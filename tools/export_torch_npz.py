#!/usr/bin/env python3
"""Export an orbax training checkpoint to the torch port's weights .npz.

    python tools/export_torch_npz.py -restore saved_model/weights-110640 \
        [-params model_parameters.json] [-num_speakers 109] \
        [-out saved_model/weights-110640.npz] [-train_state]

Restores the checkpoint the way generate.py does (init_train_state's tree as
the template, training/checkpoint.py::restore_checkpoint) and writes the EMA
parameters plus the model state (encoder batch-norm statistics) as the flat
``params/...`` / ``state/...`` npz that vqvae_wavenet_torch.params.load_npz
reads.  For the Magenta family (``-params magenta_parameters.json``) it
writes the raw parameters, which is what generate.py restores for that
family; its model state is empty.  With -train_state it writes the whole
train state (params, EMA shadows, Adam moments and count, model state,
step) of either family through
vqvae_wavenet_torch.params.from_jax_train_state in the port's checkpoint
layout, so ``python -m vqvae_wavenet_torch.train -restore <out>`` resumes
the JAX run (and the port's generate.py reads it: the Magenta family its
train/params).  -num_speakers is the speaker-table size the model was trained
with (VCTK 109, aishell 340, LibriSpeech 251).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-restore", dest="restore_path", required=True,
                        help="orbax checkpoint directory (weights-<step>)")
    parser.add_argument("-params", default="model_parameters.json",
                        dest="parameter_path", help="model parameters file")
    parser.add_argument("-num_speakers", default=109, type=int,
                        help="speaker-table size of the trained model")
    parser.add_argument("-out", default=None, dest="out_path",
                        help="output .npz (default: <restore>.npz)")
    parser.add_argument("-train_state", action="store_true",
                        help="write the whole train state (resumable by "
                             "vqvae_wavenet_torch.train -restore)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import jax
    from vqvae_wavenet_tpu.config import ModelConfig
    from vqvae_wavenet_tpu.training.checkpoint import restore_checkpoint
    from vqvae_wavenet_tpu.training.train_loop import init_train_state
    from vqvae_wavenet_torch.params import (from_jax_train_state,
                                            from_jax_tree, save_npz)
    from vqvae_wavenet_torch.training.checkpoint import write_checkpoint

    cfg = ModelConfig.from_json(args.parameter_path)
    magenta = cfg.model_family == "magenta"
    # an abstract template: restoring needs the tree's shapes only
    ts = jax.eval_shape(lambda k: init_train_state(k, cfg, args.num_speakers),
                        jax.random.PRNGKey(0))
    ts = restore_checkpoint(args.restore_path, ts)
    out = args.out_path or args.restore_path.rstrip("/") + ".npz"
    if args.train_state:
        write_checkpoint(out, from_jax_train_state(jax.device_get(ts)))
    else:
        # generate.py:121-124: raw params for Magenta, EMA shadows otherwise
        params, state = from_jax_tree(
            jax.device_get(ts["params" if magenta else "ema_params"]),
            jax.device_get(ts["model_state"]))
        save_npz(out, params, state)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
