"""The port's prior CLI (``python -m vqvae_wavenet_torch.prior``) end to end
on the CPU, on the synthetic VCTK-layout corpus of
tools/make_synthetic_corpus.py and a tiny VQ-VAE with Encoder_Magenta
(random weights from a numpy seed): three training steps, a resume with
-prior_restore to step 5, and -sample 2, which writes two finite wavs and
reads the checkpoint's EMA shadow (params/), not its trained parameters.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from vqvae_wavenet_torch import prior as prior_cli
from vqvae_wavenet_torch.config import ModelConfig
from vqvae_wavenet_torch.models.prior import prior_sample
from vqvae_wavenet_torch.models.vqvae import speaker_vector
from vqvae_wavenet_torch.params import (load_npz, load_tree,
                                        random_params_np, save_npz)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("prior_cli")
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus",
        os.path.join(REPO, "tools", "make_synthetic_corpus.py"))
    corpus = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(corpus)
    corpus.make_corpus(str(root / "data"))
    (root / "wn.json").write_text(json.dumps({
        "quantization_channels": 256, "num_cycles": 1,
        "num_cycle_layers": 3, "dilation_rates": [1, 2, 4],
        "kernel_size": 2, "dilation_filters": 16, "skip_filters": 16,
        "residual_filters": 16,
        "preprocess": {"kernel_size": 4, "filters": 16}}))
    (root / "model.json").write_text(json.dumps({
        "encoder": "Magenta", "use_vq": True, "speaker_embedding": 8,
        "k": 16, "latent_dim": 8, "beta": 0.25,
        "wavenet_parameters": str(root / "wn.json")}))
    cfg = ModelConfig.from_json(str(root / "model.json"))
    params, state = random_params_np(cfg, 109, seed=0)
    save_npz(str(root / "vqvae.npz"), params, state)
    return root


def common(root):
    return ["-restore", str(root / "vqvae.npz"), "-params",
            str(root / "model.json"), "-data", str(root / "data"),
            "-device", "cpu"]


def train_args(root, *extra):
    return common(root) + ["-length", "1024", "-batch", "2", "-save",
                           str(root / "prior"), "-interval", "1",
                           "-ckpt_interval", "100", *extra]


def test_train_resume_and_sample(setup, capsys):
    root = setup
    res = prior_cli.main(train_args(root, "-step", "3"))
    assert res["step"] == 3 and len(res["nll"]) == 3
    assert np.isfinite(res["nll"]).all()
    assert (root / "prior" / "weights-3.npz").exists()
    res = prior_cli.main(train_args(root, "-step", "2", "-prior_restore",
                                    str(root / "prior"), "-train_dtype",
                                    "bf16"))
    assert res["step"] == 5 and np.isfinite(res["nll"]).all()
    assert "[prior restore] last prior step: 3" in capsys.readouterr().out
    rows = [json.loads(r) for r in
            (root / "prior" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    for r in rows:
        assert 0 < r["prior/code_usage"] <= 1
        assert 1 <= r["prior/code_perplexity"] <= 16
        assert np.isfinite(r["prior/nll"])

    out = prior_cli.main(common(root) + [
        "-prior", str(root / "prior" / "weights-5"), "-sample", "2",
        "-seconds", "0.064", "-speakers", "p225", "None", "-mode", "greedy"])
    assert out["audio"].shape == (2, 1024) and out["codes"].shape == (2, 16)
    names = [os.path.basename(p) for p in out["paths"]]
    assert names == ["prior_p225.wav", "prior_None.wav"]
    for p in out["paths"]:
        sr, x = wavfile.read(p)
        assert sr == 16000 and x.shape == (1024,)
        assert np.isfinite(x).all() and np.abs(x).max() <= 1.0


def test_sampling_reads_the_ema_shadow(setup, tmp_path):
    """A checkpoint whose trained parameters (train/params) are scrambled:
    the CLI's codes are prior_sample's on the EMA shadow (params/)."""
    root = setup
    src = root / "prior" / "weights-3.npz"
    if not src.exists():
        prior_cli.main(train_args(root, "-step", "3"))
    with np.load(src) as z:
        flat = {k: z[k] for k in z.files}
    for k in flat:
        if k.startswith("train/params/"):
            flat[k] = -3.0 * flat[k] + 0.5
    ckpt = tmp_path / "weights-3.npz"
    np.savez(ckpt, **flat)
    out = prior_cli.main(common(root) + [
        "-prior", str(ckpt), "-sample", "2", "-seconds", "0.032",
        "-speakers", "p226", "p226"])
    assert [os.path.basename(p) for p in out["paths"]] == [
        "prior_p226.wav", "prior_p226_1.wav"]
    cfg = ModelConfig.from_json(str(root / "model.json"))
    vq, _ = load_npz(str(root / "vqvae.npz"))
    y = torch.zeros((2, 1, 109))
    y[:, 0, 1] = 1.0
    h = speaker_vector(vq, cfg, y)
    tree = load_tree(str(ckpt))

    def codes(params):
        g = torch.Generator().manual_seed(prior_cli.SEED)
        return prior_sample(params, g, batch_size=2, length=8, gc=h).numpy()
    np.testing.assert_array_equal(out["codes"], codes(tree["params"]))
    assert not np.array_equal(out["codes"], codes(tree["train"]["params"]))


def other_corpus(root, name):
    """Two speakers x two 0.5 s 16 kHz utterances in the LibriSpeech or
    Aishell layout (the manifests of data.py's classes)."""
    rng = np.random.default_rng(1)
    files = []
    for spk in ("19", "26") if name == "LibriSpeech" else ("S0002",
                                                           "S0003"):
        for u in range(2):
            rel = (f"LibriSpeech/{spk}/198/{spk}-198-{u:04d}.wav"
                   if name == "LibriSpeech"
                   else f"wav/train/{spk}/BAC009{spk}W{u:04d}.wav")
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            wavfile.write(str(root / rel), 16000, (rng.uniform(
                -0.4, 0.4, 8000) * 32767).astype(np.int16))
            files.append(rel)
    stem = {"LibriSpeech": "librispeech", "Aishell": "aishell"}[name]
    manifest = ("librispeech_train_clean_100.txt" if name == "LibriSpeech"
                else "aishell_train.txt")
    (root / manifest).write_text("\n".join(files) + "\n")
    spks = sorted({f.split("/")[1] if name == "LibriSpeech"
                   else f.split("/train/")[1].split("/")[0] for f in files})
    (root / f"{stem}_speakers.txt").write_text(
        "".join(f"{s}, {i}\n" for i, s in enumerate(spks)))
    return root


@pytest.mark.parametrize("name", ["LibriSpeech", "Aishell"])
def test_other_datasets_train(setup, tmp_path, name):
    """The prior reads every dataset of data.DATASETS, as JAX's prior.py
    :126-133 does: the port's loader finds JAX's files and speakers in the
    corpus, and the prior trains a step on it."""
    from vqvae_wavenet_tpu.data.datasets import DATASETS as JDATASETS
    from vqvae_wavenet_torch.data import DATASETS
    root = other_corpus(tmp_path / "data", name)
    ours = DATASETS[name](batch_size=2, max_len=1024,
                          relative_path=str(root) + "/", seed=0)
    theirs = JDATASETS[name](batch_size=2, max_len=1024,
                             relative_path=str(root) + "/")
    assert sorted(ours.all_files) == sorted(theirs.all_files)
    assert ours.speaker_to_int == theirs.speaker_to_int
    assert [ours.speaker_to_int[ours.split_func(f)] for f in
            sorted(ours.all_files)] == [
        theirs.speaker_to_int[theirs.split_func(f)] for f in
        sorted(theirs.all_files)]
    args = train_args(setup, "-step", "1", "-dataset", name)
    args[args.index("-data") + 1] = str(root)
    args[args.index("-save") + 1] = str(tmp_path / "prior")
    out = prior_cli.main(args)
    assert out["step"] == 1 and np.isfinite(out["nll"]).all()
