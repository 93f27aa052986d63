"""TensorBoard summaries of the port (training/metrics.py,
``train_step(..., with_summaries=True)``) against the JAX package's
(vqvae_wavenet_tpu/training/metrics.py:41-89, train_loop.py:120-139), and
its event file against tensorboardX's.

Tolerances: the histogram set has JAX's keys; q(z|x) bit for bit; every
float array within 1e-4 of its largest |value| (f32 on both sides,
summation order only; a gradient leaf whose reference lies below 1e-6 of
the largest gradient, an exact zero in exact arithmetic, within that
bound instead).  Data- and sequence-parallel steps (2 gloo ranks,
tests/test_torch_parallel_summaries.py) write the single device's set:
gradients within 5e-3 of their leaf's largest
(JAX's SP rule, tests/test_timeshard.py:654-663), the post-step
parameters' histograms within 2.5 lr more (Adam moves an element by about
lr sign(g), and a gradient within rounding of zero can take the other
sign), the rest within 1e-4.
The event file, read back with the tensorboard package, holds the tags,
scalars and histogram fields tensorboardX writes for the same arrays.
The parallel tests' ranks import this module, which therefore imports
jax only inside functions.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from vqvae_wavenet_torch.ops.conv import set_full_f32  # noqa: E402
from vqvae_wavenet_torch.params import random_params_np  # noqa: E402
from vqvae_wavenet_torch.training import metrics  # noqa: E402
from vqvae_wavenet_torch.training.train_loop import train_step  # noqa

PARAM_KEYS = ("embedding", "speaker_embedding", "wavenet/")


def check_set(got, ref, grad_rel=1e-4, param_abs=0.0):
    assert sorted(got) == sorted(ref)
    gmax = max(np.abs(v).max() for k, v in ref.items()
               if k.startswith("gradients/"))
    for k, r in ref.items():
        g, r = np.asarray(got[k]), np.asarray(r)
        assert g.shape == r.shape, k
        if not np.issubdtype(r.dtype, np.floating):
            np.testing.assert_array_equal(g, r, err_msg=k)
            continue
        r = r.astype(np.float64)
        err = np.abs(g.astype(np.float64) - r).max()
        if k.startswith("gradients/") and np.abs(r).max() < 1e-6 * gmax:
            assert np.abs(g).max() < 1e-6 * gmax, k
        elif k.startswith("gradients/"):
            assert err <= grad_rel * np.abs(r).max(), (k, err)
        else:
            extra = param_abs if k.startswith(PARAM_KEYS) else 0.0
            assert err <= 1e-4 * max(np.abs(r).max(), 1e-6) + extra, \
                (k, err)


def test_summary_histograms_match_jax():
    """One step of the tiny config of tests/test_torch_train_step.py with
    summaries, from JAX's init, in both packages."""
    import jax
    import jax.numpy as jnp
    from vqvae_wavenet_tpu.training import metrics as jmetrics
    from vqvae_wavenet_tpu.training import train_loop as jloop
    from test_torch_train_step import (batch_np, jax_state, port_state,
                                       tiny_cfg, torch_batch)
    set_full_f32()
    cfg = tiny_cfg()
    b = batch_np()
    jts = jax_state()
    jnew, jm = jax.jit(functools.partial(
        jloop.train_step, cfg=cfg, with_summaries=True))(
        jts, {k: jnp.asarray(v) for k, v in b.items()})
    jnew, jm = jax.device_get((jnew, jm))
    jsumm = jm["summaries"]
    ref = jmetrics.summary_histograms(jnew["params"], jsumm)
    new, m = train_step(port_state(), torch_batch(b), cfg,
                        with_summaries=True)
    summ = m["summaries"]
    assert abs(float(summ["grad_norm"]) - float(jsumm["grad_norm"])) \
        <= 1e-4 * float(jsumm["grad_norm"])
    check_set(metrics.summary_histograms(new["params"], summ), ref)
    assert "wavenet/layer_2/kernel" in ref and "distances" in ref


def _read_events(logdir):
    from tensorboard.backend.event_processing.event_file_loader import (
        EventFileLoader)
    (name,) = [f for f in os.listdir(logdir) if "tfevents" in f]
    return list(EventFileLoader(os.path.join(logdir, name)).Load())


def _fields(events):
    """{(step, tag): scalar or histogram fields} of the summary events."""
    out = {}
    for e in events:
        for v in e.summary.value:
            if v.HasField("histo"):
                h = v.histo
                out[(e.step, v.tag)] = (
                    h.min, h.max, h.num, h.sum, h.sum_squares,
                    tuple(h.bucket_limit), tuple(h.bucket))
            else:
                out[(e.step, v.tag)] = v.simple_value
    return out


def test_event_file_matches_tensorboardx(tmp_path):
    tbx = pytest.importorskip("tensorboardX")
    pytest.importorskip("tensorboard")
    from tensorboardX.crc32c import crc32c as tbx_crc
    rng = np.random.default_rng(0)
    data = bytes(rng.integers(0, 256, 1000, dtype=np.uint8))
    for n in (0, 1, 7, 1000):
        assert metrics.crc32c(data[:n]) == tbx_crc(data[:n])
    arrays = {"z_e": rng.standard_normal((2, 16, 4)).astype(np.float32),
              "q(z|x)": rng.integers(0, 8, (2, 16)),
              "gradients/decoder/layers/[0]/bias": np.full(5, 2.5e-9,
                                                            np.float32),
              "wide": (rng.standard_normal(3000) * 1e4).astype(np.float32),
              "zeros": np.zeros(4, np.float32)}
    scalars = {"loss": 3.25, "lr": np.float32(8e-5),
               "global_norm/gradient_norm": torch.tensor(0.125), "step": 9}
    ours, theirs = tmp_path / "port", tmp_path / "tbx"
    ours.mkdir()
    w = metrics.MetricWriter(str(ours))
    t = tbx.SummaryWriter(str(theirs))
    for step in (3, 7):
        w.histograms(step, arrays)
        w.scalars(step, scalars)
        for k, v in arrays.items():
            t.add_histogram(k, v, step)
        for k, v in scalars.items():
            if k != "step":
                t.add_scalar(k, float(v), step)
    w.close()
    t.close()
    mine, ref = _read_events(str(ours)), _read_events(str(theirs))
    assert mine[0].file_version == "brain.Event:2"
    got, want = _fields(mine), _fields(ref)
    assert sorted(got) == sorted(want)
    assert (3, "q_z_x_") in got and (7, "loss") in got
    for key, v in want.items():
        assert got[key] == v, key
    (row,) = [r for r in open(ours / "metrics.jsonl")][:1]
    assert '"global_norm/gradient_norm": 0.125' in row


def _case(T=1024):
    """The parallel tests' case: tests/test_torch_sp_train.py's config
    with dilations [1, 2, 1, 2], random weights, B=2 x T."""
    from test_torch_sp_train import port_cfg
    cfg = port_cfg([1, 2, 1, 2])
    params, state = random_params_np(cfg, 4, seed=3)
    rng = np.random.default_rng(4)
    x = (0.5 * np.sin(np.cumsum(rng.uniform(0.01, 0.2, (2, T)), axis=1))
         ).astype(np.float32)[..., None]
    y = np.zeros((2, 1, 4), np.float32)
    y[[0, 1], 0, [1, 3]] = 1.0
    return cfg, params, state, {"x": x, "y": y}

