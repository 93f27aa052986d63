"""The port's MFCC front end, Encoder_Magenta, Encoder_2019, their training
and generation paths, and the loss head's plain twin at frames of any
length, against the JAX package at small sizes (inputs from numpy seeds;
JAX on the CPU, data crossing as numpy).

Tolerances.  Mel and DCT matrices, |STFT| and MFCC: rtol 1e-5 with an
absolute floor of 1e-5 of the largest |reference| (float32 FFTs and sums
in another order; near-zero bins carry only that rounding).  Encoders:
1e-4, as tests/test_torch_encode.py (float32 convs summed in another
order).  One f32 training step: loss and every gradient leaf within 1e-4
of the leaf's largest |reference| (tests/test_torch_train_step.py).
Greedy generation: the generated mu-law bins equal.  Loss head: as
tests/test_torch_train_epilogue.py (bf16: loss 2e-5, gradients 2e-2 of
each leaf's max; f32: 1e-6 and 1e-5).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from vqvae_wavenet_tpu.config import ModelConfig, WavenetConfig
from vqvae_wavenet_tpu.generation import fast as jfast
from vqvae_wavenet_tpu.models import encoders as jenc
from vqvae_wavenet_tpu.models import vqvae as jvqvae
from vqvae_wavenet_tpu.models.wavenet import wavenet_loss
from vqvae_wavenet_tpu.ops import signal as jsignal
from vqvae_wavenet_tpu.ops.conv import add_condition
from vqvae_wavenet_torch.generation import fast as tfast
from vqvae_wavenet_torch.models import encoders as tenc
from vqvae_wavenet_torch.models import vqvae as tvqvae
from vqvae_wavenet_torch.ops import epilogue_kernels
from vqvae_wavenet_torch.ops import signal as tsignal
from vqvae_wavenet_torch.ops.conv import set_full_f32
from vqvae_wavenet_torch.params import (from_jax_tree, random_params_np,
                                        save_npz, to_torch)
from vqvae_wavenet_torch.training import train_loop as tloop
from vqvae_wavenet_torch.training.optimizer import tree_leaves

set_full_f32()

NUM_SPEAKERS = 3
FILTERS = 32


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def wav(b, t, seed=0):
    rng = np.random.default_rng(seed)
    n = np.arange(t)[None, :]
    f0 = rng.uniform(100, 400, (b, 1))
    return (0.4 * np.sin(2 * np.pi * f0 * n / 16000.0)
            + 0.05 * rng.standard_normal((b, t))).astype(np.float32)


# ------------------------------------------------------------ MFCC front end

def test_mel_and_dct_matrices_match_jax():
    close(tsignal.linear_to_mel_weight_matrix(),
          jsignal.linear_to_mel_weight_matrix())
    close(tsignal._dct2_matrix(80), jsignal._dct2_matrix(80))


@pytest.mark.parametrize("pad_end", [True, False])
def test_stft_magnitude_matches_jax(pad_end):
    x = wav(2, 1234)
    got = tsignal.stft_magnitude(torch.from_numpy(x), pad_end=pad_end)
    ref = jsignal.stft_magnitude(jnp.asarray(x), pad_end=pad_end)
    assert got.shape == ref.shape == (2, 8 if pad_end else 6, 201)
    close(got.numpy(), ref)


@pytest.mark.parametrize("pad_end", [True, False])
def test_mfcc_matches_jax(pad_end):
    x = wav(2, 1600, seed=1)
    got = tsignal.mfcc(torch.from_numpy(x), pad_end=pad_end)
    ref = jsignal.mfcc(jnp.asarray(x), pad_end=pad_end)
    assert got.shape == ref.shape == (2, 10 if pad_end else 8, 13)
    close(got.numpy(), ref)


def test_pool1d_max_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 13, 3)).astype(
        np.float32)
    for mode in ("avg", "max"):
        got = tsignal.pool1d(torch.from_numpy(x), 4, mode)
        close(got.numpy(), jsignal.pool1d(jnp.asarray(x), 4, mode))


# ------------------------------------------------------------------ encoders

def jax_encoder(name, latent_dim=8, seed=0):
    """A JAX encoder tree at FILTERS channels (numpy leaves)."""
    init = {"Magenta": jenc.init_encoder_magenta,
            "2019": jenc.init_encoder_2019}[name]
    params, state = init(jax.random.PRNGKey(seed), latent_dim,
                         filters=FILTERS)
    return jax.device_get(params), state


@pytest.mark.parametrize("name,t,frames", [("Magenta", 1280, 20),
                                           ("2019", 1280, 4),
                                           ("2019", 1300, 5)])
def test_encoder_matches_jax(name, t, frames):
    params, state = jax_encoder(name)
    x = wav(2, t, seed=3)[..., None]
    ref, _ = jax.jit(lambda p, x: jenc.encoder_forward(
        name, p, state, x, train=True))(params, jnp.asarray(x))
    tp, _ = from_jax_tree({"encoder": params}, {"encoder": state})
    got, st = tenc.encoder_forward(name, tp["encoder"], {}, torch.from_numpy(x),
                                   train=True)
    assert got.shape == (2, frames, 8) and st == {}
    assert tenc.encoder_downsample_rate(name) \
        == jenc.encoder_downsample_rate(name)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["Magenta", "2019"])
def test_from_jax_tree_carries_encoder_trees(name):
    params, state = jax_encoder(name, seed=4)
    tp, ts = from_jax_tree({"encoder": params, "vq": {
        "embedding": np.ones((4, 8), np.float32)}}, {"encoder": state})
    assert ts == {"encoder": {}}
    got = tree_leaves(tp["encoder"])
    ref = jax.tree_util.tree_leaves(params)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("name", ["Magenta", "2019"])
def test_random_params_match_jax_shapes_and_limits(name):
    cfg = ModelConfig(encoder=name, k=16, latent_dim=8, speaker_embedding=4,
                      wavenet=WavenetConfig(num_cycles=1, num_cycle_layers=2,
                                            dilation_rates=[1, 2]))
    params, state = random_params_np(cfg, NUM_SPEAKERS, seed=0)
    ref_p, ref_s = jax.eval_shape(
        lambda k: jvqvae.init_vqvae(k, cfg, NUM_SPEAKERS),
        jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(params["encoder"]) \
        == jax.tree_util.tree_structure(ref_p["encoder"])
    for p, r in zip(jax.tree_util.tree_leaves(params["encoder"]),
                    jax.tree_util.tree_leaves(ref_p["encoder"])):
        assert p.shape == r.shape and p.dtype == np.float32
    assert state["encoder"] == {} and ref_s["encoder"] == {}
    if name == "2019":          # glorot: sqrt(6 / (K (C_in + C_out)))
        k = params["encoder"]["pre2"]["kernel"]
        lim = np.sqrt(6.0 / (3 * 768 * 2))
    else:                       # uniform unit scaling: sqrt(3 / (K C_in))
        k = params["encoder"]["layers"][0]["gate"]["kernel"]
        lim = np.sqrt(3.0 / (5 * 128))
    assert lim * 0.98 < np.abs(k).max() <= lim


# ------------------------------------------------------- training (tiny)

def tiny_cfg(encoder, **kw):
    wn = WavenetConfig(
        quantization_channels=32, num_cycles=1, num_cycle_layers=3,
        dilation_rates=[1, 2, 4], kernel_size=2, dilation_filters=8,
        skip_filters=8, residual_filters=8, preprocess_kernel_size=2,
        preprocess_filters=8)
    return ModelConfig(encoder=encoder, use_vq=True, speaker_embedding=4,
                       k=8, latent_dim=8, beta=0.25, wavenet=wn,
                       learning_rate_schedule={0: 1e-3}, **kw)


@functools.lru_cache(maxsize=None)
def jax_model(encoder):
    """init_vqvae of the tiny config with the encoder at FILTERS channels
    (numpy leaves)."""
    cfg = tiny_cfg("64")
    params, state = jax.device_get(jax.jit(
        lambda k: jvqvae.init_vqvae(k, cfg, NUM_SPEAKERS))(
            jax.random.PRNGKey(0)))
    params["encoder"], state["encoder"] = jax_encoder(encoder, seed=5)
    return params, state


def batch_np(T, seed=1, B=2):
    y = np.zeros((B, 1, NUM_SPEAKERS), np.float32)
    y[np.arange(B), 0, np.arange(B) % NUM_SPEAKERS] = 1.0
    return {"x": wav(B, T, seed)[..., None], "y": y}


@pytest.mark.parametrize("encoder,T", [("2019", 640), ("Magenta", 256)])
def test_f32_step_loss_and_grads_match_jax(encoder, T):
    cfg = tiny_cfg(encoder)
    params, state = jax_model(encoder)
    b = batch_np(T)

    def loss_fn(p):
        return jvqvae.vqvae_forward(p, state, cfg, jnp.asarray(b["x"]),
                                    jnp.asarray(b["y"]), train=True)
    (jl, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    tp, ts = from_jax_tree(params, state)
    loss, _, grads = tloop.loss_and_grads(
        tp, ts, cfg, {k: torch.from_numpy(v) for k, v in b.items()})
    assert rel(loss, jl) < 1e-4
    ref = jax.tree_util.tree_leaves(jax.device_get(jgrads))
    assert len(ref) == len(grads)
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert rel(g, r) < 1e-4, (i, rel(g, r))


@pytest.mark.parametrize("encoder,train_dtype", [
    ("2019", "f32"), ("2019", "bf16"), ("Magenta", "bf16")])
def test_train_steps_lower_the_loss(encoder, train_dtype):
    """Three steps on one batch through train_step (the stack and loss-head
    plain twins on the CPU): finite, lower; under bf16 the 2019 encoder
    stays float32 (z_e equals the f32 encoder's bit for bit)."""
    cfg = tiny_cfg(encoder, train_dtype=train_dtype)
    params, state = jax_model(encoder)
    tp, ts = from_jax_tree(params, state)
    b = {k: torch.from_numpy(v) for k, v in
         batch_np(640 if encoder == "2019" else 256).items()}
    _, aux = tvqvae.vqvae_forward(tp, ts, cfg, b["x"], b["y"])
    assert aux["z_e"].dtype == torch.float32
    if encoder == "2019":
        z32, _ = tenc.encoder_forward("2019", tp["encoder"], {}, b["x"])
        assert torch.equal(aux["z_e"], z32)
    tstate = tloop.init_train_state(tp, ts)
    losses = []
    for _ in range(3):
        tstate, m = tloop.train_step(tstate, b, cfg)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# ------------------------------------------------------------ generation

def bins(audio: torch.Tensor) -> np.ndarray:
    """The mu-law bins (Q = 32) of a generated waveform: the two frameworks
    decode a bin to floats ~1e-7 apart."""
    from vqvae_wavenet_torch.ops.mu_law import mu_law_encode
    return mu_law_encode(audio, 32, to_int=True).numpy()


def encode_jax(cfg, params, state, x, y):
    lc, _ = jvqvae.vqvae_encode(params, state, cfg, jnp.asarray(x),
                                jnp.asarray(y))
    return np.asarray(lc)


@pytest.mark.parametrize("length,frames", [(1280, 4), (2048, 7)])
def test_2019_greedy_generation_matches_jax(length, frames):
    """1,280 samples: 4 frames of 320.  2,048: 7 frames, ratio 292, so the
    last 4 samples (7 x 292 = 2,044) read the last frame; JAX, which needs
    frames dividing the length, gets the per-sample condition
    lc[:, min(i // 292, 6)] (ratio 1)."""
    cfg = tiny_cfg("2019")
    params, state = jax_model("2019")
    b = batch_np(length, seed=6)
    lc = encode_jax(cfg, params, state, b["x"], b["y"])
    assert lc.shape[1] == frames
    ratio = length // frames
    idx = np.minimum(np.arange(length) // ratio, frames - 1)
    ref = np.asarray(jfast.generate(
        params["decoder"], cfg.wavenet, jnp.asarray(lc[:, idx]),
        length=length, mode="greedy", engine="xla"))
    tp, ts = from_jax_tree(params, state)
    tlc, _ = tvqvae.vqvae_encode(tp, ts, cfg, torch.from_numpy(b["x"]),
                                 torch.from_numpy(b["y"]))
    np.testing.assert_allclose(tlc.numpy(), lc, rtol=1e-4, atol=1e-4)
    got = tfast.generate(tp["decoder"], cfg.wavenet, tlc, length=length,
                         mode="greedy")
    np.testing.assert_array_equal(bins(got), bins(torch.from_numpy(ref)))


@pytest.mark.parametrize("encoder,length,frames,padded", [
    ("2019", 1536, 5, 2048), ("2019", 6656, 21, 8192),
    ("Magenta", 1024, 16, 1024)])
def test_generate_cli_bucket_keeps_kept_samples(tmp_path, encoder, length,
                                                frames, padded):
    """The port's generate CLI with the other encoders: 2019 on 1,536
    samples (5 frames, ratio 307: the last sample reads the last frame)
    bucketed to 2,048 and on 6,656 (21 frames, ratio 316: the last 20
    samples) bucketed to 8,192; Magenta on 1,024 (16 frames).  Its wav
    equals a direct greedy generation of exactly ``length`` samples, so the
    bucket padding changes no frame a kept sample reads."""
    from vqvae_wavenet_torch import generate as gen_cli
    from vqvae_wavenet_torch.data import read_wav_16k
    params, state = jax_model(encoder)
    tp, ts = from_jax_tree(params, state)
    cfg = tiny_cfg(encoder)
    (tmp_path / "wn.json").write_text(json.dumps({
        "quantization_channels": 32, "num_cycles": 1, "num_cycle_layers": 3,
        "dilation_rates": [1, 2, 4], "kernel_size": 2, "dilation_filters": 8,
        "skip_filters": 8, "residual_filters": 8,
        "preprocess": {"kernel_size": 2, "filters": 8}}))
    (tmp_path / "model.json").write_text(json.dumps({
        "encoder": encoder, "use_vq": True, "speaker_embedding": 4, "k": 8,
        "latent_dim": 8, "beta": 0.25,
        "wavenet_parameters": str(tmp_path / "wn.json")}))
    info = tmp_path / "vctk_info"
    info.mkdir()
    (info / "vctk_speakers.txt").write_text("p225, 0\np226, 1\np227, 2\n")
    wavfile.write(str(tmp_path / "in.wav"), 16000,
                  (wav(1, length, seed=7)[0] * 32767).astype(np.int16))
    ckpt = tmp_path / "weights-7.npz"
    save_npz(str(ckpt), tp, ts)
    out = gen_cli.main(["-restore", str(ckpt), "-audio",
                        str(tmp_path / "in.wav"), "-speakers", "p226",
                        "-mode", "greedy", "-params",
                        str(tmp_path / "model.json"), "-data", str(tmp_path),
                        "-device", "cpu"])
    assert out["samples"] == padded and out["audio"].shape == (1, length)
    xt = torch.from_numpy(read_wav_16k(str(tmp_path / "in.wav"))).reshape(
        1, -1, 1)
    y = torch.zeros((1, 1, NUM_SPEAKERS))
    y[0, 0, 1] = 1.0
    lc, _ = tvqvae.vqvae_encode(tp, ts, cfg, xt, y)
    assert lc.shape[1] == frames
    ref = tfast.generate(tp["decoder"], cfg.wavenet, lc, length=length,
                         mode="greedy")
    np.testing.assert_array_equal(out["audio"], ref.numpy())


# ------------------------------------------------ loss head at any frame

@pytest.mark.parametrize("dtype,loss_tol,grad_tol,T,FR", [
    ("bf16", 2e-5, 2e-2, 640, 320), ("f32", 1e-6, 1e-5, 640, 320),
    ("bf16", 2e-5, 2e-2, 300, 100), ("f32", 1e-6, 1e-5, 300, 100)])
def test_loss_head_plain_twin_any_frame_matches_xla(dtype, loss_tol, grad_tol,
                                                    T, FR):
    """The heads + CE (fused_epilogue, its plain twin on the CPU) at 320-row
    frames (Encoder_2019) and ragged 100-row frames, against JAX's XLA
    heads + wavenet_loss: the loss, and the gradients of the head weights,
    the skip stream and the condition."""
    S, Q, B, C = 64, 128, 2, 16
    rng = np.random.default_rng(T + FR)

    def u(shape, fan):
        return rng.uniform(-1, 1, shape).astype(np.float32) * np.sqrt(3 / fan)
    pp1 = {"kernel": u((1, S, S), S), "bias": rng.normal(0, 0.05, S).astype(
        np.float32), "lc_kernel": u((C, S), C)}
    pp2 = {"kernel": u((1, S, Q), S), "bias": rng.normal(0, 0.05, Q).astype(
        np.float32)}
    skip = (rng.standard_normal((B, T, S)) * 0.5).astype(np.float32)
    lc = (rng.standard_normal((B, T // FR, C)) * 0.3).astype(np.float32)
    labels = rng.integers(0, Q, (B, T)).astype(np.int32)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32

    def xla_ref(a, b, s, c):
        net = jnp.einsum("btc,cf->btf", jax.nn.relu(s).astype(jd),
                         a["kernel"][0], preferred_element_type=jnp.float32)
        net = add_condition(net + a["bias"], c, a["lc_kernel"])
        net = jnp.einsum("btc,cf->btf", jax.nn.relu(net).astype(jd),
                         b["kernel"][0], preferred_element_type=jnp.float32)
        return wavenet_loss((net + b["bias"]).reshape(-1, Q),
                            jnp.asarray(labels).reshape(-1))
    cast = lambda t: {k: jnp.asarray(v, jd) for k, v in t.items()}  # noqa
    lr, gr = jax.device_get(jax.jit(jax.value_and_grad(
        xla_ref, argnums=(0, 1, 2, 3)))(cast(pp1), cast(pp2),
                                        jnp.asarray(skip),
                                        jnp.asarray(lc, jd)))
    t1 = {k: torch.from_numpy(v).to(td).requires_grad_(True)
          for k, v in pp1.items()}
    t2 = {k: torch.from_numpy(v).to(td).requires_grad_(True)
          for k, v in pp2.items()}
    ts = torch.from_numpy(skip).requires_grad_(True)
    tl = torch.from_numpy(lc).to(td).requires_grad_(True)
    loss = epilogue_kernels.fused_epilogue(t1, t2, ts, tl, None,
                                           torch.from_numpy(labels))
    loss.backward()
    assert abs(float(loss.detach()) - float(lr)) < loss_tol
    pairs = [(t1[k].grad, gr[0][k]) for k in t1] \
        + [(t2[k].grad, gr[1][k]) for k in t2] \
        + [(ts.grad, gr[2]), (tl.grad, gr[3])]
    for i, (g, r) in enumerate(pairs):
        assert rel(g.double().numpy(), r) < grad_tol, (i, rel(g.double(), r))


@pytest.mark.parametrize("encoder,train_dtype,length", [
    ("2019", "bf16", 640), ("Magenta", "f32", 256)])
def test_train_cli_trains_the_other_encoders(tmp_path, encoder, train_dtype,
                                             length):
    """python -m vqvae_wavenet_torch.train with the config's encoder
    (random full-width encoder weights from the numpy seed, a tiny WaveNet)
    on the corpus of tools/make_synthetic_corpus.py: one step, finite, a
    checkpoint; Encoder_2019 refuses a length that is not a multiple of
    320 before it reads any data."""
    import importlib.util
    import os
    from vqvae_wavenet_torch import train as train_cli
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus",
        os.path.join(repo, "tools", "make_synthetic_corpus.py"))
    corpus = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(corpus)
    corpus.make_corpus(str(tmp_path / "data"))
    (tmp_path / "wn.json").write_text(json.dumps({
        "quantization_channels": 256, "num_cycles": 1, "num_cycle_layers": 3,
        "dilation_rates": [1, 2, 4], "kernel_size": 2, "dilation_filters": 8,
        "skip_filters": 8, "residual_filters": 8,
        "preprocess": {"kernel_size": 2, "filters": 8}}))
    (tmp_path / "model.json").write_text(json.dumps({
        "encoder": encoder, "use_vq": True, "speaker_embedding": 4, "k": 8,
        "latent_dim": 8, "beta": 0.25, "train_dtype": train_dtype,
        "wavenet_parameters": str(tmp_path / "wn.json")}))

    def args(n):
        return ["-dataset", "VCTK", "-length", str(n), "-batch", "2",
                "-step", "1", "-save", str(tmp_path / "saved" / "weights"),
                "-params", str(tmp_path / "model.json"), "-data",
                str(tmp_path / "data"), "-device", "cpu"]
    res = train_cli.main(args(length))
    assert res["step"] == 1 and np.isfinite(res["losses"]).all()
    assert (tmp_path / "saved" / "weights-1.npz").exists()
    if encoder == "2019":
        with pytest.raises(ValueError, match="multiple of 320"):
            train_cli.main(args(6656))


def test_check_length_of_each_encoder():
    from vqvae_wavenet_torch.config import ModelConfig as PortConfig
    from vqvae_wavenet_torch.train import check_length
    cfg = PortConfig(encoder="2019")
    check_length(cfg, 6400)
    with pytest.raises(ValueError, match="multiple of 320"):
        check_length(cfg, 6656)
    check_length(dataclasses.replace(cfg, encoder="Magenta"), 6656)
    with pytest.raises(ValueError, match="multiple of 64"):
        check_length(dataclasses.replace(cfg, encoder="64"), 6600)
