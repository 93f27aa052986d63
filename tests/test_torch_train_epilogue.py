"""The port's loss head (``fused_epilogue``: the heads and the mean sparse
softmax CE, whose CUDA kernel runs its plain version on the CPU) against
the XLA reference of tests/test_train_pallas.py:595-603 (S=128, Q=256,
B=1, T=192, 8 samples per frame) and at S=64, Q=128, B=2, T=320 with 64
samples per frame (T % 128 = 64), values and gradients with respect to
the head parameters, the skip stream and the condition.

Tolerances.  bf16: the loss within 2e-5 and every gradient within 2e-2 of
its leaf's max |ref| -- the kernel saves the softmax probabilities in
bf16 while the reference's dlogits stay f32 (test_train_pallas.py:
613-625).  f32: the loss within 1e-6, gradients within 1e-5 (summation
order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_wavenet_tpu.models.wavenet import wavenet_loss
from vqvae_wavenet_tpu.ops.conv import add_condition
from vqvae_wavenet_torch.ops import epilogue_kernels
from vqvae_wavenet_torch.ops.conv import set_full_f32

set_full_f32()

# (S, Q, B, T, C, FR): the reference test's shape, and the shipped 64
# samples a frame at narrow widths with T % 128 = 64 (the kernel's last
# row tile of each batch row half empty)
SHAPE = (128, 256, 1, 192, 128, 8)
RAGGED = (64, 128, 2, 320, 32, 64)


def make(shape=SHAPE, seed=61):
    S, Q, B, T, C, FR = shape
    rng = np.random.default_rng(seed)

    def u(shape, fan):
        lim = np.sqrt(3.0 / fan)
        return rng.uniform(-lim, lim, shape).astype(np.float32)
    pp1 = {"kernel": u((1, S, S), S), "bias": rng.normal(0, 0.05, S).astype(
        np.float32), "lc_kernel": u((C, S), C)}
    pp2 = {"kernel": u((1, S, Q), S), "bias": rng.normal(0, 0.05, Q).astype(
        np.float32)}
    skip = (rng.standard_normal((B, T, S)) * 0.5).astype(np.float32)
    lc = (rng.standard_normal((B, T // FR, C)) * 0.3).astype(np.float32)
    labels = rng.integers(0, Q, (B, T)).astype(np.int32)
    return pp1, pp2, skip, lc, labels


def xla_ref(pp1, pp2, skip, lc, labels, cd):
    Q = pp2["kernel"].shape[2]
    net = jax.nn.relu(skip).astype(cd)
    net = jnp.einsum("btc,cf->btf", net, pp1["kernel"][0],
                     preferred_element_type=jnp.float32) + pp1["bias"]
    net = add_condition(net, lc, pp1["lc_kernel"])
    net = jax.nn.relu(net).astype(cd)
    net = jnp.einsum("btc,cf->btf", net, pp2["kernel"][0],
                     preferred_element_type=jnp.float32) + pp2["bias"]
    return wavenet_loss(net.reshape(-1, Q), labels.reshape(-1))


@pytest.mark.parametrize("dtype,loss_tol,grad_tol,shape", [
    pytest.param("bf16", 2e-5, 2e-2, SHAPE, id="bf16-2e-05-0.02"),
    pytest.param("f32", 1e-6, 1e-5, SHAPE, id="f32-1e-06-1e-05"),
    pytest.param("bf16", 2e-5, 2e-2, RAGGED, id="bf16-ragged"),
    pytest.param("f32", 1e-6, 1e-5, RAGGED, id="f32-ragged")])
def test_epilogue_matches_xla(dtype, loss_tol, grad_tol, shape):
    pp1, pp2, skip, lc, labels = make(shape)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    cast = lambda t: {k: jnp.asarray(v, jd) for k, v in t.items()}  # noqa
    lr, gr = jax.jit(jax.value_and_grad(
        lambda a, b, s, c: xla_ref(a, b, s, c, jnp.asarray(labels), jd),
        argnums=(0, 1, 2, 3)))(cast(pp1), cast(pp2), jnp.asarray(skip),
                               jnp.asarray(lc, jd))
    gr = jax.device_get(gr)

    def leafs(tree):
        return {k: torch.from_numpy(v).to(td).requires_grad_(True)
                for k, v in tree.items()}
    t1, t2 = leafs(pp1), leafs(pp2)
    ts = torch.from_numpy(skip).requires_grad_(True)
    tl = torch.from_numpy(lc).to(td).requires_grad_(True)
    before = epilogue_kernels.fwd_launches, epilogue_kernels.bwd_launches
    loss = epilogue_kernels.fused_epilogue(t1, t2, ts, tl, None,
                                           torch.from_numpy(labels))
    loss.backward()
    assert (epilogue_kernels.fwd_launches,
            epilogue_kernels.bwd_launches) == before
    assert abs(float(loss.detach()) - float(lr)) < loss_tol
    got = [(("pp1", k), t1[k].grad) for k in t1] \
        + [(("pp2", k), t2[k].grad) for k in t2] \
        + [(("skip",), ts.grad), (("lc",), tl.grad)]
    refs = {("pp1", k): v for k, v in gr[0].items()}
    refs.update({("pp2", k): v for k, v in gr[1].items()})
    refs[("skip",)], refs[("lc",)] = gr[2], gr[3]
    for key, g in got:
        ref = np.asarray(refs[key], np.float64)
        rel = np.abs(g.double().numpy() - ref).max() / (np.abs(ref).max()
                                                        + 1e-9)
        assert rel < grad_tol, (key, rel)


@pytest.mark.parametrize("entry,Q,frames", [
    ("fwd", 512, 3), ("bwd", 264, 3), ("fwd", 128, 2)])
def test_epilogue_wrapper_refuses_shapes_before_device(entry, Q, frames):
    """Frames that do not divide T raise ValueError with the reason,
    before the wrapper looks at the device (CPU tensors here).  Frames of
    any number of rows dividing T (65 here, 97.5 for frames=2) and any Q
    that is a multiple of 8 (past 256 the kernel walks 256-column chunks)
    pass the shape checks and reach the device check."""
    S, B, T = 16, 1, 195
    skip, w1 = torch.zeros((B, T, S)), torch.zeros((S, S))
    w2, labels = torch.zeros((S, Q)), torch.zeros((B, T), dtype=torch.int32)
    match = "divid" if T % frames else "CUDA tensors"
    with pytest.raises(ValueError, match=match):
        if entry == "fwd":
            epilogue_kernels.epilogue_forward_cuda(
                skip, w1, w2, torch.zeros(Q), torch.zeros((frames, B, S)),
                labels)
        else:
            epilogue_kernels.epilogue_backward_cuda(
                torch.ones(()), skip, skip, torch.zeros((B, T, Q)), labels,
                w1, w2, frames, skip)


def test_epilogue_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        epilogue_kernels.epilogue_forward_cuda(
            torch.zeros((1, 8, 8)), torch.zeros((8, 8)), torch.zeros((8, 8)),
            torch.zeros(8), torch.zeros((1, 1, 8)),
            torch.zeros((1, 8), dtype=torch.int32))
