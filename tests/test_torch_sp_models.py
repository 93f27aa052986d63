"""Sequence parallelism (SP) of the other models on the CPU: the Magenta
family, Encoder_Magenta and Encoder_2019 (with its MFCC front end's
240-sample right halo) on time rows of 2 and 4 ranks spawned with
torch.multiprocessing, gloo between them, the stack's plain twins.  Each
case is held against JAX's SINGLE-DEVICE ``jax.value_and_grad`` of
``vqvae_forward`` or ``magenta_forward`` on the same numpy weights and
batch:

  * the Magenta family (4 decoder layers of 2 stages at narrow widths, as
    tests/test_torch_dp.py patches the family's module constants, here in
    both packages; K = 2, a global condition in every layer, sigmoid first)
    at B = 2, T = 512 on 2 ranks;
  * Encoder_Magenta at B = 2, T = 512 on 2 ranks;
  * Encoder_2019 at B = 2, T = 1,280 on 2 ranks (640 samples, 2 frames a
    shard) and 4 ranks (320 samples, 1 frame a shard: the decoder's cycle
    halo of one frame spans a whole shard), in f32, and on 2 ranks in bf16
    with the encoder in f32 (JAX's own SP casts it to bf16 and raises
    TypeError, ROADMAP.md C).

The main family runs at the widths of tests/test_torch_sp_train.py.
Tolerances are JAX's SP ones (tests/test_torch_sp_mesh.py): the loss within
rtol 2e-4 (bf16: 2e-2), every f32 gradient leaf within 5e-3 of max(its
largest |value|, 1e-4 of the largest of any leaf), bf16 by
check_bf16_grads.  The ranks import this module, which therefore imports
jax only inside functions; no rank may import jax.
"""
import contextlib
import functools
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from test_torch_sp_mesh import (  # noqa: E402
    DILS, _imported_jax, jax_case, jax_reference, sp_case_rank, to_t)
from test_torch_sp_train import (  # noqa: E402
    RANK_TIMEOUT, check_bf16_grads, check_f32_grads)
from vqvae_wavenet_torch.config import ModelConfig  # noqa: E402
from vqvae_wavenet_torch.ops.conv import set_full_f32  # noqa: E402
from vqvae_wavenet_torch.parallel import run_ranks  # noqa: E402
from vqvae_wavenet_torch.parallel.timeshard import (  # noqa: E402
    sp_loss_and_grads)

MAGENTA_JSON = os.path.join(REPO, "magenta_parameters.json")
SHALLOW_MAGENTA = (("NUM_LAYERS", 4), ("NUM_STAGES", 2), ("WIDTH", 16),
                   ("SKIP_WIDTH", 24), ("AE_WIDTH", 32))
ENCODER_CASES = {        # name -> (ModelConfig kwargs, T, time shards)
    "magenta_enc": ({"encoder": "Magenta"}, 512, 2),
    "2019": ({"encoder": "2019"}, 1280, 2),
    "2019_bf16": ({"encoder": "2019", "train_dtype": "bf16"}, 1280, 2),
    "2019_4": ({"encoder": "2019"}, 1280, 4),
}


@contextlib.contextmanager
def shallow_magenta(*modules):
    """The Magenta family's module constants narrowed in ``modules``."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in modules:
            for name, v in SHALLOW_MAGENTA:
                mp.setattr(mod, name, v)
        yield


def magenta_rank(sh, params, x, y):
    """One rank of the Magenta family's SP loss and gradients (its module
    constants narrowed in this process)."""
    from vqvae_wavenet_torch.models import magenta
    for name, v in SHALLOW_MAGENTA:
        setattr(magenta, name, v)
    set_full_f32()
    cfg = ModelConfig.from_json(MAGENTA_JSON)
    t_l = x.shape[1] // sh.n_time
    cols = slice(sh.time_rank * t_l, (sh.time_rank + 1) * t_l)
    loss, aux, grads = sp_loss_and_grads(
        to_t(params), {}, cfg, {"x": torch.from_numpy(x[:, cols]).contiguous(),
                                "y": torch.from_numpy(y)}, sh)
    return {"loss": float(loss), "reg": float(aux["reg_loss"]),
            "perplexity": float(aux["perplexity"]),
            "grads": [g.numpy() for g in grads] if sh.rank == 0 else None,
            "imported": _imported_jax()}


@functools.lru_cache(maxsize=None)
def magenta_case():
    """JAX's init of the narrowed family, a batch, and JAX's single-device
    loss, aux and gradients."""
    import jax
    import jax.numpy as jnp
    from vqvae_wavenet_tpu.models import magenta as jmagenta
    rng = np.random.default_rng(3)
    t = np.arange(512) / 16000.0
    x = (0.4 * np.sin(2 * np.pi * rng.uniform(150, 400, (2, 1)) * t)
         + 0.05 * rng.standard_normal((2, 512))).astype(np.float32)[..., None]
    y = np.zeros((2, 1, 3), np.float32)
    y[[0, 1], 0, [2, 0]] = 1.0
    with shallow_magenta(jmagenta):
        params = jax.device_get(jmagenta.init_magenta_params(
            jax.random.PRNGKey(4), num_speakers=3))
        params = jax.tree_util.tree_map(np.asarray, params)
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p: jmagenta.magenta_forward(p, jnp.asarray(x),
                                               jnp.asarray(y), engine="xla"),
            has_aux=True))(params)
    grads = [np.asarray(g, np.float64)
             for g in jax.tree_util.tree_leaves(jax.device_get(grads))]
    return params, x, y, float(loss), jax.device_get(aux), grads


def test_magenta_family_matches_jax_single_device():
    params, x, y, loss, aux, grads = magenta_case()
    res = run_ranks(magenta_rank, 2, "cpu", params, x, y,
                    timeout=RANK_TIMEOUT, n_time=2)
    for r in res:
        assert r["loss"] == pytest.approx(loss, rel=2e-4)
        assert r["reg"] == pytest.approx(float(aux["reg_loss"]), rel=1e-5)
        assert r["perplexity"] == pytest.approx(float(aux["perplexity"]),
                                                rel=1e-5)
        assert r["imported"] == []
    check_f32_grads(res[0]["grads"], grads)


@pytest.fixture(scope="module")
def encoder_runs():
    """Each encoder case's SP train step on its time row; one spawn a row
    length."""
    out = {}
    for n in (2, 4):
        cases = {}
        for name, (kw, T, shards) in ENCODER_CASES.items():
            if shards == n:
                jkw = {k: v for k, v in kw.items() if k != "train_dtype"}
                cases[name] = (kw, DILS) + jax_case(tuple(DILS), 2, T, 2,
                                                    **jkw) + ("auto",)
        res = run_ranks(sp_case_rank, n, "cpu", cases,
                        timeout=RANK_TIMEOUT, n_time=n)
        out.update({name: [r[name] for r in res] + [r["imported"]
                                                     for r in res]
                    for name in cases})
    return out


@pytest.mark.parametrize("name", ["magenta_enc", "2019", "2019_4"])
def test_encoders_match_jax_single_device(encoder_runs, name):
    kw, T, n = ENCODER_CASES[name]
    ranks, imported = encoder_runs[name][:n], encoder_runs[name][n:]
    loss, grads, _ = jax_reference(tuple(DILS), 2, T, 2, **kw)
    for r in ranks:
        assert r["loss"] == pytest.approx(loss, rel=2e-4)
    assert imported == [[]] * n
    check_f32_grads(ranks[0]["grads"], grads)


def test_encoder_2019_bf16_keeps_an_f32_encoder(encoder_runs):
    kw, T, n = ENCODER_CASES["2019_bf16"]
    ranks = encoder_runs["2019_bf16"][:n]
    loss, grads, _ = jax_reference(tuple(DILS), 2, T, 2, **kw)
    assert ranks[0]["loss"] == pytest.approx(loss, rel=2e-2)
    check_bf16_grads(ranks[0]["grads"], grads,
                     jax_reference(tuple(DILS), 2, T, 2, encoder="2019")[1])
