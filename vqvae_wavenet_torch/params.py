"""The weight bridge between the JAX package and the port.

Parameters keep the JAX pytree's structure and layouts (conv kernels
[K, C_in, C_out], per-layer decoder parameters stacked [L, ...]); only the
leaves change from numpy arrays to torch tensors.  On disk they are one
flat ``.npz`` keyed ``params/a/b/c`` and ``state/a/b/c`` (list entries by
index), written by ``save_npz`` (or tools/export_torch_npz.py from an orbax
checkpoint) and read by ``load_npz``.

``random_params_np`` builds a tree with the JAX shapes and init limits from
a numpy seed (models/vqvae.py:46-74, encoders.py:38-46, 104-221,
wavenet.py:35-81, ops/conv.py:30-41, vq.py:35-49, models/magenta.py:72-117),
so the port can run and train at full width without jax.  ``from_jax_tree``
carries any encoder's tree (Encoder_64, Encoder_Magenta, Encoder_2019),
``from_jax_prior`` a prior's.  ``from_jax_train_state`` carries a whole
JAX train state (params, EMA shadows, optax Adam moments and count, model
state, step) into the port's (training/train_loop.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# the parameter groups the voice-conversion path reads
_PARAM_KEYS = ("encoder", "vq", "speaker_embedding", "speaker_emb",
               "cond_conv", "decoder")
_STATE_KEYS = ("encoder",)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def to_torch(tree, device=None):
    """numpy (or array-like) leaves -> torch tensors."""
    return _map(tree, lambda x: torch.as_tensor(np.array(x), device=device))


def from_jax_tree(params, state=None, device=None):
    """A JAX (params, model_state) pair with numpy leaves -> the port's
    (params, state) of torch tensors, keeping the groups the port uses:
    encoder, vq, speaker_embedding (Magenta: speaker_emb), cond_conv and
    decoder parameters, and the encoder's batch-norm statistics."""
    p = {k: to_torch(params[k], device) for k in _PARAM_KEYS
         if params.get(k) is not None}
    s = {k: to_torch(state[k], device) for k in _STATE_KEYS
         if state is not None and state.get(k) is not None}
    return p, s


def from_jax_prior(prior, device=None):
    """A JAX prior's parameters (vqvae_wavenet_tpu/models/prior.py's tree
    with numpy leaves) -> the port's: the same tree of torch tensors
    (models/prior.py keeps JAX's structure and layouts)."""
    return to_torch(prior, device)


def from_jax_train_state(ts, device=None):
    """A JAX train state with numpy leaves (jax.device_get of
    training/train_loop.py::init_train_state's dict; opt_state is optax's
    (ScaleByAdamState, ScaleByScheduleState)) -> the port's train state.
    Both families: the Magenta family's state has the same layout (its
    Adam runs with beta1 0.5) and an empty model state."""
    adam = ts["opt_state"][0]

    def tree(t):
        return to_torch({k: v for k, v in t.items() if v is not None},
                        device)

    return {"params": tree(ts["params"]),
            "ema_params": tree(ts["ema_params"]),
            "model_state": tree(ts["model_state"]),
            "opt_state": {"mu": tree(adam.mu), "nu": tree(adam.nu),
                          "count": int(np.asarray(adam.count))},
            "step": int(np.asarray(ts["step"]))}


def flatten(tree, prefix, out):
    """Flatten a tree into ``out`` as {"prefix/a/b": numpy array}."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flatten(v, f"{prefix}/{i}", out)
    elif tree is not None:
        out[prefix] = (tree.detach().cpu().numpy()
                       if isinstance(tree, torch.Tensor) else np.asarray(tree))


def _unflatten(flat):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_npz(path: str, params, state) -> None:
    """Write (params, state) -- torch or numpy leaves -- as one flat npz."""
    flat: dict = {}
    flatten(params, "params", flat)
    flatten(state, "state", flat)
    np.savez(path, **flat)


def load_tree(path: str, device=None, prefixes=None):
    """Read a flat npz -> its tree of torch tensors (only the keys under
    ``prefixes``, such as "params" or "train/params", when given)."""
    with np.load(path) as z:
        keys = [k for k in z.files if prefixes is None
                or any(k.startswith(p + "/") for p in prefixes)]
        return to_torch(_unflatten({k: z[k] for k in keys}), device)


def load_npz(path: str, device=None, *, raw_params: bool = False):
    """Read a ``save_npz`` file (or a training checkpoint) -> (params,
    state) of torch tensors.  With ``raw_params`` a training checkpoint's
    trained parameters (train/params) are returned instead of its EMA
    shadows: the Magenta family generates from those, as the JAX
    generate.py does (generate.py:121-124); a file without them gives its
    params.  Only the one parameter tree returned is read."""
    with np.load(path) as z:
        raw = raw_params and any(k.startswith("train/params/")
                                 for k in z.files)
    tree = load_tree(path, device, prefixes=(
        "train/params" if raw else "params", "state"))
    params = tree["train"]["params"] if raw else tree.get("params", {})
    return params, tree.get("state", {})


def lc_channels(cfg, num_speakers: Optional[int]) -> int:
    """Local-condition width (models/vqvae.py:37-43)."""
    base = 128 if cfg.condition_upsample else cfg.latent_dim
    if num_speakers is None or cfg.condition_upsample:
        return base
    gc = cfg.speaker_embedding if cfg.speaker_embedding > 0 else num_speakers
    return cfg.latent_dim + gc


def _uniform_inits(rng):
    """(glorot, uus) initialisers drawing from ``rng``."""
    def uniform(shape, limit):
        return rng.uniform(-limit, limit, size=shape).astype(np.float32)

    def glorot(shape):                                   # encoders.py:38-46
        if len(shape) == 3:
            fan_in, fan_out = shape[0] * shape[1], shape[0] * shape[2]
        else:
            fan_in, fan_out = shape[0], shape[-1]
        return uniform(shape, np.sqrt(6.0 / (fan_in + fan_out)))

    def uus(shape, factor=1.0):                          # ops/conv.py:30-41
        fan = float(np.prod(shape[:-1])) if len(shape) > 1 else float(shape[0])
        return uniform(shape, factor * np.sqrt(3.0 / fan))

    return glorot, uus


def _decoder_np(w, c_lc: Optional[int], uus, c_gc: Optional[int] = None,
                bias: float = 0.0):
    """WaveNet decoder parameters (wavenet.py:35-81) for WavenetConfig
    ``w``: kernels uniform-unit-scaling, every bias ``bias``; lc and gc
    kernels (per layer and in postprocess1) when ``c_lc`` / ``c_gc`` is
    given."""
    L, K = w.num_layers, w.kernel_size
    R, D, S = w.residual_filters, w.dilation_filters, w.skip_filters
    Q, PK, PF = (w.quantization_channels, w.preprocess_kernel_size,
                 w.preprocess_filters)

    def stack(shape):
        return np.stack([uus(shape) for _ in range(L)])

    def b(*shape):
        return np.full(shape, bias, np.float32)

    dec = {
        "preprocess": {"kernel": uus((PK, 1, PF)), "bias": b(PF)},
        "skip_start": {"kernel": uus((1, PF, S)), "bias": b(S)},
        "layers": {"kernel": stack((K, R, 2 * D)), "bias": b(L, 2 * D),
                   "skip_kernel": stack((D, S)), "skip_bias": b(L, S),
                   "res_kernel": stack((D, R)), "res_bias": b(L, R)},
        "postprocess1": {"kernel": uus((1, S, S)), "bias": b(S)},
        "postprocess2": {"kernel": uus((1, S, Q)), "bias": b(Q)},
    }
    if c_lc is not None:
        dec["layers"]["lc_kernel"] = stack((c_lc, 2 * D))
        dec["postprocess1"]["lc_kernel"] = uus((c_lc, S))
    if c_gc is not None:
        dec["layers"]["gc_kernel"] = stack((c_gc, 2 * D))
        dec["postprocess1"]["gc_kernel"] = uus((c_gc, S))
    return dec


def _random_magenta_np(num_speakers: int, rng):
    """init_magenta_params (models/magenta.py:72-117): uniform-unit-scaling
    kernels, every conv bias 1.0 (masked.py:72), the per-layer and
    postprocess1 gc biases 1.0."""
    from vqvae_wavenet_torch.models import magenta as m
    _, uus = _uniform_inits(rng)

    def conv_p(ksize, cin, cout):
        return {"kernel": uus((ksize, cin, cout)),
                "bias": np.ones(cout, np.float32)}

    encoder = {
        "startconv": conv_p(1, 1, m.AE_WIDTH),
        "layers": [
            {"conv": conv_p(m.AE_FILTER_LENGTH, m.AE_WIDTH, m.AE_WIDTH),
             "gate": conv_p(m.AE_FILTER_LENGTH, m.AE_WIDTH, m.AE_WIDTH),
             "res": conv_p(1, m.AE_WIDTH, m.AE_WIDTH)}
            for _ in range(m.AE_NUM_LAYERS)],
        "bottleneck": conv_p(1, m.AE_WIDTH, m.AE_BOTTLENECK_WIDTH),
    }
    w = m.magenta_wavenet_config()
    decoder = _decoder_np(w, m.AE_BOTTLENECK_WIDTH, uus,
                          c_gc=m.AE_BOTTLENECK_WIDTH, bias=1.0)
    decoder["layers"]["gc_bias"] = np.ones(
        (w.num_layers, 2 * w.dilation_filters), np.float32)
    decoder["postprocess1"]["gc_bias"] = np.ones(w.skip_filters, np.float32)
    return {"encoder": encoder,
            "vq": {"embedding": uus((m.K_CODES, m.AE_BOTTLENECK_WIDTH))},
            "speaker_emb": uus((num_speakers, m.AE_BOTTLENECK_WIDTH)),
            "decoder": decoder}


def _encoder_np(name: str, latent_dim: int, glorot, uus):
    """(params, state) of an encoder in the JAX shapes and init limits
    (encoders.py:104-122, 157-179, 206-221): Encoder_64 glorot, 768
    filters, k=5, batch norm at scale 1 / bias 0 / mean 0 / var 1;
    Encoder_Magenta uniform unit scaling, 128 filters, k=5; Encoder_2019
    glorot, 768 filters.  Biases zero; only Encoder_64 has state."""
    def zeros(*shape):
        return np.zeros(shape, np.float32)

    if name == "Magenta":
        f, k = 128, 5

        def conv(ksize, cin, cout):
            return {"kernel": uus((ksize, cin, cout)), "bias": zeros(cout)}

        return {"preprocess": conv(k, 1, f),
                "layers": [{"down": conv(1, f, f), "gate": conv(k, f, f),
                            "filter": conv(k, f, f),
                            "residual": conv(1, f, f)} for _ in range(6)],
                "postprocess": conv(1, f, latent_dim)}, {}
    if name == "2019":
        f = 768

        def conv(ksize, cin, cout):
            return {"kernel": glorot((ksize, cin, cout)), "bias": zeros(cout)}

        return {"pre1": conv(3, 13, f), "pre2": conv(3, f, f),
                "strided": conv(4, f, f),
                "res": [conv(3, f, f) for _ in range(2)],
                "relu": [conv(3, f, f) for _ in range(4)],
                "out": conv(1, f, latent_dim)}, {}
    if name != "64":
        raise NotImplementedError(f"encoder {name!r} not implemented")
    # Encoder_64: 6 x conv k=5 f=768
    filters, c_in = 768, 1
    convs, bn, bn_state = [], [], []
    for _ in range(6):
        convs.append({"kernel": glorot((5, c_in, filters)),
                      "bias": zeros(filters)})
        c_in = filters
    for c in [filters] * 6 + [latent_dim]:
        bn.append({"scale": np.ones(c, np.float32), "bias": zeros(c)})
        bn_state.append({"mean": zeros(c), "var": np.ones(c, np.float32)})
    return ({"convs": convs,
             "out": {"kernel": glorot((1, filters, latent_dim)),
                     "bias": zeros(latent_dim)},
             "bn": bn}, {"bn": bn_state})


def random_wavenet_np(w, lc_channels: Optional[int] = None,
                      gc_channels: Optional[int] = None, seed: int = 0):
    """A random WaveNet parameter tree alone (the standalone trainer's,
    wavenet.py:35-81) for WavenetConfig ``w``, with lc / gc kernels when
    their widths are given.  Leaves are float32 numpy arrays."""
    _, uus = _uniform_inits(np.random.default_rng(seed))
    return _decoder_np(w, lc_channels, uus, gc_channels)


def random_params_np(cfg, num_speakers: Optional[int], seed: int = 0):
    """A random (params, state) tree in the JAX shapes and init limits for
    a ModelConfig with any of the three encoders, or of the Magenta family
    (whose model state is empty).  Leaves are float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    if cfg.model_family == "magenta":
        return _random_magenta_np(num_speakers or 109, rng), {}
    glorot, uus = _uniform_inits(rng)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    enc_params, enc_state = _encoder_np(cfg.encoder, cfg.latent_dim, glorot,
                                        uus)
    params = {"encoder": enc_params}
    state = {"encoder": enc_state}
    if cfg.use_vq:
        if getattr(cfg, "codebook_init", "uniform_scaling") == "normal":
            emb = rng.standard_normal((cfg.k, cfg.latent_dim)).astype(
                np.float32)
        else:
            emb = uus((cfg.k, cfg.latent_dim), 1.7)
        params["vq"] = {"embedding": emb}
        if cfg.vq_mode == "ema":
            state["vq"] = {"ema_cluster_size": zeros(cfg.k),
                           "ema_means": emb.copy()}
    if num_speakers is not None and cfg.speaker_embedding > 0:
        params["speaker_embedding"] = uus(
            (num_speakers, cfg.speaker_embedding), 2.0)
    c_lc = lc_channels(cfg, num_speakers)
    if cfg.condition_upsample:
        gc = 0 if num_speakers is None else (
            cfg.speaker_embedding if cfg.speaker_embedding > 0
            else num_speakers)
        params["cond_conv"] = {"kernel": glorot((3, cfg.latent_dim + gc, 128)),
                               "bias": zeros(128)}
    params["decoder"] = _decoder_np(cfg.wavenet, c_lc, uus)
    return params, state
