"""vqvae_wavenet_torch — the PyTorch/CUDA port of vqvae_wavenet_tpu's
voice-conversion path, for NVIDIA Hopper (sm_90a).

Layout mirrors the JAX package so each module's counterpart is easy to find:
  ops/        — mu-law codec, conv1d, and the hand-written CUDA kernels'
                wrappers (VQ nearest-code search, whole-clip generation)
                with their plain PyTorch twins; ``_build`` compiles csrc/.
  models/     — Encoder_64, VQ lookup, VQVAE encode (local condition).
  generation/ — whole-clip autoregressive WaveNet generation.
  training/   — train state, optimizer step, checkpoints, metrics.
  parallel/   — ranks and exchanges of sequence-parallel training.
  params.py   — the weight bridge (JAX pytree <-> flat .npz <-> tensors).
  config.py, data.py — JSON config and wav/speaker-table readers.
  generate.py — the voice-conversion CLI (python -m vqvae_wavenet_torch.generate).

The package imports torch and never jax, nor the JAX package.
"""

__version__ = "0.1.0"
