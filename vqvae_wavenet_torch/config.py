"""Config loaders for the port: the reference's JSON schemas, read exactly
as vqvae_wavenet_tpu/config.py reads them (model_parameters.json and
wavenet_parameters.json, with the same optional extension keys).

The port keeps its own copy so that it never imports the JAX package.  The
Magenta family's hyperparameters are module constants of its model code
(vqvae_wavenet_torch/models/magenta.py, copied from the JAX package's
models/magenta.py); its JSON may override only the LR schedule.

``train_engine`` selects between TPU code paths in the JAX package; the
port has no engine switch (the device picks the kernel), so it accepts
only ``"auto"``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


@dataclass(frozen=True)
class WavenetConfig:
    quantization_channels: int = 256
    num_cycles: int = 3
    num_cycle_layers: int = 10
    dilation_rates: tuple = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512) * 3
    kernel_size: int = 3
    dilation_filters: int = 256
    skip_filters: int = 512
    residual_filters: int = 256
    preprocess_kernel_size: int = 32
    preprocess_filters: int = 256

    def __post_init__(self):
        object.__setattr__(self, "dilation_rates", tuple(self.dilation_rates))
        if len(self.dilation_rates) != self.num_cycles * self.num_cycle_layers:
            raise ValueError("dilation_rates length must equal num_cycles * "
                             "num_cycle_layers (reference wavenet.py:13)")

    @property
    def num_layers(self) -> int:
        return len(self.dilation_rates)

    @property
    def max_dilation(self) -> int:
        return max(self.dilation_rates)

    @property
    def receptive_field(self) -> int:
        """sum(dilations)*(K-1) + 1 + (preprocess_K - 1) (wavenet.py:16-17)."""
        rf = sum(self.dilation_rates) * (self.kernel_size - 1) + 1
        return rf + self.preprocess_kernel_size - 1

    @classmethod
    def from_json(cls, path: str) -> "WavenetConfig":
        with open(path) as f:
            args = json.load(f)
        return cls(
            quantization_channels=args["quantization_channels"],
            num_cycles=args["num_cycles"],
            num_cycle_layers=args["num_cycle_layers"],
            dilation_rates=tuple(args["dilation_rates"]),
            kernel_size=args["kernel_size"],
            dilation_filters=args["dilation_filters"],
            skip_filters=args["skip_filters"],
            residual_filters=args["residual_filters"],
            preprocess_kernel_size=args["preprocess"]["kernel_size"],
            preprocess_filters=args["preprocess"]["filters"])


@dataclass
class ModelConfig:
    encoder: str = "64"
    use_vq: bool = True
    speaker_embedding: int = 64
    k: int = 512
    latent_dim: int = 64
    beta: float = 0.25
    wavenet: WavenetConfig = field(default_factory=WavenetConfig)
    learning_rate_schedule: dict = field(default_factory=lambda: {0: 8e-5})
    verbose: bool = False
    vq_mode: str = "st"
    ema_decay: float = 0.99
    time_jitter: bool = False
    condition_upsample: bool = False
    encoder_norm: str = "batch"
    codebook_init: str = "uniform_scaling"
    model_family: str = "vqvae"
    train_dtype: str = "f32"
    train_engine: str = "auto"

    def __post_init__(self):
        if self.train_engine != "auto":
            raise ValueError(
                f"train_engine {self.train_engine!r} selects a TPU code path "
                "of the JAX package; the port takes only 'auto'")
        if self.train_dtype not in ("f32", "bf16"):
            raise ValueError(f"train_dtype {self.train_dtype!r}: want "
                             "'f32' or 'bf16'")

    @classmethod
    def from_json(cls, path: str) -> "ModelConfig":
        with open(path) as f:
            p = json.load(f)
        if p.get("model_family") == "magenta":
            # vqvae_wavenet_tpu/config.py:152-171
            from vqvae_wavenet_torch.models.magenta import (
                MAGENTA_LR_SCHEDULE, magenta_wavenet_config)
            return cls(
                model_family="magenta", encoder="Magenta", k=512,
                latent_dim=64, speaker_embedding=64, beta=0.25, use_vq=True,
                wavenet=magenta_wavenet_config(),
                learning_rate_schedule={
                    int(s): float(v) for s, v in p.get(
                        "learning_rate_schedule",
                        MAGENTA_LR_SCHEDULE).items()},
                verbose=p.get("verbose", False),
                train_dtype=p.get("train_dtype", "f32"),
                train_engine=p.get("train_engine", "auto"))
        wn_path = p["wavenet_parameters"]
        if not os.path.isabs(wn_path):
            candidate = os.path.join(os.path.dirname(os.path.abspath(path)),
                                     wn_path)
            wn_path = candidate if os.path.exists(candidate) else wn_path
        return cls(
            encoder=p["encoder"], use_vq=p["use_vq"],
            speaker_embedding=p["speaker_embedding"], k=p["k"],
            latent_dim=p["latent_dim"], beta=p["beta"],
            wavenet=WavenetConfig.from_json(wn_path),
            learning_rate_schedule={
                int(s): float(v)
                for s, v in p.get("learning_rate_schedule",
                                  {"0": 8e-5}).items()},
            verbose=p.get("verbose", False),
            vq_mode=p.get("vq_mode", "st"),
            ema_decay=p.get("ema_decay", 0.99),
            time_jitter=p.get("time_jitter", False),
            condition_upsample=p.get("condition_upsample", False),
            encoder_norm=p.get("encoder_norm", "batch"),
            codebook_init=p.get("codebook_init", "uniform_scaling"),
            train_dtype=p.get("train_dtype", "f32"),
            train_engine=p.get("train_engine", "auto"))
