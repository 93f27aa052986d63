"""Config loaders for the port: the reference's JSON schemas, read exactly
as vqvae_wavenet_tpu/config.py reads them (model_parameters.json and
wavenet_parameters.json, with the same optional extension keys).

The port keeps its own copy so that it never imports the JAX package; the
Magenta family (whose hyperparameters live in the JAX model code) is not
ported yet.
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
    vq_mode: str = "st"
    condition_upsample: bool = False
    encoder_norm: str = "batch"
    model_family: str = "vqvae"

    @classmethod
    def from_json(cls, path: str) -> "ModelConfig":
        with open(path) as f:
            p = json.load(f)
        if p.get("model_family") == "magenta":
            raise NotImplementedError("the Magenta family is not ported to "
                                      "torch yet")
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
            vq_mode=p.get("vq_mode", "st"),
            condition_upsample=p.get("condition_upsample", False),
            encoder_norm=p.get("encoder_norm", "batch"))
