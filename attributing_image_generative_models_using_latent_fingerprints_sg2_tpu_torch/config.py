"""Configuration dataclasses (the reference's ``config.py``, cut to the port's slice).

Field names and defaults are the reference's; knobs of features the port
does not carry yet are absent, and the CLI refuses their flags
(``cli/common.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Generator architecture (ref ``src/params.py:4-12``)."""

    model: str = "sg2"
    img_size: int = 256
    style_dim: int = 512
    n_mlp: int = 8
    channel_multiplier: int = 2
    channel_max: int = 512  # cap on per-resolution channels (512 = reference)
    blur_kernel: Tuple[int, ...] = (1, 3, 3, 1)
    lr_mlp: float = 0.01
    ckpt: Optional[str] = "./checkpoint/550000.pt"

    @property
    def style_space_dim(self) -> int:
        return self.style_dim

    @property
    def n_latent(self) -> int:
        return int(math.log2(self.img_size)) * 2 - 2


@dataclasses.dataclass(frozen=True)
class FingerprintConfig:
    """Key embedding: V = pc[shift : shift+key_len], wx = w0 + c V^T S k."""

    key_len: int = 64
    shift: int = 448
    sigma: float = 1.0
    sd_moved: float = 1.0
    n_pca_samples: int = 10000


@dataclasses.dataclass(frozen=True)
class AttributionConfig:
    """Inversion solver settings (ref ``src/main.py:42-89``)."""

    steps: int = 2000
    n_starts: int = 20
    lr: float = 0.2
    lr_decay: float = 0.001  # lr * exp(-decay * (i+1)) at step i
    bound_weight: float = 0.1
    loss: str = "perceptual"  # "perceptual" | "mse"


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    augmentation: str = "None"  # only "None" is ported


@dataclasses.dataclass(frozen=True)
class RunConfig:
    sample_size: int = 100
    batch_size: int = 1
    save_dir: str = "./result/"
    seed: int = 0
    device: str = "cuda"


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    fingerprint: FingerprintConfig = FingerprintConfig()
    attribution: AttributionConfig = AttributionConfig()
    attack: AttackConfig = AttackConfig()
    run: RunConfig = RunConfig()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
