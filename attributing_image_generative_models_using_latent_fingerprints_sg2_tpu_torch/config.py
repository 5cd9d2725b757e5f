"""Configuration dataclasses (the reference's ``config.py``, cut to the port's slice).

Field names and defaults are the reference's; knobs of features the port
does not carry yet are absent, and the CLI refuses their flags
(``cli/common.py``).  ``Config.to_dict`` / ``from_dict`` are the saved form
of a resumable run (``checkpoints/state.py``); a dictionary written by the
reference package loads here (unknown keys are ignored) and the other way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Generator architecture (ref ``src/params.py:4-12``)."""

    model: str = "sg2"  # "sg2" | "biggan"
    img_size: int = 256
    style_dim: int = 512
    n_mlp: int = 8
    channel_multiplier: int = 2
    channel_max: int = 512  # cap on per-resolution channels (512 = reference)
    blur_kernel: Tuple[int, ...] = (1, 3, 3, 1)
    lr_mlp: float = 0.01
    ckpt: Optional[str] = "./checkpoint/550000.pt"
    biggan_label: str = "golden retriever"

    @property
    def style_space_dim(self) -> int:
        """The fingerprinted latent's dimension: w for sg2, BigGAN's 128-d
        truncated noise for biggan."""
        return self.style_dim if self.model == "sg2" else 128

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
    # coarse-to-fine (mse only): compare Gaussian-blurred estimate and target,
    # sigma annealed linearly from ctf_sigma0 to 0 over ctf_frac of the steps
    coarse_to_fine: bool = False
    ctf_sigma0: float = 2.0
    ctf_frac: float = 0.5
    # after the solve, greedy sign flips of single key logits at fixed alpha;
    # a flip must lower the loss by the relative margin.  0 = off
    polish_sweeps: int = 0
    polish_margin: float = 0.05
    # successive halving: all restarts run prune_frac of the steps, then the
    # best prune_starts per sample run the rest.  0 = off
    prune_starts: int = 0
    prune_frac: float = 0.25
    # attack-aware solving: name of the known channel the estimate is pushed
    # through before the loss (attacks.make_solver_attack).  "None" = off
    solver_attack: str = "None"


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Robustness attack settings (ref ``src/params.py:27-31``)."""

    augmentation: str = "None"  # None | Noise | Blur | Jpeg | Crop | Combination
    jpeg_quality: int = 50
    noise_sigma: float = 0.1
    blur_sigma: float = 0.5
    blur_filter_size: int = 25
    crop_ratio: float = 0.9


@dataclasses.dataclass(frozen=True)
class RunConfig:
    sample_size: int = 100
    batch_size: int = 1
    save_dir: str = "./result/"
    seed: int = 0
    device: str = "cuda"
    dtype: str = "float32"  # compute dtype of synthesis and LPIPS in the solve ("float32" | "bfloat16")
    remat: bool = False  # gradient-checkpoint the synthesis blocks in the solve (torch.utils.checkpoint)
    mesh_data: int = 1  # data-parallel ranks (samples x starts, the batch): parallel/mesh.py
    mesh_model: int = 1  # model-parallel ranks (the styled convs' output channels)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    fingerprint: FingerprintConfig = FingerprintConfig()
    attribution: AttributionConfig = AttributionConfig()
    attack: AttackConfig = AttackConfig()
    run: RunConfig = RunConfig()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """Inverse of ``to_dict`` after a JSON round trip: lists become tuples
        again, unknown keys are ignored."""

        def coerce(dc_cls, sub: dict):
            names = {f.name for f in dataclasses.fields(dc_cls)}
            return dc_cls(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in sub.items() if k in names})

        return cls(
            model=coerce(ModelConfig, d.get("model", {})),
            fingerprint=coerce(FingerprintConfig, d.get("fingerprint", {})),
            attribution=coerce(AttributionConfig, d.get("attribution", {})),
            attack=coerce(AttackConfig, d.get("attack", {})),
            run=coerce(RunConfig, d.get("run", {})),
        )
