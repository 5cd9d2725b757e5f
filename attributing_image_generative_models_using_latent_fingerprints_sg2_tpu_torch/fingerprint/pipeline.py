"""The fingerprinting pipeline: generator weights + basis + noise, built once.

Counterpart of the sg2 parts of the reference package's
``fingerprint/pipeline.py``: ``build_pipeline`` (weights -> PCA -> basis ->
fixed synthesis noise -> LPIPS -> attack), ``generate_fingerprinted``,
``synthesize`` and ``augment``.  Every random draw comes from an explicit ``torch.Generator``
(on the CPU, so a seed gives the same draws on every device) and can be
replaced by given arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..attacks import AttackFn, apply_attack, make_attack
from ..config import AttackConfig, FingerprintConfig, ModelConfig
from ..losses import lpips as lpips_mod
from ..models import stylegan2 as sg2
from ..utils.device import resolve_device
from .embed import FingerprintBasis, build_basis, embed, sample_alpha, sample_key_bits
from .pca import PCABasis, perform_pca_for_params


@dataclasses.dataclass
class Pipeline:
    mcfg: ModelConfig
    fpcfg: FingerprintConfig
    gen_params: Any
    basis: FingerprintBasis
    pca: PCABasis
    noise: List[torch.Tensor]
    device: torch.device
    lpips_params: Optional[Any] = None
    attack: Optional[AttackFn] = None


def build_pipeline(
    mcfg: ModelConfig,
    fpcfg: FingerprintConfig,
    *,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    attack_cfg: Optional[AttackConfig] = None,
    gen_params: Any = None,
    ckpt_path: Optional[str] = None,
    lpips_params: Any = None,
    want_lpips: bool = True,
    pca_z: Optional[torch.Tensor] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> Pipeline:
    """Load or draw the generator, run PCA on ``device``, slice the basis,
    draw the fixed synthesis noise, make random LPIPS if wanted, and build
    the eval-mode attack of ``attack_cfg``.
    ``device`` is the card unless the caller asks for ``"cpu"``; without a
    CUDA device the default raises (``utils.device.resolve_device``).

    Draw order from ``generator``: generator weights, PCA latents, noise,
    LPIPS weights (each skipped when given)."""
    if mcfg.model != "sg2":
        raise NotImplementedError(f"--model {mcfg.model}: not yet ported (sg2 only)")
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    if gen_params is None:
        if ckpt_path is not None:
            from ..checkpoints.rosinality import load_generator

            gen_params = load_generator(ckpt_path, mcfg, device)
        else:
            gen_params = sg2.init_generator_params(mcfg, g, device)
    pca = perform_pca_for_params(gen_params, mcfg.lr_mlp, fpcfg.n_pca_samples,
                                 mcfg.style_space_dim, generator=g, z=pca_z)
    basis = build_basis(pca, fpcfg)
    if noise is None:
        noise = sg2.make_noise(mcfg.img_size, g, device)
    noise = [torch.as_tensor(n, dtype=torch.float32).to(device) for n in noise]
    if lpips_params is None and want_lpips:
        lpips_params = lpips_mod.init_lpips_params(g, device)
    return Pipeline(mcfg=mcfg, fpcfg=fpcfg, gen_params=gen_params, basis=basis, pca=pca,
                    noise=noise, lpips_params=lpips_params, device=device,
                    attack=make_attack(attack_cfg) if attack_cfg is not None else None)


@torch.no_grad()
def synthesize(pipe: Pipeline, w: torch.Tensor) -> torch.Tensor:
    """Image [B, H, W, 3] for latents w [B, D] with the pipeline's fixed noise."""
    return sg2.generate(pipe.gen_params, [w], pipe.mcfg, input_is_latent=True, noise=pipe.noise)


@torch.no_grad()
def generate_fingerprinted(
    pipe: Pipeline,
    batch: int = 1,
    generator: Optional[torch.Generator] = None,
    alpha: Optional[torch.Tensor] = None,
    bits: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(imgs, w0, wx, key_bits, alpha): random content + random key, or the
    given ``alpha`` / ``bits``."""
    if alpha is None:
        alpha = sample_alpha(pipe.basis, batch, generator)
    if bits is None:
        bits = sample_key_bits(pipe.fpcfg.key_len, batch, generator, pipe.device)
    alpha = torch.as_tensor(alpha, dtype=torch.float32).to(pipe.device)
    bits = torch.as_tensor(bits, dtype=torch.float32).to(pipe.device)
    w0, wx = embed(pipe.basis, alpha, bits)
    return synthesize(pipe, wx), w0, wx, bits, alpha


@torch.no_grad()
def augment(pipe: Pipeline, imgs: torch.Tensor, generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The pipeline's eval-mode attack on ``imgs`` (the identity if none);
    random attacks draw from ``generator`` or take the unit-normal ``noise``."""
    return apply_attack(pipe.attack, imgs, generator, noise)
