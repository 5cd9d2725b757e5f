"""The fingerprinting pipeline: generator weights + basis + noise, built once.

Counterpart of the reference package's ``fingerprint/pipeline.py``:
``build_pipeline`` (weights -> PCA -> basis -> fixed synthesis noise -> LPIPS
-> attack), ``generate_fingerprinted``, ``synthesize``, ``synthesize_mixed``,
``augment``, ``get_watermarked_images`` and ``generate_with_latent``, for
both model families: StyleGAN2 (W space, fixed noise maps) and BigGAN-deep
(its truncated-noise latent, a one-hot class, truncation 0.4, no noise).
Every random draw comes from an explicit ``torch.Generator`` (on the CPU, so
a seed gives the same draws on every device) and can be replaced by given
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..attacks import AttackFn, apply_attack, make_attack
from ..config import AttackConfig, FingerprintConfig, ModelConfig
from ..losses import lpips as lpips_mod
from ..models import biggan as bg
from ..models import stylegan2 as sg2
from ..utils.device import resolve_device
from ..utils.lhs import fold_in
from .embed import (FingerprintBasis, build_basis, embed, key_offset, project_latent, sample_alpha,
                    sample_key_bits)
from .pca import PCABasis, pca_from_truncated_noise, perform_pca_for_params


@dataclasses.dataclass
class Pipeline:
    mcfg: ModelConfig
    fpcfg: FingerprintConfig
    gen_params: Any
    basis: FingerprintBasis
    pca: PCABasis
    noise: List[torch.Tensor]  # empty for BigGAN
    device: torch.device
    lpips_params: Optional[Any] = None
    attack: Optional[AttackFn] = None
    # BigGAN: architecture, class conditioning [1, num_classes] and truncation
    biggan_cfg: Optional[bg.BigGANConfig] = None
    class_onehot: Optional[torch.Tensor] = None
    truncation: float = 0.4


def solver_kwargs(pipe: Pipeline) -> Dict[str, Any]:
    """The family arguments ``fingerprint.attribute`` takes beside the
    generator weights, basis and noise."""
    return dict(biggan_cfg=pipe.biggan_cfg, class_onehot=pipe.class_onehot, truncation=pipe.truncation)


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
    biggan_cfg: Optional[bg.BigGANConfig] = None,
    truncation: float = 0.4,
) -> Pipeline:
    """Load or draw the generator, run PCA on ``device``, slice the basis,
    draw the fixed synthesis noise, make random LPIPS if wanted, and build
    the eval-mode attack of ``attack_cfg``.
    ``device`` is the card unless the caller asks for ``"cpu"``; without a
    CUDA device the default raises (``utils.device.resolve_device``).

    ``mcfg.model == "biggan"`` builds the reference's second family
    (``biggan_cfg``, by default the published BigGAN-deep of ``mcfg.img_size``,
    256 or 512: ``BigGANConfig.for_size``): PCA over truncated noise at
    ``truncation`` (``pca_z`` replaces the draw), the class of
    ``mcfg.biggan_label``, no synthesis noise.

    Draw order from ``generator``: generator weights, PCA latents, noise
    (StyleGAN2), LPIPS weights (each skipped when given)."""
    if mcfg.model not in ("sg2", "biggan"):
        raise ValueError(f"Not Avail GANs: {mcfg.model!r}")
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    extra: Dict[str, Any] = {}
    if mcfg.model == "biggan":
        bg_cfg = biggan_cfg or bg.BigGANConfig.for_size(mcfg.img_size)
        if bg_cfg.img_size != mcfg.img_size:
            raise ValueError(f"BigGAN layers make {bg_cfg.img_size}px images; img_size is {mcfg.img_size}")
        if gen_params is None:
            if ckpt_path is not None:
                from ..checkpoints.rosinality import load_torch_state_dict

                gen_params = bg.params_from_torch_state_dict(load_torch_state_dict(ckpt_path), bg_cfg,
                                                             device=device)
            else:
                gen_params = bg.init_biggan_params(bg_cfg, g, device)
        pca = pca_from_truncated_noise(truncation, fpcfg.n_pca_samples, bg_cfg.z_dim, device=device,
                                       generator=g, z=pca_z)
        noise = []
        onehot = bg.one_hot_from_name(mcfg.biggan_label, bg_cfg.num_classes, 1)
        extra = dict(biggan_cfg=bg_cfg, class_onehot=torch.from_numpy(onehot).to(device), truncation=truncation)
    else:
        if gen_params is None:
            if ckpt_path is not None:
                from ..checkpoints.rosinality import load_generator

                gen_params = load_generator(ckpt_path, mcfg, device)
            else:
                gen_params = sg2.init_generator_params(mcfg, g, device)
        pca = perform_pca_for_params(gen_params, mcfg.lr_mlp, fpcfg.n_pca_samples,
                                     mcfg.style_space_dim, generator=g, z=pca_z)
        if noise is None:
            noise = sg2.make_noise(mcfg.img_size, g, device)
        noise = [torch.as_tensor(n, dtype=torch.float32).to(device) for n in noise]
    basis = build_basis(pca, fpcfg)
    if lpips_params is None and want_lpips:
        lpips_params = lpips_mod.init_lpips_params(g, device)
    return Pipeline(mcfg=mcfg, fpcfg=fpcfg, gen_params=gen_params, basis=basis, pca=pca,
                    noise=noise, lpips_params=lpips_params, device=device,
                    attack=make_attack(attack_cfg) if attack_cfg is not None else None, **extra)


@torch.no_grad()
def synthesize(pipe: Pipeline, w: torch.Tensor) -> torch.Tensor:
    """Image [B, H, W, 3] for latents w [B, D]: StyleGAN2 with the pipeline's
    fixed noise, or BigGAN with its class and truncation."""
    if pipe.mcfg.model == "biggan":
        onehot = pipe.class_onehot.expand(w.shape[0], -1)
        return bg.generate(pipe.gen_params, w, onehot, pipe.truncation, pipe.biggan_cfg)
    return sg2.generate(pipe.gen_params, [w], pipe.mcfg, input_is_latent=True, noise=pipe.noise)


@torch.no_grad()
def synthesize_mixed(pipe: Pipeline, w_content: torch.Tensor, w_fingerprint: torch.Tensor,
                     inject_index: Optional[int] = None) -> torch.Tensor:
    """Style-mixing synthesis (StyleGAN2): the content style for the first
    ``inject_index`` layers, the fingerprinted one for the rest.  The
    reference's ``style_mixing`` switch (default off) sets inject_index =
    n_latent - 1, so by default only the last layer takes the fingerprint."""
    if pipe.mcfg.model != "sg2":
        raise ValueError("style mixing is an sg2 feature")
    if inject_index is None:
        inject_index = pipe.mcfg.n_latent - 1
    return sg2.generate(pipe.gen_params, [w_content, w_fingerprint], pipe.mcfg, input_is_latent=True,
                        inject_index=inject_index, noise=pipe.noise)


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


@torch.no_grad()
def get_watermarked_images(pipe: Pipeline, generator: Optional[torch.Generator] = None, batch: int = 1
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(original, watermarked, attacked) images in [-1, 1]: a fingerprinted
    batch drawn from ``fold_in(generator, 0)``, the same content without the
    key, and the watermarked images through the pipeline's attack (its random
    draws from ``fold_in(generator, 1)``)."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    imgs, w0, _, _, _ = generate_fingerprinted(pipe, batch, fold_in(g, 0))
    return synthesize(pipe, w0), imgs, augment(pipe, imgs, fold_in(g, 1))


@torch.no_grad()
def generate_with_latent(pipe: Pipeline, generator: Optional[torch.Generator], latent_w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fingerprint arbitrary latents w [B, D]: project them onto the content
    subspace (:func:`embed.project_latent`, no mean added), add the key offset
    of random bits drawn from ``generator``.  Returns (imgs, w0, wx, bits)."""
    latent_w = torch.as_tensor(latent_w, dtype=torch.float32).to(pipe.device)
    bits = sample_key_bits(pipe.fpcfg.key_len, latent_w.shape[0], generator, pipe.device)
    w0 = project_latent(pipe.basis, latent_w)
    wx = w0 + key_offset(pipe.basis, bits)
    return synthesize(pipe, wx), w0, wx, bits
