"""Capacity-quality sweep: key_len x sigma x shift against watermark visibility.

Counterpart of the reference package's ``eval/sweep.py``.  For each grid
point it

1. slices the fingerprint basis at (key_len, sigma, shift),
2. renders fingerprinted samples and their content-only counterparts,
3. measures watermark visibility: LPIPS and MSE between the two, and
   optionally FID (random Inception) and the Frechet distance over a trained
   discriminator's features between the two populations,
4. solves the fingerprinted images and records bit accuracy, exact-match
   accuracy and the cosine of the recovered content latent to the true one.

One generator and one PCA serve the whole grid (slicing the basis is free).

Draws (another stream than the reference's PRNG keys): the pipeline from
``torch.Generator().manual_seed(seed)``; a point's seed is ``seed`` folded
with the reference's ``hash((key_len, shift)) % 2**30`` (as
``eval/study.py::point_seed`` folds its own hash), and gives the content
(``fold_in(., 0)``), the key bits (1) and the solve (3).  The default LPIPS
is random VGG from ``manual_seed(7)``, Inception from ``manual_seed(11)``
(the reference's ``PRNGKey(7)`` / ``PRNGKey(11)``).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Any, List, Optional, Sequence

import torch

from ..config import AttributionConfig, FingerprintConfig, ModelConfig
from ..fingerprint import attribute as attr
from ..fingerprint import embed as fpe
from ..fingerprint import pipeline as pl
from ..losses import lpips as lpips_mod
from ..utils.lhs import fold_in


@dataclasses.dataclass
class SweepPoint:
    key_len: int
    sigma: float
    shift: int
    mean_bit_acc: float
    attribution_acc: float
    watermark_lpips: float
    watermark_mse: float
    mean_latent_cos: float = float("nan")  # recovered-vs-true content latent
    fid: Optional[float] = None
    fid_disc: Optional[float] = None  # trained-discriminator features


def sweep_point_seed(seed: int, key_len: int, shift: int) -> int:
    """The seed of one grid point's draws: ``seed`` folded with the
    reference's ``hash((key_len, shift)) % 2**30``."""
    return fold_in(seed, hash((key_len, shift)) % (1 << 30)).initial_seed()


def run_sweep(
    seed: int,
    mcfg: ModelConfig,
    *,
    key_lens: Sequence[int] = (32, 64, 128),
    sigmas: Sequence[float] = (1.0,),
    shifts: Optional[Sequence[int]] = None,
    samples: int = 4,
    acfg: Optional[AttributionConfig] = None,
    ckpt_path: Optional[str] = None,
    with_fid: bool = False,
    dtype: str = "float32",
    lpips_params: Any = None,
    disc_params: Any = None,
    clip_targets: bool = True,
    device="cuda",
) -> List[SweepPoint]:
    """The grid's points in key_len, sigma, shift order (a point whose key
    band leaves the W space is skipped).  ``shifts`` None puts each key on the
    last ``key_len`` axes.  ``clip_targets`` clips both renders to [-1, 1] (the
    stored, deployed images) before they are measured and solved.  On the card
    unless ``device="cpu"``."""
    acfg = acfg or AttributionConfig(steps=200, n_starts=4, loss="mse")
    if acfg.solver_attack != "None":
        raise ValueError(
            "run_sweep solves CLEAN targets (capacity-vs-visibility grid); attack-aware solving "
            f"(solver_attack={acfg.solver_attack!r}) would push the estimate through a channel the targets "
            "never passed --- use eval.study.eval_point(attack=..., attack_aware=True) for attacked-target studies")
    perceptual = acfg.loss == "perceptual"
    pipe = pl.build_pipeline(mcfg, FingerprintConfig(key_len=key_lens[0], shift=0),
                             generator=torch.Generator().manual_seed(seed), device=device, ckpt_path=ckpt_path,
                             want_lpips=perceptual)
    if lpips_params is None:
        lpips_params = pipe.lpips_params or lpips_mod.init_lpips_params(torch.Generator().manual_seed(7),
                                                                        pipe.device)
    inc_params = None
    if with_fid:
        from .inception import init_inception_params

        inc_params = init_inception_params(torch.Generator().manual_seed(11), pipe.device)

    d = mcfg.style_space_dim
    results: List[SweepPoint] = []
    for key_len, sigma in itertools.product(key_lens, sigmas):
        for shift in (shifts if shifts is not None else (d - key_len,)):
            if shift + key_len > d:
                continue
            basis = fpe.build_basis(pipe.pca, FingerprintConfig(key_len=key_len, shift=shift, sigma=sigma))
            pseed = sweep_point_seed(seed, key_len, shift)
            alpha = fpe.sample_alpha(basis, samples, fold_in(pseed, 0))
            bits = fpe.sample_key_bits(key_len, samples, fold_in(pseed, 1), pipe.device)
            w0, wx = fpe.embed(basis, alpha, bits)
            imgs_wx, imgs_w0 = pl.synthesize(pipe, wx), pl.synthesize(pipe, w0)
            if clip_targets:
                # deployment stores clipped images: measure visibility and solve under
                # that condition, as eval_point does (a random tiny generator's images
                # leave [-1, 1], and its callers turn this off)
                imgs_wx, imgs_w0 = torch.clamp(imgs_wx, -1.0, 1.0), torch.clamp(imgs_w0, -1.0, 1.0)
            with torch.no_grad():
                wm_lpips = float(lpips_mod.lpips(lpips_params, imgs_w0, imgs_wx).mean())
            wm_mse = float(((imgs_w0 - imgs_wx) ** 2).mean())
            fid_val = fid_disc_val = None
            if with_fid:
                from .fid import fid_between

                fid_val = fid_between(inc_params, imgs_w0, imgs_wx, batch=min(8, samples))
            if disc_params is not None:
                from .fid import fid_between_disc

                fid_disc_val = fid_between_disc(disc_params, imgs_w0, imgs_wx, batch=min(8, samples))

            res = attr.attribute(pipe.gen_params, lpips_params if perceptual else None, basis, pipe.noise, imgs_wx,
                                 mcfg=mcfg, acfg=acfg, generator=fold_in(pseed, 3), dtype=dtype,
                                 **pl.solver_kwargs(pipe))
            ev = attr.evaluate_attribution(res, bits, basis=basis, true_w0=w0)
            results.append(SweepPoint(
                key_len=key_len, sigma=float(sigma), shift=int(shift),
                mean_bit_acc=float(ev["mean_bit_acc"]), attribution_acc=float(ev["attribution_acc"]),
                watermark_lpips=wm_lpips, watermark_mse=wm_mse, mean_latent_cos=float(ev["mean_latent_cos"]),
                fid=fid_val, fid_disc=fid_disc_val))
    return results


def sweep_to_json(points: List[SweepPoint]) -> str:
    return json.dumps([dataclasses.asdict(p) for p in points], indent=2)
