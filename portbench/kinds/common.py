"""What the request kinds share: the port's modules, imported when a driver
is set up (never when this module is imported), the seed's inputs, and the
relative gaps the comparisons read."""

from __future__ import annotations

import importlib
import time
from types import SimpleNamespace
from typing import Optional

import torch

from portbench.core import PORT
from portbench.reference import lpips_vgg16 as ref_lp
from portbench.reference import stylegan2 as ref_sg
from portbench.reference.precision import exact_float32


def port():
    """The port's modules a driver calls."""
    names = ("config", "fingerprint.pipeline", "fingerprint.attribute", "losses.lpips", "models.stylegan2",
             "utils.image")
    mods = {n.rsplit(".", 1)[-1]: importlib.import_module(f"{PORT}.{n}") for n in names}
    return SimpleNamespace(**mods)


def model_config(P, cfg: dict):
    return P.config.ModelConfig(model="sg2", img_size=cfg["img_size"], style_dim=cfg["style_dim"], n_mlp=cfg["n_mlp"],
                                channel_multiplier=cfg["channel_multiplier"], channel_max=cfg["channel_max"],
                                blur_kernel=tuple(cfg["blur_kernel"]), lr_mlp=cfg["lr_mlp"], ckpt=None)


def fingerprint_config(P, cfg: dict):
    return P.config.FingerprintConfig(key_len=cfg["key_len"], shift=cfg["shift"], sigma=cfg["sigma"],
                                      sd_moved=cfg["sd_moved"], n_pca_samples=cfg["n_pca_samples"])


def draw_inputs(cfg: dict, seed: int, device, with_lpips: bool) -> SimpleNamespace:
    """Weights, fixed noise and PCA latents of the seed, drawn on the device
    by one generator in a few large calls, float32 (the port keeps its
    parameters float32 and casts them at use)."""
    exact_float32()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    inputs = SimpleNamespace(gen=ref_sg.make_generator_params(cfg, gen, device),
                             noise=ref_sg.make_noise(cfg["img_size"], gen, device),
                             pca_z=torch.randn((cfg["n_pca_samples"], cfg["style_dim"]), generator=gen, device=device),
                             lpips=ref_lp.make_params(gen, device) if with_lpips else None, rng=gen)
    return inputs


def reference_basis(inputs: SimpleNamespace, cfg: dict):
    """The reference's own PCA and basis of the seed's weights and latents."""
    with torch.no_grad():
        return ref_sg.build_basis(inputs.gen, inputs.pca_z, cfg)


def clock(device) -> float:
    """The host clock once the device has finished what was queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def rel_gap(x: torch.Tensor, ref: torch.Tensor, dim: Optional[int] = -1) -> torch.Tensor:
    """||x - ref|| / ||ref|| along ``dim`` (all of it for None), in float64."""
    x, ref = x.double(), ref.double()
    if dim is None:
        return torch.linalg.norm(x - ref) / torch.linalg.norm(ref).clamp(min=1e-300)
    return torch.linalg.norm(x - ref, dim=dim) / torch.linalg.norm(ref, dim=dim).clamp(min=1e-300)


def free_device(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
