"""Generator weights: rosinality StyleGAN2 checkpoints and the JAX package's trees.

The port's generator tree has the reference package's layout (see its
``checkpoints/rosinality.py`` for the name map): HWIO conv weights,
[in, out] linear weights, NHWC constant input and noise maps, and the
upsample layers' (``convs[2j]``) conv weights stored spatially flipped.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..models.stylegan2 import channel_map, noise_shapes
from ..utils.device import resolve_device
from ..utils.tree import tree_to


def load_torch_state_dict(path: str, key: str = "g_ema") -> Dict[str, np.ndarray]:
    """A rosinality ``.pt`` (its ``g_ema`` entry) or a portable ``.npz`` with
    the same tensor names -> {name: float32 ndarray}."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k], dtype=np.float32) for k in z.files}
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob[key] if key and key in blob else blob
    return {k: v.detach().float().numpy() for k, v in state.items()}


def _conv_weight(w: np.ndarray, flip: bool) -> np.ndarray:
    """[1,O,I,kh,kw] or [O,I,kh,kw] -> [kh,kw,I,O], optionally flipped spatially."""
    if w.ndim == 5:
        w = w[0]
    w = np.transpose(w, (2, 3, 1, 0))
    if flip:
        w = w[::-1, ::-1]
    return np.ascontiguousarray(w, dtype=np.float32)


def _mod(sd, prefix) -> Dict[str, np.ndarray]:
    return {"weight": np.ascontiguousarray(sd[f"{prefix}.conv.modulation.weight"].T, np.float32),
            "bias": sd[f"{prefix}.conv.modulation.bias"].astype(np.float32)}


def _styled_conv(sd, prefix: str, flip: bool) -> Dict[str, Any]:
    return {
        "weight": _conv_weight(sd[f"{prefix}.conv.weight"], flip),
        "mod": _mod(sd, prefix),
        "noise_weight": np.float32(sd[f"{prefix}.noise.weight"].reshape(())),
        "act_bias": sd[f"{prefix}.activate.bias"].astype(np.float32),
    }


def _to_rgb(sd, prefix: str) -> Dict[str, Any]:
    return {
        "weight": _conv_weight(sd[f"{prefix}.conv.weight"], flip=False),
        "mod": _mod(sd, prefix),
        "bias": sd[f"{prefix}.bias"].reshape(-1).astype(np.float32),
    }


def generator_params_from_state_dict(sd: Mapping[str, np.ndarray], cfg: ModelConfig,
                                     device) -> Dict[str, Any]:
    """Rosinality ``g_ema`` state dict -> the port's generator tree."""
    n_blocks = int(math.log2(cfg.img_size)) - 2
    style = []
    while f"style.{len(style) + 1}.weight" in sd:
        i = len(style) + 1
        style.append({"weight": np.ascontiguousarray(sd[f"style.{i}.weight"].T, np.float32),
                      "bias": sd[f"style.{i}.bias"].astype(np.float32)})
    if len(style) != cfg.n_mlp:
        raise ValueError(f"expected {cfg.n_mlp} mapping layers, found {len(style)}")
    noises = []
    for l, shape in enumerate(noise_shapes(cfg.img_size)):
        name = f"noises.noise_{l}"
        noises.append(np.transpose(sd[name], (0, 2, 3, 1)) if name in sd else np.zeros(shape, np.float32))
    params = {
        "style": style,
        "input": np.transpose(sd["input.input"], (0, 2, 3, 1)),
        "conv1": _styled_conv(sd, "conv1", flip=False),
        "to_rgb1": _to_rgb(sd, "to_rgb1"),
        "convs": [_styled_conv(sd, f"convs.{j}", flip=(j % 2 == 0)) for j in range(2 * n_blocks)],
        "to_rgbs": [_to_rgb(sd, f"to_rgbs.{j}") for j in range(n_blocks)],
        "noises": noises,
    }
    validate_generator(params, cfg)
    return tree_to(params, device)


def validate_generator(params: Mapping[str, Any], cfg: ModelConfig) -> None:
    """Raise if the tree's conv shapes do not match ``cfg``'s architecture."""
    n_blocks = int(math.log2(cfg.img_size)) - 2
    if len(params["convs"]) != 2 * n_blocks or len(params["to_rgbs"]) != n_blocks:
        raise ValueError(
            f"generator weights have {len(params['to_rgbs'])} upsample blocks; "
            f"img_size {cfg.img_size} needs {n_blocks}"
        )
    chans = channel_map(cfg.channel_multiplier, cfg.channel_max)
    expect = {"input": (1, 4, 4, chans[4]), "conv1": (3, 3, chans[4], chans[4])}
    got = {"input": tuple(params["input"].shape), "conv1": tuple(params["conv1"]["weight"].shape)}
    in_ch = chans[4]
    for i in range(3, int(math.log2(cfg.img_size)) + 1):
        out_ch, j = chans[2 ** i], 2 * (i - 3)
        expect[f"convs.{j}"] = (3, 3, in_ch, out_ch)
        expect[f"convs.{j + 1}"] = (3, 3, out_ch, out_ch)
        expect[f"to_rgbs.{i - 3}"] = (1, 1, out_ch, 3)
        got[f"convs.{j}"] = tuple(params["convs"][j]["weight"].shape)
        got[f"convs.{j + 1}"] = tuple(params["convs"][j + 1]["weight"].shape)
        got[f"to_rgbs.{i - 3}"] = tuple(params["to_rgbs"][i - 3]["weight"].shape)
        in_ch = out_ch
    if got != expect:
        bad = {k: (got.get(k), v) for k, v in expect.items() if got.get(k) != v}
        raise ValueError(f"generator weights do not match the config (got, expected): {bad}")


def load_generator(path: str, cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    """Rosinality ``.pt`` / ``.npz`` file -> the port's generator tree on ``device``:
    the card unless the caller asks for ``"cpu"`` (``utils.device.resolve_device``)."""
    device = resolve_device(device)
    return generator_params_from_state_dict(load_torch_state_dict(path), cfg, device)


def params_from_jax(tree: Any, device, cfg: ModelConfig = None) -> Dict[str, Any]:
    """The JAX package's generator pytree (numpy or JAX leaves) -> the port's
    tree.  Both use the same layout, so this converts leaves only; with
    ``cfg`` the shapes are checked too."""
    params = tree_to(tree, device)
    if cfg is not None:
        validate_generator(params, cfg)
    return params


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def generator_state_dict_from_params(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's generator tree -> rosinality ``g_ema`` names and layouts
    (the inverse of :func:`generator_params_from_state_dict`): the trained
    EMA generator's export, a ``.npz`` every ``--ckpt`` flag takes."""
    sd: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(params["style"]):
        sd[f"style.{i + 1}.weight"] = _np(layer["weight"]).T
        sd[f"style.{i + 1}.bias"] = _np(layer["bias"])
    sd["input.input"] = np.transpose(_np(params["input"]), (0, 3, 1, 2))

    def put_mod(prefix, p, flip=False):
        w = _np(p["weight"])
        if flip:
            w = w[::-1, ::-1]
        sd[f"{prefix}.conv.weight"] = np.transpose(w, (3, 2, 0, 1))[None]
        sd[f"{prefix}.conv.modulation.weight"] = _np(p["mod"]["weight"]).T
        sd[f"{prefix}.conv.modulation.bias"] = _np(p["mod"]["bias"])

    def put_styled(prefix, p, flip=False):
        put_mod(prefix, p, flip)
        sd[f"{prefix}.noise.weight"] = _np(p["noise_weight"]).reshape(1)
        sd[f"{prefix}.activate.bias"] = _np(p["act_bias"])

    def put_rgb(prefix, p):
        put_mod(prefix, p)
        sd[f"{prefix}.bias"] = _np(p["bias"]).reshape(1, 3, 1, 1)

    put_styled("conv1", params["conv1"])
    put_rgb("to_rgb1", params["to_rgb1"])
    for j, p in enumerate(params["convs"]):
        put_styled(f"convs.{j}", p, flip=j % 2 == 0)  # the upsample layers are stored flipped
    for j, p in enumerate(params["to_rgbs"]):
        put_rgb(f"to_rgbs.{j}", p)
    for i, nz in enumerate(params["noises"]):
        sd[f"noises.noise_{i}"] = np.transpose(_np(nz), (0, 3, 1, 2))
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def discriminator_params_from_jax(tree: Any, device) -> Dict[str, Any]:
    """The JAX package's discriminator pytree -> the port's (same layout)."""
    return tree_to(tree, device)
