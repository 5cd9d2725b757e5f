"""Discriminator-feature perceptual loss: the trained StyleGAN2
discriminator as an LPIPS backbone.

Counterpart of the reference package's ``losses/disc_percept.py``.  With no
pretrained VGG16 available, the discriminator trained here (``cli.train``'s
``<out>.disc.npz``) is a perceptual embedding of the very distribution the
fingerprinted generator draws from.  Its parameters wrapped as
``{"disc": ..., "lin": ...}`` plug into ``losses/lpips.py`` unchanged:
``extract_raw_features`` dispatches on the ``"disc"`` key, and the distance
head and the solver take the maps as they take VGG's.

Feature taps: the from_rgb conv output and every residual block's output
(img_size, img_size / 2, ..., 8 px: five maps at 64 px).  The minibatch
stddev head and the logit layers are left out: they couple the batch and
carry no spatial signal.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models import stylegan2 as sg2
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves, tree_map


def cast_features(d_params: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """The discriminator with the layers :func:`disc_features` runs (from_rgb
    and the res blocks) cast to ``dtype``, the rest as it was.  A solve casts
    once with this, and its steps' :func:`disc_features` calls then cast
    nothing."""
    return dict(d_params, **{k: tree_map(lambda t: t.to(dtype), d_params[k]) for k in ("from_rgb", "blocks")})


def disc_features(d_params: Dict[str, Any], x: torch.Tensor,
                  blur_kernel: Sequence[int] = (1, 3, 3, 1)) -> List[torch.Tensor]:
    """[-1, 1] NHWC image -> the discriminator's feature maps (from_rgb, then
    each res block).  The weights are cast to the image's dtype before any
    layer runs, as the reference does: in a bf16 solve the equalized-LR scale,
    the convs, the blurs and the leaky ReLUs all run in bf16."""
    if x.dtype != d_params["from_rgb"]["weight"].dtype:
        d_params = cast_features(d_params, x.dtype)
    out = sg2.conv_layer(x, d_params["from_rgb"], blur_kernel=blur_kernel)
    feats = [out]
    for rb in d_params["blocks"]:
        out = sg2.res_block(out, rb, blur_kernel)
        feats.append(out)
    return feats


def disc_feature_channels(d_params: Dict[str, Any]) -> Tuple[int, ...]:
    chans = [d_params["from_rgb"]["weight"].shape[-1]]
    for rb in d_params["blocks"]:
        chans.append(rb["conv2"]["weight"].shape[-1])
    return tuple(int(c) for c in chans)


def build_disc_percept_params(d_params: Dict[str, Any]) -> Dict[str, Any]:
    """LPIPS-compatible params: the discriminator backbone and uniform 1/C
    lin heads (the zero-data default; ``losses/calibrate.py`` fits them)."""
    device = tree_leaves(d_params)[0].device
    lin = [torch.full((c,), 1.0 / c, dtype=torch.float32, device=device)
           for c in disc_feature_channels(d_params)]
    return {"disc": d_params, "lin": lin}


def load_disc_percept(path: str, device="cuda") -> Dict[str, Any]:
    """A discriminator exported by ``cli.train`` (flat ``.npz``,
    ``checkpoints/flat.py``) as perceptual-loss params on ``device``: the card
    unless the caller asks for ``"cpu"`` (``utils.device.resolve_device``)."""
    from ..checkpoints.flat import unflatten_params

    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return build_disc_percept_params(unflatten_params(flat, resolve_device(device)))
