"""BigGAN-deep (Brock, Donahue and Simonyan, arXiv:1809.11096, Appendix B;
``pytorch_pretrained_biggan``'s ``BigGAN``), its truncated-noise PCA and the
solver's objective, in plain PyTorch (NCHW inside, NHWC at the edges).

- cond = [z, E onehot];  h = reshape(W_z cond + b) to 4 x 4 x 16 ch, then NCHW;
- a block (C_in, C_out, C_b = C_in / 4): h1 = conv1x1(relu(cBN0(x))),
  h2 = conv3x3(up2(relu(cBN1(h1)))), h3 = conv3x3(relu(cBN2(h2))),
  out = conv1x1(relu(cBN3(h3))) + up2(x[:, :C_out]) (up2 nearest, on up
  layers only; the skip keeps the first half of the channels where they halve);
- cBN(x) = (x - mu_t) / sqrt(var_t + eps) * (1 + cond W_s) + cond W_o, with
  the running statistics blended from the ``n_stats`` stored rows at the
  truncation;
- before layer ``attention_layer_position`` the SAGAN block: theta = conv1x1(x),
  phi = maxpool2(conv1x1(x)), g = maxpool2(conv1x1(x)),
  beta = softmax over the pooled positions of theta^T phi,
  x + gamma conv1x1(g beta^T);
- relu(BN(h)), conv3x3 to 3 channels, tanh.

The parameter tree is the one the port takes: conv weights [O, I, kh, kw],
linear weights [out, in], conditional gains [C, cond_dim].

Departures from the published description, each on purpose:

- the statistics blend is the package's (``BigGANBatchNorm.forward``):
  ``coef, start = modf(truncation / step)`` and
  ``stats[start] * coef + stats[start + 1] * (1 - coef)``, so the nearer row
  gets the smaller weight; the published checkpoints were used with it;
- the weights are random, drawn from the seed, and are the effective ones
  (no spectral-norm parametrization to fold); the package's ``conv_to_rgb``
  has ``channel_width`` outputs of which it keeps the first 3, here it has 3;
- the attention's gamma is drawn non-zero (a trained model's is, the
  package's initial value is 0, where the block would not reach the image);
- the 2x2 max pool is ``F.max_pool2d``, whose gradient takes one element of
  a tied window where the port's splits it evenly (a tie of two float32 conv
  outputs does not occur on these draws).

The fingerprint's PCA is the one of :mod:`.stylegan2` on the truncated
noise itself (BigGAN fingerprints its 128-d latent, not a mapped one).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import lpips_vgg16 as lp
from . import stylegan2 as sg
from .precision import FLOAT32, Precision
from .stylegan2 import _Draw, _fill

# Scales of the random draw, chosen so that every part reaches the image and
# the image is not saturated: each block's last conv adds a fraction of the
# residual stream (its variance grows ~3x over 14 blocks, not 2^14), the
# attention's logits spread over a few units, and the output conv puts tanh's
# input at a standard deviation of ~0.6.
RESIDUAL_GAIN = 0.3
ATTN_LOGIT_GAIN = 0.4
GAMMA = 1.0
OUT_GAIN = 0.5


def layers(cfg: dict) -> List[Tuple[bool, int, int]]:
    return [(bool(up), int(i), int(o)) for up, i, o in cfg["layers"]]


def cond_dim(cfg: dict) -> int:
    return cfg["z_dim"] + cfg["class_embed_dim"]


def attention_channels(cfg: dict) -> int:
    """Channels at the attention block: the output of the layer before it."""
    pre = layers(cfg)[:cfg["attention_layer_position"]]
    return (pre[-1][2] if pre else 16) * cfg["channel_width"]


def make_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """Random BigGAN-deep weights, float32, in the port's tree (module
    docstring for the scales): He-scaled convs with small biases, running
    means near 0 and variances in [1, 1.3] at every stored truncation,
    small conditional gains and offsets, a non-zero attention gamma."""
    d = _Draw()
    ch, cd, ns = cfg["channel_width"], cond_dim(cfg), cfg["n_stats"]

    def conv(cin, cout, k, gain=1.0, bias=True):
        p = {"w": d.leaf((cout, cin, k, k), gain * math.sqrt(2.0 / (cin * k * k)))}
        if bias:
            p["b"] = d.leaf((cout,), 0.05)
        return p

    def cbn(c):
        return {"running_means": d.leaf((ns, c), 0.1), "running_vars": d.leaf((ns, c), 0.1, 1.0, absolute=True),
                "scale_w": d.leaf((c, cd), 0.02), "offset_w": d.leaf((c, cd), 0.02)}

    z_scale = 0.35  # the standard deviation of truncnorm(-2, 2) x 0.4, the embedding's too
    tree = {"embeddings": d.leaf((cfg["class_embed_dim"], cfg["num_classes"]), z_scale),
            "gen_z": {"w": d.leaf((4 * 4 * 16 * ch, cd), 1.0 / (z_scale * math.sqrt(cd))),
                      "b": d.leaf((4 * 4 * 16 * ch,), 0.1)}}
    blocks = []
    for _, in_m, out_m in layers(cfg):
        cin, cout = in_m * ch, out_m * ch
        mid = cin // 4
        blocks.append({"bn0": cbn(cin), "conv0": conv(cin, mid, 1), "bn1": cbn(mid), "conv1": conv(mid, mid, 3),
                       "bn2": cbn(mid), "conv2": conv(mid, mid, 3), "bn3": cbn(mid),
                       "conv3": conv(mid, cout, 1, RESIDUAL_GAIN)})
    tree["layers"] = blocks
    c = attention_channels(cfg)
    logit = ATTN_LOGIT_GAIN / math.sqrt(2.0)  # He's sqrt(2 / C) times this is ATTN_LOGIT_GAIN / sqrt(C)
    tree["attn"] = {"theta": conv(c, c // 8, 1, logit, bias=False), "phi": conv(c, c // 8, 1, logit, bias=False),
                    "g": conv(c, c // 2, 1, bias=False), "o_conv": conv(c // 2, c, 1, bias=False),
                    "gamma": d.leaf((), 0.1, GAMMA)}
    out_ch = layers(cfg)[-1][2] * ch
    tree["bn_out"] = {"running_means": d.leaf((ns, out_ch), 0.1),
                      "running_vars": d.leaf((ns, out_ch), 0.1, 1.0, absolute=True),
                      "weight": d.leaf((out_ch,), 0.1, 1.0), "bias": d.leaf((out_ch,), 0.1)}
    tree["conv_out"] = conv(out_ch, 3, 3, OUT_GAIN)
    return _fill(tree, d.realize(gen, device))


def truncated_noise(n: int, truncation: float, dim: int, gen: torch.Generator, device) -> torch.Tensor:
    """truncnorm(-2, 2) x truncation [n, dim] (the package's
    ``truncated_noise_sample``), by the inverse CDF of a uniform float64 draw."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand((n, dim), generator=gen, device=device, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
    return (z.clamp(-2.0, 2.0) * truncation).float()


def build_basis(z: torch.Tensor, cfg: dict, prec: Precision = FLOAT32) -> Dict[str, torch.Tensor]:
    """The fingerprint's basis from the PCA of the truncated noise itself."""
    return sg.basis(sg.pca(z, prec), cfg)


embed = sg.embed


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------


def interp_stats(stats: torch.Tensor, truncation: float, n_stats: int) -> torch.Tensor:
    """The package's blend of the stored rows (module docstring)."""
    coef, start = math.modf(truncation / (1.0 / (n_stats - 1)))
    start = int(start)
    if coef != 0.0:
        return stats[start] * coef + stats[start + 1] * (1.0 - coef)
    return stats[start]


def _bn(x, p, truncation, n_stats, eps, weight, bias):
    mean = interp_stats(p["running_means"], truncation, n_stats)[None, :, None, None]
    var = interp_stats(p["running_vars"], truncation, n_stats)[None, :, None, None]
    return (x - mean) / torch.sqrt(var + eps) * weight + bias


def cond_bn(x, cond, p, cfg, prec):
    weight = 1.0 + prec.mm(cond, p["scale_w"].T)[:, :, None, None]
    bias = prec.mm(cond, p["offset_w"].T)[:, :, None, None]
    return _bn(x, p, cfg["truncation"], cfg["n_stats"], cfg["eps"], weight, bias)


def _conv(x, p, prec, padding=0):
    return prec.conv2d(x, p["w"], p.get("b"), padding=padding)


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def block(x, cond, p, up: bool, cfg, prec):
    h = _conv(F.relu(cond_bn(x, cond, p["bn0"], cfg, prec)), p["conv0"], prec)
    h = F.relu(cond_bn(h, cond, p["bn1"], cfg, prec))
    h = _conv(_up2(h) if up else h, p["conv1"], prec, padding=1)
    h = _conv(F.relu(cond_bn(h, cond, p["bn2"], cfg, prec)), p["conv2"], prec, padding=1)
    h = _conv(F.relu(cond_bn(h, cond, p["bn3"], cfg, prec)), p["conv3"], prec)
    skip = x[:, :h.shape[1]]  # the package drops to the first half where the channels halve
    return h + (_up2(skip) if up else skip)


def attention(x, p, prec):
    b, c, hh, ww = x.shape
    theta = _conv(x, p["theta"], prec).reshape(b, c // 8, hh * ww)
    phi = F.max_pool2d(_conv(x, p["phi"], prec), 2).reshape(b, c // 8, hh * ww // 4)
    g = F.max_pool2d(_conv(x, p["g"], prec), 2).reshape(b, c // 2, hh * ww // 4)
    beta = torch.softmax(prec.mm(theta.transpose(1, 2), phi), dim=-1)  # [B, HW, HW/4]
    o = prec.mm(g, beta.transpose(1, 2)).reshape(b, c // 2, hh, ww)
    return x + p["gamma"] * _conv(o, p["o_conv"], prec)


def generate(params: dict, z: torch.Tensor, cfg: dict, prec: Precision = FLOAT32) -> torch.Tensor:
    """Images [B, H, W, 3] of latents z [B, z_dim] for class ``cfg["class"]``
    at truncation ``cfg["truncation"]``."""
    onehot = torch.zeros((z.shape[0], cfg["num_classes"]), device=z.device)
    onehot[:, int(cfg["class"])] = 1.0
    cond = torch.cat([z, prec.mm(onehot, params["embeddings"].T)], dim=1)
    ch = cfg["channel_width"]
    h = prec.mm(cond, params["gen_z"]["w"].T) + params["gen_z"]["b"]
    h = h.reshape(z.shape[0], 4, 4, 16 * ch).permute(0, 3, 1, 2)
    for i, (up, _, _) in enumerate(layers(cfg)):
        if i == cfg["attention_layer_position"]:
            h = attention(h, params["attn"], prec)
        h = block(h, cond, params["layers"][i], up, cfg, prec)
    p = params["bn_out"]
    h = F.relu(_bn(h, p, cfg["truncation"], cfg["n_stats"], cfg["eps"], p["weight"][None, :, None, None],
                   p["bias"][None, :, None, None]))
    return torch.tanh(_conv(h, params["conv_out"], prec, padding=1)).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# The solver's objective
# ---------------------------------------------------------------------------


def objective(ref: dict, alpha: torch.Tensor, key: torch.Tensor, tfeats: List[torch.Tensor],
              solver: dict, prec: Precision = FLOAT32) -> torch.Tensor:
    """Per-restart loss [n]: LPIPS(G(wx(alpha, sigmoid(key))), target) + the
    bound penalty (``solver.objective`` with BigGAN as the generator)."""
    _, wx = embed(ref["basis"], alpha, torch.sigmoid(key), ref["cfg"], prec)
    img = generate(ref["gen"], wx, ref["cfg"], prec)
    dist = lp.distance(ref["lpips"], lp.features(ref["lpips"], img, prec), tfeats)
    box = ref["basis"]["box"]
    bound = torch.sum(torch.relu(alpha - box) + torch.relu(-box - alpha), dim=-1)
    return dist + solver["bound_weight"] * bound


def loss_and_grads(ref: dict, alpha: torch.Tensor, key: torch.Tensor, tfeats: List[torch.Tensor], solver: dict,
                   block_size: int, prec: Precision = FLOAT32) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss [n], d loss / d alpha [n, D-K], d loss / d key [n, K]) in blocks
    of restarts (they are independent)."""
    losses, g_alpha, g_key = [], [], []
    for r0 in range(0, alpha.shape[0], block_size):
        a = alpha[r0:r0 + block_size].detach().float().requires_grad_(True)
        k = key[r0:r0 + block_size].detach().float().requires_grad_(True)
        with torch.enable_grad():
            per = objective(ref, a, k, tfeats, solver, prec)
            ga, gk = torch.autograd.grad(per.sum(), [a, k])
        losses.append(per.detach())
        g_alpha.append(ga)
        g_key.append(gk)
    return torch.cat(losses), torch.cat(g_alpha), torch.cat(g_key)
