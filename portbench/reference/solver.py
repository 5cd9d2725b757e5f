"""The attribution solver's objective and one Adam step, in plain PyTorch.

Per restart r the objective is LPIPS(G(wx(alpha_r, sigmoid(key_r))), target)
+ bound_weight * sum(relu(alpha_r - 3 sigma) + relu(-3 sigma - alpha_r)),
and Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
correction by the step number t, rate lr * exp(-decay * t)) updates alpha and
the key logits.  Restarts are independent, so the step is computed in blocks
of restarts that fit the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import lpips_vgg16 as lp
from . import stylegan2 as sg
from .precision import FLOAT32, Precision

B1, B2, EPS = 0.9, 0.999, 1e-8


def centered_lhs(n_designs: int, n: int, d: int, gen: torch.Generator, device) -> torch.Tensor:
    """[n_designs, n, d] centered Latin hypercube designs in [-1, 1]: in each
    dimension the n points take the centres of the n strata in a random order."""
    perms = torch.argsort(torch.rand((n_designs, d, n), generator=gen, device=device), dim=-1)
    return (2.0 * (perms.float() + 0.5) / n - 1.0).transpose(1, 2).contiguous()


def objective(ref: dict, alpha: torch.Tensor, key: torch.Tensor, tfeats: List[torch.Tensor],
              solver: dict, prec: Precision = FLOAT32) -> torch.Tensor:
    """Per-restart loss [n] of alpha [n, D-K] and key logits [n, K]."""
    _, wx = sg.embed(ref["basis"], alpha, torch.sigmoid(key), ref["cfg"], prec)
    img = sg.synthesis(ref["gen"], wx, ref["noise"], prec)
    dist = lp.distance(ref["lpips"], lp.features(ref["lpips"], img, prec), tfeats)
    box = ref["basis"]["box"]
    bound = torch.sum(torch.relu(alpha - box) + torch.relu(-box - alpha), dim=-1)
    return dist + solver["bound_weight"] * bound


def loss_and_grads(ref: dict, alpha: torch.Tensor, key: torch.Tensor, tfeats: List[torch.Tensor], solver: dict,
                   block: int, prec: Precision = FLOAT32) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss [n], d loss / d alpha [n, D-K], d loss / d key [n, K]) in blocks of restarts."""
    losses, g_alpha, g_key = [], [], []
    for r0 in range(0, alpha.shape[0], block):
        a = alpha[r0:r0 + block].detach().float().requires_grad_(True)
        k = key[r0:r0 + block].detach().float().requires_grad_(True)
        with torch.enable_grad():
            per = objective(ref, a, k, tfeats, solver, prec)
            ga, gk = torch.autograd.grad(per.sum(), [a, k])
        losses.append(per.detach())
        g_alpha.append(ga)
        g_key.append(gk)
    return torch.cat(losses), torch.cat(g_alpha), torch.cat(g_key)


def adam(param: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor, t: int,
         solver: dict, prec: Precision = FLOAT32) -> Dict[str, torch.Tensor]:
    """One Adam step at step number t (from 1): the new parameter and moments.
    ``prec`` rounds the tensor operands of every product."""
    q = prec.q
    lr = solver["lr"] * math.exp(-solver["lr_decay"] * t)
    m = B1 * q(m) + (1.0 - B1) * q(g)
    v = B2 * q(v) + (1.0 - B2) * q(g) * q(g)
    m_hat = m / (1.0 - B1 ** t)
    v_hat = v / (1.0 - B2 ** t)
    return {"param": param - lr * q(m_hat / (torch.sqrt(v_hat) + EPS)), "m": m, "v": v}
