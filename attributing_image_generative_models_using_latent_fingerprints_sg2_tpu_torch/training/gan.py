"""StyleGAN2 training, single device (the reference package's ``training/gan.py``).

The standard StyleGAN2 recipe: non-saturating logistic loss, lazy R1 on the
reals, style-mixing regularization, fresh noise maps per call, Adam for
both networks and an exponential moving average of G (the ``g_ema`` the
fingerprinting pipeline consumes).  One step updates D first, then G against
the updated D, as the JAX package's step does.

Randomness is an explicit argument of the step (:class:`PhaseDraws` for the
D and the G phase, and the reals): :func:`draw_step` derives it from
(seed, absolute step), so a resumed run sees the stream the uninterrupted
run saw (the JAX package's ``fold_in(base_key, step)``), and a test can feed
the step the JAX package's draws.

The parameters and both Adam states are updated in place; a step returns
its metrics as 0-d device tensors, so the host reads them once per chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models import stylegan2 as sg2
from ..parallel.mesh import all_reduce_mean_
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves, tree_map
from .data import sample_batch

Params = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch: int = 16
    lr: float = 0.002
    beta1: float = 0.0
    beta2: float = 0.99
    r1: float = 10.0
    d_reg_every: int = 16
    mixing: float = 0.9
    ema_decay: float = 0.999
    data_sharp: bool = False  # sharp-feature data variant (data.py)
    # >0: rank-limited synthetic data (data.py lowdim_factors)
    data_latent_dim: int = 0


@dataclasses.dataclass
class TrainState:
    """Everything a step reads and updates.  An Adam state is
    {"count": int, "mu": tree, "nu": tree} with the parameters' structure."""

    step: int
    g_params: Params
    d_params: Params
    g_ema: Params
    g_opt: Dict[str, Any]
    d_opt: Dict[str, Any]


@dataclasses.dataclass
class PhaseDraws:
    """The random inputs of one network phase: z [2, B, D] for the two mixed
    styles, the crossover layer t [B] in [1, n_latent), the mask use_mix [B]
    (False: the first style everywhere), and noise maps [1, res, res, 1]."""

    z: torch.Tensor
    t: torch.Tensor
    use_mix: torch.Tensor
    noise: List[torch.Tensor]

    def to(self, device) -> "PhaseDraws":
        return PhaseDraws(self.z.to(device), self.t.to(device), self.use_mix.to(device),
                          [n.to(device) for n in self.noise])


def init_adam(params: Params) -> Dict[str, Any]:
    return {"count": 0, "mu": tree_map(torch.zeros_like, params), "nu": tree_map(torch.zeros_like, params)}


def init_train_state(mcfg: ModelConfig, tcfg: TrainConfig, generator: torch.Generator, device) -> TrainState:
    """G then D drawn from ``generator`` (on the CPU), moved to ``device``:
    the card unless the caller asks for ``"cpu"``."""
    device = resolve_device(device)
    g_params = sg2.init_generator_params(mcfg, generator, device)
    d_params = sg2.init_discriminator_params(mcfg, generator, device)
    return TrainState(step=0, g_params=g_params, d_params=d_params,
                      g_ema=tree_map(torch.clone, g_params),
                      g_opt=init_adam(g_params), d_opt=init_adam(d_params))


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of absolute step ``step`` of run ``seed``."""
    entropy = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(entropy))


def draw_phase(generator: torch.Generator, mcfg: ModelConfig, tcfg: TrainConfig) -> PhaseDraws:
    b = tcfg.batch
    return PhaseDraws(
        z=torch.randn((2, b, mcfg.style_dim), generator=generator),
        t=torch.randint(1, mcfg.n_latent, (b,), generator=generator),
        use_mix=torch.rand((b,), generator=generator) < tcfg.mixing,
        noise=sg2.make_noise(mcfg.img_size, generator, "cpu"),
    )


def draw_step(seed: int, step: int, mcfg: ModelConfig, tcfg: TrainConfig, device,
              synthetic_reals: bool = True) -> Dict[str, Any]:
    """Step ``step``'s draws on ``device``: {"real": [B, S, S, 3] synthetic
    reals (or None, for reals from a folder), "d": PhaseDraws, "g": PhaseDraws}."""
    g = step_generator(seed, step)
    real = None
    if synthetic_reals:
        real = sample_batch(g, tcfg.batch, mcfg.img_size, tcfg.data_sharp, tcfg.data_latent_dim, device)
    d = draw_phase(g, mcfg, tcfg).to(device)
    return {"real": real, "d": d, "g": draw_phase(g, mcfg, tcfg).to(device)}


def shard_draws(draws: Dict[str, Any], rows: torch.Tensor) -> Dict[str, Any]:
    """The ``rows`` of a step's batch draws (the reals, and z, t and use_mix of
    both phases); the noise maps are shared by the batch."""
    def phase(p: PhaseDraws) -> PhaseDraws:
        idx = rows.to(p.t.device)
        return PhaseDraws(p.z[:, idx], p.t[idx], p.use_mix[idx], p.noise)

    real = draws["real"]
    return {"real": None if real is None else real[rows.to(real.device)], "d": phase(draws["d"]),
            "g": phase(draws["g"])}


def mixed_latent(g_params: Params, draws: PhaseDraws, mcfg: ModelConfig) -> torch.Tensor:
    """[B, n_latent, D]: w of z[0] below the crossover t, w of z[1] from t on."""
    nl = mcfg.n_latent
    two, b, d = draws.z.shape
    w = sg2.mapping_network(g_params, draws.z.reshape(two * b, d), mcfg.lr_mlp).reshape(two, b, d)
    t = torch.where(draws.use_mix, draws.t, torch.full_like(draws.t, nl))
    idx = torch.arange(nl, device=t.device)[None, :, None]
    return torch.where(idx < t[:, None, None], w[0][:, None, :], w[1][:, None, :])


def _synthesize(g_params: Params, draws: PhaseDraws, mcfg: ModelConfig) -> torch.Tensor:
    return sg2.generate(g_params, [mixed_latent(g_params, draws, mcfg)], mcfg, input_is_latent=True,
                        noise=draws.noise)


def _with_grad(tree: Params) -> Params:
    return tree_map(lambda p: p.detach().requires_grad_(True), tree)


def _grads(loss: torch.Tensor, tree: Params, mesh=None) -> List[torch.Tensor]:
    """d loss / d every leaf of ``tree``; zeros for leaves the loss does not
    read (the generator's stored noise maps), as in the JAX package.  On a
    mesh, each rank's loss is the mean over its rows, and the gradients are
    averaged over "data": the gradient of the global batch's mean."""
    leaves = tree_leaves(tree)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]
    if mesh is not None:
        all_reduce_mean_(mesh, gs)
    return gs


@torch.no_grad()
def adam_update_(params: Params, grads: List[torch.Tensor], opt: Dict[str, Any], tcfg: TrainConfig) -> None:
    """One Adam step in place (optax.adam's arithmetic: bias correction by the
    step count, eps outside the square root, eps_root 0)."""
    p, mu, nu = tree_leaves(params), tree_leaves(opt["mu"]), tree_leaves(opt["nu"])
    opt["count"] += 1
    c = opt["count"]
    torch._foreach_mul_(mu, tcfg.beta1)
    torch._foreach_add_(mu, grads, alpha=1.0 - tcfg.beta1)
    torch._foreach_mul_(nu, tcfg.beta2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - tcfg.beta2)
    den = torch._foreach_div(nu, 1.0 - tcfg.beta2 ** c)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, 1e-8)
    upd = torch._foreach_div(mu, 1.0 - tcfg.beta1 ** c)
    torch._foreach_div_(upd, den)
    torch._foreach_add_(p, upd, alpha=-tcfg.lr)


def train_step(state: TrainState, draws: Dict[str, Any], mcfg: ModelConfig,
               tcfg: TrainConfig, mesh=None) -> tuple:
    """One D update then one G update (against the updated D), the EMA, the
    step count; returns (state, {"d_loss", "r1", "g_loss"}).  ``d_loss`` is
    the adversarial term; ``r1`` is 0 except every ``d_reg_every`` steps,
    where it is (r1 / 2) * mean(sum(g^2)) * d_reg_every with g the gradient
    of sum(D(real)) in the reals (a second derivative for D's update).

    On a ``parallel.mesh`` grid, ``draws`` are this rank's rows of the global
    batch (:func:`shard_draws` of ``models.stylegan2.stddev_rows``): whole
    minibatch-stddev groups where they split over the ranks, else contiguous
    rows that the discriminator gathers at its stddev layer.  Gradients and
    metrics are averaged over "data", so every rank takes the global batch's
    step and its parameters, EMA and Adam states stay equal."""
    gather = mesh if mesh is not None and sg2.stddev_gathers(tcfg.batch, mesh.shape["data"]) else None
    real = draws["real"]
    with torch.no_grad():
        fake_d = _synthesize(state.g_params, draws["d"], mcfg)

    do_r1 = state.step % tcfg.d_reg_every == 0
    dp = _with_grad(state.d_params)
    if do_r1:
        real = real.detach().requires_grad_(True)
    real_logit = sg2.discriminator_apply(dp, real, mcfg, gather)
    fake_logit = sg2.discriminator_apply(dp, fake_d, mcfg, gather)
    d_adv = F.softplus(-real_logit).mean() + F.softplus(fake_logit).mean()
    loss, r1 = d_adv, torch.zeros((), device=d_adv.device)
    if do_r1:
        # the reals' forward above serves both terms: D's value does not change
        (g,) = torch.autograd.grad(real_logit.sum(), real, create_graph=True)
        r1 = (tcfg.r1 / 2.0) * g.square().sum(dim=(1, 2, 3)).mean() * tcfg.d_reg_every
        loss = loss + r1
    adam_update_(state.d_params, _grads(loss, dp, mesh), state.d_opt, tcfg)

    gp = _with_grad(state.g_params)
    fake = _synthesize(gp, draws["g"], mcfg)
    g_loss = F.softplus(-sg2.discriminator_apply(state.d_params, fake, mcfg, gather)).mean()
    adam_update_(state.g_params, _grads(g_loss, gp, mesh), state.g_opt, tcfg)

    with torch.no_grad():
        ema, cur = tree_leaves(state.g_ema), tree_leaves(state.g_params)
        torch._foreach_mul_(ema, tcfg.ema_decay)
        torch._foreach_add_(ema, cur, alpha=1.0 - tcfg.ema_decay)
    state.step += 1
    metrics = torch.stack([d_adv.detach(), r1.detach(), g_loss.detach()])
    if mesh is not None:
        all_reduce_mean_(mesh, [metrics])
    return state, dict(zip(("d_loss", "r1", "g_loss"), metrics.unbind()))


def run_steps(state: TrainState, seed: int, n: int, mcfg: ModelConfig, tcfg: TrainConfig,
              reals: Optional[List[torch.Tensor]] = None, mesh=None) -> Dict[str, np.ndarray]:
    """``n`` steps from ``state.step`` with the draws of (seed, step); reals
    from ``reals`` (one batch a step) when given, else synthetic.  Returns
    the metrics of every step as float64 arrays [n] (one host sync).  On a
    mesh every rank draws the global batch and keeps its rows; ``reals`` are
    this rank's rows already (``parallel.train.shard_reals``)."""
    device = tree_leaves(state.g_params)[0].device
    rows = []
    for j in range(n):
        draws = draw_step(seed, state.step, mcfg, tcfg, device, synthetic_reals=reals is None)
        if mesh is not None:
            draws = shard_draws(draws, sg2.stddev_rows(tcfg.batch, mesh.shape["data"], mesh.index("data")))
        if reals is not None:
            draws["real"] = reals[j].to(device)
        state, m = train_step(state, draws, mcfg, tcfg, mesh)
        rows.append(m)
    return {k: torch.stack([r[k] for r in rows]).double().cpu().numpy() for k in ("d_loss", "r1", "g_loss")}
