"""The plain reference against the port's CPU path at a tiny size: the PCA
and basis, synthesis, the LPIPS distance and one solver step; and a
bfloat16-rounded reference falls outside the same tolerances."""

from __future__ import annotations

import importlib

import pytest
import torch

from portbench.core import PORT
from portbench.kinds import common
from portbench.reference import lpips_vgg16 as rl
from portbench.reference import solver as rs
from portbench.reference import stylegan2 as rsg
from portbench.reference.precision import Precision
from portbench.tests.tiny import TINY

TOL = {"image": 1e-5, "dist": 1e-5, "grad": 2e-3}


@pytest.fixture(scope="module")
def setup():
    dev = torch.device("cpu")
    inputs = common.draw_inputs(TINY, 7, dev, with_lpips=True)
    P = common.port()
    mcfg = common.model_config(P, TINY)
    pipe = P.pipeline.build_pipeline(mcfg, common.fingerprint_config(P, TINY), device=dev, gen_params=inputs.gen,
                                     lpips_params=inputs.lpips, pca_z=inputs.pca_z, noise=inputs.noise)
    basis = common.reference_basis(inputs, TINY)
    return P, mcfg, pipe, inputs, basis


def _rel(a, b):
    return float(common.rel_gap(a, b, None))


def test_basis(setup):
    P, _, pipe, _, basis = setup
    assert _rel(pipe.basis.v_cap, basis["v"]) < 1e-5
    assert _rel(pipe.basis.u_cap, basis["u"]) < 1e-5
    assert _rel(pipe.basis.sigma_rest, basis["sigma_rest"]) < 1e-5


def _images(setup, prec):
    P, mcfg, pipe, inputs, basis = setup
    g = torch.Generator().manual_seed(3)
    alpha = torch.randn((3, basis["sigma_rest"].shape[0]), generator=g) * basis["sigma_rest"]
    bits = torch.randint(0, 2, (3, TINY["key_len"]), generator=g).float()
    port_img, *_ = P.pipeline.generate_fingerprinted(pipe, 3, alpha=alpha, bits=bits)
    with torch.no_grad():
        _, wx = rsg.embed(basis, alpha, bits, TINY, prec)
        return port_img, rsg.synthesis(inputs.gen, wx, inputs.noise, prec)


def test_synthesis_and_control(setup):
    port_img, ref_img = _images(setup, Precision())
    assert _rel(port_img, ref_img) < TOL["image"]
    port_img, low = _images(setup, Precision("bfloat16"))
    assert _rel(low, port_img) > 10 * TOL["image"]


def _step(setup, prec):
    """The reference's loss and gradient against the port's per_elem loss and its autograd."""
    P, mcfg, pipe, inputs, basis = setup
    acfg = P.config.AttributionConfig(steps=1, n_starts=3)
    target = rsg.synthesis(inputs.gen, basis["mean"][None], inputs.noise).detach()
    tf_port = [f[:, None] for f in P.lpips.extract_features(pipe.lpips_params, target)]
    _, per_elem = P.attribute.make_attribution_step(pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, mcfg,
                                                    acfg, tf_port, None)
    g = torch.Generator().manual_seed(5)
    alpha = (torch.rand((1, 3, basis["sigma_rest"].shape[0]), generator=g) * 2 - 1) * basis["sigma_rest"]
    key = torch.randn((1, 3, TINY["key_len"]), generator=g)
    a, k = alpha.clone().requires_grad_(True), key.clone().requires_grad_(True)
    per = per_elem(a, k)
    ga, gk = torch.autograd.grad(per.sum(), [a, k])
    ref = {"cfg": TINY, "gen": inputs.gen, "lpips": inputs.lpips, "noise": inputs.noise, "basis": basis}
    tf_ref = rl.target_features(inputs.lpips, target, prec)
    loss, ra, rk = rs.loss_and_grads(ref, alpha[0], key[0], tf_ref, {"bound_weight": 0.1}, 2, prec)
    return per[0].detach(), ga[0], gk[0], loss, ra, rk


def test_step_and_control(setup):
    per, ga, gk, loss, ra, rk = _step(setup, Precision())
    assert _rel(per, loss) < TOL["dist"]
    assert _rel(ga, ra) < TOL["grad"] and _rel(gk, rk) < TOL["grad"]
    per, ga, gk, loss, ra, rk = _step(setup, Precision("bfloat16"))
    assert _rel(per, loss) > TOL["dist"] and max(_rel(ga, ra), _rel(gk, rk)) > TOL["grad"]


def test_adam_matches_the_port():
    attr = importlib.import_module(f"{PORT}.fingerprint.attribute")
    cfg = importlib.import_module(f"{PORT}.config").AttributionConfig()
    g = torch.Generator().manual_seed(1)
    state = {n: torch.randn((2, 5), generator=g) for n in ("alpha", "key", "m_alpha", "m_key")}
    state.update({n: torch.rand((2, 5), generator=g) for n in ("v_alpha", "v_key")}, count=3)
    grads = {n: torch.randn((2, 5), generator=g) for n in ("alpha", "key")}
    new = attr.adam_update(state, grads, cfg)
    for n in ("alpha", "key"):
        mine = rs.adam(state[n], state["m_" + n], state["v_" + n], grads[n], 4,
                       {"lr": cfg.lr, "lr_decay": cfg.lr_decay})
        assert torch.allclose(mine["param"], new[n], rtol=1e-6, atol=1e-7)
        assert torch.allclose(mine["m"], new["m_" + n]) and torch.allclose(mine["v"], new["v_" + n])


def test_lhs_is_a_latin_hypercube():
    x = rs.centered_lhs(2, 5, 3, torch.Generator().manual_seed(0), "cpu")
    strata = torch.sort(((x + 1) / 2 * 5 - 0.5).round(), dim=1).values
    assert torch.equal(strata, torch.arange(5.0)[None, :, None].expand(2, 5, 3))
