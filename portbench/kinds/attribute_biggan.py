"""Attribution solves with BigGAN-deep as the generator: the request, the
window and the comparison of :mod:`.attribute` (its ``Driver``, subclassed),
with the BigGAN reference (``reference/biggan.py``) in StyleGAN2's place.

Set-up draws the seed's generator weights, the truncated noise of the PCA
and LPIPS; the port builds its pipeline from them on its normal path (the
published configuration of the image size, ``BigGANConfig.for_size``, chosen
by ``build_pipeline``; a port without the configuration raises here, before
the reference's work).  The reference then works out its own basis, renders
the pool of fingerprinted targets (class ``config["class"]`` at
``config["truncation"]``) and the restarts' starting points.

A request's work counts the chain-steps and, where the port counts them, the
images its BigGAN generator rendered (``models.biggan.render_counts``): a
solve renders one image a chain-step and nothing else.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from types import SimpleNamespace
from typing import Optional

import torch

from portbench.core import PORT, Reservoir, SpecError
from portbench.flops import biggan as flops_bg
from portbench.flops import lpips_vgg16 as flops_lp
from portbench.kinds import attribute, common
from portbench.reference import biggan as ref_bg
from portbench.reference import lpips_vgg16 as ref_lp
from portbench.reference import solver as ref_solver
from portbench.reference.precision import exact_float32


class Driver(attribute.Driver):
    def setup(self) -> None:
        run, cfg, tp, dev = self.run, self.cfg, self.tp, self.run.device
        exact_float32()
        gen = torch.Generator(device=dev)
        gen.manual_seed(run.seed)
        weights = ref_bg.make_params(cfg, gen, dev)
        pca_z = ref_bg.truncated_noise(cfg["n_pca_samples"], cfg["truncation"], cfg["z_dim"], gen, dev)
        lpips = ref_lp.make_params(gen, dev)
        bad = {k: v for k, v in tp["solver"].items() if k in attribute.UNFOLLOWED and v != attribute.UNFOLLOWED[k]}
        if bad:
            raise SpecError(f"the reference does not follow the solver settings {bad}")

        P = self.P = common.port()
        self.bg = importlib.import_module(f"{PORT}.models.biggan")
        self.mcfg = P.config.ModelConfig(model="biggan", img_size=cfg["img_size"], biggan_label=str(cfg["class"]),
                                         ckpt=None)
        self.acfg = P.config.AttributionConfig(**tp["solver"])
        self.pipe = P.pipeline.build_pipeline(self.mcfg, common.fingerprint_config(P, cfg), device=dev,
                                              gen_params=weights, lpips_params=lpips, pca_z=pca_z,
                                              truncation=cfg["truncation"])

        t_ref = common.clock(dev)
        with torch.no_grad():
            basis = ref_bg.build_basis(pca_z, cfg)
        self.ref = {"cfg": cfg, "gen": weights, "lpips": lpips, "basis": basis}
        d_rest = basis["sigma_rest"].shape[0]
        pool, n, self.S = int(tp["target_pool"]), int(tp["solver"]["n_starts"]), int(tp["targets_per_solve"])
        alpha = torch.randn((pool, d_rest), generator=gen, device=dev) * basis["sigma_rest"]
        bits = torch.randint(0, 2, (pool, cfg["key_len"]), generator=gen, device=dev).float()
        with torch.no_grad():
            _, wx = ref_bg.embed(basis, alpha, bits, cfg)
            self.targets = torch.cat([ref_bg.generate(weights, wx[i:i + 1], cfg) for i in range(pool)])
        self.inits = ref_solver.centered_lhs(int(tp["init_pool"]), n, d_rest, gen, dev) * basis["sigma_rest"]
        self.key0 = torch.zeros((self.S, n, cfg["key_len"]), device=dev)
        self.reference_s = common.clock(dev) - t_ref

        self._log: Optional[list] = None
        self._real_step = P.attribute.make_attribution_step
        P.attribute.make_attribution_step = self._recording_step
        self.sample = Reservoir(int(tp["check_solves"]), run.seed)
        self._solve(0, dataclasses.replace(self.acfg, steps=int(self.tp["warm_steps"])))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _rendered(self) -> Optional[int]:
        counts = getattr(self.bg, "render_counts", None)
        return counts()["biggan_images"] if counts is not None else None

    def request(self, i: int):
        before = self._rendered()
        ok, work = super().request(i)
        if work and before is not None:
            work["biggan_images"] = self._rendered() - before
        return ok, work

    def flops_per(self, unit: str) -> Optional[float]:
        """Useful operations of one chain-step: the generator forward and
        backward to z, LPIPS forward and backward to the image, one chain."""
        if unit != "chain_steps":
            return None
        return (flops_bg.generator(self.cfg, 1, self.tp["dtype"], True)["flops"]
                + flops_lp.lpips(self.cfg["img_size"], 1, self.tp["dtype"], True)["flops"])

    def probe(self, layer: str):
        """``lpips`` as in :mod:`.attribute`; ``biggan``, the generator
        forward and backward to z at the solve's chains; ``attention``, the
        non-local block alone, forward and backward to its input, at the
        solve's chains and the block's shape."""
        pipe, n, dt = self.pipe, self.acfg.n_starts * self.S, self.tp["dtype"]
        if layer == "lpips":
            return super().probe(layer)
        if layer == "biggan":
            z = pipe.basis.mean.expand(n, -1).clone().requires_grad_(True)
            onehot = pipe.class_onehot.expand(n, -1)
            ct = torch.ones((n, self.cfg["img_size"], self.cfg["img_size"], 3), device=z.device)

            def fn():
                img = self.bg.generate(pipe.gen_params, z, onehot, pipe.truncation, pipe.biggan_cfg)
                return torch.autograd.grad(img, z, ct)

            return fn, flops_bg.generator(self.cfg, n, dt, True)
        if layer == "attention":
            c, side = flops_bg.attention_shape(self.cfg)
            g = torch.Generator(device=self.run.device)
            g.manual_seed(self.run.seed)
            x = torch.randn((n, c, side, side), generator=g, device=self.run.device).requires_grad_(True)
            ct = torch.ones_like(x)

            def fn():
                return torch.autograd.grad(self.bg.self_attention(x, pipe.gen_params["attn"]), x, ct)

            return fn, flops_bg.attention(self.cfg, n, dt, True)
        return None

    def check(self, control: Optional[str] = None):
        """:meth:`attribute.Driver.check` with the BigGAN reference's loss and
        gradients."""
        with _reference_solver():
            return super().check(control)


@contextlib.contextmanager
def _reference_solver():
    """Inside, :mod:`.attribute` computes the reference's loss and gradients
    with the BigGAN objective (its ``ref_solver.loss_and_grads``); Adam stays
    ``reference/solver.py``'s."""
    real = attribute.ref_solver
    attribute.ref_solver = SimpleNamespace(B1=ref_solver.B1, adam=ref_solver.adam, loss_and_grads=ref_bg.loss_and_grads)
    try:
        yield
    finally:
        attribute.ref_solver = real
