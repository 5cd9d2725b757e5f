"""Attribution solves: the port's ``fingerprint.attribute.attribute``, a
request solving ``targets_per_solve`` targets x ``solver["n_starts"]``
Latin-hypercube restarts x ``solver["steps"]`` Adam steps in the compute
dtype of the mix.  ``solver`` is passed whole to the port's
``AttributionConfig``; ``remat`` to ``attribute``.

Set-up draws the seed's weights, noise and PCA latents; the reference works
out its own basis from them and renders the pool of fingerprinted targets
(content and keys from the seed) and the restarts' starting points; the port
builds its pipeline from the same weights and latents.  The window runs
solves back to back, each on the next target of the pool.

The comparison follows the solver step by step from the port's own state:
the harness wraps the solver's step (``make_attribution_step``, as the port's
``attribute`` finds it) so that it keeps a reference to every state it is
handed and returns; nothing is copied and nothing waits.  For a sample of the
window's solves drawn from the seed, the reference computes from the state
the port held before a step the loss of every restart and its gradient, and
the numbers compared are the worst relative gap of a restart's loss and the
worst relative gap of the gradient of all restarts together (of alpha, of
the key logits), the port's gradient as its first moment took it.  A single
restart's gradient is not compared alone: float32 rounding flips the slope
of the few activations (leaky ReLU, ReLU, max pool) that sit at rounding
level, and one restart's share of those flips swings from seed to seed.  The
Adam update is compared on the port's own gradient: the reference's Adam
step applied to the state the port was handed and the gradient its first
moment took gives the parameters and second moment the port has to return
(``update_gap``).  Against the reference's own gradient it could not be
compared: the first step is lr * sign(g), which flips wherever a gradient
coordinate is at rounding level.  The start (the given initial state), the
chain of states and their step counts, and the final selection (the best
restart, its parameters and key bits) are held exactly.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Optional

import torch

from portbench.core import Reservoir, SpecError
from portbench.flops import lpips_vgg16 as flops_lp
from portbench.flops import stylegan2 as flops_sg
from portbench.kinds import common
from portbench.reference import lpips_vgg16 as ref_lp
from portbench.reference import solver as ref_solver
from portbench.reference import stylegan2 as ref_sg
from portbench.reference.precision import FLOAT32, Precision

LEAVES = ("alpha", "key")
QUIET_LEAF = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's is not compared
# solver settings whose path the reference does not follow (its step is the plain perceptual one)
UNFOLLOWED = {"loss": "perceptual", "coarse_to_fine": False, "polish_sweeps": 0, "prune_starts": 0,
              "solver_attack": "None"}


class Driver:
    def __init__(self, run):
        self.run = run
        self.tp = run.traffic
        self.cfg = run.config

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        run, cfg, tp, dev = self.run, self.cfg, self.tp, self.run.device
        self.inputs = common.draw_inputs(cfg, run.seed, dev, with_lpips=True)
        gen = self.inputs.rng
        t_ref = common.clock(dev)
        basis = common.reference_basis(self.inputs, cfg)
        self.ref = {"cfg": cfg, "gen": self.inputs.gen, "lpips": self.inputs.lpips, "noise": self.inputs.noise,
                    "basis": basis}
        bad = {k: v for k, v in tp["solver"].items() if k in UNFOLLOWED and v != UNFOLLOWED[k]}
        if bad:
            raise SpecError(f"the reference does not follow the solver settings {bad}")
        d_rest = basis["sigma_rest"].shape[0]
        pool, n, self.S = int(tp["target_pool"]), int(tp["solver"]["n_starts"]), int(tp["targets_per_solve"])
        alpha = torch.randn((pool, d_rest), generator=gen, device=dev) * basis["sigma_rest"]
        bits = torch.randint(0, 2, (pool, cfg["key_len"]), generator=gen, device=dev).float()
        with torch.no_grad():
            _, wx = ref_sg.embed(basis, alpha, bits, cfg)
            self.targets = torch.cat([ref_sg.synthesis(self.inputs.gen, wx[i:i + 1], self.inputs.noise)
                                      for i in range(pool)])
        self.inits = ref_solver.centered_lhs(int(tp["init_pool"]), n, d_rest, gen, dev) * basis["sigma_rest"]
        self.key0 = torch.zeros((self.S, n, cfg["key_len"]), device=dev)
        self.reference_s = common.clock(dev) - t_ref

        P = self.P = common.port()
        self.mcfg = common.model_config(P, cfg)
        self.acfg = P.config.AttributionConfig(**tp["solver"])
        self.pipe = P.pipeline.build_pipeline(self.mcfg, common.fingerprint_config(P, cfg), device=dev,
                                              gen_params=self.inputs.gen, lpips_params=self.inputs.lpips,
                                              pca_z=self.inputs.pca_z, noise=self.inputs.noise)
        self._log: Optional[list] = None
        self._real_step = P.attribute.make_attribution_step
        P.attribute.make_attribution_step = self._recording_step
        self.sample = Reservoir(int(tp["check_solves"]), run.seed)
        self._solve(0, dataclasses.replace(self.acfg, steps=int(tp["warm_steps"])))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _recording_step(self, *args, **kwargs):
        step, per_elem = self._real_step(*args, **kwargs)
        log = self._log

        def recorded(state, ctf_sigma=None):
            new, per = step(state, ctf_sigma)
            if log is not None:
                log.append((state, new, per))
            return new, per

        return recorded, per_elem

    def _rows(self, i: int, pool: int) -> list:
        """The pool rows of solve i's targets (and of their starting points)."""
        return [(i * self.S + s) % pool for s in range(self.S)]

    def _solve(self, i: int, acfg):
        pipe = self.pipe
        return self.P.attribute.attribute(
            pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, self.targets[self._rows(i, len(self.targets))],
            mcfg=self.mcfg, acfg=acfg, alpha_init=self.inits[self._rows(i, len(self.inits))], key_init=self.key0,
            dtype=self.tp["dtype"], remat=bool(self.tp.get("remat", False)), **self.P.pipeline.solver_kwargs(pipe))

    # -- the window ---------------------------------------------------------

    def request(self, i: int):
        self._log = log = []
        try:
            res = self._solve(i, self.acfg)
            loss, _ = res.loss.cpu(), res.key_bits.cpu()  # the answer, on the host
            ok = bool(torch.isfinite(loss).all()) and bool(torch.isfinite(res.losses_all).all())
        except Exception as exc:  # a failed request is counted, and the window goes on
            import traceback

            traceback.print_exception(exc)
            return False, {}
        finally:
            self._log = None
        self.sample.offer((i, log, res))
        return ok, {"solves": 1, "chain_steps": self.acfg.steps * self.acfg.n_starts * self.S}

    def flops_per(self, unit: str) -> Optional[float]:
        """Useful operations of one chain-step: synthesis forward and backward
        to w+, LPIPS forward and backward to the image, one chain."""
        if unit != "chain_steps":
            return None
        return (flops_sg.synthesis(self.cfg, 1, self.tp["dtype"], True)["flops"]
                + flops_lp.lpips(self.cfg["img_size"], 1, self.tp["dtype"], True)["flops"])

    def probe(self, layer: str):
        """One call of ``layer`` at the solve's batch and dtype, forward and
        backward, with its frozen counts."""
        P, pipe, n = self.P, self.pipe, self.acfg.n_starts * self.S
        dt = P.attribute.compute_dtype(self.tp["dtype"])
        size = self.cfg["img_size"]
        if layer == "lpips":
            img = self.targets[:1].expand(n, -1, -1, -1).to(dt).clone().requires_grad_(True)
            with torch.no_grad():
                tf = [f[:, None] for f in P.lpips.extract_features(pipe.lpips_params, self.targets[:1].to(dt))]

            def fn():
                feats = P.lpips.extract_raw_features(pipe.lpips_params, img)
                feats = [f.reshape((1, n) + tuple(f.shape[1:])) for f in feats]
                d = P.lpips.distance_from_raw_features(pipe.lpips_params, feats, tf)
                return torch.autograd.grad(d.sum(), img)

            return fn, flops_lp.lpips(size, n, self.tp["dtype"], True)
        if layer == "synthesis":
            nl = self.mcfg.n_latent
            w = pipe.basis.mean.expand(n, nl, -1).to(dt).clone().requires_grad_(True)
            ct = torch.ones((n, size, size, 3), dtype=dt, device=w.device)

            def fn():
                img = P.stylegan2.synthesis(pipe.gen_params, w, pipe.noise, blur_kernel=self.mcfg.blur_kernel)
                return torch.autograd.grad(img, w, ct)

            return fn, flops_sg.synthesis(self.cfg, n, self.tp["dtype"], True)
        return None

    def release(self) -> None:
        self.P.attribute.make_attribution_step = self._real_step
        self.pipe = None
        common.free_device(self.run.device)

    # -- the comparison -----------------------------------------------------

    def check(self, control: Optional[str] = None) -> Dict[str, float]:
        """The numbers compared: ``loss_gap`` (worst relative gap of a
        restart's loss), ``grad_gap`` (worst relative L2 gap of the gradient
        of all restarts, of alpha or of the key logits) and ``update_gap``
        (worst relative L2 gap, over all restarts, of a leaf's Adam step or
        of its new second moment), over the sampled solves' checked steps, and
        ``exact_mismatch`` (the start, the chain of states, the selection).
        With ``control`` the reference at that precision takes the port's
        place on the same states."""
        prec = Precision(control) if control else FLOAT32
        rng = random.Random(self.run.seed + 1)
        out = {"loss_gap": 0.0, "grad_gap": 0.0, "update_gap": 0.0, "exact_mismatch": 0.0}
        if not self.sample.items:
            return {k: float("nan") for k in out}
        solver = {"bound_weight": self.acfg.bound_weight, "lr": self.acfg.lr, "lr_decay": self.acfg.lr_decay}
        for i, log, res in self.sample.items:
            if not control:
                out["exact_mismatch"] += self._exact(i, log, res)
            steps = sorted({0, len(log) - 1, rng.randrange(len(log))})
            for s, row in enumerate(self._rows(i, len(self.targets))):
                with torch.no_grad():
                    tf_ref = ref_lp.target_features(self.ref["lpips"], self.targets[row][None])
                    tf_x = ref_lp.target_features(self.ref["lpips"], self.targets[row][None], prec) if control else None
                for k in steps:
                    self._compare(out, log[k], s, tf_ref, tf_x, solver, prec if control else None)
        return out

    def _compare(self, out, entry, s, tf_ref, tf_x, solver, prec) -> None:
        """One step of target s: the port's loss, gradient and Adam step (or
        the control's) against the reference's."""
        tp = self.tp
        s_in, s_out, per = entry
        alpha, key = s_in["alpha"][s], s_in["key"][s]
        t = int(s_in["count"]) + 1
        loss_r, *g_r = ref_solver.loss_and_grads(self.ref, alpha, key, tf_ref, solver, int(tp["ref_block"]))
        g_r = dict(zip(LEAVES, g_r))
        if prec is not None:
            loss_x, *g_x = ref_solver.loss_and_grads(self.ref, alpha, key, tf_x, solver, int(tp["ref_block"]), prec)
            g_x = dict(zip(LEAVES, g_x))
            new_x = {}
            for nm in LEAVES:
                st = ref_solver.adam(s_in[nm][s], s_in["m_" + nm][s], s_in["v_" + nm][s], g_x[nm], t, solver, prec)
                new_x.update({nm: st["param"], "m_" + nm: st["m"], "v_" + nm: st["v"]})
        else:
            loss_x = per[s].float()
            new_x = {k: s_out[k][s] for k in s_out if k != "count"}
            g_x = {nm: self._taken(s_in, new_x, s, nm) for nm in LEAVES}
        out["loss_gap"] = max(out["loss_gap"], float(((loss_x - loss_r).abs() / loss_r.abs()).max()))
        norms = {nm: torch.linalg.norm(g_r[nm].double(), dim=-1) for nm in LEAVES}
        floor = QUIET_LEAF * float(torch.median(torch.cat(list(norms.values()))))
        for nm in LEAVES:
            keep = norms[nm] >= floor
            if keep.any():
                gap = common.rel_gap(g_x[nm][keep], g_r[nm][keep], None)
                out["grad_gap"] = max(out["grad_gap"], float(gap))
            # the Adam step on the gradient the first moment took, from the state the step was handed
            p_in = s_in[nm][s]
            want = ref_solver.adam(p_in, s_in["m_" + nm][s], s_in["v_" + nm][s], self._taken(s_in, new_x, s, nm), t,
                                   solver)
            gap = max(float(common.rel_gap(new_x[nm] - p_in, want["param"] - p_in, None)),
                      float(common.rel_gap(new_x["v_" + nm], want["v"], None)))
            out["update_gap"] = max(out["update_gap"], gap)

    @staticmethod
    def _taken(s_in, new, s, nm) -> torch.Tensor:
        """The gradient of leaf ``nm`` that the first moment took: (m' - b1 m) / (1 - b1)."""
        return (new["m_" + nm] - ref_solver.B1 * s_in["m_" + nm][s]) / (1.0 - ref_solver.B1)

    def _exact(self, i: int, log: List[Any], res) -> int:
        """Mismatches of the start (the given initial state), the chain of
        states from step to step and their step counts, and the final
        selection."""
        bad = 0
        s0 = log[0][0]
        bad += not torch.equal(s0["alpha"], self.inits[self._rows(i, len(self.inits))])
        bad += not torch.equal(s0["key"], self.key0)
        bad += any(bool(s0[m].abs().max() != 0) for m in ("m_alpha", "v_alpha", "m_key", "v_key"))
        bad += int(s0["count"]) != 0
        bad += len(log) != self.acfg.steps
        bad += sum(log[k][0] is not log[k - 1][1] for k in range(1, len(log)))
        bad += sum(int(new["count"]) != int(old["count"]) + 1 for old, new, _ in log)
        _, last, per = log[-1]
        bad += not torch.equal(res.losses_all, per)
        bad += not torch.equal(res.key_logits_all, last["key"])
        for s in range(self.S):
            best = int(torch.argmin(per[s]))
            bad += int(res.best_start[s]) != best
            bad += not torch.equal(res.loss[s], per[s, best])
            bad += not torch.equal(res.alpha[s], last["alpha"][s, best])
            bad += not torch.equal(res.key_logits[s], last["key"][s, best])
            bad += not torch.equal(res.key_bits[s], torch.round(torch.sigmoid(last["key"][s, best])))
        return bad
