"""Fingerprinted generation: a request is the port's
``fingerprint.pipeline.generate_fingerprinted`` of ``batch`` images with the
given content and keys, then ``utils.image.make_image`` to uint8 images on
the host, the path ``cli.generate`` and the serving engine take.

Set-up draws the seed's weights, noise and PCA latents, and each request's
content (the reference basis' sigmas times a normal draw) and key bits; the
port builds its pipeline (PCA and basis) from the same weights and latents.

The comparison takes a sample of the window's requests drawn from the seed:
the reference embeds the same content and keys in its own basis, renders
them and quantizes, and the numbers compared are the worst relative gap of
the fingerprinted latents and the worst mean absolute difference of an
image's uint8 values.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from portbench.core import Reservoir
from portbench.flops import stylegan2 as flops_sg
from portbench.kinds import common
from portbench.reference import stylegan2 as ref_sg
from portbench.reference.precision import FLOAT32, Precision


class Driver:
    def __init__(self, run):
        self.run = run
        self.tp = run.traffic
        self.cfg = run.config

    def setup(self) -> None:
        run, cfg, tp, dev = self.run, self.cfg, self.tp, self.run.device
        self.inputs = common.draw_inputs(cfg, run.seed, dev, with_lpips=False)
        gen = self.inputs.rng
        t_ref = common.clock(dev)
        self.basis = common.reference_basis(self.inputs, cfg)
        self.reference_s = common.clock(dev) - t_ref
        pool, b = int(tp["request_pool"]), int(tp["batch"])
        d_rest = self.basis["sigma_rest"].shape[0]
        self.alphas = torch.randn((pool, b, d_rest), generator=gen, device=dev) * self.basis["sigma_rest"]
        self.bits = torch.randint(0, 2, (pool, b, cfg["key_len"]), generator=gen, device=dev).float()
        P = self.P = common.port()
        self.mcfg = common.model_config(P, cfg)
        self.pipe = P.pipeline.build_pipeline(self.mcfg, common.fingerprint_config(P, cfg), device=dev,
                                              gen_params=self.inputs.gen, want_lpips=False, pca_z=self.inputs.pca_z,
                                              noise=self.inputs.noise)
        self.sample = Reservoir(int(tp["check_requests"]), run.seed)
        for i in range(int(tp["warm_requests"])):
            self._generate(i)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _generate(self, i: int):
        j = i % len(self.alphas)
        imgs, w0, wx, _, _ = self.P.pipeline.generate_fingerprinted(self.pipe, int(self.tp["batch"]),
                                                                     alpha=self.alphas[j], bits=self.bits[j])
        finite = torch.isfinite(imgs).all()
        return self.P.image.make_image(imgs), w0, wx, finite

    def request(self, i: int):
        try:
            u8, w0, wx, finite = self._generate(i)
            ok = bool(finite)
        except Exception as exc:  # a failed request is counted, and the window goes on
            import traceback

            traceback.print_exception(exc)
            return False, {}
        self.sample.offer((i, u8, w0, wx))
        return ok, {"requests": 1, "images": int(self.tp["batch"])}

    def flops_per(self, unit: str) -> Optional[float]:
        """Useful operations of one image: the synthesis forward."""
        if unit != "images":
            return None
        return flops_sg.synthesis(self.cfg, 1, self.tp["dtype"], False)["flops"]

    def probe(self, layer: str):
        if layer != "synthesis":
            return None
        P, pipe, n = self.P, self.pipe, int(self.tp["batch"])
        w = pipe.basis.mean.expand(n, self.mcfg.n_latent, -1).contiguous()

        def fn():
            with torch.no_grad():
                return P.stylegan2.synthesis(pipe.gen_params, w, pipe.noise, blur_kernel=self.mcfg.blur_kernel)

        return fn, flops_sg.synthesis(self.cfg, n, self.tp["dtype"], False)

    def release(self) -> None:
        self.pipe = None
        common.free_device(self.run.device)

    def check(self, control: Optional[str] = None) -> Dict[str, float]:
        """``embed_gap``: the worst relative gap of a content or fingerprinted
        latent; ``image_gap``: the worst mean absolute difference of one
        image's uint8 values, in levels.  With ``control`` the reference at
        that precision takes the port's place."""
        prec = Precision(control) if control else FLOAT32
        out = {"embed_gap": 0.0, "image_gap": 0.0}
        if not self.sample.items:
            return {k: float("nan") for k in out}
        block = int(self.tp["ref_block"])
        for i, u8, w0, wx in self.sample.items:
            j = i % len(self.alphas)
            with torch.no_grad():
                w0_r, wx_r = ref_sg.embed(self.basis, self.alphas[j], self.bits[j], self.cfg)
                if control:
                    w0, wx = ref_sg.embed(self.basis, self.alphas[j], self.bits[j], self.cfg, prec)
                    u8 = torch.cat([ref_sg.to_uint8(ref_sg.synthesis(self.inputs.gen, wx[r:r + block],
                                                                     self.inputs.noise, prec))
                                    for r in range(0, len(wx), block)])
                else:
                    u8 = torch.from_numpy(np.ascontiguousarray(u8)).to(wx_r.device)
                u8_r = torch.cat([ref_sg.to_uint8(ref_sg.synthesis(self.inputs.gen, wx_r[r:r + block],
                                                                   self.inputs.noise))
                                  for r in range(0, len(wx_r), block)])
            gap = max(float(common.rel_gap(w0, w0_r).max()), float(common.rel_gap(wx, wx_r).max()))
            out["embed_gap"] = max(out["embed_gap"], gap)
            diff = (u8.int() - u8_r.int()).abs().float().mean(dim=(1, 2, 3))
            out["image_gap"] = max(out["image_gap"], float(diff.max()))
        return out
