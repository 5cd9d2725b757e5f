"""Micro-batching inference engine for fingerprinted generation and attribution.

Counterpart of the reference package's ``serving/engine.py``:

- **Static-shape buckets.**  Requests are coalesced and padded up to the
  nearest of a few batch sizes, so the card only ever sees those shapes.
  ``warmup`` runs every (kind, bucket) once on dummy inputs before serving
  (the kernel library is built, cuDNN picks its algorithms for each shape),
  so the first real request pays neither.
- **Per-request randomness.**  Generation draws each row's alpha and key bits
  from CPU generators folded from that request's seed, so a response is a
  function of its payload alone, whatever batch it shares.
- **One worker thread owns all device work.**  Clients block on futures;
  the worker drains the queue kind whose head has waited longest.

Generation and attribution route by the pipeline's model family (StyleGAN2
or BigGAN).  Attribution requests run the batched solver over the coalesced
targets.
Its restarts are drawn per batch from a counter, so an attribution is
reproducible given (engine seed, attribute-batch index, batch composition),
not per request.  With an encoder (``fingerprint/encoder.py``) the restarts
start around its prediction.

On a ``parallel.mesh`` grid (``mesh=``; every bucket a multiple of the
"data" axis) the pipeline is placed once and each device batch is sharded
over "data": rank 0 runs the queue and the worker thread and broadcasts each
batch's kind, bucket and inputs; every other rank loops in :meth:`follow`,
runs the same batch function on its rows, and the rows come back by a
gather.  :meth:`stop` on rank 0 ends the followers' loops.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AttackConfig, AttributionConfig
from ..fingerprint import attribute as attr_mod
from ..fingerprint import encoder as enc_mod
from ..fingerprint.embed import embed
from ..fingerprint.pipeline import Pipeline, solver_kwargs, synthesize
from ..parallel.mesh import all_gather_rows, replicate, shard_batch
from ..parallel.multihost import broadcast_one_to_all
from ..parallel.solver import place_pipeline, solve_rows
from ..utils.lhs import fold_in

KINDS = ("generate", "attribute")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs.

    ``buckets``: the static batch shapes (ascending).  ``max_wait_ms``: the
    coalescing window after a batch's first request.  ``aot_warmup``: warm
    every bucket in ``start()``.  ``latency_window``: ring buffer of the
    latency percentiles."""

    buckets: Tuple[int, ...] = (1, 4, 8)
    max_wait_ms: float = 5.0
    max_queue: int = 1024
    aot_warmup: bool = True
    latency_window: int = 1024


class EngineUnavailable(RuntimeError):
    """Transient capacity/lifecycle failure (queue full, engine stopped): the
    request was fine, retry later.  The HTTP layer maps it to 503."""


class EngineMisconfigured(RuntimeError):
    """The request is fine but this engine is not set up to serve it (no
    AttributionConfig, no KeyRegistry).  The HTTP layer maps it to 501."""


@dataclasses.dataclass
class _Request:
    kind: str
    payload: Dict[str, Any]
    future: Future
    t_enqueue: float


@torch.no_grad()
def generate_rows(pipe: Pipeline, seeds: Sequence[int], bits_in: np.ndarray, has_bits: np.ndarray
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(imgs, wx, bits) for one padded batch: row i draws alpha from
    ``fold_in(seeds[i], 0)`` and its key bits from ``fold_in(seeds[i], 1)``
    unless ``has_bits[i]``, where ``bits_in[i]`` is planted."""
    basis = pipe.basis
    d, key_len = basis.sigma_rest.shape[0], pipe.fpcfg.key_len
    z = torch.stack([torch.randn((d,), generator=fold_in(int(s), 0)) for s in seeds])
    drawn = torch.stack([torch.randint(0, 2, (key_len,), generator=fold_in(int(s), 1)) for s in seeds])
    bits = torch.where(torch.from_numpy(has_bits)[:, None], torch.from_numpy(bits_in), drawn.float())
    alpha = z.to(pipe.device) * basis.sigma_rest
    _, wx = embed(basis, alpha, bits.to(pipe.device))
    return synthesize(pipe, wx), wx, bits


class InferenceEngine:
    """Request-batching executor over a built fingerprint Pipeline.

        eng = InferenceEngine(pipe, acfg=acfg).start()   # acfg optional; warms the buckets
        out = eng.generate(seed=7)                        # dict, blocking
        fut = eng.generate(seed=8, sync=False)            # Future
        dec = eng.attribute(img_hwc)                      # dict, blocking
        eng.stop()
    """

    def __init__(self, pipe: Pipeline, acfg: Optional[AttributionConfig] = None,
                 cfg: ServeConfig = ServeConfig(), seed: int = 0, registry=None,
                 encoder_params=None, encoder_jitter: float = 0.25,
                 attack_cfg: Optional[AttackConfig] = None, mesh=None, shard_model: bool = False):
        if not cfg.buckets or list(cfg.buckets) != sorted(set(cfg.buckets)):
            raise ValueError(f"buckets must be ascending+unique: {cfg.buckets}")
        self.mesh = mesh
        if mesh is not None:
            data = mesh.shape["data"]
            bad = [b for b in cfg.buckets if b % data]
            if bad:
                raise ValueError(f"buckets {bad} not divisible by mesh data axis {data}")
            pipe = place_pipeline(mesh, pipe, shard_model=shard_model)
            replicate(mesh, encoder_params)
        self._followers_released = False
        self.pipe = pipe
        self.acfg = acfg
        self.cfg = cfg
        self.seed = seed
        self.registry = registry  # the setter validates and builds the name index
        self.encoder_params = encoder_params
        self.encoder_jitter = encoder_jitter
        self.attack_cfg = attack_cfg  # strengths of acfg.solver_attack's channel model
        self._warm = set()
        self._queues: Dict[str, collections.deque] = {k: collections.deque() for k in KINDS}
        self._cond = threading.Condition()
        self._stop = False
        self._worker: Optional[threading.Thread] = None
        self._seed_counter = 0  # seeds of generate() calls that give none
        self._attr_counter = 0  # the solver's generator stream, one per attribute batch
        self._lock = threading.Lock()
        self._n_requests = collections.Counter()
        self._n_batches = collections.Counter()
        self._n_padded_rows = collections.Counter()
        self._n_real_rows = collections.Counter()
        self._latencies = {k: collections.deque(maxlen=cfg.latency_window) for k in KINDS}

    # registry (fingerprint.keys.KeyRegistry or None)
    @property
    def registry(self):
        return self._registry

    @registry.setter
    def registry(self, reg) -> None:
        """Validated when attached, not on the first identify; builds the
        name -> index map the generate path uses."""
        if reg is not None and reg.keys.shape[1] != self.pipe.fpcfg.key_len:
            raise ValueError(f"registry key_len {reg.keys.shape[1]} != pipeline key_len "
                             f"{self.pipe.fpcfg.key_len}")
        self._registry = reg
        self._user_index = None if reg is None else {n: i for i, n in enumerate(reg.names)}

    # lifecycle
    def start(self) -> "InferenceEngine":
        if self.cfg.aot_warmup:
            self.warmup()
        self._stop = False
        self._worker = threading.Thread(target=self._run, name="fp-serve-worker", daemon=True)
        self._worker.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=timeout)
            self._worker = None
        for q in self._queues.values():  # fail stragglers rather than hang their clients
            while q:
                q.popleft().future.set_exception(EngineUnavailable("engine stopped"))
        if self.mesh is not None and not self._followers_released:
            self._followers_released = True
            broadcast_one_to_all(None)  # ends the followers' loops

    def follow(self) -> None:
        """A follower rank's loop (a mesh's ranks but 0): run every batch that
        rank 0 broadcasts, on this rank's rows, until rank 0 stops."""
        while True:
            msg = broadcast_one_to_all(None)
            if msg is None:
                return
            self._run_rows(*msg)

    def warmup(self, kinds: Optional[Sequence[str]] = None) -> Dict[str, float]:
        """Run every (kind, bucket) once on dummy inputs, before the worker
        starts; the solve is cut to 2 steps (each step launches the same
        kernels at the same shapes).  Returns seconds per kind."""
        if kinds is None:
            kinds = ["generate"] + (["attribute"] if self.acfg is not None else [])
        took = {}
        for kind in kinds:
            t0 = time.perf_counter()
            for b in self.cfg.buckets:
                self.run_bucket(kind, b, self._dummy_rows(kind, b), warm=True)
                with self._lock:
                    self._warm.add((kind, b))
            took[kind] = time.perf_counter() - t0
        return took

    def _dummy_rows(self, kind: str, b: int):
        if kind == "generate":
            return [{"seed": i, "bits": None} for i in range(b)]
        if self.acfg is None:
            raise EngineMisconfigured("engine built without an AttributionConfig; attribution serving is disabled")
        hw = self.pipe.mcfg.img_size
        return [{"image": np.zeros((hw, hw, 3), np.float32)} for _ in range(b)]

    # public request API
    def generate(self, seed: Optional[int] = None, key_bits: Optional[Sequence[int]] = None,
                 user: Optional[str] = None, sync: bool = True, timeout: Optional[float] = None):
        """One fingerprinted image.  ``seed=None`` draws an engine-local seed;
        ``key_bits`` (0/1, key_len long) or ``user`` (a registered name) plants
        that key instead of a drawn one.  Returns (or resolves to)
        ``{"image", "w", "key_bits", "seed"}``, the image float32 [-1, 1] HWC."""
        if user is not None:
            if key_bits is not None:
                raise ValueError("pass either key_bits or user, not both")
            if self.registry is None:
                raise EngineMisconfigured("no KeyRegistry attached to this engine")
            idx = self._user_index.get(user)
            if idx is None:
                raise ValueError(f"unknown user {user!r}")
            key_bits = self.registry.keys[idx]
        if seed is None:
            with self._lock:
                self._seed_counter += 1
                seed = (self.seed * 1_000_003 + self._seed_counter) % (2**31)
        else:
            seed = int(seed) % (2**31)  # out-of-range seeds reduce, they do not fail the batch
        bits = None
        if key_bits is not None:
            bits = np.asarray(key_bits, dtype=np.float32).reshape(-1)
            if bits.shape[0] != self.pipe.fpcfg.key_len:
                raise ValueError(f"key_bits must have length {self.pipe.fpcfg.key_len}, got {bits.shape[0]}")
            if not np.isin(bits, (0.0, 1.0)).all():
                raise ValueError("key_bits must be 0/1")
        fut = self._submit("generate", {"seed": seed, "bits": bits})
        return fut.result(timeout=timeout) if sync else fut

    def attribute(self, image: np.ndarray, sync: bool = True, timeout: Optional[float] = None):
        """Decode the key of one image (float [-1, 1] HWC).  Returns
        ``{"key_bits", "key_logits", "confidence", "loss"}``; confidence is
        |sigmoid(logit) - 0.5| * 2 per bit."""
        if self.acfg is None:
            raise EngineMisconfigured("attribution serving disabled (no acfg)")
        img = np.asarray(image, dtype=np.float32)
        hw = self.pipe.mcfg.img_size
        if img.shape != (hw, hw, 3):
            raise ValueError(f"image must be ({hw},{hw},3), got {img.shape}")
        fut = self._submit("attribute", {"image": img})
        return fut.result(timeout=timeout) if sync else fut

    def identify(self, image: np.ndarray, sync: bool = True, timeout: Optional[float] = None):
        """Attribute the image, then decode WHICH registered user's key it
        carries: ``match_soft`` on the solver's logits, ``match_hard`` on its
        bits.  Returns ``{"user", "user_index", "log_likelihood",
        "margin_nats", "hard_match_user", "hard_distance", "key_bits", "loss"}``."""
        if self.registry is None:
            raise EngineMisconfigured("no KeyRegistry attached to this engine")
        reg = self.registry
        inner = self.attribute(image, sync=False)

        def finish(att: Dict[str, Any]) -> Dict[str, Any]:
            si, ll, margin = reg.match_soft(att["key_logits"])
            hi, hd, _ = reg.match_hard(att["key_bits"])
            return {"user": reg.names[si], "user_index": si, "log_likelihood": ll, "margin_nats": margin,
                    "hard_match_user": reg.names[hi], "hard_distance": hd, "key_bits": att["key_bits"],
                    "loss": att["loss"]}

        if sync:
            return finish(inner.result(timeout=timeout))
        out: Future = Future()

        def chain(f: Future):
            try:
                out.set_result(finish(f.result()))
            except Exception as e:  # noqa: BLE001 - the client reads it from the future
                out.set_exception(e)

        inner.add_done_callback(chain)
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "buckets": list(self.cfg.buckets),
                "queue_depth": {k: len(q) for k, q in self._queues.items()},
                "compiled": sorted(f"{k}:{b}" for (k, b) in self._warm),
            }
            for kind in KINDS:
                lats = sorted(self._latencies[kind])
                nb, real, pad = self._n_batches[kind], self._n_real_rows[kind], self._n_padded_rows[kind]
                out[kind] = {
                    "requests": self._n_requests[kind],
                    "batches": nb,
                    "mean_batch_occupancy": real / max(1, real + pad) if nb else None,
                    "latency_ms_p50": 1e3 * lats[len(lats) // 2] if lats else None,
                    "latency_ms_p99": 1e3 * lats[min(len(lats) - 1, int(len(lats) * 0.99))] if lats else None,
                }
            return out

    # worker
    def _submit(self, kind: str, payload: Dict[str, Any]) -> Future:
        fut: Future = Future()
        req = _Request(kind, payload, fut, time.perf_counter())
        with self._cond:
            if self._stop or self._worker is None:
                raise EngineUnavailable("engine not running (call start())")
            if sum(len(q) for q in self._queues.values()) >= self.cfg.max_queue:
                raise EngineUnavailable("queue full")
            self._queues[kind].append(req)
            self._cond.notify_all()
        with self._lock:
            self._n_requests[kind] += 1
        return fut

    def _bucket_for(self, n: int) -> int:
        for b in self.cfg.buckets:
            if n <= b:
                return b
        return self.cfg.buckets[-1]

    def _run(self) -> None:
        max_b = self.cfg.buckets[-1]
        wait_s = self.cfg.max_wait_ms / 1e3
        while True:
            with self._cond:
                while not self._stop and not any(self._queues.values()):
                    self._cond.wait(timeout=0.1)
                if self._stop:
                    return
                # serve the kind whose head request has waited longest
                kind = min((k for k, q in self._queues.items() if q), key=lambda k: self._queues[k][0].t_enqueue)
                q = self._queues[kind]
                batch = [q.popleft()]
                deadline = time.perf_counter() + wait_s
                while len(batch) < max_b:
                    if q:
                        batch.append(q.popleft())
                        continue
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                    if self._stop:
                        break  # still answer what was taken
            try:
                self._execute(kind, batch)
            except Exception as e:  # noqa: BLE001 - fail this batch's requests, keep serving
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

    def run_bucket(self, kind: str, b: int, rows, warm: bool = False):
        """One device batch of bucket ``b`` over ``rows`` (request payloads), as
        the worker runs it; padded rows repeat the last real row.  Results as
        host arrays.  Call it only while the worker is stopped or idle.  On a
        mesh the followers run it too (rank 0 broadcasts the batch)."""
        rows = list(rows) + [rows[-1]] * (b - len(rows))
        attr_seed = None
        if kind == "attribute":
            with self._lock:
                if not warm:
                    self._attr_counter += 1
                attr_seed = self.seed * 7_919 + self._attr_counter
        if self.mesh is not None:
            broadcast_one_to_all((kind, rows, warm, attr_seed))
        return self._run_rows(kind, rows, warm, attr_seed)

    def _run_rows(self, kind: str, rows, warm: bool, attr_seed: Optional[int]):
        """The batch function: on a mesh each rank computes its rows of the
        batch and the rows are gathered."""
        p, mesh = self.pipe, self.mesh
        if kind == "generate":
            seeds = [r["seed"] for r in rows]
            bits = np.stack([r["bits"] if r["bits"] is not None else np.zeros(p.fpcfg.key_len, np.float32)
                             for r in rows])
            has = np.asarray([r["bits"] is not None for r in rows])
            if mesh is None:
                imgs, wx, out_bits = generate_rows(p, seeds, bits, has)
                return imgs.cpu().numpy(), wx.cpu().numpy(), out_bits.numpy(), seeds
            local = [shard_batch(mesh, torch.from_numpy(a)).numpy() for a in (np.asarray(seeds), bits, has)]
            out = generate_rows(p, local[0].tolist(), local[1], local[2])
            imgs, wx, out_bits = (all_gather_rows(mesh, x.to(p.device)).cpu().numpy() for x in out)
            return imgs, wx, out_bits, seeds
        acfg = dataclasses.replace(self.acfg, steps=min(self.acfg.steps, 2)) if warm else self.acfg
        targets = torch.from_numpy(np.stack([r["image"] for r in rows])).to(p.device)
        g = torch.Generator().manual_seed(attr_seed)
        kw = dict(mcfg=p.mcfg, acfg=acfg, generator=g,
                  attack_cfg=self.attack_cfg if acfg.solver_attack != "None" else None, **solver_kwargs(p))
        if self.encoder_params is not None:
            kw["alpha_init"], kw["key_init"] = enc_mod.encoder_solve_init(
                self.encoder_params, p.basis, targets, acfg.n_starts, g, jitter=self.encoder_jitter)
        if mesh is None:
            res = attr_mod.attribute(p.gen_params, p.lpips_params, p.basis, p.noise, targets, **kw)
        else:
            res = solve_rows(mesh, p.gen_params, p.lpips_params, p.basis, p.noise, shard_batch(mesh, targets), **kw)
        return res.key_bits.cpu().numpy(), res.key_logits.cpu().numpy(), res.loss.cpu().numpy()

    def _execute(self, kind: str, batch) -> None:
        n = len(batch)
        b = self._bucket_for(n)
        out = self.run_bucket(kind, b, [req.payload for req in batch])
        if kind == "generate":
            imgs, wx, out_bits, seeds = out
            for i, req in enumerate(batch):
                req.future.set_result({"image": imgs[i], "w": wx[i], "key_bits": out_bits[i].astype(np.int32),
                                       "seed": int(seeds[i])})
        else:
            key_bits, key_logits, loss = out
            for i, req in enumerate(batch):
                conf = np.abs(1.0 / (1.0 + np.exp(-key_logits[i])) - 0.5) * 2.0
                req.future.set_result({"key_bits": key_bits[i].astype(np.int32), "key_logits": key_logits[i],
                                       "confidence": conf, "loss": float(loss[i])})
        with self._lock:
            self._warm.add((kind, b))
            self._n_batches[kind] += 1
            self._n_real_rows[kind] += n
            self._n_padded_rows[kind] += b - n
            now = time.perf_counter()
            for req in batch:
                self._latencies[kind].append(now - req.t_enqueue)
