"""Key issuance + user identification: the deployment layer over bit recovery.

The port's own copy of the reference package's numpy-only
``fingerprint/keys.py`` (that package's ``fingerprint/__init__.py`` imports
its JAX solver, so the port cannot import the module from there).  Same
algorithms, same random streams, same JSON: a registry issued or saved by
either package loads and decodes identically in the other.

- ``KeyRegistry.issue``: random coding with a guaranteed minimum pairwise
  Hamming distance (rejection sampling), so up to ``(d_min-1)//2`` bit
  errors never flip the nearest codeword.
- ``KeyRegistry.issue_rm``: Reed-Muller RM(r, m) codewords, distance
  2^(m-r) by construction, millions of keys without pairwise checks.
- ``match_soft``: maximum-likelihood decoding from the solver's key logits;
  ``match_hard``: nearest codeword by Hamming distance.
- capacity math: the union-bound identification error for N users at a
  measured per-bit error rate, and a Monte-Carlo simulator.

Everything here is host-side numpy; the heavy lifting stays in the solver.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np


# decode chunk: bounds the [chunk, K] float temp of a registry match to a
# few MB regardless of N (issue_rm registries reach N ~ 4e6)
_DECODE_CHUNK = 1 << 16


def _best_two(scores: np.ndarray, *, smaller_is_better: bool):
    """(best, second) indices with ties broken toward the LOWER index ---
    identical tie semantics to the previous stable-argsort implementation
    (argmin/argmax return the first occurrence), without the O(N log N)
    sort.  ``second`` is -1 for a single-entry registry."""
    if scores.shape[0] == 1:
        return 0, -1
    if smaller_is_better:
        best = int(np.argmin(scores))
        masked = scores.copy()
        masked[best] = np.iinfo(scores.dtype).max if np.issubdtype(
            scores.dtype, np.integer) else np.inf
        return best, int(np.argmin(masked))
    best = int(np.argmax(scores))
    masked = scores.copy()
    masked[best] = -np.inf
    return best, int(np.argmax(masked))


@dataclasses.dataclass
class KeyRegistry:
    """Issued key codebook: ``keys`` [N, K] in {0,1} + user names."""

    keys: np.ndarray
    names: List[str]
    min_distance: int

    def __post_init__(self):
        self.keys = np.asarray(self.keys, dtype=np.int8)
        if self.keys.ndim != 2:
            raise ValueError(f"keys must be [N, K], got {self.keys.shape}")
        if not np.isin(self.keys, (0, 1)).all():
            raise ValueError("keys must be 0/1")
        if len(self.names) != self.keys.shape[0]:
            raise ValueError("names/keys length mismatch")

    # ------------------------------------------------------------------ #
    # issuance
    # ------------------------------------------------------------------ #
    @classmethod
    def issue(
        cls,
        n_users: int,
        key_len: int,
        min_distance: int = 1,
        seed: int = 0,
        names: Optional[Sequence[str]] = None,
        max_tries_per_key: int = 10_000,
    ) -> "KeyRegistry":
        """Draw ``n_users`` random keys with pairwise Hamming distance
        >= ``min_distance`` (rejection sampling).

        Random coding approaches the Gilbert-Varshamov bound; issuance
        raises once the ball-packing budget is exhausted rather than
        silently degrading the distance guarantee.
        """
        if min_distance < 1 or min_distance > key_len:
            raise ValueError(f"min_distance must be in [1, {key_len}]")
        rng = np.random.default_rng(seed)
        keys = np.zeros((n_users, key_len), np.int8)
        # Packed shadow copy for the distance check: Hamming distance as
        # popcount(xor) over ceil(K/64) uint64 words instead of an
        # [n, K] int8 row sum --- ~64x less memory traffic, which takes
        # issuance at N=1e5 / key_len=64 from ~9 min to seconds.  The
        # candidate RNG stream is untouched, so issued registries are
        # bit-identical to the unpacked implementation per seed.
        n_words = (key_len + 63) // 64
        packed = np.zeros((n_users, n_words), np.uint64)

        def _pack(bits: np.ndarray) -> np.ndarray:
            padded = np.zeros(n_words * 64, np.uint8)
            padded[:key_len] = bits
            return np.packbits(padded).view(np.uint64)

        n = 0
        while n < n_users:
            for _ in range(max_tries_per_key):
                cand = rng.integers(0, 2, key_len, dtype=np.int8)
                if n == 0:
                    break
                cand_packed = _pack(cand)
                dists = np.bitwise_count(packed[:n] ^ cand_packed).sum(axis=1)
                if int(dists.min()) >= min_distance:
                    break
            else:
                raise RuntimeError(
                    f"could not place key {n + 1}/{n_users} at "
                    f"min_distance={min_distance} with key_len={key_len} "
                    f"(ball packing exhausted; lower min_distance or "
                    f"n_users, or raise key_len)"
                )
            keys[n] = cand
            packed[n] = cand_packed if n else _pack(cand)
            n += 1
        if names is None:
            names = [f"user_{i:05d}" for i in range(n_users)]
        return cls(keys=keys, names=list(names), min_distance=min_distance)

    @classmethod
    def issue_rm(
        cls,
        n_users: int,
        key_len: int,
        seed: int = 0,
        r: int = 2,
        names: Optional[Sequence[str]] = None,
    ) -> "KeyRegistry":
        """Structured issuance from a Reed-Muller RM(r, m) code
        (``key_len`` must be 2^m): keys are random DISTINCT codewords, so
        the pairwise Hamming distance is >= the code's minimum distance
        2^(m-r) **by construction** --- no pairwise checking.

        Why: rejection sampling (``issue``) does O(N^2) popcount
        comparisons, out of reach at N=1e6, while RM evaluation is one
        [N, k] x [k, key_len] GF(2) matmul.  RM(2, 6) carries
        k = 1+6+15 = 22 message bits => 4,194,304 users at guaranteed
        distance 16 for key_len=64 (vs d=12 from rejection sampling at
        1e5); RM(2, 5) gives 65,536 users at d=8 for key_len=32.

        Generator matrix rows are the degree-<= r monomials in the m
        point-coordinate bits evaluated at all 2^m points (the textbook
        Boolean-polynomial construction).
        """
        m = key_len.bit_length() - 1
        if (1 << m) != key_len:
            raise ValueError(f"key_len must be a power of 2, got {key_len}")
        if not 1 <= r < m:
            raise ValueError(f"r must be in [1, {m - 1}]")
        from itertools import combinations
        from math import comb

        # coordinate bits of every evaluation point: [m, 2^m]
        pts = np.arange(key_len)
        coord = ((pts[None, :] >> np.arange(m)[:, None]) & 1).astype(np.uint8)
        rows = [np.ones(key_len, np.uint8)]
        for deg in range(1, r + 1):
            for idxs in combinations(range(m), deg):
                rows.append(np.bitwise_and.reduce(coord[list(idxs)], axis=0))
        gmat = np.stack(rows)  # [k, key_len]
        k = gmat.shape[0]
        assert k == sum(comb(m, i) for i in range(r + 1))
        capacity = 1 << k
        if n_users > capacity:
            raise ValueError(
                f"RM({r},{m}) carries {capacity} codewords; "
                f"asked for {n_users} (raise r or key_len)"
            )
        rng = np.random.default_rng(seed)
        msgs = rng.choice(capacity, size=n_users, replace=False)
        msg_bits = ((msgs[:, None] >> np.arange(k)[None, :]) & 1).astype(
            np.uint8
        )  # [N, k]
        keys = (msg_bits @ gmat) & 1  # row sums <= k = 22 < 256: no wrap
        if names is None:
            names = [f"user_{i:07d}" for i in range(n_users)]
        return cls(
            keys=keys.astype(np.int8),
            names=list(names),
            min_distance=1 << (m - r),
        )

    # ------------------------------------------------------------------ #
    # decoding
    # ------------------------------------------------------------------ #
    def match_hard(self, bits: np.ndarray) -> Tuple[int, int, int]:
        """Nearest codeword by Hamming distance for decoded bits [K].

        Returns (index, distance, margin) where margin = runner-up
        distance minus best distance (0 = ambiguous)."""
        bits = np.asarray(bits).reshape(-1).astype(np.int8)
        if bits.shape[0] != self.keys.shape[1]:
            raise ValueError(
                f"bits length {bits.shape[0]} != key_len {self.keys.shape[1]}"
            )
        # chunked XOR-popcount: million-user registries (issue_rm) must
        # not materialize an [N, K] temp per decode
        n = self.keys.shape[0]
        dists = np.empty(n, np.int32)
        for c0 in range(0, n, _DECODE_CHUNK):
            c1 = min(c0 + _DECODE_CHUNK, n)
            dists[c0:c1] = (self.keys[c0:c1] != bits).sum(
                axis=1, dtype=np.int32
            )
        best, second = _best_two(dists, smaller_is_better=True)
        margin = (
            int(dists[second] - dists[best]) if second >= 0 else
            int(self.keys.shape[1])
        )
        return best, int(dists[best]), margin

    def match_soft(self, key_logits: np.ndarray) -> Tuple[int, float, float]:
        """Maximum-likelihood decode from solver logits [K].

        The solver parameterizes bit b as sigmoid(logit)
        (fingerprint/attribute.py),
        so codeword c's log-likelihood is
        ``sum_j c_j * log sigmoid(l_j) + (1-c_j) * log sigmoid(-l_j)``.
        Returns (index, log_likelihood, margin) with margin = best - runner-up
        log-likelihood (in nats; larger = more confident)."""
        logits = np.asarray(key_logits, np.float64).reshape(-1)
        if logits.shape[0] != self.keys.shape[1]:
            raise ValueError(
                f"logits length {logits.shape[0]} != key_len "
                f"{self.keys.shape[1]}"
            )
        # log sigmoid(x) = -log1p(exp(-x)), stable both tails
        log_p1 = -np.logaddexp(0.0, -logits)  # log P(bit=1)
        log_p0 = -np.logaddexp(0.0, logits)  # log P(bit=0)
        # ll = keys @ log_p1 + (1-keys) @ log_p0 = keys @ (lp1-lp0) + sum lp0
        # --- one matmul instead of two, chunked so million-user
        # registries (issue_rm) never materialize an [N, K] float temp
        w = log_p1 - log_p0
        base = float(log_p0.sum())
        n = self.keys.shape[0]
        ll = np.empty(n, np.float64)
        for c0 in range(0, n, _DECODE_CHUNK):
            c1 = min(c0 + _DECODE_CHUNK, n)
            ll[c0:c1] = self.keys[c0:c1] @ w
        ll += base
        best, second = _best_two(ll, smaller_is_better=False)
        margin = (
            float(ll[best] - ll[second]) if second >= 0 else float("inf")
        )
        return best, float(ll[best]), margin

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "min_distance": self.min_distance,
                    "names": self.names,
                    "keys": self.keys.tolist(),
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "KeyRegistry":
        with open(path) as f:
            d = json.load(f)
        return cls(
            keys=np.asarray(d["keys"], np.int8),
            names=list(d["names"]),
            min_distance=int(d["min_distance"]),
        )

    def __len__(self) -> int:
        return self.keys.shape[0]


# ---------------------------------------------------------------------- #
# capacity analysis
# ---------------------------------------------------------------------- #
def identification_error_union_bound(
    p_bit: float, n_users: int, key_len: int, min_distance: int
) -> float:
    """Union bound on hard-decision identification error.

    A wrong user is only possible if at least ``ceil(d_min/2)`` of the
    bits flipped (nearest-codeword decoding corrects fewer); with i.i.d.
    per-bit error rate ``p_bit`` (the measured 1 - bit accuracy) the
    probability of >= t flips is a binomial tail, and any of the other
    N-1 codewords could capture the decode.  Conservative (ignores that
    far-apart codewords need far more flips) but closed-form --- the
    Monte-Carlo simulator below gives the tight number.
    """
    if not 0.0 <= p_bit <= 1.0:
        raise ValueError("p_bit must be in [0,1]")
    t = (min_distance + 1) // 2  # flips needed to leave the guarantee
    # P[Binom(key_len, p_bit) >= t]
    k = np.arange(t, key_len + 1)
    from math import comb, exp, log

    if p_bit == 0.0:
        tail = 0.0
    elif p_bit == 1.0:
        tail = 1.0
    else:
        logs = [
            log(comb(key_len, int(i)))
            + int(i) * log(p_bit)
            + (key_len - int(i)) * log(1.0 - p_bit)
            for i in k
        ]
        m = max(logs)
        tail = exp(m) * sum(exp(v - m) for v in logs)
    return float(min(1.0, (n_users - 1) * tail)) if n_users > 1 else 0.0


def simulate_identification(
    registry: KeyRegistry,
    p_bit: float,
    n_trials: int = 2000,
    seed: int = 0,
    confidence: float = 4.0,
) -> dict:
    """Monte-Carlo identification accuracy at a measured per-bit error
    rate, for both decoders.

    Soft decoding draws logits whose sign matches the (possibly flipped)
    hard bit but whose magnitude is smaller for flipped bits --- the
    empirical solver signature (wrong bits converge less confidently;
    see the polish section of BASELINE.md) --- parameterized by
    ``confidence`` (mean |logit| of a correct bit; flipped bits get 1/4
    of it).  Returns accuracies plus the union bound for context.
    """
    rng = np.random.default_rng(seed)
    n, k = registry.keys.shape
    hard_ok = soft_ok = 0
    for _ in range(n_trials):
        true_idx = int(rng.integers(0, n))
        true = registry.keys[true_idx].astype(np.float64)
        flips = rng.random(k) < p_bit
        observed = np.where(flips, 1 - true, true)
        # hard decode on the flipped bits
        hi, _, _ = registry.match_hard(observed.astype(np.int8))
        hard_ok += hi == true_idx
        # soft decode: logit sign from observed bit, magnitude shrunk on flips
        mag = rng.gamma(2.0, confidence / 2.0, k)
        mag = np.where(flips, mag * 0.25, mag)
        logits = (2 * observed - 1) * mag
        si, _, _ = registry.match_soft(logits)
        soft_ok += si == true_idx
    return {
        "n_users": n,
        "key_len": k,
        "min_distance": registry.min_distance,
        "p_bit": p_bit,
        "trials": n_trials,
        "hard_accuracy": hard_ok / n_trials,
        "soft_accuracy": soft_ok / n_trials,
        "union_bound_error": identification_error_union_bound(
            p_bit, n, k, registry.min_distance
        ),
    }
