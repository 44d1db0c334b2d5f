"""Cost model: scores (reorder, cluster-format) candidates per matrix.

Two layers, as in the JAX package:

* **Heuristic priors** — closed-form predictions of relative SpGEMM time
  and preprocessing cost from :class:`~repro_torch.planner.features.
  MatrixFeatures`, in units of *one identity-order row-wise SpGEMM* on the
  same matrix. Heuristic gains carry an uncertainty discount (they gate
  measurement, they do not replace it).
* **Measured overrides** — :meth:`CostModel.observe` ingests real
  (kernel_s, preprocess_s) measurements keyed by (fingerprint,
  candidate); once a fingerprint has a measured identity baseline,
  measured candidates are scored exactly (no discount).

The amortization rule is the paper's break-even logic: a candidate is
worth its preprocessing iff ``reuse_count × spgemm_gain > preprocess_cost``,
so single-shot calls (``reuse_hint=1``) keep ``original + rowwise``.

The ``pallas`` scheme (the hand-written Sp×Sp kernel tier) keys on the
planner's device: on the CPU it carries the JAX package's off-TPU
interpret penalty, so CPU plans match the JAX package's; on a card an
unmeasured ``pallas`` candidate is priced by the JAX package's
on-accelerator traffic model, term for term — the bytes of B and A the
tiled kernels move per B nonzero against the gather tier's, from the
formats' own byte counts — and a cold plan takes the kernels where that
price wins. The model charges whole tiles ÷ fill, while the card's
kernels read only A's live slab columns' B rows, so it prices them far
above what they measure; measured mode corrects it per pattern. The
TPU's shard-efficiency constant is left out.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.planner.features import MatrixFeatures

__all__ = ["Candidate", "ScoredCandidate", "Measurement", "CostModel",
           "DEFAULT_CANDIDATES", "IDENTITY", "break_even_reuse",
           "amortizes", "SCHEMES", "batch_break_even",
           "BATCH_DISPATCH_REL", "BATCH_PACK_REL"]

SCHEMES = ("rowwise", "fixed", "variable", "hierarchical", "pallas")

# heuristic uncertainty: only this fraction of a *predicted* gain is
# trusted when deciding whether preprocessing can amortize
HEURISTIC_GAIN_TRUST = 0.5

# the kernel tier on the CPU runs the plain version, far slower than the
# gather tier: the heuristic must never pick it there (the JAX package's
# off-TPU interpret penalty, kept so CPU plans match)
PALLAS_INTERPRET_REL = 50.0

# -- the kernel tier's traffic prior on the card: byte counts of the
# port's formats (the JAX package's terms, which describe the same
# formats, not the TPU) ------------------------------------------------------
# the gather tier moves ~10.4 B of B per A nonzero: an int32 column index
# plus an fp32 value (8 B) per gathered element, × ~1.3 for the binned
# passes' power-of-two width padding, re-fetched per nonzero
PALLAS_GATHER_BYTES = 10.4
# the tiled kernels' B term: the TiledCSR store's dense fp32 live tiles,
# 4 B per slot and no index, read once — ÷ the live tiles' fill gives
# bytes per B nonzero (a bf16 tile store would move 2 B; the served path
# packs fp32 tiles)
PALLAS_B_BYTES_PER_SLOT = 4.0
# A-refetch term: the BCC slabs, 4 B per fp32 slot, one slab read per
# stream step — ÷ the slab fill per A nonzero. The port's default slab is
# block_r × block_k = 8 × 128 (bcc_from_host), 16× smaller than the
# 128 × 128 tile tile128_fill measures, so it runs denser by about
# √16 = 4 — the JAX package's geometry and boost
PALLAS_A_BYTES_PER_SLOT = 4.0
PALLAS_SLAB_FILL_BOOST = 4.0
# dead-step term: the live-pair stream's only dead steps are the
# per-block zero-slot sentinels and tail pads, a small constant next to
# one gather-tier call
PALLAS_DEAD_STEP_REL = 0.01

# -- cross-request batching break-even (the JAX package's constants, in
# units of one identity-order row-wise SpGEMM on one member) ---------------
# the fixed per-launch cost of a sub-threshold request (dispatch, argument
# staging, result readback)
BATCH_DISPATCH_REL = 1.0
# per-member block-diagonal packing: one concatenate per CSR array plus
# the column-offset shift
BATCH_PACK_REL = 0.15


def batch_break_even(members: int, *,
                     dispatch_rel: float = BATCH_DISPATCH_REL,
                     pack_rel: float = BATCH_PACK_REL) -> bool:
    """Whether one block-diagonal launch beats ``members`` single launches.

    ``members`` singles pay ``members × dispatch``; the batch pays one
    dispatch plus per-member packing (the kernel work is the same — the
    packed product's diagonal blocks are the member products), so
    batching amortizes iff ``dispatch × (members − 1) > members × pack``.

    >>> batch_break_even(1)
    False
    >>> batch_break_even(2)
    True
    """
    if members < 2:
        return False
    return dispatch_rel * (members - 1) > members * pack_rel


def _pallas_core_count() -> int:
    """Shards the sharded pair-stream kernel would split a product into
    (tests monkeypatch this to model a sharded default)."""
    from repro_torch.kernels.ops import pallas_shard_count
    return pallas_shard_count()


def _pallas_compact_ok(ncols: int) -> bool:
    """Whether the live-pair (shardable) grid applies to an A² product on
    a matrix this wide: wider B runs on the padded per-tile grid, which is
    not sharded."""
    from repro_torch.kernels.ops import compact_grid_ok_ncols
    return compact_grid_ok_ncols(ncols)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the method menu: a row reordering × a compute scheme.

    >>> Candidate("rcm", "fixed").key
    'rcm+fixed'
    >>> Candidate("rcm", "banded")
    Traceback (most recent call last):
        ...
    ValueError: unknown scheme 'banded'
    """

    reorder: str          # name in repro_torch.core.reorder.REORDERINGS
    scheme: str           # one of SCHEMES

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme '{self.scheme}'")

    @property
    def key(self) -> str:
        return f"{self.reorder}+{self.scheme}"


IDENTITY = Candidate("original", "rowwise")

# the serving menu: identity always first; hierarchical only unreordered
# (it computes its own permutation); pallas is the BCC × TiledCSR kernel
DEFAULT_CANDIDATES: tuple[Candidate, ...] = (
    IDENTITY,
    Candidate("rcm", "rowwise"),
    Candidate("gp", "rowwise"),
    Candidate("degree", "rowwise"),
    Candidate("gray", "rowwise"),
    Candidate("original", "fixed"),
    Candidate("rcm", "fixed"),
    Candidate("degree", "fixed"),
    Candidate("original", "variable"),
    Candidate("rcm", "variable"),
    Candidate("original", "hierarchical"),
    Candidate("original", "pallas"),
    Candidate("rcm", "pallas"),
)

# -- priors (host preprocessing costs and reorder strengths, in units of
# one row-wise SpGEMM; carried from the JAX package so both rank alike) ---
_REORDER_PRE = {
    "original": 0.0, "random": 0.05, "gray": 0.08, "degree": 0.08,
    "rcm": 0.4, "amd": 0.5, "rabbit": 1.0, "slashburn": 1.5,
    "nd": 4.0, "gp": 4.0, "hp": 8.0,
}
_SCHEME_PRE = {"rowwise": 0.0, "fixed": 0.15, "variable": 0.8,
               "hierarchical": 0.2, "pallas": 0.3}
_REORDER_STRENGTH = {
    "original": 0.0, "random": -0.1, "gray": 0.15, "degree": 0.2,
    "rcm": 0.35, "amd": 0.3, "rabbit": 0.3, "slashburn": 0.2,
    "nd": 0.35, "gp": 0.4, "hp": 0.4,
}


@dataclasses.dataclass(frozen=True)
class Measurement:
    kernel_s: float
    preprocess_s: float


@dataclasses.dataclass(frozen=True)
class ScoredCandidate:
    """A candidate with its predicted economics at a given reuse count.

    ``kernel_rel`` / ``preprocess_rel`` are relative to the identity
    row-wise SpGEMM time of the same matrix; ``total_rel`` is the full
    amortized bill ``preprocess_rel + reuse × kernel_rel``.

    >>> s = ScoredCandidate(Candidate("rcm", "fixed"), kernel_rel=0.8,
    ...                     preprocess_rel=1.0, reuse=10, measured=True)
    >>> s.total_rel, round(s.gain_rel, 3), s.amortizes
    (9.0, 0.2, True)
    >>> round(s.break_even, 6)
    5.0
    """

    candidate: Candidate
    kernel_rel: float
    preprocess_rel: float
    reuse: int
    measured: bool

    @property
    def total_rel(self) -> float:
        return self.preprocess_rel + self.reuse * self.kernel_rel

    @property
    def gain_rel(self) -> float:
        """Per-call saving vs identity (may be negative)."""
        return 1.0 - self.kernel_rel

    @property
    def trusted_gain(self) -> float:
        return self.gain_rel * (1.0 if self.measured
                                else HEURISTIC_GAIN_TRUST)

    @property
    def amortizes(self) -> bool:
        # a single-shot call never speculates on unmeasured preprocessing
        if (not self.measured and self.reuse <= 1
                and self.preprocess_rel > 0.0):
            return False
        return amortizes(self.reuse, self.trusted_gain, self.preprocess_rel)

    @property
    def break_even(self) -> float:
        return break_even_reuse(self.trusted_gain, self.preprocess_rel)


def amortizes(reuse: int, gain_per_call: float, preprocess: float) -> bool:
    """Paper break-even: does ``reuse`` calls' saving cover preprocessing?

    >>> amortizes(10, 0.2, 1.5)          # 10 × 0.2 > 1.5
    True
    >>> amortizes(1, 0.2, 1.5)           # single-shot: never pays
    False
    >>> amortizes(1, 0.0, 0.0)           # identity: free by convention
    True
    """
    if preprocess <= 0.0:
        return True
    return reuse * gain_per_call > preprocess


def break_even_reuse(gain_per_call: float, preprocess: float) -> float:
    """Number of calls after which preprocessing has paid for itself.

    >>> break_even_reuse(0.2, 1.5)
    7.5
    >>> break_even_reuse(0.0, 1.0)       # no gain: never pays
    inf
    >>> break_even_reuse(0.5, 0.0)       # nothing to pay off
    0.0
    """
    if preprocess <= 0.0:
        return 0.0
    if gain_per_call <= 0.0:
        return math.inf
    return preprocess / gain_per_call


class CostModel:
    """Heuristic-plus-measured candidate scoring (see module docstring).

    ``device`` is where the planned products run: it decides what an
    unmeasured ``pallas`` candidate scores (it is not touched otherwise,
    so a model for ``"cuda"`` can be built without a card).

    ``calibration`` — an optional
    :class:`~repro_torch.planner.calibration.Calibration`: least-squares
    fitted corrections applied on top of the heuristic constants. ``None``
    keeps the hand-tuned values; measured overrides always win either way.
    """

    def __init__(self, device="cuda", calibration=None):
        self.device_type = torch.device(device).type
        self.calibration = calibration
        # (fingerprint, candidate.key) -> Measurement
        self._measured: dict[tuple[str, str], Measurement] = {}

    # -- measured layer ------------------------------------------------------

    def observe(self, fingerprint: str, candidate: Candidate,
                kernel_s: float, preprocess_s: float) -> None:
        """Record a real (kernel, preprocess) timing for a candidate.

        >>> m = CostModel()
        >>> m.observe("fp0", IDENTITY, kernel_s=2.0, preprocess_s=0.0)
        >>> m.measurement("fp0", IDENTITY).kernel_s
        2.0
        >>> m.measurement("fp0", Candidate("rcm", "fixed")) is None
        True
        """
        self._measured[(fingerprint, candidate.key)] = Measurement(
            kernel_s=float(kernel_s), preprocess_s=float(preprocess_s))

    def measurement(self, fingerprint: str,
                    candidate: Candidate) -> Measurement | None:
        return self._measured.get((fingerprint, candidate.key))

    def _base_kernel_s(self, fingerprint: str | None) -> float | None:
        if fingerprint is None:
            return None
        m = self._measured.get((fingerprint, IDENTITY.key))
        return m.kernel_s if m and m.kernel_s > 0 else None

    # -- heuristic layer -----------------------------------------------------

    def _heuristic(self, f: MatrixFeatures, c: Candidate,
                   workload: str = "a2") -> tuple[float, float]:
        """(kernel_rel, preprocess_rel) from structural features alone.

        ``workload`` matters only to an unmeasured ``pallas`` candidate on
        the card: a product the serving path would shard (``a2``,
        ``chain`` or a block-diagonal ``batch`` pack on the live-pair
        grid) divides its traffic terms by the shard count, as the JAX
        package's per-core term does (without that package's TPU
        shard-efficiency constant). With one shard —
        :func:`~repro_torch.kernels.ops.pallas_shard_count` — nothing
        changes."""
        # disorder: how far the current order is from a banded layout —
        # a random symmetric permutation lands at bandwidth_mean ≈ 1/3
        disorder = min(3.0 * f.bandwidth_mean, 1.0)
        # skew discounts mesh-style reorderings (RCM/ND assume bounded
        # degree), boosts degree/gray
        skew = min(f.row_gini, 1.0)
        local = f.consec_jaccard
        latent = f.similar_frac * f.similar_mean
        # reordering only recovers locality that exists — ER-style
        # patterns gain nothing from any permutation
        structure = min(2.0 * (latent + local), 1.0)
        strength = _REORDER_STRENGTH.get(c.reorder, 0.2)
        if c.reorder in ("rcm", "amd", "nd", "gp", "hp"):
            strength *= (1.0 - 0.5 * skew)
        elif c.reorder in ("degree", "gray", "slashburn"):
            strength *= (0.5 + skew)
        reorder_gain = strength * disorder * structure
        kernel_rel = max(1.0 - reorder_gain, 0.2)

        # clusterability: as-ordered locality, or pattern-level similarity
        # for schemes that get a reorder first / find their own mates
        conv = 0.4 + 0.3 * skew
        if c.scheme in ("fixed", "variable"):
            q = local if c.reorder == "original" else max(local, conv * latent)
            if c.reorder in ("degree", "gray"):
                q = max(q, 0.5 * skew)
            if c.scheme == "fixed":
                kernel_rel *= max(1.1 - 0.9 * q, 0.15)
            else:
                kernel_rel *= max(1.08 - 0.85 * q, 0.15)
        elif c.scheme == "hierarchical":
            eff = latent * (1.0 - 0.6 * min(f.row_cv / 1.5, 1.0))
            kernel_rel *= max(1.1 - 1.0 * eff, 0.15)
        elif c.scheme == "pallas":
            if self.device_type == "cpu":
                kernel_rel = PALLAS_INTERPRET_REL
            else:
                # traffic per B nonzero relative to the gather tier (both
                # bound by memory): B's live tiles read once ÷ their fill
                # (reordering densifies the lattice by at most the
                # recovered-locality factor), one A slab per stream step
                # ÷ the slab fill, and the residual dead steps
                fill = max(f.tile128_fill, 1e-4)
                fill_eff = min(fill * (1.0 + 2.0 * reorder_gain), 1.0)
                slab_fill = min(fill_eff * PALLAS_SLAB_FILL_BOOST, 1.0)
                b_term = PALLAS_B_BYTES_PER_SLOT / fill_eff
                a_term = PALLAS_A_BYTES_PER_SLOT / slab_fill
                kernel_rel = ((b_term + a_term) / PALLAS_GATHER_BYTES
                              + PALLAS_DEAD_STEP_REL)
                # the sharded kernel splits the live-pair stream across
                # shards; the padded grid (wide B) and the dense-B SpMM
                # path are not sharded
                cores = (max(_pallas_core_count(), 1)
                         if workload in ("a2", "chain", "batch")
                         and _pallas_compact_ok(f.ncols) else 1)
                kernel_rel /= cores
                kernel_rel = min(max(kernel_rel, 0.15 / cores),
                                 PALLAS_INTERPRET_REL)

        pre = _REORDER_PRE.get(c.reorder, 1.0) + _SCHEME_PRE[c.scheme]
        if c.scheme == "hierarchical":
            # candidate-pair volume drives the heap
            pre += f.similar_frac
        return kernel_rel, pre

    # -- public API ----------------------------------------------------------

    def score(self, features: MatrixFeatures, candidate: Candidate,
              reuse: int, fingerprint: str | None = None,
              workload: str = "a2") -> ScoredCandidate:
        base = self._base_kernel_s(fingerprint)
        m = (self._measured.get((fingerprint, candidate.key))
             if fingerprint is not None else None)
        if m is not None and base is not None:
            return ScoredCandidate(
                candidate=candidate, kernel_rel=m.kernel_s / base,
                preprocess_rel=m.preprocess_s / base, reuse=reuse,
                measured=True)
        kernel_rel, pre = self._heuristic(features, candidate, workload)
        cal = self.calibration
        if cal is not None:
            # fitted slope per scheme (rowwise-normalized so identity
            # keeps kernel_rel == 1); the kernel tier's CPU penalty is a
            # routing gate, not a prediction — never rescaled
            if kernel_rel < PALLAS_INTERPRET_REL:
                kernel_rel *= cal.kernel_scale.get(candidate.scheme, 1.0)
            pre_r = cal.preprocess_reorder.get(candidate.reorder)
            pre_s = cal.preprocess_scheme.get(candidate.scheme)
            if pre_r is not None or pre_s is not None:
                pre = ((pre_r if pre_r is not None
                        else _REORDER_PRE.get(candidate.reorder, 1.0))
                       + (pre_s if pre_s is not None
                          else _SCHEME_PRE[candidate.scheme]))
                if candidate.scheme == "hierarchical":
                    pre += features.similar_frac
        return ScoredCandidate(candidate=candidate, kernel_rel=kernel_rel,
                               preprocess_rel=pre, reuse=reuse,
                               measured=False)

    def rank(self, features: MatrixFeatures, reuse: int,
             candidates=DEFAULT_CANDIDATES,
             fingerprint: str | None = None,
             workload: str = "a2") -> list[ScoredCandidate]:
        """Score all candidates; amortizing ones first, by total cost.

        Non-amortizing candidates sort after every amortizing one (they
        are kept — a measurement pass may still probe them) but can never
        be chosen by the planner.
        """
        reuse = max(int(reuse), 1)
        scored = [self.score(features, c, reuse, fingerprint, workload)
                  for c in candidates]
        return sorted(scored,
                      key=lambda s: (not s.amortizes, s.total_rel,
                                     s.candidate.key))

    def choose(self, features: MatrixFeatures, reuse: int,
               candidates=DEFAULT_CANDIDATES,
               fingerprint: str | None = None,
               workload: str = "a2") -> ScoredCandidate:
        """Best amortizing candidate (identity always amortizes, so the
        result is never worse than identity *under the model*)."""
        for s in self.rank(features, reuse, candidates, fingerprint,
                           workload):
            if s.amortizes:
                return s
        return self.score(features, IDENTITY, reuse, fingerprint, workload)
