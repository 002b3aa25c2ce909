"""Sampled structure estimator: first-contact planning without the full
join on the caller's critical path (the port's copy of the JAX package's
`ops/estimate.py`).

An evenly spaced sample of A's distinct tile-rows is joined EXACTLY against
B's sorted row index: the sampled rows' output keys, fanouts and pair counts
are true values, scaled to the population.  ops/spgemm.plan uses it on a
plan-cache miss: a confident estimate returns the plan at once with the
exact join deferred (SpgemmPlan.ensure_exact, which the chain's plan-ahead
worker runs off the dispatch thread, or execute forces), a low-confidence
one takes the exact join inline.  The rounds always come from the exact
join, so the estimator never changes a bit: on and off give the same plans
and bytes.

Off by default in the port (on in the JAX package): every consumer here
forces the exact join before the multiply's first launch, so the deferral
overlaps no device work and the sample's cost lands on the critical path
(chip_smoke.py's [estimate] phase, PERF.md section 6).  A consumer that can
overlap the join with device work (a long-lived server, not ported yet) is
where it can pay.

predicted_route is advisory: the rounds' route comes from the exact join's
fanouts, and ops/spgemm counts a prediction that differs from it as
ENGINE's `est_route_mismatch`.

Host-only, safe on planner threads.  Knobs (utils/knobs.py):
  SPGEMM_TPU_PLAN_ESTIMATE    0|1 (default 0): estimator on or off.
  SPGEMM_TPU_EST_SAMPLE_ROWS  int >= 1 (default 48): rows sampled; a
                              structure with this many rows or fewer is not
                              estimated (the exact join costs the same).
  SPGEMM_TPU_EST_CONFIDENCE   float >= 0 (default 0.5): below it the exact
                              join runs inline.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from spgemm_tpu_torch.ops.symbolic import DENSE_MIN_CLASS, _segment_expand, _shape_class_vec
from spgemm_tpu_torch.utils import knobs

_LOCK = threading.Lock()
_STATS = {"hits": 0, "fallbacks": 0}  # spgemm-lint: guarded-by(_LOCK)


def enabled() -> bool:
    """SPGEMM_TPU_PLAN_ESTIMATE (default 0)."""
    return knobs.get("SPGEMM_TPU_PLAN_ESTIMATE")


def sample_budget() -> int:
    """SPGEMM_TPU_EST_SAMPLE_ROWS (default 48)."""
    return knobs.get("SPGEMM_TPU_EST_SAMPLE_ROWS")


def confidence_threshold() -> float:
    """SPGEMM_TPU_EST_CONFIDENCE (default 0.5)."""
    return knobs.get("SPGEMM_TPU_EST_CONFIDENCE")


def note_hit() -> None:
    with _LOCK:
        _STATS["hits"] += 1


def note_fallback() -> None:
    with _LOCK:
        _STATS["fallbacks"] += 1


def stats() -> dict:
    """Estimator-routed plans and inline fallbacks since the last clear(),
    and the knob values."""
    with _LOCK:
        out = dict(_STATS)
    return {**out, "enabled": enabled(), "sample_rows": sample_budget(),
            "confidence_threshold": confidence_threshold()}


def clear() -> None:
    """Zero the counts."""
    with _LOCK:
        _STATS["hits"] = _STATS["fallbacks"] = 0


def pair_mass(a_coords: np.ndarray, b_coords: np.ndarray) -> float:
    """Predicted tile pairs of one A x B multiply: the sampled estimate
    where the structure is big enough to sample, else the exact count."""
    est = maybe_estimate(a_coords, b_coords)
    if est is not None:
        return float(est.est_pairs)
    if len(a_coords) == 0 or len(b_coords) == 0:
        return 0.0
    b_rows = b_coords[:, 0]
    lo = np.searchsorted(b_rows, a_coords[:, 1], side="left")
    hi = np.searchsorted(b_rows, a_coords[:, 1], side="right")
    return float((hi - lo).sum())


def chain_mass(coords_list: list[np.ndarray]) -> float:
    """Predicted tile pairs of a chain's first reduction pass (pairs (0, 1),
    (2, 3), ...; the odd last operand is carried): where a chain's work
    concentrates, so a price for scheduling it."""
    return sum(pair_mass(coords_list[i], coords_list[i + 1])
               for i in range(0, len(coords_list) - 1, 2))


def predicted_route(est: "StructureEstimate | None") -> str | None:
    """'dense' when a sampled fanout class reaches DENSE_MIN_CLASS, else
    'ladder'; None without an estimate.  Advisory only."""
    if est is None:
        return None
    return "dense" if any(cls >= DENSE_MIN_CLASS for cls in est.class_hist) else "ladder"


@dataclass
class StructureEstimate:
    """A scaled prediction of one A x B output structure from a row sample.

    The sampled rows' figures are exact; population figures are the
    sampled totals times total_rows / sampled_rows.  confidence is 1 minus
    the relative standard error of the sampled per-row pair mass: near 1
    on uniform structures (banded chains), towards 0 under skew."""

    total_rows: int
    sampled_rows: int
    scale: float
    est_keys: float
    est_pairs: float
    est_max_fanout: int
    class_hist: dict = field(default_factory=dict)  # shape class -> est keys
    row_mass: np.ndarray | None = None              # pair counts per sampled row
    skew: float = 0.0                               # coefficient of variation
    confidence: float = 0.0


def maybe_estimate(a_coords: np.ndarray, b_coords: np.ndarray,
                   sample_rows: int | None = None) -> StructureEstimate | None:
    """The estimate of A x B's output structure from a row sample, or None
    where estimation does not apply: an empty operand, or no more distinct
    A rows than the sample budget.  Both coord arrays lex-sorted by (row,
    col).  Deterministic: evenly spaced sample positions."""
    if sample_rows is None:
        sample_rows = sample_budget()
    if len(a_coords) == 0 or len(b_coords) == 0:
        return None
    a_rows = a_coords[:, 0]
    row_vals, row_starts = np.unique(a_rows, return_index=True)
    n_rows = len(row_vals)
    if n_rows <= sample_rows:
        return None
    row_ends = np.append(row_starts[1:], len(a_rows))

    take = np.unique(np.linspace(0, n_rows - 1, num=sample_rows).astype(np.int64))
    n_take = len(take)
    lens = row_ends[take] - row_starts[take]
    blk_seg, blk_off = _segment_expand(lens)  # sample-local row of each block
    blk_idx = np.repeat(row_starts[take], lens) + blk_off

    # the exact join of the sampled rows against B's sorted rows
    cols = a_coords[blk_idx, 1]
    b_rows = b_coords[:, 0]
    b_cols = b_coords[:, 1]
    lo = np.searchsorted(b_rows, cols, side="left")
    hi = np.searchsorted(b_rows, cols, side="right")
    cnt = hi - lo
    # spgemm-lint: fld-proof(integer pair-count total for sizing only; exact int64 addition is order-free, no wrap-then-mod values involved)
    total_pairs = int(cnt.sum())
    row_mass = np.bincount(blk_seg, weights=cnt, minlength=n_take).astype(np.int64)
    scale = n_rows / n_take

    if total_pairs == 0:
        return StructureEstimate(total_rows=n_rows, sampled_rows=n_take, scale=scale,
                                 est_keys=0.0, est_pairs=0.0, est_max_fanout=0,
                                 class_hist={}, row_mass=row_mass, skew=0.0, confidence=1.0)

    pair_seg, pair_off = _segment_expand(cnt)
    b_slot = np.repeat(lo, cnt) + pair_off
    out_r = blk_seg[pair_seg].astype(np.uint64)
    out_c = b_cols[b_slot].astype(np.uint64)
    span = np.uint64(int(b_cols.max()) + 1)
    fused = out_r * span + out_c  # < n_take * span: no wrap
    uniq, fan = np.unique(fused, return_counts=True)
    keys_per_row = np.bincount((uniq // span).astype(np.int64), minlength=n_take)

    classes, cls_counts = np.unique(_shape_class_vec(fan), return_counts=True)
    class_hist = {int(c): float(n * scale) for c, n in zip(classes, cls_counts)}

    mean = float(row_mass.mean())
    std = float(row_mass.std())
    skew = std / mean if mean > 0 else 0.0
    rse = skew / float(np.sqrt(n_take))  # relative standard error of the scaled total
    return StructureEstimate(
        total_rows=n_rows, sampled_rows=n_take, scale=scale,
        # spgemm-lint: fld-proof(integer key total for prediction scaling only; exact int64 addition is order-free, no wrap-then-mod values involved)
        est_keys=float(keys_per_row.sum()) * scale, est_pairs=float(total_pairs) * scale,
        est_max_fanout=int(fan.max()), class_hist=class_hist, row_mass=row_mass,
        skew=skew, confidence=max(0.0, 1.0 - rse))
