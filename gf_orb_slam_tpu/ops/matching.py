"""Batched Hamming-distance data association.

Reference: src/ORBmatcher.cc (2402 LoC of per-keypoint grid-bucketed loops).
Device redesign: all search variants are one dense masked [Nq, Nt] distance
program — XOR + popcount over packed uint32 descriptors, candidate
gating expressed as boolean masks (projection window / pyramid level /
epipolar distance / orientation) instead of grid bucket iteration. At SLAM
sizes (≤2k keypoints) the dense matrix is small; masking costs nothing
compared to the scalar-loop alternative the reference uses.

Thresholds follow the reference: TH_LOW=50, TH_HIGH=100, ratio tests per call
site (ORBmatcher.cc:40-41).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30
BIG = jnp.int32(10_000)


def hamming_matrix(desc_q: jnp.ndarray, desc_t: jnp.ndarray) -> jnp.ndarray:
    """(Nq, 8) × (Nt, 8) uint32 → (Nq, Nt) int32 Hamming distances.

    XLA fuses XOR → popcount → sum over the 8 words into one loop, so the
    (Nq, Nt, 8) intermediate is never written to device memory.
    """
    x = jnp.bitwise_xor(desc_q[:, None, :], desc_t[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


class MatchResult(NamedTuple):
    idx: jnp.ndarray    # (Nq,) int32 — best target index (valid only where matched)
    dist: jnp.ndarray   # (Nq,) int32 — best distance
    matched: jnp.ndarray  # (Nq,) bool


def masked_best2(dist: jnp.ndarray, mask: jnp.ndarray):
    """Per-row best and second-best over a masked distance matrix.

    Returns (best_idx, best_dist, second_dist); masked-out entries = BIG.
    """
    d = jnp.where(mask, dist, BIG)
    best_idx = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, best_idx[:, None], axis=1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(BIG)
    second = jnp.min(d2, axis=1)
    return best_idx.astype(jnp.int32), best, second


def orientation_consistency(
    angle_q: jnp.ndarray, angle_t: jnp.ndarray, matched: jnp.ndarray, idx: jnp.ndarray
) -> jnp.ndarray:
    """Keep only matches whose rotation Δθ falls in the 3 dominant histogram
    bins (ref ORBmatcher::ComputeThreeMaxima + rotHist pattern, cc:2338-2380)."""
    dtheta = angle_q - angle_t[idx]
    dtheta = jnp.mod(dtheta, 2.0 * jnp.pi)
    bins = jnp.clip(
        jnp.round(dtheta * (HISTO_BINS / (2.0 * jnp.pi))).astype(jnp.int32) % HISTO_BINS,
        0,
        HISTO_BINS - 1,
    )
    hist = jnp.zeros((HISTO_BINS,), jnp.int32).at[bins].add(matched.astype(jnp.int32))
    top3 = jax.lax.top_k(hist, 3)[0]
    # Reference rule: drop bins below 10% of the max bin among top-3 slots.
    keep_count = jnp.where(top3 >= jnp.maximum((0.1 * top3[0]).astype(jnp.int32), 1), top3, -1)
    top3_idx = jax.lax.top_k(hist, 3)[1]
    bin_ok = jnp.zeros((HISTO_BINS,), bool)
    for k in range(3):
        bin_ok = bin_ok.at[top3_idx[k]].set(keep_count[k] >= 0)
    return matched & bin_ok[bins]


def mutual_filter(dist: jnp.ndarray, mask: jnp.ndarray, idx: jnp.ndarray, matched: jnp.ndarray):
    """Cross-check: query q's best target t must have q as its best query."""
    d = jnp.where(mask, dist, BIG)
    best_q_for_t = jnp.argmin(d, axis=0)  # (Nt,)
    return matched & (best_q_for_t[idx] == jnp.arange(dist.shape[0]))


def match(
    desc_q: jnp.ndarray,
    desc_t: jnp.ndarray,
    mask: jnp.ndarray,
    max_dist: int = TH_LOW,
    ratio: float = 1.0,
    angle_q: jnp.ndarray | None = None,
    angle_t: jnp.ndarray | None = None,
    mutual: bool = False,
) -> MatchResult:
    """The one matching kernel. `mask[q, t]` gates candidate pairs; every
    reference search variant is a different mask (see builders below)."""
    dist = hamming_matrix(desc_q, desc_t)
    idx, best, second = masked_best2(dist, mask)
    matched = best <= max_dist
    if ratio < 1.0:
        matched = matched & (best.astype(jnp.float32) <= ratio * second.astype(jnp.float32))
    if mutual:
        matched = mutual_filter(dist, mask, idx, matched)
    if angle_q is not None and angle_t is not None:
        matched = orientation_consistency(angle_q, angle_t, matched, idx)
    return MatchResult(idx=idx, dist=best, matched=matched)


# ---------------------------------------------------------------------------
# Mask builders — each reproduces one reference search variant's gate.
# ---------------------------------------------------------------------------


def window_mask(
    uv_q: jnp.ndarray,
    uv_t: jnp.ndarray,
    radius: jnp.ndarray | float,
    valid_q: jnp.ndarray,
    valid_t: jnp.ndarray,
) -> jnp.ndarray:
    """|Δu|,|Δv| ≤ radius box gate (SearchForInitialization, cc:1172; radius
    may be per-query (Nq,) or scalar)."""
    r = jnp.asarray(radius, jnp.float32)
    r = r[:, None] if r.ndim == 1 else r
    du = jnp.abs(uv_q[:, None, 0] - uv_t[None, :, 0])
    dv = jnp.abs(uv_q[:, None, 1] - uv_t[None, :, 1])
    return (du <= r) & (dv <= r) & valid_q[:, None] & valid_t[None, :]


def octave_mask(
    octave_q_lo: jnp.ndarray, octave_q_hi: jnp.ndarray, octave_t: jnp.ndarray
) -> jnp.ndarray:
    """Scale-consistency gate: target keypoint octave within [lo, hi] of the
    query's predicted octave (SearchByProjection's nPredictedLevel window)."""
    return (octave_t[None, :] >= octave_q_lo[:, None]) & (
        octave_t[None, :] <= octave_q_hi[:, None]
    )


def projection_mask(
    uv_proj: jnp.ndarray,
    valid_proj: jnp.ndarray,
    kp_uv: jnp.ndarray,
    kp_octave: jnp.ndarray,
    kp_valid: jnp.ndarray,
    radius_per_q: jnp.ndarray,
    pred_octave: jnp.ndarray,
    octave_window: tuple[int, int] = (-1, 1),
) -> jnp.ndarray:
    """Map-point → frame projection gate (SearchByProjection cc:384-542):
    radius scaled by predicted octave, target octave within window."""
    base = window_mask(uv_proj, kp_uv, radius_per_q, valid_proj, kp_valid)
    lo = pred_octave + octave_window[0]
    hi = pred_octave + octave_window[1]
    return base & octave_mask(lo, hi, kp_octave)


def epipolar_mask(
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    F12: jnp.ndarray,
    sigma2_t: jnp.ndarray,
    valid_q: jnp.ndarray,
    valid_t: jnp.ndarray,
    thresh_chi2: float = 3.84,
) -> jnp.ndarray:
    """Epipolar-line distance gate for triangulation search
    (CheckDistEpipolarLine, ORBmatcher.cc:16-36 + SearchForTriangulation)."""
    ones = jnp.ones_like(uv1[:, :1])
    x1 = jnp.concatenate([uv1, ones], axis=-1)  # (Nq, 3)
    lines = x1 @ F12.T  # (Nq, 3): epipolar lines in image 2
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    d = a * uv2[None, :, 0] + b * uv2[None, :, 1] + c  # (Nq, Nt)
    dsq = (d * d) / jnp.maximum(a * a + b * b, 1e-12)
    return (dsq < thresh_chi2 * sigma2_t[None, :]) & valid_q[:, None] & valid_t[None, :]
