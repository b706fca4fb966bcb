"""FAST-9/16 corner detection as a dense whole-image vector program.

Reference: the per-cell cv::FAST calls in ORBextractor::ComputeKeyPoints
(src/ORBextractor.cc:535-758). The scalar-loop + early-exit structure of
classic FAST is hostile to SIMD hardware; instead we compute the exact FAST-9
corner *score* (the maximum threshold at which a pixel remains a corner) for
every pixel at once with a log-depth min/roll reduction over the 16-point
Bresenham circle, then 3×3 non-max suppression, then spatially-stratified
top-k selection that reproduces the reference's grid-cell quota +
redistribution behavior with static shapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3, OpenCV ordering (dy, dx), index 0 at 12 o'clock.
CIRCLE_OFFSETS = np.asarray(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9


def fast_score(img: jnp.ndarray) -> jnp.ndarray:
    """Dense FAST-9 corner score for every pixel.

    score(p) = max over the 32 (bright/dark × 16 windows) arcs of the minimum
    margin within a 9-long contiguous arc; > t means p is a FAST-9 corner at
    threshold t. Exactly OpenCV's definition of the FAST score, computed
    branch-free for all pixels simultaneously.
    """
    x = img.astype(jnp.float32)
    # d[k] = circle_k - center, via rolls (border pixels wrap; masked later).
    diffs = jnp.stack(
        [jnp.roll(x, (-int(dy), -int(dx)), axis=(0, 1)) - x for dy, dx in CIRCLE_OFFSETS],
        axis=0,
    )  # (16, H, W)

    def arc_min(m):
        # min over all 9-long cyclic windows, per window-start r: log-depth
        # doubling: 9 = 4 + 4 + 1.
        m2 = jnp.minimum(m, jnp.roll(m, -1, axis=0))
        m4 = jnp.minimum(m2, jnp.roll(m2, -2, axis=0))
        m8 = jnp.minimum(m4, jnp.roll(m4, -4, axis=0))
        m9 = jnp.minimum(m8, jnp.roll(m, -8, axis=0))
        return jnp.max(m9, axis=0)  # best window start

    score_bright = arc_min(diffs)      # arcs where circle ≫ center
    score_dark = arc_min(-diffs)       # arcs where circle ≪ center
    score = jnp.maximum(score_bright, score_dark)

    # Invalidate the 3-pixel wrap border.
    h, w = x.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    border = (yy < 3) | (yy >= h - 3) | (xx < 3) | (xx >= w - 3)
    return jnp.where(border, 0.0, score)


def nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3×3 non-max suppression: keep a pixel only if it is the strict max of
    its neighborhood (ties broken towards top-left, like KeyPointsFilter)."""
    neigh = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= neigh, score, 0.0)


@partial(jax.jit, static_argnames=("n_keep", "grid", "cell_cap", "threshold", "min_threshold"))
def detect_keypoints(
    img: jnp.ndarray,
    n_keep: int,
    threshold: float = 20.0,
    min_threshold: float = 7.0,
    grid: int = 8,
    cell_cap: int = 0,
):
    """Detect up to n_keep FAST corners with spatial stratification.

    Replicates the reference's two-tier behavior (src/ORBextractor.cc:620-721):
    cells prefer corners above `threshold`, fall back to `min_threshold` where
    a cell has none, and unused per-cell quota is redistributed globally by
    score. Returns (xy (n_keep,2) float32 [x,y], resp (n_keep,), valid bool).
    """
    if cell_cap <= 0:
        cell_cap = max(4 * n_keep // (grid * grid), 8)

    score = nms3(fast_score(img))
    h, w = score.shape
    ch, cw = -(-h // grid), -(-w // grid)  # ceil cell size
    pad_h, pad_w = ch * grid - h, cw * grid - w
    sp = jnp.pad(score, ((0, pad_h), (0, pad_w)))

    # (grid, ch, grid, cw) → (grid*grid, ch*cw)
    cells = sp.reshape(grid, ch, grid, cw).transpose(0, 2, 1, 3).reshape(grid * grid, ch * cw)

    # Rank within each cell: corners ≥ threshold beat corners ≥ min_threshold
    # beat everything (which is dropped). A large additive bonus implements the
    # two-tier preference inside one top_k.
    strong = cells >= threshold
    weak = cells >= min_threshold
    rank = jnp.where(strong, cells + 1e6, jnp.where(weak, cells + 1e3, -1.0))
    # approx_max_k: a partial sort where the backend has one (elsewhere it is
    # exact top_k); 95% recall on corner candidates is harmless — the
    # per-cell cap already has 4× slack over the final quota.
    top_vals, top_idx = jax.lax.approx_max_k(rank, cell_cap, recall_target=0.95)
    top_idx = top_idx.astype(jnp.int32)

    # Recover global pixel coordinates of per-cell winners.
    cell_ids = jax.lax.broadcasted_iota(jnp.int32, (grid * grid, cell_cap), 0)
    gy, gx = cell_ids // grid, cell_ids % grid
    ly, lx = top_idx // cw, top_idx % cw
    ys, xs = gy * ch + ly, gx * cw + lx

    flat_rank = top_vals.reshape(-1)
    flat_y = ys.reshape(-1)
    flat_x = xs.reshape(-1)

    # Global redistribution: overall top-n_keep among the per-cell-capped pool.
    # The per-cell cap bounds density; the two-tier bonus keeps weak-only cells
    # represented when strong corners are scarce — same net behavior as the
    # reference's quota redistribution loop.
    best, pick = jax.lax.approx_max_k(flat_rank, n_keep, recall_target=0.95)
    pick = pick.astype(jnp.int32)
    valid = best > 0.0
    resp = jnp.where(best >= 1e6, best - 1e6, jnp.where(best >= 1e3, best - 1e3, 0.0))
    xy = jnp.stack([flat_x[pick].astype(jnp.float32), flat_y[pick].astype(jnp.float32)], axis=-1)
    return xy, resp, valid
