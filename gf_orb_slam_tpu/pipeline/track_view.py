"""Compact per-keyframe tracking view of the map.

The reference recomputes the covisibility-local map every frame
(Tracking::UpdateReference, cc:3689-3853). On the device that meant (K, P) incidence
ops and P=16k-point frustum/Jacobian math per frame — but the local map only
changes meaningfully at keyframe rate. This module snapshots a compact view
(candidate ids + gathered attributes, fixed capacity) when a keyframe is
inserted / relocalized / loop-corrected; the per-frame fused tracker then
works on ~4k candidates instead of the full point table, and the per-frame
program no longer takes any (K, ·) arrays at all.

Point POSITIONS are still read through the global table at track time (the
mapper refines them between keyframes); the view holds ids + slowly-changing
attributes (descriptors, normals, scale ranges).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam_tpu.mapping import map_state as ms


class TrackView(NamedTuple):
    ids: jnp.ndarray       # (V,) int32 global point ids (P = invalid padding)
    valid: jnp.ndarray     # (V,) bool
    desc: jnp.ndarray      # (V, 8) uint32
    normal: jnp.ndarray    # (V, 3)
    min_dist: jnp.ndarray  # (V,)
    max_dist: jnp.ndarray  # (V,)

    @property
    def capacity(self) -> int:
        return self.ids.shape[0]


@partial(jax.jit, static_argnames=("view_size", "n_neighbor_kfs"))
def compute_track_view(
    m: ms.MapState,
    center_kf: jnp.ndarray,
    view_size: int = 4096,
    n_neighbor_kfs: int = 12,
) -> TrackView:
    """Candidates = points observed by the center keyframe's top covisible
    neighbors (plus itself), capped at view_size (lowest ids first)."""
    P = m.pt_capacity
    W = ms.covisibility(m)
    w_row = W[center_kf].at[center_kf].set(jnp.int32(1 << 30))
    _, kf_ids = jax.lax.top_k(w_row, n_neighbor_kfs)
    member = jnp.zeros((P,), bool)
    for i in range(n_neighbor_kfs):
        obs = m.kf_obs_point[kf_ids[i]]
        ok = (obs >= 0) & m.kf_valid[kf_ids[i]] & ((W[center_kf][kf_ids[i]] > 0) | (kf_ids[i] == center_kf))
        member = member.at[jnp.where(ok, obs, P)].set(True, mode="drop")
    member = member & m.pt_valid

    order = jnp.where(member, jnp.arange(P, dtype=jnp.int32), P)
    # top_k of the negated ids → the view_size smallest member ids.
    ids = -jax.lax.top_k(-order, view_size)[0]
    valid = ids < P
    safe = jnp.minimum(ids, P - 1)
    return TrackView(
        ids=jnp.where(valid, ids, P).astype(jnp.int32),
        valid=valid,
        desc=m.pt_desc[safe],
        normal=m.pt_normal[safe],
        min_dist=m.pt_min_dist[safe],
        max_dist=m.pt_max_dist[safe],
    )


def empty_view(view_size: int, pt_capacity: int) -> TrackView:
    return TrackView(
        ids=jnp.full((view_size,), pt_capacity, jnp.int32),
        valid=jnp.zeros((view_size,), bool),
        desc=jnp.zeros((view_size, 8), jnp.uint32),
        normal=jnp.zeros((view_size, 3), jnp.float32),
        min_dist=jnp.zeros((view_size,), jnp.float32),
        max_dist=jnp.full((view_size,), jnp.inf, jnp.float32),
    )
