"""The SLAM map as struct-of-arrays device state.

Replaces the reference's pointer-graph map model (include/KeyFrame.h,
MapPoint.h, Map.h): KeyFrame*/MapPoint* objects with per-object mutexes become
fixed-capacity parallel arrays with validity masks, and the covisibility
graph becomes an incidence matmul. All update functions are pure
(state → state) so the three SLAM stages can hand off versioned snapshots
instead of locking shared memory.

Design invariants:
* `kf_obs_point[k, i]` is the single source of truth for data association:
  the map-point id observed by keypoint slot i of keyframe k (−1 = none).
  Point observation lists, covisibility weights, and BA edge sets all derive
  from it by gathers/matmuls.
* Tombstoning matches the reference (`SetBadFlag` semantics, MapPoint.h:151):
  deleted entities get valid=False and ids are never reused within a session
  unless capacity forces it (free-slot scan picks invalid slots first).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

NO_POINT = -1


class MapState(NamedTuple):
    # --- keyframes (capacity K, keypoints-per-frame capacity N) ---
    kf_pose: jnp.ndarray       # (K, 7) T_cw pose vectors
    kf_valid: jnp.ndarray      # (K,) bool
    kf_frame_id: jnp.ndarray   # (K,) int32 — source frame id (tracking time)
    kf_timestamp: jnp.ndarray  # (K,) float32
    kf_kp_uv: jnp.ndarray      # (K, N, 2) float32 undistorted pixels
    kf_kp_octave: jnp.ndarray  # (K, N) int32
    kf_kp_angle: jnp.ndarray   # (K, N) float32
    kf_kp_desc: jnp.ndarray    # (K, N, 8) uint32
    kf_kp_valid: jnp.ndarray   # (K, N) bool
    kf_obs_point: jnp.ndarray  # (K, N) int32 — map-point id or NO_POINT

    # --- map points (capacity P) ---
    pt_pos: jnp.ndarray        # (P, 3) float32 world positions
    pt_valid: jnp.ndarray      # (P,) bool
    pt_desc: jnp.ndarray       # (P, 8) uint32 distinctive descriptor
    pt_normal: jnp.ndarray     # (P, 3) float32 mean viewing direction
    pt_min_dist: jnp.ndarray   # (P,) float32 scale-invariance range low
    pt_max_dist: jnp.ndarray   # (P,) float32 scale-invariance range high
    pt_visible: jnp.ndarray    # (P,) int32 — times predicted visible
    pt_found: jnp.ndarray      # (P,) int32 — times actually matched
    pt_first_kf: jnp.ndarray   # (P,) int32 — creating keyframe
    pt_first_frame: jnp.ndarray  # (P,) int32 — creating frame id

    # --- counters ---
    n_kf: jnp.ndarray          # () int32 — next keyframe slot
    n_pt: jnp.ndarray          # () int32 — high-water mark of point slots

    @property
    def kf_capacity(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def pt_capacity(self) -> int:
        return self.pt_pos.shape[0]

    @property
    def kp_capacity(self) -> int:
        return self.kf_kp_uv.shape[1]


def empty_map(
    max_keyframes: int = 256, max_points: int = 16384, max_kps: int = 1024,
    dtype=jnp.float32,
) -> MapState:
    K, P, N = max_keyframes, max_points, max_kps
    return MapState(
        kf_pose=jnp.zeros((K, 7), dtype).at[:, 0].set(1.0),
        kf_valid=jnp.zeros(K, bool),
        kf_frame_id=jnp.full(K, -1, jnp.int32),
        kf_timestamp=jnp.zeros(K, dtype),
        kf_kp_uv=jnp.zeros((K, N, 2), dtype),
        kf_kp_octave=jnp.zeros((K, N), jnp.int32),
        kf_kp_angle=jnp.zeros((K, N), dtype),
        kf_kp_desc=jnp.zeros((K, N, 8), jnp.uint32),
        kf_kp_valid=jnp.zeros((K, N), bool),
        kf_obs_point=jnp.full((K, N), NO_POINT, jnp.int32),
        pt_pos=jnp.zeros((P, 3), dtype),
        pt_valid=jnp.zeros(P, bool),
        pt_desc=jnp.zeros((P, 8), jnp.uint32),
        pt_normal=jnp.zeros((P, 3), dtype),
        pt_min_dist=jnp.zeros(P, dtype),
        pt_max_dist=jnp.full(P, jnp.inf, dtype),
        pt_visible=jnp.ones(P, jnp.int32),
        pt_found=jnp.ones(P, jnp.int32),
        pt_first_kf=jnp.full(P, -1, jnp.int32),
        pt_first_frame=jnp.full(P, -1, jnp.int32),
        n_kf=jnp.asarray(0, jnp.int32),
        n_pt=jnp.asarray(0, jnp.int32),
    )


# ---------------------------------------------------------------------------
# Derived structure
# ---------------------------------------------------------------------------


def incidence(m: MapState) -> jnp.ndarray:
    """(K, P) bool — keyframe k observes point p. The master derived object.

    Scattered with FLAT 1-D indices (k·P + p), one index vector."""
    K, P = m.kf_capacity, m.pt_capacity
    obs = m.kf_obs_point  # (K, N)
    ok = (obs >= 0) & m.kf_valid[:, None]
    k_idx = jax.lax.broadcasted_iota(jnp.int32, obs.shape, 0)
    flat = jnp.where(ok, k_idx * P + obs, K * P)
    A = jnp.zeros((K * P,), bool).at[flat.reshape(-1)].set(True, mode="drop")
    return A.reshape(K, P) & m.pt_valid[None, :]


def covisibility(m: MapState, A: jnp.ndarray | None = None) -> jnp.ndarray:
    """(K, K) int32 shared-point counts (ref KeyFrame::UpdateConnections
    weights, KeyFrame.h:68-76) — one incidence matmul."""
    if A is None:
        A = incidence(m)
    Af = A.astype(jnp.float32)
    W = (Af @ Af.T).astype(jnp.int32)
    W = W * (1 - jnp.eye(m.kf_capacity, dtype=jnp.int32))
    return jnp.where(m.kf_valid[:, None] & m.kf_valid[None, :], W, 0)


def covisibility_row(m: MapState, kf_id: jnp.ndarray) -> jnp.ndarray:
    """(K,) int32 — shared-point counts between kf_id and every keyframe,
    WITHOUT building the full incidence/covisibility: mark kf_id's points
    (one small scatter), then count marked hits along each keyframe's
    observation row (one gather + row reduce). The keyframe-insertion program
    only ever needs the new keyframe's row for neighbor/window selection."""
    P = m.pt_capacity
    obs_new = m.kf_obs_point[kf_id]
    marked = jnp.zeros((P + 1,), bool).at[
        jnp.where(obs_new >= 0, obs_new, P)
    ].set(True, mode="drop")
    marked = marked.at[P].set(False)
    marked = marked & jnp.pad(m.pt_valid, (0, 1))
    obs = m.kf_obs_point
    hit = marked[jnp.where(obs >= 0, obs, P)]        # (K, N)
    w = jnp.sum(hit, axis=1).astype(jnp.int32)
    w = jnp.where(m.kf_valid & m.kf_valid[kf_id], w, 0)
    return w.at[kf_id].set(0)


def point_observation_count_raw(m: MapState) -> jnp.ndarray:
    """(P,) int32 observation counts WITHOUT the pt_valid mask — the (K·N)
    scatter-add is independent of point validity, so fused programs can run
    it once and re-mask per stage as points die (cull → fuse share it)."""
    obs = m.kf_obs_point
    ok = (obs >= 0) & m.kf_valid[:, None]
    return jnp.zeros((m.pt_capacity,), jnp.int32).at[
        jnp.where(ok, obs, m.pt_capacity).reshape(-1)
    ].add(1, mode="drop")


def point_observation_count(m: MapState) -> jnp.ndarray:
    """(P,) int32 — number of keyframes observing each point.

    Direct 1-D scatter-add from the observation table — building the full
    (K, P) incidence just to column-reduce it costs a K·P materialization."""
    return point_observation_count_raw(m) * m.pt_valid.astype(jnp.int32)


def spanning_tree_parent(m: MapState, W: jnp.ndarray | None = None) -> jnp.ndarray:
    """(K,) int32 parent = earlier keyframe with max covisibility (ref
    KeyFrame spanning tree, built incrementally at ChangeParent sites).
    Derived on demand from the covisibility matrix; −1 for roots/invalid."""
    if W is None:
        W = covisibility(m)
    K = m.kf_capacity
    earlier = jnp.tril(jnp.ones((K, K), bool), k=-1)
    W_earlier = jnp.where(earlier, W, -1)
    parent = jnp.argmax(W_earlier, axis=1).astype(jnp.int32)
    has = jnp.max(W_earlier, axis=1) > 0
    return jnp.where(m.kf_valid & has, parent, -1)


# ---------------------------------------------------------------------------
# Allocation helpers (functional)
# ---------------------------------------------------------------------------


def free_point_slots(m: MapState, n: int) -> jnp.ndarray:
    """(n,) int32 indices of invalid point slots (lowest-index first).

    If fewer than n free slots exist the tail indices repeat slot of the
    lowest-priority victim — callers must check `pt_valid` before relying on
    uniqueness in overflow situations (capacity sized to avoid this).
    """
    free = ~m.pt_valid
    score = jnp.where(free, 1.0, 0.0) - jnp.arange(m.pt_capacity) * 1e-9
    return jax.lax.top_k(score, n)[1].astype(jnp.int32)


def add_keyframe(
    m: MapState,
    pose: jnp.ndarray,
    frame_id: jnp.ndarray,
    timestamp: jnp.ndarray,
    kp_uv: jnp.ndarray,
    kp_octave: jnp.ndarray,
    kp_angle: jnp.ndarray,
    kp_desc: jnp.ndarray,
    kp_valid: jnp.ndarray,
    obs_point: jnp.ndarray,
) -> tuple[MapState, jnp.ndarray]:
    """Insert a keyframe at the next slot; returns (new_state, kf_id)."""
    k = m.n_kf
    return (
        m._replace(
            kf_pose=m.kf_pose.at[k].set(pose),
            kf_valid=m.kf_valid.at[k].set(True),
            kf_frame_id=m.kf_frame_id.at[k].set(frame_id),
            kf_timestamp=m.kf_timestamp.at[k].set(timestamp),
            kf_kp_uv=m.kf_kp_uv.at[k].set(kp_uv),
            kf_kp_octave=m.kf_kp_octave.at[k].set(kp_octave),
            kf_kp_angle=m.kf_kp_angle.at[k].set(kp_angle),
            kf_kp_desc=m.kf_kp_desc.at[k].set(kp_desc),
            kf_kp_valid=m.kf_kp_valid.at[k].set(kp_valid),
            kf_obs_point=m.kf_obs_point.at[k].set(obs_point),
            n_kf=m.n_kf + 1,
        ),
        k,
    )


def add_points(
    m: MapState,
    slots: jnp.ndarray,      # (M,) int32 target slots (from free_point_slots)
    pos: jnp.ndarray,        # (M, 3)
    desc: jnp.ndarray,       # (M, 8) uint32
    normal: jnp.ndarray,     # (M, 3)
    min_dist: jnp.ndarray,   # (M,)
    max_dist: jnp.ndarray,   # (M,)
    first_kf: jnp.ndarray,   # () or (M,)
    first_frame: jnp.ndarray,
    use: jnp.ndarray,        # (M,) bool — only these slots are written
) -> MapState:
    """Batch-insert map points at explicit slots under a mask. Masked-out
    entries write out of bounds and are dropped by the scatter."""
    safe = jnp.where(use, slots, m.pt_capacity)  # OOB → dropped

    def wr(arr, vals):
        return arr.at[safe].set(vals, mode="drop")

    return m._replace(
        pt_pos=wr(m.pt_pos, pos),
        pt_valid=wr(m.pt_valid, jnp.ones_like(use)),
        pt_desc=wr(m.pt_desc, desc),
        pt_normal=wr(m.pt_normal, normal),
        pt_min_dist=wr(m.pt_min_dist, min_dist),
        pt_max_dist=wr(m.pt_max_dist, max_dist),
        pt_visible=wr(m.pt_visible, jnp.ones(use.shape, jnp.int32)),
        pt_found=wr(m.pt_found, jnp.ones(use.shape, jnp.int32)),
        pt_first_kf=wr(m.pt_first_kf, jnp.broadcast_to(first_kf, use.shape).astype(jnp.int32)),
        pt_first_frame=wr(
            m.pt_first_frame, jnp.broadcast_to(first_frame, use.shape).astype(jnp.int32)
        ),
        n_pt=jnp.maximum(m.n_pt, jnp.max(jnp.where(use, slots + 1, 0))),
    )


def erase_points(m: MapState, kill: jnp.ndarray) -> MapState:
    """Tombstone points (kill: (P,) bool) and clear their observations —
    the reference's SetBadFlag + per-KF EraseMapPointMatch sweep."""
    obs = m.kf_obs_point
    obs_kill = jnp.where(obs >= 0, kill[jnp.maximum(obs, 0)], False)
    return m._replace(
        pt_valid=m.pt_valid & ~kill,
        kf_obs_point=jnp.where(obs_kill, NO_POINT, obs),
    )


def erase_keyframe(m: MapState, k: jnp.ndarray) -> MapState:
    """Tombstone keyframe k (ref KeyFrame::SetBadFlag): its observations
    vanish from the incidence; points keep living via other keyframes."""
    return m._replace(
        kf_valid=m.kf_valid.at[k].set(False),
        kf_obs_point=m.kf_obs_point.at[k].set(
            jnp.full((m.kp_capacity,), NO_POINT, jnp.int32)
        ),
    )


@jax.jit
def compact_keyframes(m: MapState):
    """Renumber live keyframes to the front (temporal order preserved),
    freeing tombstoned slots for reuse — keyframe ids stay monotone in time,
    which the spanning tree, BA-window ordering, culling protection, and
    loop-gap checks all rely on. The reference never needs this (pointer
    graph), but fixed-capacity slabs do: without compaction the capacity
    bounds total insertions ever, not live keyframes.

    Returns (m', perm, n_valid): perm (K,) gathers old rows into new order
    (callers must apply the same permutation to any keyframe-indexed side
    state, e.g. the BoW database)."""
    K = m.kf_capacity
    ar = jnp.arange(K, dtype=jnp.int32)
    order = jnp.where(m.kf_valid, ar, K + ar)
    perm = jnp.argsort(order).astype(jnp.int32)          # old ids, new order
    inv = jnp.zeros((K,), jnp.int32).at[perm].set(ar)    # old id → new id
    n_valid = jnp.sum(m.kf_valid.astype(jnp.int32))

    first_old = jnp.clip(m.pt_first_kf, 0, K - 1)
    # Points whose creator was culled keep a mature (early) reference.
    first_new = jnp.where(
        m.pt_valid & m.kf_valid[first_old], inv[first_old], 0
    )
    m2 = m._replace(
        kf_pose=m.kf_pose[perm],
        kf_valid=m.kf_valid[perm],
        kf_frame_id=m.kf_frame_id[perm],
        kf_timestamp=m.kf_timestamp[perm],
        kf_kp_uv=m.kf_kp_uv[perm],
        kf_kp_octave=m.kf_kp_octave[perm],
        kf_kp_angle=m.kf_kp_angle[perm],
        kf_kp_desc=m.kf_kp_desc[perm],
        kf_kp_valid=m.kf_kp_valid[perm],
        kf_obs_point=m.kf_obs_point[perm],
        pt_first_kf=jnp.where(m.pt_valid, first_new, m.pt_first_kf),
        n_kf=n_valid,
    )
    return m2, perm, n_valid


def replace_point(m: MapState, old_id: jnp.ndarray, new_id: jnp.ndarray) -> MapState:
    """Fuse: every observation of old_id is rewired to new_id and old_id dies
    (ref MapPoint::Replace, MapPoint.h:68)."""
    obs = m.kf_obs_point
    obs = jnp.where(obs == old_id, new_id, obs)
    return m._replace(
        kf_obs_point=obs,
        pt_valid=m.pt_valid.at[old_id].set(False),
        pt_found=m.pt_found.at[new_id].add(m.pt_found[old_id]),
        pt_visible=m.pt_visible.at[new_id].add(m.pt_visible[old_id]),
    )


# ---------------------------------------------------------------------------
# Point statistics refresh (ref MapPoint::UpdateNormalAndDepth +
# ComputeDistinctiveDescriptors, run per keyframe insertion)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("scale", "n_levels", "update_desc"))
def refresh_point_stats(
    m: MapState, scale: float = 1.2, n_levels: int = 8,
    update_desc: bool = True,
) -> MapState:
    """Recompute normals, scale-invariance ranges, and distinctive descriptors
    for all valid points from the current observation structure — one batched
    pass replacing the reference's per-point loops."""
    A = incidence(m)  # (K, P)
    Af = A.astype(jnp.float32)
    n_obs = jnp.sum(Af, axis=0)  # (P,)
    has_obs = n_obs > 0

    # Mean viewing direction: average of (pos - camera_center) normalized.
    from gf_orb_slam_tpu.geometry import se3 as se3m

    centers = se3m.pose_t(se3m.inverse(m.kf_pose))  # (K, 3) camera centers
    # normal_p = Σ_k A[k,p] · unit(pos_p − C_k)
    diff = m.pt_pos[None, :, :] - centers[:, None, :]     # (K, P, 3)
    dist = jnp.linalg.norm(diff, axis=-1)                  # (K, P)
    unit = diff / jnp.maximum(dist[..., None], 1e-9)
    normals = jnp.einsum("kp,kpd->pd", Af, unit) / jnp.maximum(n_obs[:, None], 1.0)

    # Scale range from the reference keyframe (= first observing KF here):
    # maxDist = dist * scale^octave ; minDist = maxDist / scale^(nLevels-1).
    # Find each point's first (kf, slot) observation with one scatter-min of
    # the packed code k·N+i — no (P, N) blowup.
    K, N = m.kf_obs_point.shape
    BIG = jnp.int32(K * N)
    k_idx = jax.lax.broadcasted_iota(jnp.int32, (K, N), 0)
    i_idx = jax.lax.broadcasted_iota(jnp.int32, (K, N), 1)
    code = k_idx * N + i_idx
    obs_ok = (m.kf_obs_point >= 0) & m.kf_valid[:, None]
    min_code = jnp.full((m.pt_capacity,), BIG, jnp.int32).at[
        jnp.where(obs_ok, m.kf_obs_point, m.pt_capacity)
    ].min(jnp.where(obs_ok, code, BIG), mode="drop")
    min_code = jnp.minimum(min_code, BIG - 1)
    first_kf = min_code // N
    obs_slot = min_code % N
    ref_dist = dist[first_kf, jnp.arange(m.pt_capacity)]
    ref_oct = m.kf_kp_octave[first_kf, obs_slot]
    level_factor = scale ** ref_oct.astype(jnp.float32)
    max_dist = ref_dist * level_factor
    min_dist = max_dist / (scale ** (n_levels - 1))

    # Distinctive descriptor: among observations, pick the one minimizing the
    # summed Hamming distance to the others (median in the reference,
    # MapPoint.h:74 — min-sum is the same argmin for small sets and batches).
    # Approximation: keep the current descriptor unless the point has ≥2 obs,
    # in which case use the first observing KF's descriptor slot. A full
    # min-sum pass runs in local mapping (keyframe_ops.distinctive_descriptors).
    m = m._replace(
        pt_normal=jnp.where(has_obs[:, None], normals, m.pt_normal),
        pt_min_dist=jnp.where(has_obs, min_dist, m.pt_min_dist),
        pt_max_dist=jnp.where(has_obs, max_dist, m.pt_max_dist),
    )
    if update_desc:
        desc_ref = m.kf_kp_desc[first_kf, obs_slot]
        m = m._replace(pt_desc=jnp.where(has_obs[:, None], desc_ref, m.pt_desc))
    return m
