"""Keyframe-rate map maintenance programs (reference LocalMapping internals):
new-point triangulation, map-point culling, duplicate fusion, distinctive
descriptors, keyframe culling.

Each operation is a fixed-shape jitted program over MapState; the reference's
per-pointer loops (src/LocalMapping.cc:163-655, ORBmatcher Fuse cc:1590) are
batched gathers/scatters gated by masks.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from gf_orb_slam_tpu.geometry import se3
from gf_orb_slam_tpu.geometry.camera import CameraModel, project
from gf_orb_slam_tpu.mapping import map_state as ms
from gf_orb_slam_tpu.ops import matching
from gf_orb_slam_tpu.solvers.initializer import triangulate_dlt


# ---------------------------------------------------------------------------
# Triangulating new map points between a new keyframe and a neighbor
# (ref LocalMapping::CreateNewMapPoints, cc:243-410)
# ---------------------------------------------------------------------------


def fundamental_from_poses(cam: CameraModel, pose1: jnp.ndarray, pose2: jnp.ndarray):
    """F12 with x2ᵀ F12 x1 = 0 from two T_cw poses (ref ComputeF12,
    LocalMapping.cc:490-507)."""
    rel = se3.compose(pose2, se3.inverse(pose1))  # T_21
    from gf_orb_slam_tpu.geometry import quat

    R = quat.q2r(se3.pose_q(rel))
    t = se3.pose_t(rel)
    tx = se3.hat(t)
    E = tx @ R
    Kinv = jnp.linalg.inv(cam.K)
    return Kinv.T @ E @ Kinv


@partial(jax.jit, static_argnames=("cam", "scale", "n_levels"))
def triangulate_between(
    cam: CameraModel,
    m: ms.MapState,
    kf1: jnp.ndarray,
    kf2: jnp.ndarray,
    frame_id: jnp.ndarray,
    min_parallax_cos: float = 0.9998,
    scale: float = 1.2,
    n_levels: int = 8,
) -> ms.MapState:
    """Epipolar-search + DLT triangulation of unmatched keypoints between
    keyframes kf1 (new) and kf2 (neighbor), inserting accepted points."""
    pose1 = m.kf_pose[kf1]
    pose2 = m.kf_pose[kf2]
    uv1 = m.kf_kp_uv[kf1]
    uv2 = m.kf_kp_uv[kf2]
    N = uv1.shape[0]

    # Only keypoints without an existing map point participate.
    free1 = m.kf_kp_valid[kf1] & (m.kf_obs_point[kf1] == ms.NO_POINT)
    free2 = m.kf_kp_valid[kf2] & (m.kf_obs_point[kf2] == ms.NO_POINT)

    sigma2_lvl = jnp.asarray([scale ** (2 * i) for i in range(n_levels)])
    F12 = fundamental_from_poses(cam, pose1, pose2)
    emask = matching.epipolar_mask(
        uv1, uv2, F12, sigma2_lvl[m.kf_kp_octave[kf2]], free1, free2
    )
    res = matching.match(
        m.kf_kp_desc[kf1], m.kf_kp_desc[kf2], emask,
        max_dist=matching.TH_LOW, ratio=1.0,
        angle_q=m.kf_kp_angle[kf1], angle_t=m.kf_kp_angle[kf2], mutual=True,
    )

    # Triangulate every tentative pair; gate afterwards.
    P1 = cam.K @ jnp.concatenate(
        [se3.pose_matrix(pose1)[:3, :3], se3.pose_matrix(pose1)[:3, 3:4]], axis=1
    )
    P2 = cam.K @ jnp.concatenate(
        [se3.pose_matrix(pose2)[:3, :3], se3.pose_matrix(pose2)[:3, 3:4]], axis=1
    )
    uv2_m = uv2[res.idx]
    X = triangulate_dlt(P1, P2, uv1, uv2_m)  # world coords (P includes pose)

    # Cheirality + reprojection + parallax + scale-consistency gates.
    xc1 = se3.transform_point(pose1, X)
    xc2 = se3.transform_point(pose2, X)
    uvp1, z1, ok1 = project(cam, xc1)
    uvp2, z2, ok2 = project(cam, xc2)
    e1 = jnp.sum((uvp1 - uv1) ** 2, axis=-1)
    e2 = jnp.sum((uvp2 - uv2_m) ** 2, axis=-1)
    s2_1 = sigma2_lvl[m.kf_kp_octave[kf1]]
    s2_2 = sigma2_lvl[m.kf_kp_octave[kf2]][res.idx]

    c1 = se3.pose_t(se3.inverse(pose1))
    c2 = se3.pose_t(se3.inverse(pose2))
    r1 = X - c1[None, :]
    r2 = X - c2[None, :]
    cosp = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-9
    )
    dist1 = jnp.linalg.norm(r1, axis=-1)
    dist2 = jnp.linalg.norm(r2, axis=-1)
    ratio_dist = dist1 / jnp.maximum(dist2, 1e-9)
    ratio_oct = (
        sigma2_lvl[m.kf_kp_octave[kf1]] / jnp.maximum(s2_2, 1e-9)
    ) ** 0.5  # scale^Δoctave
    ratio_factor = 1.5 * scale

    good = (
        res.matched
        & ok1
        & ok2
        & jnp.all(jnp.isfinite(X), axis=-1)
        & (e1 < 5.991 * s2_1)
        & (e2 < 5.991 * s2_2)
        & (cosp < min_parallax_cos)
        & (ratio_dist * ratio_factor > ratio_oct)
        & (ratio_dist < ratio_oct * ratio_factor)
    )

    # Insert points + wire observations in both keyframes.
    slots = ms.free_point_slots(m, N)
    normal = r1 / jnp.maximum(jnp.linalg.norm(r1, axis=-1, keepdims=True), 1e-9)
    level_factor = scale ** m.kf_kp_octave[kf1].astype(jnp.float32)
    max_d = dist1 * level_factor
    min_d = max_d / (scale ** (n_levels - 1))
    m2 = ms.add_points(
        m, slots, X, m.kf_kp_desc[kf1], normal, min_d, max_d,
        first_kf=kf1, first_frame=frame_id, use=good,
    )
    # observation wiring: kf1 slot i ↔ point slots[i]; kf2 slot res.idx[i].
    obs1 = m2.kf_obs_point[kf1]
    obs1 = jnp.where(good, slots, obs1)
    obs2 = m2.kf_obs_point[kf2]
    obs2 = obs2.at[jnp.where(good, res.idx, N)].set(
        jnp.where(good, slots, 0), mode="drop"
    )
    m2 = m2._replace(
        kf_obs_point=m2.kf_obs_point.at[kf1].set(obs1).at[kf2].set(obs2)
    )
    return m2


# ---------------------------------------------------------------------------
# Map point culling (ref LocalMapping::MapPointCulling, cc:213-241)
# ---------------------------------------------------------------------------


@jax.jit
def cull_points(
    m: ms.MapState,
    current_kf: jnp.ndarray,
    min_found_ratio: float = 0.25,
    n_obs: jnp.ndarray | None = None,
) -> ms.MapState:
    """Remove low-quality recent points: found/visible < 0.25, or ≥2 keyframes
    old with ≤2 observations (monocular rule).

    n_obs may be passed in to share the (K,N) observation-count scatter with
    other stages of a fused program (the scatter itself is pt_valid-agnostic;
    point_observation_count masks dead points afterwards)."""
    if n_obs is None:
        n_obs = ms.point_observation_count(m)
    age = current_kf - m.pt_first_kf
    found_ratio = m.pt_found.astype(jnp.float32) / jnp.maximum(
        m.pt_visible.astype(jnp.float32), 1.0
    )
    bad = m.pt_valid & (
        (found_ratio < min_found_ratio)
        | ((age >= 2) & (n_obs <= 2))
    )
    # Points older than 3 KFs with ≥3 obs are permanent (reference removes
    # them from the culling candidate list).
    bad = bad & ~((age >= 3) & (n_obs >= 3))
    return ms.erase_points(m, bad)


# ---------------------------------------------------------------------------
# Fuse duplicated points between a keyframe and neighbors
# (ref LocalMapping::SearchInNeighbors + ORBmatcher::Fuse, cc:1590-1709)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cam", "scale", "n_levels"))
def fuse_into_keyframe(
    cam: CameraModel,
    m: ms.MapState,
    target_kf: jnp.ndarray,
    cand_points: jnp.ndarray,  # (M,) point ids to project (from neighbor KFs)
    cand_use: jnp.ndarray,     # (M,) bool
    radius: float = 3.0,
    scale: float = 1.2,
    n_levels: int = 8,
) -> ms.MapState:
    """Project candidate points into target_kf; where they land on a keypoint
    whose descriptor matches: either merge with that keypoint's existing point
    (keep the one with more observations) or claim the free keypoint."""
    pose = m.kf_pose[target_kf]
    pts = m.pt_pos[cand_points]
    ok = cand_use & m.pt_valid[cand_points]

    # Skip candidates the target already observes (ref ORBmatcher::Fuse's
    # IsInKeyFrame skip, cc:1600) — fusing a point with itself via a second
    # keypoint slot would duplicate the observation within one keyframe.
    obs_t = m.kf_obs_point[target_kf]
    in_target = jnp.zeros((m.pt_capacity,), bool).at[
        jnp.maximum(obs_t, 0)
    ].max(obs_t >= 0)
    ok = ok & ~in_target[cand_points]

    xc = se3.transform_point(pose, pts)
    uvp, depth, front = project(cam, xc)
    # Scale/viewing gates as in Fuse: distance within [min,max], normal cos>0.5.
    c = se3.pose_t(se3.inverse(pose))
    view = pts - c[None, :]
    dist = jnp.linalg.norm(view, axis=-1)
    cos_view = jnp.sum(
        view * m.pt_normal[cand_points], axis=-1
    ) / jnp.maximum(dist, 1e-9)
    in_range = (dist >= m.pt_min_dist[cand_points] * 0.8) & (
        dist <= m.pt_max_dist[cand_points] * 1.2
    )
    ok = ok & front & in_range & (cos_view > 0.5)

    # Predicted octave from distance (ref MapPoint::PredictScale).
    pred_oct = jnp.clip(
        jnp.ceil(
            jnp.log(jnp.maximum(m.pt_max_dist[cand_points] / jnp.maximum(dist, 1e-9), 1e-9))
            / jnp.log(scale)
        ).astype(jnp.int32),
        0,
        n_levels - 1,
    )
    sigma_lvl = jnp.asarray([scale**i for i in range(n_levels)])
    rad = radius * sigma_lvl[pred_oct]

    pmask = matching.projection_mask(
        uvp, ok, m.kf_kp_uv[target_kf], m.kf_kp_octave[target_kf],
        m.kf_kp_valid[target_kf], rad, pred_oct,
    )
    res = matching.match(
        m.pt_desc[cand_points], m.kf_kp_desc[target_kf], pmask,
        max_dist=matching.TH_LOW,
    )
    hit = res.matched & ok

    kp_point = m.kf_obs_point[target_kf][res.idx]  # existing point at hit slot
    n_obs = ms.point_observation_count(m)

    # Case A: keypoint free → claim it for the candidate point.
    claim = hit & (kp_point == ms.NO_POINT)
    obs_row = m.kf_obs_point[target_kf]
    obs_row = obs_row.at[jnp.where(claim, res.idx, obs_row.shape[0])].set(
        jnp.where(claim, cand_points, 0), mode="drop"
    )
    m = m._replace(kf_obs_point=m.kf_obs_point.at[target_kf].set(obs_row))

    # Case B: keypoint already has a different point → replace the one with
    # fewer observations by the other.
    dup = hit & (kp_point != ms.NO_POINT) & (kp_point != cand_points)
    keep_existing = n_obs[jnp.maximum(kp_point, 0)] >= n_obs[jnp.maximum(cand_points, 0)]
    old_id = jnp.where(keep_existing, cand_points, kp_point)
    new_id = jnp.where(keep_existing, kp_point, cand_points)
    # One-pass rewire via a point-id remap table (single-level: chained merges
    # a→b→c resolve over successive fuse calls, same as the reference which
    # fuses once per keyframe insertion).
    remap = jnp.arange(m.pt_capacity, dtype=jnp.int32)
    remap = remap.at[jnp.where(dup, old_id, m.pt_capacity)].set(
        jnp.where(dup, new_id, 0), mode="drop"
    )
    obs = m.kf_obs_point
    obs = jnp.where(obs >= 0, remap[jnp.maximum(obs, 0)], obs)
    killed = m.pt_valid & (remap != jnp.arange(m.pt_capacity, dtype=jnp.int32))
    # Merge visible/found counters into the survivor (ref MapPoint::Replace,
    # MapPoint.cc — IncreaseVisible/IncreaseFound carried over). Keyed by the
    # KILLED point id (a (P,)-wide mask), not by dup pair: each dead point
    # donates its counters exactly once to its final survivor remap[p], even
    # if the same (old,new) pair was detected by several candidate rows.
    surv = jnp.where(killed, remap, m.pt_capacity)
    add_vis = jnp.zeros(m.pt_capacity, jnp.int32).at[surv].add(
        jnp.where(killed, m.pt_visible, 0), mode="drop"
    )
    add_fnd = jnp.zeros(m.pt_capacity, jnp.int32).at[surv].add(
        jnp.where(killed, m.pt_found, 0), mode="drop"
    )
    m = m._replace(
        kf_obs_point=obs,
        pt_valid=m.pt_valid & ~killed,
        pt_visible=m.pt_visible + add_vis,
        pt_found=m.pt_found + add_fnd,
    )
    return m


def fuse_points_into_keyframes(
    cam: CameraModel,
    m: ms.MapState,
    target_kfs: jnp.ndarray,   # (F,) keyframe ids
    target_ok: jnp.ndarray,    # (F,) bool — padded/ineligible targets off
    cand_points: jnp.ndarray,  # (F, M) point ids to project per target
    cand_use: jnp.ndarray,     # (F, M) bool
    radius: float = 3.0,
    scale: float = 1.2,
    n_levels: int = 8,
    n_obs: jnp.ndarray | None = None,
) -> ms.MapState:
    """Both directions of SearchInNeighbors fuse (ref LocalMapping.cc:
    411-560: neighbors' points into the new keyframe AND the new keyframe's
    points into each neighbor), BATCHED over the F targets with per-target
    candidate lists: one vmapped projection/gate/Hamming pass and ONE update
    application replace the sequential fuse_into_keyframe calls (their
    sequential scatter chains, not the math, were the cost).

    Semantics vs the sequential loop: every target matches against its
    candidate list as of the program's START (the sequential version re-read
    rows after each target's merges). Merge-chains across targets (a→b in
    one neighbor, b→c in another) resolve over successive insertions,
    exactly like the reference's once-per-insertion fuse; conflicting
    scatter writes resolve last-wins, matching the loop's
    last-neighbor-wins."""
    if n_obs is None:
        n_obs = ms.point_observation_count(m)
    sigma_lvl = jnp.asarray([scale**i for i in range(n_levels)])

    def per_target(tkf, tok, cand, use):
        pts = m.pt_pos[cand]
        obs_t = m.kf_obs_point[tkf]
        in_target = jnp.zeros((m.pt_capacity,), bool).at[
            jnp.maximum(obs_t, 0)
        ].max(obs_t >= 0)
        ok = use & m.pt_valid[cand] & tok & ~in_target[cand]
        pose = m.kf_pose[tkf]
        xc = se3.transform_point(pose, pts)
        uvp, depth, front = project(cam, xc)
        c = se3.pose_t(se3.inverse(pose))
        view = pts - c[None, :]
        dist = jnp.linalg.norm(view, axis=-1)
        cos_view = jnp.sum(view * m.pt_normal[cand], axis=-1) / jnp.maximum(
            dist, 1e-9
        )
        in_range = (dist >= m.pt_min_dist[cand] * 0.8) & (
            dist <= m.pt_max_dist[cand] * 1.2
        )
        ok = ok & front & in_range & (cos_view > 0.5)
        pred_oct = jnp.clip(
            jnp.ceil(
                jnp.log(
                    jnp.maximum(
                        m.pt_max_dist[cand] / jnp.maximum(dist, 1e-9), 1e-9
                    )
                )
                / jnp.log(scale)
            ).astype(jnp.int32),
            0,
            n_levels - 1,
        )
        rad = radius * sigma_lvl[pred_oct]
        pmask = matching.projection_mask(
            uvp, ok, m.kf_kp_uv[tkf], m.kf_kp_octave[tkf], m.kf_kp_valid[tkf],
            rad, pred_oct,
        )
        res = matching.match(
            m.pt_desc[cand], m.kf_kp_desc[tkf], pmask,
            max_dist=matching.TH_LOW,
        )
        hit = res.matched & ok
        kp_point = m.kf_obs_point[tkf][res.idx]
        return hit, res.idx, kp_point

    hit, idx, kp_point = jax.vmap(per_target)(
        target_kfs, target_ok, cand_points, cand_use
    )  # (F, M)
    F, M = hit.shape
    cand_b = cand_points

    # Case A: free keypoint slot → claim it. FLAT 1-D scatter (k·N + slot),
    # one index vector (as in map_state.incidence). Duplicate
    # writes resolve last-wins, as in the sequential loop.
    K, Nk = m.kf_obs_point.shape
    claim = hit & (kp_point == ms.NO_POINT)
    flat_idx = jnp.where(claim, target_kfs[:, None] * Nk + idx, K * Nk)
    obs_all = m.kf_obs_point.reshape(-1).at[flat_idx.reshape(-1)].set(
        jnp.where(claim, cand_b, 0).reshape(-1), mode="drop"
    ).reshape(K, Nk)
    m = m._replace(kf_obs_point=obs_all)

    # Case B: occupied by a DIFFERENT point → keep the better-observed one.
    dup = hit & (kp_point != ms.NO_POINT) & (kp_point != cand_b)
    keep_existing = (
        n_obs[jnp.maximum(kp_point, 0)] >= n_obs[jnp.maximum(cand_b, 0)]
    )
    old_id = jnp.where(keep_existing, cand_b, kp_point)
    new_id = jnp.where(keep_existing, kp_point, cand_b)
    remap = jnp.arange(m.pt_capacity, dtype=jnp.int32)
    remap = remap.at[jnp.where(dup, old_id, m.pt_capacity).reshape(-1)].set(
        jnp.where(dup, new_id, 0).reshape(-1), mode="drop"
    )
    # Self-map survivors: a point that is old in one target and new in
    # another must not be redirected through a killed id chain — re-anchor
    # new ids to themselves so last-wins cannot orphan them.
    remap = remap.at[jnp.where(dup, new_id, m.pt_capacity).reshape(-1)].set(
        jnp.where(dup, new_id, 0).reshape(-1), mode="drop"
    )
    obs = m.kf_obs_point
    obs = jnp.where(obs >= 0, remap[jnp.maximum(obs, 0)], obs)
    killed = m.pt_valid & (remap != jnp.arange(m.pt_capacity, dtype=jnp.int32))
    # Counter merges keyed by the killed point id, not by dup pair: all F
    # targets share the same candidate list, so the same (old,new) merge can
    # be detected by several targets — a pair-keyed scatter-add would donate
    # the old point's visible/found counters k times (and tie/re-anchored
    # survivors would donate without dying). One (P,)-wide pass adds each
    # dead point's counters exactly once to its final survivor remap[p]
    # (advisor finding, round 4).
    surv = jnp.where(killed, remap, m.pt_capacity)
    add_vis = jnp.zeros(m.pt_capacity, jnp.int32).at[surv].add(
        jnp.where(killed, m.pt_visible, 0), mode="drop"
    )
    add_fnd = jnp.zeros(m.pt_capacity, jnp.int32).at[surv].add(
        jnp.where(killed, m.pt_found, 0), mode="drop"
    )
    return m._replace(
        kf_obs_point=obs,
        pt_valid=m.pt_valid & ~killed,
        pt_visible=m.pt_visible + add_vis,
        pt_found=m.pt_found + add_fnd,
    )


# ---------------------------------------------------------------------------
# Distinctive descriptors (ref MapPoint::ComputeDistinctiveDescriptors) are
# maintained window-locally inside the fused insertion program
# (pipeline/local_mapping.py) — one scatter + medoid popcount over the BA
# window, where all fresh observations live. A full-map min-sum pass (8
# serial scatter-min passes over K·N) gave no accuracy gain over the
# windowed medoid, so it is deliberately not provided.
# ---------------------------------------------------------------------------
# Keyframe culling (ref LocalMapping::KeyFrameCulling, cc:562-618)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_levels",))
def keyframe_redundancy(
    m: ms.MapState, n_levels: int = 8, rows: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Fraction of each keyframe's tracked points that are seen by ≥3 OTHER
    keyframes at the same-or-finer scale (ref LocalMapping::KeyFrameCulling,
    cc:562-618: observers with scaleLevel ≤ this observation's scaleLevel + 1
    count; thObs = 3). One flat scatter-add builds the per-point octave
    histogram; a cumulative sum answers every (keyframe, observation)
    redundancy query by gather.

    rows=None → (K,) over all keyframes. rows=(Kc,) keyframe ids → (Kc,)
    restricted to those rows: the observer histogram still covers the whole
    map, but the expensive (K, N) answer gather shrinks to (Kc, N) — the
    reference only ever culls the current keyframe's covisible locals."""
    K, N = m.kf_obs_point.shape
    P = m.pt_capacity
    obs_all = m.kf_obs_point
    ok_all = (obs_all >= 0) & m.kf_valid[:, None] & m.pt_valid[jnp.maximum(obs_all, 0)]
    oct_all = jnp.clip(m.kf_kp_octave, 0, n_levels - 1)
    flat = jnp.where(ok_all, obs_all * n_levels + oct_all, P * n_levels)
    cnt = jnp.zeros((P * n_levels,), jnp.int32).at[flat.reshape(-1)].add(
        1, mode="drop"
    )
    cum = jnp.cumsum(cnt.reshape(P, n_levels), axis=1)   # observers at octave ≤ o
    if rows is None:
        obs, ok, oct_, kfv = obs_all, ok_all, oct_all, m.kf_valid
    else:
        obs, ok, oct_, kfv = (
            obs_all[rows], ok_all[rows], oct_all[rows], m.kf_valid[rows]
        )
    oct_p1 = jnp.minimum(oct_ + 1, n_levels - 1)
    # Subtract self: this keyframe's own observation is at octave ≤ octave+1.
    n_other = cum[jnp.maximum(obs, 0), oct_p1] - 1
    red = ok & (n_other >= 3)
    n_has = jnp.sum(ok, axis=1)
    return jnp.where(
        kfv & (n_has > 0),
        jnp.sum(red, axis=1) / jnp.maximum(n_has, 1),
        0.0,
    )
