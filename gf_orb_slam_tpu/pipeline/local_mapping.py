"""The per-keyframe local-mapping pipeline as ONE fused device program.

Reference: LocalMapping::Run's per-keyframe sequence (src/LocalMapping.cc:
46-147 — ProcessNewKeyFrame → MapPointCulling → CreateNewMapPoints →
SearchInNeighbors → LocalBundleAdjustment → KeyFrameCulling). The reference
runs it on a separate thread with mutexes and an abortable BA; here the whole
sequence is a single MapState → MapState jitted transform: one dispatch per
keyframe insertion, with covisibility-neighbor selection, triangulation
against the top-2 neighbors, point culling, stat refresh, fused duplicate
search, the padded-window Schur BA, and keyframe-redundancy culling all
scheduled by XLA inside one program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam_tpu.geometry.camera import CameraModel
from gf_orb_slam_tpu.mapping import keyframe_ops
from gf_orb_slam_tpu.mapping import map_state as ms
from gf_orb_slam_tpu.solvers import local_ba


class InsertResult(NamedTuple):
    m: ms.MapState
    kf_id: jnp.ndarray
    culled_kf: jnp.ndarray   # () int32 — keyframe tombstoned this round (−1 none)
    view: object             # track_view.TrackView around the new keyframe
    n_ref: jnp.ndarray       # () int32 — tracked-observation count of the new
                             # keyframe (the host's n_ref_tracked statistic;
                             # computed here so the host needn't dispatch a
                             # separate reduction per insertion)


@partial(
    jax.jit,
    static_argnames=(
        "cam", "scale", "n_levels", "ba_window", "ba_fixed", "n_tri_neighbors",
        "ba_points", "ba_iters", "n_fuse_neighbors", "view_size",
    ),
    donate_argnums=(1,),
)
def insert_keyframe_fused(
    cam: CameraModel,
    m: ms.MapState,
    pose: jnp.ndarray,
    frame_id: jnp.ndarray,
    timestamp: jnp.ndarray,
    kp_uv: jnp.ndarray,
    kp_octave: jnp.ndarray,
    kp_angle: jnp.ndarray,
    kp_desc: jnp.ndarray,
    kp_valid: jnp.ndarray,
    obs_point: jnp.ndarray,
    scale: float = 1.2,
    n_levels: int = 8,
    ba_window: int = 8,
    ba_fixed: int = 2,
    n_tri_neighbors: int = 3,
    ba_points: int = 2048,
    ba_iters: tuple = (5, 10),
    n_fuse_neighbors: int = 4,
    view_size: int = 4096,
) -> InsertResult:
    """Insert + run the whole local-mapping pipeline. kp_* arrays must already
    be padded to the map's keypoint capacity."""
    m, kf_id = ms.add_keyframe(
        m, pose, frame_id, timestamp, kp_uv, kp_octave, kp_angle, kp_desc,
        kp_valid, obs_point,
    )

    # Covisibility + triangulation neighbors: top-n by shared points (≥10)
    # among keyframes with a usable stereo baseline. The reference skips
    # neighbors with baseline < 1% of median scene depth
    # (LocalMapping.cc:262-276); bursts of keyframes inserted a frame apart
    # are nearly co-located, so without this gate the top-covisibility
    # neighbor often has sub-degree parallax and triangulation yields nothing.
    w_row = ms.covisibility_row(m, kf_id)
    from gf_orb_slam_tpu.geometry import se3 as se3m

    centers = se3m.pose_t(se3m.inverse(m.kf_pose))           # (K, 3)
    baseline = jnp.linalg.norm(centers - centers[kf_id], axis=-1)
    obs_new = m.kf_obs_point[kf_id]
    has_new = obs_new >= 0
    depth_ref = jnp.sum(
        jnp.where(
            has_new,
            jnp.linalg.norm(
                m.pt_pos[jnp.maximum(obs_new, 0)] - centers[kf_id], axis=-1
            ),
            0.0,
        )
    ) / jnp.maximum(jnp.sum(has_new), 1)
    w_eff = jnp.where(baseline > 0.02 * depth_ref, w_row, 0)
    top_w, top_ids = jax.lax.top_k(w_eff, n_tri_neighbors)
    for i in range(n_tri_neighbors):
        nb = top_ids[i]
        do = top_w[i] >= 10
        m_tri = keyframe_ops.triangulate_between(
            cam, m, kf_id, nb, frame_id, scale=scale, n_levels=n_levels
        )
        m = jax.tree.map(
            lambda new, old: jnp.where(do, new, old) if new.dtype != bool
            else jnp.where(do, new, old),
            m_tri, m,
        )

    # One shared (K·N) observation-count scatter for culling AND fusion: the
    # scatter is pt_valid-agnostic, so each stage just re-masks it (the two
    # separate point_observation_count calls cost a full scatter each in the
    # round-4 program).
    cnt_raw = ms.point_observation_count_raw(m)
    m = keyframe_ops.cull_points(
        m, kf_id, n_obs=cnt_raw * m.pt_valid.astype(jnp.int32)
    )

    # --- SearchInNeighbors: fuse duplicate points both directions (ref
    # LocalMapping.cc:411-560 + ORBmatcher::Fuse cc:1590-1709). Direction 1:
    # the top covisible neighbors' points projected into the new keyframe;
    # direction 2: the new keyframe's points projected into each neighbor.
    # Neighbors below the covisibility floor participate with an all-False
    # candidate mask, which makes the fuse call an identity transform.
    N = m.kp_capacity
    P = m.pt_capacity
    if n_fuse_neighbors > 0:  # static: 0 compiles fusion out entirely
        # Reuse the pre-triangulation covisibility row (w_row) — an
        # APPROXIMATION: triangulation partners are chosen from the
        # baseline-gated w_eff, so a co-located (gated-out) keyframe can
        # outrank a partner that just gained triangulated points, and the
        # top-F set here may differ from a recomputed row's. Accepted
        # heuristic drift: recomputing the row costs another pass, and fusion
        # only needs *well-covisible* neighbors, not exactly the top-F.
        fw, fuse_ids = jax.lax.top_k(w_row, n_fuse_neighbors)
        fuse_ok = fw >= 10
        # Direction-1 candidates: the UNION of the neighbors' points,
        # deduplicated and compacted to a fixed slab (neighbors share most
        # points, so the raw F·N list is ~2-3× redundant — dedup shrinks the
        # fuse Hamming matrix).
        obs_nb = m.kf_obs_point[fuse_ids]                      # (F, N)
        nb_ok = (obs_nb >= 0) & fuse_ok[:, None]
        member = jnp.zeros((P,), bool).at[
            jnp.where(nb_ok, obs_nb, P).reshape(-1)
        ].set(True, mode="drop")
        order = jnp.where(member, jnp.arange(P, dtype=jnp.int32), P)
        # Candidate slab width: at least kp_capacity so direction-2 (the new
        # keyframe's own point list, one entry per keypoint slot) is never
        # silently truncated when n_features outgrows ba_points (advisor
        # finding, round 4); ba_points bounds direction-1's union as before.
        Mf = min(max(ba_points, N), P)
        cand1 = -jax.lax.top_k(-order, Mf)[0]                   # smallest ids
        use1 = cand1 < P
        # Both directions in ONE batched program (5 targets): target 0 is the
        # new keyframe receiving the neighbors' point union; targets 1..F are
        # the neighbors receiving the new keyframe's points (padded to the
        # same candidate width) instead of sequential per-target calls.
        cand2 = m.kf_obs_point[kf_id]
        c2 = jnp.full((Mf,), ms.NO_POINT, jnp.int32).at[
            : min(cand2.shape[0], Mf)
        ].set(cand2[:Mf])
        targets = jnp.concatenate([kf_id[None], fuse_ids])
        t_ok = jnp.concatenate([jnp.ones(1, bool), fuse_ok])
        cands = jnp.concatenate([
            jnp.minimum(cand1, P - 1)[None],
            jnp.broadcast_to(jnp.maximum(c2, 0)[None], (n_fuse_neighbors, Mf)),
        ])
        uses = jnp.concatenate([
            use1[None],
            jnp.broadcast_to((c2 >= 0)[None], (n_fuse_neighbors, Mf)),
        ])
        m = keyframe_ops.fuse_points_into_keyframes(
            cam, m, targets, t_ok, cands, uses,
            scale=scale, n_levels=n_levels,
            n_obs=cnt_raw * m.pt_valid.astype(jnp.int32),
        )

    # --- local BA over the top covisibility window (fixed shapes) ---
    # Same w_row reuse as fusion: triangulation/fusion only strengthen links
    # to keyframes already at the top of the row.
    w_row2 = w_row.at[kf_id].set(jnp.int32(1 << 30))  # self always in window
    top_w2, win_ids = jax.lax.top_k(w_row2, ba_window)
    active = top_w2 > 0
    # Order by keyframe id so the fixed boundary = the earliest ones.
    order = jnp.argsort(jnp.where(active, win_ids, jnp.int32(1 << 30)))
    win_ids = win_ids[order]
    active = active[order]

    obs_local = jnp.where(active[:, None], m.kf_obs_point[win_ids], ms.NO_POINT)
    local_pts = jnp.zeros(m.pt_capacity, bool).at[
        jnp.maximum(obs_local.reshape(-1), 0)
    ].max(obs_local.reshape(-1) >= 0)
    local_pts = local_pts & m.pt_valid
    sigma2 = jnp.asarray([scale ** (2 * i) for i in range(n_levels)])[
        m.kf_kp_octave[win_ids]
    ]
    n_active = jnp.sum(active.astype(jnp.int32))
    rank = jnp.cumsum(active.astype(jnp.int32)) - 1  # position among active
    fixed = (~active) | (rank < jnp.minimum(ba_fixed, jnp.maximum(n_active - 1, 1)))

    # Compact the BA to a ba_points-slot local-point view: the per-point Schur
    # tensors (L, C, 6, 3) dominate the insertion program's HBM traffic, and
    # padding them to the full 16k-point capacity cost ~4× the necessary
    # bandwidth. top_k over the mask gathers the set-bit indices (stable —
    # ties broken by lower index); points beyond the cap simply sit this BA
    # out (static compute budget, like every other cap here).
    P = m.pt_capacity
    L = ba_points
    local_idx = jax.lax.top_k(local_pts.astype(jnp.int32), L)[1].astype(jnp.int32)
    l_valid = local_pts[local_idx]
    inv = jnp.full((P,), L, jnp.int32).at[local_idx].set(
        jnp.arange(L, dtype=jnp.int32)
    )
    obs_lidx = inv[jnp.maximum(obs_local, 0)]
    in_ba = (obs_local >= 0) & (obs_lidx < L)
    obs_l = jnp.where(in_ba, obs_lidx, ms.NO_POINT)

    prob = local_ba.BAProblem(
        poses=m.kf_pose[win_ids],
        points=m.pt_pos[local_idx],
        fixed=fixed,
        point_valid=l_valid,
        obs_uv=m.kf_kp_uv[win_ids],
        obs_point=obs_l,
        obs_w=jnp.where(obs_l >= 0, 1.0 / sigma2, 0.0),
    )
    res = local_ba.bundle_adjust(cam, prob, iters_stage1=ba_iters[0], iters_stage2=ba_iters[1])
    safe_ids = jnp.where(active, win_ids, m.kf_capacity)
    # Observations outside the compacted BA keep their status; only
    # BA-classified outliers are dropped.
    keep_obs = jnp.where(in_ba, res.obs_active, obs_local >= 0)
    new_pt_pos = m.pt_pos.at[jnp.where(l_valid, local_idx, P)].set(
        res.points, mode="drop"
    )
    m = m._replace(
        kf_pose=m.kf_pose.at[safe_ids].set(res.poses, mode="drop"),
        pt_pos=new_pt_pos,
        kf_obs_point=m.kf_obs_point.at[safe_ids].set(
            jnp.where(keep_obs, obs_local, ms.NO_POINT), mode="drop"
        ),
    )

    # --- distinctive descriptors, window-local (ref MapPoint::
    # ComputeDistinctiveDescriptors via LocalMapping::ProcessNewKeyFrame,
    # cc:163-211, which recomputes only points touched by the new keyframe).
    # The full-map variant (keyframe_ops.distinctive_descriptors) needs 8
    # serial scatter-min passes over (K·N); here the BA window's
    # observation table is already compact, so one scatter into an
    # (L, C, 8) table + a medoid popcount suffices. Window observations
    # dominate each local point's lifetime, so the medoid matches the
    # reference's all-observations median closely.
    C = ba_window
    desc_w = m.kf_kp_desc[win_ids]                       # (C, N, 8)
    obs_keep = jnp.where(keep_obs, obs_l, ms.NO_POINT)   # post-BA inlier obs
    slot = jnp.where(obs_keep >= 0, obs_keep, L)         # (C, N) local ids
    c_idx = jax.lax.broadcasted_iota(jnp.int32, slot.shape, 0)
    Dw = jnp.zeros((L + 1, C, 8), jnp.uint32).at[slot, c_idx].set(
        desc_w, mode="drop"
    )
    Hw = jnp.zeros((L + 1, C), bool).at[slot, c_idx].set(True, mode="drop")
    x = jnp.bitwise_xor(Dw[:, :, None, :], Dw[:, None, :, :])
    dmat = jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
    dmat = jnp.where(Hw[:, :, None] & Hw[:, None, :], dmat, 0)
    sums = jnp.where(Hw, jnp.sum(dmat, axis=2), jnp.int32(1 << 30))
    best = jnp.argmin(sums, axis=1)
    new_desc = jnp.take_along_axis(Dw, best[:, None, None], axis=1)[:, 0]  # (L+1, 8)
    upd = Hw.any(axis=1)[:L] & l_valid
    m = m._replace(
        pt_desc=m.pt_desc.at[jnp.where(upd, local_idx, P)].set(
            new_desc[:L], mode="drop"
        )
    )
    # update_desc=False: the medoid above is strictly better than the
    # refresh's first-KF fallback and must not be clobbered.
    m = ms.refresh_point_stats(m, scale=scale, n_levels=n_levels, update_desc=False)

    # --- keyframe culling: one most-redundant candidate per insertion ---
    # Candidates are the new keyframe's top-covisibility neighbors ONLY — the
    # reference culls among the current keyframe's covisible locals
    # (LocalMapping::KeyFrameCulling iterates GetVectorCovisibleKeyFrames(),
    # cc:562-571), and restricting the redundancy gather to 32 rows instead
    # of all 256 cuts the per-insertion (K,N) gather cost (round-5 profile).
    # The newest keyframes are protected: in slow sweeps every fresh keyframe
    # is instantly "redundant" (its tracked points are all re-observations),
    # but culling it starves triangulation of recent baselines and the map
    # stops growing into newly-seen territory (the reference avoids this
    # implicitly — culling lags insertion by the LocalMapping queue).
    cull_rows = jax.lax.top_k(w_row, min(32, m.kf_capacity))[1]
    red = keyframe_ops.keyframe_redundancy(m, n_levels=n_levels, rows=cull_rows)
    protect = (cull_rows <= 1) | (cull_rows >= kf_id - 2) | (w_row[cull_rows] <= 0)
    red = jnp.where(protect, 0.0, red)
    j = jnp.argmax(red)
    worst = cull_rows[j].astype(jnp.int32)
    do_cull = red[j] > 0.9
    m_culled = ms.erase_keyframe(m, worst)
    m = jax.tree.map(lambda a, b: jnp.where(do_cull, a, b), m_culled, m)
    culled = jnp.where(do_cull, worst, -1)

    # --- compact tracking view around the new keyframe (track_view.
    # compute_track_view folded in): the host previously dispatched it as a
    # separate program that rebuilt the FULL covisibility matrix; reusing
    # w_row for the neighbor ranking makes it nearly free here and removes a
    # dispatch from the insertion sequence. Same w_row approximation as the
    # fusion/BA-window selection above.
    from gf_orb_slam_tpu.pipeline import track_view as tv

    P = m.pt_capacity
    w_view = w_row.at[kf_id].set(jnp.int32(1 << 30))
    _, view_kfs = jax.lax.top_k(w_view, 12)
    member = jnp.zeros((P,), bool)
    for i in range(12):
        vk = view_kfs[i]
        obs_v = m.kf_obs_point[vk]
        ok_v = (obs_v >= 0) & m.kf_valid[vk] & (w_view[vk] > 0)
        member = member.at[jnp.where(ok_v, obs_v, P)].set(True, mode="drop")
    member = member & m.pt_valid
    order_v = jnp.where(member, jnp.arange(P, dtype=jnp.int32), P)
    vids = -jax.lax.top_k(-order_v, view_size)[0]
    v_valid = vids < P
    safe_v = jnp.minimum(vids, P - 1)
    view = tv.TrackView(
        ids=jnp.where(v_valid, vids, P).astype(jnp.int32),
        valid=v_valid,
        desc=m.pt_desc[safe_v],
        normal=m.pt_normal[safe_v],
        min_dist=m.pt_min_dist[safe_v],
        max_dist=m.pt_max_dist[safe_v],
    )

    return InsertResult(
        m=m, kf_id=kf_id, culled_kf=culled, view=view,
        n_ref=jnp.sum((obs_point >= 0).astype(jnp.int32)),
    )
