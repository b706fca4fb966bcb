"""Per-frame tracking programs (reference src/Tracking.cc:461-917 GrabImage
path): motion-model tracking, local-map tracking with optional Good-Feature
selection, and the keyframe decision.

Each function here is one jitted fixed-shape program; the host state machine
(pipeline/system.py) sequences them. The reference's wall-clock budgets
(matrix build, selection and matching caps) become static compute
budgets: candidate counts, selection rounds, and iteration counts fixed at
trace time.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam_tpu.geometry import se3
from gf_orb_slam_tpu.geometry.camera import CameraModel, project
from gf_orb_slam_tpu.gf import observability, selection
from gf_orb_slam_tpu.mapping import map_state as ms
from gf_orb_slam_tpu.mapping.frame import FrameData
from gf_orb_slam_tpu.ops import matching
from gf_orb_slam_tpu.solvers import pose_opt

NO_POINT = ms.NO_POINT


class TrackResult(NamedTuple):
    pose: jnp.ndarray        # (7,) refined T_cw
    obs_point: jnp.ndarray   # (N,) map-point id per keypoint (post-opt inliers)
    n_matches: jnp.ndarray   # () int32 — tentative matches fed to the optimizer
    n_inliers: jnp.ndarray   # () int32
    ok: jnp.ndarray          # () bool — thresholds passed


def _level_sigma2(scale: float, n_levels: int):
    return jnp.asarray([scale ** (2 * i) for i in range(n_levels)], jnp.float32)


def _predict_octave(dist, max_dist, scale: float, n_levels: int):
    """ref MapPoint::PredictScale: level from distance ratio."""
    ratio = jnp.maximum(max_dist / jnp.maximum(dist, 1e-9), 1e-9)
    return jnp.clip(
        jnp.ceil(jnp.log(ratio) / jnp.log(scale)).astype(jnp.int32), 0, n_levels - 1
    )


@partial(jax.jit, static_argnames=("cam", "scale", "n_levels", "radius", "min_inliers"))
def track_with_motion_model(
    cam: CameraModel,
    m: ms.MapState,
    frame: FrameData,
    pose_pred: jnp.ndarray,
    last_obs_point: jnp.ndarray,   # (N,) point ids matched in the previous frame
    last_uv: jnp.ndarray,          # (N, 2) their pixel locations last frame
    scale: float = 1.2,
    n_levels: int = 8,
    radius: float = 15.0,
    min_inliers: int = 10,
) -> TrackResult:
    """ref Tracking::TrackWithMotionModel (cc:1506-1645): project last frame's
    map points through the constant-velocity pose prediction, search ±radius,
    pose-optimize, scrub outliers."""
    N = frame.capacity
    lp = jnp.maximum(last_obs_point, 0)
    has_pt = (last_obs_point >= 0) & m.pt_valid[lp]
    pts = m.pt_pos[lp]

    xc = se3.transform_point(pose_pred, pts)
    uv_proj, depth, front = project(cam, xc)
    proj_ok = has_pt & front

    # Octave-scaled search radius around the projection.
    pred_oct = _predict_octave(
        jnp.linalg.norm(pts - se3.pose_t(se3.inverse(pose_pred))[None, :], axis=-1),
        m.pt_max_dist[lp], scale, n_levels,
    )
    sf = jnp.asarray([scale**i for i in range(n_levels)])
    rad = radius * sf[pred_oct]

    pmask = matching.projection_mask(
        uv_proj, proj_ok, frame.uv, frame.octave, frame.valid, rad, pred_oct
    )
    res = matching.match(
        m.pt_desc[lp], frame.desc, pmask,
        max_dist=matching.TH_HIGH, ratio=0.9, mutual=True,
    )
    hit = res.matched & proj_ok

    # Scatter point ids onto the frame's keypoint slots.
    obs = jnp.full((N,), NO_POINT, jnp.int32)
    obs = obs.at[jnp.where(hit, res.idx, N)].set(
        jnp.where(hit, last_obs_point, 0), mode="drop"
    )
    n_matches = jnp.sum((obs >= 0).astype(jnp.int32))

    # Pose optimization over the matched observations.
    op = jnp.maximum(obs, 0)
    valid_obs = obs >= 0
    sigma2 = _level_sigma2(scale, n_levels)[frame.octave]
    result = pose_opt.optimize_pose(
        cam, pose_pred, m.pt_pos[op], frame.uv, 1.0 / sigma2, valid_obs
    )
    obs_final = jnp.where(result.inliers, obs, NO_POINT)
    ok = (n_matches >= 20) & (result.n_inliers >= min_inliers)
    return TrackResult(
        pose=result.pose,
        obs_point=obs_final,
        n_matches=n_matches,
        n_inliers=result.n_inliers,
        ok=ok,
    )


class LocalMapTrackResult(NamedTuple):
    pose: jnp.ndarray
    obs_point: jnp.ndarray
    n_inliers: jnp.ndarray
    ok: jnp.ndarray
    local_points: jnp.ndarray   # (P,) bool — the local map used
    gf_selected: jnp.ndarray    # (P,) bool — GF-selected subset (all-False if off)
    visible_points: jnp.ndarray  # (P,) bool — frustum-visible this frame
    found_points: jnp.ndarray    # (P,) bool — matched this frame
    n_total: jnp.ndarray        # () int32 — inliers + deferred matches (ref
                                # lmk_num_BA = refTrack + nMatched, Tracking.cc:3143)


@partial(
    jax.jit,
    static_argnames=(
        "cam", "scale", "n_levels", "radius", "min_inliers", "gf_budget", "use_gf",
        "gf_mode", "gf_batch",
    ),
)
def track_local_map(
    cam: CameraModel,
    m: ms.MapState,
    view,                       # track_view.TrackView — compact local-map snapshot
    frame: FrameData,
    pose: jnp.ndarray,
    obs_point: jnp.ndarray,     # (N,) current matches from initial tracking (global ids)
    Xv: jnp.ndarray,            # (13,) PWLS state for GF Jacobians
    gf_key: jnp.ndarray,
    scale: float = 1.2,
    n_levels: int = 8,
    radius: float = 3.0,
    min_inliers: int = 15,
    gf_budget: int = 100,
    use_gf: bool = False,
    gf_mode: str = "subset",
    gf_batch: int = 1,
    dt: jnp.ndarray | float = 0.05,
) -> LocalMapTrackResult:
    """ref Tracking::TrackLocalMap (cc:2732-2830) + SearchReferencePointsInFrustum
    (cc:3149-3360), over the compact per-keyframe TrackView: frustum-filter the
    ~4k candidates, optionally restrict by Max-logDet GF selection (subset or
    active mode), match by projection, optimize the pose.

    `dt` is the PWLS segment duration, used only by gf_mode="hybrid" for the
    [H; H·F] 13×13 stacking (ref Observability.cc:236-245).
    """
    N = frame.capacity
    P = m.pt_capacity
    V = view.capacity
    safe_ids = jnp.minimum(view.ids, P - 1)

    pos_v = m.pt_pos[safe_ids]                            # (V, 3)
    valid_v = view.valid & m.pt_valid[safe_ids]

    # Exclude candidates already matched by the initial tracking stage.
    cur_mask = jnp.zeros((P,), bool).at[jnp.maximum(obs_point, 0)].max(obs_point >= 0)
    search_v = valid_v & ~cur_mask[safe_ids]

    # --- frustum check (ref Frame::isInFrustum) over the view ---
    xc = se3.transform_point(pose, pos_v)
    uv_proj, depth, front = project(cam, xc)
    center = se3.pose_t(se3.inverse(pose))
    vec = pos_v - center[None, :]
    dist = jnp.linalg.norm(vec, axis=-1)
    cos_view = jnp.sum(vec * view.normal, axis=-1) / jnp.maximum(dist, 1e-9)
    in_img = (
        (uv_proj[:, 0] >= 0) & (uv_proj[:, 0] < cam.width)
        & (uv_proj[:, 1] >= 0) & (uv_proj[:, 1] < cam.height)
    )
    in_range = (dist >= view.min_dist) & (dist <= view.max_dist)
    visible = search_v & front & in_img & in_range & (cos_view > 0.5)

    # Predicted pyramid octave per candidate (ref MapPoint::PredictScale) —
    # used both for the octave-scaled search radius below and for the
    # octave-leveled measurement-noise whitening of the GF info blocks.
    pred_oct = _predict_octave(dist, view.max_dist, scale, n_levels)
    lvl_sigma2 = _level_sigma2(scale, n_levels)

    # --- optional budgeted selection over the visible candidates ---
    # gf_mode: "subset"   exact Max-logDet greedy (determinant-lemma kernel,
    #                     gf/selection.py) seeded with the tracking info prior
    #          "hybrid"   same, over 13×13 [H; H·F] two-segment PWLS factors
    #                     (ref Observability.cc:236-245 hybrid matrices)
    #          "lazier"   the reference's lazier-greedy random-subsampling
    #                     variant (Observability.cc:2815, for parity/ablation)
    #          "auto"     budget discovered from the marginal gain floor
    #                     (ref maxVolAutomatic_*); gf_budget caps it
    #          "active"   select-then-match by marginal logDet gain
    #          "random"   budget-size random subset (ref runBaselineMapMatching
    #                     RANDOM_MAP_MATCHING baseline, Observability.cc:1819)
    #          "longlive" budget oldest-first by first observing keyframe (ref
    #                     LONGLIVE_MAP_MATCHING baseline)
    if use_gf and gf_mode in ("subset", "auto", "active", "hybrid", "lazier"):
        jac = observability.measurement_jacobians(cam, Xv, pos_v)
        # Octave-leveled noise whitening (ref reWeightInfoMat with
        # WITH_OCT_LEVELED_NOISE, Observability.h:517-570): a candidate
        # expected at pyramid level ℓ carries measurement noise σ² = s^{2ℓ},
        # so its info contribution is scaled by 1/σ² — coarse-level points
        # count less in the Max-logDet objective, as in the shipped reference
        # config (SURVEY §5 #define set).
        H_w = observability.whiten(jac.H, lvl_sigma2[pred_oct])
        vis_j = jac.visible & valid_v
        if gf_mode == "hybrid":
            from gf_orb_slam_tpu.geometry import pwls

            F = pwls.f_matrix(Xv, jnp.asarray(dt, pose.dtype))
            factors = observability.hybrid_factors(H_w, F, vis_j)
        else:
            factors = jnp.where(vis_j[:, None, None], H_w, 0.0)
        if gf_mode in ("auto", "active", "lazier"):
            blocks = jnp.einsum("nri,nrj->nij", factors, factors)
    if use_gf and gf_mode in ("subset", "hybrid", "active"):
        # Info prior from the initial-tracking matches (ref FRAME_MATCHING_
        # INFO_PRIOR, Tracking.h:91; Observability.cc:556-644): selection adds
        # information where the current match set is weakest.
        op0 = jnp.maximum(obs_point, 0)
        jac_cur = observability.measurement_jacobians(cam, Xv, m.pt_pos[op0])
        # Current matches live at known keypoint octaves — whiten by the
        # keypoint's actual level noise (same reWeightInfoMat convention).
        Hc = observability.whiten(jac_cur.H, lvl_sigma2[frame.octave])
        Hc = jnp.where(
            (jac_cur.visible & (obs_point >= 0))[:, None, None], Hc, 0.0
        )
        info_prior7 = jnp.einsum("nri,nrj->ij", Hc, Hc)
    if use_gf and gf_mode in ("subset", "hybrid"):
        if gf_mode == "hybrid":
            prior = jnp.zeros((13, 13), info_prior7.dtype).at[0:7, 0:7].set(
                info_prior7
            )
        else:
            prior = info_prior7
        sel = selection.greedy_maxlogdet_lowrank(
            factors, visible & jac.visible, k=gf_budget, batch=gf_batch,
            info_prior=prior,
        )
        match_v = sel.selected
        gf_sel_v = sel.selected
    elif use_gf and gf_mode == "lazier":
        sel = selection.lazier_greedy_maxlogdet(
            blocks, visible & jac.visible, k=gf_budget, key=gf_key,
            batch=gf_batch,
        )
        match_v = sel.selected
        gf_sel_v = sel.selected
    elif use_gf and gf_mode == "auto":
        sel = selection.auto_maxlogdet(
            blocks, visible & jac.visible, k_max=gf_budget, key=gf_key,
        )
        match_v = sel.selected
        gf_sel_v = sel.selected
    elif use_gf and gf_mode in ("random", "longlive"):
        if gf_mode == "random":
            pri = jax.random.uniform(gf_key, (V,))
        else:
            # Older points first (smaller first_kf); ids break ties.
            age = m.pt_first_kf[safe_ids].astype(jnp.float32)
            pri = -(age + safe_ids.astype(jnp.float32) / jnp.float32(P))
        pri = jnp.where(visible, pri, -jnp.inf)
        kth = jax.lax.top_k(pri, min(gf_budget, V))[0][-1]
        match_v = visible & (pri >= kth) & jnp.isfinite(pri)
        gf_sel_v = match_v
    else:
        match_v = visible
        gf_sel_v = jnp.zeros((V,), bool)

    # --- projection matching of candidates into the frame ---
    # ALL frustum-visible candidates are matched, not just the GF subset: the
    # dense masked Hamming kernel costs the same either way, and the deferred
    # (non-selected) matches are what the reference's DELAYED_MAP_MATCHING
    # recovers in the post-publish slack (Tracking.cc:854-893,3097-3141 →
    # SearchByProjection_Budget ORBmatcher.cc:276). The GF budget still caps
    # the pose-LM observation set below — the latency-critical path — while
    # keyframes keep full observation richness (lmk_num_BA = refTrack +
    # nMatched, Tracking.cc:3143).
    sf = jnp.asarray([scale**i for i in range(n_levels)])
    rad = radius * sf[pred_oct]
    rad = jnp.where(cos_view < 0.998, rad * (5.0 / 3.0), rad)

    free_kp = frame.valid & (obs_point == NO_POINT)
    pmask = matching.projection_mask(
        uv_proj, visible, frame.uv, frame.octave, free_kp, rad, pred_oct
    )
    res = matching.match(
        view.desc, frame.desc, pmask, max_dist=matching.TH_HIGH, ratio=0.8,
        mutual=True,
    )
    hit_all = res.matched & visible
    hit = hit_all & match_v

    if use_gf and gf_mode == "active":
        # Select-then-match by marginal logDet gain (ref runActiveMapMatching),
        # seeded with the shared tracking info prior computed above.
        from gf_orb_slam_tpu.gf import active_matching as am

        act = am.active_match(
            blocks, visible & jac.visible, hit, res.idx, info_prior7,
            budget=gf_budget,
        )
        hit = act.matched
        gf_sel_v = act.matched

    # Scatter: frame keypoint slot ← global point id.
    obs = obs_point
    obs = obs.at[jnp.where(hit, res.idx, N)].set(
        jnp.where(hit, view.ids, 0), mode="drop"
    )

    # --- pose optimization over the (budgeted) matches (global gather) ---
    op = jnp.maximum(obs, 0)
    valid_obs = obs >= 0
    sigma2 = _level_sigma2(scale, n_levels)[frame.octave]
    result = pose_opt.optimize_pose(
        cam, pose, m.pt_pos[op], frame.uv, 1.0 / sigma2, valid_obs
    )
    obs_final = jnp.where(result.inliers, obs, NO_POINT)

    # --- deferred matches (ref DELAYED_MAP_MATCHING): candidates matched by
    # the dense kernel but excluded from the pose LM by the GF budget. They
    # are chi2-gated against the REFINED pose (the reference validates its
    # post-publish matches through the next frame's optimization; gating here
    # is the single-program equivalent) and merged into the observation set,
    # so keyframes record full-density observations regardless of budget.
    # mutual=True makes res.idx injective over matched rows, so deferred and
    # selected hits occupy disjoint keypoint slots by construction.
    hit_def = hit_all & ~hit
    obs_def = jnp.full((N,), NO_POINT, jnp.int32).at[
        jnp.where(hit_def, res.idx, N)
    ].set(jnp.where(hit_def, view.ids, 0), mode="drop")
    dp = jnp.maximum(obs_def, 0)
    xc_d = se3.transform_point(result.pose, m.pt_pos[dp])
    uv_hat_d, _, front_d = project(cam, xc_d)
    r_d = frame.uv - uv_hat_d
    chi2_d = jnp.sum(r_d * r_d, axis=-1) / sigma2
    keep_d = (obs_def >= 0) & front_d & (chi2_d < pose_opt.HUBER_DELTA2)
    obs_final = jnp.where((obs_final == NO_POINT) & keep_d, obs_def, obs_final)

    # (P,)-shaped reporting masks via scatter from the view / frame.
    def scatter_p(mask_v):
        return jnp.zeros((P,), bool).at[jnp.where(mask_v, view.ids, P)].set(
            True, mode="drop"
        )

    found = jnp.zeros((P,), bool).at[jnp.maximum(obs_final, 0)].max(obs_final >= 0)
    ok = result.n_inliers >= min_inliers
    return LocalMapTrackResult(
        pose=result.pose,
        obs_point=obs_final,
        n_inliers=result.n_inliers,
        ok=ok,
        local_points=scatter_p(valid_v),
        gf_selected=scatter_p(gf_sel_v),
        visible_points=scatter_p(visible),
        found_points=found,
        n_total=jnp.sum((obs_final >= 0).astype(jnp.int32)),
    )


class FusedTrackResult(NamedTuple):
    """Everything the host needs from one WORKING-state frame — returned from
    a single device program so per-frame dispatch/sync cost is one call."""

    pose: jnp.ndarray          # (7,)
    obs_point: jnp.ndarray     # (N,)
    frame_uv: jnp.ndarray      # (N, 2) undistorted keypoints (for next frame)
    frame_octave: jnp.ndarray  # (N,)
    frame_angle: jnp.ndarray   # (N,)
    frame_desc: jnp.ndarray    # (N, 8)
    frame_valid: jnp.ndarray   # (N,)
    n_inliers: jnp.ndarray     # () int32
    ok: jnp.ndarray            # () bool — both stages passed
    velocity: jnp.ndarray      # (7,) updated T_cur_last
    pt_visible_add: jnp.ndarray  # (P,) bool — this frame's visibility
    pt_found_add: jnp.ndarray    # (P,) bool
    pt_visible: jnp.ndarray    # (P,) int32 — already-incremented counters
    pt_found: jnp.ndarray      # (P,) int32
    n_total: jnp.ndarray       # () int32 — LM inliers + deferred matches
    next_key: jnp.ndarray      # (2,) uint32 — rolling per-frame PRNG key for
                               # the next frame (incremented on device: a
                               # host-built key is one h2d transfer per
                               # tracked frame)


@partial(
    jax.jit,
    static_argnames=("cam", "orb_cfg", "scale", "n_levels", "gf_budget", "use_gf", "gf_mode", "gf_batch"),
)
def track_frame_fused(
    cam: CameraModel,
    orb_cfg,
    m: ms.MapState,
    view,
    img: jnp.ndarray,
    last_pose: jnp.ndarray,
    last_obs: jnp.ndarray,
    last_uv: jnp.ndarray,
    velocity: jnp.ndarray,
    dt: jnp.ndarray,
    key: jnp.ndarray,
    scale: float = 1.2,
    n_levels: int = 8,
    gf_budget: int = 100,
    use_gf: bool = False,
    gf_mode: str = "subset",
    gf_batch: int = 1,
) -> FusedTrackResult:
    """The whole per-frame WORKING path as ONE program: ORB extraction →
    motion-model tracking (with built-in wide-radius retry) → local-map
    tracking (+ optional GF selection) → velocity update → counter deltas.

    The reference runs this as Tracking::GrabImage's hot path with many
    sequential stages (SURVEY §3.1); fusing it means XLA schedules extraction
    convolutions, Hamming matmuls, and LM solves in one graph, and the host
    pays one dispatch + one scalar readback per frame.
    """
    from gf_orb_slam_tpu.mapping.frame import make_frame

    frame = make_frame(img, cam, orb_cfg)
    pose_pred = se3.compose(velocity, last_pose)

    r1 = track_with_motion_model(
        cam, m, frame, pose_pred, last_obs, last_uv,
        scale=scale, n_levels=n_levels, radius=15.0,
    )

    # Fallback: widened search from the last pose (ref TrackPreviousFrame).
    # The reference widens only under loss alert (Tracking.cc:1534-1555);
    # lax.cond executes one branch at runtime, so a healthy frame never pays
    # for the radius-40 matcher + LM solve.
    def _wide_retry(_):
        return track_with_motion_model(
            cam, m, frame, last_pose, last_obs, last_uv,
            scale=scale, n_levels=n_levels, radius=40.0,
        )

    r = jax.lax.cond(r1.ok, lambda _: r1, _wide_retry, operand=None)
    pose1, obs1, ok1 = r.pose, r.obs_point, r.ok

    from gf_orb_slam_tpu.geometry import pwls

    t0 = jnp.asarray(0.0, pose1.dtype)
    Xv = pwls.state_from_pose_pair(t0, last_pose, t0 + dt, pose1)
    r2 = track_local_map(
        cam, m, view, frame, pose1, obs1, Xv, key,
        scale=scale, n_levels=n_levels, gf_budget=gf_budget, use_gf=use_gf,
        gf_mode=gf_mode, gf_batch=gf_batch, dt=dt,
    )
    ok = ok1 & r2.ok
    new_velocity = se3.compose(r2.pose, se3.inverse(last_pose))
    return FusedTrackResult(
        pose=r2.pose,
        obs_point=r2.obs_point,
        frame_uv=frame.uv,
        frame_octave=frame.octave,
        frame_angle=frame.angle,
        frame_desc=frame.desc,
        frame_valid=frame.valid,
        n_inliers=r2.n_inliers,
        ok=ok,
        velocity=new_velocity,
        pt_visible_add=r2.visible_points,
        pt_found_add=r2.found_points,
        pt_visible=m.pt_visible + r2.visible_points.astype(jnp.int32),
        pt_found=m.pt_found + r2.found_points.astype(jnp.int32),
        n_total=r2.n_total,
        next_key=key + jnp.asarray([0, 1], jnp.uint32),
    )


class RelocResult(NamedTuple):
    ok: jnp.ndarray          # () bool — relocalized
    pose: jnp.ndarray        # (7,)
    obs_point: jnp.ndarray   # (N,)
    n_inliers: jnp.ndarray   # () int32
    best_kf: jnp.ndarray     # () int32 — winning candidate keyframe


@partial(jax.jit, static_argnames=("cam", "scale", "n_levels", "view_size"))
def relocalize_fused(
    cam: CameraModel,
    m: ms.MapState,
    db_words: jnp.ndarray,   # (K, N) BoW word ids per keyframe keypoint
    frame: FrameData,
    words_f: jnp.ndarray,    # (N,) frame word ids
    cand: jnp.ndarray,       # (C,) candidate keyframe ids
    cand_ok: jnp.ndarray,    # (C,) bool
    key: jnp.ndarray,
    scale: float = 1.2,
    n_levels: int = 8,
    view_size: int = 4096,
):
    """ref Tracking::Relocalisation (cc:3854-4032) as ONE device program:
    every BoW candidate's gated matching + EPnP RANSAC runs vmapped, the best
    candidate wins, and the local-map densification + pose optimization runs
    on its covisibility view — replacing the reference-style host loop that
    cost several dispatch+fetch round trips per candidate per lost frame.
    Returns (RelocResult, TrackView-of-winner)."""
    from gf_orb_slam_tpu.pipeline import track_view as tv
    from gf_orb_slam_tpu.retrieval import keyframe_db as kdb
    from gf_orb_slam_tpu.solvers import pnp

    sigma2 = _level_sigma2(scale, n_levels)[frame.octave]
    C = cand.shape[0]
    keys = jax.random.split(key, C)

    def per_cand(c, ok_c, k):
        obs_c = m.kf_obs_point[c]
        has_pt = m.kf_kp_valid[c] & (obs_c >= 0)
        mask = kdb.bow_match_mask(words_f, db_words[c], frame.valid, has_pt)
        res = matching.match(
            frame.desc, m.kf_kp_desc[c], mask,
            max_dist=matching.TH_LOW, ratio=0.75, mutual=True,
        )
        pt_ids = jnp.maximum(obs_c[res.idx], 0)
        good = res.matched & (obs_c[res.idx] >= 0) & m.pt_valid[pt_ids] & ok_c
        good = good & (jnp.sum(good) >= 15)
        pr = pnp.pnp_ransac(cam, m.pt_pos[pt_ids], frame.uv, sigma2, good, k)
        obs0 = jnp.where(pr.inliers & good, obs_c[res.idx], NO_POINT)
        return pr.ok & ok_c, pr.pose, pr.n_inliers, obs0

    oks, poses, n_inl, obs0s = jax.vmap(per_cand)(cand, cand_ok, keys)
    j = jnp.argmax(jnp.where(oks, n_inl, -1))
    best_kf = cand[j]

    view = tv.compute_track_view(m, best_kf, view_size=view_size)
    Xv = jnp.zeros(13, frame.uv.dtype).at[3].set(1.0)
    r2 = track_local_map(
        cam, m, view, frame, poses[j], obs0s[j], Xv, key,
        scale=scale, n_levels=n_levels, min_inliers=25, use_gf=False,
    )
    return (
        RelocResult(
            ok=oks[j] & r2.ok, pose=r2.pose, obs_point=r2.obs_point,
            n_inliers=r2.n_inliers, best_kf=best_kf,
        ),
        view,
    )


@jax.jit
def update_point_counters(
    m: ms.MapState, visible: jnp.ndarray, found: jnp.ndarray
) -> ms.MapState:
    """ref MapPoint::IncreaseVisible/IncreaseFound bookkeeping."""
    return m._replace(
        pt_visible=m.pt_visible + visible.astype(jnp.int32),
        pt_found=m.pt_found + found.astype(jnp.int32),
    )


def need_new_keyframe(
    n_inliers: int,
    n_ref_tracked: int,
    frames_since_kf: int,
    frames_since_reloc: int,
    max_frames: int,
    min_frames: int = 0,
) -> bool:
    """ref Tracking::NeedNewKeyFrame (cc:3035-3077), host-side scalar logic:
    insert when the map is getting stale or tracking weakens vs the reference
    keyframe."""
    if frames_since_reloc < max_frames:
        return False
    c1 = frames_since_kf >= max_frames
    c2 = frames_since_kf >= min_frames and n_inliers < 0.9 * n_ref_tracked
    return (c1 or c2) and n_inliers >= 15
