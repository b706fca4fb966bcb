"""Two-view monocular bootstrap: batched H/F RANSAC + motion recovery.

Replaces src/Initializer.cc (1064 LoC): the reference runs two boost threads
computing homography and fundamental hypotheses over 200 preset 8-point RANSAC
samples, picks the model by RH = SH/(SH+SF), then reconstructs R,t
(ReconstructH: Faugeras's 8-motion decomposition; ReconstructF: the 4-motion
essential decomposition) with triangulation + cheirality + parallax gating.

Device design: the "2 threads × 200 sequential samples" become one batched
program — all S hypotheses for both models estimated and scored in parallel
(vmapped DLT via 9×9 eigh + dense [S, N] symmetric-transfer scoring), then all
4 (F) / 8 (H) motion hypotheses triangulated and scored in parallel. No
data-dependent control flow; selection is argmax + masking.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam_tpu.geometry import linalg, quat, se3
from gf_orb_slam_tpu.geometry.camera import CameraModel

SIGMA = 1.0          # ref mSigma (Initializer.h:104)
TH_H = 5.991         # chi2(2dof) — homography transfer gate
TH_F = 3.841         # chi2(1dof) — epipolar distance gate
SCORE_CLIP_H = 5.991
SCORE_CLIP_F = 5.991


class TwoViewResult(NamedTuple):
    success: jnp.ndarray     # () bool
    pose21: jnp.ndarray      # (7,) T_21: frame-1 camera → frame-2 camera
    points3d: jnp.ndarray    # (N, 3) triangulated points in frame-1 camera coords
    is_triangulated: jnp.ndarray  # (N,) bool
    used_homography: jnp.ndarray  # () bool
    n_good: jnp.ndarray      # () int32


# ---------------------------------------------------------------------------
# Model estimation (DLT), batched over hypotheses
# ---------------------------------------------------------------------------


def _dlt_homography(x1: jnp.ndarray, x2: jnp.ndarray, w: jnp.ndarray | None = None) -> jnp.ndarray:
    """DLT for H with x2 ≈ H x1; optional row weights for refitting. → (3,3)."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    z = jnp.zeros_like(u1)
    o = jnp.ones_like(u1)
    rows_a = jnp.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], axis=-1)
    rows_b = jnp.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], axis=-1)
    if w is not None:
        rows_a = rows_a * w[:, None]
        rows_b = rows_b * w[:, None]
    A = jnp.concatenate([rows_a, rows_b], axis=0)  # (2M, 9)
    h = linalg.smallest_eigvec_sym(A.T @ A)
    return h.reshape(3, 3)


def _dlt_fundamental(x1: jnp.ndarray, x2: jnp.ndarray, w: jnp.ndarray | None = None) -> jnp.ndarray:
    """DLT for F with x2ᵀ F x1 = 0, rank-2 enforced; optional row weights for
    all-inlier refitting. → (3,3)."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    o = jnp.ones_like(u1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], axis=-1
    )  # (M, 9)
    if w is not None:
        A = A * w[:, None]
    f = linalg.smallest_eigvec_sym(A.T @ A)
    F = f.reshape(3, 3)
    # Rank-2 projection via SVD.
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[2].set(0.0)
    return (U * S[None, :]) @ Vt


def _score_homography(H, uv1, uv2, mask):
    """Symmetric transfer error score (ref CheckHomography)."""
    Hinv = jnp.linalg.inv(H)

    def transfer(M, src, dst):
        ones = jnp.ones_like(src[:, :1])
        p = jnp.concatenate([src, ones], axis=-1) @ M.T
        w = jnp.where(jnp.abs(p[:, 2:3]) < 1e-8, 1e-8, p[:, 2:3])
        return jnp.sum((dst - p[:, :2] / w) ** 2, axis=-1)

    inv_s2 = 1.0 / (SIGMA * SIGMA)
    d12 = transfer(H, uv1, uv2) * inv_s2
    d21 = transfer(Hinv, uv2, uv1) * inv_s2
    ok = (d12 < TH_H) & (d21 < TH_H) & mask
    score = jnp.where(d12 < TH_H, SCORE_CLIP_H - d12, 0.0) + jnp.where(
        d21 < TH_H, SCORE_CLIP_H - d21, 0.0
    )
    return jnp.sum(jnp.where(mask, score, 0.0)), ok


def _score_fundamental(F, uv1, uv2, mask):
    """Symmetric epipolar distance score (ref CheckFundamental)."""
    ones1 = jnp.ones_like(uv1[:, :1])
    x1 = jnp.concatenate([uv1, ones1], axis=-1)
    x2 = jnp.concatenate([uv2, ones1], axis=-1)
    l2 = x1 @ F.T  # lines in image 2
    l1 = x2 @ F    # lines in image 1
    inv_s2 = 1.0 / (SIGMA * SIGMA)
    d2 = (jnp.sum(l2 * x2, axis=-1) ** 2) / jnp.maximum(
        l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12
    ) * inv_s2
    d1 = (jnp.sum(l1 * x1, axis=-1) ** 2) / jnp.maximum(
        l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12
    ) * inv_s2
    ok = (d1 < TH_F) & (d2 < TH_F) & mask
    score = jnp.where(d1 < TH_F, SCORE_CLIP_F - d1, 0.0) + jnp.where(
        d2 < TH_F, SCORE_CLIP_F - d2, 0.0
    )
    return jnp.sum(jnp.where(mask, score, 0.0)), ok


# ---------------------------------------------------------------------------
# Triangulation + hypothesis checking
# ---------------------------------------------------------------------------


def _dlt_rows(P1, P2, uv1, uv2):
    """(N, 4, 4) homogeneous DLT constraint rows for each correspondence."""
    return jnp.stack(
        [
            uv1[:, 0, None] * P1[2] - P1[0],
            uv1[:, 1, None] * P1[2] - P1[1],
            uv2[:, 0, None] * P2[2] - P2[0],
            uv2[:, 1, None] * P2[2] - P2[1],
        ],
        axis=1,
    )


def triangulate_dlt(P1: jnp.ndarray, P2: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray):
    """Linear triangulation, batched over points. P: (3,4); uv: (N,2) pixels.

    Inhomogeneous DLT: fix w=1 and solve the 4×3 least squares with
    closed-form 3×3 normal equations (linalg.inv3) — the homogeneous
    nullspace needs a batched 4×4 eigendecomposition, an iterative solver
    that dominated the keyframe-insertion program. w=1
    only degrades for near-infinity points, which the callers' parallax and
    chirality gates reject anyway (triangulate_dlt_homogeneous kept below as
    the reference oracle)."""
    A = _dlt_rows(P1, P2, uv1, uv2)                       # (N, 4, 4)
    B, a4 = A[:, :, :3], A[:, :, 3]
    BtB = jnp.einsum("nij,nik->njk", B, B)                # (N, 3, 3)
    rhs = -jnp.einsum("nij,ni->nj", B, a4)                # (N, 3)
    return jnp.einsum("njk,nk->nj", linalg.inv3(BtB), rhs)


def triangulate_dlt_homogeneous(P1, P2, uv1, uv2):
    """Nullspace (eigen) DLT — exact homogeneous solution; slow (eigh)."""
    A = _dlt_rows(P1, P2, uv1, uv2)
    M = jnp.einsum("nij,nik->njk", A, A)
    x = linalg.smallest_eigvec_sym(M)
    w = jnp.where(jnp.abs(x[:, 3]) < 1e-10, 1e-10, x[:, 3])
    return x[:, :3] / w[:, None]


def _check_rt(R, t, cam: CameraModel, uv1, uv2, mask, sigma2_reproj=4.0):
    """Count good triangulations for motion hypothesis (R, t) (ref CheckRT).

    Returns (n_good, good_mask, parallax_deg_median, points3d_cam1).
    """
    K = cam.K
    P1 = K @ jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)
    P2 = K @ jnp.concatenate([R, t[:, None]], axis=1)
    X = triangulate_dlt(P1, P2, uv1, uv2)  # cam-1 frame

    finite = jnp.all(jnp.isfinite(X), axis=-1)
    z1 = X[:, 2]
    X2 = (R @ X.T).T + t[None, :]
    z2 = X2[:, 2]

    # Parallax between viewing rays.
    O2 = -R.T @ t
    n1 = X
    n2 = X - O2[None, :]
    cosp = jnp.sum(n1 * n2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(n1, axis=-1) * jnp.linalg.norm(n2, axis=-1), 1e-12
    )

    def reproj_err(P, Xh, uv):
        ones = jnp.ones_like(Xh[:, :1])
        p = jnp.concatenate([Xh, ones], axis=-1) @ P.T
        w = jnp.where(jnp.abs(p[:, 2:3]) < 1e-8, 1e-8, p[:, 2:3])
        return jnp.sum((uv - p[:, :2] / w) ** 2, axis=-1)

    e1 = reproj_err(P1, X, uv1)
    e2 = reproj_err(P2, X, uv2)
    th2 = sigma2_reproj * SIGMA * SIGMA

    good = (
        mask
        & finite
        & (z1 > 0)
        & (z2 > 0)
        & (cosp < 0.99998)
        & (e1 < th2)
        & (e2 < th2)
    )
    n_good = jnp.sum(good.astype(jnp.int32))
    # 50th-best parallax as robustness proxy (ref takes idx-50 of sorted).
    cosp_good = jnp.where(good, cosp, 1.0)
    cos_sorted = jnp.sort(cosp_good)
    pick = jnp.minimum(jnp.int32(50), jnp.maximum(n_good - 1, 0))
    parallax_deg = jnp.degrees(jnp.arccos(jnp.clip(cos_sorted[pick], -1.0, 1.0)))
    return n_good, good, parallax_deg, X


def _motions_from_F(F, cam: CameraModel):
    """Essential decomposition → 4 (R, t) hypotheses (ref ReconstructF)."""
    K = cam.K
    E = K.T @ F @ K
    U, _, Vt = jnp.linalg.svd(E)
    # Enforce proper rotations.
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = U @ W.T @ Vt
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def _motions_from_H(H, cam: CameraModel):
    """Faugeras SVD decomposition → 8 (R, t) hypotheses (ref ReconstructH,
    Faugeras et al. 'Motion and structure from motion in a piecewise planar
    environment')."""
    K = cam.K
    A = jnp.linalg.inv(K) @ H @ K
    U, w, Vt = jnp.linalg.svd(A)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(V)
    d1, d2, d3 = w[0], w[1], w[2]

    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1s = jnp.asarray([1.0, 1.0, -1.0, -1.0]) * aux1
    x3s = jnp.asarray([1.0, -1.0, 1.0, -1.0]) * aux3

    # Case d' > 0:
    aux_stheta = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)
    ctheta = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    stheta = jnp.asarray([1.0, -1.0, -1.0, 1.0]) * aux_stheta

    def rt_pos(i):
        Rp = jnp.asarray(
            [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        )
        Rp = Rp.at[0, 0].set(ctheta).at[0, 2].set(-stheta[i]).at[2, 0].set(stheta[i]).at[2, 2].set(ctheta)
        R = s * U @ Rp @ Vt
        tp = jnp.asarray([x1s[i], 0.0, -x3s[i]]) * (d1 - d3)
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    # Case d' < 0:
    aux_sphi = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)
    cphi = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sphi = jnp.asarray([1.0, -1.0, -1.0, 1.0]) * aux_sphi

    def rt_neg(i):
        Rp = jnp.asarray(
            [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]]
        )
        Rp = Rp.at[0, 0].set(cphi).at[0, 2].set(sphi[i]).at[2, 0].set(sphi[i]).at[2, 2].set(-cphi)
        R = s * U @ Rp @ Vt
        tp = jnp.asarray([x1s[i], 0.0, x3s[i]]) * (d1 + d3)
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    Rs, ts = [], []
    for i in range(4):
        R, t = rt_pos(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = rt_neg(i)
        Rs.append(R)
        ts.append(t)
    return jnp.stack(Rs), jnp.stack(ts)


# ---------------------------------------------------------------------------
# Full initialization
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cam", "min_triangulated"))
def initialize_with_prior(
    cam: CameraModel,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    matched: jnp.ndarray,
    pose21: jnp.ndarray,
    min_triangulated: int = 50,
) -> TwoViewResult:
    """Structure-only initialization with an external motion prior (ref
    Initializer::Initialize_withRT, include/Initializer.h:68-70, enabled by
    INIT_WITH_MOTION_PRIOR; exercised by test/test_Initial.cpp): R, t are
    given (odometry/IMU), only the structure is triangulated and gated."""
    from gf_orb_slam_tpu.geometry import quat as quat_mod

    R = quat_mod.q2r(quat_mod.qnormalize(se3.pose_q(pose21)))
    t = se3.pose_t(pose21)
    n_good, good, parallax, X = _check_rt(R, t, cam, uv1, uv2, matched)
    success = n_good >= min_triangulated
    return TwoViewResult(
        success=success,
        pose21=pose21,
        points3d=X,
        is_triangulated=good,
        used_homography=jnp.asarray(False),
        n_good=n_good,
    )


@partial(jax.jit, static_argnames=("cam", "n_hypotheses", "min_triangulated"))
def initialize_two_view(
    cam: CameraModel,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    matched: jnp.ndarray,
    key: jnp.ndarray,
    n_hypotheses: int = 200,
    min_triangulated: int = 50,
) -> TwoViewResult:
    """Full two-view bootstrap on matched undistorted pixel pairs.

    uv1/uv2: (N, 2) pixel coords in frames 1/2 (slot-aligned), matched: (N,)
    mask. Mirrors Initializer::Initialize (src/Initializer.cc:44-140).
    """
    N = uv1.shape[0]

    # --- sample 8-point subsets among matched entries (Gumbel top-k trick) ---
    keys = jax.random.split(key, n_hypotheses)

    def sample_idx(k):
        g = jax.random.gumbel(k, (N,)) + jnp.where(matched, 0.0, -1e9)
        return jax.lax.top_k(g, 8)[1]

    samples = jax.vmap(sample_idx)(keys)  # (S, 8)

    # --- Hartley-normalized coordinates for conditioning ---
    n1, T1 = linalg.normalize_points_2d(uv1, matched)
    n2, T2 = linalg.normalize_points_2d(uv2, matched)

    def fit_and_score_H(idx):
        Hn = _dlt_homography(n1[idx], n2[idx])
        H = jnp.linalg.inv(T2) @ Hn @ T1
        H = H / jnp.where(jnp.abs(H[2, 2]) < 1e-10, 1e-10, H[2, 2])
        score, ok = _score_homography(H, uv1, uv2, matched)
        return score, H, ok

    def fit_and_score_F(idx):
        Fn = _dlt_fundamental(n1[idx], n2[idx])
        F = T2.T @ Fn @ T1
        score, ok = _score_fundamental(F, uv1, uv2, matched)
        return score, F, ok

    sH, Hs, okH = jax.vmap(fit_and_score_H)(samples)
    sF, Fs, okF = jax.vmap(fit_and_score_F)(samples)

    iH = jnp.argmax(sH)
    iF = jnp.argmax(sF)
    H_best, F_best = Hs[iH], Fs[iF]
    inH, inF = okH[iH], okF[iF]

    SH, SF = sH[iH], sF[iF]

    # All-inlier refit (2 rounds): the 8-point estimate is precise enough for
    # gating but too noisy in f32 for motion decomposition; re-estimating over
    # all ~N inliers recovers the lost precision. (The reference gets away
    # without this because its DLT runs in double precision.)
    for _ in range(2):
        H_ref = _dlt_homography(n1, n2, inH.astype(n1.dtype))
        H_ref = jnp.linalg.inv(T2) @ H_ref @ T1
        H_ref = H_ref / jnp.where(jnp.abs(H_ref[2, 2]) < 1e-10, 1e-10, H_ref[2, 2])
        sH_ref, inH_ref = _score_homography(H_ref, uv1, uv2, matched)
        better_h = sH_ref > SH
        H_best = jnp.where(better_h, H_ref, H_best)
        inH = jnp.where(better_h, inH_ref, inH)
        SH = jnp.maximum(sH_ref, SH)

        F_ref = _dlt_fundamental(n1, n2, inF.astype(n1.dtype))
        F_ref = T2.T @ F_ref @ T1
        sF_ref, inF_ref = _score_fundamental(F_ref, uv1, uv2, matched)
        better_f = sF_ref > SF
        F_best = jnp.where(better_f, F_ref, F_best)
        inF = jnp.where(better_f, inF_ref, inF)
        SF = jnp.maximum(sF_ref, SF)

    RH = SH / jnp.maximum(SH + SF, 1e-12)
    use_H = RH > 0.40  # ref Initializer.cc:137

    # --- motion hypotheses from both models, evaluated in parallel ---
    Rs_F, ts_F = _motions_from_F(F_best, cam)       # (4, 3, 3), (4, 3)
    Rs_H, ts_H = _motions_from_H(H_best, cam)       # (8, 3, 3), (8, 3)
    Rs = jnp.concatenate([jnp.broadcast_to(Rs_F, (4, 3, 3)), Rs_H])  # (12,3,3)
    ts = jnp.concatenate([ts_F, ts_H])

    model_mask = jnp.where(
        use_H,
        jnp.concatenate([jnp.zeros(4, bool), jnp.ones(8, bool)]),
        jnp.concatenate([jnp.ones(4, bool), jnp.zeros(8, bool)]),
    )
    inlier_mask = jnp.where(use_H, inH, inF)

    check = jax.vmap(lambda R, t: _check_rt(R, t, cam, uv1, uv2, inlier_mask))
    n_goods, goods, parallaxes, Xs = check(Rs, ts)
    n_goods = jnp.where(model_mask, n_goods, -1)

    best = jnp.argmax(n_goods)
    n_best = n_goods[best]
    # Uniqueness: no other (same-model) hypothesis within 75% of the best
    # count (ref ReconstructF's nsimilar gate) and enough parallax.
    n_second = jnp.max(jnp.where(jnp.arange(12) == best, -1, n_goods))
    n_inliers = jnp.sum(inlier_mask.astype(jnp.int32))
    # ref ReconstructF: nMinGood = max(0.9*N, minTriangulated); uniqueness via
    # the second-best hypothesis staying below 75% of the best.
    n_min_good = jnp.maximum(0.9 * n_inliers.astype(jnp.float32), float(min_triangulated))
    success = (
        (n_best.astype(jnp.float32) >= n_min_good)
        & (n_second.astype(jnp.float32) < 0.75 * n_best.astype(jnp.float32))
        & (parallaxes[best] > 1.0)
    )

    R_best, t_best = Rs[best], ts[best]
    pose21 = se3.make_pose(quat.r2q(R_best), t_best)
    return TwoViewResult(
        success=success,
        pose21=pose21,
        points3d=Xs[best],
        is_triangulated=goods[best],
        used_homography=use_H,
        n_good=n_best,
    )
