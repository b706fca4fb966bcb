"""Bundle adjustment via Levenberg–Marquardt with Schur-complement reduction.

Replaces g2o's BlockSolver + Cholmod pipeline used by
Optimizer::LocalBundleAdjustment (src/Optimizer.cc:1515-1764) and
GlobalBundleAdjustemnt (cc:28-142): points are marginalized exactly like the
reference's setMarginalized(true) pattern, but as *batched 3×3 closed-form
inversions* and one dense reduced-camera-system contraction that maps straight
onto matrix units, instead of sparse Cholesky.

Problem layout (fixed shapes, mask-gated):
  poses      (C, 7)  — T_cw camera poses; `fixed` (C,) bool freezes cameras
  points     (P, 3)  — world points
  obs_uv     (C, N, 2), obs_point (C, N) int32 local point ids (−1 = none),
  obs_w      (C, N)  — per-observation information weight (1/σ²; 0 disables)
The (C, N) edge layout comes directly from MapState.kf_obs_point — at most
one observation per (camera, point) pair, which makes W_{c,p} blocks unique
and the Schur contraction dense-regular.

Two-stage schedule follows the reference: 5 LM iters → chi² outlier pruning
(5.991) → 10 more iters (LocalMapping's mbAbortBA early-exit becomes simply
a smaller static iteration count configured by the caller).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam_tpu.geometry import linalg, se3
from gf_orb_slam_tpu.geometry.camera import CameraModel, project, projection_jacobian
from gf_orb_slam_tpu.geometry.quat import q2r, qnormalize

HUBER2 = 5.991


class BAProblem(NamedTuple):
    poses: jnp.ndarray      # (C, 7)
    points: jnp.ndarray     # (P, 3)
    fixed: jnp.ndarray      # (C,) bool
    point_valid: jnp.ndarray  # (P,) bool
    obs_uv: jnp.ndarray     # (C, N, 2)
    obs_point: jnp.ndarray  # (C, N) int32 local point id or −1
    obs_w: jnp.ndarray      # (C, N) information weight (0 = inactive)


class BAResult(NamedTuple):
    poses: jnp.ndarray
    points: jnp.ndarray
    obs_active: jnp.ndarray  # (C, N) surviving observations
    cost: jnp.ndarray


def _edge_terms(cam: CameraModel, poses, points, obs_uv, obs_point, active):
    """Residuals + Jacobians for every (c, n) edge."""
    P = points.shape[0]
    lp = jnp.maximum(obs_point, 0)
    Xw = points[lp]                                   # (C, N, 3)
    xc = se3.transform_point(poses[:, None, :], Xw)   # (C, N, 3)
    uv_hat, _, front = project(cam, xc)
    r = obs_uv - uv_hat                               # (C, N, 2)
    Jp = projection_jacobian(cam, xc)                 # (C, N, 2, 3)
    Jpose = jnp.concatenate([Jp, -Jp @ se3.hat(xc)], axis=-1)  # (C, N, 2, 6) = dh/dξ
    R_cw = q2r(qnormalize(poses[:, :4]))              # (C, 3, 3)
    Jpt = jnp.einsum("cnij,cjk->cnik", Jp, R_cw)      # (C, N, 2, 3) = dh/dXw
    ok = active & front & (obs_point >= 0)
    return r, Jpose, Jpt, ok


def _robust_w(r, obs_w, ok):
    chi2 = jnp.sum(r * r, axis=-1) * obs_w
    hub = jnp.where(chi2 > HUBER2, jnp.sqrt(HUBER2 / jnp.maximum(chi2, 1e-12)), 1.0)
    return jnp.where(ok, obs_w * hub, 0.0), chi2


def _cost(cam, poses, points, obs_uv, obs_point, obs_w, active):
    r, _, _, ok = _edge_terms(cam, poses, points, obs_uv, obs_point, active)
    chi2 = jnp.sum(r * r, axis=-1) * obs_w
    rho = jnp.where(
        chi2 <= HUBER2, chi2, 2.0 * jnp.sqrt(HUBER2 * jnp.maximum(chi2, 1e-12)) - HUBER2
    )
    return jnp.sum(jnp.where(ok, rho, 0.0))


def _lm_step(cam: CameraModel, prob: BAProblem, active, lam):
    """One damped Schur-reduced Gauss-Newton step.

    Returns (dξ (C,6), dX (P,3), cost-at-current-state): the Huber cost is
    derived from the residuals this step already computed, so the LM accept
    test needs only ONE extra residual pass (at the proposed state) instead
    of two — same reuse as pose_opt.lm_iter (round-4 lesson: latency-bound
    scan bodies amplify recomputed subexpressions)."""
    C, N = prob.obs_point.shape
    P = prob.points.shape[0]
    r, Jpose, Jpt, ok = _edge_terms(
        cam, prob.poses, prob.points, prob.obs_uv, prob.obs_point, active
    )
    w, chi2 = _robust_w(r, prob.obs_w, ok)  # fixed cams keep weight: they still constrain points
    rho = jnp.where(
        chi2 <= HUBER2, chi2, 2.0 * jnp.sqrt(HUBER2 * jnp.maximum(chi2, 1e-12)) - HUBER2
    )
    cost_here = jnp.sum(jnp.where(ok, rho, 0.0))

    lp = jnp.maximum(prob.obs_point, 0)

    # Camera blocks U (C,6,6) and gradient g_c (C,6).
    U = jnp.einsum("cnri,cn,cnrj->cij", Jpose, w, Jpose)
    g_c = jnp.einsum("cnri,cn,cnr->ci", Jpose, w, r)

    # Per-edge point-block terms, reduced onto points below.
    Vscat = jnp.einsum("cnri,cn,cnrj->cnij", Jpt, w, Jpt)
    gp_scat = jnp.einsum("cnri,cn,cnr->cni", Jpt, w, r)

    # Per-edge W blocks (C,N,6,3); fixed cameras contribute no pose rows.
    W_edge = jnp.einsum("cnri,cn,cnrj->cnij", Jpose, w, Jpt)
    W_edge = jnp.where(prob.fixed[:, None, None, None], 0.0, W_edge)

    # One flat 1-D scatter-add reduces V, g_p and T at once: each edge's
    # payload (30 floats: [Vscat (9) | g_p (3) | W_edge (18)]) lands at row
    # p·C + c of a (P·C, 30) table. (camera, point) pairs are unique (at most
    # one observation per pair, see module docstring), so the scatter is
    # contention-free; this replaces a per-camera (N, P)-one-hot matmul loop
    # that cost C dense passes over the full point table.
    payload = jnp.concatenate(
        [Vscat.reshape(C, N, 9), gp_scat, W_edge.reshape(C, N, 18)], axis=-1
    )  # (C, N, 30)
    c_iota = jax.lax.broadcasted_iota(jnp.int32, (C, N), 0)
    flat = jnp.where(ok, lp * C + c_iota, P * C)
    M = jnp.zeros((P * C, 30), payload.dtype).at[flat.reshape(-1)].add(
        payload.reshape(-1, 30), mode="drop"
    ).reshape(P, C, 30)
    V = jnp.sum(M[:, :, :9], axis=1).reshape(P, 3, 3)
    g_p = jnp.sum(M[:, :, 9:12], axis=1)
    T = M[:, :, 12:30].reshape(P, C, 6, 3)

    # Damping (Levenberg: scale diagonals).
    U_d = U + lam * jnp.eye(6)[None] * jnp.maximum(
        jnp.diagonal(U, axis1=-2, axis2=-1), 1e-6
    )[:, :, None] * jnp.eye(6)[None]
    V_d = V + lam * jnp.eye(3)[None] * jnp.maximum(
        jnp.diagonal(V, axis1=-2, axis2=-1), 1e-6
    )[:, :, None] * jnp.eye(3)[None]
    V_d = V_d + 1e-8 * jnp.eye(3)[None]
    Vinv = linalg.inv3(V_d)
    Vinv = jnp.where(prob.point_valid[:, None, None], Vinv, 0.0)

    # Schur complement S = U − Σ_p Y_p W_pᵀ with Y = T·V⁻¹.
    Y = jnp.einsum("pcij,pjk->pcik", T, Vinv)
    S_off = jnp.einsum("pcij,pdkj->cidk", Y, T)  # (C,6,C,6)
    S = -S_off
    diag_idx = jnp.arange(C)
    S = S.at[diag_idx, :, diag_idx, :].add(U_d)
    b = g_c - jnp.einsum("pcij,pj->ci", Y, g_p)

    # Freeze fixed cameras: identity rows/cols, zero rhs.
    free = ~prob.fixed
    free_f = free.astype(S.dtype)
    S = S * free_f[:, None, None, None] * free_f[None, None, :, None]
    S = S.at[diag_idx, :, diag_idx, :].add(
        jnp.eye(6)[None] * jnp.where(prob.fixed, 1.0, 0.0)[:, None, None]
    )
    b = b * free_f[:, None]

    Sd = S.reshape(C * 6, C * 6)
    Sd = Sd + 1e-8 * jnp.eye(C * 6)
    delta_c = jnp.linalg.solve(Sd, b.reshape(-1)).reshape(C, 6)

    # Back-substitute points: δX = V⁻¹ (g_p − Σ_c W_pᵀ δξ_c).
    delta_p = jnp.einsum(
        "pij,pj->pi", Vinv, g_p - jnp.einsum("pcij,ci->pj", T, delta_c)
    )
    delta_p = jnp.where(prob.point_valid[:, None], delta_p, 0.0)
    return delta_c, delta_p, cost_here


def _apply(prob: BAProblem, delta_c, delta_p):
    new_poses = jax.vmap(se3.apply_left_update)(delta_c, prob.poses)
    new_poses = jnp.where(prob.fixed[:, None], prob.poses, new_poses)
    return new_poses, prob.points + delta_p


@partial(jax.jit, static_argnames=("cam", "iters_stage1", "iters_stage2"))
def bundle_adjust(
    cam: CameraModel,
    prob: BAProblem,
    iters_stage1: int = 5,
    iters_stage2: int = 10,
    chi2_prune: float = HUBER2,
) -> BAResult:
    """Two-stage robust BA (ref LocalBundleAdjustment's 5-then-10 schedule
    with inter-stage outlier pruning, Optimizer.cc:1672-1723)."""

    def lm_iter(carry, _):
        poses, points, active, lam = carry
        p = prob._replace(poses=poses, points=points)
        dc, dp, c_old = _lm_step(cam, p, active, lam)
        new_poses, new_points = _apply(p, dc, dp)
        c_new = _cost(cam, new_poses, new_points, prob.obs_uv, prob.obs_point, prob.obs_w, active)
        good = c_new < c_old
        poses = jnp.where(good, new_poses, poses)
        points = jnp.where(good, new_points, points)
        lam = jnp.where(good, jnp.maximum(lam * 0.4, 1e-9), jnp.minimum(lam * 5.0, 1e5))
        return (poses, points, active, lam), None

    active0 = (prob.obs_point >= 0) & (prob.obs_w > 0)
    lam0 = jnp.asarray(1e-4, prob.poses.dtype)

    (poses, points, active, _), _ = jax.lax.scan(
        lm_iter, (prob.poses, prob.points, active0, lam0), None, length=iters_stage1
    )

    # Outlier pruning between stages.
    r, _, _, ok = _edge_terms(cam, poses, points, prob.obs_uv, prob.obs_point, active0)
    chi2 = jnp.sum(r * r, axis=-1) * prob.obs_w
    active1 = active0 & ok & (chi2 <= chi2_prune)

    (poses, points, active, _), _ = jax.lax.scan(
        lm_iter, (poses, points, active1, lam0), None, length=iters_stage2
    )

    # Final inlier classification.
    r, _, _, ok = _edge_terms(cam, poses, points, prob.obs_uv, prob.obs_point, active1)
    chi2 = jnp.sum(r * r, axis=-1) * prob.obs_w
    final_active = active1 & ok & (chi2 <= chi2_prune)
    cost = _cost(cam, poses, points, prob.obs_uv, prob.obs_point, prob.obs_w, final_active)
    return BAResult(poses=poses, points=points, obs_active=final_active, cost=cost)
