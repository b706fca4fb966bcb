"""Motion-only pose optimization: batched-residual Levenberg–Marquardt.

Replaces g2o-based Optimizer::PoseOptimization (src/Optimizer.cc:279-413) and
its GF variant PoseOptimization_Selected (cc:573-721): one SE3 vertex, unary
reprojection edges to fixed map points, Huber kernel δ=√5.991, staged
optimization with chi² outlier gating 9.21/7.378/5.991/5.991 between stages
(the reference's its[4]={10,10,7,5} rounds).

Device design: residuals/Jacobians for all N observations are one batched
program; the normal equations are a 6×6 solve. Stages and LM iterations are
lax.scan loops with static trip counts; outlier gating is a mask update, not
an edge-level setLevel. The whole optimizer jits to a single XLA program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam_tpu.geometry import se3
from gf_orb_slam_tpu.geometry.camera import CameraModel, project, projection_jacobian

CHI2_STAGES = (9.21, 7.378, 5.991, 5.991)
ITERS_PER_STAGE = (10, 10, 7, 5)
HUBER_DELTA2 = 5.991  # δ² (δ=√5.991, ref Optimizer.cc:324)


class PoseOptResult(NamedTuple):
    pose: jnp.ndarray      # (7,) refined T_cw
    inliers: jnp.ndarray   # (N,) bool — final chi2 gate
    n_inliers: jnp.ndarray # () int32
    chi2: jnp.ndarray      # (N,) final per-observation chi2


def _residuals_jacobians(cam, pose, points_w, uv_obs):
    """r (N,2) = observed − projected; J (N,2,6) wrt left se3 perturbation."""
    xc = se3.transform_point(pose, points_w)
    uv_hat, _, pos_depth = project(cam, xc)
    r = uv_obs - uv_hat
    Jproj = projection_jacobian(cam, xc)  # (N,2,3)
    # d(xc)/dξ for T ← exp(ξ)T: [ I | −[xc]× ] ; dr/dξ = −Jproj · d(xc)/dξ.
    J_t = -Jproj
    J_w = Jproj @ se3.hat(xc)
    J = jnp.concatenate([J_t, J_w], axis=-1)  # (N,2,6)
    return r, J, pos_depth


def _robust_weights(chi2, inv_sigma2):
    """Huber IRLS weight on the whitened residual norm."""
    w = jnp.where(chi2 > HUBER_DELTA2, jnp.sqrt(HUBER_DELTA2 / jnp.maximum(chi2, 1e-12)), 1.0)
    return w * inv_sigma2


def _cost(cam, pose, points_w, uv_obs, inv_sigma2, active):
    r, _, pos = _residuals_jacobians(cam, pose, points_w, uv_obs)
    chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
    # Huber cost: quadratic inside δ, linear outside.
    rho = jnp.where(
        chi2 <= HUBER_DELTA2,
        chi2,
        2.0 * jnp.sqrt(HUBER_DELTA2 * jnp.maximum(chi2, 1e-12)) - HUBER_DELTA2,
    )
    m = active & pos
    return jnp.sum(jnp.where(m, rho, 0.0)), chi2


@partial(jax.jit, static_argnames=("cam", "stages", "iters"))
def optimize_pose(
    cam: CameraModel,
    pose0: jnp.ndarray,
    points_w: jnp.ndarray,
    uv_obs: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    valid: jnp.ndarray,
    stages: tuple = CHI2_STAGES,
    iters: tuple = ITERS_PER_STAGE,
) -> PoseOptResult:
    """Staged robust LM on a single pose against fixed points.

    valid: observation mask (un-matched / GF-unselected slots are False —
    passing the GF selection mask here IS PoseOptimization_Selected).
    """
    lam0 = jnp.asarray(1e-3, pose0.dtype)
    eye6 = jnp.eye(6, dtype=pose0.dtype)

    def lm_iter(carry, _):
        pose, lam, active = carry
        r, J, pos = _residuals_jacobians(cam, pose, points_w, uv_obs)
        m = active & pos
        chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
        w = jnp.where(m, _robust_weights(chi2, inv_sigma2), 0.0)
        H = jnp.einsum("nri,n,nrj->ij", J, w, J)
        b = jnp.einsum("nri,n,nr->i", J, w, r)
        # r = obs − pred and J = d(pred→residual)/dξ already carries the sign:
        # solve (H + λ diag(H)) δ = −Jᵀ W r with our J convention → δ = solve(H, −b)?
        # With r = z − h(x) and J = ∂r/∂ξ, normal equations are H δ = −Jᵀ W r.
        Hd = H + lam * (eye6 * jnp.diagonal(H)[None, :] + 1e-8 * eye6)
        delta = jnp.linalg.solve(Hd, -b)
        new_pose = se3.apply_left_update(delta, pose)
        # Current-pose cost from the residuals already computed above (same
        # value _cost would produce: same pose → same front-of-camera mask) —
        # saves one of three full residual passes per LM iteration.
        rho_old = jnp.where(
            chi2 <= HUBER_DELTA2,
            chi2,
            2.0 * jnp.sqrt(HUBER_DELTA2 * jnp.maximum(chi2, 1e-12)) - HUBER_DELTA2,
        )
        old_cost = jnp.sum(jnp.where(m, rho_old, 0.0))
        new_cost, _ = _cost(cam, new_pose, points_w, uv_obs, inv_sigma2, active)
        accept = new_cost < old_cost
        pose = jnp.where(accept, new_pose, pose)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9), jnp.minimum(lam * 4.0, 1e6))
        return (pose, lam, active), None

    pose = pose0
    active = valid
    chi2_final = jnp.zeros(points_w.shape[0], pose0.dtype)
    for stage, (chi2_th, n_it) in enumerate(zip(stages, iters)):
        (pose, _, _), _ = jax.lax.scan(
            lm_iter, (pose, lam0, active), None, length=n_it
        )
        _, chi2_now = _cost(cam, pose, points_w, uv_obs, inv_sigma2, active)
        _, _, pos = _residuals_jacobians(cam, pose, points_w, uv_obs)
        # Re-admit observations that pass the gate again (the reference flips
        # edges back to level 0 when chi2 drops below the threshold).
        active = valid & pos & (chi2_now < chi2_th)
        chi2_final = chi2_now
    return PoseOptResult(
        pose=pose,
        inliers=active,
        n_inliers=jnp.sum(active.astype(jnp.int32)),
        chi2=chi2_final,
    )
