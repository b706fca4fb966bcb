"""Sim(3) pose-graph (essential graph) optimization.

Replaces Optimizer::OptimizeEssentialGraph (src/Optimizer.cc:1768-2016, g2o
VertexSim3Expmap/EdgeSim3): vertices are keyframe Sim3 poses S_cw (K, 8);
edges (spanning tree + strong covisibility + loop edges) carry relative Sim3
measurements. The residual is the sim3 log of the loop composition
    e_ij = log( S_ji_meas ∘ S_iw ∘ S_wj ) ∈ R⁷,
Jacobians come from batched forward-mode autodiff of the exact residual (the
reference hand-codes them through g2o), and the normal equations are assembled
dense — at SLAM scale (K ≤ 512 → ≤3584 vars) one dense Cholesky beats any
sparse machinery on an accelerator.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gf_orb_slam_tpu.geometry import sim3 as s3


class PoseGraphProblem(NamedTuple):
    poses: jnp.ndarray     # (K, 8) initial S_cw
    fixed: jnp.ndarray     # (K,) bool
    vertex_valid: jnp.ndarray  # (K,) bool
    edge_i: jnp.ndarray    # (E, ) int32
    edge_j: jnp.ndarray    # (E, ) int32
    edge_meas: jnp.ndarray  # (E, 8) S_ji measurement (maps i-cam coords → j-cam)
    edge_valid: jnp.ndarray  # (E,) bool
    edge_weight: jnp.ndarray  # (E,) information scale (loop edges can be upweighted)


def relative_sim3(poses: jnp.ndarray, i, j) -> jnp.ndarray:
    """S_ji = S_jw ∘ S_wi from absolute S_cw poses."""
    return s3.compose(poses[j], s3.inverse(poses[i]))


def _edge_residual(xi_i, xi_j, S_iw, S_jw, S_ji_meas):
    """Residual with left-multiplicative updates applied to both vertices."""
    Si = s3.compose(s3.exp(xi_i), S_iw)
    Sj = s3.compose(s3.exp(xi_j), S_jw)
    err = s3.compose(S_ji_meas, s3.compose(Si, s3.inverse(Sj)))
    return s3.log(err)


@partial(jax.jit, static_argnames=("n_iters",))
def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20) -> jnp.ndarray:
    """Gauss-Newton with LM damping on the Sim3 pose graph. Returns (K, 8)."""
    K = prob.poses.shape[0]
    E = prob.edge_i.shape[0]
    z7 = jnp.zeros(7)

    res_fn = jax.vmap(_edge_residual, in_axes=(0, 0, 0, 0, 0))
    jac_fn = jax.vmap(
        jax.jacfwd(_edge_residual, argnums=(0, 1)), in_axes=(0, 0, 0, 0, 0)
    )

    def total_cost(poses):
        r = res_fn(
            jnp.zeros((E, 7)), jnp.zeros((E, 7)),
            poses[prob.edge_i], poses[prob.edge_j], prob.edge_meas,
        )
        return jnp.sum(jnp.where(prob.edge_valid, prob.edge_weight * jnp.sum(r * r, -1), 0.0))

    def iteration(carry, _):
        poses, lam = carry
        Si = poses[prob.edge_i]
        Sj = poses[prob.edge_j]
        zeros = jnp.zeros((E, 7))
        r = res_fn(zeros, zeros, Si, Sj, prob.edge_meas)            # (E, 7)
        Ji, Jj = jac_fn(zeros, zeros, Si, Sj, prob.edge_meas)       # (E, 7, 7) each
        w = jnp.where(prob.edge_valid, prob.edge_weight, 0.0)

        # Assemble dense H (K,7,K,7) and g (K,7) by scatter-add of blocks.
        Hii = jnp.einsum("eri,e,erj->eij", Ji, w, Ji)
        Hjj = jnp.einsum("eri,e,erj->eij", Jj, w, Jj)
        Hij = jnp.einsum("eri,e,erj->eij", Ji, w, Jj)
        gi = jnp.einsum("eri,e,er->ei", Ji, w, r)
        gj = jnp.einsum("eri,e,er->ei", Jj, w, r)

        H = jnp.zeros((K, 7, K, 7))
        H = H.at[prob.edge_i, :, prob.edge_i, :].add(Hii)
        H = H.at[prob.edge_j, :, prob.edge_j, :].add(Hjj)
        H = H.at[prob.edge_i, :, prob.edge_j, :].add(Hij)
        H = H.at[prob.edge_j, :, prob.edge_i, :].add(jnp.swapaxes(Hij, -1, -2))
        g = jnp.zeros((K, 7)).at[prob.edge_i].add(gi).at[prob.edge_j].add(gj)

        # Freeze fixed/invalid vertices.
        free = prob.vertex_valid & ~prob.fixed
        f = free.astype(H.dtype)
        H = H * f[:, None, None, None] * f[None, None, :, None]
        diag_idx = jnp.arange(K)
        H = H.at[diag_idx, :, diag_idx, :].add(
            jnp.eye(7)[None] * jnp.where(free, lam, 1.0)[:, None, None]
        )
        g = g * f[:, None]

        Hd = H.reshape(K * 7, K * 7) + 1e-8 * jnp.eye(K * 7)
        # GN step: minimize |r + J δ|² → H δ = −g.
        delta = jnp.linalg.solve(Hd, -g.reshape(-1)).reshape(K, 7)
        delta = jnp.where(free[:, None], delta, 0.0)

        new_poses = jax.vmap(lambda d, S: s3.compose(s3.exp(d), S))(delta, poses)
        new_poses = jnp.where(free[:, None], new_poses, poses)
        good = total_cost(new_poses) < total_cost(poses)
        poses = jnp.where(good, new_poses, poses)
        lam = jnp.where(good, jnp.maximum(lam * 0.3, 1e-8), jnp.minimum(lam * 6.0, 1e6))
        return (poses, lam), None

    (poses, _), _ = jax.lax.scan(
        iteration, (prob.poses, jnp.asarray(1e-4)), None, length=n_iters
    )
    return poses


def build_essential_edges(
    covis: jnp.ndarray,          # (K, K) int32 covisibility weights
    parent: jnp.ndarray,         # (K,) spanning-tree parent (−1 root)
    kf_valid: jnp.ndarray,       # (K,)
    loop_i: jnp.ndarray,         # (Lmax,) loop edge endpoints
    loop_j: jnp.ndarray,
    loop_valid: jnp.ndarray,
    poses: jnp.ndarray,          # (K, 8) current S_cw (measurements from current estimate)
    corrected: jnp.ndarray | None = None,  # (K, 8) poses to measure from instead
    covis_min: int = 100,
):
    """Edge set of the essential graph (ref Optimizer.cc:1814-1907): spanning
    tree + covisibility ≥ covis_min + loop edges. Measurements taken from the
    pre-correction relative poses (the standard pose-graph recipe)."""
    K = covis.shape[0]
    meas_src = poses if corrected is None else corrected

    # Spanning tree edges (child → parent).
    tree_i = jnp.arange(K, dtype=jnp.int32)
    tree_j = jnp.where(parent >= 0, parent, 0).astype(jnp.int32)
    tree_valid = (parent >= 0) & kf_valid

    # Strong covisibility edges, upper triangle.
    iu, ju = jnp.triu_indices(K, k=1)
    strong = (covis[iu, ju] >= covis_min) & kf_valid[iu] & kf_valid[ju]

    edge_i = jnp.concatenate([tree_i, iu.astype(jnp.int32), loop_i])
    edge_j = jnp.concatenate([tree_j, ju.astype(jnp.int32), loop_j])
    edge_valid = jnp.concatenate([tree_valid, strong, loop_valid])
    weight = jnp.concatenate(
        [
            jnp.ones(K),
            jnp.ones(iu.shape[0]),
            jnp.full(loop_i.shape[0], 5.0),  # loop edges count more
        ]
    )
    meas = jax.vmap(lambda i, j: relative_sim3(meas_src, i, j))(edge_i, edge_j)
    return edge_i, edge_j, meas, edge_valid, weight
