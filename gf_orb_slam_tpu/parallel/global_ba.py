"""Distributed global bundle adjustment: keyframe-sharded LM with a
matrix-free PCG solve of the Schur-reduced camera system.

This is the multi-device replacement for the reference's single-threaded g2o
GlobalBundleAdjustemnt (src/Optimizer.cc:28-142), designed for maps sharded
over several devices (BASELINE.json configs 4-5):

* Keyframes (and their observation rows) are sharded over the mesh axis
  'kf'; point POSITIONS are replicated (P·3 floats is tiny next to
  observations) but all O(P) point WORK is sharded over the same axis.
* Point normal-equation blocks V_p, g_p are formed shard-locally and
  combined with one reduce_scatter (psum_scatter) over the point dimension:
  each shard owns a P/d slice of the summed blocks, inverts only its slice
  (batched 3×3), and applies V⁻¹ locally — the (P,3,3) block never crosses
  the mesh fully-replicated (half the bandwidth of the old full psum, and
  the V-inversion/back-substitution flops drop by 1/d).
* The reduced camera system S = U − Σ_p W V⁻¹ Wᵀ is never materialized
  (its cross-camera blocks couple cameras on different shards). Instead the
  CG solve applies S matrix-free:
      S·v  =  U·v − Σ_p W_p V_p⁻¹ (Σ_d W_pdᵀ v_d)
  where the inner per-point accumulation Σ_d W_pdᵀ v_d is a shard-local
  scatter-add followed by one psum_scatter of a (P, 3) array; the V⁻¹
  application runs on the local slice and one all_gather of the (P, 3)
  result re-replicates it for the edge gather. reduce_scatter + all_gather
  moves the same bytes as the old psum, so the CG collective cost is
  unchanged while its O(P) compute drops by 1/d.
* Block-Jacobi preconditioner (damped U⁻¹, shard-local).

All collectives are expressed with jax.lax.psum inside shard_map, so the same
program runs on a virtual CPU mesh (tests), one real card (mesh of 1), or
several cards joined by NVLink without modification.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gf_orb_slam_tpu.geometry import linalg, se3
from gf_orb_slam_tpu.geometry.camera import CameraModel
from gf_orb_slam_tpu.solvers.local_ba import BAProblem, BAResult, _edge_terms, _robust_w

AXIS = "kf"


def _local_blocks(cam, poses, points, obs_uv, obs_point, obs_w, fixed, active):
    """Shard-local residuals, Jacobians, and per-edge weight."""
    r, Jpose, Jpt, ok = _edge_terms(cam, poses, points, obs_uv, obs_point, active)
    w, _ = _robust_w(r, obs_w, ok)
    # Fixed cameras: contribute to points (V, g_p) but not to pose rows.
    w_pose = jnp.where(fixed[:, None], 0.0, w)
    return r, Jpose, Jpt, w, w_pose


def _scatter_point(vals, lp, ok, P_cap, width):
    """Scatter-add per-edge (C, N, width...) values into (P, width...)."""
    drop = jnp.where(ok, lp, P_cap)
    flat = vals.reshape((-1,) + vals.shape[2:])
    out = jnp.zeros((P_cap,) + vals.shape[2:], vals.dtype)
    return out.at[drop.reshape(-1)].add(flat, mode="drop")


def _make_step(cam: CameraModel, n_pcg_iters: int, lam_pt: float):
    """Builds the shard_map-able single-LM-iteration function."""

    def step(poses, points, fixed, point_valid, obs_uv, obs_point, obs_w, active, lam):
        C_loc, N = obs_point.shape
        P_cap = points.shape[0]
        lp = jnp.maximum(obs_point, 0)

        r, Jpose, Jpt, w, w_pose = _local_blocks(
            cam, poses, points, obs_uv, obs_point, obs_w, fixed, active
        )
        ok = active & (obs_point >= 0)

        # --- camera blocks (shard-local) ---
        U = jnp.einsum("cnri,cn,cnrj->cij", Jpose, w_pose, Jpose)
        g_c = jnp.einsum("cnri,cn,cnr->ci", Jpose, w_pose, r)

        # --- point blocks: reduce_scatter over the point dimension so each
        # shard owns (and inverts) only its P/d slice of V ---
        d_ax = jax.lax.axis_size(AXIS)
        me = jax.lax.axis_index(AXIS)
        P_loc = P_cap // d_ax
        V_loc = jnp.einsum("cnri,cn,cnrj->cnij", Jpt, w, Jpt)
        gp_loc = jnp.einsum("cnri,cn,cnr->cni", Jpt, w, r)
        V_s = jax.lax.psum_scatter(
            _scatter_point(V_loc, lp, ok, P_cap, 9), AXIS,
            scatter_dimension=0, tiled=True,
        )                                                     # (P/d, 3, 3)
        gp_s = jax.lax.psum_scatter(
            _scatter_point(gp_loc, lp, ok, P_cap, 3), AXIS,
            scatter_dimension=0, tiled=True,
        )                                                     # (P/d, 3)
        pv_s = jax.lax.dynamic_slice_in_dim(
            point_valid, me * P_loc, P_loc, axis=0
        )

        V_d = V_s + (lam * jnp.maximum(
            jnp.diagonal(V_s, axis1=-2, axis2=-1), 1e-6
        ))[:, :, None] * jnp.eye(3) + lam_pt * jnp.eye(3)
        Vinv_s = linalg.inv3(V_d)
        Vinv_s = jnp.where(pv_s[:, None, None], Vinv_s, 0.0)

        def vinv_apply_gather(a_s):
            """V⁻¹ on the local point slice, re-replicated as (P, 3)."""
            va = jnp.einsum("pij,pj->pi", Vinv_s, a_s)
            return jax.lax.all_gather(va, AXIS, axis=0, tiled=True)

        # Per-edge W blocks (pose×point coupling), shard-local.
        W_edge = jnp.einsum("cnri,cn,cnrj->cnij", Jpose, w_pose, Jpt)

        # Damped U and its inverse (Jacobi preconditioner).
        U_d = U + (lam * jnp.maximum(
            jnp.diagonal(U, axis1=-2, axis2=-1), 1e-6
        ))[:, :, None] * jnp.eye(6) + 1e-7 * jnp.eye(6)
        M_inv = jnp.linalg.inv(U_d)
        eye6 = jnp.eye(6)
        M_inv = jnp.where(fixed[:, None, None], eye6[None], M_inv)

        def point_accum_scatter(v):
            """a_p = Σ_d W_pdᵀ v_d — scatter + psum_scatter: each shard gets
            its P/d slice of the global accumulation (the per-iteration
            collective)."""
            contrib = jnp.einsum("cnij,ci->cnj", W_edge, v)  # (C,N,3)
            return jax.lax.psum_scatter(
                _scatter_point(contrib, lp, ok, P_cap, 3), AXIS,
                scatter_dimension=0, tiled=True,
            )

        def S_apply(v):
            """S v, shard-local rows."""
            Va = vinv_apply_gather(point_accum_scatter(v))      # (P, 3)
            back = jnp.einsum("cnij,cnj->cni", W_edge, Va[lp] * ok[..., None])
            Uv = jnp.einsum("cij,cj->ci", U_d, v)
            Sv = Uv - jnp.sum(back, axis=1)
            return jnp.where(fixed[:, None], v, Sv)  # identity rows for fixed

        # RHS: b = g_c − Y g_p (shard-local rows).
        Vg = vinv_apply_gather(gp_s)
        b = g_c - jnp.sum(
            jnp.einsum("cnij,cnj->cni", W_edge, Vg[lp] * ok[..., None]), axis=1
        )
        b = jnp.where(fixed[:, None], 0.0, b)

        def dot(x, y):
            return jax.lax.psum(jnp.sum(x * y), AXIS)

        # --- preconditioned CG on S δ = b ---
        x0 = jnp.zeros_like(b)
        r0 = b
        z0 = jnp.einsum("cij,cj->ci", M_inv, r0)
        p0 = z0
        rz0 = dot(r0, z0)

        def pcg_iter(carry, _):
            x, rr, z, p, rz = carry
            Sp = S_apply(p)
            alpha = rz / jnp.maximum(dot(p, Sp), 1e-20)
            x = x + alpha * p
            rr = rr - alpha * Sp
            z = jnp.einsum("cij,cj->ci", M_inv, rr)
            rz_new = dot(rr, z)
            beta = rz_new / jnp.maximum(rz, 1e-20)
            p = z + beta * p
            return (x, rr, z, p, rz_new), None

        (delta_c, _, _, _, _), _ = jax.lax.scan(
            pcg_iter, (x0, r0, z0, p0, rz0), None, length=n_pcg_iters
        )
        delta_c = jnp.where(fixed[:, None], 0.0, delta_c)

        # --- back-substitute points: δX = V⁻¹ (g_p − Σ_c W_pcᵀ δξ_c),
        # computed on the local P/d slice and re-replicated ---
        a_s = point_accum_scatter(delta_c)
        delta_p = vinv_apply_gather(gp_s - a_s)
        delta_p = jnp.where(point_valid[:, None], delta_p, 0.0)

        # --- apply + accept/reject (cost via psum) ---
        new_poses = jax.vmap(se3.apply_left_update)(delta_c, poses)
        new_poses = jnp.where(fixed[:, None], poses, new_poses)
        new_points = points + delta_p

        def cost_of(ps, pt):
            rr, _, _, okk = _edge_terms(cam, ps, pt, obs_uv, obs_point, active)
            chi2 = jnp.sum(rr * rr, axis=-1) * obs_w
            rho = jnp.where(
                chi2 <= 5.991, chi2,
                2.0 * jnp.sqrt(5.991 * jnp.maximum(chi2, 1e-12)) - 5.991,
            )
            return jax.lax.psum(jnp.sum(jnp.where(okk & ok, rho, 0.0)), AXIS)

        c_old = cost_of(poses, points)
        c_new = cost_of(new_poses, new_points)
        good = c_new < c_old
        poses = jnp.where(good, new_poses, poses)
        points = jnp.where(good, new_points, points)  # replicated: same decision everywhere
        lam = jnp.where(good, jnp.maximum(lam * 0.4, 1e-9), jnp.minimum(lam * 5.0, 1e5))
        # Report the ACCEPTED objective: a rejected proposal (e.g. a CG solve
        # gone bad at tiny lambda) must not masquerade as the result cost.
        return poses, points, lam, jnp.where(good, c_new, c_old)

    return step


@partial(
    jax.jit,
    static_argnames=("cam", "mesh", "n_lm_iters", "n_pcg_iters"),
)
def distributed_bundle_adjust(
    cam: CameraModel,
    prob: BAProblem,
    mesh: Mesh,
    n_lm_iters: int = 10,
    n_pcg_iters: int = 25,
    lam_pt: float = 1e-6,
) -> BAResult:
    """Run keyframe-sharded global BA on a device mesh.

    prob arrays follow solvers/local_ba.BAProblem; the camera dimension C must
    be divisible by the mesh size. Point positions/validity are replicated;
    point WORK is sharded, so the point capacity is padded here to a multiple
    of the mesh size (padding slots are invalid and referenced by no edge).
    """
    d = mesh.devices.size
    pad = (-prob.points.shape[0]) % d
    if pad:
        prob = prob._replace(
            points=jnp.pad(prob.points, ((0, pad), (0, 0))),
            point_valid=jnp.pad(prob.point_valid, (0, pad)),
        )
    step = _make_step(cam, n_pcg_iters, lam_pt)

    cam_spec = P(AXIS)
    rep = P()

    def sharded_ba(poses, fixed, obs_uv, obs_point, obs_w, points, point_valid):
        active = (obs_point >= 0) & (obs_w > 0)
        lam = jnp.asarray(1e-4, poses.dtype)

        def lm_iter(carry, _):
            poses, points, lam = carry
            poses, points, lam, cost = step(
                poses, points, fixed, point_valid, obs_uv, obs_point, obs_w,
                active, lam,
            )
            return (poses, points, lam), cost

        (poses, points, _), costs = jax.lax.scan(
            lm_iter, (poses, points, lam), None, length=n_lm_iters
        )
        # Final chi2 classification (shard-local rows).
        r, _, _, ok = _edge_terms(cam, poses, points, obs_uv, obs_point, active)
        chi2 = jnp.sum(r * r, axis=-1) * obs_w
        final_active = active & ok & (chi2 <= 5.991)
        return poses, points, final_active, costs[-1]

    from jax import shard_map

    fn = shard_map(
        sharded_ba,
        mesh=mesh,
        in_specs=(cam_spec, cam_spec, cam_spec, cam_spec, cam_spec, rep, rep),
        out_specs=(cam_spec, rep, cam_spec, rep),
        check_vma=False,
    )
    poses, points, final_active, cost = fn(
        prob.poses, prob.fixed, prob.obs_uv, prob.obs_point, prob.obs_w,
        prob.points, prob.point_valid,
    )
    if pad:
        points = points[:-pad]
    return BAResult(poses=poses, points=points, obs_active=final_active, cost=cost)


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devs), (AXIS,))
