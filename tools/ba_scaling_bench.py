#!/usr/bin/env python
"""Distributed global BA scaling benchmark (BASELINE.json configs 4-5).

Measures time per LM iteration of the keyframe-sharded global BA across mesh
sizes and reports scaling efficiency. On a multi-device host the mesh spans
real devices; with --virtual N it uses
xla_force_host_platform_device_count to validate the collective structure.

  python tools/ba_scaling_bench.py --virtual 8 --cams 64 --points 4096
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices (0 = use real devices)")
    ap.add_argument("--cams", type=int, default=64)
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--obs-per-cam", type=int, default=512)
    ap.add_argument("--lm-iters", type=int, default=6)
    ap.add_argument("--pcg-iters", type=int, default=20)
    ap.add_argument("--breakdown", action="store_true",
                    help="also time the per-shard workload on a 1-device mesh "
                         "(psum = identity) to split compute vs collective cost")
    ap.add_argument("--fast-gen", action="store_true",
                    help="synthesize observations by sampling point-id windows "
                         "per camera instead of full-visibility projection — "
                         "required at large scale (the per-camera generation "
                         "loop projects C*P pairs)")
    args = ap.parse_args()

    if args.virtual:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gf_orb_slam_tpu.geometry import camera, quat, se3
    from gf_orb_slam_tpu.geometry.camera import project
    from gf_orb_slam_tpu.parallel import global_ba
    from gf_orb_slam_tpu.solvers.local_ba import BAProblem

    cam = camera.EUROC_CAM
    rng = np.random.default_rng(0)
    C, P, N = args.cams, args.points, args.obs_per_cam

    pts = rng.uniform([-8, -6, 5.0], [8, 6, 20.0], (P, 3)).astype(np.float32)
    if args.fast_gen:
        # Large-scale generation: each camera observes N points drawn from a
        # sliding id window (structured covisibility locality, like a long
        # trajectory); only the C·N observed pairs are projected, vectorized
        # in one jit, instead of all C·P pairs. Observation geometry realism
        # only has to keep the LM numerically healthy — the benchmark
        # measures compute/collective structure, not accuracy.
        ids = np.empty((C, N), np.int64)
        span = max(P // 4, N * 4)
        for c in range(C):
            lo = int((P - span) * c / max(C - 1, 1))
            ids[c] = rng.choice(span, size=N, replace=False) + lo
        t_all = np.stack([
            np.asarray([8.0 * c / C - 4.0, 0.2 * np.sin(c), 0.0], np.float32)
            for c in range(C)
        ])
        w_all = (rng.normal(size=(C, 3)) * 0.02).astype(np.float32)

        @jax.jit
        def gen(t_all, w_all, pts_j, ids_j):
            pose = jax.vmap(
                lambda w, t: se3.make_pose(quat.v2q(w), t)
            )(w_all, t_all)                                     # (C, 7)
            sel = pts_j[ids_j]                                  # (C, N, 3)
            uv, _, ok = project(cam, se3.transform_point(pose[:, None, :], sel))
            return pose, uv, ok

        pose_j, uv_j, ok_j = gen(
            jnp.asarray(t_all), jnp.asarray(w_all), jnp.asarray(pts),
            jnp.asarray(ids),
        )
        uv_np = np.asarray(uv_j) + rng.normal(0, 0.5, (C, N, 2))
        ok_np = np.asarray(ok_j)
        prob = BAProblem(
            poses=jnp.asarray(np.asarray(pose_j)),
            points=jnp.asarray(
                pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
            ),
            fixed=jnp.asarray([True, True] + [False] * (C - 2)),
            point_valid=jnp.ones(P, bool),
            obs_uv=jnp.asarray(uv_np.astype(np.float32)),
            obs_point=jnp.asarray(np.where(ok_np, ids, -1).astype(np.int32)),
            obs_w=jnp.asarray(ok_np.astype(np.float32)),
        )
        return bench_problem(args, cam, prob, C, P, N)
    poses, obs_uv, obs_pt, obs_w = [], [], [], []
    for c in range(C):
        t = np.asarray([8.0 * c / C - 4.0, 0.2 * np.sin(c), 0.0], np.float32)
        w = (rng.normal(size=3) * 0.02).astype(np.float32)
        pose = np.asarray(se3.make_pose(quat.v2q(jnp.asarray(w)), jnp.asarray(t)))
        uv, _, ok = project(cam, se3.transform_point(jnp.asarray(pose), jnp.asarray(pts)))
        vis = np.nonzero(np.asarray(ok))[0]
        rng.shuffle(vis)
        sel = vis[:N]
        row_uv = np.zeros((N, 2), np.float32)
        row_pt = np.full(N, -1, np.int32)
        row_w = np.zeros(N, np.float32)
        row_uv[: len(sel)] = np.asarray(uv)[sel] + rng.normal(0, 0.5, (len(sel), 2))
        row_pt[: len(sel)] = sel
        row_w[: len(sel)] = 1.0
        poses.append(pose)
        obs_uv.append(row_uv)
        obs_pt.append(row_pt)
        obs_w.append(row_w)

    prob = BAProblem(
        poses=jnp.asarray(np.stack(poses)),
        points=jnp.asarray(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)),
        fixed=jnp.asarray([True, True] + [False] * (C - 2)),
        point_valid=jnp.ones(P, bool),
        obs_uv=jnp.asarray(np.stack(obs_uv)),
        obs_point=jnp.asarray(np.stack(obs_pt)),
        obs_w=jnp.asarray(np.stack(obs_w)),
    )
    return bench_problem(args, cam, prob, C, P, N)


def bench_problem(args, cam, prob, C, P, N):
    import jax
    import jax.numpy as jnp

    from gf_orb_slam_tpu.parallel import global_ba
    from gf_orb_slam_tpu.solvers.local_ba import BAProblem

    n_dev = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev and C % d == 0]
    results = {}
    compute_only = {}

    def time_run(problem, mesh):
        run = lambda: global_ba.distributed_bundle_adjust(
            cam, problem, mesh, n_lm_iters=args.lm_iters, n_pcg_iters=args.pcg_iters
        )
        out = run()
        jax.block_until_ready(out.poses)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = run()
            jax.block_until_ready(out.poses)
        return (time.perf_counter() - t0) / reps / args.lm_iters * 1e3, out

    mesh1 = global_ba.make_mesh(1)

    for d in sizes:
        mesh = global_ba.make_mesh(d)
        dt, out = time_run(prob, mesh)
        results[d] = dt
        if args.breakdown and d > 1:
            # Compute-only ablation: the SAME per-shard workload (C/d cameras,
            # full replicated point table) on a 1-device mesh, where every
            # psum is the identity — isolates collective+partition cost.
            sub = BAProblem(
                poses=prob.poses[: C // d],
                points=prob.points,
                fixed=prob.fixed[: C // d],
                point_valid=prob.point_valid,
                obs_uv=prob.obs_uv[: C // d],
                obs_point=prob.obs_point[: C // d],
                obs_w=prob.obs_w[: C // d],
            )
            dt_c, _ = time_run(sub, mesh1)
            compute_only[d] = dt_c
            print(
                f"devices={d:3d}  per-shard compute-only={dt_c:8.2f} ms/LM-iter  "
                f"collective+partition={dt - dt_c:8.2f} ms ({(dt - dt_c) / dt:5.1%})",
                flush=True,
            )
        if args.virtual:
            # Virtual shards share ONE host's cores: aggregate compute is
            # fixed, so ideal is FLAT time and the meaningful number is the
            # partition+collective overhead vs 1 shard — true scaling
            # efficiency requires real devices.
            ovh = dt / results[sizes[0]] - 1.0
            print(
                f"devices={d:3d}  ms/LM-iter={dt:8.2f}  cost={float(out.cost):10.1f}  "
                f"shard-overhead={ovh:+6.1%} (virtual mesh: shared compute)",
                flush=True,
            )
        else:
            eff = results[sizes[0]] * sizes[0] / (dt * d) if d > sizes[0] else 1.0
            print(
                f"devices={d:3d}  ms/LM-iter={dt:8.2f}  cost={float(out.cost):10.1f}  "
                f"scaling-eff={eff:5.2f}",
                flush=True,
            )


if __name__ == "__main__":
    main()
