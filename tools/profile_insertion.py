#!/usr/bin/env python
"""Stage attribution for the fused keyframe-insertion program: time full
insertion against variants with pieces dialed down, chained map-to-map so
each dispatch consumes the previous result (same discipline as
profile_stages.py — a per-link dispatch floor applies; differences between
variants are the signal)."""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from gf_orb_slam_tpu.geometry.camera import CameraModel
from gf_orb_slam_tpu.io_utils import synthetic
from gf_orb_slam_tpu.mapping import map_state as ms
from gf_orb_slam_tpu.pipeline import local_mapping
from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem

CHAIN = 6


def main():
    cam = CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0,
                      width=752, height=480, fps=20.0)
    scene = synthetic.make_scene(seed=0)
    ts, poses_gt = synthetic.trajectory(30, fps=20.0)
    system = SlamSystem(cam, SlamConfig(n_features=800, max_frames_between_kf=6))
    for i in range(30):
        img = synthetic.render(scene, cam, jnp.asarray(poses_gt[i]))
        system.process(img, float(ts[i]))
    system.flush()
    print(f"map ready: kfs={system.n_kf} pts={int(system.map.pt_valid.sum())}", flush=True)

    cfg = system.cfg
    f = system.last_frame
    Nm = system.map.kp_capacity
    pad = Nm - f.capacity

    def pz(a, fill=0):
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, widths, constant_values=fill)

    uv, oct_, ang, desc = pz(f.uv), pz(f.octave), pz(f.angle), pz(f.desc)
    val, obs = pz(f.valid, False), pz(system.last_obs, ms.NO_POINT)
    pose = system.last_pose

    variants = [
        ("full (tri3, fuse4, ba 5+10)", dict()),
        ("ba 4+6", dict(ba_iters=(4, 6))),
        ("ba 4+6 window 6", dict(ba_iters=(4, 6), ba_window=6)),
        ("ba 4+6 pts 1024", dict(ba_iters=(4, 6), ba_points=1024)),
        ("ba 1+1", dict(ba_iters=(1, 1))),
        ("ba 0+0", dict(ba_iters=(0, 0))),
        ("no triangulation", dict(n_tri_neighbors=0)),
        ("no fusion", dict(n_fuse_neighbors=0)),
        ("fusion 2 neighbors", dict(n_fuse_neighbors=2)),
        ("tri 2 neighbors", dict(n_tri_neighbors=2)),
        ("window 6", dict(ba_window=6)),
    ]

    def run_once(m0, kw):
        m = m0
        fid = 1000
        out = None
        for i in range(CHAIN):
            out = local_mapping.insert_keyframe_fused(
                cam, m, pose, jnp.asarray(fid + i), jnp.asarray(1.0 * i),
                uv, oct_, ang, desc, val, obs,
                scale=cfg.scale, n_levels=cfg.n_levels,
                ba_window=kw.get("ba_window", cfg.ba_window), ba_fixed=cfg.ba_fixed,
                n_tri_neighbors=kw.get("n_tri_neighbors", cfg.triangulate_neighbors),
                ba_points=kw.get("ba_points", cfg.ba_points),
                ba_iters=kw.get("ba_iters", (5, 10)),
                n_fuse_neighbors=kw.get("n_fuse_neighbors", 4),
            )
            m = out.m
        float(out.kf_id)

    # --- standalone sub-stage programs (per-link dispatch floor applies;
    # each chains on a scalar derived from the map) ---
    from gf_orb_slam_tpu.mapping import keyframe_ops

    mm = system.map

    def chain_scalar(fn, name):
        import jax as _jax

        jfn = _jax.jit(fn)
        t0 = time.perf_counter()
        float(jfn(mm, jnp.float32(0)))
        print(f"warm {name}: {time.perf_counter()-t0:.1f}s", flush=True)
        best = float("inf")
        for _ in range(3):
            s = jnp.float32(0)
            t0 = time.perf_counter()
            for _ in range(CHAIN):
                s = jfn(mm, s * 1e-12)
            float(s)
            best = min(best, (time.perf_counter() - t0) / CHAIN)
        print(f"{name:>32} {best*1e3:10.2f}", flush=True)

    chain_scalar(lambda m, s: jnp.sum(ms.covisibility_row(
        m._replace(pt_pos=m.pt_pos + s), jnp.asarray(3))).astype(jnp.float32),
        "sub: covisibility_row")
    chain_scalar(lambda m, s: jnp.sum(ms.incidence(
        m._replace(pt_pos=m.pt_pos + s)).astype(jnp.int32)).astype(jnp.float32),
        "sub: incidence")
    chain_scalar(lambda m, s: keyframe_ops.keyframe_redundancy(
        m._replace(pt_pos=m.pt_pos + s)).sum(),
        "sub: keyframe_redundancy")
    chain_scalar(lambda m, s: ms.refresh_point_stats(
        m._replace(pt_pos=m.pt_pos + s)).pt_normal.sum(),
        "sub: refresh_point_stats")
    chain_scalar(lambda m, s: keyframe_ops.cull_points(
        m._replace(pt_pos=m.pt_pos + s), jnp.asarray(6)).pt_valid.sum().astype(jnp.float32),
        "sub: cull_points")
    chain_scalar(lambda m, s: ms.erase_keyframe(
        m._replace(pt_pos=m.pt_pos + s), jnp.asarray(2)).pt_pos.sum(),
        "sub: erase_keyframe")

    # NOTE: insert_keyframe_fused donates the map arg — copy per run.
    for name, kw in variants:
        m0 = jax.tree.map(lambda a: a + 0 if hasattr(a, "dtype") else a, system.map)
        t0 = time.perf_counter()
        run_once(m0, kw)
        print(f"warm {name}: {time.perf_counter()-t0:.1f}s", flush=True)

    best = {name: float("inf") for name, _ in variants}
    for rep in range(3):
        for name, kw in variants:
            m0 = jax.tree.map(lambda a: a + 0 if hasattr(a, "dtype") else a, system.map)
            t0 = time.perf_counter()
            run_once(m0, kw)
            best[name] = min(best[name], (time.perf_counter() - t0) / CHAIN)
    print(f"\n{'variant':>32} {'ms/insert':>10}", flush=True)
    for name, _ in variants:
        print(f"{name:>32} {best[name]*1e3:10.2f}", flush=True)


if __name__ == "__main__":
    main()
