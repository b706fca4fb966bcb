#!/usr/bin/env python
"""Device stage attribution for the fused per-frame tracking program.

Each stage is jitted standalone, warmed, then timed by chaining CHAIN
dispatches (each consuming a scalar from the previous result so XLA cannot
overlap them away) with a single final fetch. Stages are interleaved
round-robin so throughput drift hits all stages equally. Each number carries
a per-link dispatch floor; differences between stages are the signal.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from gf_orb_slam_tpu.geometry import se3
from gf_orb_slam_tpu.geometry.camera import CameraModel
from gf_orb_slam_tpu.io_utils import synthetic
from gf_orb_slam_tpu.ops import fast as fast_ops
from gf_orb_slam_tpu.ops import orb, pyramid as pyr
from gf_orb_slam_tpu.pipeline import tracking as trk
from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem

CHAIN = 8


def main(which=None):
    cam = CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0,
                      width=752, height=480, fps=20.0)
    scene = synthetic.make_scene(seed=0)
    ts, poses_gt = synthetic.trajectory(40, fps=20.0)
    frames = []
    for i in range(40):
        img = synthetic.render(scene, cam, jnp.asarray(poses_gt[i]))
        img.block_until_ready()
        frames.append(img)

    system = SlamSystem(cam, SlamConfig(n_features=800, max_frames_between_kf=10))
    for i in range(22):
        system.process(frames[i], float(ts[i]))
    system.flush()
    print(f"map ready: kfs={system.n_kf} pts={int(system.map.pt_valid.sum())}")

    cfg = system.orb_cfg
    img0 = frames[-1]

    # --- stage programs, each returning a scalar to chain on ---
    @jax.jit
    def s_pyramid(img):
        lv = pyr.build_pyramid(img, cfg.n_levels, cfg.scale)
        return sum(jnp.sum(l[::64, ::64]) for l in lv)

    @jax.jit
    def s_fast(img):
        lv = pyr.build_pyramid(img, cfg.n_levels, cfg.scale)
        quotas = pyr.features_per_level(cfg.n_features, cfg.n_levels, cfg.scale)
        acc = jnp.float32(0)
        for l, q in zip(lv, quotas):
            if q <= 0:
                continue
            xy, resp, valid = fast_ops.detect_keypoints(
                l, n_keep=q, threshold=cfg.fast_threshold,
                min_threshold=cfg.fast_min_threshold, grid=cfg.grid)
            acc = acc + jnp.sum(resp) + jnp.sum(xy[:, 0])
        return acc

    @jax.jit
    def s_integrals(img):
        lv = pyr.build_pyramid(img, cfg.n_levels, cfg.scale)
        acc = jnp.float32(0)
        for l in lv:
            S, Sx, _ = orb.level_moment_integrals(l)
            acc = acc + jnp.sum(S[::64, ::64]) + jnp.sum(Sx[::64, ::64])
        return acc

    @jax.jit
    def s_blur(img):
        lv = pyr.build_pyramid(img, cfg.n_levels, cfg.scale)
        return sum(jnp.sum(pyr.gaussian_blur(l)[::64, ::64]) for l in lv)

    @jax.jit
    def s_extract(img):
        kp = orb.extract_orb(img, cfg)
        return jnp.sum(kp.uv) + jnp.sum(kp.desc[:, 0].astype(jnp.float32))

    # Patch-matmul descriptor backend (the round-3 experiment, now non-default)
    # for A/B against the element-gather production path.
    cfg_patch = cfg._replace(patch_desc=True)

    @jax.jit
    def s_extract_patchmm(img):
        kp = orb.extract_orb(img, cfg_patch)
        return jnp.sum(kp.uv) + jnp.sum(kp.desc[:, 0].astype(jnp.float32))

    key = jax.random.PRNGKey(0)

    def s_fused(img):
        r = trk.track_frame_fused(
            cam, cfg, system.map, system.track_view, img,
            system.last_pose, system.last_obs, system.last_frame.uv,
            system.velocity, jnp.asarray(0.05, jnp.float32), key)
        return r.n_inliers.astype(jnp.float32) + r.pose[4]

    def s_fused_gf(batch, budget=100):
        def run(img):
            r = trk.track_frame_fused(
                cam, cfg, system.map, system.track_view, img,
                system.last_pose, system.last_obs, system.last_frame.uv,
                system.velocity, jnp.asarray(0.05, jnp.float32), key,
                use_gf=True, gf_budget=budget, gf_batch=batch)
            return r.n_inliers.astype(jnp.float32) + r.pose[4]

        return run

    def bf16(fn):
        """Same program traced under bfloat16 default matmul precision — the
        round-3 pre-fix configuration. The config value keys the jit cache, so
        the f32 and bf16 traces coexist in one process and can be chained
        interleaved (drift-fair A/B of the global f32-matmul default)."""
        def run(img):
            with jax.default_matmul_precision("bfloat16"):
                return fn(img)
        return run

    stages = [
        ("pyramid", s_pyramid),
        ("pyramid_bf16", bf16(s_pyramid)),
        ("pyr+fast", s_fast),
        ("pyr+integrals", s_integrals),
        ("pyr+blur", s_blur),
        ("extract_full", s_extract),
        ("extract_bf16", bf16(s_extract)),
        ("extract_patchmm", s_extract_patchmm),
        ("fused_track", s_fused),
        ("fused_bf16", bf16(s_fused)),
        ("fused_track_gf", s_fused_gf(1)),          # batch=1: k rounds
        ("fused_gf_b5", s_fused_gf(5)),             # production default
        ("fused_gf_b10", s_fused_gf(10)),
        ("fused_gf10_bf16", bf16(s_fused_gf(10))),
        ("fused_gf_b5_k60", s_fused_gf(5, 60)),
        ("fused_gf_b5_k200", s_fused_gf(5, 200)),
    ]
    if which:
        stages = [(n, f) for n, f in stages if n in which]

    # Warm all.
    for name, f in stages:
        t0 = time.perf_counter()
        float(f(img0))
        print(f"warm {name}: {time.perf_counter()-t0:.1f}s", flush=True)
    # Throwaway chain: the first chained sequence after warmup absorbs a
    # cache warm hit that would land on whichever stage happens to run first.
    s = jnp.float32(0)
    for i in range(CHAIN):
        s = stages[0][1](img0 + s * 1e-12)
    float(s)
    # Interleaved chained timing; report min over reps (drift only ever
    # inflates).
    best = {name: float("inf") for name, _ in stages}
    REPS = 3
    for rep in range(REPS):
        for name, f in stages:
            s = jnp.float32(0)
            t0 = time.perf_counter()
            for i in range(CHAIN):
                s = f(img0 + s * 1e-12)
            float(s)
            best[name] = min(best[name], (time.perf_counter() - t0) / CHAIN)
    print(f"\n{'stage':>16} {'ms/frame':>9}", flush=True)
    for name, _ in stages:
        print(f"{name:>16} {best[name] * 1e3:9.2f}", flush=True)


if __name__ == "__main__":
    import sys
    main(set(sys.argv[1].split(",")) if len(sys.argv) > 1 else None)
