#!/usr/bin/env python
"""Endurance at reference sequence length.

The reference's benchmark sequences are 2-4k frames (MH_01 = 3682 frames,
batch_script/Run_EuRoC.py:13,51); the longest run in this repo before round
5 was 800 frames against a max_keyframes=256 / max_points=16384 capacity.
This tool runs a ≥3600-frame multi-revolution room circuit (and a long
plane-sweep run) at SHIPPED capacities and records, per segment:

  * live keyframes / map points (must stay bounded through capacity churn:
    redundancy culling + slab compaction + fusion),
  * slab compactions and loop closures,
  * per-segment ATE (each segment Sim3-aligned independently — drift vs
    correction visible) and full-trajectory ATE,
  * per-segment host dispatch-time medians (local_map_track +
    keyframe_insert + pipeline_wait from the TimeLog) — flat-latency
    evidence: the covisibility-local design must keep per-frame cost
    independent of total map age (ref Tracking.cc:3689-3853).

Exit code is non-zero if any regression gate fails (tracked fraction,
bounded KFs/points, final ATE) so this doubles as a long-run regression
check without living in the per-commit pytest suite.

Usage:
  python tools/endurance.py --frames 3600 --out docs/endurance.json
  python tools/endurance.py --scene planes --frames 2400 ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3600)
    ap.add_argument("--scene", choices=["room", "planes"], default="room")
    ap.add_argument("--gf-budget", type=int, default=100)
    ap.add_argument("--pipeline", type=int, default=6)
    ap.add_argument("--segment", type=int, default=600)
    ap.add_argument("--deg-per-frame", type=float, default=0.99,
                    help="room yaw rate; 3600 frames at 0.99 deg/frame = 9.9 "
                         "revolutions of capacity churn")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ate-gate-m", type=float, default=0.12)
    ap.add_argument("--out", default="docs/endurance.json")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gf_orb_slam_tpu.geometry import se3
    from gf_orb_slam_tpu.geometry.camera import EUROC_CAM, CameraModel
    from gf_orb_slam_tpu.io_utils import evaluation, synthetic
    from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem
    from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod

    n = args.frames
    if args.scene == "room":
        cam = EUROC_CAM
        scene = synthetic.make_room_scene(seed=0)
        revs = n * args.deg_per_frame / 360.0
        ts, poses_gt = synthetic.circuit_trajectory(n, fps=cam.fps, radius=4.0,
                                                    revs=revs)
        render = synthetic.render_general
    else:
        cam = CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0,
                          width=752, height=480, fps=20.0)
        scene = synthetic.make_scene(seed=0)
        revs = 0.0
        ts, poses_gt = synthetic.trajectory(n, fps=cam.fps)
        render = synthetic.render

    cfg = SlamConfig(
        max_frames_between_kf=6 if args.scene == "room" else 12,
        use_gf=args.gf_budget > 0, gf_budget=max(args.gf_budget, 1),
        pipelined=args.pipeline > 1, pipeline_depth=max(args.pipeline, 1),
    )
    system = SlamSystem(cam, cfg)
    voc = voc_mod.load_default_vocabulary()
    if voc is not None:
        system.set_vocabulary(voc)

    seg_rows = []
    t_start = time.perf_counter()
    for i in range(n):
        img = render(scene, cam, jnp.asarray(poses_gt[i]))
        system.process(img, float(ts[i]))
        if (i + 1) % args.segment == 0:
            system.flush()
            live_kf = int(np.asarray(system.map.kf_valid).sum())
            live_pt = int(np.asarray(system.map.pt_valid).sum())
            frames = system.time_log.frames[-args.segment:]

            def med(stage):
                vals = sorted(f.stages_ms[stage] for f in frames
                              if stage in f.stages_ms)
                return round(vals[len(vals) // 2], 2) if vals else None

            seg_rows.append({
                "frame": i + 1,
                "live_keyframes": live_kf,
                "live_points": live_pt,
                "n_kf_counter": system.n_kf,
                "loops_closed": system.n_loops_closed,
                "compactions": system.n_compactions,
                "state": system.state.name,
                "median_dispatch_ms": med("local_map_track"),
                "median_insert_ms": med("keyframe_insert"),
                "median_wait_ms": med("pipeline_wait"),
                "wall_fps": round((i + 1) / (time.perf_counter() - t_start), 1),
            })
            print(json.dumps(seg_rows[-1]), flush=True)
    system.flush()
    wall_s = time.perf_counter() - t_start

    est_ts, est_poses = system.get_trajectory()
    gt_by_t = {round(float(t), 6): np.asarray(
        se3.pose_t(se3.inverse(jnp.asarray(p)))) for t, p in zip(ts, poses_gt)}
    est_pos = np.stack(
        [np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in est_poses]
    )
    gt_pos = np.stack([gt_by_t[round(float(t), 6)] for t in est_ts])
    full_ate = evaluation.ate_rmse(est_pos, gt_pos)

    # Per-segment ATE with independent alignment.
    seg_ate = []
    step = args.segment
    tarr = np.asarray(est_ts)
    for s0 in range(0, n, step):
        m = (tarr >= ts[s0]) & (tarr < ts[min(s0 + step, n - 1)])
        if m.sum() > 30:
            seg_ate.append(round(evaluation.ate_rmse(est_pos[m], gt_pos[m]), 4))
        else:
            seg_ate.append(None)

    tracked_frac = len(est_poses) / n
    result = {
        "scene": args.scene, "frames": n, "revolutions": round(revs, 2),
        "gf_budget": args.gf_budget, "pipeline": args.pipeline,
        "capacities": {"max_keyframes": cfg.max_keyframes,
                       "max_points": cfg.max_points},
        "tracked": len(est_poses), "tracked_frac": round(tracked_frac, 4),
        "ate_rmse_m": full_ate,
        "segment_ate_m": seg_ate,
        "loops_closed": system.n_loops_closed,
        "compactions": system.n_compactions,
        "final_state": system.state.name,
        "wall_s": round(wall_s, 1), "wall_fps": round(n / wall_s, 2),
        "segments": seg_rows,
    }
    print(json.dumps({k: v for k, v in result.items() if k != "segments"},
                     indent=2))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)

    # Regression gates.
    fails = []
    if tracked_frac < 0.97:
        fails.append(f"tracked_frac {tracked_frac:.3f} < 0.97")
    if full_ate > args.ate_gate_m:
        fails.append(f"ate {full_ate:.3f} > {args.ate_gate_m}")
    kmax = max(r["live_keyframes"] for r in seg_rows) if seg_rows else 0
    pmax = max(r["live_points"] for r in seg_rows) if seg_rows else 0
    if kmax > cfg.max_keyframes:
        fails.append("keyframes exceeded capacity")
    if pmax > cfg.max_points:
        fails.append("points exceeded capacity")
    # Flat latency: last-quarter dispatch median must not exceed 2x the
    # second segment's (first segment carries compiles).
    disp = [r["median_dispatch_ms"] for r in seg_rows
            if r["median_dispatch_ms"] is not None]
    if len(disp) >= 4 and disp[1] and disp[-1] > 2.0 * max(disp[1], 1.0):
        fails.append(f"dispatch median grew {disp[1]} -> {disp[-1]} ms")
    if fails:
        print("ENDURANCE GATES FAILED: " + "; ".join(fails), file=sys.stderr)
        sys.exit(1)
    print("ENDURANCE GATES PASSED")


if __name__ == "__main__":
    main()
