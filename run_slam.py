#!/usr/bin/env python
"""CLI driver: run the SLAM system on a dataset sequence (or the synthetic
scene) and write TUM trajectories + timing logs.

Replaces the reference's main.cc argv interface (vocabulary, settings yaml,
#good-features, topic, results prefix; src/main.cc:57-64) and the per-sequence
body of batch_script/Run_EuRoC.py:

  python run_slam.py --seq /data/EuRoC/MH_01_easy --settings cfg/EuRoC.yaml \
      --gf-budget 100 --out results/MH01
  python run_slam.py --synthetic 120 --out results/synth   # no dataset needed
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", help="dataset sequence directory (EuRoC/TUM/NUIM)")
    ap.add_argument("--synthetic", type=int, default=0, help="run N synthetic frames instead")
    ap.add_argument("--scene", choices=["planes", "room"], default="planes",
                    help="synthetic scene: fronto-parallel plane sweep, or the "
                         "4-wall room 360-degree circuit (radtan-distorted "
                         "EuRoC camera, oblique geometry, loop closure)")
    ap.add_argument("--settings", help="OpenCV-style yaml settings file")
    ap.add_argument("--vocabulary",
                    help="pretrained BoW vocabulary (.txt DBoW2 text or .npz "
                         "binary); default: train on-the-fly from early keyframes")
    ap.add_argument("--gf-budget", type=int, default=0,
                    help="good-feature budget (0 = GF off, plain ORB-SLAM path)")
    ap.add_argument("--gf-mode", default="subset",
                    choices=["subset", "hybrid", "lazier", "auto", "active",
                             "random", "longlive"],
                    help="selection variant (ref Observability #define matrix): "
                         "subset=7x7 exact Max-logDet (det-lemma kernel), "
                         "hybrid=13x13 [H;H*F], lazier=reference lazier-greedy, "
                         "auto=gain-floor budget, active=select-then-match, "
                         "random/longlive=ablation baselines")
    ap.add_argument("--probe-stages", action="store_true",
                    help="after the run, measure on-chip per-stage times "
                         "(gf_selection/triangulation/fusion/local_ba/...) by "
                         "chained-dispatch deltas and record them in the "
                         "TimeLog + result JSON")
    ap.add_argument("--gf-warmup", type=int, default=-1,
                    help="frames after init before GF activates (ref: GF off "
                         "first 5 s, Tracking.h:104); -1 keeps the config default")
    ap.add_argument("--init-gate", type=int, default=-1,
                    help="post-init quality gate: min BA-surviving points to "
                         "accept a two-view bootstrap (ref resets when the "
                         "post-init map is too thin); -1 keeps config default")
    ap.add_argument("--n-features", type=int, default=0, help="override ORB feature count")
    ap.add_argument("--max-frames", type=int, default=0, help="cap processed frames")
    ap.add_argument("--out", default="results/run", help="output prefix")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--pipeline", type=int, default=0,
                    help="frames in flight (>1 hides fetch RTT; 0 = synchronous)")
    ap.add_argument("--save-map", help="write a map snapshot (.npz) at sequence end")
    ap.add_argument("--load-map", help="resume from a map snapshot (relocalize-only start)")
    ap.add_argument("--seed", type=int, default=0,
                    help="SLAM PRNG seed (RANSAC/lazier sampling) — the "
                         "statistical-rounds axis of the reference's protocol "
                         "(Run_EuRoC.py:34-43, 10 rounds per config)")
    ap.add_argument("--scene-seed", type=int, default=0,
                    help="synthetic scene texture seed: the pipeline is "
                         "deterministic given --seed (static compute budgets), "
                         "so independent scene instances are the meaningful "
                         "statistical axis for mean±std ATE")
    args = ap.parse_args(argv)

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gf_orb_slam_tpu.compile_cache import enable_compile_cache
    from gf_orb_slam_tpu.geometry import se3
    from gf_orb_slam_tpu.geometry.camera import CameraModel
    from gf_orb_slam_tpu.io_utils import evaluation, synthetic
    from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem

    enable_compile_cache()
    if args.settings:
        from gf_orb_slam_tpu.io_utils.settings import load_settings

        cam, cfg = load_settings(args.settings)
    elif args.synthetic and args.scene == "room":
        from gf_orb_slam_tpu.geometry.camera import EUROC_CAM

        cam = EUROC_CAM  # radtan distortion exercised end-to-end
        cfg = SlamConfig(max_frames_between_kf=6)
    else:
        cam = CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0,
                          width=752, height=480, fps=20.0)
        cfg = SlamConfig()
    if args.n_features:
        cfg.n_features = args.n_features
    if args.gf_budget > 0:
        cfg.use_gf = True
        cfg.gf_budget = args.gf_budget
        cfg.gf_mode = args.gf_mode
    if args.gf_warmup >= 0:
        cfg.gf_warmup_frames = args.gf_warmup
    if args.init_gate >= 0:
        cfg.init_min_points = args.init_gate
    if args.pipeline > 1:
        cfg.pipelined = True
        cfg.pipeline_depth = args.pipeline

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    system = SlamSystem(cam, cfg)
    if args.seed:
        system._seed = args.seed
        system._key = jax.random.PRNGKey(args.seed)
    from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod

    if args.vocabulary:
        system.set_vocabulary(voc_mod.load_vocabulary(args.vocabulary))
    else:
        # Packaged pretrained tree by default (ref loads ORBvoc at startup,
        # main.cc:92-97); falls back to on-the-fly training when absent.
        voc = voc_mod.load_default_vocabulary()
        if voc is not None:
            print(f"using packaged vocabulary ({voc.n_words} words)", file=sys.stderr)
            system.set_vocabulary(voc)
    if args.load_map:
        from gf_orb_slam_tpu.io_utils import snapshot

        system.load_map_state(*snapshot.load_map(args.load_map))

    gt_positions = None
    if args.synthetic:
        if args.scene == "room":
            scene = synthetic.make_room_scene(seed=args.scene_seed)
            # Constant ~1.3-1.45°/frame (tracking-safe); ≥~270 frames makes a
            # full revolution and the loop can close.
            ts, poses_gt = synthetic.circuit_trajectory(
                args.synthetic, fps=cam.fps, radius=4.0,
                revs=min(1.1, args.synthetic / 270.0),
            )
            render = synthetic.render_general
        else:
            scene = synthetic.make_scene(seed=args.scene_seed)
            ts, poses_gt = synthetic.trajectory(args.synthetic, fps=cam.fps)
            render = synthetic.render
        frames = ((float(ts[i]), render(scene, cam, jnp.asarray(poses_gt[i])))
                  for i in range(args.synthetic))
        gt_by_t = {round(float(t), 6): np.asarray(
            se3.pose_t(se3.inverse(jnp.asarray(p)))) for t, p in zip(ts, poses_gt)}
    else:
        from gf_orb_slam_tpu.io_utils.datasets import detect_and_load
        from gf_orb_slam_tpu.io_utils.prefetch import FramePrefetcher

        seq = detect_and_load(args.seq)
        gt_by_t = None

        def _frames():
            # Native C++ prefetcher decodes ahead of the tracker.
            with FramePrefetcher(seq.image_paths, cam.width, cam.height) as pf:
                for i, img in pf:
                    yield seq.timestamps[i], img

        frames = _frames()

    n = 0
    last_img = None
    for t, img in frames:
        log = system.process(jnp.asarray(img, jnp.float32), t)
        last_img = img
        n += 1
        if n % 50 == 0:
            print(f"[{n}] {log.state} inliers={log.n_inliers} "
                  f"kfs={system.n_kf} loops={system.n_loops_closed}", file=sys.stderr)
        if args.max_frames and n >= args.max_frames:
            break
    system.flush()

    if args.probe_stages and system.state.name == "WORKING" and last_img is not None:
        # On-chip per-stage attribution (ref TimeLog's ~25 stage fields,
        # Util.hpp:179-264): chained-dispatch deltas of fused-program
        # variants, attached to the TimeLog and the result JSON.
        from gf_orb_slam_tpu.io_utils.stage_probe import probe_device_stages

        probe_device_stages(system, jnp.asarray(last_img, jnp.float32))

    est_ts, est_poses = system.get_trajectory()
    evaluation.write_tum_trajectory(f"{args.out}_AllFrameTrajectory.txt", est_ts, est_poses)
    # KeyFrame trajectory (ref main.cc:186-215)
    kf_valid = np.asarray(system.map.kf_valid)
    kf_ts = np.asarray(system.map.kf_timestamp)[kf_valid]
    kf_poses = np.asarray(system.map.kf_pose)[kf_valid]
    order = np.argsort(kf_ts)
    evaluation.write_tum_trajectory(
        f"{args.out}_KeyFrameTrajectory.txt", kf_ts[order], kf_poses[order]
    )
    system.time_log.save(f"{args.out}_TimeLog.txt")
    if args.save_map:
        from gf_orb_slam_tpu.io_utils import snapshot

        snapshot.save_map(args.save_map, system.map, system.voc, system.bow_db)

    result = {
        "frames": n,
        "tracked": len(est_poses),
        "keyframes": int(system.n_kf),
        "map_points": int(system.map.pt_valid.sum()),
        "loops_closed": system.n_loops_closed,
        "timing": system.time_log.summary(),
    }
    if args.synthetic and len(est_poses) > 10:
        est_pos = np.stack(
            [np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in est_poses]
        )
        gt_pos = np.stack([gt_by_t[round(float(t), 6)] for t in est_ts])
        result["ate_rmse_m"] = evaluation.ate_rmse(est_pos, gt_pos)
    elif not args.synthetic:
        from gf_orb_slam_tpu.io_utils.datasets import associate_ground_truth

        gt_pos, ok = associate_ground_truth(seq, est_ts)
        if gt_pos is not None and ok.sum() > 10:
            est_pos = np.stack(
                [np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in est_poses]
            )
            result["ate_rmse_m"] = evaluation.ate_rmse(est_pos[ok], gt_pos[ok])

    print(json.dumps(result, indent=2, default=float))
    with open(f"{args.out}_result.json", "w") as f:
        json.dump(result, f, indent=2, default=float)
    return result


if __name__ == "__main__":
    main()
