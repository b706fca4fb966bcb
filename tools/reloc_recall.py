#!/usr/bin/env python
"""Relocalization recall statistic.

The reference's relocalization (Tracking::Relocalisation, cc:3854-4032: BoW
candidates → SearchByBoW → EPnP-RANSAC → pose optimize → widened search) has
only anecdotal evidence here so far (one blackout e2e test, one
snapshot-resume test). This tool measures it as a statistic with the same
rigor as tools/loop_recall.py: per {scene seed} on the room circuit, two
disturbance kinds, GF ON at the shipped budget:

  blackout — Nb black frames mid-sequence; the camera then continues from
             where it was. Recovery = tracker back in WORKING state.
  kidnap   — Nb black frames AND the camera teleports ~90° around the
             circuit (to a region already mapped on this revolution).
             Recovery requires relocalizing against genuinely old keyframes.

Reported per episode: recovered?, frames-to-recover (from first good frame
after the disturbance), and FALSE relocalizations — recovery whose next-10-
frame positions, mapped through the Sim3 alignment fitted on the
pre-disturbance trajectory segment, sit > err_th from GT (a wrong-place
relocalization would land ~meters off on this 8-unit-radius scene).

Usage:
  python tools/reloc_recall.py --seeds 5 --out docs/reloc_recall.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(seed: int, kind: str, n_frames: int, budget: int,
            blackout_len: int = 8, err_th: float = 0.5):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gf_orb_slam_tpu.geometry import se3
    from gf_orb_slam_tpu.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu.io_utils import evaluation, synthetic
    from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem, State
    from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod

    cam = EUROC_CAM
    scene = synthetic.make_room_scene(seed=seed)
    revs = min(1.1, n_frames / 270.0)
    ts, poses_gt = synthetic.circuit_trajectory(
        n_frames, fps=cam.fps,
        radius=4.0 - 0.2 * (seed % 3),
        revs=revs,
        phase=0.61 * seed,
    )
    cfg = SlamConfig(max_frames_between_kf=6, use_gf=budget > 0,
                     gf_budget=max(budget, 1))
    system = SlamSystem(cam, cfg)
    voc = voc_mod.load_default_vocabulary()
    if voc is not None:
        system.set_vocabulary(voc)
    system._seed = seed
    system._key = jax.random.PRNGKey(seed)

    # Disturbance schedule: one episode starting at ~60% of the sequence
    # (enough map behind it; enough frames after it to measure recovery).
    b0 = int(0.60 * n_frames)
    # Kidnap target: jump BACK ~90° (a quarter revolution) into already-mapped
    # territory — relocalization must match against old keyframes, not the
    # just-seen wall.
    jump = -int(0.25 * n_frames / revs)

    black = jnp.zeros((cam.height, cam.width), jnp.float32)
    frame_src = []   # GT index actually shown at each step (−1 = blackout)
    for i in range(n_frames):
        if b0 <= i < b0 + blackout_len:
            frame_src.append(-1)
        elif kind == "kidnap" and i >= b0 + blackout_len:
            frame_src.append(i + jump)
        else:
            frame_src.append(i)

    logs = []
    for i, src in enumerate(frame_src):
        if src < 0:
            img = black
        else:
            img = synthetic.render_general(scene, cam, jnp.asarray(poses_gt[src]))
        log = system.process(img, float(ts[i]))
        logs.append((src, log))
    system.flush()

    # Recovery: first WORKING frame with a pose after the blackout window.
    rec_frame = None
    for i in range(b0 + blackout_len, n_frames):
        src, log = logs[i]
        if log.state == "WORKING" and log.pose_cw is not None:
            rec_frame = i
            break

    # False-reloc check: align the PRE-disturbance estimated trajectory to GT
    # (Sim3 fixes the monocular gauge), then map the first 10 post-recovery
    # poses through that alignment and compare against the GT of the frames
    # actually shown.
    false_reloc = False
    post_err = None
    if rec_frame is not None:
        pre = [(i, lg) for i, (s, lg) in enumerate(logs[:b0])
               if lg.pose_cw is not None]
        est_pre = np.stack([
            np.asarray(se3.pose_t(se3.inverse(jnp.asarray(lg.pose_cw))))
            for _, lg in pre
        ])
        gt_pre = np.stack([
            np.asarray(se3.pose_t(se3.inverse(jnp.asarray(poses_gt[i]))))
            for i, _ in pre
        ])
        s, R, t = evaluation.umeyama_alignment(est_pre, gt_pre)
        post = [(src, lg) for src, lg in
                [logs[j] for j in range(rec_frame, min(rec_frame + 10, n_frames))]
                if lg.pose_cw is not None and src >= 0]
        if post:
            est_post = np.stack([
                np.asarray(se3.pose_t(se3.inverse(jnp.asarray(lg.pose_cw))))
                for _, lg in post
            ])
            gt_post = np.stack([
                np.asarray(se3.pose_t(se3.inverse(jnp.asarray(poses_gt[src]))))
                for src, _ in post
            ])
            aligned = (s * (R @ est_post.T)).T + t
            post_err = float(np.linalg.norm(aligned - gt_post, axis=1).mean())
            false_reloc = post_err > err_th
    return {
        "seed": seed,
        "kind": kind,
        "frames": n_frames,
        "blackout_at": b0,
        "blackout_len": blackout_len,
        "recovered": rec_frame is not None,
        "frames_to_recover": (rec_frame - (b0 + blackout_len)
                              if rec_frame is not None else None),
        "post_recovery_err_m": post_err,
        "false_reloc": bool(false_reloc),
        "keyframes": system.n_kf,
        "final_state": system.state.name,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--gf-budget", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="docs/reloc_recall.json")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    rows = []
    for seed in range(args.seeds):
        for kind in ("blackout", "kidnap"):
            r = run_one(seed, kind, args.frames, args.gf_budget)
            rows.append(r)
            print(json.dumps(r), flush=True)

    n = len(rows)
    rec = sum(1 for r in rows if r["recovered"] and not r["false_reloc"])
    ftr = [r["frames_to_recover"] for r in rows
           if r["recovered"] and not r["false_reloc"]]
    summary = {
        "runs": rows,
        "episodes": n,
        "recovered_true": rec,
        "recall": rec / n if n else None,
        "false_relocs": sum(1 for r in rows if r["false_reloc"]),
        "frames_to_recover": {
            "mean": sum(ftr) / len(ftr) if ftr else None,
            "max": max(ftr) if ftr else None,
            "all": ftr,
        },
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
