#!/usr/bin/env python
"""Loop-verification gate precision/recall study.

The shipped verify chain (ref LoopClosing::ComputeSim3, cc:240-411) gates a
candidate on: 3-consecutive-KF temporal consistency → Sim3-RANSAC ≥20
inliers → guided rematch → OptimizeSim3 ≥20 inliers. Round 4 measured 7/8
episode recall at 0 false closures but could not say whether ≥20/≥20 sits on
the knee of the precision/recall curve or deep in the conservative tail —
there was no per-gate instrumentation.

This tool runs the shipped configuration (GF budget 100) over many distinct
room-circuit instances with `loop_probe_floor=8`: every candidate that
reaches streak ≥2 is SHADOW-VERIFIED with the RANSAC floor lowered to 8, so
its full funnel (n_bow → n_ransac → n_guided → n_opt) is recorded even when
the shipped thresholds would reject it, while the live accept decision keeps
the shipped ≥20/≥20 @ streak ≥3 rule (the recorded trajectory IS the shipped
system). GT labels come from the synthetic circuit's exact geometry.

--analyze then sweeps (consistency, ransac_th, refine_th) OFFLINE over the
recorded funnels and reports, per operating point: episode recall and false
accepts. Offline caveat (stated in the artifact): accepting a different
candidate earlier would alter the rest of that run; the projection holds
when closures are sparse, as here (≤2 per run).

Usage:
  python tools/loop_gate_study.py --seeds 10 --out docs/loop_gate_events.json
  python tools/loop_gate_study.py --analyze docs/loop_gate_events.json \
      --out docs/loop_gate_pr.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(seed: int, n_frames: int, revs: float, budget: int, probe_floor: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gf_orb_slam_tpu.geometry.camera import EUROC_CAM
    from gf_orb_slam_tpu.io_utils import synthetic
    from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem
    from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod

    cam = EUROC_CAM
    # Same distinct-instance scheme as tools/loop_recall.py: textures, start
    # phase AND orbit radius all vary per seed.
    scene = synthetic.make_room_scene(seed=seed)
    ts, poses_gt = synthetic.circuit_trajectory(
        n_frames, fps=cam.fps,
        radius=4.0 - 0.2 * (seed % 3),
        revs=revs,
        phase=0.61 * seed,
    )
    cfg = SlamConfig(
        max_frames_between_kf=6, use_gf=budget > 0, gf_budget=max(budget, 1),
        loop_probe_floor=probe_floor,
    )
    system = SlamSystem(cam, cfg)
    voc = voc_mod.load_default_vocabulary()
    if voc is not None:
        system.set_vocabulary(voc)
    system._seed = seed
    system._key = jax.random.PRNGKey(seed)

    theta = lambda fid: 2.0 * np.pi * revs * fid / n_frames  # noqa: E731

    def gt_overlap(fid_q: int, fid_k: int, max_deg: float = 25.0) -> bool:
        d = abs(theta(fid_q) - theta(fid_k)) % (2.0 * np.pi)
        d = min(d, 2.0 * np.pi - d)
        return d < np.deg2rad(max_deg)

    system.loop_gt_overlap = gt_overlap

    for i in range(n_frames):
        img = synthetic.render_general(scene, cam, jnp.asarray(poses_gt[i]))
        system.process(img, float(ts[i]))
    system.flush()

    # Episodes of consecutive revisit opportunities (as tools/loop_recall.py).
    episodes, cur = [], None
    for ev in system.loop_events:
        if ev["opportunity"]:
            if cur is None:
                cur = {"kfs": [ev["kf"]], "closed": ev["closed"]}
            else:
                cur["kfs"].append(ev["kf"])
                cur["closed"] = cur["closed"] or ev["closed"]
        else:
            if cur is not None:
                episodes.append(cur)
                cur = None
    if cur is not None:
        episodes.append(cur)

    return {
        "seed": seed,
        "frames": n_frames,
        "revs": revs,
        "state": system.state.name,
        "keyframes": system.n_kf,
        "closures_live": system.n_loops_closed,
        "episodes": episodes,
        "gate_events": system.loop_gate_events,
    }


def analyze(paths: list[str], out: str | None):
    runs = []
    for p in paths:
        with open(p) as f:
            runs.extend(json.load(f)["runs"])

    cand_events = [
        dict(ev, run=i) for i, r in enumerate(runs)
        for ev in r["gate_events"] if "cand" in ev
    ]
    n_episodes = sum(len(r["episodes"]) for r in runs)

    def passes(ev, cons, t_ransac, t_refine):
        return (
            ev["streak"] >= cons
            and ev["n_ransac"] >= t_ransac
            and ev["n_opt"] >= t_refine
        )

    table = []
    for cons in (2, 3):
        for t_r in (8, 10, 13, 15, 20):
            for t_o in (10, 15, 20, 25):
                closed = 0
                for i, r in enumerate(runs):
                    for ep in r["episodes"]:
                        kfset = set(ep["kfs"])
                        # An episode's verification rounds run while its
                        # opportunity keyframes are current (loop detection
                        # lags insertion by one finalize, hence the +1 slack).
                        hit = any(
                            ev["run"] == i
                            and any(abs(ev["kf"] - k) <= 1 for k in kfset)
                            and ev["gt_true"]
                            and passes(ev, cons, t_r, t_o)
                            for ev in cand_events
                        )
                        closed += hit
                false = sum(
                    1 for ev in cand_events
                    if ev["gt_true"] is False and passes(ev, cons, t_r, t_o)
                )
                table.append({
                    "consistency": cons, "ransac_th": t_r, "refine_th": t_o,
                    "episodes_closed": closed, "episodes": n_episodes,
                    "recall": closed / n_episodes if n_episodes else None,
                    "false_accepts": false,
                })

    live_closed = sum(1 for r in runs for ep in r["episodes"] if ep["closed"])
    result = {
        "n_runs": len(runs),
        "n_episodes": n_episodes,
        "live_closed_episodes": live_closed,
        "n_candidate_events": len(cand_events),
        "n_gt_true_events": sum(1 for e in cand_events if e["gt_true"]),
        "n_gt_false_events": sum(1 for e in cand_events if e["gt_true"] is False),
        "note": (
            "offline projection over shadow-verified funnels recorded at "
            "ransac_floor=8 under the shipped live decision (>=20/>=20 @ "
            "streak>=3); episode<->event association by keyframe id +/-1"
        ),
        "operating_points": table,
    }
    print(json.dumps({k: v for k, v in result.items() if k != "operating_points"},
                     indent=2))
    best = [t for t in table if t["false_accepts"] == 0]
    best.sort(key=lambda t: (-t["recall"], t["ransac_th"] + t["refine_th"]))
    print("top zero-false operating points:")
    for t in best[:8]:
        print(f"  cons={t['consistency']} ransac>={t['ransac_th']:>2} "
              f"refine>={t['refine_th']:>2}  recall={t['recall']:.3f} "
              f"({t['episodes_closed']}/{t['episodes']})")
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--revs", type=float, default=1.15)
    ap.add_argument("--endurance-extra", type=int, default=2,
                    help="additionally run this many 800-frame 2.2-rev seeds")
    ap.add_argument("--gf-budget", type=int, default=100)
    ap.add_argument("--probe-floor", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="docs/loop_gate_events.json")
    ap.add_argument("--analyze", nargs="*", default=None,
                    help="skip running; analyze these event JSONs")
    args = ap.parse_args()

    if args.analyze is not None:
        analyze(args.analyze, args.out)
        return

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    rows = []
    for seed in range(args.seeds):
        r = run_one(seed, args.frames, args.revs, args.gf_budget,
                    args.probe_floor)
        rows.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "gate_events"}),
              flush=True)
    for seed in range(args.endurance_extra):
        r = run_one(100 + seed, 800, 2.2, args.gf_budget, args.probe_floor)
        rows.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "gate_events"}),
              flush=True)

    with open(args.out, "w") as f:
        json.dump({"runs": rows}, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
