"""Benchmark: end-to-end monocular SLAM tracking throughput on one chip.

Runs the full pipeline (ORB extraction → motion-model tracking → local-map
tracking → keyframe/local-mapping work as scheduled) over a rendered synthetic
sequence and reports steady-state tracking frames/s.

Baseline: the reference (GF-ORB-SLAM, C++ on desktop CPU) tracks in real time
at ~30 Hz with the same per-frame feature load (SURVEY.md §6); vs_baseline is
frames/s ÷ 30. Prints exactly one JSON line.
"""

import json
import sys
import time


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gf_orb_slam_tpu.compile_cache import enable_compile_cache
    from gf_orb_slam_tpu.geometry.camera import CameraModel
    from gf_orb_slam_tpu.io_utils import synthetic
    from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem

    enable_compile_cache()

    cam = CameraModel(
        fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, fps=20.0
    )
    n_frames = 240
    warmup_frames = 24
    window = 12  # frames per measurement window

    scene = synthetic.make_scene(seed=0)
    ts, poses_gt = synthetic.trajectory(n_frames, fps=20.0)

    # Pre-render all frames (rendering is not part of tracking latency) and
    # materialize on device, with only coarse backpressure.
    frames = []
    for i in range(n_frames):
        img = synthetic.render(scene, cam, jnp.asarray(poses_gt[i]))
        if i % 16 == 15:
            img.block_until_ready()
        frames.append(img)
    frames[-1].block_until_ready()

    # PRIMARY metric: the shipped Good-Feature configuration (GF selection ON
    # at the reference's default budget — the system's namesake feature;
    # ref batch_script/Run_EuRoC.py budgets, README.md:14). GF-off plain
    # ORB-SLAM throughput is reported as a secondary line in detail.
    cfg = SlamConfig(
        n_features=800, max_frames_between_kf=10,
        use_gf=True, gf_budget=100, gf_warmup_frames=10,
        pipelined=True, pipeline_depth=8,
    )

    from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod

    voc = voc_mod.load_default_vocabulary()

    def make_system(c):
        s = SlamSystem(cam, c)
        if voc is not None:
            s.set_vocabulary(voc)  # packaged pretrained tree (ref ORBvoc)
        return s

    # GF-on and GF-off systems process the SAME frames in interleaved
    # windows within one process; the first measured window of each system
    # is dropped and the reported value is the median over the rest.
    system_on = make_system(cfg)
    system_off = make_system(cfg.__class__(**{**cfg.__dict__, "use_gf": False}))
    for i in range(warmup_frames):
        system_on.process(frames[i], float(ts[i]))
        system_off.process(frames[i], float(ts[i]))
    for s in (system_on, system_off):
        s.flush()
        s.warmup_compile()

    win_on, win_off = [], []
    w_starts = list(range(warmup_frames, n_frames, window))
    for wi, w0 in enumerate(w_starts):
        w1 = min(w0 + window, n_frames)
        # Alternate A/B order each window to cancel drift bias.
        order = (
            [(system_on, win_on), (system_off, win_off)]
            if wi % 2 == 0
            else [(system_off, win_off), (system_on, win_on)]
        )
        for sysm, acc in order:
            t0 = time.perf_counter()
            for i in range(w0, w1):
                sysm.process(frames[i], float(ts[i]))
            acc.append((w1 - w0) / max(time.perf_counter() - t0, 1e-9))
    for s in (system_on, system_off):
        s.flush()
        jax.block_until_ready(s.map.kf_pose)

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    fps = median(win_on[1:]) if len(win_on) > 1 else win_on[0]
    fps_gf_off = median(win_off[1:]) if len(win_off) > 1 else win_off[0]
    measured = n_frames - warmup_frames
    system = system_on
    n_tracked = sum(
        1 for lg in system.logs[warmup_frames:] if lg.pose_cw is not None
    )

    # Device-only throughput: chain 20 fused tracking dispatches (each
    # consuming the previous pose) with a single final fetch — the device's
    # steady-state rate with host round trips amortized.
    from gf_orb_slam_tpu.pipeline import tracking as trk

    pose = system.last_pose
    obs = system.last_obs
    uv = system.last_frame.uv
    vel = system.velocity
    key = jax.random.PRNGKey(1)
    chain = 20

    def one(i, pose, obs, uv, vel):
        return trk.track_frame_fused(
            system.cam, system.orb_cfg, system.map, system.track_view,
            frames[-1] + np.float32(i % 3),
            pose, obs, uv, vel, jnp.asarray(0.05, jnp.float32), key,
            use_gf=cfg.use_gf, gf_budget=cfg.gf_budget, gf_mode=cfg.gf_mode,
            gf_batch=cfg.gf_batch,
        )
    r = one(0, pose, obs, uv, vel)
    float(r.n_inliers)  # warm & sync
    t0 = time.perf_counter()
    for i in range(chain):
        r = one(i, r.pose, r.obs_point, r.frame_uv, r.velocity)
    float(r.n_inliers)  # single fetch drains the chain
    device_fps = chain / (time.perf_counter() - t0)

    baseline_fps = 30.0  # reference: real-time ~30 Hz tracking on desktop CPU
    print(
        json.dumps(
            {
                "metric": "tracking_frames_per_second",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / baseline_fps, 3),
                "detail": {
                    "frames_measured": measured,
                    "frames_tracked": n_tracked,
                    "gf": {"on": True, "budget": cfg.gf_budget, "mode": cfg.gf_mode},
                    "gf_off_fps": round(fps_gf_off, 2),
                    "n_features": 800,
                    "map_points": int(system.map.pt_valid.sum()),
                    "keyframes": system.n_kf,
                    "device": str(jax.devices()[0]),
                    "window_fps_gf_on": [round(f, 2) for f in win_on],
                    "window_fps_gf_off": [round(f, 2) for f in win_off],
                    "device_only_fps": round(device_fps, 2),
                    "note": "device_only_fps amortizes host round trips",
                },
            }
        )
    )


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # noqa: BLE001 — the driver needs a JSON line either way
        print(
            json.dumps(
                {
                    "metric": "tracking_frames_per_second",
                    "value": 0.0,
                    "unit": "frames/s",
                    "vs_baseline": 0.0,
                    "error": f"{type(e).__name__}: {e}",
                }
            )
        )
        sys.exit(1)
