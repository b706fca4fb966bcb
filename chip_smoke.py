#!/usr/bin/env python
"""Smoke run of the SLAM main path on one NVIDIA GPU, in one process.

Width is what the package supports for an EuRoC-shaped stream: a 752x480
camera at 20 Hz, 800 ORB features, a 4096-point tracking view, 256 keyframes,
16384 map points, the packaged 1M-word vocabulary and GF subset selection at
budget 100. Phases:

  device   refuse any platform but the GPU; print the card's name and limit
  hamming  matching.hamming_matrix at (800, 4096) and (1600, 4096) exactly
           equal to a numpy XOR+popcount
  pyramid  build_pyramid_stack on a 752x480 render within 1e-3 intensity of
           the float64 numpy resize, under the package's float32 default
  pose     pose_opt.optimize_pose on the GPU against the CPU backend, within
           1e-4 m and 1e-4 rad
  plane    120-frame plane sweep, GF-100 subset, pipelined: tracked, keyframes
           and ATE
  reloc    blackout sequence: LOST inside the blackout, WORKING after it
  room     300-frame radtan room circuit through run_slam: a loop closes

Usage:  python chip_smoke.py

Wall and compile times and peak device memory are printed as smoke
observations, not benchmark metrics. The last line of standard output is
{"ok": true, "device": {...}} only when every phase passed; otherwise the
script exits non-zero without it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

from gf_orb_slam_tpu.compile_cache import enable_compile_cache
from gf_orb_slam_tpu.geometry import camera, quat, se3
from gf_orb_slam_tpu.io_utils import evaluation, synthetic
from gf_orb_slam_tpu.ops import matching, pyramid
from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem
from gf_orb_slam_tpu.retrieval import vocabulary as voc_mod
from gf_orb_slam_tpu.solvers import pose_opt

# EuRoC-shaped pinhole camera (the plane sweep's; the room circuit uses the
# radtan EUROC_CAM through run_slam).
EUROC_PINHOLE = camera.CameraModel(
    fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, fps=20.0
)
HAMMING_SHAPES = ((800, 4096), (1600, 4096))
PYRAMID_TOL = 1e-3      # intensity units, on a 0..255 image
POSE_TOL_M = 1e-4
POSE_TOL_RAD = 1e-4
PLANE_ATE_M = 0.08
ROOM_ATE_M = 0.1


class SmokeFailure(Exception):
    """A phase's result is outside its bound."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def require_gpu():
    """The first JAX device, which must be a GPU: no fallback to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX found platform {dev.platform!r}"
        )
    return dev


def card_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


class CompileClock:
    """Sums JAX's backend-compile durations (persistent-cache loads included)."""

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration


# ---------------------------------------------------------------------------
# Kernel and precision checks
# ---------------------------------------------------------------------------

_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def hamming_reference(desc_q: np.ndarray, desc_t: np.ndarray) -> np.ndarray:
    """Plain numpy XOR+popcount over packed uint32 descriptors."""
    out = np.empty((desc_q.shape[0], desc_t.shape[0]), np.int32)
    for r0 in range(0, desc_q.shape[0], 128):
        x = np.bitwise_xor(desc_q[r0:r0 + 128, None, :], desc_t[None, :, :])
        out[r0:r0 + 128] = _POPCOUNT8[x.view(np.uint8)].sum(axis=-1)
    return out


def random_descriptors(n: int, rng: np.random.Generator) -> np.ndarray:
    d = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    d[0] = 0             # extremes: distance 0 and 256 both occur
    d[-1] = 0xFFFFFFFF
    return d


def check_hamming(nq: int, nt: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    q, t = random_descriptors(nq, rng), random_descriptors(nt, rng)
    got = np.asarray(jax.jit(matching.hamming_matrix)(q, t))
    want = hamming_reference(q, t)
    check(got.shape == want.shape and got.dtype == np.int32,
          f"hamming {nq}x{nt}: shape {got.shape} dtype {got.dtype}")
    n_diff = int(np.count_nonzero(got != want))
    check(n_diff == 0, f"hamming {nq}x{nt}: {n_diff} entries differ from numpy")
    return {"shape": [nq, nt], "entries_differing": n_diff}


def _pyramid_reference(img: np.ndarray, n_levels: int, scale: float) -> np.ndarray:
    Rr, Rc = pyramid._chain_resize_mats(img.shape[0], img.shape[1], n_levels, scale)
    t = Rr.astype(np.float64) @ img.astype(np.float64)
    return t @ np.swapaxes(Rc.astype(np.float64), 1, 2)


def check_pyramid(img: np.ndarray, n_levels: int = 8, scale: float = 1.2) -> dict:
    """The pyramid resize is two batched f32 matmuls: under the package's
    float32 default it holds 1e-3 intensity units; TF32 (10 mantissa bits)
    would miss that by about two orders of magnitude, so this is the check
    that the precision default holds on the card."""
    want = _pyramid_reference(img, n_levels, scale)

    def run():
        f = jax.jit(pyramid.build_pyramid_stack, static_argnums=(1, 2))
        return np.asarray(f(jnp.asarray(img), n_levels, scale), np.float64)

    err = float(np.abs(run() - want).max())
    with jax.default_matmul_precision("tensorfloat32"):
        err_tf32 = float(np.abs(run() - want).max())
    check(err <= PYRAMID_TOL, f"pyramid: max abs diff {err} > {PYRAMID_TOL}")
    return {"max_abs_diff": err, "bound": PYRAMID_TOL, "tf32_max_abs_diff": err_tf32,
            "tf32": f"under TF32 the error is {err_tf32 / PYRAMID_TOL:.0f}x the bound "
                    "(about two orders of magnitude on an H100)"}


def pose_problem(seed: int = 0, n: int = 800):
    """Perturbed synthetic pose problem: n landmarks in the EuRoC camera's
    frustum, 0.3 px noise, 10% gross outliers."""
    rng = np.random.default_rng(seed)
    cam = camera.EUROC_CAM
    w = rng.normal(size=3) * 0.1
    pose_gt = se3.make_pose(quat.v2q(jnp.asarray(w, jnp.float32)),
                            jnp.asarray(rng.normal(size=3) * 0.5, jnp.float32))
    uv = rng.uniform([60, 60], [cam.width - 60, cam.height - 60], size=(n, 2))
    z = rng.uniform(4.0, 12.0, size=n)
    xc = camera.backproject(cam, jnp.asarray(uv, jnp.float32), jnp.asarray(z, jnp.float32))
    pts = np.asarray(se3.transform_point(se3.inverse(pose_gt), xc), np.float32)
    uv_obs = uv + rng.normal(size=(n, 2)) * 0.3
    n_out = n // 10
    uv_obs[:n_out] += rng.uniform(20, 80, size=(n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    xi = rng.normal(size=6) * 0.05
    pose0 = np.asarray(se3.apply_left_update(jnp.asarray(xi, jnp.float32), pose_gt))
    args = (pose0, pts, uv_obs.astype(np.float32), np.ones(n, np.float32), np.ones(n, bool))
    return cam, np.asarray(pose_gt), args


def _rotation_angle(q_a, q_b) -> float:
    dq = quat.qprod(quat.qconj(jnp.asarray(q_a)), jnp.asarray(q_b))
    return float(np.linalg.norm(np.asarray(quat.q2v(dq))))


def check_pose(seed: int = 0) -> dict:
    cam, pose_gt, args = pose_problem(seed)
    gpu = np.asarray(pose_opt.optimize_pose(cam, *args).pose)
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu_args = jax.device_put(args, cpu_dev)
        cpu = np.asarray(pose_opt.optimize_pose(cam, *cpu_args).pose)
    dt = float(np.linalg.norm(gpu[4:] - cpu[4:]))
    dr = _rotation_angle(gpu[:4], cpu[:4])
    check(dt <= POSE_TOL_M and dr <= POSE_TOL_RAD,
          f"pose: GPU vs CPU {dt:.3g} m, {dr:.3g} rad")
    gt_err = float(np.linalg.norm(gpu[4:] - pose_gt[4:]))
    check(gt_err < 0.01, f"pose: {gt_err:.3g} m from ground truth")
    return {"gpu_vs_cpu_m": dt, "gpu_vs_cpu_rad": dr, "gpu_vs_truth_m": gt_err}


# ---------------------------------------------------------------------------
# End-to-end phases
# ---------------------------------------------------------------------------

def plane_config() -> SlamConfig:
    """bench.py's configuration: GF subset at budget 100, pipelined."""
    return SlamConfig(
        n_features=800, max_frames_between_kf=10,
        use_gf=True, gf_budget=100, gf_warmup_frames=10,
        pipelined=True, pipeline_depth=8,
    )


def make_system(cam, cfg, voc) -> SlamSystem:
    system = SlamSystem(cam, cfg)
    if voc is not None:
        system.set_vocabulary(voc)
    return system


def trajectory_ate(system: SlamSystem, ts, poses_gt) -> float | None:
    est_ts, est_poses = system.get_trajectory()
    if len(est_poses) < 5:
        return None
    centers = jax.jit(jax.vmap(lambda p: se3.pose_t(se3.inverse(p))))
    row = {round(float(t), 6): i for i, t in enumerate(ts)}
    gt_idx = [row[round(float(t), 6)] for t in est_ts]
    est = np.asarray(centers(jnp.asarray(est_poses)))
    gt = np.asarray(centers(jnp.asarray(poses_gt[gt_idx])))
    return evaluation.ate_rmse(est, gt)


def run_plane_sweep(voc, cfg=None, n_frames: int = 120) -> dict:
    cam, cfg = EUROC_PINHOLE, cfg or plane_config()
    scene = synthetic.make_scene(seed=0)
    ts, poses_gt = synthetic.trajectory(n_frames, fps=cam.fps)
    system = make_system(cam, cfg, voc)
    for i in range(n_frames):
        system.process(synthetic.render(scene, cam, jnp.asarray(poses_gt[i])), float(ts[i]))
    system.flush()
    tracked = len(system.trajectory)
    ate = trajectory_ate(system, ts, poses_gt)
    out = {"frames": n_frames, "tracked": tracked, "keyframes": system.n_kf,
           "map_points": int(system.map.pt_valid.sum()), "ate_m": ate}
    check(tracked >= 0.9 * n_frames, f"plane: tracked {tracked}/{n_frames}")
    check(system.n_kf >= 4, f"plane: {system.n_kf} keyframes")
    check(ate is not None and ate < PLANE_ATE_M, f"plane: ATE {ate} m")
    return out


def run_relocalization(voc, n_frames: int = 55, blackout=(35, 40),
                       n_features: int = 800) -> dict:
    """ref Tracking::Relocalisation: black frames lose tracking; BoW + PnP
    relocalization recovers once the scene is back."""
    cam = EUROC_PINHOLE
    scene = synthetic.make_scene(seed=0)
    ts, poses_gt = synthetic.trajectory(n_frames, fps=cam.fps)
    cfg = SlamConfig(n_features=n_features, max_frames_between_kf=6, vocab_train_kfs=4)
    system = make_system(cam, cfg, voc)
    black = jnp.zeros((cam.height, cam.width), jnp.float32)
    b0, b1 = blackout
    states = []
    for i in range(n_frames):
        img = black if b0 <= i < b1 else synthetic.render(scene, cam, jnp.asarray(poses_gt[i]))
        states.append(system.process(img, float(ts[i])).state)
    lost = "LOST" in states[b0:b1 + 1]
    back = next((i for i in range(b1, n_frames) if states[i] == "WORKING"), None)
    check(lost, f"reloc: never LOST in the blackout: {states[b0:b1 + 1]}")
    check(back is not None, f"reloc: not WORKING after the blackout: {states[b1:]}")
    return {"lost_in_blackout": lost, "working_again_at_frame": back,
            "frames_after_blackout": back - b1}


def run_room_circuit(n_frames: int = 300) -> dict:
    import run_slam

    with tempfile.TemporaryDirectory() as tmp:
        res = run_slam.main([
            "--synthetic", str(n_frames), "--scene", "room", "--out", f"{tmp}/room",
        ])
    out = {k: res.get(k) for k in ("frames", "tracked", "keyframes", "loops_closed", "ate_rmse_m")}
    check(res["tracked"] > 0.9 * n_frames, f"room: tracked {res['tracked']}/{n_frames}")
    check(res["loops_closed"] >= 1, "room: no loop closed")
    check(res.get("ate_rmse_m", 1e9) < ROOM_ATE_M, f"room: ATE {res.get('ate_rmse_m')} m")
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    enable_compile_cache()
    dev = require_gpu()
    print(f"device: platform={dev.platform} kind={dev.device_kind} count={len(jax.devices())}")
    print(f"card (name, power.limit): {card_name_and_power_limit()}")
    clock = CompileClock()
    voc = voc_mod.load_default_vocabulary()
    check(voc is not None, "packaged vocabulary missing")
    img = np.asarray(synthetic.render(
        synthetic.make_scene(seed=0), EUROC_PINHOLE,
        jnp.asarray(synthetic.trajectory(2, fps=20.0)[1][0]),
    ))
    phases = [(f"hamming {nq}x{nt}", lambda nq=nq, nt=nt: check_hamming(nq, nt))
              for nq, nt in HAMMING_SHAPES]
    phases += [
        ("pyramid", lambda: check_pyramid(img)),
        ("pose", check_pose),
        ("plane", lambda: run_plane_sweep(voc)),
        ("reloc", lambda: run_relocalization(voc)),
        ("room", run_room_circuit),
    ]
    failed = []
    for name, fn in phases:
        t0, c0 = time.perf_counter(), clock.seconds
        try:
            result = fn()
        except Exception as e:  # recorded as a failure; the run exits non-zero
            failed.append(name)
            traceback.print_exc()
            print(f"phase {name}: FAILED {type(e).__name__}: {e}", flush=True)
            continue
        wall, comp = time.perf_counter() - t0, clock.seconds - c0
        peak = dev.memory_stats().get("peak_bytes_in_use")
        print(f"phase {name}: ok {json.dumps(result, default=float)} "
              f"[smoke observation: wall {wall:.1f} s, backend compile {comp:.1f} s, "
              f"peak device bytes {peak}]", flush=True)
    if failed:
        print(f"chip_smoke: {len(failed)} phase(s) failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
