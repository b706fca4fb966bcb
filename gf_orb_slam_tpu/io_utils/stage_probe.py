"""Device stage attribution for the production TimeLog.

The reference fills ~25 per-stage TimeLog fields by wall-clocking each stage
inline (Util.hpp:179-264, filled throughout Tracking.cc / LocalMapping.cc).
This rebuild fuses the whole frame (and the whole keyframe insertion) into
single device programs, so inline host timers see only one number per program
— which is why sweep JSONs used to report gf_selection / local_ba /
triangulation medians of 0.0.

This module recovers the reference's per-stage numbers by DELTA TIMING on the
device: progressively-larger prefixes of the fused tracking program, and
insertion variants with one stage compiled out, are each timed with chained
dispatches (every call consumes a scalar from the previous result so XLA
cannot overlap them; min over reps since host noise only inflates).
Differences between variants attribute the device cost of each stage:

    extraction       = t(make_frame)
    initial_track    = t(extract + motion model) − extraction
    local_map_track  = t(fused, GF off) − t(extract + motion model)
    gf_selection     = t(fused, GF on) − t(fused, GF off)
    keyframe_insert  = t(full insertion)
    triangulation    = t(full) − t(n_tri_neighbors=0)
    fusion           = t(full) − t(n_fuse_neighbors=0)
    local_ba         = t(full) − t(ba_iters=(0,0))

The probe runs once per sequence (or on demand) and its results are attached
to TimeLog.device_stages_ms, which summary() and the sweep JSONs surface next
to the host-side wall-clock medians. A per-link dispatch floor rides on
every absolute number; the deltas subtract it out.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from gf_orb_slam_tpu.mapping import frame as frame_mod
from gf_orb_slam_tpu.mapping import map_state as ms
from gf_orb_slam_tpu.pipeline import local_mapping
from gf_orb_slam_tpu.pipeline import tracking as trk


def _chain_time(fn, arg0, chain: int, reps: int = 3) -> float:
    """Chained-dispatch timing: seconds per call, min over reps."""
    s = jnp.float32(0)
    for _ in range(2):  # throwaway chain absorbs cache warm hits
        s = fn(arg0, s)
    float(s)
    best = float("inf")
    for _ in range(reps):
        s = jnp.float32(0)
        t0 = time.perf_counter()
        for _ in range(chain):
            s = fn(arg0, s)
        float(s)
        best = min(best, (time.perf_counter() - t0) / chain)
    return best


def probe_device_stages(system, img, chain: int = 8, reps: int = 3) -> dict:
    """Measure device per-stage times at the system's CURRENT config and map
    state. Returns {stage: ms} and attaches it to system.time_log.

    Call after the map is warm (a few keyframes in); the probe dispatches
    ~chain×reps×6 programs and leaves system state untouched (insertion
    variants run on copies — insert_keyframe_fused donates its map arg).
    """
    cam, cfg, orb_cfg = system.cam, system.cfg, system.orb_cfg
    m, view = system.map, system.track_view
    pose, obs, vel = system.last_pose, system.last_obs, system.velocity
    last_uv = system.last_frame.uv
    key = jax.random.PRNGKey(0)
    dt = jnp.asarray(0.05, jnp.float32)

    @jax.jit
    def s_extract(im, s):
        f = frame_mod.make_frame(im + s * 1e-12, cam, orb_cfg)
        return jnp.sum(f.uv) * 1e-6 + f.valid.sum().astype(jnp.float32)

    @jax.jit
    def s_motion(im, s):
        f = frame_mod.make_frame(im + s * 1e-12, cam, orb_cfg)
        r = trk.track_with_motion_model(
            cam, m, f, pose, obs, last_uv, scale=cfg.scale,
            n_levels=cfg.n_levels,
        )
        return r.n_inliers.astype(jnp.float32) + r.pose[4]

    def fused(gf: bool):
        def run(im, s):
            r = trk.track_frame_fused(
                cam, orb_cfg, m, view, im + s * 1e-12, pose, obs, last_uv,
                vel, dt, key, scale=cfg.scale, n_levels=cfg.n_levels,
                gf_budget=cfg.gf_budget, use_gf=gf, gf_mode=cfg.gf_mode,
                gf_batch=cfg.gf_batch,
            )
            return r.n_inliers.astype(jnp.float32) + r.pose[4]

        return run

    t_ext = _chain_time(s_extract, img, chain, reps)
    t_mot = _chain_time(s_motion, img, chain, reps)
    t_off = _chain_time(fused(False), img, chain, reps)
    t_gf = _chain_time(fused(True), img, chain, reps) if cfg.use_gf else t_off

    # --- insertion variants (chained map→map; donated arg → fresh copies) ---
    Nm = m.kp_capacity
    f = system.last_frame
    pad = Nm - f.capacity

    def pz(a, fill=0):
        if pad == 0:
            return a
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, widths, constant_values=fill)

    uv, oct_, ang = pz(f.uv), pz(f.octave), pz(f.angle)
    desc, val = pz(f.desc), pz(f.valid, False)
    obs_p = pz(obs, ms.NO_POINT)

    def insertion(kw):
        def run(_, s):
            m0 = jax.tree.map(
                lambda a: a + 0 if hasattr(a, "dtype") else a, m
            )
            out = None
            mm = m0._replace(pt_pos=m0.pt_pos + s * 1e-12)
            out = local_mapping.insert_keyframe_fused(
                cam, mm, pose, jnp.asarray(100000), jnp.asarray(0.0, jnp.float32),
                uv, oct_, ang, desc, val, obs_p,
                scale=cfg.scale, n_levels=cfg.n_levels,
                ba_window=cfg.ba_window, ba_fixed=cfg.ba_fixed,
                n_tri_neighbors=kw.get("n_tri_neighbors", cfg.triangulate_neighbors),
                ba_points=cfg.ba_points,
                ba_iters=kw.get("ba_iters", (5, 10)),
                n_fuse_neighbors=kw.get("n_fuse_neighbors", 4),
            )
            return out.kf_id.astype(jnp.float32) + out.m.pt_pos[0, 0] * 1e-12

        return run

    t_ins = _chain_time(insertion({}), None, max(chain // 2, 3), reps)
    t_no_tri = _chain_time(
        insertion({"n_tri_neighbors": 0}), None, max(chain // 2, 3), reps
    )
    t_no_fuse = _chain_time(
        insertion({"n_fuse_neighbors": 0}), None, max(chain // 2, 3), reps
    )
    t_ba0 = _chain_time(
        insertion({"ba_iters": (0, 0)}), None, max(chain // 2, 3), reps
    )

    out = {
        "extraction": t_ext * 1e3,
        "initial_track": max(t_mot - t_ext, 0.0) * 1e3,
        "local_map_track": max(t_off - t_mot, 0.0) * 1e3,
        "gf_selection": max(t_gf - t_off, 0.0) * 1e3,
        "keyframe_insert": t_ins * 1e3,
        "triangulation": max(t_ins - t_no_tri, 0.0) * 1e3,
        "fusion": max(t_ins - t_no_fuse, 0.0) * 1e3,
        "local_ba": max(t_ins - t_ba0, 0.0) * 1e3,
    }
    system.time_log.device_stages_ms = out
    return out
