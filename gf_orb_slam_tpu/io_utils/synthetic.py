"""Synthetic multi-plane scene renderer with exact ground-truth poses.

Replaces the reference's rosbag-driven evaluation when no dataset is on disk:
a camera flies through a scene of textured fronto-parallel planes at different
depths (giving real parallax, so F-initialization and triangulation are
exercised), each frame rendered by exact ray-plane intersection + bilinear
texture sampling. Ground truth T_cw per frame enables ATE evaluation of the
full SLAM pipeline without any external data — the array-renderer equivalent
of the reference's synthetic-camera test fixtures (test/test_Greedy.cpp:81).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gf_orb_slam_tpu.geometry import quat, se3
from gf_orb_slam_tpu.geometry.camera import CameraModel


class PlaneScene(NamedTuple):
    textures: jnp.ndarray   # (n_planes, T, T) float32
    depths: jnp.ndarray     # (n_planes,) plane z in world
    centers: jnp.ndarray    # (n_planes, 2) world (x, y) of texture center
    extents: jnp.ndarray    # (n_planes,) half-size in world units
    tex_size: int


def make_scene(
    seed: int = 0, n_planes: int = 3, tex_size: int = 1024,
    depths=(6.0, 9.0, 14.0), extents=(5.0, 8.0, 14.0),
) -> PlaneScene:
    """Blobby high-contrast textures with fine noise (FAST-friendly)."""
    rng = np.random.default_rng(seed)
    texs = []
    for _ in range(n_planes):
        t = np.full((tex_size, tex_size), 128.0, np.float32)
        for _ in range(tex_size // 2):
            y, x = rng.integers(0, tex_size - 24, 2)
            sy, sx = rng.integers(6, 24, 2)
            t[y : y + sy, x : x + sx] = rng.uniform(10, 245)
        t += rng.uniform(-12, 12, t.shape).astype(np.float32)
        texs.append(np.clip(t, 0, 255))
    return PlaneScene(
        textures=jnp.asarray(np.stack(texs)),
        depths=jnp.asarray(depths[:n_planes], jnp.float32),
        centers=jnp.zeros((n_planes, 2), jnp.float32),
        extents=jnp.asarray(extents[:n_planes], jnp.float32),
        tex_size=tex_size,
    )


@partial(jax.jit, static_argnames=("cam",))
def render(scene: PlaneScene, cam: CameraModel, pose_cw: jnp.ndarray) -> jnp.ndarray:
    """Render one frame: per-pixel ray ↦ nearest plane intersection ↦ bilinear
    texture sample. (H, W) float32 in [0, 255]."""
    H, W = cam.height, cam.width
    yy = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    # Pixel rays in camera frame (no distortion in the synthetic camera).
    rx = (xx - cam.cx) / cam.fx
    ry = (yy - cam.cy) / cam.fy
    rays_c = jnp.stack([rx, ry, jnp.ones_like(rx)], axis=-1)  # (H, W, 3)

    pose_wc = se3.inverse(pose_cw)
    C = se3.pose_t(pose_wc)
    rays_w = quat.rotate(se3.pose_q(pose_wc)[None, None, :], rays_c)

    n_planes = scene.textures.shape[0]
    tex_px_per_unit = scene.tex_size / (2.0 * scene.extents)

    best_depth = jnp.full((H, W), jnp.inf)
    out = jnp.full((H, W), 96.0)  # background
    for p in range(n_planes):
        d = scene.depths[p]
        lam = (d - C[2]) / jnp.where(jnp.abs(rays_w[..., 2]) < 1e-9, 1e-9, rays_w[..., 2])
        Xw = C[None, None, :] + lam[..., None] * rays_w
        u = (Xw[..., 0] - scene.centers[p, 0] + scene.extents[p]) * tex_px_per_unit[p]
        v = (Xw[..., 1] - scene.centers[p, 1] + scene.extents[p]) * tex_px_per_unit[p]
        inside = (
            (lam > 0.1)
            & (u >= 0) & (u < scene.tex_size - 1)
            & (v >= 0) & (v < scene.tex_size - 1)
        )
        # Bilinear sample.
        u0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, scene.tex_size - 2)
        v0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, scene.tex_size - 2)
        fu, fv = u - u0, v - v0
        t = scene.textures[p]
        val = (
            t[v0, u0] * (1 - fu) * (1 - fv)
            + t[v0, u0 + 1] * fu * (1 - fv)
            + t[v0 + 1, u0] * (1 - fu) * fv
            + t[v0 + 1, u0 + 1] * fu * fv
        )
        closer = inside & (lam < best_depth)
        best_depth = jnp.where(closer, lam, best_depth)
        out = jnp.where(closer, val, out)
    return out


class GeneralScene(NamedTuple):
    """Arbitrary-pose textured planes (non-fronto-parallel geometry; walls of
    a room for 360° circuit sequences — the synthetic analogue of EuRoC MH's
    loopy machine-hall trajectories)."""

    textures: jnp.ndarray   # (n, T, T) float32
    plane_q: jnp.ndarray    # (n, 4) world←plane rotation; plane-local +z = normal
    plane_c: jnp.ndarray    # (n, 3) plane center in world
    extents: jnp.ndarray    # (n, 2) half-sizes (x, y) in world units
    tex_size: int


def _blob_texture(rng, tex_size):
    t = np.full((tex_size, tex_size), 128.0, np.float32)
    for _ in range(tex_size // 2):
        y, x = rng.integers(0, tex_size - 24, 2)
        sy, sx = rng.integers(6, 24, 2)
        t[y : y + sy, x : x + sx] = rng.uniform(10, 245)
    t += rng.uniform(-12, 12, t.shape).astype(np.float32)
    return np.clip(t, 0, 255)


TEXTURE_STYLES = ("blobs", "stripes", "checker", "smooth", "mixed")


def varied_texture(rng, tex_size: int = 1024, style: str | None = None):
    """A texture drawn from one of several families, with random gain/bias
    ("lighting"). Used to widen the vocabulary-training corpus beyond the
    single blob family — the descriptor statistics of
    stripes/checker/smooth-gradient surfaces differ materially from blobs.
    Not used by the deterministic benchmark scenes."""
    if style is None:
        style = TEXTURE_STYLES[rng.integers(len(TEXTURE_STYLES))]
    if style == "blobs":
        t = _blob_texture(rng, tex_size)
    elif style == "stripes":
        ang = rng.uniform(0, np.pi)
        period = rng.uniform(12, 80)
        yy, xx = np.mgrid[0:tex_size, 0:tex_size]
        ph = (np.cos(ang) * xx + np.sin(ang) * yy) / period
        t = 128.0 + 100.0 * np.sign(np.sin(2 * np.pi * ph))
        t += rng.uniform(-15, 15, t.shape)
    elif style == "checker":
        cell = int(rng.integers(8, 48))
        yy, xx = np.mgrid[0:tex_size, 0:tex_size]
        t = np.where(((yy // cell) + (xx // cell)) % 2 == 0, 40.0, 215.0)
        t += rng.uniform(-20, 20, t.shape)
    elif style == "smooth":
        # Band-limited noise: a coarse grid bilinearly upsampled, plus dots.
        coarse = rng.uniform(30, 225, (tex_size // 32, tex_size // 32))
        t = np.kron(coarse, np.ones((32, 32)))
        for _ in range(tex_size // 4):
            y, x = rng.integers(4, tex_size - 4, 2)
            t[y - 2 : y + 3, x - 2 : x + 3] = rng.uniform(0, 255)
    else:  # mixed: blobs over stripes
        t = 0.5 * _blob_texture(rng, tex_size) + 0.5 * varied_texture(
            rng, tex_size, "stripes"
        )
    gain = rng.uniform(0.55, 1.25)
    bias = rng.uniform(-30, 30)
    return np.clip(gain * (t - 128.0) + 128.0 + bias, 0, 255).astype(np.float32)


def make_room_scene(
    seed: int = 0, half_size: float = 8.0, height: float = 5.0,
    tex_size: int = 1024,
) -> GeneralScene:
    """A square room: 4 distinctly-textured walls facing inward. A camera
    circling the interior sees every wall obliquely (non-fronto-parallel) and
    revisits its starting view after a full 360° — the loop-closure scenario."""
    rng = np.random.default_rng(seed)
    texs, qs, cs, es = [], [], [], []
    for j in range(4):
        phi = j * np.pi / 2.0
        texs.append(_blob_texture(rng, tex_size))
        # Wall plane normal points inward: Ry(phi+pi) maps +z to -(sin,0,cos).
        qs.append(np.asarray(quat.v2q(jnp.asarray([0.0, phi + np.pi, 0.0], jnp.float32))))
        cs.append(half_size * np.asarray([np.sin(phi), 0.0, np.cos(phi)], np.float32))
        es.append([half_size, height])
    return GeneralScene(
        textures=jnp.asarray(np.stack(texs)),
        plane_q=jnp.asarray(np.stack(qs), jnp.float32),
        plane_c=jnp.asarray(np.stack(cs), jnp.float32),
        extents=jnp.asarray(es, jnp.float32),
        tex_size=tex_size,
    )


@partial(jax.jit, static_argnames=("cam",))
def render_general(
    scene: GeneralScene, cam: CameraModel, pose_cw: jnp.ndarray
) -> jnp.ndarray:
    """Render arbitrary-pose planes through the full camera model INCLUDING
    radtan distortion (when cam.has_distortion): each distorted pixel's ray is
    recovered with the same fixed-point undistortion the tracker uses, so the
    end-to-end undistortion path is exercised against exact ground truth."""
    from gf_orb_slam_tpu.geometry import camera as cam_mod

    H, W = cam.height, cam.width
    yy = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    uv = jnp.stack([xx, yy], axis=-1)
    xn = cam_mod.pixel_to_normalized(cam, uv)
    if cam.has_distortion:
        xn = cam_mod.undistort_normalized(cam, xn)
    rays_c = jnp.concatenate([xn, jnp.ones((H, W, 1))], axis=-1)

    pose_wc = se3.inverse(pose_cw)
    C = se3.pose_t(pose_wc)
    rays_w = quat.rotate(se3.pose_q(pose_wc)[None, None, :], rays_c)

    n_planes = scene.textures.shape[0]
    best_depth = jnp.full((H, W), jnp.inf)
    out = jnp.full((H, W), 96.0)
    for p in range(n_planes):
        R_wp = quat.q2r(scene.plane_q[p])
        n_w = R_wp[:, 2]
        denom = jnp.sum(rays_w * n_w, axis=-1)
        denom = jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
        lam = jnp.dot(scene.plane_c[p] - C, n_w) / denom
        Xw = C[None, None, :] + lam[..., None] * rays_w
        local = (Xw - scene.plane_c[p]) @ R_wp            # plane-local coords
        ex, ey = scene.extents[p, 0], scene.extents[p, 1]
        u = (local[..., 0] + ex) / (2.0 * ex) * scene.tex_size
        v = (local[..., 1] + ey) / (2.0 * ey) * scene.tex_size
        inside = (
            (lam > 0.1)
            & (u >= 0) & (u < scene.tex_size - 1)
            & (v >= 0) & (v < scene.tex_size - 1)
        )
        u0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, scene.tex_size - 2)
        v0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, scene.tex_size - 2)
        fu, fv = u - u0, v - v0
        t = scene.textures[p]
        val = (
            t[v0, u0] * (1 - fu) * (1 - fv)
            + t[v0, u0 + 1] * fu * (1 - fv)
            + t[v0 + 1, u0] * (1 - fu) * fv
            + t[v0 + 1, u0 + 1] * fu * fv
        )
        closer = inside & (lam < best_depth)
        best_depth = jnp.where(closer, lam, best_depth)
        out = jnp.where(closer, val, out)
    return out


def circuit_trajectory(
    n_frames: int, fps: float = 20.0, radius: float = 4.0, bob: float = 0.08,
    revs: float = 1.0, phase: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Camera orbits the room center looking radially outward, completing
    `revs` revolutions: every wall is approached obliquely, and after a full
    revolution the starting view recurs with whatever drift has accumulated —
    the canonical loop-closing sequence. Returns (timestamps, poses_cw)."""
    ts = np.arange(n_frames, dtype=np.float64) / fps
    poses = []
    for i in range(n_frames):
        th = phase + 2.0 * np.pi * revs * i / n_frames
        pos = np.asarray(
            [radius * np.sin(th), bob * np.sin(3.0 * th), radius * np.cos(th)],
            np.float32,
        )
        q_wc = quat.v2q(jnp.asarray([0.0, th, 0.0], jnp.float32))
        poses.append(np.asarray(se3.inverse(se3.make_pose(q_wc, jnp.asarray(pos)))))
    return ts.astype(np.float64), np.stack(poses)


def revisit_trajectory(
    n_frames: int, fps: float = 20.0, sweep: float = 4.0, yaw_amp: float = 0.35,
) -> tuple[np.ndarray, np.ndarray]:
    """Out-and-back circuit: the camera pans far enough right (translation +
    synchronized yaw) that the starting scene region leaves the frustum, then
    returns over the mapped area — exercising duplicate-point fusion and loop
    closing (the reference validates these on EuRoC's MH revisit sequences).

    Returns (timestamps (F,), poses_cw (F, 7)).
    """
    ts = np.arange(n_frames, dtype=np.float64) / fps
    poses = []
    for i in range(n_frames):
        phase = 2.0 * np.pi * i / n_frames
        tx = sweep * np.sin(phase)
        ty = 0.15 * np.sin(2.0 * phase)
        yaw = yaw_amp * np.sin(phase)
        q_wc = quat.v2q(jnp.asarray([0.0, yaw, 0.0], jnp.float32))
        t_wc = jnp.asarray([tx, ty, 0.0], jnp.float32)
        poses.append(np.asarray(se3.inverse(se3.make_pose(q_wc, t_wc))))
    return ts.astype(np.float64), np.stack(poses)


def trajectory(
    n_frames: int, fps: float = 20.0, radius: float = 1.2, forward: float = 0.4,
    yaw_amp: float = 0.06,
) -> tuple[np.ndarray, np.ndarray]:
    """Smooth figure trajectory: lateral sweep + slight forward/yaw motion.

    Returns (timestamps (F,), poses_cw (F, 7)) as numpy arrays.
    """
    ts = np.arange(n_frames, dtype=np.float64) / fps
    poses = []
    for i, t in enumerate(ts):
        phase = 2.0 * np.pi * t / (n_frames / fps)
        tx = radius * np.sin(phase)
        ty = 0.25 * radius * np.sin(2.0 * phase)
        tz = forward * np.sin(phase * 0.5)
        yaw = yaw_amp * np.sin(phase + 0.5)
        pitch = 0.4 * yaw_amp * np.cos(phase)
        q_wc = quat.v2q(jnp.asarray([pitch, yaw, 0.0], jnp.float32))
        t_wc = jnp.asarray([tx, ty, tz], jnp.float32)
        pose_wc = se3.make_pose(q_wc, t_wc)
        poses.append(np.asarray(se3.inverse(pose_wc)))
    return ts.astype(np.float64), np.stack(poses)
