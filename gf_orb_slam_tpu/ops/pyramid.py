"""Image pyramid + Gaussian smoothing (ref ORBextractor::ComputePyramid,
src/ORBextractor.cc:922-966, and the pre-descriptor GaussianBlur at :842-854).

Dense whole-image ops: bilinear resize through jax.image and a separable
Gaussian as two 1-D convolutions — both fuse well under XLA and keep the
pyramid entirely on device.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float):
    """Static per-level (H, W) list — shapes must be known at trace time."""
    shapes = []
    for lv in range(n_levels):
        inv = 1.0 / (scale**lv)
        shapes.append((max(int(round(height * inv)), 16), max(int(round(width * inv)), 16)))
    return shapes


def _resize_matrix(n_out: int, n_in: int, antialias: bool = True) -> np.ndarray:
    """(n_out, n_in) linear-interpolation matrix with triangle antialiasing —
    resize as a dense matmul, which runs far faster than gather-based image
    resize."""
    scale = n_in / n_out
    support = max(scale, 1.0) if antialias else 1.0
    A = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        center = (o + 0.5) * scale - 0.5
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        idx = np.clip(np.arange(lo, hi + 1), 0, n_in - 1)
        w = np.maximum(0.0, 1.0 - np.abs(np.arange(lo, hi + 1) - center) / support)
        if w.sum() > 0:
            np.add.at(A[o], idx, w / w.sum())
    return A


@lru_cache(maxsize=None)
def _resize_mats(h_out: int, w_out: int, h_in: int, w_in: int):
    # Cache NUMPY (not device arrays): device constants created inside one jit
    # trace must not be reused by another (tracer leak on some backends).
    return _resize_matrix(h_out, h_in), _resize_matrix(w_out, w_in)


def resize_matmul(img: jnp.ndarray, shape: tuple[int, int]) -> jnp.ndarray:
    """Bilinear+antialias resize as two matmuls: A_h @ img @ A_wᵀ."""
    Ah, Aw = _resize_mats(shape[0], shape[1], img.shape[0], img.shape[1])
    return (jnp.asarray(Ah) @ img) @ jnp.asarray(Aw).T


def build_pyramid_chain(img: jnp.ndarray, n_levels: int, scale: float) -> list[jnp.ndarray]:
    """Sequential per-level cascade (each level resampled from the previous —
    the reference's ComputePyramid structure). 16 small matmuls whose latency
    adds up; kept as the reference implementation for equivalence tests of
    build_pyramid."""
    shapes = pyramid_shapes(img.shape[0], img.shape[1], n_levels, scale)
    levels = [img.astype(jnp.float32)]
    for lv in range(1, n_levels):
        levels.append(resize_matmul(levels[-1], shapes[lv]))
    return levels


def build_pyramid(img: jnp.ndarray, n_levels: int, scale: float) -> list[jnp.ndarray]:
    """Grayscale f32 [H, W] → list of n_levels images, level l scaled by scale^-l.

    Numerically the same cascade as build_pyramid_chain (resize is linear, so
    the per-level chain composes into one constant matrix per level — composed
    in float64 on the host), but executed as 2 batched matmuls + cheap
    slices instead of 16 latency-bound small ones. Downstream per-level ops
    keep their tight shapes, so only the resize gets the batched treatment —
    a fully padded-stack pipeline was measured SLOWER (2.6× the pixels through
    every dense pass outweighs the latency saved).
    """
    shapes = pyramid_shapes(img.shape[0], img.shape[1], n_levels, scale)
    stack = build_pyramid_stack(img, n_levels, scale)
    return [stack[lv, : h, : w] for lv, (h, w) in enumerate(shapes)]


@lru_cache(maxsize=None)
def _chain_resize_mats(h0: int, w0: int, n_levels: int, scale: float):
    """(L, h0, h0) and (L, w0, w0) composed-chain resize matrices: level l's
    rows [:h_l] map the ORIGINAL image to level l exactly as the sequential
    level-by-level cascade does (each level resampled from the previous one —
    resize is linear, so the cascade composes into one matrix per level;
    composition runs in float64 on the host, so it is at least as accurate as
    chaining f32 matmuls). Rows/cols beyond the level's extent are zero, so
    the padded canvas region of every level is exactly 0."""
    shapes = pyramid_shapes(h0, w0, n_levels, scale)
    Rrow = np.zeros((n_levels, h0, h0), np.float64)
    Rcol = np.zeros((n_levels, w0, w0), np.float64)
    cur_r = np.eye(h0)
    cur_c = np.eye(w0)
    for lv, (hl, wl) in enumerate(shapes):
        if lv > 0:
            Ah, Aw = _resize_mats(hl, wl, shapes[lv - 1][0], shapes[lv - 1][1])
            cur_r = Ah.astype(np.float64) @ cur_r
            cur_c = Aw.astype(np.float64) @ cur_c
        Rrow[lv, :hl, :] = cur_r
        Rcol[lv, :wl, :] = cur_c
    return Rrow.astype(np.float32), Rcol.astype(np.float32)


def build_pyramid_stack(img: jnp.ndarray, n_levels: int, scale: float) -> jnp.ndarray:
    """All pyramid levels as ONE (L, H0, W0) tensor (level l occupies the
    top-left (h_l, w_l) corner; the rest is zero) via two batched matmuls.

    The sequential per-level chain is 16 small latency-bound matmuls; this is
    2 large ones (~7 GFLOP)."""
    Rr, Rc = _chain_resize_mats(img.shape[0], img.shape[1], n_levels, scale)
    t = jnp.einsum("lij,jw->liw", jnp.asarray(Rr), img.astype(jnp.float32))
    return jnp.einsum("liw,lmw->lim", t, jnp.asarray(Rc))


def _gaussian_kernel_1d(sigma: float, ksize: int) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@partial(jax.jit, static_argnames=("sigma", "ksize"))
def gaussian_blur(img: jnp.ndarray, sigma: float = 2.0, ksize: int = 7) -> jnp.ndarray:
    """Separable Gaussian with replicate padding (matches cv::GaussianBlur's
    default BORDER_REFLECT_101 closely enough for descriptor sampling)."""
    k = jnp.asarray(_gaussian_kernel_1d(sigma, ksize))
    r = ksize // 2
    x = img.astype(jnp.float32)
    xp = jnp.pad(x, ((0, 0), (r, r)), mode="reflect")
    # Horizontal pass: conv as weighted sum of shifted slices (vectorized; XLA
    # fuses this into a single pass — avoids conv layout overhead for 1ch).
    h = sum(xp[:, i : i + x.shape[1]] * k[i] for i in range(ksize))
    hp = jnp.pad(h, ((r, r), (0, 0)), mode="reflect")
    v = sum(hp[i : i + x.shape[0], :] * k[i] for i in range(ksize))
    return v


def scale_factors(n_levels: int, scale: float) -> np.ndarray:
    """Per-level scale factors [scale^l], matching ref mvScaleFactor."""
    return np.asarray([scale**lv for lv in range(n_levels)], dtype=np.float32)


def level_sigma2(n_levels: int, scale: float) -> np.ndarray:
    """Per-level measurement noise variance, ref mvLevelSigma2 (Frame.cc ctor)."""
    return scale_factors(n_levels, scale) ** 2


def features_per_level(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Geometric per-level quota (ref ORBextractor ctor, cc:478-494)."""
    factor = 1.0 / scale
    n_first = n_features * (1.0 - factor) / (1.0 - factor**n_levels)
    quotas = []
    acc = 0
    for lv in range(n_levels - 1):
        q = int(round(n_first * factor**lv))
        quotas.append(q)
        acc += q
    quotas.append(max(n_features - acc, 0))
    return quotas
