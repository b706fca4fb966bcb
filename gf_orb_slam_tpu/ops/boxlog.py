"""Box-filtered Laplacian-of-Gaussian (BoxLOG) blob detector.

Reference: include/BoxLOG.hpp (~480 LoC, header-only) — an integral-image
approximation of multi-scale LoG blob detection, shipped as an experimental
alternative to FAST and compiled out by default (ORBextractor.h:38-42). This
version needs no integral images: a box filter is a depthwise convolution
with a constant kernel, and the LoG approximation (center box minus surround
box, scale-normalized) is two such convolutions per scale — all scales
evaluated as one batched conv, NMS over space and scale with reduce_window.

Enabled via OrbConfig-style plumbing when detector="boxlog" (the detector
produces (xy, response, valid) with the same contract as fast.detect_keypoints
so the rest of the extractor is unchanged).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _box_kernel(r: int, size: int) -> np.ndarray:
    k = np.zeros((size, size), np.float32)
    c = size // 2
    k[c - r : c + r + 1, c - r : c + r + 1] = 1.0 / ((2 * r + 1) ** 2)
    return k


@partial(jax.jit, static_argnames=("radii",))
def boxlog_response(img: jnp.ndarray, radii: tuple = (2, 3, 4, 6, 8)) -> jnp.ndarray:
    """(H, W) → (S, H, W) scale-normalized center-surround responses.

    LoG ≈ (surround box mean − center box mean); the box pair (r, 2r) matches
    the reference's difference-of-boxes construction.
    """
    size = 4 * max(radii) + 1
    kernels = []
    for r in radii:
        k = _box_kernel(2 * r, size) - _box_kernel(r, size)
        kernels.append(k)
    K = jnp.asarray(np.stack(kernels))[:, None, :, :]  # (S, 1, k, k)
    x = img[None, None].astype(jnp.float32)
    out = jax.lax.conv_general_dilated(
        x, K, (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW")
    )
    return jnp.abs(out[0])  # (S, H, W)


@partial(jax.jit, static_argnames=("n_keep", "radii", "threshold"))
def detect_blobs(
    img: jnp.ndarray,
    n_keep: int,
    threshold: float = 4.0,
    radii: tuple = (2, 3, 4, 6, 8),
):
    """Multi-scale blob detection with space+scale NMS; same output contract
    as fast.detect_keypoints: (xy (n,2), response (n,), valid (n,))."""
    resp = boxlog_response(img, radii)  # (S, H, W)
    neigh = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max, (len(radii), 3, 3), (1, 1, 1), "SAME"
    )
    peaks = jnp.where((resp >= neigh) & (resp > threshold), resp, 0.0)
    best_scale = jnp.max(peaks, axis=0)  # (H, W)

    # Mask the border where SAME padding corrupts the surround box.
    h, w = img.shape
    b = 2 * max(radii)
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    interior = (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    best_scale = jnp.where(interior, best_scale, 0.0)

    flat = best_scale.reshape(-1)
    vals, idx = jax.lax.top_k(flat, n_keep)
    w = img.shape[1]
    xy = jnp.stack(
        [(idx % w).astype(jnp.float32), (idx // w).astype(jnp.float32)], axis=-1
    )
    return xy, vals, vals > 0.0
