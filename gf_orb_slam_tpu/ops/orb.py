"""ORB keypoint orientation + rBRIEF-256 descriptors, and the full extractor.

Reference: ORBextractor (src/ORBextractor.cc:769-920 operator(), :131 IC_Angle,
:204-462 pattern + computeDescriptors). Device redesign:

* IC_Angle becomes a dense 2-channel 31×31 convolution producing the (m10, m01)
  intensity-centroid moment maps for the whole image, sampled at keypoints —
  matmul-friendly dense compute instead of per-keypoint scalar loops.
* rBRIEF uses the classic 30-bin rotation quantization (2π/30 like the
  original ORB), with all 30 rotated copies of the 256-pair sampling pattern
  precomputed host-side; descriptor sampling is then a single batched gather
  from the blurred level image followed by vectorized bit packing to
  [N, 8] uint32.
* The sampling pattern itself is generated from a seeded Gaussian distribution
  per the original BRIEF/ORB recipe (σ = patch/5, pairs deduplicated) — a
  from-scratch pattern, not the OpenCV learned table; matching quality is
  validated statistically in tests (descriptor invariance under rotation).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gf_orb_slam_tpu.ops import fast as fast_ops
from gf_orb_slam_tpu.ops import pyramid as pyr

HALF_PATCH = 15
EDGE_MARGIN = 19  # ref EDGE_THRESHOLD (ORBextractor.cc:58)
N_ROT_BINS = 30
N_BITS = 256
N_WORDS = 8  # 256 bits as 8 × uint32


# ---------------------------------------------------------------------------
# Sampling pattern
# ---------------------------------------------------------------------------


def make_brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 2, 2) int32 — 256 point pairs (p, q) in patch coords.

    Gaussian-II sampling from the BRIEF paper: p ~ N(0, (S/5)²),
    q ~ N(p, (S/25)²)·? — we use the simpler isotropic variant with both points
    ~ N(0, (S/5)²) clipped to the 31×31 patch, deduplicated, which empirically
    gives near-ORB matching quality once rotation-steered.
    """
    rng = np.random.default_rng(seed)
    sigma = (2 * HALF_PATCH + 1) / 5.0
    pairs = []
    seen = set()
    while len(pairs) < N_BITS:
        p = np.clip(np.round(rng.normal(0, sigma, 2)), -13, 13).astype(np.int32)
        q = np.clip(np.round(rng.normal(0, sigma, 2)), -13, 13).astype(np.int32)
        key = (p[0], p[1], q[0], q[1])
        if (p == q).all() or key in seen:
            continue
        seen.add(key)
        pairs.append((p, q))
    return np.asarray(pairs, dtype=np.int32)  # (256, 2 points, 2=[x,y])


def rotated_patterns(pattern: np.ndarray) -> np.ndarray:
    """(30, 256, 2, 2) int32 — pattern pre-rotated at 12° steps (ORB's
    quantized steering; original paper section 4.1)."""
    out = np.zeros((N_ROT_BINS, N_BITS, 2, 2), dtype=np.int32)
    for b in range(N_ROT_BINS):
        th = 2.0 * np.pi * b / N_ROT_BINS
        c, s = np.cos(th), np.sin(th)
        x, y = pattern[..., 0], pattern[..., 1]
        out[b, ..., 0] = np.round(c * x - s * y)
        out[b, ..., 1] = np.round(s * x + c * y)
    return out


_PATTERN = make_brief_pattern()
_ROT_PATTERNS = rotated_patterns(_PATTERN)  # host-side numpy; closed over jit


# ---------------------------------------------------------------------------
# Orientation (IC_Angle)
# ---------------------------------------------------------------------------


def _moment_masks() -> np.ndarray:
    """(2, 31, 31) x- and y-weighted circular-disc masks."""
    r = HALF_PATCH
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    disc = (xs * xs + ys * ys) <= r * r
    return np.stack([xs * disc, ys * disc]).astype(np.float32)


def moment_maps_circular(img: jnp.ndarray) -> jnp.ndarray:
    """Exact circular-disc (m10, m01) maps via one dense 31×31 conv — the
    reference-faithful version (slow: ~0.7 GMAC/frame)."""
    masks = jnp.asarray(_moment_masks())  # (2, 31, 31)
    x = img[None, None, :, :].astype(jnp.float32)
    k = masks[:, None, :, :]  # OIHW
    out = jax.lax.conv_general_dilated(
        x, k, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return out[0]  # (2, H, W)


def moment_maps(img: jnp.ndarray) -> jnp.ndarray:
    """(2, H, W) circular-disc centroid-moment maps, as one bf16 conv.

    The disc support must stay circular — a square window does not commute
    with image rotation, which breaks descriptor steering. bf16 inputs halve
    the conv cost; moments are large sums, so the 0.4% relative error moves
    the IC angle by ≲0.3°, far below the 12° steering bin.
    """
    masks = jnp.asarray(_moment_masks())  # (2, 31, 31)
    x = img[None, None, :, :].astype(jnp.bfloat16)
    k = masks[:, None, :, :].astype(jnp.bfloat16)
    out = jax.lax.conv_general_dilated(
        x, k, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32,
    )
    return out[0]  # (2, H, W)


_MOMENT_FLAT = _moment_masks().reshape(2, -1).T  # (961, 2) numpy, closed over jit


def ic_angles(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Keypoint orientations in radians [0, 2π) (ref IC_Angle cc:131-160).

    Dense 31×31 moment convs over the whole image are costly
    (1-input-channel convs map poorly onto matrix units); moments are only
    needed AT the keypoints, so gather the N 31×31 patches (one flat gather) and reduce against the two
    disc masks with a single (N, 961) @ (961, 2) matmul instead.
    """
    h, w = img.shape
    r = HALF_PATCH
    xi = jnp.clip(xy[..., 0].astype(jnp.int32), r, w - 1 - r)
    yi = jnp.clip(xy[..., 1].astype(jnp.int32), r, h - 1 - r)
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    offs = jnp.asarray((dy * w + dx).reshape(-1), jnp.int32)      # (961,)
    idx = (yi * w + xi)[:, None] + offs[None, :]                  # (N, 961)
    patches = jnp.take(img.reshape(-1), idx, axis=0)              # (N, 961)
    m = patches @ jnp.asarray(_MOMENT_FLAT)                       # (N, 2)=[m10,m01]
    ang = jnp.arctan2(m[:, 1], m[:, 0])
    return jnp.where(ang < 0, ang + 2.0 * jnp.pi, ang)


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------


def brief_descriptors(
    blurred: jnp.ndarray, xy: jnp.ndarray, angles: jnp.ndarray
) -> jnp.ndarray:
    """(N, 8) uint32 packed rBRIEF-256 descriptors.

    Nearest-pixel sampling from the blurred image at rotation-steered pattern
    offsets — one flat gather of N×512 samples.
    """
    h, w = blurred.shape
    flat = blurred.reshape(-1)
    rot = jnp.asarray(_ROT_PATTERNS)  # (30, 256, 2, 2)

    bins = jnp.clip(
        jnp.round(angles * (N_ROT_BINS / (2.0 * jnp.pi))).astype(jnp.int32) % N_ROT_BINS,
        0,
        N_ROT_BINS - 1,
    )
    offs = rot[bins]  # (N, 256, 2, 2)
    xi = xy[:, None, None, 0].astype(jnp.int32) + offs[..., 0]
    yi = xy[:, None, None, 1].astype(jnp.int32) + offs[..., 1]
    xi = jnp.clip(xi, 0, w - 1)
    yi = jnp.clip(yi, 0, h - 1)
    samples = jnp.take(flat, yi * w + xi, axis=0)  # (N, 256, 2)
    bits = samples[..., 0] < samples[..., 1]  # (N, 256)

    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(
        bits.reshape(bits.shape[0], N_WORDS, 32).astype(jnp.uint32) << shifts[None, None, :],
        axis=-1,
        dtype=jnp.uint32,
    )
    return words  # (N, 8)


_INT_SCALE = 8  # fixed-point scale for integral-image moments (1/8 intensity)


def _disc_halfwidths() -> np.ndarray:
    """(31,) per-row half-width of the radius-15 disc (ref u_max table,
    ORBextractor.cc:66-76 — same circle, computed not tabulated)."""
    dy = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    return np.floor(np.sqrt(float(HALF_PATCH * HALF_PATCH) - dy * dy + 1e-6)).astype(np.int32)


def level_moment_integrals(lvl_img: jnp.ndarray):
    """Row-prefix-sum images for IC moments, padded with a leading zero
    column: S[y, x+1] = Σ_{x'≤x} round(8·I), Sx[y, x+1] = Σ (x'−c)·round(8·I).
    int32 and exact, so the hi−lo differences below carry no cancellation
    error (a float cumsum at image scale would lose ~0.4% to rounding)."""
    h, w = lvl_img.shape
    q = jnp.round(lvl_img * _INT_SCALE).astype(jnp.int32)
    c = (w - 1) // 2
    xw = (jnp.arange(w, dtype=jnp.int32) - c)[None, :]
    S = jnp.pad(jnp.cumsum(q, axis=1), ((0, 0), (1, 0)))
    Sx = jnp.pad(jnp.cumsum(q * xw, axis=1), ((0, 0), (1, 0)))
    return S, Sx, c


def ic_angles_rows(
    flat_S: jnp.ndarray, flat_Sx: jnp.ndarray, xy: jnp.ndarray,
    base: jnp.ndarray, wl: jnp.ndarray, hl: jnp.ndarray, xc: jnp.ndarray,
) -> jnp.ndarray:
    """IC angles from row integrals: per keypoint, each of the 31 disc rows
    needs only (S, Sx) at the row's two ends — 124 gathered elements instead
    of the 961-pixel patch (gather cost grows with the element count, so
    this is the whole game).

    flat_S/flat_Sx: concatenated per-level padded prefix sums (row stride
    wl+1); base: per-keypoint offset of its level in the flat buffers;
    xc: per-keypoint level center column used in the Sx weighting.
    """
    r = HALF_PATCH
    u = jnp.asarray(_disc_halfwidths())                     # (31,)
    dyv = jnp.arange(-r, r + 1, dtype=jnp.int32)            # (31,)
    xi = jnp.clip(xy[:, 0].astype(jnp.int32), r, wl - 1 - r)
    yi = jnp.clip(xy[:, 1].astype(jnp.int32), r, hl - 1 - r)
    stride = wl + 1
    row = base[:, None] + (yi[:, None] + dyv[None, :]) * stride[:, None]  # (N, 31)
    hi = row + xi[:, None] + u[None, :] + 1
    lo = row + xi[:, None] - u[None, :]
    idx = jnp.concatenate([hi, lo], axis=1)                 # (N, 62)
    S2 = jnp.take(flat_S, idx, axis=0)
    Sx2 = jnp.take(flat_Sx, idx, axis=0)
    m00r = S2[:, :31] - S2[:, 31:]                          # (N, 31)
    mxr = Sx2[:, :31] - Sx2[:, 31:]
    m10 = jnp.sum(mxr, axis=1) - (xi - xc) * jnp.sum(m00r, axis=1)
    m01 = jnp.sum(dyv[None, :] * m00r, axis=1)
    ang = jnp.arctan2(m01.astype(jnp.float32), m10.astype(jnp.float32))
    return jnp.where(ang < 0, ang + 2.0 * jnp.pi, ang)


def brief_descriptors_flat(
    flat_blur: jnp.ndarray, xy: jnp.ndarray, angles: jnp.ndarray,
    base: jnp.ndarray, wl: jnp.ndarray, hl: jnp.ndarray,
) -> jnp.ndarray:
    """brief_descriptors over a flattened pyramid — one (N, 512) gather for
    all levels (same flat-buffer layout as ic_angles_rows)."""
    rot = jnp.asarray(_ROT_PATTERNS)  # (30, 256, 2, 2)
    bins = jnp.clip(
        jnp.round(angles * (N_ROT_BINS / (2.0 * jnp.pi))).astype(jnp.int32) % N_ROT_BINS,
        0,
        N_ROT_BINS - 1,
    )
    offs = rot[bins]  # (N, 256, 2, 2)
    xi = jnp.clip(
        xy[:, None, None, 0].astype(jnp.int32) + offs[..., 0],
        0, (wl - 1)[:, None, None],
    )
    yi = jnp.clip(
        xy[:, None, None, 1].astype(jnp.int32) + offs[..., 1],
        0, (hl - 1)[:, None, None],
    )
    idx = base[:, None, None] + yi * wl[:, None, None] + xi
    samples = jnp.take(flat_blur, idx, axis=0)  # (N, 256, 2)
    bits = samples[..., 0] < samples[..., 1]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(
        bits.reshape(bits.shape[0], N_WORDS, 32).astype(jnp.uint32) << shifts[None, None, :],
        axis=-1,
        dtype=jnp.uint32,
    )


# ---------------------------------------------------------------------------
# Patch-matmul orientation + descriptors (A/B path, non-default — see OrbConfig)
# ---------------------------------------------------------------------------

_PATCH_R = max(int(np.abs(_ROT_PATTERNS).max()), HALF_PATCH)
_PATCH_W = 2 * _PATCH_R + 1
_PATCH_AREA = _PATCH_W * _PATCH_W
# The gathered patch must cover BOTH the rotated BRIEF sample reach (≤ 13·√2)
# and the radius-15 IC moment disc; a seed/clip change shrinking the realized
# pattern reach must not silently truncate the disc in _patch_moment_masks_i8.
assert _PATCH_R >= HALF_PATCH, (_PATCH_R, HALF_PATCH)


def _pair_diff_matrix() -> np.ndarray:
    """(PATCH_AREA, 30·256) int8: each column holds +1 at sample point p and
    −1 at q for one (rotation bin, bit) pair, so `patch @ D` evaluates
    I(p) − I(q) for every bit of every rotation bin in one matmul."""
    D = np.zeros((_PATCH_AREA, N_ROT_BINS * N_BITS), np.int8)
    for b in range(N_ROT_BINS):
        for j in range(N_BITS):
            (px, py), (qx, qy) = _ROT_PATTERNS[b, j]
            col = b * N_BITS + j
            D[(py + _PATCH_R) * _PATCH_W + (px + _PATCH_R), col] += 1
            D[(qy + _PATCH_R) * _PATCH_W + (qx + _PATCH_R), col] -= 1
    return D


def _patch_moment_masks_i8() -> np.ndarray:
    """(PATCH_AREA, 2) int8 x-/y-weighted radius-15 disc masks in patch
    coordinates (weights ∈ [−15, 15] fit int8)."""
    ys, xs = np.mgrid[-_PATCH_R : _PATCH_R + 1, -_PATCH_R : _PATCH_R + 1]
    disc = (xs * xs + ys * ys) <= HALF_PATCH * HALF_PATCH
    return (
        np.stack([xs * disc, ys * disc], axis=-1)
        .reshape(_PATCH_AREA, 2)
        .astype(np.int8)
    )


def center_i8(img: jnp.ndarray) -> jnp.ndarray:
    """f32 intensities → int8 I−128 (exact uchar semantics: the reference
    samples the blurred 8-bit image, ORBextractor.cc:842-854)."""
    return (jnp.clip(jnp.round(img), 0.0, 255.0) - 128.0).astype(jnp.int8)


def patch_orientation_brief(
    flat_blur_i8: jnp.ndarray, xy: jnp.ndarray,
    base: jnp.ndarray, wl: jnp.ndarray, hl: jnp.ndarray,
):
    """(angles (N,), desc (N,8) uint32) from ONE patch gather + int8 matmuls.

    Replaces the 512-element-per-keypoint descriptor gather + the row-integral
    orientation path (512·N scalar gathers at N=800): gather each keypoint's
    (2·_PATCH_R+1)² blurred patch (33×33 with the shipped pattern) as
    contiguous row slices (slice gathers move whole
    lanes, not elements), then

      * IC moments = patch @ disc-masks — int8×int8→int32 matmul; the
        disc is symmetric so Σx=Σy=0 over it and the −128 centering cancels
        exactly (same m10/m01 as the reference's IC_Angle over the blurred
        image, cc:131-160);
      * all 30 rotation bins' BRIEF pair differences = patch @ D in one int8
        matmul (exact int32), bin-selected per keypoint by a one-hot
        multiply-sum — no gather at all.

    Orientation is computed from the BLURRED patch (the reference uses the raw
    image); Gaussian blur is rotationally symmetric so IC equivariance is
    preserved, and the 12° steering bins absorb the small angle shift —
    rotation-invariance and matching-quality tests gate this.
    """
    n = xy.shape[0]
    xi = jnp.clip(xy[:, 0].astype(jnp.int32), _PATCH_R, wl - 1 - _PATCH_R)
    yi = jnp.clip(xy[:, 1].astype(jnp.int32), _PATCH_R, hl - 1 - _PATCH_R)
    dyv = jnp.arange(-_PATCH_R, _PATCH_R + 1, dtype=jnp.int32)
    starts = (
        base[:, None] + (yi[:, None] + dyv[None, :]) * wl[:, None]
        + (xi - _PATCH_R)[:, None]
    ).reshape(-1, 1)
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(), start_index_map=(0,)
    )
    rows = jax.lax.gather(
        flat_blur_i8, starts, dn, slice_sizes=(_PATCH_W,),
        mode=jax.lax.GatherScatterMode.CLIP,
    )
    patch = rows.reshape(n, _PATCH_AREA)  # int8: I − 128

    m = jax.lax.dot(
        patch, jnp.asarray(_patch_moment_masks_i8()),
        preferred_element_type=jnp.int32,
    )  # (N, 2) = [m10, m01], exact
    ang = jnp.arctan2(m[:, 1].astype(jnp.float32), m[:, 0].astype(jnp.float32))
    ang = jnp.where(ang < 0, ang + 2.0 * jnp.pi, ang)
    bins = jnp.clip(
        jnp.round(ang * (N_ROT_BINS / (2.0 * jnp.pi))).astype(jnp.int32)
        % N_ROT_BINS,
        0, N_ROT_BINS - 1,
    )

    diffs = jax.lax.dot(
        patch, jnp.asarray(_pair_diff_matrix()),
        preferred_element_type=jnp.int32,
    ).reshape(n, N_ROT_BINS, N_BITS)
    onehot = (bins[:, None] == jnp.arange(N_ROT_BINS)[None, :]).astype(jnp.int32)
    sel = jnp.sum(diffs * onehot[:, :, None], axis=1)  # exact: picks one bin
    bits = sel < 0  # I(p) < I(q), strict — ties → 0, as in the gather path

    shifts = jnp.arange(32, dtype=jnp.uint32)
    desc = jnp.sum(
        bits.reshape(n, N_WORDS, 32).astype(jnp.uint32) << shifts[None, None, :],
        axis=-1,
        dtype=jnp.uint32,
    )
    return ang, desc


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------


class OrbConfig(NamedTuple):
    """Runtime equivalent of the settings-yaml ORBextractor.* block
    (src/Tracking.cc:182-206)."""

    n_features: int = 800
    n_levels: int = 8
    scale: float = 1.2
    fast_threshold: float = 20.0
    fast_min_threshold: float = 7.0
    grid: int = 8
    # Descriptor backend. False (production) = row-integral IC angles +
    # (N,512) element-gather rBRIEF. True = the round-3 patch-matmul path
    # (one int8 patch gather + int8 matmuls), slower where int8 dots do not
    # reach the matrix units; the (N·33·33)-element patch gather alone
    # exceeds the element-gather path's footprint. Kept for A/B and as the
    # bit-exactness cross-check in the unit tests.
    patch_desc: bool = False


class Keypoints(NamedTuple):
    """SoA keypoint set, fixed capacity = cfg.n_features, mask `valid`.

    uv is in level-0 (full-resolution) pixel coordinates, as the reference
    stores after scaling (ORBextractor.cc:905-918).
    """

    uv: jnp.ndarray        # (N, 2) float32
    response: jnp.ndarray  # (N,) float32
    octave: jnp.ndarray    # (N,) int32
    angle: jnp.ndarray     # (N,) float32 radians
    desc: jnp.ndarray      # (N, 8) uint32
    valid: jnp.ndarray     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


@partial(jax.jit, static_argnames=("cfg",))
def extract_orb(img: jnp.ndarray, cfg: OrbConfig) -> Keypoints:
    """Grayscale f32 [H, W] → Keypoints with capacity cfg.n_features.

    Per level: FAST quota detection → IC orientation → blur → rBRIEF; keypoint
    coords rescaled to level 0. All shapes static; invalid slots masked.
    """
    levels = pyr.build_pyramid(img, cfg.n_levels, cfg.scale)
    quotas = pyr.features_per_level(cfg.n_features, cfg.n_levels, cfg.scale)
    sf = pyr.scale_factors(cfg.n_levels, cfg.scale)

    # Per-level FAST detection (shapes differ per level, so this stays a
    # Python loop over static shapes), collecting level-coordinate keypoints
    # plus static per-keypoint level metadata for the batched gathers below.
    xs, resps, valids, octs, sfs = [], [], [], [], []
    bases_np, wls_np, hls_np = [], [], []
    ibases_np, xcs_np = [], []
    offset = 0
    ioffset = 0
    used_levels = []
    for lv, (lvl_img, quota) in enumerate(zip(levels, quotas)):
        h, w = lvl_img.shape
        if quota <= 0:
            continue
        xy, resp, valid = fast_ops.detect_keypoints(
            lvl_img,
            n_keep=quota,
            threshold=cfg.fast_threshold,
            min_threshold=cfg.fast_min_threshold,
            grid=cfg.grid,
        )
        inside = (
            (xy[:, 0] >= EDGE_MARGIN)
            & (xy[:, 0] < w - EDGE_MARGIN)
            & (xy[:, 1] >= EDGE_MARGIN)
            & (xy[:, 1] < h - EDGE_MARGIN)
        )
        xs.append(xy)
        resps.append(resp)
        valids.append(valid & inside)
        octs.append(np.full((quota,), lv, np.int32))
        sfs.append(np.full((quota,), sf[lv], np.float32))
        bases_np.append(np.full((quota,), offset, np.int32))
        wls_np.append(np.full((quota,), w, np.int32))
        hls_np.append(np.full((quota,), h, np.int32))
        ibases_np.append(np.full((quota,), ioffset, np.int32))
        xcs_np.append(np.full((quota,), (w - 1) // 2, np.int32))
        used_levels.append(lv)
        offset += h * w
        ioffset += h * (w + 1)

    xy_all = jnp.concatenate(xs)
    base = jnp.asarray(np.concatenate(bases_np))
    wl = jnp.asarray(np.concatenate(wls_np))
    hl = jnp.asarray(np.concatenate(hls_np))

    if cfg.patch_desc:
        # ONE int8 slice-gather of blurred (2R+1)² patches feeds orientation
        # moments AND all-bin BRIEF via matmuls (see
        # patch_orientation_brief) — no row integrals, no element gathers.
        flat_blur_i8 = jnp.concatenate(
            [center_i8(pyr.gaussian_blur(levels[lv])).reshape(-1) for lv in used_levels]
        )
        ang, desc = patch_orientation_brief(flat_blur_i8, xy_all, base, wl, hl)
    else:
        # Flattened pyramids: row-integral buffers for orientation moments
        # (124 gathered elements per keypoint — see ic_angles_rows) and a
        # blurred buffer for descriptor sampling, gathered ONCE for all levels.
        S_parts, Sx_parts = [], []
        for lv in used_levels:
            S, Sx, _ = level_moment_integrals(levels[lv])
            S_parts.append(S.reshape(-1))
            Sx_parts.append(Sx.reshape(-1))
        flat_S = jnp.concatenate(S_parts)
        flat_Sx = jnp.concatenate(Sx_parts)
        flat_blur = jnp.concatenate(
            [pyr.gaussian_blur(levels[lv]).reshape(-1) for lv in used_levels]
        )
        ibase = jnp.asarray(np.concatenate(ibases_np))
        xc = jnp.asarray(np.concatenate(xcs_np))
        ang = ic_angles_rows(flat_S, flat_Sx, xy_all, ibase, wl, hl, xc)
        desc = brief_descriptors_flat(flat_blur, xy_all, ang, base, wl, hl)

    return Keypoints(
        uv=xy_all * jnp.asarray(np.concatenate(sfs))[:, None],
        response=jnp.concatenate(resps),
        octave=jnp.asarray(np.concatenate(octs)),
        angle=ang,
        desc=desc,
        valid=jnp.concatenate(valids),
    )
