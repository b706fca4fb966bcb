"""ORB front-end tests: FAST correctness vs the OpenCV oracle, descriptor
rotation invariance, matching kernel behavior on synthetic imagery."""

import jax.numpy as jnp
import numpy as np
import pytest

from gf_orb_slam_tpu.ops import fast as fast_ops
from gf_orb_slam_tpu.ops import matching, orb, pyramid


def checkerboard_scene(rng, h=240, w=320, n_blobs=60):
    """Random blobby grayscale image with strong corners."""
    img = np.full((h, w), 128.0, np.float32)
    for _ in range(n_blobs):
        y, x = rng.integers(20, h - 20), rng.integers(20, w - 20)
        sy, sx = rng.integers(4, 14, 2)
        img[y : y + sy, x : x + sx] = rng.uniform(0, 255)
    # Low-amplitude texture so descriptor bits are well-defined everywhere
    # (real images are never perfectly flat).
    img += rng.uniform(-10, 10, (h, w)).astype(np.float32)
    return np.clip(img, 0, 255)


class TestFast:
    def test_fast_score_matches_opencv_corners(self, rng):
        cv2 = pytest.importorskip("cv2")
        img = checkerboard_scene(rng)
        img_u8 = img.astype(np.uint8)
        t = 20
        det = cv2.FastFeatureDetector_create(
            threshold=t, nonmaxSuppression=False, type=cv2.FAST_FEATURE_DETECTOR_TYPE_9_16
        )
        kps = det.detect(img_u8)
        cv_set = {(int(k.pt[0]), int(k.pt[1])) for k in kps}

        score = np.asarray(fast_ops.fast_score(jnp.asarray(img)))
        ours = {tuple(p) for p in np.argwhere(score > t)[:, ::-1]}  # (x, y)

        # Interior corners must agree (OpenCV also excludes a 3px border).
        inter = {(x, y) for (x, y) in cv_set if 3 <= x < 317 and 3 <= y < 237}
        missing = inter - ours
        extra = ours - cv_set
        assert len(missing) <= 0.02 * max(len(inter), 1), f"missing {len(missing)}/{len(inter)}"
        assert len(extra) <= 0.02 * max(len(ours), 1), f"extra {len(extra)}/{len(ours)}"

    def test_detect_keypoints_quota_and_spread(self, rng):
        img = checkerboard_scene(rng)
        xy, resp, valid = fast_ops.detect_keypoints(jnp.asarray(img), n_keep=200)
        n_valid = int(valid.sum())
        assert n_valid > 100
        xy_v = np.asarray(xy)[np.asarray(valid)]
        # spread across at least half the cells of a 4x4 partition
        cells = {(int(x // 80), int(y // 60)) for x, y in xy_v}
        assert len(cells) >= 8
        # all detections are genuine corners
        score = np.asarray(fast_ops.fast_score(jnp.asarray(img)))
        for x, y in xy_v[:50]:
            assert score[int(y), int(x)] >= 7.0

    def test_nms_keeps_local_maxima_only(self, rng):
        img = checkerboard_scene(rng)
        s = np.asarray(fast_ops.nms3(fast_ops.fast_score(jnp.asarray(img))))
        ys, xs = np.nonzero(s > 20)
        for y, x in list(zip(ys, xs))[:100]:
            patch = s[max(y - 1, 0) : y + 2, max(x - 1, 0) : x + 2]
            assert s[y, x] == patch.max()


class TestPyramid:
    def test_shapes(self):
        shapes = pyramid.pyramid_shapes(480, 752, 8, 1.2)
        assert shapes[0] == (480, 752)
        assert shapes[1] == (400, 627)
        assert len(shapes) == 8

    def test_quotas_sum(self):
        q = pyramid.features_per_level(800, 8, 1.2)
        assert sum(q) == 800
        assert all(q[i] >= q[i + 1] for i in range(6))

    def test_batched_resize_matches_chain(self, rng):
        """build_pyramid (2 batched matmuls from composed chain matrices) must
        reproduce the sequential per-level cascade to float32 tolerance."""
        img = jnp.asarray(rng.uniform(0, 255, (120, 188)).astype(np.float32))
        fast_lv = pyramid.build_pyramid(img, 5, 1.2)
        chain_lv = pyramid.build_pyramid_chain(img, 5, 1.2)
        for a, b in zip(fast_lv, chain_lv):
            assert a.shape == b.shape
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-3)

    def test_blur_preserves_mean(self, rng):
        img = jnp.asarray(rng.uniform(0, 255, (64, 64)).astype(np.float32))
        b = pyramid.gaussian_blur(img)
        np.testing.assert_allclose(float(b.mean()), float(img.mean()), rtol=0.01)


class TestDescriptors:
    def test_rotation_invariance(self, rng):
        """Descriptor of a rotated patch should stay close in Hamming distance
        — the core rBRIEF property (ORB paper sec 4; ref steered pattern)."""
        cv2 = pytest.importorskip("cv2")
        img = checkerboard_scene(rng, 256, 256)
        angle_deg = 30.0
        M = cv2.getRotationMatrix2D((128, 128), angle_deg, 1.0)
        rot = cv2.warpAffine(img, M, (256, 256), flags=cv2.INTER_LINEAR)

        kp = jnp.asarray([[128.0, 128.0], [100.0, 90.0], [150.0, 160.0]])
        blur0 = pyramid.gaussian_blur(jnp.asarray(img))
        blur1 = pyramid.gaussian_blur(jnp.asarray(rot))
        a0 = orb.ic_angles(jnp.asarray(img), kp)

        # Map keypoints through the rotation for the second image.
        ones = np.ones((3, 1), np.float32)
        kp_h = np.concatenate([np.asarray(kp), ones], axis=1)
        kp_rot = jnp.asarray((np.asarray(M, np.float32) @ kp_h.T).T)
        a1 = orb.ic_angles(jnp.asarray(rot), kp_rot)

        d0 = orb.brief_descriptors(blur0, kp, a0)
        d1 = orb.brief_descriptors(blur1, kp_rot, a1)
        dist = np.diag(np.asarray(matching.hamming_matrix(d0, d1)))
        assert (dist < 80).all(), dist

        # Negative control: random pairs should be near 128.
        d_rand = np.asarray(matching.hamming_matrix(d0, jnp.roll(d1, 1, axis=0)))
        assert np.mean(np.diag(d_rand)) > 90

    def test_patch_path_exact_vs_numpy(self, rng):
        """patch_orientation_brief (int8 slice-gather + int8 matmuls) must
        reproduce, bit-exactly, a direct numpy evaluation of IC moments and
        steered-BRIEF sampling on the same int8 buffer — the matmul
        reformulation is algebra, not approximation."""
        h, w = 96, 128
        lvl = rng.integers(0, 256, (h, w)).astype(np.int32)
        flat_i8 = jnp.asarray((lvl - 128).astype(np.int8).reshape(-1))
        n = 24
        R = orb._PATCH_R
        xy = np.stack(
            [rng.integers(R, w - R, n), rng.integers(R, h - R, n)], axis=1
        ).astype(np.float32)
        base = jnp.zeros(n, jnp.int32)
        wl = jnp.full(n, w, jnp.int32)
        hlv = jnp.full(n, h, jnp.int32)
        ang, desc = orb.patch_orientation_brief(
            flat_i8, jnp.asarray(xy), base, wl, hlv
        )
        ang, desc = np.asarray(ang), np.asarray(desc)

        cimg = lvl - 128
        ys, xs = np.mgrid[-R : R + 1, -R : R + 1]
        disc = (xs * xs + ys * ys) <= orb.HALF_PATCH**2
        for i in range(n):
            x0, y0 = int(xy[i, 0]), int(xy[i, 1])
            patch = cimg[y0 - R : y0 + R + 1, x0 - R : x0 + R + 1]
            m10 = int((xs * disc * patch).sum())
            m01 = int((ys * disc * patch).sum())
            a = np.arctan2(m01, m10) % (2 * np.pi)
            assert abs(ang[i] - a) < 1e-4 or abs(abs(ang[i] - a) - 2 * np.pi) < 1e-4
            b = int(np.round(a * orb.N_ROT_BINS / (2 * np.pi))) % orb.N_ROT_BINS
            pat = orb._ROT_PATTERNS[b]  # (256, 2, 2)
            pv = cimg[y0 + pat[:, 0, 1], x0 + pat[:, 0, 0]]
            qv = cimg[y0 + pat[:, 1, 1], x0 + pat[:, 1, 0]]
            bits = (pv < qv).astype(np.uint32)
            words = (
                bits.reshape(8, 32) << np.arange(32, dtype=np.uint32)[None, :]
            ).sum(axis=1, dtype=np.uint32)
            np.testing.assert_array_equal(desc[i], words)

    def test_extract_orb_patch_vs_gather_matching_quality(self, rng):
        """The patch-matmul extractor must match the element-gather extractor
        at ≥90% identical descriptors up to the angle-source change (blurred
        vs raw moments can shift a keypoint across a 12° steering-bin edge)."""
        img = checkerboard_scene(rng, 240, 320)
        cfg_p = orb.OrbConfig(n_features=200, patch_desc=True)
        cfg_g = orb.OrbConfig(n_features=200, patch_desc=False)
        kp = orb.extract_orb(jnp.asarray(img), cfg_p)
        kg = orb.extract_orb(jnp.asarray(img), cfg_g)
        v = np.asarray(kp.valid & kg.valid)
        np.testing.assert_array_equal(np.asarray(kp.uv)[v], np.asarray(kg.uv)[v])
        dist = np.diag(np.asarray(matching.hamming_matrix(kp.desc, kg.desc)))[v]
        same_bin = (
            np.asarray(
                jnp.round(kp.angle * orb.N_ROT_BINS / (2 * np.pi)).astype(int)
            )
            == np.asarray(
                jnp.round(kg.angle * orb.N_ROT_BINS / (2 * np.pi)).astype(int)
            )
        )[v]
        # Blurred-vs-raw moments shift keypoints near bin edges (checkerboard
        # patches are rotation-ambiguous); most keypoints keep their bin, and
        # where the bin agrees the descriptor is near-identical (remaining
        # bits differ only by the u8 rounding of near-tie pairs).
        assert same_bin.mean() > 0.5, same_bin.mean()
        # Same-bin pairs differ only where blurred pair samples are near ties
        # (u8 rounding — the reference's uchar sampling — flips those): small
        # median, far below the ~128 of unrelated descriptors.
        assert np.median(dist[same_bin]) <= 12, dist[same_bin]
        assert dist[same_bin].mean() < 32, dist[same_bin].mean()

    def test_extract_orb_end_to_end(self, rng):
        img = checkerboard_scene(rng, 480, 752)
        cfg = orb.OrbConfig(n_features=500)
        kps = orb.extract_orb(jnp.asarray(img), cfg)
        assert kps.capacity == 500
        n_valid = int(kps.valid.sum())
        assert n_valid > 200
        uv = np.asarray(kps.uv)[np.asarray(kps.valid)]
        assert (uv[:, 0] < 752).all() and (uv[:, 1] < 480).all()
        oct_counts = np.bincount(np.asarray(kps.octave)[np.asarray(kps.valid)], minlength=8)
        assert oct_counts[0] > oct_counts[4]  # geometric distribution


class TestMatching:
    def test_identity_matching(self, rng):
        """A frame matched against itself under a tight window is identity."""
        img = checkerboard_scene(rng, 240, 320)
        cfg = orb.OrbConfig(n_features=300, n_levels=4)
        kps = orb.extract_orb(jnp.asarray(img), cfg)
        mask = matching.window_mask(kps.uv, kps.uv, 3.0, kps.valid, kps.valid)
        res = matching.match(kps.desc, kps.desc, mask, max_dist=10)
        v = np.asarray(kps.valid)
        idx = np.asarray(res.idx)
        matched = np.asarray(res.matched) & v
        assert matched.sum() >= 0.95 * v.sum()
        assert (idx[matched] == np.arange(len(idx))[matched]).mean() > 0.9

    def test_shifted_matching(self, rng):
        """Match between an image and its 5px-shifted copy."""
        img = checkerboard_scene(rng, 240, 320)
        shifted = np.roll(img, (0, 5), axis=(0, 1))
        cfg = orb.OrbConfig(n_features=300, n_levels=4)
        k0 = orb.extract_orb(jnp.asarray(img), cfg)
        k1 = orb.extract_orb(jnp.asarray(shifted), cfg)
        mask = matching.window_mask(k0.uv, k1.uv, 12.0, k0.valid, k1.valid)
        res = matching.match(
            k0.desc, k1.desc, mask, max_dist=matching.TH_LOW, ratio=0.9,
            angle_q=k0.angle, angle_t=k1.angle, mutual=True,
        )
        m = np.asarray(res.matched)
        assert m.sum() > 50
        du = np.asarray(k1.uv)[np.asarray(res.idx)][m, 0] - np.asarray(k0.uv)[m, 0]
        # Median displacement should recover the shift.
        assert abs(np.median(du) - 5.0) < 1.5

    def test_orientation_consistency_rejects_outliers(self, rng):
        n = 200
        # 10 outliers: below the reference's 10%-of-max bin-keep threshold
        # (ComputeThreeMaxima drops bin2 when max2 < 0.1*max1).
        angle_q = jnp.zeros(n)
        angle_t = jnp.zeros(n).at[:10].set(jnp.pi)
        idx = jnp.arange(n, dtype=jnp.int32)
        matched = jnp.ones(n, bool)
        kept = np.asarray(matching.orientation_consistency(angle_q, angle_t, matched, idx))
        assert not kept[:10].any()
        assert kept[10:].all()

    def test_hamming_matrix_basic(self):
        a = jnp.asarray([[0, 0, 0, 0, 0, 0, 0, 0]], jnp.uint32)
        b = jnp.asarray([[0xFFFFFFFF] * 8, [0] * 8], jnp.uint32)
        d = np.asarray(matching.hamming_matrix(a, b))
        np.testing.assert_array_equal(d, [[256, 0]])
