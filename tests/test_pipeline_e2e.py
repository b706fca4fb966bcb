"""End-to-end SLAM pipeline tests on rendered synthetic sequences — the
'benchmark-as-test' pattern of the reference's batch scripts (SURVEY.md §4),
with the rendered multi-plane scene replacing rosbag playback."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gf_orb_slam_tpu.geometry import se3
from gf_orb_slam_tpu.geometry.camera import CameraModel
from gf_orb_slam_tpu.io_utils import evaluation, synthetic
from gf_orb_slam_tpu.pipeline.system import SlamConfig, SlamSystem

CAM = CameraModel(fx=458.0, fy=458.0, cx=376.0, cy=240.0, width=752, height=480, fps=20.0)


def run_sequence(cfg: SlamConfig, n_frames: int = 40, seed: int = 0):
    scene = synthetic.make_scene(seed=seed)
    ts, poses_gt = synthetic.trajectory(n_frames, fps=20.0)
    system = SlamSystem(CAM, cfg)
    for i in range(n_frames):
        img = synthetic.render(scene, CAM, jnp.asarray(poses_gt[i]))
        system.process(img, float(ts[i]))
    est_ts, est_poses = system.get_trajectory()
    if len(est_poses) < 5:
        return system, None
    est_pos = np.stack(
        [np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))) for p in est_poses]
    )
    t2i = {round(t, 4): i for i, t in enumerate(ts)}
    gt_pos = np.stack(
        [
            np.asarray(se3.pose_t(se3.inverse(jnp.asarray(poses_gt[t2i[round(t, 4)]]))))
            for t in est_ts
        ]
    )
    return system, evaluation.ate_rmse(est_pos, gt_pos)


@pytest.mark.slow
class TestEndToEnd:
    def test_vo_baseline(self):
        """Plain ORB-SLAM path (GF off) — BASELINE.json config 1 analogue."""
        system, rmse = run_sequence(SlamConfig(n_features=600, max_frames_between_kf=8))
        assert rmse is not None, "tracking failed"
        assert len(system.trajectory) > 30
        assert system.n_kf >= 4
        assert int(system.map.pt_valid.sum()) > 150
        assert rmse < 0.05, f"ATE {rmse*100:.1f} cm too high"

    def test_relocalization_after_blackout(self):
        """LOST on blacked-out frames → BoW+PnP relocalization recovers
        (ref Tracking::Relocalisation path)."""
        scene = synthetic.make_scene(seed=0)
        n_frames = 55
        ts, poses_gt = synthetic.trajectory(n_frames, fps=20.0)
        system = SlamSystem(
            CAM, SlamConfig(n_features=600, max_frames_between_kf=6, vocab_train_kfs=4)
        )
        black = jnp.zeros((480, 752), jnp.float32)
        states = []
        for i in range(n_frames):
            img = black if 35 <= i < 40 else synthetic.render(scene, CAM, jnp.asarray(poses_gt[i]))
            log = system.process(img, float(ts[i]))
            states.append(log.state)
        assert "LOST" in states[35:41]
        assert any(s == "WORKING" for s in states[40:]), states[35:]

    def test_keyframe_slab_compaction_on_long_runs(self):
        """With a tiny keyframe capacity the system must compact tombstoned
        slots and keep tracking indefinitely (slab ids are reused; without
        compaction the capacity would bound total insertions ever)."""
        system, rmse = run_sequence(
            SlamConfig(n_features=600, max_frames_between_kf=3, max_keyframes=12),
            n_frames=50,
        )
        assert rmse is not None, "tracking failed under compaction"
        assert system.state.name == "WORKING"
        assert rmse < 0.08, f"ATE {rmse*100:.1f} cm too high under compaction"
        assert int(np.asarray(system.map.kf_valid).sum()) <= 12

    def test_vo_with_gf_selection(self):
        """GF active matching at budget 100 — accuracy within 2x of baseline
        with a bounded match budget (the GF tradeoff property)."""
        system, rmse = run_sequence(
            SlamConfig(
                n_features=600, max_frames_between_kf=8,
                use_gf=True, gf_budget=100, gf_warmup_frames=10,
            )
        )
        assert rmse is not None, "tracking failed with GF"
        assert rmse < 0.08, f"GF ATE {rmse*100:.1f} cm too high"

    def test_deferred_matching_keeps_keyframes_dense(self):
        """ref DELAYED_MAP_MATCHING (Tracking.h:82; Tracking.cc:854-893,
        3097-3141): GF budgets cap the pose-LM observation set, NOT keyframe
        observation richness — non-selected candidates matched by the dense
        kernel are chi2-gated against the refined pose and carried into the
        keyframe (lmk_num_BA = refTrack + nMatched, Tracking.cc:3143). At
        budget 60 the keyframes inserted under GF must hold several× the
        budget in observations, and accuracy must stay at the GF-off level
        (the round-2 budget-60 ATE cliff came from thin keyframes).

        Uses the SAME config as test_vo_with_gf_selection so every program is
        already in the in-process jit cache (the in-suite CPU XLA compiler
        segfaults on fresh large program sets after 100+ tests — CLAUDE.md);
        the low-budget (60) variant is exercised through the public CLI in a
        fresh process by the sweep and verify drives."""
        budget = 100
        system, rmse = run_sequence(
            SlamConfig(
                n_features=600, max_frames_between_kf=8,
                use_gf=True, gf_budget=budget, gf_warmup_frames=10,
            )
        )
        assert rmse is not None, "tracking failed with GF"
        assert rmse < 0.05, f"budget-{budget} ATE {rmse*100:.1f} cm too high"
        m = system.map
        kf_valid = np.asarray(m.kf_valid)
        obs = np.asarray(m.kf_obs_point)
        fid = np.asarray(m.kf_frame_id)
        gf_kf_counts = [
            int((obs[k] >= 0).sum())
            for k in np.nonzero(kf_valid)[0]
            if fid[k] > 10  # inserted after GF warmup
        ]
        assert gf_kf_counts, "no keyframes inserted under GF"
        assert max(gf_kf_counts) > 2 * budget, (
            f"GF keyframes too thin (obs counts {gf_kf_counts}) — deferred "
            "matches are not reaching keyframe observations"
        )

    @pytest.mark.parametrize("mode", ["random", "longlive", "auto", "lazier"])
    def test_vo_baseline_matching_modes(self, mode, tmp_path):
        """The reference's ablation baselines (RANDOM / LONGLIVE budgeted
        matching, Observability::runBaselineMapMatching cc:1819; lazier
        greedy cc:2815; auto budget cc:3141) track the synthetic sequence at
        the same budget. Runs through the public CLI in a SUBPROCESS: each
        mode is a fresh program set and the in-suite CPU XLA compiler
        intermittently segfaults compiling those after 100+ earlier tests."""
        import json
        import subprocess
        import sys

        out = tmp_path / f"mode_{mode}"
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [
                sys.executable, os.path.join(repo, "run_slam.py"),
                "--synthetic", "30", "--cpu", "--n-features", "600",
                "--gf-budget", "100", "--gf-mode", mode, "--gf-warmup", "10",
                "--out", str(out),
            ],
            capture_output=True, text=True, timeout=1200,
            env={**os.environ, "PYTHONPATH": repo,
                 "XLA_FLAGS": ""},
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        result = json.load(open(f"{out}_result.json"))
        assert result["tracked"] > 20, f"tracking failed with gf_mode={mode}"
        assert result["ate_rmse_m"] < 0.12, (
            f"{mode} ATE {result['ate_rmse_m']*100:.1f} cm too high"
        )


@pytest.mark.slow
class TestLoopClosingLive:
    def test_circuit_closes_loop_live(self, tmp_path):
        """The canonical loop-closure scenario, fully live: a 360°+ circuit
        inside the 4-wall room (radtan-distorted EuRoC camera). The start view
        leaves the frustum for most of the revolution (no covisibility chain
        back), so on return the tracker maps duplicates and only the full
        detect (BoW + temporal consistency) → verify (Sim3 RANSAC + guided
        rematch + optimize_sim3) → correct (essential graph + SearchAndFuse)
        path can reconcile them.

        Runs in a SUBPROCESS via the public run_slam CLI: the sequence needs
        a fresh XLA process (the in-suite CPU compiler intermittently aborts
        compiling the distorted-camera program set after 100+ earlier tests),
        and the CLI is the surface users drive anyway."""
        import json
        import subprocess
        import sys

        n_frames = 300
        out = tmp_path / "circuit"
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run(
            [
                sys.executable, os.path.join(repo, "run_slam.py"),
                "--synthetic", str(n_frames), "--scene", "room", "--cpu",
                "--n-features", "600", "--out", str(out),
            ],
            capture_output=True, text=True, timeout=1500,
            env={**os.environ, "PYTHONPATH": repo,
                 "XLA_FLAGS": ""},
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        result = json.load(open(f"{out}_result.json"))
        assert result["tracked"] > 0.9 * n_frames, result
        assert result["loops_closed"] >= 1, "no loop closed through the live path"
        assert result["ate_rmse_m"] < 0.1, result

        # Keyframe-trajectory accuracy post-correction (map not corrupted).
        kf_rows = np.loadtxt(f"{out}_KeyFrameTrajectory.txt")
        ts_all, poses_gt = synthetic.circuit_trajectory(
            n_frames, fps=20.0, radius=4.0, revs=min(1.1, n_frames / 270.0),
        )
        gt_by_t = {round(float(t), 4): p for t, p in zip(ts_all, poses_gt)}
        est, gt = [], []
        for row in kf_rows:
            p = gt_by_t.get(round(float(row[0]), 4))
            if p is None:
                continue
            est.append(row[1:4])  # TUM: t x y z qx qy qz qw (camera center)
            gt.append(np.asarray(se3.pose_t(se3.inverse(jnp.asarray(p)))))
        assert len(est) > 10
        assert evaluation.ate_rmse(np.stack(est), np.stack(gt)) < 0.15


class TestEvaluation:
    def test_umeyama_recovers_similarity(self, rng):
        src = rng.normal(size=(50, 3))
        R_gt = np.asarray(
            [[0, -1, 0], [1, 0, 0], [0, 0, 1]], float
        )
        dst = 2.5 * (R_gt @ src.T).T + np.asarray([1.0, -2.0, 3.0])
        s, R, t = evaluation.umeyama_alignment(src, dst)
        np.testing.assert_allclose(s, 2.5, rtol=1e-5)
        np.testing.assert_allclose(R, R_gt, atol=1e-6)
        assert evaluation.ate_rmse(src, dst) < 1e-5

    def test_tum_trajectory_roundtrip(self, tmp_path):
        ts = np.asarray([0.0, 0.05])
        poses = np.asarray([[1, 0, 0, 0, 0.1, 0.2, 0.3], [1, 0, 0, 0, 0.2, 0.3, 0.4]], np.float32)
        path = tmp_path / "traj.txt"
        evaluation.write_tum_trajectory(str(path), ts, poses)
        lines = path.read_text().strip().split("\n")
        assert len(lines) == 2
        vals = np.asarray([float(x) for x in lines[0].split()])
        assert vals.shape == (8,)


class TestSyntheticRenderer:
    def test_render_shapes_and_texture(self):
        scene = synthetic.make_scene(seed=1)
        img = synthetic.render(scene, CAM, se3.identity_pose())
        assert img.shape == (480, 752)
        a = np.asarray(img)
        assert a.std() > 20  # textured, not flat

    def test_parallax_between_planes(self):
        """Camera translation shifts near-plane texture more than far-plane."""
        scene = synthetic.make_scene(seed=1)
        p0 = se3.identity_pose()
        p1 = se3.make_pose(jnp.asarray([1.0, 0, 0, 0.0]), jnp.asarray([-0.3, 0.0, 0.0]))
        i0 = np.asarray(synthetic.render(scene, CAM, p0))
        i1 = np.asarray(synthetic.render(scene, CAM, p1))
        assert np.abs(i0 - i1).mean() > 5  # scene moved
