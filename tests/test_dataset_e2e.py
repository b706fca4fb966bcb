"""End-to-end proof of the on-disk dataset path.

The reference is driven by rosbag playback + a YAML settings file
(batch_script/Run_EuRoC.py:34-80, src/main.cc:70-80); our equivalents are the
EuRoC/TUM file loaders (io_utils/datasets.py), the OpenCV-YAML settings
parser (io_utils/settings.py) and the native C++ prefetcher
(native/io_runtime.cpp). Real EuRoC pixels are unreachable here (zero
egress), so a rendered synthetic sequence is dumped to disk in the real
layouts and run through `run_slam.py --seq <dir> --settings <yaml>` — the
same CLI surface a real dataset uses. Only the pixels, not the plumbing,
remain unproven for EuRoC day.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 90


def _dump(layout: str, out_dir: str):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import dump_dataset

    dump_dataset.main([
        "--out", out_dir, "--layout", layout, "--frames", str(N_FRAMES),
        "--scene", "planes", "--n-features", "600",
    ])


def _run_slam(args, out_prefix):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "run_slam.py"), "--cpu",
         "--out", str(out_prefix), *args],
        capture_output=True, text=True, timeout=1500,
        env={**os.environ, "PYTHONPATH": REPO,
             "XLA_FLAGS": ""},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(f"{out_prefix}_result.json") as f:
        return json.load(f)


@pytest.mark.slow
class TestDatasetPathEndToEnd:
    def test_euroc_layout_files_to_ate(self, tmp_path):
        """Dump EuRoC ASL layout → run the public CLI through detect_and_load
        + FramePrefetcher + load_settings → ATE evaluated against the on-disk
        GT csv matches the in-memory synthetic run of the same sequence
        (differences bounded by the 8-bit PNG quantization)."""
        seq_dir = tmp_path / "SYNTH_01"
        _dump("euroc", str(seq_dir))
        # data.csv + PNGs + GT csv exist where the loader expects them
        assert (seq_dir / "mav0" / "cam0" / "data.csv").exists()
        assert (seq_dir / "mav0" / "state_groundtruth_estimate0" / "data.csv").exists()

        res_disk = _run_slam(
            ["--seq", str(seq_dir), "--settings", str(seq_dir / "settings.yaml")],
            tmp_path / "disk",
        )
        assert res_disk["frames"] == N_FRAMES
        assert res_disk["tracked"] > 0.85 * N_FRAMES, res_disk
        assert res_disk.get("ate_rmse_m") is not None, (
            "GT association through the on-disk csv failed"
        )
        assert res_disk["ate_rmse_m"] < 0.05, res_disk

        # In-memory reference run: same scene/trajectory/config through the
        # float renderer (no disk round-trip).
        res_mem = _run_slam(
            ["--synthetic", str(N_FRAMES), "--n-features", "600"],
            tmp_path / "mem",
        )
        assert res_mem["ate_rmse_m"] < 0.05, res_mem
        assert abs(res_disk["ate_rmse_m"] - res_mem["ate_rmse_m"]) < 0.02, (
            f"disk {res_disk['ate_rmse_m']} vs mem {res_mem['ate_rmse_m']}: "
            "the dataset path changes accuracy beyond quantization noise"
        )

    def test_tum_layout_loads_identically(self, tmp_path):
        """The TUM-RGBD layout of the same sequence parses to identical
        timestamps, frame count, and ground truth as the EuRoC layout (the
        SLAM run above already exercises the shared consumption path)."""
        from gf_orb_slam_tpu.io_utils.datasets import detect_and_load

        eu = tmp_path / "eu"
        tu = tmp_path / "tu"
        _dump("euroc", str(eu))
        _dump("tum", str(tu))
        s_eu = detect_and_load(str(eu))
        s_tu = detect_and_load(str(tu))
        assert len(s_eu) == len(s_tu) == N_FRAMES
        np.testing.assert_allclose(s_eu.timestamps, s_tu.timestamps, atol=1e-6)
        np.testing.assert_allclose(s_eu.gt_positions, s_tu.gt_positions, atol=1e-6)
        np.testing.assert_allclose(
            s_eu.gt_quaternions, s_tu.gt_quaternions, atol=1e-6
        )
        # Same pixels through both layouts.
        from gf_orb_slam_tpu.io_utils.datasets import _imread_gray

        a = _imread_gray(s_eu.image_paths[3])
        b = _imread_gray(s_tu.image_paths[3])
        np.testing.assert_array_equal(a, b)
