"""chip_smoke.py's helpers on the CPU, and its kernel/precision checks under
the `gpu` marker.

The `gpu` tests skip here; on a machine with a card they run with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_chip_smoke.py`
and call the same functions the smoke script runs."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from gf_orb_slam_tpu import compile_cache
from gf_orb_slam_tpu.ops import matching

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("nq,nt", [(1, 1), (37, 129), (800, 4096), (1600, 4096)])
def test_hamming_matrix_matches_numpy(nq, nt):
    rng = np.random.default_rng(nq + nt)
    q = chip_smoke.random_descriptors(nq, rng)
    t = chip_smoke.random_descriptors(nt, rng)
    got = np.asarray(jax.jit(matching.hamming_matrix)(q, t))
    assert got.dtype == np.int32 and got.shape == (nq, nt)
    np.testing.assert_array_equal(got, chip_smoke.hamming_reference(q, t))


def test_platform_guard_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


def _cache_files_after_compile(env_dir):
    """Run a fresh process that enables the cache and compiles one small
    program with a unique constant; return (returned dir, files there)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    env["PYTHONPATH"] = REPO
    code = (
        "import os, jax, jax.numpy as jnp\n"
        "from gf_orb_slam_tpu.compile_cache import enable_compile_cache\n"
        "d = enable_compile_cache()\n"
        f"jax.jit(lambda x: x * {float(os.getpid())} + 0.25)(jnp.ones(3)).block_until_ready()\n"
        "print(d)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    path = proc.stdout.strip().splitlines()[-1]
    return path, (os.listdir(path) if os.path.isdir(path) else [])


def test_compile_cache_uses_env_dir_when_set(tmp_path):
    path, files = _cache_files_after_compile(tmp_path / "cache")
    assert path == str(tmp_path / "cache")
    assert files, "nothing was cached in JAX_COMPILATION_CACHE_DIR"


def test_compile_cache_defaults_to_fixed_checkout_path():
    assert compile_cache.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    path, files = _cache_files_after_compile(None)
    assert path == compile_cache.DEFAULT_CACHE_DIR
    assert files, "nothing was cached at the in-checkout default"


# --- the smoke script's kernel and precision checks, on the card -----------


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; default device is {dev.platform}")
    return dev


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nt", chip_smoke.HAMMING_SHAPES)
def test_hamming_exact_on_gpu(gpu, nq, nt):
    assert chip_smoke.check_hamming(nq, nt)["entries_differing"] == 0


@pytest.mark.gpu
def test_pyramid_precision_on_gpu(gpu):
    from gf_orb_slam_tpu.io_utils import synthetic

    cam = chip_smoke.EUROC_PINHOLE
    pose = synthetic.trajectory(2, fps=cam.fps)[1][0]
    img = np.asarray(synthetic.render(synthetic.make_scene(seed=0), cam, jax.numpy.asarray(pose)))
    assert chip_smoke.check_pyramid(img)["max_abs_diff"] <= chip_smoke.PYRAMID_TOL


@pytest.mark.gpu
def test_pose_gpu_matches_cpu(gpu):
    res = chip_smoke.check_pose()
    assert res["gpu_vs_cpu_m"] <= chip_smoke.POSE_TOL_M
    assert res["gpu_vs_cpu_rad"] <= chip_smoke.POSE_TOL_RAD
