"""gf_orb_slam_tpu — an accelerator-resident monocular visual SLAM framework.

A from-scratch JAX/XLA rebuild of the capabilities of GF-ORB-SLAM
(ORB-SLAM v1 + observability-driven "Good Feature" selection). The map is
struct-of-arrays device state, every per-frame computation is a fixed-shape
jitted program, and the hot kernels (ORB extraction, Hamming matching,
Max-logDet selection, bundle adjustment) are batched device programs rather
than translations of the reference's C++ thread/pointer architecture.

Layer map (mirrors SURVEY.md section 1, reimagined for the device):
  geometry/   SE3/SO3/quat/Sim3, pinhole+radtan camera, PWLS 13-state kinematics
  ops/        ORB pyramid extraction (FAST + rBRIEF) and Hamming matching kernels
  solvers/    pose LM, two-view initializer, EPnP RANSAC, Sim3 Horn, local BA,
              Sim3 pose-graph optimization
  gf/         Good-Feature engine: measurement Jacobians, info matrices,
              Max-logDet lazier-greedy selection, active matching
  mapping/    SoA map state, keyframe/map-point lifecycle, local mapping program
  retrieval/  device-resident binary BoW vocabulary + inverted-file keyframe database
  loop/       loop detection, Sim3 verification, loop correction
  parallel/   sharded distributed global BA over jax.sharding meshes
  io_utils/   dataset loaders (EuRoC/TUM/NUIM + synthetic), config, trajectory IO
  pipeline/   tracking state machine and full-system orchestration
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# JAX's DEFAULT f32 matmul precision lets the backend use reduced-precision
# passes (TF32 on NVIDIA tensor cores: 10 mantissa bits; bfloat16 on some
# accelerators: 8). Image-path matmuls tolerate that, but the estimation
# stack does not: normal-equation assembly (pose LM, Schur BA),
# information-matrix whitening, and PCG all run through jnp matmuls/einsums,
# and reduced-precision Hessians measurably corrupt accuracy on oblique
# geometry (room-circuit ATE 4.7 cm in full f32 vs ~17 cm with bf16 passes,
# identical code, round 3). Full-f32 matmuls are the framework default; the
# pyramid-resize check in chip_smoke.py holds it on the card. Override via
# GF_MATMUL_PRECISION={bfloat16,tensorfloat32,float32} for A/B measurement.
_prec = _os.environ.get("GF_MATMUL_PRECISION", "float32")
if _prec not in ("bfloat16", "tensorfloat32", "float32"):
    import warnings as _warnings

    _warnings.warn(
        f"GF_MATMUL_PRECISION={_prec!r} is not one of "
        "{bfloat16, tensorfloat32, float32}; using float32",
        stacklevel=2,
    )
    _prec = "float32"
_jax.config.update("jax_default_matmul_precision", _prec)
