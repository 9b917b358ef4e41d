"""RGB-D SLAM engine in JAX.

A from-scratch re-design of the capabilities of BaptisteHudyma/RGB-D-SLAM as
batched, masked, fixed-capacity array programs instead of per-feature object
graphs; one Pallas kernel (pyramidal LK through Triton) on the GPU; shard_map
over device meshes for the distributed bundle-adjustment backend.
"""

import os as _os

import jax as _jax

# Persistent compilation cache.  Where JAX_COMPILATION_CACHE_DIR is set, JAX
# reads it itself and nothing is set here; otherwise the cache lives at a fixed
# path in the checkout (the path is part of the cache key).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# float32 matmuls on a GPU may run in TF32 (about three decimal digits) by
# default; the pipeline's small-matrix algebra (4x4 transforms, covariance
# propagation, Kalman/LM solves) needs true f32.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
