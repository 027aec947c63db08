"""objective_slam_tpu — JAX point-pair-feature (PPF) 6-DoF recognition.

A JAX/XLA framework with the capabilities of the reference
CUDA pipeline in ``nicolasavru/objective-slam`` (Drost et al. 2010 "Model
Globally, Match Locally"): given a model point cloud and a scene point cloud
(both with normals), recover the rigid transform placing the model in the
scene via discretized point-pair features and Hough-style voting.

Architecture (static-shape dense formulations, not a port):
  * ``ops.transforms``  — batched rigid-transform / quaternion math
  * ``ops.ppf``         — PPF features, truncating quantization, packed
                          integer keys (replaces FNV-1a byte hashing of the
                          reference; an FNV mode is kept for parity checks)
  * ``ops.hashing``     — FNV-1a 32-bit in uint32 lanes (bit-parity mode)
  * ``ops.voting``      — expansion-based vote generation + dense Hough
                          accumulator (the reference's sort/histogram path
                          re-thought as static-shape segment math)
  * ``ops.clustering``  — pose clustering, dense pairwise formulation
  * ``models.drost``    — the flagship model: ModelDescription + match()
  * ``parallel``        — shard_map sharding of scene reference points
  * ``utils``           — PLY I/O, voxel grid, normals, synthetic scenes,
                          validation metrics
  * ``pipeline``        — multi-(scene,model) registration driver
  * ``cli``             — `alignment`-equivalent command line

Reference layer map: see SURVEY.md §1; component inventory §2.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent XLA compilation cache, kept at ONE fixed path inside the
# checkout (listed in .gitignore): the cache key includes the directory, so
# a path that moves never hits. Dataset sweeps, CLI invocations and the
# capacity buckets of drost.match span many processes over identical static
# shapes; without the cache every process recompiles the voting graphs.
XLA_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".xla_cache")


def _cache_dir_to_set(environ, platforms: str | None) -> str | None:
    """The directory the package should set as JAX's compilation cache, or
    None to leave JAX's setting alone.

    JAX reads JAX_COMPILATION_CACHE_DIR itself, so a set variable wins. The
    CPU keeps the cache off: XLA:CPU persists host-feature-specific code
    whose reload in another process warns of SIGILL risk, and its compiles
    are cheap. Decided from the configured platform string only — no
    backend is initialised at import."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    plat = (platforms or environ.get("JAX_PLATFORMS", "")).lower()
    if plat and all(p.strip() == "cpu" for p in plat.split(",")):
        return None
    return XLA_CACHE_DIR


_cache_dir = _cache_dir_to_set(_os.environ, _jax.config.jax_platforms)
if _cache_dir is not None and _jax.config.jax_compilation_cache_dir is None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)

from objective_slam_tpu.config import PPFConfig  # noqa: F401
from objective_slam_tpu.models.drost import (  # noqa: F401
    MatchCaps,
    ModelDescription,
    build_model_description,
    match,
    match_with_state,
)
