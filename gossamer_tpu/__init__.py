"""gossamer_tpu — a JAX de Bruijn sequence-analysis engine for the GPU.

A from-scratch JAX/XLA re-design of the capabilities of the
data61/gossamer succinct de Bruijn graph suite (reference layout:
``src/GossApp.cc``, ``src/XenoApp.cc``, ``src/ElectApp.cc``).

Design stance (accelerator-first, not a port):

* K-mers are fixed-width 128-bit integers carried as ``uint64`` lo/hi lanes
  on the host and as ``uint32`` limb planes inside device kernels.
* The succinct rank/select structures of the reference (SparseArray /
  DenseArray, Elias-Fano) are replaced by *sorted device arrays* with
  block-rank tables; ``rank`` is a vectorized ``searchsorted``, ``select``
  is a gather.
* Counting (the reference's BackyardHash + BlendedSort + AsyncMerge
  pipeline, ``src/GossCmdBuildGraph.cc:270-491``) becomes: device
  kmerization -> multi-limb sort -> segment-sum dedup -> sorted-run merge,
  with host-RAM spill for spectra larger than device memory.
* Multi-device scale-out uses ``jax.sharding.Mesh`` + ``shard_map`` with
  all-to-all k-mer-prefix shuffles instead of spill files.
"""

import os as _os

import jax as _jax

# The engine manipulates 64-bit k-mer words everywhere; enable x64 once,
# centrally, before any other module is imported.
_jax.config.update("jax_enable_x64", True)


def _compile_cache_dir(environ=_os.environ) -> str | None:
    """Directory this package sets for JAX's persistent compile cache.

    None when ``JAX_COMPILATION_CACHE_DIR`` is set: JAX reads that
    variable itself, and no other directory is set in code.  Otherwise
    a fixed path inside the checkout (the path is part of the cache key,
    so it must not move between runs)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".jax_cache")


# Persistent compile cache: the engine uses a small family of static
# shapes; caching makes repeat CLI invocations start in seconds.
_cache_dir = _compile_cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

__version__ = "0.1.0"

# Reference format versions we keep output parity with.
GRAPH_VERSION = 2011101014  # src/Graph.hh:65
KMER_SET_VERSION = 2011101701  # src/KmerSet.hh:26
MAX_K = 62  # src/Graph.hh:87-89 (128-bit rho-mers)
