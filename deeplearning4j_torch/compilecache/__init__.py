"""Compile-once fleet: the shared kernel-library cache and warmup
artifacts (counterpart of ``deeplearning4j_tpu/compilecache/``).

- ``cache.py``: the directory where kernel libraries are built and loaded,
  shared across processes under ``DL4J_TPU_COMPILE_CACHE_DIR``; hit/miss
  counts (a library on disk against an ``nvcc`` run), stats and GC.
- ``artifacts.py``: a served model's warmup artifact (fingerprint,
  signatures, golden set and kernel libraries) and its checked install.
"""
from .cache import (ENV_DIR, cache_dir, cache_stats, claim_persistent_hit,  # noqa: F401
                    enable, enabled, gc_cache, hits_count, maybe_enable,
                    persistent_cache_counts)
from .artifacts import (ARTIFACT_EXT, ArtifactError, export_warmup_artifact,  # noqa: F401
                        load_warmup_artifact, read_manifest, runtime_fingerprint,
                        topology_hash, try_install)

__all__ = [
    "ENV_DIR", "enable", "maybe_enable", "enabled", "cache_dir",
    "hits_count", "claim_persistent_hit", "persistent_cache_counts",
    "cache_stats", "gc_cache",
    "ARTIFACT_EXT", "ArtifactError", "export_warmup_artifact",
    "load_warmup_artifact", "read_manifest", "runtime_fingerprint",
    "topology_hash", "try_install",
]
