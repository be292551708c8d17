"""Device-memory gauges (the memory half of
``deeplearning4j_tpu/monitor/jitwatch.py``).

:func:`sample_device_memory` reads the caching allocator's counters of
every card (``torch.cuda.memory_stats``) into the JAX package's gauges:
``device_memory_in_use_bytes{device=}`` (allocated bytes now),
``device_memory_peak_bytes{device=}`` (their peak over the process) and
``device_live_buffers`` (active allocations over all cards, the
counterpart of ``len(jax.live_arrays())``). A process that never touched
CUDA is not made to: the sampler then records nothing.
:func:`maybe_sample_device_memory` is the throttled form the step span
calls after each step, at most once a ``DL4J_TPU_MEMSAMPLE_INTERVAL``
seconds (default 1.0).

The rest of the JAX module (the jit registry, compile and retrace
watching, cost capture, the profile report) is ROADMAP A 16.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict

import torch

log = logging.getLogger(__name__)

__all__ = ["sample_device_memory", "maybe_sample_device_memory"]


def sample_device_memory(registry=None) -> Dict[str, Any]:
    """Sample each card's allocator counters into the gauges; returns the
    same data as a dict. Never raises."""
    out: Dict[str, Any] = {"devices": {}, "live_buffers": None}
    if not torch.cuda.is_initialized():
        return out
    try:
        from .registry import get_registry
        reg = registry if registry is not None else get_registry()
        live = 0
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            dev = f"cuda:{i}"
            in_use = int(stats.get("allocated_bytes.all.current", 0))
            peak = int(stats.get("allocated_bytes.all.peak", 0))
            reg.gauge("device_memory_in_use_bytes", "device bytes currently allocated",
                      device=dev).set(float(in_use))
            reg.gauge("device_memory_peak_bytes",
                      "peak device bytes over the process lifetime",
                      device=dev).set(float(peak))
            out["devices"][dev] = {"bytes_in_use": in_use, "peak_bytes_in_use": peak,
                                   "bytes_limit": int(torch.cuda.get_device_properties(i)
                                                      .total_memory)}
            live += int(stats.get("active.all.current", 0))
        reg.gauge("device_live_buffers",
                  "active allocations of the caching allocator, all cards").set(float(live))
        out["live_buffers"] = live
    except (RuntimeError, AssertionError) as e:
        log.debug("device memory sample failed: %r", e)
    return out


#: per-step sampling throttle (seconds)
_SAMPLE_INTERVAL = float(os.environ.get("DL4J_TPU_MEMSAMPLE_INTERVAL", "1.0"))
_LAST_SAMPLE = [0.0]


def maybe_sample_device_memory():
    """Throttled :func:`sample_device_memory`: at most one sample per
    ``DL4J_TPU_MEMSAMPLE_INTERVAL`` seconds."""
    now = time.monotonic()
    if now - _LAST_SAMPLE[0] < _SAMPLE_INTERVAL:
        return
    _LAST_SAMPLE[0] = now
    sample_device_memory()
