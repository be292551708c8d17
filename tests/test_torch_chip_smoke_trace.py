"""``chip_smoke.py``'s reading of a profiler trace, on a made-up trace.

The put-ahead check holds every batch copy made once the steps had begun
to mostly overlap kernels on other streams. The first batch's copy cannot:
the first step waits for it, and only the fit's set-up kernels run beside
it. With a ``step_mark`` the steps begin at the first kernel launched inside
the first marked range, so that copy is not held; without one they begin at
the first compute-stream kernel.
"""
import pytest

import chip_smoke

COMPUTE, COPY = 7, 30
BATCH = 1 << 29


def _kernel(ts, dur, corr, stream=COMPUTE):
    return {"cat": "kernel", "name": "k", "ts": ts, "dur": dur,
            "args": {"stream": stream, "correlation": corr}}


def _launch(ts, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _copy(ts, dur):
    return {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": ts, "dur": dur,
            "args": {"stream": COPY, "bytes": BATCH}}


def _trace():
    """A set-up kernel (0-5 us), batch 0's copy (2-12) with nothing else
    beside it, the first step (marked on the host 1-40, its kernels 13-100
    on the device) and batch 1's copy (20-30) under it."""
    return [_launch(0, 1), _kernel(0, 5, 1),
            {"cat": "user_annotation", "name": "step", "ts": 1, "dur": 39},
            _copy(2, 10),
            _launch(3, 2), _kernel(13, 40, 2), _launch(4, 3), _kernel(53, 47, 3),
            _copy(20, 10)]


@pytest.mark.parametrize("mark, held", [("step", [False, True]), (None, [True, True])])
def test_copies_under_the_steps_start_at_the_marked_first_step(mark, held):
    got = chip_smoke.trace_summary("made-up", _trace(), 100.0, step_mark=mark)
    assert got["compute_stream"] == COMPUTE
    assert got["steps_marked"] == (mark is not None)
    assert [c["under_steps"] for c in got["batch_copies"]] == held
    assert [round(c["overlap"], 3) for c in got["batch_copies"]] == [0.3, 1.0]
