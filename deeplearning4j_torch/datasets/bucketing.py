"""Bucket rules shared by batching code.

Counterpart of the two rule functions of
``deeplearning4j_tpu/datasets/bucketing.py``: a bucket spec is a sorted set
of positive sizes, and a size goes to the smallest bucket that admits it.
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["validate_buckets", "bucket_for"]


def validate_buckets(values: Sequence[int], kind: str = "batch") -> List[int]:
    """Normalize a bucket spec: sorted unique positive ints, loud on junk."""
    out = sorted({int(v) for v in values})
    if not out or out[0] < 1:
        raise ValueError(f"{kind} buckets must be positive ints, got "
                         f"{list(values)}")
    return out


def bucket_for(buckets, n: int, kind: str = "batch") -> int:
    """Smallest bucket admitting ``n``; oversize is rejected loudly."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(
        f"{kind} size {n} exceeds the largest configured bucket "
        f"{buckets[-1]} — add a bucket >= {n} (buckets: {buckets})")
