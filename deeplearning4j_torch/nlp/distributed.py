"""Distributed NLP embeddings: Word2Vec and GloVe across processes.

Counterpart of ``deeplearning4j_tpu/nlp/distributed.py`` (reference
``dl4j-spark-nlp``: ``TextPipeline.java:1`` builds one vocabulary for the
cluster, ``FirstIterationFunction``/``SecondIterationFunction`` train each
partition of sentences, ``Word2Vec.java:237`` averages the trained
vectors). Every process tokenizes the whole corpus (the same vocabulary
everywhere), keeps its round-robin share of the sentences
(:func:`partition_sentences`), trains on it with the single-process
engine (``Word2Vec.fit_tokenized``), and the tables are averaged across
the ``torch.distributed`` process group after every epoch. GloVe
distributes the co-occurrence counting: each process counts its share,
the sparse counts are gathered and merged, and the factorization runs
alike everywhere from the same merged counts. With one process both are
the single-process models.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .glove import Glove
from .word2vec import Word2Vec

__all__ = ["DistributedWord2Vec", "DistributedGlove", "SparkWord2Vec",
           "SparkGlove", "partition_sentences"]


def _group():
    from ..parallel.distributed import process_count, process_index
    return process_index(), process_count()


def partition_sentences(sentences, process_index: Optional[int] = None,
                        process_count: Optional[int] = None):
    """Round-robin sentence partitioning: process ``p`` of ``P`` keeps
    sentences ``p, p+P, ...`` (the map-partition feed of
    ``FirstIterationFunction``)."""
    p0, n0 = _group()
    p = p0 if process_index is None else process_index
    P = n0 if process_count is None else process_count
    return [s for i, s in enumerate(sentences) if i % P == p]


def _mean_across_processes(t: torch.Tensor) -> torch.Tensor:
    """The processes' mean of a replicated table (the reference's
    driver-side averaging); the table itself with one process."""
    from ..parallel.distributed import all_reduce_mean
    return all_reduce_mean(t)


def _allgather_rows(rows: np.ndarray) -> np.ndarray:
    """Every process's row block, concatenated in rank order."""
    from ..parallel.distributed import allgather_objects
    return np.concatenate(allgather_objects(rows), axis=0)


class DistributedWord2Vec:
    """Multi-process Word2Vec (reference Spark ``Word2Vec.java:61``).

    Usage matches the single-host Builder; ``fit`` partitions sentences
    across processes, trains each partition locally with the existing jitted
    skip-gram engine (``nlp/sequencevectors.py``), and averages the embedding
    tables across processes after every epoch. All processes finish with
    the same tables.
    """

    def __init__(self, word2vec: Optional[Word2Vec] = None, **kw):
        self.w2v = word2vec if word2vec is not None else Word2Vec(**kw)

    def fit(self, sentences):
        """``sentences``: the full corpus (every process passes the same
        list — the reference ships the RDD; we ship the stream and partition
        by index)."""
        w = self.w2v
        tokenized = [w._tokenizer.create(s).get_tokens() for s in sentences]
        # TextPipeline: one vocab for the whole cluster, built identically
        # on every process (driver-build + broadcast equivalent)
        w.build_vocab(tokenized)
        local = partition_sentences(tokenized)
        # epochs are driven here so tables average once per epoch (the
        # reference's per-iteration aggregation cadence); the local engine
        # runs single epochs over the partition
        epochs, w.epochs = w.epochs, 1
        try:
            for _ in range(epochs):
                if local:
                    w.fit_tokenized(local)
                lt = w.lookup_table
                lt.syn0 = _mean_across_processes(lt.syn0)
                if lt.syn1 is not None:
                    lt.syn1 = _mean_across_processes(lt.syn1)
                if lt.syn1neg is not None:
                    lt.syn1neg = _mean_across_processes(lt.syn1neg)
        finally:
            w.epochs = epochs
        return self

    # delegate the query surface
    def __getattr__(self, name):
        return getattr(self.w2v, name)


class DistributedGlove:
    """Multi-process GloVe (reference ``glove/count/`` Spark co-occurrence
    jobs feeding ``Glove.java``): counting is partitioned, counts are merged
    cluster-wide, training runs identically everywhere — the distributed
    model equals the single-process model on the same corpus exactly."""

    def __init__(self, glove: Optional[Glove] = None, **kw):
        self.glove = glove if glove is not None else Glove(**kw)

    def fit(self, sentences):
        g = self.glove
        tokenized = [g._tokenizer.create(s).get_tokens() for s in sentences]
        from .vocab import build_vocab
        # cluster-wide vocab, built identically everywhere (TextPipeline)
        g.vocab = build_vocab(tokenized, g.min_word_frequency,
                              build_huffman=False)
        local = partition_sentences(tokenized)
        cooc: Dict[Tuple[int, int], float] = defaultdict(float)
        for seq in local:
            idxs = [g.vocab.index_of(t) for t in seq]
            idxs = [i for i in idxs if i >= 0]
            for pos, i in enumerate(idxs):
                for off in range(1, g.window + 1):
                    j = pos + off
                    if j >= len(idxs):
                        break
                    cooc[(i, idxs[j])] += 1.0 / off
                    cooc[(idxs[j], i)] += 1.0 / off
        if cooc:
            block = np.asarray([(i, j, v) for (i, j), v in cooc.items()],
                               np.float64)
        else:
            block = np.zeros((0, 3), np.float64)
        if _group()[1] > 1:
            block = _allgather_rows(block)
        merged: Dict[Tuple[int, int], float] = defaultdict(float)
        for i, j, v in block:
            merged[(int(i), int(j))] += float(v)
        g.fit_cooccurrences(merged)
        return self

    def __getattr__(self, name):
        return getattr(self.glove, name)


# reference-name aliases (Spark facade naming)
SparkWord2Vec = DistributedWord2Vec
SparkGlove = DistributedGlove
