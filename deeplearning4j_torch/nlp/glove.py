"""GloVe: co-occurrence counting and AdaGrad-weighted least squares.

Counterpart of ``deeplearning4j_tpu/nlp/glove.py`` (reference
``models/glove/Glove.java`` and its ``glove/count/`` co-occurrence
machinery): the distance-weighted, symmetric co-occurrence map is counted
on the host, then batched AdaGrad updates of ``w_i . wc_j + b_i + bc_j ~
log X_ij`` weighted by f(X) run on ``device`` (the card unless
``device="cpu"``). The pairs are sorted canonically and visited in the same
``rng.permutation`` order as in the JAX package; the pairs, log X and f(X)
cross to the device once, each epoch's order once.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .vocab import VocabCache, build_vocab
from .text import (CollectionSentenceIterator, DefaultTokenizerFactory,
                   SentenceIterator, TokenizerFactory)

__all__ = ["Glove"]


def _glove_step(w, wc, b, bc, hw, hwc, hb, hbc, rows, cols, logx, fx, lr):
    """One AdaGrad batch of J = f(x) (w_i . wc_j + b_i + bc_j - log x)^2, in
    place. The gradients are taken at the batch's entry values; the
    accumulators take the batch's squared gradients (duplicates summed)
    before the step reads them, as in the JAX package. Returns the tables
    and the batch's loss (a 0-d tensor)."""
    wi = w.index_select(0, rows)
    wj = wc.index_select(0, cols)
    diff = (wi * wj).sum(-1) + b.index_select(0, rows) + bc.index_select(0, cols) - logx
    g = fx * diff                                                   # [B]
    gwi = g[:, None] * wj
    gwj = g[:, None] * wi
    gbi = g
    gbj = g
    # AdaGrad accumulators
    hw.index_add_(0, rows, gwi * gwi)
    hwc.index_add_(0, cols, gwj * gwj)
    hb.index_add_(0, rows, gbi * gbi)
    hbc.index_add_(0, cols, gbj * gbj)
    w.index_add_(0, rows, -lr * gwi / torch.sqrt(hw.index_select(0, rows) + 1e-8))
    wc.index_add_(0, cols, -lr * gwj / torch.sqrt(hwc.index_select(0, cols) + 1e-8))
    b.index_add_(0, rows, -lr * gbi / torch.sqrt(hb.index_select(0, rows) + 1e-8))
    bc.index_add_(0, cols, -lr * gbj / torch.sqrt(hbc.index_select(0, cols) + 1e-8))
    loss = 0.5 * (fx * diff * diff).sum()
    return w, wc, b, bc, hw, hwc, hb, hbc, loss


class Glove:
    """Reference ``Glove.java`` Builder surface (subset) + fit/query."""

    class Builder:
        def __init__(self):
            self._kw = {}
            self._iterator = None
            self._tokenizer = DefaultTokenizerFactory()

        def layer_size(self, n):
            self._kw["vector_length"] = int(n)
            return self

        layerSize = layer_size

        def window_size(self, n):
            self._kw["window"] = int(n)
            return self

        windowSize = window_size

        def min_word_frequency(self, n):
            self._kw["min_word_frequency"] = int(n)
            return self

        minWordFrequency = min_word_frequency

        def learning_rate(self, v):
            self._kw["learning_rate"] = float(v)
            return self

        learningRate = learning_rate

        def epochs(self, n):
            self._kw["epochs"] = int(n)
            return self

        def x_max(self, v):
            self._kw["x_max"] = float(v)
            return self

        xMax = x_max

        def alpha(self, v):
            self._kw["alpha"] = float(v)
            return self

        def device(self, dev):
            """Where the factorization trains: "cuda" (the default) or
            "cpu"."""
            self._kw["device"] = dev
            return self

        def iterate(self, it: SentenceIterator):
            self._iterator = it
            return self

        def tokenizer_factory(self, tf: TokenizerFactory):
            self._tokenizer = tf
            return self

        tokenizerFactory = tokenizer_factory

        def build(self) -> "Glove":
            g = Glove(**self._kw)
            g._iterator = self._iterator
            g._tokenizer = self._tokenizer
            return g

    @staticmethod
    def builder():
        return Glove.Builder()

    def __init__(self, vector_length: int = 100, window: int = 5,
                 min_word_frequency: int = 1, learning_rate: float = 0.05,
                 epochs: int = 5, x_max: float = 100.0, alpha: float = 0.75,
                 batch_size: int = 4096, seed: int = 123, device="cuda"):
        self.vector_length = vector_length
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.x_max = x_max
        self.alpha = alpha
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.syn0 = None
        self._iterator = None
        self._tokenizer = DefaultTokenizerFactory()

    def _sentences(self):
        for s in self._iterator:
            yield self._tokenizer.create(s).get_tokens()

    def fit(self, sentences: Optional[Sequence[str]] = None):
        if sentences is not None:
            self._iterator = CollectionSentenceIterator(sentences)
        seqs = list(self._sentences())
        self.vocab = build_vocab(seqs, self.min_word_frequency,
                                 build_huffman=False)
        cooc: Dict[Tuple[int, int], float] = defaultdict(float)
        for seq in seqs:
            idxs = [self.vocab.index_of(t) for t in seq]
            idxs = [i for i in idxs if i >= 0]
            for pos, i in enumerate(idxs):
                for off in range(1, self.window + 1):
                    j = pos + off
                    if j >= len(idxs):
                        break
                    # distance-weighted count, symmetric (GloVe convention)
                    cooc[(i, idxs[j])] += 1.0 / off
                    cooc[(idxs[j], i)] += 1.0 / off
        return self.fit_cooccurrences(cooc)

    def fit_cooccurrences(self, cooc: Dict[Tuple[int, int], float]):
        """Train the factorization from a co-occurrence map (split out so
        that counts merged elsewhere train the same way). Pairs are sorted
        canonically, so the same counts give the same vectors whatever the
        map's insertion order."""
        n = self.vocab.num_words()
        d = self.vector_length
        dev = self.device
        rng = np.random.default_rng(self.seed)
        w = torch.from_numpy(((rng.random((n, d)) - 0.5) / d).astype(np.float32)).to(dev)
        wc = torch.from_numpy(((rng.random((n, d)) - 0.5) / d).astype(np.float32)).to(dev)
        b = torch.zeros((n,), device=dev)
        bc = torch.zeros((n,), device=dev)
        hw = torch.ones((n, d), device=dev)
        hwc = torch.ones((n, d), device=dev)
        hb = torch.ones((n,), device=dev)
        hbc = torch.ones((n,), device=dev)

        items = sorted(cooc.items())
        pairs = np.asarray([ij for ij, _ in items], np.int32).reshape(-1, 2)
        counts = np.asarray([v for _, v in items], np.float32)
        logx = np.log(counts)
        fx = np.minimum((counts / self.x_max) ** self.alpha, 1.0).astype(np.float32)
        rows_d, cols_d = (torch.from_numpy(np.ascontiguousarray(pairs[:, k])).to(dev)
                          for k in (0, 1))
        logx_d, fx_d = torch.from_numpy(logx).to(dev), torch.from_numpy(fx).to(dev)
        lr = float(np.float32(self.learning_rate))
        B = self.batch_size
        for _ in range(self.epochs):
            order = torch.from_numpy(rng.permutation(len(pairs))).to(dev)
            for s in range(0, len(pairs), B):
                sel = order[s:s + B]
                (w, wc, b, bc, hw, hwc, hb, hbc, _) = _glove_step(
                    w, wc, b, bc, hw, hwc, hb, hbc, rows_d.index_select(0, sel),
                    cols_d.index_select(0, sel), logx_d.index_select(0, sel),
                    fx_d.index_select(0, sel), lr)
        # final vectors: w + wc (GloVe paper recommendation)
        self.syn0 = w.cpu().numpy() + wc.cpu().numpy()
        return self

    fitCooccurrences = fit_cooccurrences

    # ----------------------------------------------------------------- query
    def word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word) if self.vocab else -1
        return None if i < 0 else self.syn0[i]

    getWordVector = word_vector

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.word_vector(a), self.word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = max(np.linalg.norm(va) * np.linalg.norm(vb), 1e-9)
        return float(va @ vb / denom)
