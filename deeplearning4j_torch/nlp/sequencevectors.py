"""SequenceVectors: the generic embedding trainer (the word2vec engine).

Counterpart of ``deeplearning4j_tpu/nlp/sequencevectors.py`` (reference
``models/sequencevectors/SequenceVectors.java``, the learning algorithms
``models/embeddings/learning/impl/elements/{SkipGram,CBOW}`` and
``InMemoryLookupTable``).

The host draws what the JAX package draws, from the same numpy stream:
subsampling, dynamic windows, the pairs of each sequence, the learning rate
and the negative samples. Pairs are batched to ``batch_size`` and each
batch is one update on the device: the pairs, packed into one [n, 2 + K]
int32 array, cross to the device in one copy (from pinned memory on the
card), then the hierarchical-softmax step and the negative-sampling step
run in that order, as in the JAX package. Each step gathers rows
(``index_select``), takes sigmoid dot products by batched products, and
scatters the updates with ``index_add_``: every duplicate index of a batch
is summed, and every pair of the batch reads the tables as they were before
the batch. (Advanced-index assignment would keep one duplicate and drop
the rest.) On the card ``index_add_`` sums duplicates with float atomics,
so two runs part in the last bits.

The JAX package pads the tail batch to ``batch_size`` and masks the
padding on the device; here the tail is sliced on the host, which adds the
same (zero) updates. ``syn0``, ``syn1`` and ``syn1neg`` stay on the device
across batches; ``vector`` returns a numpy copy of a row.
"""
from __future__ import annotations

import logging
import math
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from .vocab import VocabCache, build_vocab

__all__ = ["InMemoryLookupTable", "SequenceVectors", "lookup_table_from_numpy"]

log = logging.getLogger(__name__)


def _initial_syn0(rng, n, d) -> np.ndarray:
    return ((rng.random((n, d)) - 0.5) / d).astype(np.float32)


class InMemoryLookupTable:
    """Reference ``models/embeddings/inmemory/InMemoryLookupTable``: syn0
    (word vectors), syn1 (HS inner-node weights), syn1neg (NS weights), f32
    tensors on ``device``; syn0 drawn from ``seed`` with numpy as in the JAX
    package."""

    def __init__(self, vocab: VocabCache, vector_length: int, seed: int = 123,
                 use_hs: bool = True, use_neg: bool = False, device="cuda"):
        self.vocab = vocab
        self.vector_length = vector_length
        self.device = resolve_device(device)
        n = vocab.num_words()
        self.syn0 = torch.from_numpy(
            _initial_syn0(np.random.default_rng(seed), n, vector_length)).to(self.device)
        self.syn1 = (torch.zeros((max(n - 1, 1), vector_length), device=self.device)
                     if use_hs else None)
        self.syn1neg = (torch.zeros((n, vector_length), device=self.device)
                        if use_neg else None)

    def reset_weights(self, seed: int = 123):
        n = self.vocab.num_words()
        self.syn0 = torch.from_numpy(
            _initial_syn0(np.random.default_rng(seed), n, self.vector_length)).to(self.device)
        if self.syn1 is not None:
            self.syn1 = torch.zeros_like(self.syn1)
        if self.syn1neg is not None:
            self.syn1neg = torch.zeros_like(self.syn1neg)

    resetWeights = reset_weights

    def vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.syn0[i].cpu().numpy()


def lookup_table_from_numpy(vocab: VocabCache, syn0, syn1=None, syn1neg=None,
                            device="cuda") -> InMemoryLookupTable:
    """A lookup table over ``vocab`` holding copies of the given arrays
    (``np.asarray`` of a JAX table's ``syn0``, ``syn1``, ``syn1neg``) on
    ``device``, in their dtype; a table given as None is left out."""
    syn0 = np.asarray(syn0)
    lt = InMemoryLookupTable.__new__(InMemoryLookupTable)
    lt.vocab = vocab
    lt.vector_length = int(syn0.shape[1])
    lt.device = resolve_device(device)
    lt.syn0, lt.syn1, lt.syn1neg = (
        None if a is None else torch.from_numpy(np.array(a)).to(lt.device)
        for a in (syn0, syn1, syn1neg))
    return lt


# ------------------------------------------------------------------- steps
def _hs_step(syn0, syn1, rows, targets, hs_points, hs_codes, hs_mask, lr):
    """Hierarchical-softmax skip-gram/CBOW update of one batch, in place.

    rows, targets: [B] int (the rows updated; the words whose Huffman path
    is the objective). hs_points/codes/mask: [V, L] tables of every word's
    path. The classic word2vec rule: g = (1 - code - sigmoid(h . v)) lr.
    Returns (syn0, syn1)."""
    B, d = rows.shape[0], syn0.shape[1]
    points = hs_points.index_select(0, targets)                    # [B, L]
    codes = hs_codes.index_select(0, targets).to(syn0.dtype)
    mask = hs_mask.index_select(0, targets).to(syn0.dtype)
    h = syn0.index_select(0, rows)                                  # [B, d]
    v = syn1.index_select(0, points.reshape(-1)).view(B, -1, d)     # [B, L, d]
    f = torch.sigmoid(torch.bmm(v, h.unsqueeze(2)).squeeze(2))     # [B, L]
    g = (1.0 - codes - f) * mask * lr                               # [B, L]
    dh = torch.bmm(g.unsqueeze(1), v).squeeze(1)                    # [B, d]
    dv = g.unsqueeze(2) * h.unsqueeze(1)                            # [B, L, d]
    syn0.index_add_(0, rows, dh)
    syn1.index_add_(0, points.reshape(-1), dv.reshape(-1, d) * mask.reshape(-1, 1))
    return syn0, syn1


def _ns_step(syn0, syn1neg, rows, targets, lr):
    """Negative-sampling update of one batch, in place. rows: [B]; targets:
    [B, K+1], the positive target then K negatives (label 1, then 0).
    Returns (syn0, syn1neg)."""
    B, d = rows.shape[0], syn0.shape[1]
    h = syn0.index_select(0, rows)                                  # [B, d]
    v = syn1neg.index_select(0, targets.reshape(-1)).view(B, -1, d)  # [B, K+1, d]
    f = torch.sigmoid(torch.bmm(v, h.unsqueeze(2)).squeeze(2))     # [B, K+1]
    labels = torch.zeros_like(f)
    labels[:, 0] = 1.0
    g = (labels - f) * lr
    dh = torch.bmm(g.unsqueeze(1), v).squeeze(1)
    dv = g.unsqueeze(2) * h.unsqueeze(1)
    syn0.index_add_(0, rows, dh)
    syn1neg.index_add_(0, targets.reshape(-1), dv.reshape(-1, d))
    return syn0, syn1neg


class SequenceVectors:
    """Configurable embedding trainer over sequences of tokens; its tables
    live on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, vector_length: int = 100, window: int = 5,
                 min_word_frequency: int = 1, learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4, epochs: int = 1,
                 negative: int = 0,
                 use_hierarchic_softmax: Optional[bool] = None,
                 subsampling: float = 0.0, batch_size: int = 512,
                 seed: int = 123, device="cuda"):
        self.vector_length = vector_length
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.negative = negative
        # NS replaces HS unless HS is explicitly requested (word2vec
        # convention; combining both doubles device work for no benefit)
        if use_hierarchic_softmax is None:
            self.use_hs = negative == 0
        else:
            self.use_hs = use_hierarchic_softmax or negative == 0
        self.subsampling = subsampling
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None
        self._neg_table: Optional[np.ndarray] = None
        self._code_len = 0
        self._hs_tables = None

    # ----------------------------------------------------------------- vocab
    def build_vocab(self, sequences: Iterable[Sequence[str]]):
        self.vocab = build_vocab(sequences,
                                 min_word_frequency=self.min_word_frequency,
                                 build_huffman=True)
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.vector_length, self.seed,
            use_hs=self.use_hs, use_neg=self.negative > 0, device=self.device)
        self._code_len = max((len(w.codes)
                              for w in self.vocab.vocab_words()), default=1)
        self._hs_tables = None
        if self.use_hs:
            # vocab-wide Huffman tables, on the device once: a batch's HS
            # encoding is three gathers there
            V, L = self.vocab.num_words(), self._code_len
            points = np.zeros((V, L), np.int32)
            codes = np.zeros((V, L), np.float32)
            mask = np.zeros((V, L), np.float32)
            for i, w in enumerate(self.vocab.vocab_words()):
                k = len(w.codes)
                points[i, :k] = w.points
                codes[i, :k] = w.codes
                mask[i, :k] = 1.0
            self._hs_tables = tuple(torch.from_numpy(a).to(self.device)
                                    for a in (points, codes, mask))
        if self.negative > 0:
            self._neg_table = self._build_unigram_table()
        return self

    buildVocab = build_vocab

    def _build_unigram_table(self, size: int = 1 << 20) -> np.ndarray:
        """word2vec unigram^0.75 sampling table."""
        freqs = np.array([w.frequency for w in self.vocab.vocab_words()])
        p = freqs ** 0.75
        p /= p.sum()
        return np.random.default_rng(self.seed).choice(
            len(freqs), size=size, p=p).astype(np.int32)

    # ------------------------------------------------------------------- fit
    def fit(self, sequences_provider):
        """``sequences_provider``: callable returning an iterable of token
        sequences (re-iterable across epochs), or a list of sequences."""
        provider = (sequences_provider if callable(sequences_provider)
                    else (lambda: sequences_provider))
        if self.vocab is None:
            self.build_vocab(provider())
        total_words = max(self.vocab.total_word_count, 1.0)
        rng = np.random.default_rng(self.seed)
        words_seen = 0
        est_total = total_words * self.epochs
        for epoch in range(self.epochs):
            pend_c: List[np.ndarray] = []
            pend_t: List[np.ndarray] = []
            pending = 0
            for seq in provider():
                idxs = self._subsampled_indices(seq, rng)
                words_seen += len(idxs)
                c, t = self._sequence_pairs_arrays(idxs, rng)
                if c.size:
                    pend_c.append(c)
                    pend_t.append(t)
                    pending += c.size
                if pending >= self.batch_size:
                    # concatenate once, then walk batch-size slices (the
                    # remainder is a view)
                    cat_c = np.concatenate(pend_c)
                    cat_t = np.concatenate(pend_t)
                    off = 0
                    while pending - off >= self.batch_size:
                        lr = self._lr(words_seen, est_total)
                        self._apply_pairs(cat_c[off:off + self.batch_size],
                                          cat_t[off:off + self.batch_size],
                                          lr, rng)
                        off += self.batch_size
                    pend_c = [cat_c[off:]]
                    pend_t = [cat_t[off:]]
                    pending -= off
            if pending:
                lr = self._lr(words_seen, est_total)
                self._apply_pairs(np.concatenate(pend_c),
                                  np.concatenate(pend_t), lr, rng)
        return self

    def _sequence_pairs(self, idxs, rng):
        """Yield (center, context) training pairs for one sequence: dynamic
        windows, skip-gram convention. Overridden by doc2vec to add
        document-level pairs; the vectorized array path below is used when
        this method is NOT overridden."""
        for pos, center in enumerate(idxs):
            b = rng.integers(1, self.window + 1)  # dynamic window
            lo = max(0, pos - b)
            hi = min(len(idxs), pos + b + 1)
            for j in range(lo, hi):
                if j != pos:
                    yield center, idxs[j]

    def _sequence_pairs_arrays(self, idxs, rng):
        """(centers, contexts) int32 arrays for one sequence, vectorized.
        Subclasses that override ``_sequence_pairs`` fall back to the
        generator; ``_orient_pairs`` gives CBOW its row/target swap."""
        n = len(idxs)
        if n < 2:
            empty = np.empty(0, np.int32)
            return empty, empty
        if type(self)._sequence_pairs is not SequenceVectors._sequence_pairs:
            pairs = list(self._sequence_pairs(idxs, rng))
            if not pairs:
                empty = np.empty(0, np.int32)
                return empty, empty
            arr = np.asarray(pairs, np.int32)
            return self._orient_pairs(arr[:, 0], arr[:, 1])
        c, t = self._window_pairs_arrays(idxs, rng)
        return self._orient_pairs(c, t)

    def _window_pairs_arrays(self, idxs, rng):
        """Raw vectorized dynamic-window pairs (centers, contexts): no
        orientation, no override dispatch; doc2vec reuses it for its
        word-word pairs."""
        n = len(idxs)
        if n < 2:
            empty = np.empty(0, np.int32)
            return empty, empty
        arr = np.asarray(idxs, np.int32)
        pos = np.arange(n)
        b = rng.integers(1, self.window + 1, size=n)
        lo = np.maximum(0, pos - b)
        hi = np.minimum(n, pos + b + 1)
        counts = hi - lo - 1                      # window size minus center
        total = int(counts.sum())
        if total == 0:
            empty = np.empty(0, np.int32)
            return empty, empty
        centers_pos = np.repeat(pos, counts)
        # within-window offsets 0..count-1 per center
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        offs = np.arange(total) - np.repeat(starts, counts)
        ctx_pos = np.repeat(lo, counts) + offs
        ctx_pos += (ctx_pos >= centers_pos)       # skip the center slot
        return arr[centers_pos], arr[ctx_pos]

    def _orient_pairs(self, centers, contexts):
        """Skip-gram orientation: the CENTER row is updated against the
        context's objective. CBOW overrides to swap."""
        return centers, contexts

    def _lr(self, words_seen, est_total):
        frac = min(words_seen / est_total, 1.0)
        return max(self.learning_rate * (1 - frac), self.min_learning_rate)

    def _subsampled_indices(self, seq, rng) -> List[int]:
        out = []
        for tok in seq:
            i = self.vocab.index_of(tok)
            if i < 0:
                continue
            if self.subsampling > 0:
                f = self.vocab.word_at(i).frequency / self.vocab.total_word_count
                keep = (math.sqrt(f / self.subsampling) + 1) * self.subsampling / f
                if rng.random() > keep:
                    continue
            out.append(i)
        return out

    def _packed_to_device(self, packed: np.ndarray) -> torch.Tensor:
        """The batch's packed pairs on the device in one copy: from pinned
        memory, not waiting for the card, when it is a card."""
        t = torch.from_numpy(packed)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _apply_pairs(self, rows, targets, lr, rng):
        """Update syn0[rows] against targets' objective: the HS step, then
        the NS step (its K negatives a pair drawn for a full batch, as the
        JAX package draws them for its padded batch)."""
        lt = self.lookup_table
        n = len(rows)
        cols = [np.asarray(rows, np.int32)[:, None], np.asarray(targets, np.int32)[:, None]]
        if self.negative > 0:
            B = max(self.batch_size, n)
            negs = self._neg_table[rng.integers(0, len(self._neg_table),
                                                size=(B, self.negative))]
            cols.append(negs[:n])
        packed = self._packed_to_device(np.concatenate(cols, axis=1))   # [n, 2+K]
        lr = float(np.float32(lr))
        if self.use_hs:
            _hs_step(lt.syn0, lt.syn1, packed[:, 0], packed[:, 1], *self._hs_tables, lr)
        if self.negative > 0:
            _ns_step(lt.syn0, lt.syn1neg, packed[:, 0], packed[:, 1:], lr)

    # ------------------------------------------------------------- inference
    def word_vector(self, word: str) -> Optional[np.ndarray]:
        return self.lookup_table.vector(word)

    getWordVector = word_vector

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.word_vector(a), self.word_vector(b)
        if va is None or vb is None:
            return float("nan")
        na = np.linalg.norm(va)
        nb = np.linalg.norm(vb)
        if na == 0 or nb == 0:
            return 0.0
        return float(va @ vb / (na * nb))

    def words_nearest(self, word: str, n: int = 10) -> List[str]:
        """The ``n`` words of highest cosine with ``word``, ranked on the
        device (only the order comes to the host)."""
        i = self.vocab.index_of(word) if self.vocab is not None else -1
        if i < 0:
            return []
        syn0 = self.lookup_table.syn0
        v = syn0[i]
        norms = torch.linalg.vector_norm(syn0, dim=1) * max(
            torch.linalg.vector_norm(v).item(), 1e-9)
        sims = syn0 @ v / torch.clamp(norms, min=1e-9)
        order = torch.argsort(-sims, stable=True)[:n + 1].cpu().numpy()
        out = []
        for j in order:
            w = self.vocab.word_at(int(j)).word
            if w != word:
                out.append(w)
            if len(out) >= n:
                break
        return out

    wordsNearest = words_nearest

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    hasWord = has_word
