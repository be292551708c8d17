"""Word2Vec and ParagraphVectors on the SequenceVectors engine.

Counterpart of ``deeplearning4j_tpu/nlp/word2vec.py`` (reference
``models/word2vec/Word2Vec.java`` with its Builder, CBOW
(``learning/impl/elements/CBOW.java``) and
``models/paragraphvectors/ParagraphVectors.java`` with the DBOW/DM
sequence algorithms). Every model trains on ``device``, the card unless
``device="cpu"`` is passed to the constructor or to the builder's
``device``.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch

from .sequencevectors import SequenceVectors
from .text import (SentenceIterator, CollectionSentenceIterator,
                   DefaultTokenizerFactory, TokenizerFactory)


class Word2Vec(SequenceVectors):
    """Skip-gram (default) / CBOW word embeddings."""

    class Builder:
        def __init__(self):
            self._kw = {}
            self._iterator: Optional[SentenceIterator] = None
            self._tokenizer: TokenizerFactory = DefaultTokenizerFactory()
            self._cbow = False

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

        def min_learning_rate(self, v):
            self._kw["min_learning_rate"] = float(v)
            return self

        minLearningRate = min_learning_rate

        def epochs(self, n):
            self._kw["epochs"] = int(n)
            return self

        iterations = epochs  # reference exposes both; we treat as epochs

        def negative_sample(self, n):
            self._kw["negative"] = int(n)
            if n > 0:
                self._kw["use_hierarchic_softmax"] = False
            return self

        negativeSample = negative_sample

        def use_hierarchic_softmax(self, flag=True):
            self._kw["use_hierarchic_softmax"] = bool(flag)
            return self

        useHierarchicSoftmax = use_hierarchic_softmax

        def sampling(self, v):
            self._kw["subsampling"] = float(v)
            return self

        def batch_size(self, n):
            self._kw["batch_size"] = int(n)
            return self

        batchSize = batch_size

        def seed(self, n):
            self._kw["seed"] = int(n)
            return self

        def device(self, dev):
            """Where the tables live and train: "cuda" (the default) or
            "cpu"."""
            self._kw["device"] = dev
            return self

        def iterate(self, iterator: SentenceIterator):
            self._iterator = iterator
            return self

        def tokenizer_factory(self, tf: TokenizerFactory):
            self._tokenizer = tf
            return self

        tokenizerFactory = tokenizer_factory

        def elements_learning_algorithm(self, name: str):
            self._cbow = str(name).lower().endswith("cbow")
            return self

        elementsLearningAlgorithm = elements_learning_algorithm

        def build(self) -> "Word2Vec":
            cls = CBOW if self._cbow else Word2Vec
            w = cls(**self._kw)
            w._iterator = self._iterator
            w._tokenizer = self._tokenizer
            return w

    @staticmethod
    def builder() -> "Word2Vec.Builder":
        return Word2Vec.Builder()

    def __init__(self, *,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 **kw):
        super().__init__(**kw)
        self._iterator: Optional[SentenceIterator] = None
        # constructor kwarg mirrors Builder.tokenizer_factory (e.g. a CJK
        # factory with a user dictionary) so the short form works too
        self._tokenizer: TokenizerFactory = (tokenizer_factory
                                             or DefaultTokenizerFactory())

    def _sentences(self) -> Iterable[List[str]]:
        for sentence in self._iterator:
            yield self._tokenizer.create(sentence).get_tokens()

    def fit(self, sentences=None):
        """Train (reference ``fit()``). ``sentences``: optional list of raw
        sentences (else the Builder's ``iterate`` source)."""
        if sentences is not None:
            self._iterator = CollectionSentenceIterator(sentences)
        if self._iterator is None:
            raise ValueError("No sentence source: call .iterate(...) on the "
                             "builder or pass sentences to fit()")
        return super().fit(lambda: self._sentences())

    def fit_tokenized(self, token_sequences):
        """Train on pre-tokenized sequences against the existing vocab (the
        per-partition step of distributed training, reference
        ``FirstIterationFunction``)."""
        return SequenceVectors.fit(self, token_sequences)


class CBOW(Word2Vec):
    """Continuous bag-of-words: the averaged context predicts the center
    (reference ``CBOW.java``). Implemented by flipping the (row, target) pair
    orientation: context rows are updated against the center word's
    objective."""

    def _orient_pairs(self, centers, contexts):
        return contexts, centers  # row updated: context; objective: center


class ParagraphVectors(Word2Vec):
    """doc2vec (reference ``ParagraphVectors.java``, 1461 LoC): label (doc)
    vectors trained alongside word vectors. DBOW: doc vector predicts words
    in the doc (skip-gram with the doc as center). DM: doc vector joins the
    averaged context (approximated here by interleaving doc- and word-pair
    updates, the reference's DM-mean variant)."""

    def __init__(self, dm: bool = False, **kw):
        super().__init__(**kw)
        self.dm = dm
        self.labels: List[str] = []

    class Builder(Word2Vec.Builder):
        def __init__(self):
            super().__init__()
            self._dm = False

        def sequence_learning_algorithm(self, name: str):
            self._dm = str(name).lower().endswith("dm")
            return self

        sequenceLearningAlgorithm = sequence_learning_algorithm

        def build(self) -> "ParagraphVectors":
            p = ParagraphVectors(dm=self._dm, **self._kw)
            p._iterator = self._iterator
            p._tokenizer = self._tokenizer
            return p

    @staticmethod
    def builder() -> "ParagraphVectors.Builder":
        return ParagraphVectors.Builder()

    def fit_labelled(self, documents):
        """``documents``: iterable of (label, text). Labels become vocab
        entries (prefixed) trained with DBOW/DM."""
        docs = [(label, text) for label, text in documents]
        self.labels = [l for l, _ in docs]

        def provider():
            for label, text in docs:
                tokens = self._tokenizer.create(text).get_tokens()
                yield [self._label_token(label)] + tokens

        return super(Word2Vec, self).fit(provider)

    fitLabelled = fit_labelled

    @staticmethod
    def _label_token(label: str) -> str:
        return f"LBL::{label}"

    def _sequence_pairs(self, idxs, rng):
        """DBOW: the doc (label) vector predicts EVERY word of its document
        (reference ``DBOW.java`` samples the full document, not just the
        opening window); word-word skip-gram pairs run over the rest."""
        if idxs and self.vocab.word_at(idxs[0]).word.startswith("LBL::"):
            label, words = idxs[0], idxs[1:]
            for w in words:
                yield label, w
                if self.dm:  # DM: word rows also update against the doc
                    yield w, label
            yield from super()._sequence_pairs(words, rng)
        else:
            yield from super()._sequence_pairs(idxs, rng)

    def _sequence_pairs_arrays(self, idxs, rng):
        """Vectorized doc2vec pair generation (same semantics as
        ``_sequence_pairs``): the base class's fast array path is bypassed
        whenever ``_sequence_pairs`` is overridden, which left PV on the
        per-pair Python generator — the exact host bottleneck the
        vectorization removed for Word2Vec."""
        if not (idxs and self.vocab.word_at(idxs[0]).word.startswith("LBL::")):
            c, t = self._window_pairs_arrays(idxs, rng)
            return self._orient_pairs(c, t)
        label, words = idxs[0], np.asarray(idxs[1:], np.int32)
        if words.size == 0:
            empty = np.empty(0, np.int32)
            return empty, empty
        lbl = np.full(words.size, label, np.int32)
        # doc→word (DBOW) [+ word→doc for DM], then word-word skip-gram
        # pairs over the rest via the raw vectorized window path
        cs = [lbl] + ([words] if self.dm else [])
        ts = [words] + ([lbl] if self.dm else [])
        wc, wt = self._window_pairs_arrays(list(words), rng)
        c = np.concatenate(cs + [wc])
        t = np.concatenate(ts + [wt])
        return self._orient_pairs(c, t)

    # ------------------------------------------------------------- doc query
    def doc_vector(self, label: str):
        return self.word_vector(self._label_token(label))

    @staticmethod
    def _cosine(v, d) -> float:
        denom = max(np.linalg.norm(v) * np.linalg.norm(d), 1e-9)
        return float(v @ d / denom)

    def similarity_to_label(self, text: str, label: str) -> float:
        """Cosine between an unseen text's inferred vector and a doc vector
        (reference ``predict``/``similarityToLabel``)."""
        v = self.infer_vector(text)
        d = self.doc_vector(label)
        if v is None or d is None:
            return float("nan")
        return self._cosine(v, d)

    similarityToLabel = similarity_to_label

    def _rows(self, tokens) -> np.ndarray:
        """The vectors of the known ``tokens``, gathered on the device and
        copied to the host in one transfer: [n, d]."""
        idx = [i for i in (self.vocab.index_of(t) for t in tokens) if i >= 0]
        if not idx:
            return np.empty((0, self.vector_length), np.float32)
        syn0 = self.lookup_table.syn0
        return syn0.index_select(0, torch.tensor(idx, device=syn0.device)).cpu().numpy()

    def infer_vector(self, text: str) -> Optional[np.ndarray]:
        """Mean of known word vectors (fast inference; the reference offers
        gradient-based inference, same neighborhood for mean-style DM)."""
        vecs = self._rows(self._tokenizer.create(text).get_tokens())
        if not len(vecs):
            return None
        return np.mean(vecs, axis=0)

    inferVector = infer_vector

    def predict(self, text: str) -> Optional[str]:
        """Nearest doc label for a text (reference ``predict``): the text's
        vector is inferred once and the labels' rows come over in one copy;
        a label that labels several documents is one candidate. NaN
        similarities are dropped, and None comes back when none is left."""
        v = self.infer_vector(text)
        labels = [l for l in dict.fromkeys(self.labels) if self.has_word(self._label_token(l))]
        if v is None or not labels:
            return None
        rows = self._rows([self._label_token(l) for l in labels])
        sims = [(s, l) for s, l in ((self._cosine(v, d), l) for l, d in zip(labels, rows))
                if not np.isnan(s)]
        return max(sims)[1] if sims else None
