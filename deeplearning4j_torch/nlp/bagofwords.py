"""Bag-of-words / TF-IDF text vectorizers and the inverted index.

Counterpart of ``deeplearning4j_tpu/nlp/bagofwords.py`` (reference
``bagofwords/vectorizer/{BagOfWordsVectorizer,TfidfVectorizer}.java`` and
``text/invertedindex``), with the reference's formulas:

 - tf(word, doc)  = count / documentLength              (``MathUtils.tf``)
 - idf(word)      = log10(totalDocs / docAppearedIn)    (``MathUtils.idf``;
   0 when the corpus is empty)
 - tfidf          = tf * idf                            (``MathUtils.tfidf``)

``transform`` returns a dense [1, vocab] row like the reference's
``transform(List<String> tokens)``; ``vectorize(text, label)`` pairs it
with a one-hot label row as the port's ``DataSet``. Host code on the
tokenizer pipeline of ``nlp/text.py``.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .text import DefaultTokenizerFactory, TokenizerFactory
from ..datasets.dataset import DataSet

__all__ = ["InvertedIndex", "BagOfWordsVectorizer", "TfidfVectorizer"]


class InvertedIndex:
    """word → sorted list of document ids (reference ``text/invertedindex``:
    the lookup behind ``docAppearedIn``)."""

    def __init__(self):
        self._postings: Dict[str, List[int]] = defaultdict(list)
        self.num_docs = 0

    def add_document(self, doc_id: int, tokens: Iterable[str]):
        for tok in set(tokens):
            self._postings[tok].append(doc_id)
        self.num_docs = max(self.num_docs, doc_id + 1)

    addDocument = add_document

    def documents(self, word: str) -> List[int]:
        return list(self._postings.get(word, ()))

    def doc_appeared_in(self, word: str) -> int:
        """Number of documents containing ``word`` (reference
        ``vocabCache.docAppearedIn``)."""
        return len(self._postings.get(word, ()))

    docAppearedIn = doc_appeared_in

    def query(self, *words: str) -> List[int]:
        """Documents containing ALL the words (postings intersection)."""
        if not words:
            return []
        sets = [set(self._postings.get(w, ())) for w in words]
        out = set.intersection(*sets) if sets else set()
        return sorted(out)


class _BaseTextVectorizer:
    """Shared fit machinery (reference ``BaseTextVectorizer``): vocab from
    min-frequency-filtered corpus counts + the inverted index for document
    frequencies."""

    class Builder:
        def __init__(self):
            self._kw = {}
            self._tokenizer = DefaultTokenizerFactory()
            self._stop = ()

        def set_tokenizer_factory(self, tf: TokenizerFactory):
            self._tokenizer = tf
            return self

        setTokenizerFactory = set_tokenizer_factory

        def set_min_word_frequency(self, n: int):
            self._kw["min_word_frequency"] = int(n)
            return self

        setMinWordFrequency = set_min_word_frequency

        def set_stop_words(self, words):
            self._stop = tuple(words)
            return self

        setStopWords = set_stop_words

        def build(self):
            v = self._cls(**self._kw)  # set by subclass Builder
            v.tokenizer_factory = self._tokenizer
            v.stop_words = set(self._stop)
            return v

    def __init__(self, min_word_frequency: int = 1):
        self.min_word_frequency = int(min_word_frequency)
        self.tokenizer_factory: TokenizerFactory = DefaultTokenizerFactory()
        self.stop_words = set()
        self.vocab: List[str] = []
        self._vocab_index: Dict[str, int] = {}
        self.index = InvertedIndex()
        self.labels: List[str] = []

    # ------------------------------------------------------------------ fit
    def _tokens(self, text: str) -> List[str]:
        toks = self.tokenizer_factory.create(text).get_tokens()
        return [t for t in toks if t and t not in self.stop_words]

    def fit(self, documents: Sequence[str],
            labels: Optional[Sequence[str]] = None):
        """Build vocab + inverted index over the corpus (reference
        ``BaseTextVectorizer.buildVocab``)."""
        counts: Counter = Counter()
        tokenized = []
        for doc_id, text in enumerate(documents):
            toks = self._tokens(text)
            tokenized.append(toks)
            counts.update(toks)
            self.index.add_document(doc_id, toks)
        self.vocab = sorted(w for w, c in counts.items()
                            if c >= self.min_word_frequency)
        self._vocab_index = {w: i for i, w in enumerate(self.vocab)}
        if labels is not None:
            self.labels = sorted(set(labels))
        return self

    fitTransform = None  # defined below per subclass

    def num_words(self) -> int:
        return len(self.vocab)

    def index_of(self, word: str) -> int:
        return self._vocab_index.get(word, -1)

    # ------------------------------------------------------------ transform
    def _weight(self, word: str, count: int, doc_len: int) -> float:
        raise NotImplementedError

    def transform(self, text) -> np.ndarray:
        """[1, vocab] weight row (reference ``transform``)."""
        toks = self._tokens(text) if isinstance(text, str) else list(text)
        counts = Counter(toks)
        row = np.zeros((1, len(self.vocab)), np.float32)
        for word, count in counts.items():
            idx = self.index_of(word)
            if idx >= 0:
                row[0, idx] = self._weight(word, count, len(toks))
        return row

    def vectorize(self, text: str, label: str) -> DataSet:
        """(weights row, one-hot label) DataSet (reference ``vectorize`` :62)."""
        features = self.transform(text)
        onehot = np.zeros((1, max(len(self.labels), 1)), np.float32)
        if label in self.labels:
            onehot[0, self.labels.index(label)] = 1.0
        return DataSet(features, onehot)


class BagOfWordsVectorizer(_BaseTextVectorizer):
    """Raw word-count weights (reference ``BagOfWordsVectorizer.java``)."""

    class Builder(_BaseTextVectorizer.Builder):
        _cls = None  # bound after class creation

    def _weight(self, word: str, count: int, doc_len: int) -> float:
        return float(count)


class TfidfVectorizer(_BaseTextVectorizer):
    """tf·idf weights (reference ``TfidfVectorizer.java:105-139``)."""

    class Builder(_BaseTextVectorizer.Builder):
        _cls = None

    def tf_for_word(self, count: int, doc_len: int) -> float:
        return count / doc_len if doc_len else 0.0

    def idf_for_word(self, word: str) -> float:
        total = self.index.num_docs
        df = self.index.doc_appeared_in(word)
        if total == 0 or df == 0:
            return 0.0
        return math.log10(total / df)

    def tfidf_word(self, word: str, count: int, doc_len: int) -> float:
        return self.tf_for_word(count, doc_len) * self.idf_for_word(word)

    tfidfWord = tfidf_word

    def _weight(self, word: str, count: int, doc_len: int) -> float:
        return self.tfidf_word(word, count, doc_len)


BagOfWordsVectorizer.Builder._cls = BagOfWordsVectorizer
TfidfVectorizer.Builder._cls = TfidfVectorizer
