"""Vocabulary: SequenceElement/VocabWord, VocabCache, Huffman coding.

Counterpart of ``deeplearning4j_tpu/nlp/vocab.py`` (reference
``models/word2vec/wordstore/``, ``SequenceElement`` and
``models/word2vec/Huffman.java``): word -> index with frequency counting
and min-frequency filtering, and the Huffman tree that gives each word its
hierarchical-softmax (codes, points). Host Python; the indices, codes and
points equal the JAX package's for the same corpus, since the
hierarchical-softmax step gathers by them.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence


@dataclass
class VocabWord:
    """Reference ``VocabWord`` (a SequenceElement): word, frequency, HS codes."""
    word: str
    frequency: float = 1.0
    index: int = -1
    codes: List[int] = field(default_factory=list)    # Huffman code bits
    points: List[int] = field(default_factory=list)   # inner-node indices

    def increment(self, by: float = 1.0):
        self.frequency += by


SequenceElement = VocabWord  # reference naming alias


class VocabCache:
    """Reference ``AbstractCache``: word store with counts + index."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._index: List[VocabWord] = []
        self.total_word_count = 0.0

    def add_token(self, word: str, by: float = 1.0):
        if word in self._words:
            self._words[word].increment(by)
        else:
            self._words[word] = VocabWord(word, by)
        self.total_word_count += by

    addToken = add_token

    def finish(self, min_word_frequency: int = 1):
        """Drop rare words, assign indices by descending frequency (reference
        vocab constructor behavior)."""
        kept = [w for w in self._words.values()
                if w.frequency >= min_word_frequency]
        kept.sort(key=lambda w: (-w.frequency, w.word))
        self._index = kept
        self._words = {w.word: w for w in kept}
        for i, w in enumerate(kept):
            w.index = i
        return self

    def contains_word(self, word: str) -> bool:
        return word in self._words

    containsWord = contains_word

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def word_at(self, index: int) -> VocabWord:
        return self._index[index]

    wordFor = word_for

    def index_of(self, word: str) -> int:
        w = self._words.get(word)
        return -1 if w is None else w.index

    indexOf = index_of

    def word_frequency(self, word: str) -> float:
        w = self._words.get(word)
        return 0.0 if w is None else w.frequency

    wordFrequency = word_frequency

    def num_words(self) -> int:
        return len(self._index)

    numWords = num_words

    def words(self) -> List[str]:
        return [w.word for w in self._index]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._index)

    vocabWords = vocab_words


class Huffman:
    """Huffman tree over vocab frequencies → (codes, points) per word
    (reference ``models/word2vec/Huffman.java``). ``points`` index the
    hierarchical-softmax inner-node weight rows."""

    def __init__(self, words: Sequence[VocabWord]):
        self.words = list(words)

    def build(self):
        n = len(self.words)
        if n == 0:
            return
        if n == 1:
            self.words[0].codes = [0]
            self.words[0].points = [0]
            return
        # heap items: (freq, tiebreak, node_id); leaves are 0..n-1, inner
        # nodes n..2n-2
        heap = [(w.frequency, i, i) for i, w in enumerate(self.words)]
        heapq.heapify(heap)
        parent = {}
        bit = {}
        next_id = n
        while len(heap) > 1:
            f1, _, a = heapq.heappop(heap)
            f2, _, b = heapq.heappop(heap)
            parent[a] = next_id
            parent[b] = next_id
            bit[a] = 0
            bit[b] = 1
            heapq.heappush(heap, (f1 + f2, next_id, next_id))
            next_id += 1
        root = heap[0][2]
        for i, w in enumerate(self.words):
            codes, points = [], []
            node = i
            while node != root:
                codes.append(bit[node])
                node = parent[node]
                points.append(node - n)  # inner-node row index
            codes.reverse()
            points.reverse()
            w.codes = codes
            w.points = points
        return self


def build_vocab(sequences: Iterable[Sequence[str]],
                min_word_frequency: int = 1,
                build_huffman: bool = True) -> VocabCache:
    """Count tokens over sequences → finished VocabCache (+Huffman codes)."""
    cache = VocabCache()
    for seq in sequences:
        for tok in seq:
            cache.add_token(tok)
    cache.finish(min_word_frequency)
    if build_huffman:
        Huffman(cache.vocab_words()).build()
    return cache
