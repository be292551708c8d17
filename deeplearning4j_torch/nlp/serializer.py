"""Word-vector serialization: the word2vec text and binary formats.

Counterpart of ``deeplearning4j_tpu/nlp/serializer.py`` (reference
``models/embeddings/loader/WordVectorSerializer.java``): the text format
("word v1 v2 ...", with or without the count header) and the word2vec C
binary format of the GoogleNews vectors. Host code over ``word_vector``
(numpy rows), so a file written by either package reads in the other.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .vocab import VocabCache

__all__ = ["WordVectorSerializer", "StaticWordVectors"]


class WordVectorSerializer:
    # ------------------------------------------------------------------ text
    @staticmethod
    def write_word_vectors(model, path: str, include_header: bool = True):
        """word2vec text format; ``model`` is anything with vocab + syn0
        access (SequenceVectors family or Glove)."""
        vocab = model.vocab
        with open(path, "w", encoding="utf-8") as f:
            if include_header:
                v0 = model.word_vector(vocab.word_at(0).word)
                f.write(f"{vocab.num_words()} {len(v0)}\n")
            for w in vocab.vocab_words():
                vec = model.word_vector(w.word)
                f.write(w.word + " " + " ".join(f"{x:.6f}" for x in vec) + "\n")
        return path

    writeWordVectors = write_word_vectors

    @staticmethod
    def read_word_vectors(path: str) -> "StaticWordVectors":
        """Load text format (with or without the count header)."""
        words, vecs = [], []
        with open(path, encoding="utf-8") as f:
            first = f.readline().rstrip("\n")
            parts = first.split(" ")
            if len(parts) == 2 and all(p.isdigit() for p in parts):
                pass  # header line
            elif parts:
                words.append(parts[0])
                vecs.append([float(x) for x in parts[1:]])
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                vecs.append([float(x) for x in parts[1:]])
        return StaticWordVectors(words, np.asarray(vecs, np.float32))

    readWordVectors = read_word_vectors
    loadTxtVectors = read_word_vectors

    # ---------------------------------------------------------------- binary
    @staticmethod
    def write_binary(model, path: str):
        """word2vec C binary format (GoogleNews layout)."""
        vocab = model.vocab
        v0 = model.word_vector(vocab.word_at(0).word)
        with open(path, "wb") as f:
            f.write(f"{vocab.num_words()} {len(v0)}\n".encode("utf-8"))
            for w in vocab.vocab_words():
                vec = np.asarray(model.word_vector(w.word), np.float32)
                f.write(w.word.encode("utf-8") + b" ")
                f.write(vec.tobytes())
                f.write(b"\n")
        return path

    @staticmethod
    def read_binary(path: str) -> "StaticWordVectors":
        """Read the word2vec C binary format (also loads GoogleNews files)."""
        words, vecs = [], []
        with open(path, "rb") as f:
            header = f.readline().decode("utf-8").strip().split()
            n, d = int(header[0]), int(header[1])
            for _ in range(n):
                word = b""
                while True:
                    ch = f.read(1)
                    if ch in (b" ", b""):
                        break
                    word += ch
                vec = np.frombuffer(f.read(4 * d), np.float32)
                nl = f.peek(1)[:1] if hasattr(f, "peek") else b""
                if nl == b"\n":
                    f.read(1)
                words.append(word.decode("utf-8"))
                vecs.append(vec)
        return StaticWordVectors(words, np.stack(vecs))

    readBinary = read_binary
    loadGoogleModel = read_binary


class StaticWordVectors:
    """Read-only word vectors (reference ``WordVectors`` lookup view)."""

    def __init__(self, words, syn0: np.ndarray):
        self._index = {w: i for i, w in enumerate(words)}
        self.words = list(words)
        self.syn0 = syn0
        self.vocab = self._make_vocab(words)

    def _make_vocab(self, words) -> VocabCache:
        cache = VocabCache()
        for w in words:
            cache.add_token(w)
        cache.finish(1)
        # preserve file order (finish() sorts by frequency, all equal → word
        # order; re-map indices to file order)
        cache._index = [cache._words[w] for w in words]
        for i, vw in enumerate(cache._index):
            vw.index = i
        return cache

    def word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self._index.get(word)
        return None if i is None else self.syn0[i]

    getWordVector = word_vector

    def has_word(self, word: str) -> bool:
        return word in self._index

    hasWord = has_word

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.word_vector(a), self.word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = max(np.linalg.norm(va) * np.linalg.norm(vb), 1e-9)
        return float(va @ vb / denom)

    def words_nearest(self, word: str, n: int = 10):
        v = self.word_vector(word)
        if v is None:
            return []
        norms = (np.linalg.norm(self.syn0, axis=1)
                 * max(np.linalg.norm(v), 1e-9))
        sims = self.syn0 @ v / np.maximum(norms, 1e-9)
        order = np.argsort(-sims)
        return [self.words[i] for i in order if self.words[i] != word][:n]

    wordsNearest = words_nearest
