"""Text pipeline: sentence iterators, tokenizers, preprocessors.

Counterpart of ``deeplearning4j_tpu/nlp/text.py`` (reference
``deeplearning4j-nlp/.../text/``): ``SentenceIterator`` implementations
(BasicLineIterator, CollectionSentenceIterator), ``TokenizerFactory``/
``Tokenizer`` (DefaultTokenizerFactory: whitespace, an optional
preprocessor), ``NGramTokenizerFactory``, ``TokenPreProcess``
(CommonPreprocessor) and ``StopWords``. Host Python, the same tokens as the
JAX package's. The CJK and UIMA factories are in ``nlp/lang.py``; the
factory seam accepts any ``TokenizerFactory``.
"""
from __future__ import annotations

import re
from typing import Iterable, Iterator, List, Optional


# ------------------------------------------------------------- preprocessors
class TokenPreProcess:
    def pre_process(self, token: str) -> str:
        raise NotImplementedError

    preProcess = pre_process

    def __call__(self, token: str) -> str:
        return self.pre_process(token)


class CommonPreprocessor(TokenPreProcess):
    """Reference ``text/tokenization/tokenizer/preprocessor/CommonPreprocessor``:
    lowercase + strip punctuation/digits."""

    _PAT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PAT.sub("", token).lower()


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


# ----------------------------------------------------------------- tokenizer
class Tokenizer:
    def __init__(self, tokens: List[str]):
        self._tokens = tokens
        self._pos = 0

    def has_more_tokens(self) -> bool:
        return self._pos < len(self._tokens)

    hasMoreTokens = has_more_tokens

    def next_token(self) -> str:
        t = self._tokens[self._pos]
        self._pos += 1
        return t

    nextToken = next_token

    def get_tokens(self) -> List[str]:
        return list(self._tokens)

    getTokens = get_tokens

    def count_tokens(self) -> int:
        return len(self._tokens)

    countTokens = count_tokens


class TokenizerFactory:
    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre
        return self

    setTokenPreProcessor = set_token_pre_processor

    def _finish(self, tokens: List[str]) -> Tokenizer:
        """Apply the configured preprocessor and drop emptied tokens — the
        shared tail of every factory's ``create``."""
        pre = getattr(self, "_pre", None)
        if pre is not None:
            tokens = [pre(t) for t in tokens]
        return Tokenizer([t for t in tokens if t])


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenization + optional preprocessor (reference
    ``DefaultTokenizerFactory``)."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def create(self, text: str) -> Tokenizer:
        return self._finish(text.split())


class NGramTokenizerFactory(TokenizerFactory):
    """Reference ``NGramTokenizerFactory``: emits n-grams joined by space."""

    def __init__(self, base: TokenizerFactory, min_n: int, max_n: int):
        self._base = base
        self._min = min_n
        self._max = max_n
        self._pre = None

    def create(self, text: str) -> Tokenizer:
        tokens = self._base.create(text).get_tokens()
        out = []
        for n in range(self._min, self._max + 1):
            for i in range(len(tokens) - n + 1):
                out.append(" ".join(tokens[i:i + n]))
        return self._finish(out)


# ---------------------------------------------------------- sentence sources
class SentenceIterator:
    """Reference ``text/sentenceiterator/SentenceIterator``."""

    def __iter__(self) -> Iterator[str]:
        self.reset()
        return self

    def __next__(self) -> str:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str]):
        self._sentences = list(sentences)
        self._pos = 0

    def __next__(self):
        if self._pos >= len(self._sentences):
            raise StopIteration
        s = self._sentences[self._pos]
        self._pos += 1
        return s

    def reset(self):
        self._pos = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference ``BasicLineIterator``)."""

    def __init__(self, path: str):
        self._path = path
        self._fh = None

    def reset(self):
        if self._fh is not None:
            self._fh.close()
        self._fh = open(self._path, encoding="utf-8")

    def __next__(self):
        if self._fh is None:
            self.reset()
        line = self._fh.readline()
        while line == "\n":
            line = self._fh.readline()
        if not line:
            raise StopIteration
        return line.rstrip("\n")


class StopWords:
    """Reference bundled english stopwords list (abbreviated core set)."""

    WORDS = {"a", "an", "and", "are", "as", "at", "be", "but", "by", "for",
             "if", "in", "into", "is", "it", "no", "not", "of", "on", "or",
             "such", "that", "the", "their", "then", "there", "these", "they",
             "this", "to", "was", "will", "with"}

    @staticmethod
    def get_stop_words():
        return set(StopWords.WORDS)

    getStopWords = get_stop_words
