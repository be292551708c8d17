"""CJK and UIMA-style language modules for the text pipeline.

Counterpart of ``deeplearning4j_tpu/nlp/lang.py``, a host-Python copy with
the same tokens, tags and annotations (reference language modules
``deeplearning4j-nlp-chinese``, ``-japanese``, ``-korean`` and ``-uima``):

- ``Lexicon`` and the two segmenters (forward maximum matching, the
  dictionary-lattice Viterbi);
- ``ChineseTokenizerFactory``: forward maximum matching over a
  user-extendable lexicon with single-character fallback, Latin/digit runs
  kept whole;
- ``JapaneseTokenizerFactory``: lattice Viterbi with connection costs and
  character-class unknown words, or ``algorithm="script"`` (script runs);
- ``KoreanTokenizerFactory``: whitespace eojeol split, then the
  eojeol-internal morpheme lattice (stem/josa/eomi), or
  ``algorithm="simple"`` (longest josa strip);
- ``SentenceAnnotator``, ``TokenizerAnnotator``, ``PoStagger``,
  ``AnnotationPipeline`` and ``UimaTokenizerFactory``.

Every factory honours ``set_token_pre_processor`` like the other
``TokenizerFactory`` classes of ``nlp/text.py``, so it feeds Word2Vec,
ParagraphVectors and TF-IDF unchanged. No card work.
"""
from __future__ import annotations

import itertools
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .text import Tokenizer, TokenizerFactory, TokenPreProcess


# --------------------------------------------------------------- script tests
def _is_cjk(ch: str) -> bool:
    o = ord(ch)
    return (0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF
            or 0xF900 <= o <= 0xFAFF or 0x20000 <= o <= 0x2FA1F)


def _is_hiragana(ch: str) -> bool:
    return 0x3040 <= ord(ch) <= 0x309F


def _is_katakana(ch: str) -> bool:
    return 0x30A0 <= ord(ch) <= 0x30FF


def _is_hangul(ch: str) -> bool:
    o = ord(ch)
    return 0xAC00 <= o <= 0xD7A3 or 0x1100 <= o <= 0x11FF


def _script_class(ch: str) -> str:
    if _is_hiragana(ch):
        return "hira"
    if _is_katakana(ch):
        return "kata"
    if _is_cjk(ch):
        return "han"
    if _is_hangul(ch):
        return "hangul"
    if ch.isalnum():
        return "latin"
    if ch.isspace():
        return "space"
    return "punct"


def _script_runs(text: str) -> List[Tuple[str, str]]:
    """Split ``text`` into maximal same-script runs → [(run, class)]."""
    return [("".join(grp), cls)
            for cls, grp in itertools.groupby(text, key=_script_class)]


# ------------------------------------------------------------------- Chinese
#: Seed lexicon: common multi-character words so segmentation is useful out of
#: the box; extend per-corpus via ``ChineseTokenizerFactory(lexicon=...)``.
CHINESE_LEXICON = {
    "中国", "我们", "你们", "他们", "今天", "明天", "昨天", "时间", "工作",
    "学习", "深度", "深度学习", "机器", "机器学习", "神经", "网络",
    "神经网络", "数据", "模型", "训练", "语言", "自然", "自然语言",
    "处理", "计算", "计算机", "人工", "智能", "人工智能", "北京", "上海",
    "大学", "老师", "学生", "朋友", "喜欢", "可以", "没有", "什么",
    "知道", "现在", "因为", "所以", "如果", "但是", "已经", "开始",
}


def _iter_dict_lines(path: str, encoding: str = "utf-8"):
    """Shared dictionary-file line parser (jieba/ansj user-dict format):
    yields ``(word, freq, extra_columns)`` per non-blank non-``#`` line;
    commas normalize to spaces; freq defaults to 1 when the second column
    is missing/non-numeric. One parser for every load() so format fixes
    apply to all languages at once."""
    with open(path, encoding=encoding) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            freq = (int(parts[1]) if len(parts) > 1
                    and parts[1].isdigit() else 1)
            yield parts[0], freq, parts[2:]


class Lexicon:
    """Frequency dictionary + character trie for segmentation.

    The reference bundles ansj's double-array-trie dictionaries
    (``deeplearning4j-nlp-chinese/.../org/ansj/``); this is the same
    capability at real scale without the 3rd-party bundle: load
    user-supplied dictionary files (one ``word [frequency]`` per line —
    jieba/ansj user-dict format, ``#`` comments allowed) into a plain dict
    trie. Frequencies feed the bidirectional max-match ambiguity scoring."""

    _END = "\0"

    def __init__(self, words: Optional[Iterable[str]] = None):
        self._freq: Dict[str, int] = {}
        self._trie: Dict = {}
        self._total = 0          # running Σfreq (O(1) total_freq)
        self.max_len = 1
        if words:
            for w in words:
                self.add(w)

    def add(self, word: str, freq: int = 1):
        word = word.strip()
        if not word:
            return
        old = self._freq.get(word, 0)
        new = max(old, int(freq))
        self._freq[word] = new
        self._total += new - old
        self.max_len = max(self.max_len, len(word))
        node = self._trie
        for ch in word:
            node = node.setdefault(ch, {})
        node[self._END] = True

    def load(self, path: str, encoding: str = "utf-8") -> "Lexicon":
        """Merge a dictionary file: ``word``, ``word freq`` or ``word,freq``
        per line; blank lines and ``#`` comments skipped."""
        for word, freq, _extra in _iter_dict_lines(path, encoding):
            self.add(word, freq)
        return self

    @classmethod
    def from_file(cls, path: str, encoding: str = "utf-8") -> "Lexicon":
        return cls().load(path, encoding)

    def __contains__(self, word: str) -> bool:
        return word in self._freq

    def __len__(self) -> int:
        return len(self._freq)

    def freq(self, word: str) -> int:
        return self._freq.get(word, 0)

    def longest_prefix(self, text: str, start: int) -> int:
        """Length of the longest lexicon word starting at ``start`` (0 if
        none) — one trie walk, no per-length hashing."""
        lengths = self.match_lengths(text, start)
        return lengths[-1] if lengths else 0

    def longest_suffix(self, text: str, end: int) -> int:
        """Length of the longest lexicon word ENDING at ``end`` (exclusive).
        Bounded backward scan (len ≤ max_len) for backward max-match."""
        lo = max(0, end - self.max_len)
        for start in range(lo, end - 1):
            if text[start:end] in self._freq:
                return end - start
        return 0

    def match_lengths(self, text: str, start: int) -> List[int]:
        """ALL lexicon-word lengths starting at ``start`` (one trie walk) —
        the lattice edges for Viterbi segmentation."""
        node = self._trie
        out: List[int] = []
        i, n = start, len(text)
        while i < n:
            node = node.get(text[i])
            if node is None:
                break
            i += 1
            if self._END in node:
                out.append(i - start)
        return out

    def total_freq(self) -> int:
        return self._total


class _MaxMatchSegmenter:
    """Bidirectional maximum matching with ambiguity scoring over a
    :class:`Lexicon` (the dictionary strategy of ansj's DAT segmenter
    without the 3rd-party bundle).

    Forward AND backward max-match are both computed; when they disagree the
    segmentation with (1) fewer words, then (2) fewer single-character
    leftovers, then (3) higher summed log-frequency wins — the classic
    disambiguation triple. Example the forward-only pass gets wrong:
    研究生命起源 → FMM 研究生|命|起源 vs BMM 研究|生命|起源 (picked: fewer
    singletons)."""

    def __init__(self, lexicon: Iterable[str], bidirectional: bool = True):
        self.lexicon = (lexicon if isinstance(lexicon, Lexicon)
                        else Lexicon(lexicon))
        self.bidirectional = bidirectional

    def add(self, *words: str):
        for w in words:
            self.lexicon.add(w)

    def _forward(self, run: str) -> List[str]:
        out: List[str] = []
        i, n = 0, len(run)
        while i < n:
            L = self.lexicon.longest_prefix(run, i)
            if L > 1:
                out.append(run[i:i + L])
                i += L
            else:
                out.append(run[i])
                i += 1
        return out

    def _backward(self, run: str) -> List[str]:
        out: List[str] = []
        i = len(run)
        while i > 0:
            L = self.lexicon.longest_suffix(run, i)
            if L > 1:
                out.append(run[i - L:i])
                i -= L
            else:
                out.append(run[i - 1])
                i -= 1
        out.reverse()
        return out

    def _score(self, seg: List[str]):
        import math
        singles = sum(1 for w in seg if len(w) == 1)
        logfreq = sum(math.log1p(self.lexicon.freq(w)) for w in seg
                      if len(w) > 1)
        return (-len(seg), -singles, logfreq)

    def segment(self, run: str) -> List[str]:
        fwd = self._forward(run)
        if not self.bidirectional:
            return fwd
        bwd = self._backward(run)
        if fwd == bwd:
            return fwd
        return max(fwd, bwd, key=self._score)


class _UnigramSegmenter:
    """Unigram-LM lattice (word-DAG) segmentation with Viterbi DP — the
    algorithm class behind the reference's bundled ansj/jieba-style
    segmenters (`deeplearning4j-nlp-chinese/.../org/ansj/` builds a word
    lattice over a double-array trie and picks the best-scoring path; same
    capability here over the plain :class:`Lexicon` trie).

    Every lexicon word starting at each position is a lattice edge scored
    ``log((freq+1)/total)``; unknown single characters get the floor score.
    ``route[i] = max_j logp(run[i:j]) + route[j]`` solved right-to-left in
    O(n · max_word_len). Unlike max-match (greedy, longest-first), the DP
    picks the globally most probable path, so frequency evidence can
    override a longer dictionary match: 北京大学生前来应聘 segments
    北京|大学生|前来|应聘 when 大学生 outweighs 北京大学, where FMM is
    stuck with 北京大学|生前|来|应聘."""

    def __init__(self, lexicon: Iterable[str]):
        self.lexicon = (lexicon if isinstance(lexicon, Lexicon)
                        else Lexicon(lexicon))

    def add(self, *words: str):
        for w in words:
            self.lexicon.add(w)

    def segment(self, run: str) -> List[str]:
        import math
        lex = self.lexicon
        n = len(run)
        if n == 0:
            return []
        logtot = math.log(lex.total_freq() + len(lex) + 1)
        floor = -logtot  # unknown char: count ~1 in the corpus

        def logp(w: str) -> float:
            f = lex.freq(w)
            return math.log(f + 1) - logtot if f > 0 else floor

        route: List[Tuple[float, int]] = [(0.0, n)] * (n + 1)
        for i in range(n - 1, -1, -1):
            best = (logp(run[i]) + route[i + 1][0], i + 1)
            for L in lex.match_lengths(run, i):
                if L == 1:
                    continue  # already covered by the char fallback
                cand = logp(run[i:i + L]) + route[i + L][0]
                if cand > best[0]:
                    best = (cand, i + L)
            route[i] = best
        out: List[str] = []
        i = 0
        while i < n:
            j = route[i][1]
            out.append(run[i:j])
            i = j
        return out


class ChineseTokenizerFactory(TokenizerFactory):
    """Dictionary forward-maximum-matching Chinese tokenizer (reference
    ``deeplearning4j-nlp-chinese/.../tokenization/tokenizerFactory/
    ChineseTokenizerFactory.java`` over the bundled ansj segmenter)."""

    def __init__(self, lexicon: Optional[Iterable[str]] = None,
                 dict_path: Optional[str] = None, bidirectional: bool = True,
                 algorithm: str = "bimm"):
        """``lexicon``: iterable of words or a :class:`Lexicon`;
        ``dict_path``: user dictionary file (``word [freq]`` per line,
        jieba/ansj format) merged on top; ``algorithm``: ``"unigram"`` for
        lattice-Viterbi unigram-LM segmentation (the ansj/jieba algorithm
        class — best when the dictionary carries real frequencies),
        ``"bimm"`` (default) for FMM+BMM with ambiguity scoring, ``"fmm"``
        for plain forward max-match. ``bidirectional=False`` is a
        back-compat alias for ``algorithm="fmm"``."""
        self._pre: Optional[TokenPreProcess] = None
        lex = lexicon if lexicon is not None else CHINESE_LEXICON
        if algorithm not in ("unigram", "bimm", "fmm"):
            raise ValueError(f"unknown segmentation algorithm {algorithm!r}"
                             " (expected 'unigram', 'bimm' or 'fmm')")
        if algorithm == "unigram":
            self._seg = _UnigramSegmenter(lex)
        else:
            self._seg = _MaxMatchSegmenter(
                lex, bidirectional=bidirectional and algorithm == "bimm")
        if dict_path is not None:
            self._seg.lexicon.load(dict_path)

    def add_words(self, *words: str):
        """Extend the lexicon (ansj's user-dictionary seam)."""
        self._seg.add(*words)
        return self

    addWords = add_words

    def load_dictionary(self, path: str):
        """Merge a user dictionary file at runtime (ansj's
        ``UserDefineLibrary`` seam)."""
        self._seg.lexicon.load(path)
        return self

    loadDictionary = load_dictionary

    def create(self, text: str) -> Tokenizer:
        tokens: List[str] = []
        for run, cls in _script_runs(text):
            if cls == "han":
                tokens.extend(self._seg.segment(run))
            elif cls in ("latin", "kata", "hira", "hangul"):
                tokens.append(run)
            # space/punct dropped
        return self._finish(tokens)


# ------------------------------------------------------------------ Japanese
#: Common trailing hiragana particles/copulas split off kanji+hiragana runs
#: (Kuromoji segments these as separate morphemes).
JAPANESE_PARTICLES = (
    "でした", "ました", "です", "ます", "から", "まで", "には", "とは",
    "は", "が", "を", "に", "へ", "と", "で", "も", "の", "や", "ね", "よ",
    "か", "な",
)

#: Auxiliary verbs / copulas (connection category "a": attach after content).
JAPANESE_AUX = (
    "です", "ます", "でした", "ました", "だ", "である", "ない", "たい",
    "れる", "られる", "せる", "させる",
)

#: Seed lexicon for common multi-kanji words (legacy max-match seed).
JAPANESE_LEXICON = {
    "日本", "東京", "大学", "学生", "先生", "機械", "学習", "機械学習",
    "言語", "自然", "自然言語", "処理", "深層", "深層学習", "好き",
}

#: Seed dictionary for the LATTICE segmenter: (word, freq, category).
#: category: "c" content, "p" particle, "a" auxiliary/copula. Frequencies
#: are order-of-magnitude corpus ranks (particles ≫ common nouns ≫ rest) —
#: they set edge costs the way IPADIC word costs do for Kuromoji. Extend
#: per-corpus via ``dict_path`` / ``add_words``.
JAPANESE_SEED_ENTRIES: Tuple[Tuple[str, int, str], ...] = (
    # particles (the highest-frequency tokens in any Japanese corpus)
    ("の", 8000, "p"), ("は", 6000, "p"), ("が", 5500, "p"),
    ("を", 5000, "p"), ("に", 5000, "p"), ("と", 4000, "p"),
    ("で", 3800, "p"), ("も", 3500, "p"), ("へ", 1200, "p"),
    ("や", 1000, "p"), ("から", 1500, "p"), ("まで", 900, "p"),
    ("には", 800, "p"), ("とは", 500, "p"), ("ね", 600, "p"),
    ("よ", 600, "p"), ("か", 1200, "p"), ("な", 900, "p"),
    # auxiliaries / copulas
    ("です", 3000, "a"), ("ます", 2500, "a"), ("でした", 900, "a"),
    ("ました", 900, "a"), ("だ", 1500, "a"), ("である", 500, "a"),
    ("ない", 1500, "a"), ("たい", 500, "a"),
    # pronouns & everyday nouns
    ("私", 2000, "c"), ("あなた", 500, "c"), ("これ", 900, "c"),
    ("それ", 900, "c"), ("うち", 700, "c"), ("こと", 1500, "c"),
    ("もの", 1200, "c"), ("とき", 700, "c"), ("ところ", 600, "c"),
    ("今日", 800, "c"), ("明日", 500, "c"), ("昨日", 500, "c"),
    # common fruit/food (the classic lattice demo words — real IPADIC
    # entries, not test rigging: すもも = plum, もも = peach)
    ("すもも", 50, "c"), ("もも", 120, "c"), ("りんご", 150, "c"),
    # greetings / frequent hiragana content words (must beat particle
    # shredding: ありがとう vs あり|が|とう)
    ("ありがとう", 400, "c"), ("こんにちは", 300, "c"),
    ("さようなら", 150, "c"), ("おはよう", 200, "c"),
    # verbs/adjectives with okurigana (kanji+hira edges that cross script
    # boundaries — the case the script-run fallback cannot handle)
    ("好き", 600, "c"), ("食べる", 400, "c"), ("行く", 500, "c"),
    ("見る", 500, "c"), ("する", 1800, "c"), ("いる", 1500, "c"),
    ("ある", 1500, "c"), ("なる", 1000, "c"), ("言う", 600, "c"),
    ("思う", 600, "c"), ("大きい", 300, "c"), ("小さい", 250, "c"),
    ("新しい", 300, "c"),
    # domain nouns (mirror the Chinese seed)
    ("日本", 1000, "c"), ("東京", 700, "c"), ("大学", 600, "c"),
    ("学生", 500, "c"), ("先生", 500, "c"), ("機械", 300, "c"),
    ("学習", 350, "c"), ("機械学習", 200, "c"), ("言語", 300, "c"),
    ("自然", 300, "c"), ("自然言語", 150, "c"), ("処理", 300, "c"),
    ("深層", 100, "c"), ("深層学習", 120, "c"), ("計算", 300, "c"),
    ("研究", 400, "c"), ("時間", 500, "c"), ("問題", 500, "c"),
    ("世界", 500, "c"), ("仕事", 450, "c"),
)


class JapaneseLexicon(Lexicon):
    """:class:`Lexicon` + a connection category per word (``"c"`` content,
    ``"p"`` particle, ``"a"`` auxiliary). Dictionary files may carry the
    category as a third column (``word freq pos``); without one it is
    inferred from the particle/aux tables."""

    def __init__(self, entries: Optional[Iterable] = None):
        self._cat: Dict[str, str] = {}
        super().__init__()
        if entries:
            for e in entries:
                if isinstance(e, str):
                    self.add(e)
                else:
                    self.add(*e)

    def add(self, word: str, freq: int = 1, cat: Optional[str] = None):
        word = word.strip()
        if not word:
            return
        if cat is None:
            cat = self._cat.get(word) or (
                "p" if word in JAPANESE_PARTICLES
                else "a" if word in JAPANESE_AUX else "c")
        self._cat[word] = cat
        super().add(word, freq)

    def load(self, path: str, encoding: str = "utf-8") -> "JapaneseLexicon":
        """``word``, ``word freq`` or ``word freq pos`` per line (pos ∈
        c/p/a); ``#`` comments and blanks skipped."""
        for word, freq, extra in _iter_dict_lines(path, encoding):
            cat = extra[0] if extra and extra[0] in ("c", "p", "a") else None
            self.add(word, freq, cat)
        return self

    def category(self, word: str) -> str:
        return self._cat.get(word, "c")

    def categories(self, word: str) -> Tuple[str, ...]:
        """All lattice categories for a surface form (homographs get one
        edge per category; the base class tracks a single one)."""
        return (self.category(word),)


class _JapaneseLatticeSegmenter:
    """Dictionary-lattice Viterbi segmentation — the Kuromoji algorithm
    class (reference ``deeplearning4j-nlp-japanese/src/main/java/com/
    atilika/kuromoji/viterbi/ViterbiBuilder.java`` + ``ViterbiSearcher``:
    build a word lattice over the dictionary, add unknown-word edges by
    character class, pick the min-cost path under word + connection costs)
    without the 9k-LoC third-party bundle.

    Mechanics, mirrored structurally (not translated):

    - EDGES: every dictionary word starting at each position (one trie walk
      via :meth:`Lexicon.match_lengths` — the Chinese lattice machinery),
      with cost ``log(total) - log(freq+1)`` (unigram LM; the role of
      IPADIC word costs).
    - UNKNOWN EDGES: where the dictionary has no cover, candidates are
      generated by CHARACTER CLASS like Kuromoji's ``UnknownDictionary``:
      katakana and latin runs stay whole (loanwords, identifiers); kanji
      and hiragana get edges of every length up to the same-script run end
      (capped), costed ``UNK_BASE + UNK_PER_CHAR·len`` so any dictionary
      cover beats them.
    - CONNECTION COSTS: a small category matrix (content/particle/aux ×
      same, plus BOS/EOS) stands in for IPADIC's 1316² context-id matrix.
      It encodes what Japanese word order makes cheap — particle after
      content, content after particle — and penalizes particle-after-
      particle / content-after-content, which is exactly what
      disambiguates すもももももももものうち into
      すもも|も|もも|も|もも|の|うち (the alternating C-P-C-P… path) over
      equal-word-count rivals.
    - SEARCH: single left-to-right DP over (position, category) — Viterbi
      on the lattice, O(n · edges-per-position · categories²).
    """

    #: connection cost [prev][next] over categories c/p/a (+ B start/E end)
    _CONN = {
        "B": {"c": 0.0, "p": 3.0, "a": 3.0},
        "c": {"c": 1.0, "p": 0.0, "a": 0.0, "E": 0.0},
        "p": {"c": 0.0, "p": 2.0, "a": 1.5, "E": 0.5},
        "a": {"c": 0.5, "p": 0.5, "a": 1.0, "E": 0.0},
    }
    _UNK_BASE = 12.0
    _UNK_PER_CHAR = 2.0
    _UNK_MAX_LEN = 8          # cap unknown-edge fan-out per position
    _UNK_CAT = "c"            # category assigned to unknown edges

    #: subclasses (Korean) override these two to re-seed the machinery
    _LEX_CLS = None           # set below (JapaneseLexicon)
    _SEED: Tuple = ()

    def __init__(self, lexicon: Optional[Iterable] = None):
        # an instance of the language's lexicon class REPLACES the
        # dictionary (caller takes full control); any other iterable MERGES
        # into the seed entries — the lattice is useless without
        # particle/aux/frequency structure
        if isinstance(lexicon, self._LEX_CLS):
            self.lexicon = lexicon
        else:
            self.lexicon = self._LEX_CLS(self._SEED)
            if lexicon is not None:
                for w in lexicon:
                    self.lexicon.add(w) if isinstance(w, str) \
                        else self.lexicon.add(*w)

    def add(self, *words):
        for w in words:
            self.lexicon.add(w) if isinstance(w, str) \
                else self.lexicon.add(*w)

    def _edges(self, text: str, i: int, logtot: float,
               run_end: int) -> List[Tuple[int, float, str]]:
        """Outgoing lattice edges at position ``i`` → [(length, cost, cat)].
        Dictionary edges + character-class unknown edges (always generated:
        an out-of-vocabulary reading must be representable even where a
        dictionary word also starts). ``logtot`` and ``run_end`` (end of
        the same-script run containing ``i``) are hoisted to segment() —
        the lexicon cannot change mid-segmentation, and rescanning the run
        per position would make segmentation O(m²)."""
        import math
        lex = self.lexicon
        out: List[Tuple[int, float, str]] = []
        for L in lex.match_lengths(text, i):
            w = text[i:i + L]
            cost = logtot - math.log(lex.freq(w) + 1)
            for cat in lex.categories(w):
                out.append((L, cost, cat))
        cls = _script_class(text[i])
        R = run_end - i
        if cls in ("kata", "latin"):
            # loanwords / identifiers: the whole run, one edge
            out.append((R, self._UNK_BASE * 0.5 + self._UNK_PER_CHAR,
                        self._UNK_CAT))
        else:
            seen = {L for L, _, _ in out}
            for L in range(1, min(R, self._UNK_MAX_LEN) + 1):
                if L not in seen:
                    out.append((L, self._UNK_BASE + self._UNK_PER_CHAR * L,
                                self._UNK_CAT))
        return out

    def segment_with_categories(self, text: str) -> List[Tuple[str, str]]:
        """Best path as (morpheme, chosen-category) pairs — the category
        the VITERBI PATH selected, not the lexicon's primary reading
        (homographs like 가 = josa/verb differ per context)."""
        import math
        n = len(text)
        if n == 0:
            return []
        INF = float("inf")
        lex = self.lexicon
        logtot = math.log(lex.total_freq() + len(lex) + 1)
        # same-script run end per position, computed once (O(n))
        run_end = [0] * n
        pos = 0
        for run, _cls in _script_runs(text):
            end = pos + len(run)
            for j in range(pos, end):
                run_end[j] = end
            pos = end
        # best[i][cat] = (cost, back-pointer (prev_i, prev_cat, word))
        best: List[Dict[str, Tuple[float, Optional[Tuple]]]] = \
            [dict() for _ in range(n + 1)]
        best[0]["B"] = (0.0, None)
        for i in range(n):
            if not best[i]:
                continue
            for L, wcost, cat in self._edges(text, i, logtot, run_end[i]):
                j = i + L
                word = text[i:j]
                for pcat, (pcost, _) in best[i].items():
                    conn = self._CONN.get(pcat,
                                          self._CONN[self._UNK_CAT]).get(
                        cat, 1.0)
                    cand = pcost + conn + wcost
                    cur = best[j].get(cat, (INF, None))
                    if cand < cur[0]:
                        best[j][cat] = (cand, (i, pcat, word))
        # EOS connection picks the final category
        end_cat, end_cost = None, INF
        for cat, (cost, _) in best[n].items():
            total = cost + self._CONN.get(
                cat, self._CONN[self._UNK_CAT]).get("E", 0.0)
            if total < end_cost:
                end_cat, end_cost = cat, total
        out: List[Tuple[str, str]] = []
        i, cat = n, end_cat
        while i > 0:
            _, back = best[i][cat]
            pi, pcat, word = back
            out.append((word, cat))
            i, cat = pi, pcat
        out.reverse()
        return out

    def segment(self, text: str) -> List[str]:
        return [w for w, _ in self.segment_with_categories(text)]


_JapaneseLatticeSegmenter._LEX_CLS = JapaneseLexicon
_JapaneseLatticeSegmenter._SEED = JAPANESE_SEED_ENTRIES


class JapaneseTokenizerFactory(TokenizerFactory):
    """Japanese tokenizer behind the reference's ``TokenizerFactory`` seam
    (``deeplearning4j-nlp-japanese/.../JapaneseTokenizerFactory.java`` over
    bundled Kuromoji).

    ``algorithm="lattice"`` (default): dictionary-lattice Viterbi with
    connection costs and character-class unknown words — the Kuromoji
    algorithm class (see :class:`_JapaneseLatticeSegmenter`). Handles
    okurigana words crossing script boundaries (好き, 食べる) and classic
    ambiguities (すもももももももものうち).

    ``algorithm="script"``: the legacy script-run heuristic (kanji runs
    lexicon max-matched, ONE trailing particle peeled off hiragana runs) —
    kept as the dependency-free fallback and for callers pinned to the old
    behavior.

    ``lexicon`` semantics differ by mode: in ``lattice`` mode a plain
    iterable MERGES into the seed dictionary (the lattice needs particles,
    auxiliaries and frequencies to function — an unweighted word list alone
    would cripple it); pass a :class:`JapaneseLexicon` to take full control
    of the dictionary instead. In ``script`` mode it REPLACES the seed,
    as before."""

    def __init__(self, lexicon: Optional[Iterable] = None,
                 dict_path: Optional[str] = None,
                 bidirectional: Optional[bool] = None,
                 algorithm: str = "lattice"):
        self._pre: Optional[TokenPreProcess] = None
        if algorithm not in ("lattice", "script"):
            raise ValueError(f"unknown segmentation algorithm {algorithm!r}"
                             " (expected 'lattice' or 'script')")
        if bidirectional is not None and algorithm == "lattice":
            # a max-match knob makes no sense on the lattice; a caller
            # passing it is pinned to the old behavior — fail loudly
            # instead of silently segmenting differently
            raise ValueError(
                "bidirectional= only applies to algorithm='script' "
                "(max-match); the lattice default ignores it — pass "
                "algorithm='script' to keep the legacy behavior")
        self._algorithm = algorithm
        if algorithm == "lattice":
            self._lat = _JapaneseLatticeSegmenter(lexicon)
            if dict_path is not None:
                self._lat.lexicon.load(dict_path)
        else:
            self._seg = _MaxMatchSegmenter(lexicon if lexicon is not None
                                           else JAPANESE_LEXICON,
                                           bidirectional=bidirectional
                                           if bidirectional is not None
                                           else True)
            if dict_path is not None:
                self._seg.lexicon.load(dict_path)
        self._particles = sorted(JAPANESE_PARTICLES, key=len, reverse=True)

    def add_words(self, *words):
        """Extend the dictionary (Kuromoji user-dictionary seam). Entries
        are words or ``(word, freq[, cat])`` tuples; in ``script`` mode the
        category column is meaningless and ignored."""
        if self._algorithm == "lattice":
            self._lat.add(*words)
        else:
            for w in words:
                if isinstance(w, str):
                    self._seg.lexicon.add(w)
                else:
                    self._seg.lexicon.add(*w[:2])
        return self

    addWords = add_words

    def load_dictionary(self, path: str):
        """Merge a user dictionary file at runtime."""
        lex = (self._lat.lexicon if self._algorithm == "lattice"
               else self._seg.lexicon)
        lex.load(path)
        return self

    loadDictionary = load_dictionary

    def _split_hiragana(self, run: str) -> List[str]:
        """(script fallback) Peel ONE longest known particle off the END of
        the run. Splitting mid-word, or peeling repeatedly, would shred
        content words like ありがとう / もも whose characters double as
        particles."""
        for p in self._particles:
            if run.endswith(p) and run != p:
                return [run[:-len(p)], p]
        return [run]

    def create(self, text: str) -> Tokenizer:
        tokens: List[str] = []
        if self._algorithm == "lattice":
            # lattice over maximal Japanese-script spans (han/hira/kata mixed
            # — okurigana edges cross script boundaries); latin runs whole;
            # space/punct separate
            for is_ja, run in itertools.groupby(
                    text, key=lambda ch: _script_class(ch)
                    in ("han", "hira", "kata")):
                chunk = "".join(run)
                if is_ja:
                    tokens.extend(self._lat.segment(chunk))
                else:
                    for sub, scls in _script_runs(chunk):
                        if scls in ("latin", "hangul"):
                            tokens.append(sub)
            return self._finish(tokens)
        for run, cls in _script_runs(text):
            if cls == "han":
                tokens.extend(self._seg.segment(run))
            elif cls == "hira":
                tokens.extend(self._split_hiragana(run))
            elif cls in ("kata", "latin", "hangul"):
                tokens.append(run)
        return self._finish(tokens)


# -------------------------------------------------------------------- Korean
#: Common josa (case particles) stripped from eojeol tails — arirang's
#: observable stemming behavior for embedding pipelines.
KOREAN_JOSA = (
    "에서는", "에서", "에게", "으로", "로", "은", "는", "이", "가", "을",
    "를", "에", "와", "과", "도", "만", "의",
)

#: Seed dictionary for the Korean morpheme lattice: (morpheme, freq, cat).
#: Categories: "n" noun/pronoun stem, "v" verb/adjective stem, "j" josa
#: (case particle), "e" eomi (verbal ending, incl. tense infixes and the
#: common CONTRACTED portmanteau forms like 했/갔 — arirang handles these
#: through its own tables too), "x" affix. Frequencies are corpus-rank
#: order-of-magnitude, like the Japanese seed.
KOREAN_SEED_ENTRIES: Tuple[Tuple[str, int, str], ...] = (
    # josa — the highest-frequency bound morphemes
    ("이", 6000, "j"), ("가", 5500, "j"), ("은", 5500, "j"),
    ("는", 5500, "j"), ("을", 5000, "j"), ("를", 5000, "j"),
    ("에", 4500, "j"), ("에서", 2500, "j"), ("에서는", 600, "j"),
    ("에게", 900, "j"), ("으로", 1500, "j"), ("로", 1500, "j"),
    ("와", 1200, "j"), ("과", 1200, "j"), ("도", 1800, "j"),
    ("만", 1000, "j"), ("의", 3000, "j"), ("보다", 500, "j"),
    ("처럼", 400, "j"), ("까지", 600, "j"), ("부터", 600, "j"),
    ("하고", 500, "j"),
    # eomi — endings and tense morphemes (syllable-aligned forms +
    # frequent contracted portmanteaus)
    ("다", 4000, "e"), ("요", 2500, "e"), ("고", 2000, "e"),
    ("지", 1200, "e"), ("면", 1000, "e"), ("서", 1000, "e"),
    ("니다", 1500, "e"), ("습니다", 2000, "e"),
    ("었", 2000, "e"), ("았", 1500, "e"), ("겠", 800, "e"),
    ("는다", 800, "e"), ("기", 900, "e"),
    ("게", 900, "e"), ("죠", 400, "e"), ("어요", 1500, "e"),
    ("아요", 900, "e"), ("어", 1200, "e"), ("아", 900, "e"),
    ("으면", 500, "e"), ("습니까", 400, "e"), ("세요", 700, "e"),
    # contracted stem+tense portmanteaus (the syllable fuses stem vowel and
    # 았/었 — listing them is how a syllable-level lattice covers them)
    ("했", 1500, "e"), ("갔", 600, "e"), ("왔", 600, "e"),
    ("됐", 400, "e"), ("합니다", 1800, "e"), ("갑니다", 400, "e"),
    ("해요", 900, "e"),
    ("한다", 700, "e"), ("하는", 900, "e"), ("하면", 500, "e"),
    # verb / adjective stems
    ("하", 3000, "v"), ("가", 1200, "v"), ("오", 800, "v"),
    ("먹", 800, "v"), ("보", 900, "v"), ("살", 500, "v"),
    ("알", 600, "v"), ("모르", 400, "v"), ("좋", 800, "v"),
    ("크", 400, "v"), ("작", 300, "v"), ("있", 2000, "v"),
    ("없", 1200, "v"), ("되", 1000, "v"), ("배우", 400, "v"), ("싶", 600, "v"),
    ("만들", 400, "v"), ("읽", 300, "v"), ("쓰", 400, "v"),
    # noun / pronoun stems
    ("사람", 1500, "n"), ("것", 2000, "n"), ("때", 1200, "n"),
    ("집", 700, "n"), ("학교", 700, "n"), ("학생", 600, "n"),
    ("선생님", 500, "n"), ("시간", 700, "n"), ("나라", 400, "n"),
    ("한국", 800, "n"), ("한국어", 300, "n"), ("서울", 500, "n"),
    ("말", 700, "n"), ("물", 400, "n"), ("밥", 300, "n"),
    ("나", 1500, "n"), ("너", 700, "n"), ("우리", 1200, "n"),
    ("저", 800, "n"), ("그", 1500, "n"), ("공부", 500, "n"),
    ("일", 900, "n"), ("오늘", 600, "n"), ("내일", 400, "n"),
    ("어제", 300, "n"), ("책", 400, "n"), ("친구", 600, "n"),
)


class KoreanLexicon(JapaneseLexicon):
    """:class:`Lexicon` + Korean morpheme categories (n/v/j/e/x). Reuses
    the 3-column dictionary format; uncategorized words default to noun
    (the open class), with the josa table as a fallback hint. Homographs
    keep EVERY category they were added with (가 is a josa and a verb
    stem; the lattice gets one edge per reading)."""

    _CATS = ("n", "v", "j", "e", "x")

    def add(self, word: str, freq: int = 1, cat: Optional[str] = None):
        word = word.strip()
        if not word:
            return
        if cat is None:
            cat = self._cat.get(word) or (
                "j" if word in KOREAN_JOSA else "n")
        self._cat.setdefault(word, cat)     # primary = first reading
        cats = self._all_cats.setdefault(word, [])
        if cat not in cats:
            cats.append(cat)
        Lexicon.add(self, word, freq)

    def __init__(self, entries: Optional[Iterable] = None):
        self._all_cats: Dict[str, List[str]] = {}
        super().__init__(entries)

    def categories(self, word: str) -> Tuple[str, ...]:
        return tuple(self._all_cats.get(word) or (self.category(word),))

    def load(self, path: str, encoding: str = "utf-8") -> "KoreanLexicon":
        for word, freq, extra in _iter_dict_lines(path, encoding):
            cat = extra[0] if extra and extra[0] in self._CATS else None
            self.add(word, freq, cat)
        return self

    def category(self, word: str) -> str:
        return self._cat.get(word, "n")


class _KoreanLatticeSegmenter(_JapaneseLatticeSegmenter):
    """Eojeol-internal morpheme lattice — the arirang algorithm class
    (reference ``deeplearning4j-nlp-korean`` bundles arirang's
    ``MorphAnalyzer``: decompose each eojeol into stem + particle/ending
    chains via dictionary tables and pick the best analysis). Same Viterbi
    machinery as the Japanese lattice, Korean category set + connection
    matrix:

    - ``B → n/v/x`` (an eojeol opens with a stem; bound morphemes first
      are penalized),
    - ``n → j`` (noun+josa, the dominant pattern), ``n → n`` mildly
      penalized (compounds exist: 한국+어),
    - ``v → e`` (verb stems must take an ending; ``v → E`` is heavily
      penalized — an unfinished verb is not a Korean word),
    - ``e → e`` cheap (ending chains: 먹+었+습니다), ``e → E`` free.

    Syllable-level honesty: Korean tense/politeness morphemes fuse INTO
    the preceding syllable when the stem ends in a vowel (가+았→갔,
    하+았→했, 하+ㅂ니다→합니다). A syllable lattice cannot split those, so
    the seed lists frequent portmanteau forms as single "e"/"v" entries —
    the same table-driven answer arirang uses — and everything
    syllable-aligned (먹/었/습니다, 학생/이) decomposes properly."""

    _CONN = {
        "B": {"n": 0.0, "v": 0.3, "x": 1.0, "j": 4.0, "e": 4.0},
        # n->j carries a small BONUS: noun+josa is the dominant eojeol
        # shape, and it must beat an unknown run absorbing its josa
        "n": {"n": 1.2, "v": 1.5, "j": -0.5, "e": 1.0, "x": 0.8, "E": 0.2},
        "v": {"e": 0.0, "n": 2.5, "v": 2.5, "j": 3.0, "x": 2.0, "E": 3.0},
        "j": {"n": 1.5, "v": 1.8, "j": 1.5, "e": 2.5, "x": 2.0, "E": 0.0},
        "e": {"e": 0.3, "n": 2.0, "v": 2.0, "j": 1.5, "x": 2.0, "E": 0.0},
        "x": {"n": 0.5, "v": 0.8, "j": 1.0, "e": 1.5, "x": 1.5, "E": 0.8},
    }
    _UNK_CAT = "n"            # unknown runs read as noun stems (open class)
    _UNK_PER_CHAR = 3.0       # steeper than Japanese: an unknown eojeol
                              # must not swallow its trailing josa/eomi
    _LEX_CLS = KoreanLexicon
    _SEED = KOREAN_SEED_ENTRIES


class KoreanTokenizerFactory(TokenizerFactory):
    """Korean tokenizer behind the reference's ``TokenizerFactory`` seam
    (``deeplearning4j-nlp-korean/.../KoreanTokenizerFactory.java`` over the
    arirang analyzer).

    ``algorithm="lattice"`` (default): whitespace eojeol split, then an
    eojeol-internal morpheme lattice (:class:`_KoreanLatticeSegmenter`) —
    stems, josa and endings come out as separate tokens, so 학생이 and
    학생을 both contribute 학생 to an embedding vocabulary.
    ``strip_particles=True`` (default) drops josa/eomi from the output,
    the arirang stemming contract for embedding pipelines; set False to
    keep the full morpheme stream.

    ``algorithm="simple"``: the legacy longest-josa suffix strip."""

    def __init__(self, strip_josa: bool = True, algorithm: str = "lattice",
                 lexicon: Optional[Iterable] = None,
                 dict_path: Optional[str] = None,
                 strip_particles: Optional[bool] = None):
        self._pre: Optional[TokenPreProcess] = None
        if algorithm not in ("lattice", "simple"):
            raise ValueError(f"unknown segmentation algorithm {algorithm!r}"
                             " (expected 'lattice' or 'simple')")
        self._algorithm = algorithm
        self._strip = strip_josa
        self._strip_particles = (strip_particles if strip_particles
                                 is not None else strip_josa)
        self._josa = sorted(KOREAN_JOSA, key=len, reverse=True)
        if algorithm == "lattice":
            self._lat = _KoreanLatticeSegmenter(lexicon)
            if dict_path is not None:
                self._lat.lexicon.load(dict_path)

    def add_words(self, *words):
        """Extend the dictionary (arirang user-dictionary seam); entries
        are words or ``(word, freq[, cat])`` tuples. Lattice mode only —
        the simple josa strip has no dictionary, so silently accepting
        words would lose them."""
        if self._algorithm != "lattice":
            raise ValueError("algorithm='simple' has no dictionary — use "
                             "the lattice for user words")
        self._lat.add(*words)
        return self

    addWords = add_words

    def load_dictionary(self, path: str):
        if self._algorithm != "lattice":
            raise ValueError("algorithm='simple' has no dictionary — the "
                             "josa strip is table-driven; use the lattice "
                             "for user dictionaries")
        self._lat.lexicon.load(path)
        return self

    loadDictionary = load_dictionary

    def _stem(self, word: str) -> str:
        if not self._strip or not all(_is_hangul(c) for c in word):
            return word
        for j in self._josa:
            if len(word) > len(j) and word.endswith(j):
                return word[:-len(j)]
        return word

    def _analyze(self, eojeol: str) -> List[str]:
        pairs = self._lat.segment_with_categories(eojeol)
        if not self._strip_particles:
            return [m for m, _ in pairs]
        # filter on the category the Viterbi PATH chose — a homograph verb
        # stem whose surface doubles as a josa (가고 → 가+고) must survive
        kept = [m for m, cat in pairs if cat not in ("j", "e")]
        # an eojeol that is ALL particles/endings (e.g. 합니다 alone)
        # keeps its surface form: dropping every token would lose it
        return kept or [eojeol]

    def create(self, text: str) -> Tokenizer:
        tokens: List[str] = []
        for raw in text.split():
            # punctuation splits the eojeol (안녕,세상 → 안녕 / 세상)
            for word, cls in _script_runs(raw):
                if cls == "punct":
                    continue
                if self._algorithm == "lattice" and cls == "hangul":
                    tokens.extend(self._analyze(word))
                else:
                    tokens.append(self._stem(word))
        return self._finish(tokens)


# ------------------------------------------------------- UIMA-style pipeline
_ABBREV = {"mr", "mrs", "ms", "dr", "prof", "st", "vs", "etc", "e.g", "i.e",
           "fig", "jr", "sr"}


class SentenceAnnotator:
    """Rule-based sentence segmentation (reference
    ``deeplearning4j-nlp-uima/.../annotator/SentenceAnnotator.java``):
    split on ``.!?`` with abbreviation and decimal guards."""

    def annotate(self, text: str) -> List[str]:
        sentences: List[str] = []
        buf: List[str] = []
        i, n = 0, len(text)
        while i < n:
            ch = text[i]
            buf.append(ch)
            if ch in ".!?":
                prev = "".join(buf).rstrip(".!?").split()
                last = prev[-1].lower().rstrip(".") if prev else ""
                nxt = text[i + 1] if i + 1 < n else " "
                if ch == "." and (last in _ABBREV or nxt.isdigit()):
                    i += 1
                    continue
                if nxt.isspace() or i + 1 == n:
                    s = "".join(buf).strip()
                    if s:
                        sentences.append(s)
                    buf = []
            i += 1
        tail = "".join(buf).strip()
        if tail:
            sentences.append(tail)
        return sentences


class TokenizerAnnotator:
    """Penn-treebank-ish tokenization: words, numbers, punctuation tokens
    (reference ``annotator/TokenizerAnnotator.java``)."""

    _PAT = re.compile(
        r"[^\W\d_]+(?:'[^\W\d_]+)?|\d+(?:\.\d+)?|[^\w\s]", re.UNICODE)

    def annotate(self, sentence: str) -> List[str]:
        return self._PAT.findall(sentence)


class PoStagger:
    """Suffix-rule POS tagger over Penn tags (reference
    ``annotator/PoStagger.java`` via ClearTK; rule-based stand-in with the
    same annotation contract: token → tag)."""

    _DET = {"the", "a", "an", "this", "that", "these", "those"}
    _PRON = {"i", "you", "he", "she", "it", "we", "they", "me", "him", "her",
             "us", "them"}
    _PREP = {"in", "on", "at", "of", "to", "by", "for", "with", "from",
             "over", "under", "into"}
    _CONJ = {"and", "or", "but", "nor", "so", "yet"}
    _MODAL = {"can", "could", "will", "would", "shall", "should", "may",
              "might", "must"}
    _BE = {"is", "are", "was", "were", "be", "been", "am", "being"}

    def tag(self, token: str) -> str:
        t = token.lower()
        if re.fullmatch(r"\d+(\.\d+)?", t):
            return "CD"
        if not any(c.isalnum() for c in t):
            return "."
        if t in self._DET:
            return "DT"
        if t in self._PRON:
            return "PRP"
        if t in self._PREP:
            return "IN"
        if t in self._CONJ:
            return "CC"
        if t in self._MODAL:
            return "MD"
        if t in self._BE:
            return "VB"
        if t.endswith("ing"):
            return "VBG"
        if t.endswith("ed"):
            return "VBD"
        if t.endswith("ly"):
            return "RB"
        if t.endswith(("ous", "ful", "ive", "able", "ible", "al", "ic")):
            return "JJ"
        if t.endswith("s") and len(t) > 3 and not t.endswith("ss"):
            return "NNS"
        if token[:1].isupper():
            return "NNP"
        return "NN"

    def annotate(self, tokens: Sequence[str]) -> List[Tuple[str, str]]:
        return [(tok, self.tag(tok)) for tok in tokens]


class AnnotationPipeline:
    """Sentence → token → POS pipeline (the UIMA AnalysisEngine aggregate the
    reference builds in ``UimaResource``/``UimaTokenizerFactory``)."""

    def __init__(self):
        self.sentences = SentenceAnnotator()
        self.tokenizer = TokenizerAnnotator()
        self.pos = PoStagger()

    def process(self, text: str) -> List[Dict[str, object]]:
        out: List[Dict[str, object]] = []
        for sent in self.sentences.annotate(text):
            toks = self.tokenizer.annotate(sent)
            out.append({"sentence": sent, "tokens": toks,
                        "pos": self.pos.annotate(toks)})
        return out


class UimaTokenizerFactory(TokenizerFactory):
    """TokenizerFactory over the annotation pipeline (reference
    ``deeplearning4j-nlp-uima/.../UimaTokenizerFactory.java``)."""

    def __init__(self, pipeline: Optional[AnnotationPipeline] = None,
                 drop_punct: bool = True):
        self._pre: Optional[TokenPreProcess] = None
        self._pipeline = pipeline or AnnotationPipeline()
        self._drop_punct = drop_punct

    def create(self, text: str) -> Tokenizer:
        tokens: List[str] = []
        for ann in self._pipeline.process(text):
            for tok, tag in ann["pos"]:
                if self._drop_punct and tag == ".":
                    continue
                tokens.append(tok)
        return self._finish(tokens)
