"""The port's CJK and UIMA language modules (``nlp/lang.py``) against the
JAX package's.

Each case of ``tests/test_lang.py`` runs in both packages on the same
input and the same lexicon files: the tokens, tags and annotations must be
equal, and equal to the JAX test's expectation where it states one. The
token cases are one table (``TOKEN_CASES``), held a language a test so that
the file stays small (ROADMAP Queue C: a large new file moves the xdist
schedule of the JAX package's order-dependent tests); the CJK factories
also feed the port's Word2Vec on the CPU as they feed JAX's.
"""
import numpy as np
import pytest

from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu.nlp import lang as jlang
from deeplearning4j_tpu.nlp import text as jtext

from deeplearning4j_torch import nlp as pnlp
from deeplearning4j_torch.nlp import lang as plang
from deeplearning4j_torch.nlp import text as ptext

PACKAGES = {"jax": (jlang, jtext), "port": (plang, ptext)}

USER_DICT = "# user dictionary\n研究 1000\n研究生 120\n生命 800\n起源 300\n" \
            "科学家, 50\n发现\n外星 20\n外星人 40\n"
UNIGRAM_DICT = "北京 50000\n北京大学 3000\n大学生 20000\n生前 500\n前来 8000\n" \
               "应聘 6000\n大学 30000\n"
JA_DICT = "朝焼け 500 c\n空 400 c\n"


def _files(tmp_path):
    paths = {}
    for name, body in (("user", USER_DICT), ("unigram", UNIGRAM_DICT), ("ja", JA_DICT)):
        p = tmp_path / f"{name}.dict"
        p.write_text(body, encoding="utf-8")
        paths[name] = str(p)
    return paths


def _zh_user_word(L, files):
    f = L.ChineseTokenizerFactory()
    f.add_words("用户词")
    return f


def _zh_loaded_at_runtime(L, files):
    f = L.ChineseTokenizerFactory()
    f.load_dictionary(files["user"])
    return f


def _ko_user_word(L, files):
    return L.KoreanTokenizerFactory(strip_particles=False).add_words(("데이터", 500, "n"))


def _ja_user_words(L, files):
    return L.JapaneseTokenizerFactory().add_words(("朝焼け", 500, "c"), ("空", 400, "c"))


def _uima_lower(L, files):
    return L.UimaTokenizerFactory()


# (id, factory from (lang module, files), text, the JAX test's expected tokens or None)
TOKEN_CASES = [
    ("zh-max-match", lambda L, f: L.ChineseTokenizerFactory(), "我们喜欢深度学习和神经网络", None),
    ("zh-latin", lambda L, f: L.ChineseTokenizerFactory(), "我用JAX训练模型", None),
    ("zh-user-word", _zh_user_word, "这是用户词测试", None),
    ("zh-supplementary-plane", lambda L, f: L.ChineseTokenizerFactory(), "𠮷野家で123", None),
    ("zh-seed-lexicon-only", lambda L, f: L.ChineseTokenizerFactory(), "研究生命起源",
     list("研究生命起源")),
    ("zh-dict-file", lambda L, f: L.ChineseTokenizerFactory(dict_path=f["user"]),
     "科学家研究生命起源", ["科学家", "研究", "生命", "起源"]),
    ("zh-dict-at-runtime", _zh_loaded_at_runtime, "研究生命起源", ["研究", "生命", "起源"]),
    ("zh-unigram", lambda L, f: L.ChineseTokenizerFactory(algorithm="unigram"),
     "我们喜欢深度学习", None),
    ("zh-unigram-dict", lambda L, f: L.ChineseTokenizerFactory(algorithm="unigram",
                                                               dict_path=f["unigram"]),
     "北京大学生前来应聘", ["北京", "大学生", "前来", "应聘"]),
    ("ja-particles", lambda L, f: L.JapaneseTokenizerFactory(), "私は機械学習が好きです",
     ["私", "は", "機械学習", "が", "好き", "です"]),
    ("ja-katakana", lambda L, f: L.JapaneseTokenizerFactory(), "テンソルの計算",
     ["テンソル", "の", "計算"]),
    ("ja-no-shredding", lambda L, f: L.JapaneseTokenizerFactory(), "ありがとう", ["ありがとう"]),
    ("ja-momo", lambda L, f: L.JapaneseTokenizerFactory(), "ももが", ["もも", "が"]),
    ("ja-sumomo", lambda L, f: L.JapaneseTokenizerFactory(), "すもももももももものうち",
     ["すもも", "も", "もも", "も", "もも", "の", "うち"]),
    ("ja-okurigana", lambda L, f: L.JapaneseTokenizerFactory(), "私は食べる", ["私", "は", "食べる"]),
    ("ja-seed-only", lambda L, f: L.JapaneseTokenizerFactory(), "朝焼けの空", None),
    ("ja-dict-file", lambda L, f: L.JapaneseTokenizerFactory(dict_path=f["ja"]), "朝焼けの空",
     ["朝焼け", "の", "空"]),
    ("ja-add-words", _ja_user_words, "朝焼けの空", ["朝焼け", "の", "空"]),
    ("ja-script", lambda L, f: L.JapaneseTokenizerFactory(algorithm="script"),
     "私は機械学習が好きです", None),
    ("ja-script-momo", lambda L, f: L.JapaneseTokenizerFactory(algorithm="script"), "ももが",
     None),
    ("ko-punct", lambda L, f: L.KoreanTokenizerFactory(), "안녕,세상", ["안녕", "세상"]),
    ("ko-josa", lambda L, f: L.KoreanTokenizerFactory(), "학교에서 친구를 만났다", None),
    ("ko-raw", lambda L, f: L.KoreanTokenizerFactory(strip_josa=False), "학교에서 친구를",
     ["학교", "에서", "친구", "를"]),
    ("ko-simple", lambda L, f: L.KoreanTokenizerFactory(strip_josa=False, algorithm="simple"),
     "학교에서 친구를", ["학교에서", "친구를"]),
    ("ko-lattice", lambda L, f: L.KoreanTokenizerFactory(strip_particles=False),
     "학생이 학교에서 공부합니다", ["학생", "이", "학교", "에서", "공부", "합니다"]),
    ("ko-ending-chain", lambda L, f: L.KoreanTokenizerFactory(strip_particles=False),
     "먹었습니다", ["먹", "었", "습니다"]),
    ("ko-unknown-stem", lambda L, f: L.KoreanTokenizerFactory(strip_particles=False),
     "김철수가 책을 읽었다", ["김철수", "가", "책", "을", "읽", "었", "다"]),
    ("ko-stripped", lambda L, f: L.KoreanTokenizerFactory(), "학생이 학교에서 공부합니다",
     ["학생", "학교", "공부"]),
    ("ko-user-word", _ko_user_word, "데이터를", ["데이터", "를"]),
    ("ko-homograph", lambda L, f: L.KoreanTokenizerFactory(), "가고 싶다", ["가", "싶"]),
    ("uima", _uima_lower, "The model trains fast. It converged!", None),
]


def _tokens(pkg, make, text, files, lower=False):
    L, T = PACKAGES[pkg]
    f = make(L, files)
    if lower:
        f.set_token_pre_processor(T.LowCasePreProcessor())
    return f.create(text).get_tokens()


@pytest.mark.parametrize("lang", ["zh", "ja", "ko", "uima"])
def test_tokens_equal_jax(lang, tmp_path):
    files = _files(tmp_path)
    cases = [c for c in TOKEN_CASES if c[0].split("-")[0] == lang]
    assert cases
    for case, make, text, expected in cases:
        mine = _tokens("port", make, text, files)
        assert mine == _tokens("jax", make, text, files), case
        assert _tokens("port", make, text, files, lower=True) == \
            _tokens("jax", make, text, files, lower=True), case
        if expected is not None:
            assert mine == expected, case


def test_token_cases_hold_the_jax_tests_membership_checks(tmp_path):
    files = _files(tmp_path)
    tok = {c[0]: _tokens("port", c[1], c[2], files) for c in TOKEN_CASES}
    assert {"深度学习", "神经网络", "我们", "喜欢", "和"} <= set(tok["zh-max-match"])
    assert {"JAX", "训练", "模型"} <= set(tok["zh-latin"])
    assert "用户词" in tok["zh-user-word"]
    assert "𠮷" in tok["zh-supplementary-plane"] and "123" in tok["zh-supplementary-plane"]
    assert all("𠮷" not in t or t == "𠮷" for t in tok["zh-supplementary-plane"])
    assert {"深度学习", "我们"} <= set(tok["zh-unigram"])
    assert "朝焼け" not in tok["ja-seed-only"]
    assert "機械学習" in tok["ja-script"]
    assert {"학교", "친구", "만났다"} <= set(tok["ko-josa"])
    lower = _tokens("port", _uima_lower, "The model trains fast. It converged!", files,
                    lower=True)
    assert "the" in lower and "converged" in lower
    assert "." not in lower and "!" not in lower


def test_unknown_algorithm_raises_in_both():
    for factory in ("ChineseTokenizerFactory", "JapaneseTokenizerFactory",
                    "KoreanTokenizerFactory"):
        for L in (jlang, plang):
            with pytest.raises(ValueError):
                getattr(L, factory)(algorithm="nope")


def test_sentence_annotator_guards():
    text = "Dr. Smith trains models. Accuracy hit 99.5 today! Done?"
    out = plang.SentenceAnnotator().annotate(text)
    assert out == ["Dr. Smith trains models.", "Accuracy hit 99.5 today!", "Done?"]
    assert out == jlang.SentenceAnnotator().annotate(text)


def test_pos_tagger_rules():
    for word, tag in (("the", "DT"), ("running", "VBG"), ("trained", "VBD"), ("quickly", "RB"),
                      ("42", "CD"), ("models", "NNS"), ("Smith", None), ("converged", None)):
        mine = plang.PoStagger().tag(word)
        assert mine == jlang.PoStagger().tag(word), word
        if tag is not None:
            assert mine == tag, word


def test_uima_pipeline_annotations_equal_jax():
    text = "The model trains fast. It converged! Dr. Lee ran 3 tests quickly."
    anns = plang.AnnotationPipeline().process(text)
    assert len(anns) == 3
    assert ("The", "DT") in anns[0]["pos"]
    assert anns == jlang.AnnotationPipeline().process(text)


def test_lexicon_file_and_segmenters_equal_jax(tmp_path):
    files = _files(tmp_path)
    for L in (jlang, plang):
        lex = L.Lexicon.from_file(files["user"])
        assert len(lex) == 8 and lex.freq("研究") == 1000 and "发现" in lex
        assert L._MaxMatchSegmenter(lex, bidirectional=False).segment("研究生命起源") == \
            ["研究生", "命", "起源"]
        assert L._MaxMatchSegmenter(lex, bidirectional=True).segment("研究生命起源") == \
            ["研究", "生命", "起源"]
        uni = L._UnigramSegmenter(L.Lexicon.from_file(files["unigram"]))
        assert uni.segment("X北京Y") == ["X", "北京", "Y"]
        lex2 = L.Lexicon()
        for w, f_ in (("中华人民共和国", 100000), ("中华", 100), ("人民", 100), ("共和国", 100)):
            lex2.add(w, f_)
        assert L._UnigramSegmenter(lex2).segment("中华人民共和国") == ["中华人民共和国"]


def test_lexicon_trie_equal_jax():
    for L in (jlang, plang):
        lex = L.Lexicon(["ab", "abc", "bcd"])
        assert lex.longest_prefix("abcd", 0) == 3
        assert lex.longest_prefix("bxcd", 0) == 0
        assert lex.longest_suffix("abcd", 4) == 3
        assert lex.longest_suffix("abxd", 4) == 0
        assert lex.max_len == 3
        lex = L.Lexicon(["ab", "abc", "abcd", "b"])
        assert lex.match_lengths("abcdef", 0) == [2, 3, 4]
        assert lex.match_lengths("abcdef", 1) == [1]
        assert lex.match_lengths("xyz", 0) == []


def test_nlp_exports_the_jax_lang_names():
    names = ["Lexicon", "ChineseTokenizerFactory", "JapaneseTokenizerFactory",
             "KoreanTokenizerFactory", "UimaTokenizerFactory", "AnnotationPipeline"]
    for n in names:
        assert n in pnlp.__all__ and n in jnlp.__all__
        assert getattr(pnlp, n) is getattr(plang, n)
    assert set(pnlp.__all__) - set(jnlp.__all__) == {"lookup_table_from_numpy"}
    assert set(jnlp.__all__) - set(pnlp.__all__) == set()


def test_cjk_factories_feed_word2vec():
    base = ["我们喜欢深度学习", "我们学习神经网络", "模型训练数据"]
    sentences = [base[i % 3] for i in range(60)]
    mine = (pnlp.Word2Vec.builder().layer_size(16).window_size(2).epochs(2)
            .min_word_frequency(1).seed(1).device("cpu")
            .tokenizer_factory(plang.ChineseTokenizerFactory()).build())
    mine.fit(sentences)
    theirs = (jnlp.Word2Vec.builder().layer_size(16).window_size(2).epochs(2)
              .min_word_frequency(1).seed(1)
              .tokenizer_factory(jlang.ChineseTokenizerFactory()).build())
    theirs.fit(sentences)
    for w in ("深度学习", "我们"):
        assert mine.word_vector(w) is not None
        np.testing.assert_allclose(mine.word_vector(w), theirs.word_vector(w), rtol=0,
                                   atol=1e-5)
    assert sorted(mine.vocab.words()) == sorted(theirs.vocab.words())
