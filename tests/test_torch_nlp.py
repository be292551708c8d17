"""The port's NLP embeddings on the CPU, against the JAX package.

The host pipeline (tokenizers, vocab, Huffman codes and points, the pair and
negative draws, the bag-of-words weights) must equal the JAX package's
exactly. The device steps are held from one state: the JAX table's arrays
go into the port through ``lookup_table_from_numpy``, one hierarchical-
softmax and one negative-sampling batch with duplicate indices (and a
masked tail in JAX, sliced in the port) runs in both, and the tables must
agree at STEP_ATOL. Whole fits from the same seed (Word2Vec HS, NS and
CBOW, ParagraphVectors DBOW and DM, GloVe) must give the JAX package's
vectors at FIT_ATOL: the same f32 sums in another order, over a few hundred
batches. The word-vector files are read across the packages both ways, and
``tests/test_nlp.py``'s topic-clustering checks run on the port.
"""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import deeplearning4j_tpu.nlp as J
from deeplearning4j_tpu.nlp import sequencevectors as jsv
from deeplearning4j_tpu.nlp import glove as jglove

import deeplearning4j_torch.nlp as P
from deeplearning4j_torch.nlp import sequencevectors as psv
from deeplearning4j_torch.nlp import glove as pglove

STEP_ATOL = 1e-6     # one batch, f32, sums of up to 64 duplicates in another order
FIT_ATOL = 5e-5      # whole small fits (tables of magnitude <= ~1), f32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _topic_corpus(n=300, seed=0):
    """Two topics with disjoint vocab (tests/test_nlp.py's corpus)."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "horse", "cow", "sheep", "goat"]
    tech = ["cpu", "gpu", "ram", "disk", "cache", "bus"]
    return [" ".join(rng.choice(animals if rng.random() < 0.5 else tech, size=6))
            for _ in range(n)]


def _zipf_sequences(n=200, length=12, vocab=300, seed=0):
    rng = np.random.default_rng(seed)
    return [[f"w{int(i)}" for i in rng.zipf(1.3, length) % vocab] for _ in range(n)]


def _vectors(model):
    return np.stack([model.word_vector(w.word) for w in model.vocab.vocab_words()])


# ------------------------------------------------------------------ pipeline
def test_tokenizers_match_jax():
    text = "Hello, World! 123 foo-bar (baz) The cat sat; on the mat."
    pt, jt = (M.DefaultTokenizerFactory().set_token_pre_processor(M.CommonPreprocessor())
              for M in (P, J))
    assert pt.create(text).get_tokens() == jt.create(text).get_tokens()
    pn = P.NGramTokenizerFactory(P.DefaultTokenizerFactory(), 1, 3).create(text).get_tokens()
    jn = J.NGramTokenizerFactory(J.DefaultTokenizerFactory(), 1, 3).create(text).get_tokens()
    assert pn == jn and "foo-bar (baz) The" in pn
    low = P.DefaultTokenizerFactory().set_token_pre_processor(P.LowCasePreProcessor())
    assert low.create("A b C").get_tokens() == ["a", "b", "c"]
    assert P.StopWords.get_stop_words() == J.StopWords.get_stop_words()


def test_sentence_iterators(tmp_path):
    path = tmp_path / "lines.txt"
    path.write_text("first line\n\nsecond line\nthird\n", encoding="utf-8")
    assert list(P.BasicLineIterator(str(path))) == list(J.BasicLineIterator(str(path))) == [
        "first line", "second line", "third"]
    it = P.CollectionSentenceIterator(["a b", "c"])
    assert list(it) == ["a b", "c"] and list(it) == ["a b", "c"]


def test_vocab_and_huffman_equal_jax():
    seqs = _zipf_sequences()
    for mf in (1, 3):
        pv = P.build_vocab(seqs, min_word_frequency=mf)
        jv = J.build_vocab(seqs, min_word_frequency=mf)
        assert pv.words() == jv.words() and pv.total_word_count == jv.total_word_count
        for a, b in zip(pv.vocab_words(), jv.vocab_words()):
            assert (a.word, a.frequency, a.index, a.codes, a.points) == (
                b.word, b.frequency, b.index, b.codes, b.points)
    codes = {w.word: "".join(map(str, w.codes)) for w in P.build_vocab(seqs).vocab_words()}
    vals = sorted(codes.values())
    assert all(not b.startswith(a) for a, b in zip(vals, vals[1:]))   # prefix-free


# ------------------------------------------------------------------- steps
def _state(negative):
    """A trained JAX model's vocab and tables, and a batch of pairs with
    duplicate rows and targets."""
    sv = J.SequenceVectors(vector_length=16, window=3, negative=negative,
                           use_hierarchic_softmax=True, batch_size=256, seed=3)
    sv.fit(_zipf_sequences(60, 10, 40, seed=1))
    rng = np.random.default_rng(9)
    V = sv.vocab.num_words()
    rows = rng.integers(0, min(V, 8), 192).astype(np.int32)      # many duplicates
    targets = rng.integers(0, V, 192).astype(np.int32)
    return sv, rows, targets


def test_hs_step_matches_jax_from_one_state():
    sv, rows, targets = _state(0)
    lt, B, n, lr = sv.lookup_table, 256, 192, 0.0173
    syn0, syn1 = np.asarray(lt.syn0), np.asarray(lt.syn1)
    port = psv.lookup_table_from_numpy(sv.vocab, syn0, syn1, device="cpu")
    packed = np.zeros((2, B + 1), np.int32)                        # JAX: padded, masked
    packed[0, :n], packed[1, :n] = rows, targets
    packed[:, -1] = [n, np.float32(lr).view(np.int32)]
    j0, j1 = jsv._hs_step(jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(packed),
                          jnp.asarray(sv._hs_points), jnp.asarray(sv._hs_codes),
                          jnp.asarray(sv._hs_mask))
    tables = tuple(torch.from_numpy(a) for a in (sv._hs_points, sv._hs_codes, sv._hs_mask))
    psv._hs_step(port.syn0, port.syn1, torch.from_numpy(rows), torch.from_numpy(targets),
                 *tables, float(np.float32(lr)))
    for got, want, before in ((port.syn0, j0, syn0), (port.syn1, j1, syn1)):
        assert np.abs(np.asarray(want) - before).max() > 1e-3        # the step moved it
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=STEP_ATOL)


def test_ns_step_matches_jax_from_one_state():
    sv, rows, targets = _state(5)
    lt, B, n, K, lr = sv.lookup_table, 256, 192, 5, 0.021
    syn0, syn1neg = np.asarray(lt.syn0), np.asarray(lt.syn1neg)
    port = psv.lookup_table_from_numpy(sv.vocab, syn0, syn1neg=syn1neg, device="cpu")
    assert port.syn1 is None
    negs = np.random.default_rng(4).integers(0, sv.vocab.num_words(), (B, K)).astype(np.int32)
    body = np.zeros((B, K + 2), np.int32)
    body[:n, 0], body[:n, 1], body[:, 2:] = rows, targets, negs
    meta = np.zeros((1, K + 2), np.int32)
    meta[0, :2] = [n, np.float32(lr).view(np.int32)]
    j0, jn = jsv._ns_step(jnp.asarray(syn0), jnp.asarray(syn1neg),
                          jnp.asarray(np.concatenate([body, meta])))
    psv._ns_step(port.syn0, port.syn1neg, torch.from_numpy(rows),
                 torch.from_numpy(body[:n, 1:].copy()), float(np.float32(lr)))
    for got, want in ((port.syn0, j0), (port.syn1neg, jn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=STEP_ATOL)


def test_steps_sum_duplicates_and_read_the_batch_entry_state():
    """Two identical pairs add twice the single pair's update, computed from
    the tables as they were before the batch (no pair sees another's)."""
    rng = np.random.default_rng(0)
    syn0 = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    syn1neg = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    rows, targets = torch.tensor([1]), torch.tensor([[2, 3]])
    one = [t.clone() for t in psv._ns_step(syn0.clone(), syn1neg.clone(), rows, targets, 0.1)]
    two = psv._ns_step(syn0.clone(), syn1neg.clone(), rows.repeat(2), targets.repeat(2, 1), 0.1)
    for a, b, base in zip(one, two, (syn0, syn1neg)):
        torch.testing.assert_close(b - base, 2 * (a - base), rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------------- fits
def _w2v(M, kind, **kw):
    b = M.Word2Vec.builder().layer_size(24).window_size(3).epochs(3).seed(1)
    if kind == "ns":
        b = b.negative_sample(5)
    if kind == "cbow":
        b = b.elements_learning_algorithm("CBOW")
    if M is P:
        b = b.device("cpu")
    return b.build()


@pytest.mark.parametrize("kind", ["hs", "ns", "cbow"])
def test_word2vec_fit_matches_jax(kind):
    port, jax_model = _w2v(P, kind), _w2v(J, kind)
    port.fit(_topic_corpus())
    jax_model.fit(_topic_corpus())
    assert port.vocab.words() == jax_model.vocab.words()
    assert isinstance(port, P.CBOW) == (kind == "cbow")
    np.testing.assert_allclose(_vectors(port), _vectors(jax_model), rtol=0, atol=FIT_ATOL)
    assert port.similarity("cat", "dog") == pytest.approx(
        jax_model.similarity("cat", "dog"), abs=1e-4)


@pytest.mark.parametrize("dm", [False, True])
def test_paragraph_vectors_fit_and_predict_match_jax(dm):
    rng = np.random.default_rng(5)
    docs = []
    for i in range(60):
        docs.append((f"animal_{i}", " ".join(rng.choice(["cat", "dog", "horse", "cow"], 8))))
        docs.append((f"tech_{i}", " ".join(rng.choice(["cpu", "gpu", "ram", "disk"], 8))))
    port = P.ParagraphVectors(dm=dm, vector_length=24, window=4, epochs=3, seed=5, device="cpu")
    jax_model = J.ParagraphVectors(dm=dm, vector_length=24, window=4, epochs=3, seed=5)
    port.fit_labelled(docs)
    jax_model.fit_labelled(docs)
    np.testing.assert_allclose(_vectors(port), _vectors(jax_model), rtol=0, atol=FIT_ATOL)
    np.testing.assert_allclose(port.doc_vector("tech_3"), jax_model.doc_vector("tech_3"),
                               rtol=0, atol=FIT_ATOL)
    text = "dog horse cat"
    assert port.predict(text) == jax_model.predict(text)
    assert port.similarity_to_label(text, "animal_0") > port.similarity_to_label(text, "tech_0")


@pytest.mark.parametrize("rows", ["every_row", "labels_but_one"])
def test_paragraph_vectors_predict_drops_nan_similarities_like_jax(rows):
    """A table gone to NaN (every row: None) or NaN doc vectors for every
    label but one (that label) give JAX's ``predict`` answer."""
    docs = [(f"animal_{i}", "cat dog horse cow") for i in range(4)]
    docs += [(f"tech_{i}", "cpu gpu ram disk") for i in range(4)]
    port = P.ParagraphVectors(vector_length=8, window=2, epochs=1, seed=3, device="cpu")
    jax_model = J.ParagraphVectors(vector_length=8, window=2, epochs=1, seed=3)
    port.fit_labelled(docs)
    jax_model.fit_labelled(docs)
    syn0 = np.array(jax_model.lookup_table.syn0, np.float32)
    if rows == "every_row":
        syn0[:] = np.nan
    else:
        for label, _ in docs[:-1]:
            syn0[jax_model.vocab.index_of(jax_model._label_token(label))] = np.nan
    jax_model.lookup_table.syn0 = syn0
    port.lookup_table.syn0.copy_(torch.from_numpy(syn0))
    text = "dog horse cat"
    want = None if rows == "every_row" else docs[-1][0]
    assert jax_model.predict(text) == want
    assert port.predict(text) == want


def test_glove_fit_matches_jax():
    port = (P.Glove.builder().layer_size(16).window_size(4).epochs(20).learning_rate(0.1)
            .device("cpu").build())
    jax_model = J.Glove.builder().layer_size(16).window_size(4).epochs(20).learning_rate(0.1).build()
    port.fit(_topic_corpus(400))
    jax_model.fit(_topic_corpus(400))
    assert port.vocab.words() == jax_model.vocab.words()
    np.testing.assert_allclose(port.syn0, jax_model.syn0, rtol=0, atol=FIT_ATOL)
    assert port.similarity("cat", "dog") > port.similarity("cat", "cpu") + 0.2


def test_glove_step_matches_jax_with_duplicates():
    rng = np.random.default_rng(6)
    n, d, B = 10, 8, 64
    tabs = [rng.normal(scale=0.3, size=s).astype(np.float32)
            for s in ((n, d), (n, d), (n,), (n,))]
    tabs += [rng.uniform(1, 2, size=s).astype(np.float32) for s in ((n, d), (n, d), (n,), (n,))]
    rows, cols = rng.integers(0, 4, B), rng.integers(0, n, B)        # duplicate rows
    logx = rng.normal(size=B).astype(np.float32)
    fx = rng.uniform(0.1, 1, B).astype(np.float32)
    want = jglove._glove_step(*map(jnp.asarray, tabs), jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(logx), jnp.asarray(fx), jnp.float32(0.05))
    got = pglove._glove_step(*(torch.from_numpy(t.copy()) for t in tabs),
                             torch.from_numpy(rows), torch.from_numpy(cols),
                             torch.from_numpy(logx), torch.from_numpy(fx), 0.05)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=STEP_ATOL)


def test_large_batches_diverge_in_both_packages():
    """Reference behaviour the port mirrors: each step sums every duplicate's
    update from the batch's entry state, so on bench.py's zipf corpus (one
    word a quarter of the tokens) batch 8192 drives the vectors past any
    finite scale in both packages, while batch 512 (the default) stays
    finite and the two agree (1e-3: ~1,600 batches of f32 sums in another
    order)."""
    rng = np.random.default_rng(0)
    ids = (rng.zipf(1.3, size=1000 * 40) % 5000).reshape(1000, 40)
    sentences = [" ".join(f"w{t}" for t in row) for row in ids]
    for batch in (8192, 512):
        kw = dict(vector_length=16, window=5, epochs=1, batch_size=batch, min_word_frequency=1)
        port, jax_model = P.Word2Vec(device="cpu", **kw), J.Word2Vec(**kw)
        port.fit(sentences)
        jax_model.fit(sentences)
        ps, js = port.lookup_table.syn0.numpy(), np.asarray(jax_model.lookup_table.syn0)
        if batch == 8192:
            for v in (ps, js):
                assert not np.isfinite(v).all() or np.abs(v).max() > 1e6
        else:
            assert np.isfinite(ps).all() and np.abs(ps).max() < 1.0
            np.testing.assert_allclose(ps, js, rtol=0, atol=1e-3)


# ------------------------------------------------------------ serialization
def test_word_vectors_cross_the_packages_in_both_formats(tmp_path):
    port = P.Word2Vec.builder().layer_size(8).epochs(1).seed(6).device("cpu").build()
    port.fit(["alpha beta gamma", "beta gamma delta", "alpha delta"])
    jax_model = J.Word2Vec.builder().layer_size(8).epochs(1).seed(6).build()
    jax_model.fit(["alpha beta gamma", "beta gamma delta", "alpha delta"])
    for write, read, ext, atol in (("write_word_vectors", "read_word_vectors", "txt", 1e-5),
                                   ("write_binary", "read_binary", "bin", 0.0)):
        for src, src_ser, dst_ser, tag in (
                (port, P.WordVectorSerializer, J.WordVectorSerializer, "p2j"),
                (jax_model, J.WordVectorSerializer, P.WordVectorSerializer, "j2p")):
            path = str(tmp_path / f"{tag}.{ext}")
            getattr(src_ser, write)(src, path)
            loaded = getattr(dst_ser, read)(path)
            for w in ("alpha", "beta", "gamma", "delta"):
                assert loaded.has_word(w)
                np.testing.assert_allclose(loaded.word_vector(w), src.word_vector(w),
                                           rtol=0, atol=atol)
    loaded = P.WordVectorSerializer.read_binary(str(tmp_path / "j2p.bin"))
    assert loaded.words == jax_model.vocab.words() and loaded.words_nearest("beta", 2)
    assert isinstance(loaded, P.StaticWordVectors)


# ------------------------------------------------------------ bag of words
CORPUS = ["the cat sat on the mat", "the dog sat on the log", "cats and dogs"]


def test_bag_of_words_and_tfidf_match_jax():
    for cls in ("BagOfWordsVectorizer", "TfidfVectorizer"):
        p = getattr(P, cls).Builder().set_min_word_frequency(1).set_stop_words(["on"]).build()
        j = getattr(J, cls).Builder().set_min_word_frequency(1).set_stop_words(["on"]).build()
        p.fit(CORPUS, labels=["a", "b", "a"])
        j.fit(CORPUS, labels=["a", "b", "a"])
        assert p.vocab == j.vocab and p.index_of("on") == -1
        for doc in ("the cat and the cat", "dogs sat on the mat", "unknown words"):
            np.testing.assert_array_equal(p.transform(doc), j.transform(doc))
        ds, jds = p.vectorize("the dog sat", "b"), j.vectorize("the dog sat", "b")
        assert isinstance(ds, P.bagofwords.DataSet)
        np.testing.assert_array_equal(ds.features, jds.features)
        np.testing.assert_array_equal(ds.labels, jds.labels)
    v = P.TfidfVectorizer.Builder().build()
    v.fit(CORPUS)
    row = v.transform("the cat sat on the mat")
    assert row[0, v.index_of("the")] == pytest.approx((2 / 6) * math.log10(3 / 2), rel=1e-6)
    idx = P.InvertedIndex()
    for i, doc in enumerate(CORPUS):
        idx.add_document(i, doc.split())
    assert idx.query("the", "sat") == [0, 1] and idx.doc_appeared_in("sat") == 2


# ------------------------------------------- tests/test_nlp.py on the port
def test_word2vec_topic_clustering_on_the_port():
    hs = _w2v(P, "hs")
    hs.fit(_topic_corpus())
    assert hs.has_word("cat")
    assert hs.similarity("cat", "dog") > hs.similarity("cat", "gpu") + 0.2
    nearest = hs.words_nearest("cat", 5)
    assert len(set(nearest[:3]) & {"dog", "horse", "cow", "sheep", "goat"}) >= 2
    ns = (P.Word2Vec.builder().layer_size(24).window_size(3).negative_sample(5).epochs(3)
          .seed(2).device("cpu").build())
    ns.fit(_topic_corpus())
    assert ns.similarity("ram", "disk") > ns.similarity("ram", "sheep") + 0.2
    cbow = (P.Word2Vec.builder().layer_size(24).window_size(3).epochs(3)
            .elements_learning_algorithm("CBOW").seed(3).device("cpu").build())
    cbow.fit(_topic_corpus())
    assert cbow.similarity("cow", "goat") > cbow.similarity("cow", "cache") + 0.2


def test_words_nearest_matches_jax_ranking():
    port, jax_model = _w2v(P, "hs"), _w2v(J, "hs")
    port.fit(_topic_corpus())
    jax_model.fit(_topic_corpus())
    for w in ("cat", "gpu", "bus"):
        assert port.words_nearest(w, 4) == jax_model.words_nearest(w, 4)
    assert port.words_nearest("absent") == []


def test_options_and_device_default():
    assert P.SequenceVectors(negative=5, device="cpu").use_hs is False
    assert P.SequenceVectors(device="cpu").use_hs is True
    assert P.SequenceVectors(negative=5, use_hierarchic_softmax=True, device="cpu").use_hs


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: P.Word2Vec.builder().build(), lambda: P.Glove(),
                 lambda: P.ParagraphVectors(), lambda: P.SequenceVectors()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
