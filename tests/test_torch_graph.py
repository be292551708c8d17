"""The TransformerLM slice on the CPU, against the JAX package.

A JAX ``TransformerLM`` (vocab 12, embed 32, 2 heads, 2 blocks, Adam) is
built as a ``ComputationGraph``, its weights perturbed from their init
(so LayerNorm gains and biases are not trivially 1 and 0), written with
``ModelSerializer`` and restored by the port on ``device="cpu"``. Both
then compute outputs, scores and gradients and take three Adam steps on
the same numpy batch, on the dense attention route (T=64) and on the flash
route (T=256, with both packages' short-sequence test seams flipped: the
JAX side runs its Pallas kernels in interpret mode, the port the kernels'
plain versions).

Tolerances (max |port - jax| over max |jax| unless said otherwise):
- f32 compute: the same arithmetic in another summation order. Outputs
  1e-5 absolute (probabilities), scores 1e-5 relative, gradients 1e-4 of
  their largest entry, parameters after 3 Adam steps 1e-5 absolute
  (measured <= 7.7e-7, 7.3e-8, 2.1e-6, 2.4e-7).
- bf16 compute: activations, logits and the attention operands are
  rounded to bf16 at places where the two frameworks round differently,
  so a logit can move by one bf16 unit (2^-8 relative): outputs 3e-2
  absolute, scores 2e-3 relative, gradients 3e-2 of their largest entry,
  parameters 2 x lr x steps absolute (as for the char-RNN; measured 9.5e-3,
  2.0e-4, 1.1e-2, 3.7e-3).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.ops.flash_attention as jfa
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import TransformerLM as JTransformerLM
from deeplearning4j_tpu.nn.conf.graph import ComputationGraphConfiguration as JCGConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.utils.model_serializer import ModelSerializer

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.models import TransformerLM
from deeplearning4j_torch.nn.conf import graph as cgraph
from deeplearning4j_torch.nn.conf.graph import ComputationGraphConfiguration
from deeplearning4j_torch.nn.graph import ComputationGraph
from deeplearning4j_torch.ops import flash_attention as fa
from deeplearning4j_torch.utils.model_serializer import restore_computation_graph

V, E, HEADS, BLOCKS, B = 12, 32, 2, 2, 2
LR = 1e-3
OUT_ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
SCORE_RTOL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _short_flash_sequences(monkeypatch):
    """Both packages take the flash route from T=256 (JAX: its kernels in
    interpret mode; the port: the kernels' plain versions)."""
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(fa, "_FORCE_SHORT_SEQ", True)


def _jax_lm(compute, seed=3):
    conf = JTransformerLM(vocab_size=V, embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS,
                          seed=seed).conf()
    conf.global_conf.compute_dtype = compute
    net = JGraph(conf).init()
    rng = np.random.default_rng(seed)
    net.params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(0.05 * rng.standard_normal(p.shape), p.dtype), net.params)
    return net


def _restored(jnet, tmp_path):
    path = tmp_path / "lm.zip"
    ModelSerializer.write_model(jnet, str(path))
    return restore_computation_graph(path, device="cpu")


def _batch(seed, T):
    """Next-token data: float ids (the JAX bench's layout) and one-hot labels."""
    ids = np.random.default_rng(seed).integers(0, V, (B, T + 1))
    return ids[:, :-1].astype(np.float32), np.eye(V, dtype=np.float32)[ids[:, 1:]]


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _count_calls(monkeypatch):
    calls = {"flash_fwd": 0, "dq_block": 0, "dkv_block": 0}
    for name in calls:
        real = getattr(fa, name)

        def spy(*a, _name=name, _real=real, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(fa, name, spy)
    return calls


def test_configuration_json_round_trips_both_ways():
    """A JAX-written TransformerLM configuration decodes in the port and
    re-encodes byte-equal; the port's own builder writes the same bytes,
    which decode in the JAX package and re-encode byte-equal."""
    jconf = JTransformerLM(vocab_size=V, embed_dim=E, num_heads=HEADS,
                           num_blocks=BLOCKS, seed=3).conf()
    text = jconf.to_json()
    assert ComputationGraphConfiguration.from_json(text).to_json() == text
    mine = TransformerLM(vocab_size=V, embed_dim=E, num_heads=HEADS, num_blocks=BLOCKS,
                         seed=3).conf().to_json()
    assert mine == text
    assert JCGConf.from_json(mine).to_json() == mine


def test_every_vertex_class_decodes_and_unported_ones_raise_by_name():
    """A vertex added to a JAX-written configuration decodes and re-encodes
    byte for byte, and runs as the JAX package's does: no vertex class is
    left unported (the name is the test's from when twelve of them
    raised)."""
    conf = (JTransformerLM(vocab_size=V, embed_dim=E, num_heads=HEADS, num_blocks=1,
                           seed=3).conf())
    doc = json.loads(conf.to_json())
    doc["vertices"]["extra"] = {"@class": "ScaleVertex", "scale": 2.5}
    doc["vertex_inputs"]["extra"] = ["b0-res-f"]
    text = json.dumps(doc, indent=2)
    mine = ComputationGraphConfiguration.from_json(text)
    assert mine.to_json() == text
    x = np.array([[1.0, -2.0, 0.5]], np.float32)
    np.testing.assert_array_equal(
        mine.vertices["extra"].forward([torch.from_numpy(x)], {}).numpy(),
        np.asarray(JCGConf.from_json(text).vertices["extra"].forward([jnp.asarray(x)], {})))
    assert not hasattr(cgraph, "_UnportedVertex")
    xs = [torch.tensor([1.0, -2.0]), torch.tensor([3.0, 4.0])]
    for op, want in (("add", [4.0, 2.0]), ("subtract", [-2.0, -6.0]), ("product", [3.0, -8.0]),
                     ("average", [2.0, 1.0]), ("max", [3.0, 4.0])):
        assert cgraph.ElementWiseVertex(op=op).forward(xs, {}).tolist() == want
    assert cgraph.MergeVertex().forward(xs, {}).tolist() == [1.0, -2.0, 3.0, 4.0]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,route", [(64, "dense"), (256, "flash")])
def test_transformer_lm_matches_jax(tmp_path, monkeypatch, compute, T, route):
    """output, score, gradients and the parameters after three Adam steps,
    on the dense route (T=64) and the flash route (T=256)."""
    jnet = _jax_lm(compute)
    net = _restored(jnet, tmp_path)
    calls = _count_calls(monkeypatch)
    f, l = _batch(1, T)
    out = net.output(f)
    assert out.shape == (B, T, V) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(f)), rtol=0,
                               atol=OUT_ATOL[compute])
    jgrads, jscore = jnet.compute_gradient_and_score(JDataSet(f, l))
    grads, score = net.compute_gradient_and_score(DataSet(f, l))
    flash = route == "flash"
    assert calls == {"flash_fwd": 2 * BLOCKS * flash, "dq_block": BLOCKS * flash,
                     "dkv_block": BLOCKS * flash}
    assert abs(score - jscore) <= SCORE_RTOL[compute] * abs(jscore)
    assert set(grads) == set(jgrads)
    for n, gs in jgrads.items():
        assert set(grads[n]) == set(gs)
        for k, g in gs.items():
            assert _rel(grads[n][k], g) <= GRAD_TOL[compute], (n, k, _rel(grads[n][k], g))
    ds, jds = DataSet(f, l), JDataSet(f, l)
    for _ in range(3):
        net.fit(ds)
        jnet.fit(jds)
    assert net.iteration_count == jnet.iteration_count == 3
    assert abs(net.score() - float(jnet.score())) <= SCORE_RTOL[compute] * float(jnet.score())
    atol = 1e-5 if compute == "float32" else 2 * LR * 3
    for n, ps in jnet.params.items():
        for k, p in ps.items():
            np.testing.assert_allclose(net.params[n][k].float().numpy(),
                                       np.asarray(p, np.float32), rtol=0, atol=atol,
                                       err_msg=f"{n}/{k}")


def test_jax_adam_checkpoint_resumes_in_the_port(tmp_path):
    """Two Adam steps in the JAX package, the zip with its updater state
    restored in the port, then one more step on each side: the same loss
    and parameters (f32, dense route)."""
    jnet = _jax_lm("float32", seed=5)
    f, l = _batch(2, 64)
    for _ in range(2):
        jnet.fit(JDataSet(f, l))
    net = _restored(jnet, tmp_path)
    assert net.iteration_count == 2
    jnet.fit(JDataSet(f, l))
    net.fit(DataSet(f, l))
    assert abs(net.score() - float(jnet.score())) <= 1e-5 * float(jnet.score())
    for n, ps in jnet.params.items():
        for k, p in ps.items():
            np.testing.assert_allclose(net.params[n][k].numpy(), np.asarray(p), rtol=0,
                                       atol=1e-5, err_msg=f"{n}/{k}")


def test_score_with_masks_and_routing_contract(monkeypatch):
    """``score`` uses the features and labels masks; the features mask
    reaches attention as a key mask, which keeps the flash route."""
    net = TransformerLM(vocab_size=V, embed_dim=E, num_heads=HEADS, num_blocks=1,
                        seed=3).init(device="cpu")
    calls = _count_calls(monkeypatch)
    f, l = _batch(3, 256)
    m = np.ones((B, 256), np.float32)
    m[1, 100:] = 0.0
    full, masked = net.score(DataSet(f, l)), net.score(DataSet(f, l, m, m))
    assert np.isfinite(full) and np.isfinite(masked) and masked < full
    assert calls == {"flash_fwd": 2, "dq_block": 0, "dkv_block": 0}


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """ComputationGraph.init, TransformerLM.init and
    restore_computation_graph run on the card unless told otherwise, and
    raise without one; the MoE variant builds on the CPU when asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm = TransformerLM(vocab_size=V, embed_dim=E, num_heads=HEADS, num_blocks=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        ComputationGraph(lm.conf()).init()
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_computation_graph(tmp_path / "missing.zip")
    assert lm.init(device="cpu").device.type == "cpu"
    moe = TransformerLM(vocab_size=V, embed_dim=E, num_heads=HEADS, num_blocks=1, num_experts=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        moe.init()
    net = moe.init(device="cpu")
    assert tuple(net.params["b0-ffn"]["W"].shape) == (4, E, 4 * E)


@pytest.mark.parametrize("T", [64, 256])
def test_attention_dropout_trains_and_stays_off_outside_training(monkeypatch, T):
    """With ``dropout_rate`` > 0 a training loss draws a fresh mask from the
    network's generator (dense route at T=64, the kernels' counter hash at
    T=256, one seed per attention call), while ``output``, ``score`` and
    ``compute_gradient_and_score`` run without dropout, as in the JAX
    package."""
    net = TransformerLM(vocab_size=V, embed_dim=E, num_heads=HEADS, num_blocks=1, seed=4,
                        dropout_rate=0.3).init(device="cpu")
    f, l = _batch(4, T)
    seeds = []
    real = fa.flash_attention

    def spy(*a, **k):
        seeds.append(k.get("dropout_seed"))
        return real(*a, **k)
    monkeypatch.setattr(fa, "flash_attention", spy)
    ft, lt = net._to_device(f), net._to_device(l)
    with torch.no_grad():
        train = [float(net._loss_fn([ft], [lt], None, None, True, net._gen)) for _ in range(2)]
        plain = [float(net._loss_fn([ft], [lt], None, None, True)) for _ in range(2)]
    assert train[0] != train[1] and plain[0] == plain[1]
    assert net.score(DataSet(f, l)) == pytest.approx(plain[0], rel=1e-6)
    _, score = net.compute_gradient_and_score(DataSet(f, l))
    assert score == pytest.approx(plain[0], rel=1e-6)
    if T == 256:
        assert len(seeds) == 6 and all(isinstance(s, int) for s in seeds[:2])
        assert seeds[0] != seeds[1] and seeds[2:] == [None] * 4
    else:
        assert seeds == []
    before = {k: p.clone() for k, p in net.params["b0-attn"].items()}
    net.fit(DataSet(f, l))
    assert np.isfinite(net.score())
    assert any(not torch.equal(before[k], p) for k, p in net.params["b0-attn"].items())
