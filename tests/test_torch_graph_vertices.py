"""ComputationGraph's vertices and preprocessors on the CPU, against the
JAX package.

Against ``tests/test_computation_graph.py``: each of the twelve vertices
(forward, mask, output type, JSON) and the five preprocessors (output, the
ctx they leave, output type, JSON) on seeded numpy inputs, and
stack/unstack mask propagation. The whole-graph fits are in
``tests/test_torch_graph_training.py``.

Tolerance (f32; the same arithmetic in another summation order): vertex
outputs 1e-6 absolute; preprocessor outputs and masks exactly equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.nn.conf import graph as jgraph
from deeplearning4j_tpu.nn.conf import inputs as jinputs
from deeplearning4j_tpu.nn.conf import preprocessors as jpre

from deeplearning4j_torch.nn.conf import ComputationGraphConfiguration
from deeplearning4j_torch.nn.conf import graph as cgraph
from deeplearning4j_torch.nn.conf import inputs as cinputs
from deeplearning4j_torch.nn.conf import preprocessors as cpre

ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _np(y):
    return y.detach().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _same_type(mine, theirs):
    """Input types compared by class name and fields (two packages, two
    classes)."""
    assert type(mine).__name__ == type(theirs).__name__
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


def _lengths_mask(lengths, T):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


# ------------------------------------------------------------ the vertices
# name -> (kwargs of each package (mod = its graph module, pre = its
# preprocessors module), inputs, masks, input types (from an inputs
# module), ctx names: network inputs and masks the vertex reads)
_X3 = _normal(1, 3, 6, 4)
_MASK3 = _lengths_mask([6, 2, 4], 6)
VERTICES = {
    "SubsetVertex": (lambda mod, pre: {"from_idx": 2, "to_idx": 5}, [_normal(2, 4, 10)], [None],
                     lambda i: [i.InputTypeFeedForward(10)]),
    "StackVertex": (lambda mod, pre: {}, [_normal(3, 2, 5, 3), _normal(4, 2, 5, 3)],
                    [_lengths_mask([5, 2], 5), _lengths_mask([1, 3], 5)],
                    lambda i: [i.InputTypeRecurrent(3, 5)] * 2),
    "UnstackVertex": (lambda mod, pre: {"from_idx": 1, "stack_size": 2}, [_normal(5, 4, 5, 3)],
                      [_lengths_mask([5, 2, 1, 3], 5)], lambda i: [i.InputTypeRecurrent(3, 5)]),
    "ScaleVertex": (lambda mod, pre: {"scale": 2.5}, [_normal(6, 3, 4)], [None],
                    lambda i: [i.InputTypeFeedForward(4)]),
    "ShiftVertex": (lambda mod, pre: {"shift": 1.5}, [_normal(7, 3, 4)], [None],
                    lambda i: [i.InputTypeFeedForward(4)]),
    "L2NormalizeVertex": (lambda mod, pre: {}, [_normal(8, 3, 4, 2)], [None],
                          lambda i: [i.InputTypeRecurrent(2, 4)]),
    "L2Vertex": (lambda mod, pre: {}, [_normal(9, 3, 4), _normal(10, 3, 4)], [None, None],
                 lambda i: [i.InputTypeFeedForward(4)] * 2),
    "PreprocessorVertex": (lambda mod, pre: {"preprocessor": pre.RnnToFeedForwardPreProcessor()},
                           [_normal(11, 2, 3, 4)], [None],
                           lambda i: [i.InputTypeRecurrent(4, 3)]),
    "ReshapeVertex": (lambda mod, pre: {"shape": (-1, 3, 4)}, [_normal(12, 2, 12)], [None],
                      lambda i: [i.InputTypeFeedForward(12)]),
    "PoolHelperVertex": (lambda mod, pre: {}, [_normal(13, 2, 5, 5, 3)], [None],
                         lambda i: [i.InputTypeConvolutional(5, 5, 3)]),
    "LastTimeStepVertex": (lambda mod, pre: {"mask_input": "in"}, [_X3], [_MASK3],
                           lambda i: [i.InputTypeRecurrent(4, 6)]),
    "DuplicateToTimeSeriesVertex": (lambda mod, pre: {"reference_input": "in"},
                                    [_normal(14, 3, 4)], [None],
                                    lambda i: [i.InputTypeFeedForward(4)]),
}


@pytest.mark.parametrize("name", sorted(VERTICES))
def test_vertex_matches_jax(name):
    """Forward, ``propagate_mask``, ``get_output_type`` and ``n_inputs`` of
    each vertex, and its JSON, against the JAX package's."""
    kwargs, xs, masks, types = VERTICES[name]
    mine = getattr(cgraph, name)(**kwargs(cgraph, cpre))
    theirs = getattr(jgraph, name)(**kwargs(jgraph, jpre))
    assert mine.n_inputs() == theirs.n_inputs()
    ref, ref_mask = _X3[:, :, :2], _MASK3
    ctx = {"inputs": {"in": torch.from_numpy(ref)},
           "input_masks": {"in": torch.from_numpy(ref_mask)}}
    jctx = {"inputs": {"in": jnp.asarray(ref)}, "input_masks": {"in": jnp.asarray(ref_mask)}}
    got = mine.forward([torch.from_numpy(x) for x in xs], ctx)
    want = theirs.forward([jnp.asarray(x) for x in xs], jctx)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)
    got_m = mine.propagate_mask([None if m is None else torch.from_numpy(m) for m in masks])
    want_m = theirs.propagate_mask([None if m is None else jnp.asarray(m) for m in masks])
    assert (got_m is None) == (want_m is None)
    if got_m is not None:
        np.testing.assert_array_equal(_np(got_m), np.asarray(want_m))
    _same_type(mine.get_output_type(types(cinputs)), theirs.get_output_type(types(jinputs)))
    text = jgraph.ComputationGraphConfiguration(vertices={"v": theirs}).to_json()
    assert ComputationGraphConfiguration.from_json(text).to_json() == text


# ------------------------------------------------------- the preprocessors
PREPROCESSORS = {
    "RnnToFeedForwardPreProcessor": (lambda m: m.RnnToFeedForwardPreProcessor(),
                                     _normal(20, 2, 3, 4), {},
                                     lambda i: i.InputTypeRecurrent(4, 3)),
    "FeedForwardToRnnPreProcessor": (lambda m: m.FeedForwardToRnnPreProcessor(),
                                     _normal(21, 6, 4), {"minibatch": 2, "timesteps": 3},
                                     lambda i: i.InputTypeFeedForward(4)),
    "FeedForwardToRnnPreProcessor/no-ctx": (lambda m: m.FeedForwardToRnnPreProcessor(),
                                            _normal(22, 6, 4), {},
                                            lambda i: i.InputTypeFeedForward(4)),
    "CnnToRnnPreProcessor": (lambda m: m.CnnToRnnPreProcessor(2, 3, 4),
                             _normal(23, 6, 2, 3, 4), {"minibatch": 2},
                             lambda i: i.InputTypeConvolutional(2, 3, 4)),
    "RnnToCnnPreProcessor": (lambda m: m.RnnToCnnPreProcessor(2, 3, 4), _normal(24, 2, 3, 24),
                             {}, lambda i: i.InputTypeRecurrent(24, 3)),
    "ComposableInputPreProcessor": (
        lambda m: m.ComposableInputPreProcessor(
            [m.RnnToCnnPreProcessor(2, 3, 4), m.CnnToRnnPreProcessor(2, 3, 4)]),
        _normal(25, 2, 3, 24), {}, lambda i: i.InputTypeRecurrent(24, 3)),
}


@pytest.mark.parametrize("case", sorted(PREPROCESSORS))
def test_preprocessor_matches_jax(case):
    """Output, the ctx it leaves, the output type and the JSON of each of
    the five preprocessors the port lacked, against the JAX package's."""
    make, x, ctx, itype = PREPROCESSORS[case]
    mine, theirs = make(cpre), make(jpre)
    my_ctx, their_ctx = dict(ctx), dict(ctx)
    got, want = mine(torch.from_numpy(x), my_ctx), theirs(jnp.asarray(x), their_ctx)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert my_ctx == their_ctx
    _same_type(mine.get_output_type(itype(cinputs)), theirs.get_output_type(itype(jinputs)))
    text = jgraph.ComputationGraphConfiguration(input_preprocessors={"v": theirs}).to_json()
    assert ComputationGraphConfiguration.from_json(text).to_json() == text


def test_stack_unstack_mask_propagation():
    out = cgraph.StackVertex().propagate_mask([torch.ones(2, 5), torch.zeros(2, 5)])
    assert tuple(out.shape) == (4, 5)
    back = cgraph.UnstackVertex(from_idx=1, stack_size=2).propagate_mask([out])
    assert torch.equal(back, torch.zeros(2, 5))
    with pytest.raises(ValueError, match="all or no"):
        cgraph.StackVertex().propagate_mask([torch.ones(2, 5), None])
