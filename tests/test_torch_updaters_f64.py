"""The Adam family's bias corrections in float64 networks (ROADMAP C 6).

The JAX package takes ``1 - beta ** t`` as ``1 - jnp.power(beta, f32 t)``:
a float32 scalar even for float64 parameters. The port's
``updaters.bias_correction`` computes the same float32 power on the host
(the C library's ``powf``, which XLA's CPU backend calls) and is held bit
for bit against JAX's at every step up to 20000 for four betas. With it,
five f64 fit steps of Adam, AMSGrad, AdaMax and Nadam on the same net
agree with the JAX package within 1e-12 relative to the largest entry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.compat import enable_x64
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

from deeplearning4j_torch import DataSet
from deeplearning4j_torch.nn.updaters import bias_correction

from test_torch_recurrent_family import rel, to_port, tree_errors

FIT_TOL = 1e-12
STEPS = 20000


@pytest.mark.parametrize("beta", [0.9, 0.999, 0.99, 0.95])
def test_bias_correction_bit_equal_to_jax(beta):
    with enable_x64(True):
        t = jnp.arange(1, STEPS + 1, dtype=jnp.int32)
        want = np.asarray(jax.jit(lambda s: 1 - jnp.power(beta, s.astype(jnp.float32)))(t))
    assert want.dtype == np.float32
    got = np.array([bias_correction(beta, s) for s in range(1, STEPS + 1)], np.float32)
    assert np.array_equal(got, want), np.nonzero(got != want)[0][:5] + 1


@pytest.mark.parametrize("updater", ["Adam", "AMSGrad", "AdaMax", "Nadam"])
def test_f64_fit_matches_jax(updater, tmp_path):
    with enable_x64(True):
        conf = (JConf.builder().seed(5).updater(getattr(jupd, updater)(learning_rate=1e-2))
                .activation("tanh").dtype("float64").compute_dtype("float64").list()
                .layer(jl.DenseLayer(n_in=4, n_out=6))
                .layer(jl.GravesLSTM(n_in=6, n_out=5, activation="tanh"))
                .layer(jl.RnnOutputLayer(n_in=5, n_out=3, activation="softmax", loss="mcxent"))
                .build())
        jnet = JNet(conf).init()
        net = to_port(jnet, tmp_path)
        rng = np.random.default_rng(0)
        f = rng.normal(size=(4, 6, 4)).astype(np.float32).astype(np.float64)
        labels = np.eye(3)[rng.integers(0, 3, (4, 6))]
        for _ in range(5):
            net.fit(DataSet(f, labels))
            jnet.fit(JDataSet(f, labels))
        assert rel(float(net.score_), float(jnet.score_)) <= FIT_TOL
        errs = tree_errors(jnet.params, net.params)
        assert max(errs.values()) <= FIT_TOL, errs
        errs = tree_errors(jnet.updater_state, net.updater_state)
        assert max(errs.values()) <= FIT_TOL, errs
    assert net.params["1"]["W"].dtype == torch.float64
