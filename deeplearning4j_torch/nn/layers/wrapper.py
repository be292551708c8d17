"""Wrapper layer implementations: FrozenLayer.

Counterpart of ``deeplearning4j_tpu/nn/layers/wrapper.py`` (reference
``nn/layers/FrozenLayer.java``): the inner layer runs as it is, on its
parameters detached (``requires_grad`` off, the counterpart of
``jax.lax.stop_gradient``), so autograd records nothing of them while the
input's gradient flows through: a frozen body under an input that needs
no gradient runs no backward at all.
``train`` passes through as in the JAX package: a frozen
BatchNormalization normalises a training forward by the batch's
statistics and leaves new running statistics for the container to commit
(DL4J's own FrozenLayer runs its inner layer in inference mode). The
parameters, the layer state, the constraints and the stream state are the
inner layer's, as they are; the penalty is 0.
"""
from __future__ import annotations

from .base import LayerImpl, implements, impl_for

__all__ = ["FrozenImpl"]


@implements("FrozenLayer")
class FrozenImpl(LayerImpl):
    def __init__(self, conf, gc):
        super().__init__(conf, gc)
        self.inner = impl_for(conf.inner, gc)

    @property
    def index(self):
        return self.inner.index if "inner" in self._modules else None

    @index.setter
    def index(self, value):
        # the inner layer leaves its state and carries under this index
        if "inner" in self._modules:
            self.inner.index = value

    def param_shapes(self):
        return self.inner.param_shapes()

    def init_params(self, gen):
        return self.inner.init_params(gen)

    def set_params(self, params, device) -> None:
        self.inner.set_params(params, device)
        for p in self.inner.parameters():
            p.requires_grad_(False)

    def param_dict(self):
        return self.inner.param_dict()

    def init_state(self):
        return self.inner.init_state()

    def set_state(self, state, device) -> None:
        self.inner.set_state(state, device)

    def layer_state(self):
        return self.inner.layer_state()

    def commit_state(self, new_state) -> None:
        self.inner.commit_state(new_state)

    def draws(self) -> bool:
        return self.inner.draws()

    def constraint_sets(self):
        return self.inner.constraint_sets()

    def regularization(self):
        return 0.0

    def forward(self, x, mask=None, ctx=None):
        return self.inner(x, mask=mask, ctx=ctx)

    def loss_on(self, x, labels, mask=None, train=False, gen=None):
        return self.inner.loss_on(x, labels, mask=mask, train=train, gen=gen)
