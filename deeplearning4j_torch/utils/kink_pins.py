"""Pin the kinks of a ReLU network's forward: record which side of each
ReLU every unit took and which cell every max-pool window picked, in one
net, and replay those choices in another.

A ReLU network's loss is piecewise smooth and its gradient jumps where a
unit crosses 0 or a pool's largest cell changes. Two correct runs that
round differently (another device, another precision) land on different
pieces now and then, and in a deep net a single flipped unit moves the
whole gradient far more than rounding does, however accurate both runs
are. A net that replays the other's choices computes
``relu(x)`` as ``x * mask`` and max pooling as a gather at the recorded
cells: the same function on the recorded piece, differentiated on that
piece, so that comparing the two measures rounding and nothing else.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn.conf.layers import ConvolutionMode, PoolingType, _pair
from ..nn.layers.convolution import pad_nchw, same_pads

__all__ = ["KinkPins"]


class KinkPins:
    """``attach`` a recording net and a replaying one; ``record`` says
    which role a forward plays. ``relu[name]`` holds a vertex's signs
    ([b, h, w, c] bool, on the CPU) and ``pool[name]`` its max-pool
    picks (flat indices into each padded [h, w] plane, as
    ``F.max_pool2d(return_indices=True)`` gives them), from the last
    recording forward."""

    def __init__(self):
        self.relu, self.pool, self.record = {}, {}, True

    def attach(self, net):
        """Wrap ``net``'s ReLUs and max pools (either container: a
        MultiLayerNetwork's layers are named by index)."""
        for name, impl in net._layers().items():
            if getattr(impl, "activation", None) is torch.relu:
                impl.activation = self._relu(name)
            c = impl.conf
            if type(c).__name__ == "SubsamplingLayer" and c.pooling_type == PoolingType.MAX:
                impl.forward = self._max_pool(name, c)
        return net

    def _relu(self, name):
        def relu(x):
            if self.record:
                self.relu[name] = (x > 0).cpu()
                return torch.relu(x)
            return x * self.relu[name].to(x.device, x.dtype)
        return relu

    def _max_pool(self, name, c):
        k, s, p = _pair(c.kernel_size), _pair(c.stride), _pair(c.padding)

        def forward(x, mask=None, ctx=None):
            pads = (same_pads(x.shape[1:3], k, s) if c.convolution_mode == ConvolutionMode.Same
                    else [(pi, pi) for pi in p])
            xn = pad_nchw(x.permute(0, 3, 1, 2), pads, float("-inf"))
            if self.record:
                y, idx = F.max_pool2d(xn, k, s, return_indices=True)
                self.pool[name] = idx.cpu()
            else:
                idx = self.pool[name].to(x.device)
                y = xn.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
            return y.permute(0, 2, 3, 1)
        return forward
