"""Numerical gradient checking.

Counterpart of ``deeplearning4j_tpu/nn/gradientcheck.py`` (reference
``GradientCheckUtil``): the central difference ``(f(x + eps) - f(x - eps))
/ 2 eps`` of the training loss, element by element, against autograd's
gradient. As in the reference the network must hold float64 parameters
(build it with ``dtype("float64").compute_dtype("float64")``); run it on
the CPU, where every kernel is its plain version.

The loss is the training loss (batch statistics, regularisation, the
auxiliary losses) with no generator, so dropout and weight noise are off,
as the reference requires of a gradient check. Elements are perturbed in
place and restored; the parameters are visited in sorted key order, the
JAX package's, so ``max_per_param`` samples the same elements from the
same ``seed``.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..monitor.jitwatch import monitored_jit
from ..utils.trees import sorted_leaves

__all__ = ["GradientCheckUtil", "check_gradients", "check_function_gradients"]

log = logging.getLogger(__name__)


def _loss_at(net, ds):
    """The training loss of either container on ``ds`` at its current
    parameters: ``train=True`` and no generator, so dropout and noise stay
    off. The set's arrays are copied to the device once and kept there
    (``CacheMode.DEVICE``'s cache), since a check or a solver evaluates
    the loss many times on them."""
    from .multilayer import MultiLayerNetwork

    if isinstance(net, MultiLayerNetwork):
        f, l, fm, lm = ds.device_arrays(net.device)
        return net._loss_fn(f, l, fm, lm, True)[0]
    inputs, labels, fms, lms = net._streams(ds, cached=True)
    return net._loss_fn(inputs, labels, fms, lms, True)


def _check(leaves, analytic, loss_at, epsilon, max_rel_error, min_abs_error,
           max_per_param, seed, skip=None, on_fail=None):
    """Central differences over ``leaves`` (path, tensor perturbed in place)
    against ``analytic`` {path: numpy gradient}; returns (checked, failed,
    worst relative error)."""
    rng = np.random.default_rng(seed)
    checked = failed = 0
    worst = 0.0
    for name, t in leaves:
        if skip is not None and skip(name):
            continue
        grad = analytic[name].ravel()
        flat_idx = np.arange(t.numel())
        if max_per_param is not None and t.numel() > max_per_param:
            flat_idx = rng.choice(t.numel(), size=max_per_param, replace=False)
        view = t.view(-1)
        for i in flat_idx:
            orig = view[i].item()
            with torch.no_grad():
                view[i] = orig + epsilon
                plus = float(loss_at())
                view[i] = orig - epsilon
                minus = float(loss_at())
                view[i] = orig
            num = (plus - minus) / (2 * epsilon)
            ana = float(grad[i])
            denom = max(abs(num), abs(ana))
            rel = 0.0 if denom == 0 else abs(num - ana) / denom
            checked += 1
            worst = max(worst, rel)
            if not (rel <= max_rel_error
                    or (abs(num) < min_abs_error and abs(ana) < min_abs_error)):
                failed += 1
                msg = (f"Gradient check FAILED {name}[{i}]: numeric={num:.8e} "
                       f"analytic={ana:.8e} relError={rel:.4e}")
                if on_fail is not None:
                    on_fail(msg)
    return checked, failed, worst


def check_function_gradients(loss_fn, params, epsilon: float = 1e-6,
                             max_rel_error: float = 1e-3, min_abs_error: float = 1e-8,
                             max_per_param: Optional[int] = None, seed: int = 12345,
                             expect_zero: Optional[set] = None) -> bool:
    """Central-difference check of a scalar ``loss_fn(params)`` (``params``
    a dict tree of float64 tensors) against its autograd gradient.
    ``expect_zero``: path substrings whose gradient must be exactly zero;
    those tensors skip the numeric comparison."""
    loss_fn = monitored_jit(loss_fn, name="gradientcheck/loss")
    tree = _detached_copy(params)
    leaves = sorted_leaves(tree)
    for _, t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(loss_fn(tree), [t for _, t in leaves], allow_unused=True)
    analytic = {name: (np.zeros(tuple(t.shape)) if g is None
                       else g.detach().cpu().numpy())
                for (name, t), g in zip(leaves, grads)}
    for _, t in leaves:
        t.requires_grad_(False)
    failed = 0
    if expect_zero:
        for name, _ in leaves:
            if any(z in name for z in expect_zero) and np.abs(analytic[name]).max(initial=0.0):
                log.warning("Expected zero gradient for %s, got max %g", name,
                            np.abs(analytic[name]).max())
                failed += 1
    _, bad, _ = _check(leaves, analytic, lambda: loss_fn(tree), epsilon, max_rel_error,
                       min_abs_error, max_per_param, seed,
                       skip=(lambda n: any(z in n for z in expect_zero)) if expect_zero
                       else None, on_fail=log.warning)
    return failed + bad == 0


def _detached_copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return {k: _detached_copy(v) for k, v in tree.items()}


class GradientCheckUtil:
    @staticmethod
    def check_gradients(net, ds, epsilon: float = 1e-6, max_rel_error: float = 1e-3,
                        min_abs_error: float = 1e-8, print_results: bool = False,
                        exit_on_first_error: bool = False,
                        max_per_param: Optional[int] = None, seed: int = 12345,
                        exclude: Optional[set] = None) -> bool:
        """True when every checked element's analytic gradient matches the
        central difference within ``max_rel_error`` (elements where both are
        below ``min_abs_error`` pass). ``max_per_param`` samples that many
        elements of a larger tensor; ``exclude`` skips parameter paths
        ("layer/name") containing any of its strings."""
        leaves = sorted_leaves(net.params)
        dtypes = {t.dtype for _, t in leaves}
        if dtypes - {torch.float64}:
            raise ValueError(
                f"Gradient checks require float64 params (got {dtypes}); build the net "
                f"with dtype='float64', compute_dtype='float64' (reference "
                f"GradientCheckUtil double-precision rule)")
        loss_at = monitored_jit(_loss_at, name="gradientcheck/loss_at")
        grads = net._grads(loss_at(net, ds))
        analytic = {name: g.detach().cpu().numpy() for name, g in sorted_leaves(grads)}

        def fail(msg):
            if print_results:
                log.warning(msg)
            if exit_on_first_error:
                raise AssertionError(msg)

        checked, failed, worst = _check(
            leaves, analytic, lambda: loss_at(net, ds), epsilon, max_rel_error,
            min_abs_error, max_per_param, seed,
            skip=(lambda n: any(x in n for x in exclude)) if exclude else None, on_fail=fail)
        if print_results:
            log.info("Gradient check: %d/%d passed (max relError %.3e)", checked - failed,
                     checked, worst)
        return failed == 0

    checkGradients = check_gradients


check_gradients = GradientCheckUtil.check_gradients
