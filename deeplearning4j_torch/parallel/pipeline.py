"""Pipeline parallelism: the GPipe microbatch schedule over a ``pipe`` axis.

Counterpart of ``deeplearning4j_tpu/parallel/pipeline.py``. The JAX module
runs the schedule as one ``lax.scan`` of M + S - 1 ticks inside
``shard_map``, hands activations to the next stage with ``ppermute`` and
gets the reverse schedule from AD of the scan. Here a stage is a slot of
the mesh's ``pipe`` axis (``mesh.py``: slots may share a card) and the
ticks run eagerly in the same order: at tick t, stage s runs microbatch
t - s, and its output moves to stage s + 1's device for tick t + 1. A
bubble tick (t - s outside [0, M)) launches nothing; the JAX scan computes
those ticks on zero buffers and discards them (``:114-133``). The backward
is autograd over the graph the ticks recorded, so each stage's gradient is
the sum over its microbatches, as in JAX.

:func:`spmd_pipeline` and :class:`GPipe` are the functional API: stage
parameters stacked on a leading stage axis (:func:`stack_stage_params`),
each stage's slice moved to its slot. The container trainers
(:class:`PipelinedNetwork`, :class:`PipelinedGraph`, through
:func:`pipeline_parallel_step`) work on a copy of the network whose body
layers sit on their stage's slot: each stage holds its layers' parameters
and updater state there, and the copy's own seam applies the update
(``_grads`` -> ``_apply_update``: the minimize flip, gradient
normalization grouped per layer, the updaters, then the constraints).
``export_params``/``export_states`` give the container's layout back.

Semantics carried over from the JAX module (``:653-685``):

- Batch statistics are per microbatch; layer state (BatchNormalization's
  running statistics, CenterLoss centres) advances only on live ticks, in
  microbatch order, on every partition. Under DP x PP (a ``data`` axis)
  each data shard of a microbatch runs the body on its own rows with its
  own copy of the body's state, and the copies are averaged after the
  step (``:140-148``); the shards of a stage run on the stage's slot at
  data coordinate 0, where its parameters live.
- Masks ride the schedule with their microbatch.
- Dropout, weight noise and attention dropout draw from one generator per
  (stage, microbatch, layer) (entry and head count as stages S and S + 1),
  seeded from one draw of the network's step stream: a step is
  deterministic for a given seed and iteration and differs between
  iterations. The port's generators cannot reproduce JAX's keys.
- Auxiliary-loss layers, per-layer updater overrides and preprocessors
  inside the body are refused; ``iterations(n)`` is warned about and
  ignored (one update per ``fit_batch``).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Optional

import torch

from ..nn.conf.dropout import draw_seed
from ..monitor.jitwatch import monitored_jit
from ..nn.multilayer import nchw_to_nhwc
from .mesh import PIPELINE_AXIS, P, record_step, require_axes, tree_map

__all__ = ["PIPELINE_AXIS", "spmd_pipeline", "stack_stage_params", "GPipe",
           "partition_network", "partition_graph", "partition_graph_blocks",
           "PipelinedNetwork", "PipelinedGraph", "pipeline_parallel_step"]

log = logging.getLogger(__name__)

_MASK64 = (1 << 64) - 1


def _mix(seed: int, *idx: int) -> int:
    """A 63-bit seed from ``seed`` and indices (splitmix64 steps): the
    generator of one (stage, microbatch, layer)."""
    z = int(seed) & _MASK64
    for i in idx:
        z = (z + 0x9E3779B97F4A7C15 + (int(i) & _MASK64)) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z & ((1 << 63) - 1)


def _stream(seed: Optional[int], *idx: int) -> Optional[torch.Generator]:
    if seed is None:
        return None
    return torch.Generator().manual_seed(_mix(seed, *idx))


def _live(t: int, S: int, M: int):
    """(stage, microbatch) pairs that tick ``t`` runs: stage s holds
    microbatch t - s while that is in [0, M)."""
    return [(s, t - s) for s in range(S) if 0 <= t - s < M]


def _rows(x, d: int, D: int):
    """Data shard ``d`` of ``D`` of a microbatch's rows (None passes)."""
    if x is None or D == 1:
        return x
    n = x.shape[0] // D
    return x[d * n:(d + 1) * n]


def _to(x, dev):
    return None if x is None else x.to(dev)


def _ticks(devs, D, feeds, masks, call):
    """The GPipe schedule over the stage slots ``devs``: at tick t, stage s
    runs microbatch m = t - s (``call(s, m, d, x, mask)`` for each data
    shard d of ``D``, on stage s's device) and hands its output to stage
    s + 1 for the next tick; ticks outside [0, M) run nothing. ``feeds[m]``
    and ``masks[m]`` (or None) are microbatch m's input and mask. Returns
    the last stage's outputs by microbatch, on stage 0's device."""
    S, M = len(devs), len(feeds)
    carry, ys = {}, [[None] * D for _ in range(M)]
    for t in range(M + S - 1):
        for s, m in _live(t, S, M):
            for d in range(D):
                x = _rows(feeds[m], d, D).to(devs[0]) if s == 0 else carry.pop((s, m, d))
                y = call(s, m, d, x, _to(_rows(masks[m], d, D), devs[s]))
                if s + 1 < S:
                    carry[(s + 1, m, d)] = y.to(devs[s + 1])
                else:
                    ys[m][d] = y.to(devs[0])
    return [torch.cat(parts) if D > 1 else parts[0] for parts in ys]


def stack_stage_params(per_stage_params) -> Any:
    """Stack a list of S identical trees along a new leading stage axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)


def spmd_pipeline(stage_fn: Callable[..., Any], mesh, axis: str = PIPELINE_AXIS,
                  data_axis: Optional[str] = None, squeeze_stage: bool = True,
                  stateful: bool = False, with_masks: bool = False,
                  with_rng: bool = False):
    """Build ``pipelined(stacked_params, xs) -> ys`` or, with ``stateful``,
    ``pipelined(stacked_params, stacked_state, xs) -> (ys, new_state)``.

    ``stacked_params`` (and the state) carry a leading dim of S =
    ``mesh.shape[axis]`` (``squeeze_stage``: stage s gets ``p[s]``) or a
    multiple of S (stage s gets its contiguous slice, several layers a
    stage). ``xs`` is [M, mb, ...]; ``stage_fn(params, x[, mask][, gen])``
    (``stage_fn(params, state, x, ...) -> (y, new_state)`` when stateful)
    maps [mb, F] to [mb, F] on the stage's device. ``with_masks`` adds a
    ``masks`` argument ([M, mb, ...]: each microbatch's mask rides with
    it), ``with_rng`` an int ``seed`` from which each (stage, microbatch)
    gets its own ``torch.Generator``. Returns the last stage's outputs
    [M, mb, ...] on stage 0's device. With ``data_axis`` each microbatch's
    rows split over that axis's extent; each shard runs its own copy of the
    state, and the copies are averaged at the end."""
    require_axes(mesh, (axis, data_axis), style="spmd_pipeline")
    S = mesh.shape[axis]
    D = mesh.shape[data_axis] if data_axis else 1
    devs = mesh.axis_devices(axis)

    def slice_of(tree, s):
        def one(q):
            k = q.shape[0] // S
            part = q[s] if squeeze_stage else q[s * k:(s + 1) * k]
            return part.to(devs[s])
        return tree_map(one, tree)

    def pipelined(params, *rest):
        i = 0
        state = rest[i] if stateful else None
        i += int(stateful)
        xs = rest[i]
        i += 1
        masks = rest[i] if with_masks else None
        i += int(with_masks)
        seed = rest[i] if with_rng else None
        if isinstance(seed, torch.Generator):
            seed = draw_seed(seed)
        M = xs.shape[0]
        p_s = [slice_of(params, s) for s in range(S)]
        st = [[slice_of(state, s) for _ in range(D)] for s in range(S)] if stateful else None

        def call(s, m, d, x, mask):
            args = [x] + ([mask] if with_masks else []) + (
                [_stream(seed, s, m, d)] if with_rng else [])
            if not stateful:
                return stage_fn(p_s[s], *args)
            y, st[s][d] = stage_fn(p_s[s], st[s][d], *args)
            return y
        out = torch.stack(_ticks(devs, D, list(xs), [None] * M if masks is None else list(masks),
                                 call))
        if not stateful:
            return out
        fin = [tree_map(lambda *c: sum(c) / len(c) if D > 1 else c[0], *st[s])
               for s in range(S)]
        new_state = (stack_stage_params(fin) if squeeze_stage
                     else tree_map(lambda *c: torch.cat(c), *fin))
        return out, new_state

    return pipelined


class GPipe:
    """GPipe trainer over a homogeneous body and a head: ``block_fn(params,
    x) -> x`` is one stage, ``head_fn(head, feats, labels)`` the scalar
    mean loss of a microbatch; ``params`` is ``{"blocks": stacked [S, ...],
    "head": tree}``. ``train_step`` runs the pipelined forward, autograd's
    backward, the updater and ``p - u``."""

    def __init__(self, block_fn, head_fn, mesh, n_microbatches: int, updater,
                 axis: str = PIPELINE_AXIS, data_axis: Optional[str] = None):
        require_axes(mesh, (axis, data_axis), style="GPipe")
        record_step("pipeline/gpipe", mesh, {"blocks": P(axis), "head": P()})
        self.mesh = mesh
        self.axis = axis
        self.data_axis = data_axis
        self.n_microbatches = int(n_microbatches)
        self.updater = updater
        self._pipeline = spmd_pipeline(block_fn, mesh, axis, data_axis)
        self._head_fn = head_fn

    def place(self, params, upd_state=None):
        """Copies of ``params`` (and the updater state) on stage 0's slot,
        where the head runs; each stage's slice moves to its slot in the
        step."""
        dev = self.mesh.axis_devices(self.axis)[0]

        def put(tree):
            return tree_map(lambda p: torch.as_tensor(p).detach().to(dev).clone(), tree)
        return put(params) if upd_state is None else (put(params), put(upd_state))

    @monitored_jit(name="pipeline/step")
    def train_step(self, params, upd_state, iteration, x, y):
        """One pipelined step: ``(params, upd_state, loss)``."""
        M = self.n_microbatches
        dev = self.mesh.axis_devices(self.axis)[0]
        x = torch.as_tensor(x).to(dev)
        y = torch.as_tensor(y).to(dev)
        if x.shape[0] % M:
            raise ValueError(f"batch {x.shape[0]} does not split into {M} microbatches")
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        x_mb = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
        y_mb = y.reshape((M, y.shape[0] // M) + tuple(y.shape[1:]))
        feats = self._pipeline(live["blocks"], x_mb)
        loss = torch.stack([self._head_fn(live["head"], feats[m], y_mb[m])
                            for m in range(M)]).mean()
        flat = []
        tree_map(flat.append, live)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(gs)
        grads = tree_map(lambda p: (lambda g: torch.zeros_like(p) if g is None else g)(next(it)),
                         live)
        updates, new_state = self.updater.apply(upd_state, grads, int(iteration))
        new_params = tree_map(lambda p, u: (p - u.to(p.dtype)).detach(), live, updates)
        return new_params, new_state, loss.detach()


# ---------------------------------------------------------------------------
# Container-level pipeline parallelism
# ---------------------------------------------------------------------------
def _layer_confs_equal(a, b):
    return type(a) is type(b) and dataclasses.asdict(a) == dataclasses.asdict(b)


def _best_periodic_run(confs, n_stages: int, max_period: int):
    """Longest lag-p periodic run over a list of layer configs, trimmed to a
    multiple of ``p * n_stages``: (offset, usable_len, period), usable_len 0
    when nothing fits. Smaller periods win ties."""
    n = len(confs)
    best = (0, 0, 1)
    for p in range(1, max(1, min(max_period, n // max(1, n_stages))) + 1):
        j = 0
        while j + p < n:
            if not _layer_confs_equal(confs[j], confs[j + p]):
                j += 1
                continue
            a = j
            while j + p < n and _layer_confs_equal(confs[j], confs[j + p]):
                j += 1
            run = (j + p) - a
            usable = (run // (p * n_stages)) * (p * n_stages)
            if usable > best[1]:
                best = (a, usable, p)
    return best


def partition_network(net, n_stages: int, max_period: int = 8):
    """``(start, length, period)`` of the body to pipeline: the longest
    periodic run of layer configs (``layers[j] == layers[j + period]``)
    trimmed to a multiple of ``period * n_stages``. Period 1 is a stack of
    identical layers (LSTM cells), period p a stack of repeated blocks.
    Before the run is the entry, after it the head."""
    start, body, period = _best_periodic_run(net.conf.layers, n_stages, max_period)
    if body < n_stages:
        raise ValueError(
            f"No periodic run of >= {n_stages} repeated layers/blocks to map onto "
            f"{n_stages} pipeline stages (best: {body} layers at {start}). Stack "
            f"identical middle layers or blocks (e.g. TextGenerationLSTM(num_layers=...)) "
            f"or use fewer stages.")
    return start, body, period


def _graph_consumers(conf):
    """vertex/input name -> the vertices consuming it."""
    consumers = {}
    for name, ins in conf.vertex_inputs.items():
        for i in ins:
            consumers.setdefault(i, []).append(name)
    return consumers


def partition_graph(cg, n_stages: int, max_period: int = 8):
    """The best pipelinable chain of layer vertices of a ComputationGraph:
    a maximal path of single-input layer vertices whose interior vertices
    have one consumer and none of which is an output or has a
    preprocessor, trimmed to its longest lag-p periodic run. Returns
    (chain names, period)."""
    from ..nn.conf.layers import Layer

    conf = cg.conf
    consumers = _graph_consumers(conf)

    def chainable(name):
        v = conf.vertices.get(name)
        return (isinstance(v, Layer) and len(conf.vertex_inputs.get(name, ())) == 1
                and name not in conf.network_outputs
                and conf.input_preprocessors.get(name) is None)

    chains, seen = [], set()
    for name in cg.topo:
        if name in seen or not chainable(name):
            continue
        prev = conf.vertex_inputs[name][0]
        if chainable(prev) and consumers.get(prev, []) == [name]:
            continue
        chain, cur = [name], name
        seen.add(name)
        while True:
            cons = consumers.get(cur, [])
            if len(cons) != 1 or not chainable(cons[0]):
                break
            cur = cons[0]
            chain.append(cur)
            seen.add(cur)
        chains.append(chain)

    best = None
    for chain in chains:
        confs = [conf.vertices[n] for n in chain]
        off, ln, p = _best_periodic_run(confs, n_stages, max_period)
        if ln >= n_stages and (best is None or ln > len(best[0])):
            best = (chain[off:off + ln], p)
    if best is None:
        raise ValueError(
            f"No periodic chain of >= {n_stages} repeated layer vertices to map onto "
            f"{n_stages} pipeline stages. Pipeline-parallel CGs need a linear run of "
            f"repeated single-input layer vertices (e.g. stacked transformer blocks); "
            f"use fewer stages or restructure the graph.")
    return best


def _vertex_eq(a, b):
    return type(a) is type(b) and a == b


def partition_graph_blocks(cg, n_stages: int, max_block: int = 16):
    """Repeated single-input, single-output subgraph windows along the
    topological order (the residual transformer: ``x + Attn(LN(x)); x +
    FFN(LN(x))``, whose skip connections the chain rule cannot express).
    Windows ``W_r = topo[s + r*p : s + (r+1)*p]`` qualify when their vertex
    configs match offset by offset, each vertex's inputs sit at the same
    relative places (an in-window offset, or the window's one external
    input: the previous window's last vertex), and only the last offset
    feeds anything outside. Returns (body names, period, template), the
    template a per-offset ``(is_layer, rel_inputs)`` with ``("ext",)`` or
    ``("in", offset)`` entries."""
    from ..nn.conf.layers import Layer

    conf = cg.conf
    topo = list(cg.topo)
    consumers = _graph_consumers(conf)
    n = len(topo)

    def window_tmpl(s, p, r, ext):
        base = s + r * p
        if base + p > n:
            return None
        names = topo[base:base + p]
        index = {nm: j for j, nm in enumerate(names)}
        tmpl = []
        for j, nm in enumerate(names):
            v = conf.vertices.get(nm)
            if (v is None or nm in conf.network_outputs
                    or conf.input_preprocessors.get(nm) is not None):
                return None
            rel = []
            for i_name in conf.vertex_inputs.get(nm, ()):
                if i_name in index:
                    if index[i_name] >= j:
                        return None
                    rel.append(("in", index[i_name]))
                elif i_name == ext:
                    rel.append(("ext",))
                else:
                    return None
            if j < p - 1 and any(c not in index for c in consumers.get(nm, ())):
                return None
            tmpl.append((isinstance(v, Layer), tuple(rel)))
        return tmpl

    def spine_pure(s, p, r):
        last = topo[s + r * p + p - 1]
        nxt = set(topo[s + (r + 1) * p:s + (r + 2) * p])
        return all(c in nxt for c in consumers.get(last, ()))

    best = None                               # (start, period, R, template)
    for p in range(1, max_block + 1):
        for s in range(n - p * n_stages + 1):
            names0 = set(topo[s:s + p])
            refs = {i for nm in topo[s:s + p] for i in conf.vertex_inputs.get(nm, ())
                    if i not in names0}
            if len(refs) != 1:
                continue
            ext0 = next(iter(refs))
            tmpl = window_tmpl(s, p, 0, ext0)
            if not tmpl or not any(("ext",) in rel for _, rel in tmpl):
                continue
            R = 1
            while spine_pure(s, p, R - 1):
                base = s + R * p
                t2 = window_tmpl(s, p, R, topo[base - 1])
                if (t2 != tmpl or not all(
                        _vertex_eq(conf.vertices[topo[s + j]], conf.vertices[topo[base + j]])
                        for j in range(p))):
                    break
                R += 1
            R = (R // n_stages) * n_stages
            if R >= n_stages and R * p > (0 if best is None else best[2] * best[1]):
                best = (s, p, R, tmpl)
    if best is None:
        raise ValueError(
            f"No repeated single-input/single-output block pattern of >= {n_stages} "
            f"repeats found to map onto {n_stages} pipeline stages; stack identical "
            f"blocks (e.g. TransformerLM(num_blocks=...)) or use fewer stages.")
    s, p, R, tmpl = best
    return topo[s:s + R * p], p, tmpl


def _install_state(impl, state):
    """The layer's state buffers replaced by new tensors (not written in
    place: the autograd graph of earlier microbatches may hold the old
    ones)."""
    for name, t in state.items():
        impl._buffers[name] = t.detach()


def _add(total, term, dev):
    if isinstance(term, torch.Tensor):
        term = term.to(dev)
    return total + term


class _PipelinedBase:
    """Shared machinery of :class:`PipelinedNetwork` and
    :class:`PipelinedGraph`: the copy of the network with its body on the
    stage slots, the schedule of the body, layer state per data shard, the
    per-(stage, microbatch, layer) generators, the step and the export."""

    def _init_common(self, net, mesh, n_microbatches, axis, data_axis):
        require_axes(mesh, (axis, data_axis), style=type(self).__name__)
        record_step("pipeline/" + type(self).__name__, mesh,
                    {"entry": P(), "blocks": P(axis), "head": P()})
        if int(getattr(net.gc, "iterations", 1) or 1) > 1:
            log.warning("iterations(%s) is ignored under %s; each fit_batch applies one "
                        "optimizer iteration", net.gc.iterations, type(self).__name__)
        self.net = net
        self.mesh = mesh
        self.axis = axis
        self.data_axis = data_axis
        self.n_microbatches = int(n_microbatches)
        self.n_stages = mesh.shape[axis]
        self.n_data = mesh.shape[data_axis] if data_axis else 1
        self.stage_devices = mesh.axis_devices(axis)
        self.updater = net.gc.updater
        self.iteration_count = 0
        self._shard_states = {}
        self._start_states = {}

    def _check_layer_conf(self, where, lc):
        if getattr(lc, "updater", None) is not None:
            raise ValueError(f"{where} sets a per-layer updater override; the pipelined "
                             f"step trains every partition with the network-level updater")
        if getattr(lc, "aux_loss_weight", 0.0):
            raise ValueError(
                f"{where} ({type(lc).__name__}) produces an activation-dependent auxiliary "
                f"loss (aux_loss_weight={lc.aux_loss_weight}); the pipelined step does not "
                f"collect ctx['aux_loss']: set aux_loss_weight=0 or train unpipelined")

    def _place(self, model, stage_keys):
        """Move each stage's layers to its slot, entry and head to stage 0's,
        then start the updater state there (the JAX trainer's fresh
        ``init_state`` of its partitioned tree)."""
        layers = model._layers()
        for k, impl in layers.items():
            impl.to(self.stage_devices[0])
        for s, keys in enumerate(stage_keys):
            for k in keys:
                if k in layers:
                    layers[k].to(self.stage_devices[s])
        model.device = self.stage_devices[0]
        model.updater_state = model.updater.init_state(model.params)
        self.model = model

    # -- the body schedule -------------------------------------------------
    def _run_layer(self, impl, x, mask, ctx, gen, shard=None):
        """One training forward of a layer with its generator; the layer's
        new state (BatchNormalization's running statistics) becomes its
        state for the next microbatch. A body layer under a data axis runs
        data shard ``shard``'s copy of the state."""
        key = (id(impl), shard)
        if shard is not None and self.n_data > 1:
            if key not in self._shard_states:
                # every shard starts from the state the step started with
                start = self._start_states.setdefault(id(impl), impl.layer_state())
                self._shard_states[key] = dict(start)
            _install_state(impl, self._shard_states[key])
        ctx["rng"] = gen
        ctx["new_states"] = ns = {}
        y = impl.noised_forward(x, mask, ctx)
        for st in ns.values():
            _install_state(impl, st)
            if shard is not None and self.n_data > 1:
                self._shard_states[key] = {k: t.detach() for k, t in st.items()}
        ctx.pop("rng", None)
        ctx.pop("new_states", None)
        return y

    def _gen(self, impl, seed, *idx):
        """The generator of one (stage, microbatch, layer), made only for a
        layer that draws."""
        return _stream(seed, *idx) if impl.draws() else None

    def _reconcile_shard_states(self):
        """Average each body layer's per-shard state over the data shards
        and install it (the JAX step's ``pmean`` over ``data``)."""
        by_impl = {}
        for (iid, d), st in self._shard_states.items():
            by_impl.setdefault(iid, []).append(st)
        impls = {id(im): im for im in self.model._layers().values()}
        for iid, states in by_impl.items():
            avg = {k: sum(st[k] for st in states) / len(states) for k in states[0]}
            _install_state(impls[iid], avg)
        self._shard_states = {}
        self._start_states = {}

    def _microbatches(self, t):
        M = self.n_microbatches
        if t is None:
            return [None] * M
        if t.shape[0] % M:
            raise ValueError(f"batch {t.shape[0]} does not split into {M} microbatches")
        mb = t.shape[0] // M
        if mb % self.n_data:
            raise ValueError(f"microbatch {mb} does not split over {self.n_data} data shards")
        return list(torch.split(t, mb))

    def _regularization(self, loss):
        reg = 0.0
        for impl in self.model._layers().values():
            reg = _add(reg, impl.regularization(), loss.device)
        return reg

    def _finish_step(self, loss):
        """Gradients of the step's loss -> the copy's update; the loss."""
        model = self.model
        if self.n_data > 1:
            self._reconcile_shard_states()
        grads = model._grads(loss, skip=model._idle_frozen())
        model._apply_update(grads, self.iteration_count)
        self.iteration_count += 1
        return loss.detach()

    # -- container-layout export ------------------------------------------
    def export_params(self):
        """The trained parameters in the container's keying (layer index
        or vertex name), detached copies."""
        return {k: tree_map(lambda t: t.detach().clone(), v) for k, v in self.model.params.items()}

    def export_states(self):
        """The layers' state (BatchNormalization's running statistics ...)
        in the container's keying."""
        return {k: {n: t.detach().clone() for n, t in v.items()}
                for k, v in self.model.states.items()}


class PipelinedNetwork(_PipelinedBase):
    """A ``MultiLayerNetwork``'s homogeneous middle trained as GPipe stages.
    :func:`partition_network` splits the network into entry | body | head;
    the body's B layers (period p) go R/S repeats a stage, the entry and
    head stay on stage 0's slot and run per microbatch. Masks ([b, T]
    feature and label masks) ride the schedule; the loss is the mean of the
    microbatches' losses plus L1/L2, as the container's."""

    def __init__(self, net, mesh, n_microbatches: int, axis: str = PIPELINE_AXIS,
                 data_axis: Optional[str] = None):
        if not hasattr(net.conf, "layers"):
            raise ValueError("PipelinedNetwork supports MultiLayerNetwork; "
                             "ComputationGraph pipelines via PipelinedGraph")
        for i, lc in enumerate(net.conf.layers):
            self._check_layer_conf(f"layer {i}", lc)
        self._init_common(net, mesh, n_microbatches, axis, data_axis)
        S = self.n_stages
        self.start, self.body_len, self.period = partition_network(net, S)
        self.layers_per_stage = self.body_len // S
        self.repeats_per_stage = self.layers_per_stage // self.period
        for i in range(self.start, self.start + self.body_len):
            if net.conf.preprocessor(i) is not None:
                raise ValueError("preprocessors inside the pipelined body are not supported")
        model = net.clone()
        self._place(model, [[str(self.start + s * self.layers_per_stage + j)
                             for j in range(self.layers_per_stage)] for s in range(S)])
        self.body_impls = [model.impls[self.start + l] for l in range(self.period)]

    def _stage_call(self, seed):
        model = self.model

        def call(s, m, d, x, mask):
            for j in range(self.repeats_per_stage):
                for l in range(self.period):
                    i = self.start + (s * self.repeats_per_stage + j) * self.period + l
                    impl = model.impls[i]
                    x = self._run_layer(impl, x, mask, {"train": True},
                                        self._gen(impl, seed, s, m, j * self.period + l), shard=d)
            return x
        return call

    @monitored_jit(name="pipeline/container_step")
    def fit_batch(self, f, l, features_mask=None, labels_mask=None):
        """One pipelined step on a (features, labels) batch whose leading
        dim splits into ``n_microbatches`` equal chunks; convolutional
        features arrive NCHW, as in ``MultiLayerNetwork.fit``. Returns the
        loss (a 0-d tensor)."""
        model, S = self.model, self.n_stages
        s, b = self.start, self.body_len
        n = len(model.impls)
        f = nchw_to_nhwc(model._to_device(f), model.conf.input_type)
        l = model._to_device(l)
        fm = None if features_mask is None else model._to_device(features_mask)
        lm = None if labels_mask is None else model._to_device(labels_mask)
        f_mb, l_mb = self._microbatches(f), self._microbatches(l)
        fm_mb, lm_mb = self._microbatches(fm), self._microbatches(lm)
        M = len(f_mb)
        seed = draw_seed(model._gen)
        conf = model.conf

        # entry: per microbatch, state threading in microbatch order
        entry, ctxs = [], []
        for m in range(M):
            x, ctx = f_mb[m], {"train": True}
            for i in range(s):
                pre = conf.preprocessor(i)
                if pre is not None:
                    x = pre(x, ctx)
                impl = model.impls[i]
                x = self._run_layer(impl, x, fm_mb[m], ctx, self._gen(impl, seed, S, m, i))
            entry.append(x)
            ctxs.append(ctx)
        feats = _ticks(self.stage_devices, self.n_data, entry, fm_mb, self._stage_call(seed))
        # head and the output layer's loss, per microbatch
        out_impl = model.impls[n - 1]
        losses = []
        for m in range(M):
            x, ctx = feats[m], ctxs[m]
            for i in range(s + b, n - 1):
                pre = conf.preprocessor(i)
                if pre is not None:
                    x = pre(x, ctx)
                impl = model.impls[i]
                x = self._run_layer(impl, x, fm_mb[m], ctx, self._gen(impl, seed, S + 1, m, i))
            pre = conf.preprocessor(n - 1)
            if pre is not None:
                x = pre(x, ctx)
            mask = lm_mb[m] if lm_mb[m] is not None else (fm_mb[m] if x.dim() == 3 else None)
            losses.append(out_impl.loss_on(x, l_mb[m], mask=mask, train=True,
                                           gen=_stream(seed, S + 1, m, n - 1)))
            if hasattr(out_impl, "update_state"):
                _install_state(out_impl, out_impl.update_state(x, l_mb[m]))
        loss = torch.stack(losses).mean()
        return self._finish_step(loss + self._regularization(loss))


class PipelinedGraph(_PipelinedBase):
    """Pipeline-parallel training of a ``ComputationGraph``: the best
    periodic chain of single-input layer vertices (:func:`partition_graph`)
    or, failing that, the best run of repeated residual blocks
    (:func:`partition_graph_blocks`) becomes the body; everything
    downstream of its end is the head and the rest the entry, so skip
    connections around the body and several inputs and outputs work.
    Losses are the container's multi-output sum with the fused-softmax skip;
    masks propagate by ``ComputationGraph._apply_graph``'s rules."""

    def __init__(self, net, mesh, n_microbatches: int, axis: str = PIPELINE_AXIS,
                 data_axis: Optional[str] = None):
        from ..nn.conf.graph import GraphVertexConf, MergeVertex
        from ..nn.conf.layers import Layer
        from ..nn.graph import ComputationGraph, fused_softmax_skip_set

        conf = net.conf
        if not hasattr(conf, "vertices"):
            raise ValueError("PipelinedGraph needs a ComputationGraph")
        for name, v in conf.vertices.items():
            if isinstance(v, Layer):
                self._check_layer_conf(f"vertex '{name}'", v)
        self._init_common(net, mesh, n_microbatches, axis, data_axis)
        try:
            self.body, self.period = partition_graph(net, self.n_stages)
            self.body_tmpl = None
        except ValueError as chain_err:
            try:
                self.body, self.period, self.body_tmpl = partition_graph_blocks(
                    net, self.n_stages)
            except ValueError as block_err:
                raise ValueError(f"Neither pipelining rule fits this graph.\n"
                                 f"- linear chain: {chain_err}\n"
                                 f"- block pattern: {block_err}") from block_err
        self.body_len = len(self.body)
        self.layers_per_stage = self.body_len // self.n_stages
        self.repeats_per_stage = self.layers_per_stage // self.period
        self._block_masks_ok = self.body_tmpl is None or all(
            is_layer or type(conf.vertices[self.body[off]]).propagate_mask
            in (GraphVertexConf.propagate_mask, MergeVertex.propagate_mask)
            for off, (is_layer, _) in enumerate(self.body_tmpl))
        body_set = set(self.body)
        consumers = _graph_consumers(conf)
        reach, stack = set(), [self.body[-1]]
        while stack:
            for c in consumers.get(stack.pop(), ()):
                if c not in reach:
                    reach.add(c)
                    stack.append(c)
        self.head_names = [n for n in net.topo if n in reach and n not in body_set]
        self.entry_names = [n for n in net.topo if n not in reach and n not in body_set]
        self.body_input = conf.vertex_inputs[self.body[0]][0]
        self._skip_outputs = fused_softmax_skip_set(conf, net.impls)
        self._entry_outputs = frozenset(n for n in conf.network_outputs
                                        if n not in reach and n not in body_set)
        for n in self._entry_outputs:
            impl = net.impls[n] if n in net.impls else None
            if impl is not None and hasattr(impl, "update_state") and impl.layer_state():
                raise ValueError(f"auxiliary output '{n}' on the entry side carries running "
                                 f"state (update_state); train unpipelined or restructure so "
                                 f"it sits downstream of the body")
        model = ComputationGraph(conf.clone()).init(params=net.params, device=net.device,
                                                    states=net.states)
        L = self.layers_per_stage
        self._place(model, [self.body[s * L:(s + 1) * L] for s in range(self.n_stages)])
        self.body_impls = [model.impls[n] if n in model.impls else None
                           for n in self.body[:self.period]]

    def _stage_call(self, seed):
        model, conf, p = self.model, self.model.conf, self.period

        def call(s, m, d, x, mask):
            for j in range(self.repeats_per_stage):
                base = (s * self.repeats_per_stage + j) * p
                if self.body_tmpl is None:
                    for off in range(p):
                        impl = model.impls[self.body[base + off]]
                        x = self._run_layer(impl, x, mask, {"train": True},
                                            self._gen(impl, seed, s, m, j * p + off), shard=d)
                    continue
                vals = {}
                for off, (is_layer, rel) in enumerate(self.body_tmpl):
                    xs = [x if r[0] == "ext" else vals[r[1]] for r in rel]
                    name = self.body[base + off]
                    if is_layer:
                        impl = model.impls[name]
                        vals[off] = self._run_layer(
                            impl, xs[0], mask, {"train": True},
                            self._gen(impl, seed, s, m, j * p + off), shard=d)
                    else:
                        vals[off] = conf.vertices[name].forward(xs, {"train": True})
                x = vals[p - 1]
            return x
        return call

    def _apply_vertices(self, names, acts, masks, ctx, seed, stage, m):
        """Run ``names`` (topologically ordered) over ``acts``, propagating
        masks as ``ComputationGraph._apply_graph`` does; layer vertex at
        position ``pos`` draws from the generator (stage, m, pos)."""
        from ..nn.conf.layers import Layer

        model, conf = self.model, self.model.conf
        for pos, name in enumerate(names):
            if name in self._skip_outputs:
                continue
            v = conf.vertices[name]
            in_names = conf.vertex_inputs[name]
            if isinstance(v, Layer):
                x = acts[in_names[0]]
                pre = conf.input_preprocessors.get(name)
                if pre is not None:
                    x = pre(x, ctx)
                mk = masks.get(in_names[0])
                impl = model.impls[name]
                acts[name] = self._run_layer(impl, x, mk, ctx, self._gen(impl, seed, stage, m, pos))
                masks[name] = mk
            else:
                acts[name] = v.forward([acts[i] for i in in_names], ctx)
                masks[name] = v.propagate_mask([masks.get(i) for i in in_names])

    @monitored_jit(name="pipeline/container_step")
    def fit_batch(self, inputs, labels, features_mask=None, labels_mask=None):
        """One pipelined step; ``inputs``/``labels`` are tuples of arrays
        (one array is wrapped), ``features_mask``/``labels_mask`` one [b, T]
        mask per input/output. Convolutional inputs arrive NCHW. Returns the
        loss (a 0-d tensor)."""
        def as_tuple(t):
            return None if t is None else (tuple(t) if isinstance(t, (tuple, list)) else (t,))

        model, conf = self.model, self.model.conf
        inputs, labels = as_tuple(inputs), as_tuple(labels)
        fm, lm = as_tuple(features_mask), as_tuple(labels_mask)
        if (fm is not None or lm is not None) and not self._block_masks_ok:
            raise ValueError("this pipelined body contains a vertex whose mask propagation "
                             "is not the identity (Stack/Unstack/Reshape class); masked "
                             "training through the block pipeline would silently diverge: "
                             "train unpipelined")
        if fm is not None and len(fm) != len(conf.network_inputs):
            raise ValueError(f"features_mask needs one entry per network input "
                             f"({len(conf.network_inputs)})")
        if lm is not None and len(lm) != len(conf.network_outputs):
            raise ValueError(f"labels_mask needs one entry per network output "
                             f"({len(conf.network_outputs)})")
        put = model._to_device
        in_mb = [self._microbatches(put(x)) for x in inputs]
        lab_mb = [self._microbatches(put(y)) for y in labels]
        fm_mb = [self._microbatches(None if a is None else put(a))
                 for a in (fm or [None] * len(inputs))]
        lm_mb = [self._microbatches(None if a is None else put(a))
                 for a in (lm or [None] * len(labels))]
        M, S = self.n_microbatches, self.n_stages
        seed = draw_seed(model._gen)

        entry = []
        for m in range(M):
            acts, masks, ctx = model._forward_context(
                [x[m] for x in in_mb], [a[m] for a in fm_mb], True, None, None)
            self._apply_vertices(self.entry_names, acts, masks, ctx, seed, S, m)
            entry.append((acts, masks, ctx))
        body_masks = [e[1].get(self.body_input) for e in entry]
        feats = _ticks(self.stage_devices, self.n_data, [e[0][self.body_input] for e in entry],
                       body_masks, self._stage_call(seed))
        totals = []
        for m in range(M):
            acts, masks, ctx = entry[m]
            acts[self.body[-1]] = feats[m]
            masks[self.body[-1]] = masks.get(self.body_input)
            self._apply_vertices(self.head_names, acts, masks, ctx, seed, S + 1, m)
            total = 0.0
            for oi, out_name in enumerate(conf.network_outputs):
                impl = model.impls[out_name] if out_name in model.impls else None
                if impl is None or not hasattr(impl, "loss_on"):
                    raise ValueError(f"Output vertex '{out_name}' is not an output layer")
                in_name = conf.vertex_inputs[out_name][0]
                x = acts[in_name]
                pre = conf.input_preprocessors.get(out_name)
                if pre is not None:
                    x = pre(x, ctx)
                lbl = lab_mb[oi][m]
                lmk = lm_mb[oi][m]
                mask = lmk if lmk is not None else (masks.get(in_name) if x.dim() == 3 else None)
                total = total + impl.loss_on(
                    x, lbl, mask=mask, train=True,
                    gen=_stream(seed, S + 1, m, len(self.head_names) + oi))
                if out_name not in self._entry_outputs and hasattr(impl, "update_state"):
                    _install_state(impl, impl.update_state(x, lbl))
            totals.append(total)
        loss = torch.stack(totals).mean()
        return self._finish_step(loss + self._regularization(loss))


def pipeline_parallel_step(net, mesh, n_microbatches: int = 4, axis: str = PIPELINE_AXIS,
                           data_axis: Optional[str] = None):
    """Partition ``net``'s homogeneous middle into GPipe stages over
    ``mesh[axis]``: a :class:`PipelinedNetwork` (MultiLayerNetwork) or a
    :class:`PipelinedGraph` (ComputationGraph) ready to ``fit_batch``. The
    reference has no pipeline parallelism (SURVEY.md section 2.4): this is
    the ``pp`` member of the dp/tp/pp/sp/ep family."""
    if hasattr(net.conf, "vertices"):
        return PipelinedGraph(net, mesh, n_microbatches, axis, data_axis)
    return PipelinedNetwork(net, mesh, n_microbatches, axis, data_axis)
