"""Data-parallel steps over a mesh's slots.

Counterpart of ``deeplearning4j_tpu/parallel/sharding.py``. The JAX
package jits a network's step with sharding annotations and lets XLA's
partitioner insert the gradient ``psum``; here the step is explicit
(:class:`SyncStep`): each slot of the ``data`` axis runs the container's
:meth:`_train_loss` and ``_grads`` on its shard of the global batch (on
the slot's device, through a replica of the network when the slot is
not the network's own device), the gradients are reduced across the
slots in rank order, weighted by each shard's share of the batch (the
losses are sums over the examples divided by the batch size, so this is
the global batch's gradient), and the container's ``_apply_update``
applies them once: one update, the layers' constraints, the layers'
new state (the slots' mean).

Tensor-parallel rules and the ZeRO flags (``shard_update`` for the
updater state, ``shard_params`` for the parameters too) decide what each
slot holds (:func:`composed_specs`, :class:`ShardedModel`): the slot
keeps its block of each parameter and of its updater state on its
device; a step gathers the parameters into the container for the
forward and backward, hands each slot its block of the reduced
gradients, runs the updater there on the slot's block of the state
(every updater of ``nn/updaters.py`` is elementwise, so the blocks give
the bits of the whole) and gathers the updates back. The forward and
backward are not partitioned: they run on gathered parameters, so on one
card the sharding divides the updater state and the update's work among
the slots, not the activations.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..datasets.dataset import to_tensor
from ..nn.multilayer import _detached
from ..optimize.updater import normalize_gradients
from ..utils.trees import leaves
from .mesh import (DATA_AXIS, MODEL_AXIS, SEQUENCE_AXIS, Mesh, MeshSpec, P,
                   batch_sharded, make_mesh, mirror_updater_shardings, record_step,
                   replicated, require_axes, rule_shardings, tree_get, tree_leaves, tree_map,
                   tree_map_path, zero_update_specs)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SEQUENCE_AXIS", "MeshSpec", "make_mesh", "replicated",
           "batch_sharded", "shard_batch", "composed_specs", "data_parallel_step", "SyncStep",
           "ShardedModel", "clone_net", "slot_sum"]


# ------------------------------------------------------------ collectives
def slot_sum(tensors: Sequence[torch.Tensor], device, weights=None) -> torch.Tensor:
    """Sum of per-slot tensors on ``device``, in rank order (so every run
    adds in the same order), each first scaled by its weight if given."""
    total = None
    for i, t in enumerate(tensors):
        t = t.to(device)
        if weights is not None:
            t = t * weights[i]
        total = t if total is None else total + t
    return total


def _split_rows(x, n, devices, dim=0):
    """``x`` split into ``n`` equal chunks along ``dim``, chunk i on
    ``devices[i]``; a tuple of streams (a graph's) splits member-wise into
    per-slot tuples; None gives n Nones."""
    if x is None:
        return [None] * n
    if isinstance(x, (tuple, list)):
        parts = [_split_rows(a, n, devices, dim) for a in x]
        return [tuple(p[i] for p in parts) for i in range(n)]
    size = int(x.shape[dim])
    if size % n:
        raise ValueError(f"batch {size} not divisible by {n} slots")
    return [c.to(d) for c, d in zip(torch.chunk(x, n, dim=dim), devices)]


def _to_dev(x, device):
    if isinstance(x, (tuple, list)):
        return tuple(None if a is None else to_tensor(a, device) for a in x)
    return to_tensor(x, device)


def shard_batch(x, mesh: Mesh, axis: str = DATA_AXIS):
    """A batch with its leading dim split across ``axis``: a list of the
    slots' shards, shard i on the device of slot i along ``axis``."""
    devs = mesh.axis_devices(axis)
    x = to_tensor(x, devs[0]) if not isinstance(x, (tuple, list, type(None))) else x
    return _split_rows(x, mesh.shape[axis], devs)


# ------------------------------------------------------------ replicas
def clone_net(net, device):
    """A replica of ``net`` on ``device``: a copy of its configuration with
    copies of its parameters, layer state and updater state; its own step
    stream, seeded as the network's; no listeners."""
    rep = type(net)(net.conf.clone()).init(params=net.params, device=device,
                                           states=net.states)
    rep.updater_state = tree_map(lambda t: t.to(device, copy=True), net.updater_state)
    rep.iteration_count = net.iteration_count
    return rep


def copy_into(dst, src):
    """``src``'s parameters and layer state copied into ``dst``'s in place."""
    with torch.no_grad():
        for (_, a), (_, b) in zip(leaves(dst._trainable()), leaves(src._trainable())):
            a.copy_(b)
        for (_, a), (_, b) in zip(leaves(dst.states), leaves(src.states)):
            a.copy_(b)


class SlotReplicas:
    """The network each slot computes with: the network itself on its own
    device, else one replica a device whose parameters and layer state
    are refreshed from the network before each use."""

    def __init__(self, net):
        self.net = net
        self._reps: Dict[torch.device, object] = {}

    def on(self, device):
        net = self.net
        if torch.device(device) == net.device:
            return net
        rep = self._reps.get(device)
        if rep is None:
            rep = self._reps[device] = clone_net(net, device)
        else:
            copy_into(rep, net)
        return rep


def _mean_states(states_per_slot, device):
    """The slots' new layer states (BatchNormalization's running
    statistics, CenterLoss's centres) averaged, in rank order."""
    if not states_per_slot or not states_per_slot[0]:
        return states_per_slot[0] if states_per_slot else {}
    n = len(states_per_slot)
    return tree_map(lambda *ts: slot_sum(ts, device) / n, states_per_slot[0],
                    *states_per_slot[1:])


# ----------------------------------------------------------- shardings
def composed_specs(net, mesh: Mesh, axis: str = DATA_AXIS, tp_rules=None,
                   shard_update: bool = False, shard_params: bool = False):
    """``(param_specs, updater_specs)`` Sharding trees: tensor-parallel
    ``tp_rules`` claim their axes first (updater state mirrors its
    parameter), then ZeRO layers the ``axis`` of the same mesh onto the
    remaining dims — ``shard_update`` for the updater state (ZeRO-1),
    ``shard_params`` for the parameters too (ZeRO-3/FSDP)."""
    needed = set()
    if tp_rules:
        needed.update(s for spec in tp_rules.values() if spec is not None
                      for s in tuple(spec) if s is not None)
    if shard_update or shard_params:
        needed.add(axis)
    require_axes(mesh, sorted(needed), style="composed_specs(tp_rules/ZeRO)")
    if tp_rules:
        par = rule_shardings(net.params, mesh, tp_rules)
        upd = mirror_updater_shardings(net.params, net.updater_state, mesh, tp_rules)
    else:
        repl = replicated(mesh)
        par = tree_map(lambda _: repl, net.params)
        upd = tree_map(lambda _: repl, net.updater_state)
    if shard_update:
        upd = zero_update_specs(net.updater_state, mesh, axis, base=upd)
    if shard_params:
        par = zero_update_specs(net.params, mesh, axis, base=par)
    return par, upd


def _block(shape, spec, mesh: Mesh, coords):
    idx = []
    for d, ax in enumerate(tuple(spec)):
        if ax is None:
            idx.append(slice(None))
        else:
            n = mesh.shape[ax]
            c = shape[d] // n
            i = coords[mesh.axis_names.index(ax)]
            idx.append(slice(i * c, (i + 1) * c))
    return tuple(idx)


def _owner(spec, mesh: Mesh, coords) -> bool:
    """Whether the slot at ``coords`` is the one a gather reads its block
    from: coordinate 0 on every axis the spec does not name."""
    named = {a for a in tuple(spec) if a is not None}
    return all(c == 0 for a, c in zip(mesh.axis_names, coords) if a not in named)


def gather_blocks(blocks, spec, mesh: Mesh, shape, device, dtype=None):
    """The whole tensor from the slots' blocks, on ``device``."""
    some = next(iter(blocks.values()))
    out = torch.empty(shape, dtype=dtype or some.dtype, device=device)
    for coords, _ in mesh.slots():
        if _owner(spec, mesh, coords):
            out[_block(tuple(shape), spec, mesh, coords)] = blocks[coords].to(device)
    return out


class ShardedModel:
    """A network's parameters and updater state split over a mesh's slots
    by Sharding trees (``composed_specs``): each slot holds its block of
    every updater-state leaf and, under ``shard_params``, of every
    parameter. :meth:`update` runs the updater slot by slot on the blocks
    and gathers the updates into the network's parameters;
    :meth:`gather_state` puts the whole updater state back on the
    network."""

    def __init__(self, net, mesh: Mesh, par_specs, upd_specs):
        self.net, self.mesh = net, mesh
        self.par_specs, self.upd_specs = par_specs, upd_specs
        self.params_sharded = any(any(s is not None for s in sh.spec)
                                  for sh in tree_leaves(par_specs))
        # each parameter's update is computed on the blocks its updater
        # state is split into (the parameter's own spec when it has none)
        self.update_spec = {}
        st_specs = {}
        tree_map_path(lambda path, sh: st_specs.setdefault(path, sh.spec), upd_specs)
        psh = {}
        tree_map_path(lambda path, sh: psh.setdefault(path, sh.spec), par_specs)
        for path, spec in psh.items():
            mine = {tuple(s) for p, s in st_specs.items() if p.startswith(path + "/") or p == path}
            self.update_spec[path] = P(*next(iter(mine))) if len(mine) == 1 else spec
        self.state = self._split(net.updater_state, upd_specs)
        self.param_blocks = (self._split(net.params, par_specs) if self.params_sharded
                             else None)

    def _split(self, tree, specs):
        """{slot coordinates: ``tree`` with each leaf cut to the slot's
        block (by the leaf's spec in ``specs``), on the slot's device}."""
        mesh = self.mesh
        return {coords: tree_map_path(lambda path, t, c=coords, d=dev: t[_block(
            tuple(t.shape), tree_get(specs, path).spec, mesh, c)].to(d, copy=True), tree)
            for coords, dev in mesh.slots()}

    def slot_bytes(self, coords) -> int:
        """Bytes of updater state (and parameter blocks) the slot holds."""
        trees = [self.state[coords]] + ([] if self.param_blocks is None
                                        else [self.param_blocks[coords]])
        return sum(t.numel() * t.element_size() for tr in trees for t in tree_leaves(tr)
                   if isinstance(t, torch.Tensor))

    def update(self, grads, iteration) -> None:
        """The reduced gradients (minimize flip taken) -> normalization on
        the whole -> each slot's updater on its blocks -> gathered updates
        -> ``p - u`` -> constraints; the parameter blocks re-split."""
        net, mesh = self.net, self.mesh
        grads = normalize_gradients(grads, net.gc.gradient_normalization,
                                    net.gc.gradient_normalization_threshold)
        ups = {}
        for coords, dev in mesh.slots():
            g_s = tree_map_path(lambda path, g: g[_block(
                tuple(g.shape), self.update_spec[path], mesh, coords)].to(dev), grads)
            u_s, self.state[coords] = net.updater.apply(self.state[coords], g_s, iteration)
            ups[coords] = u_s
        params = net._trainable()
        with torch.no_grad():
            def apply(path, p):
                layer = path.split("/")[0]
                if not grads.get(layer):
                    return p
                spec = self.update_spec[path]
                blocks = {c: tree_get(ups[c], path) for c in ups}
                u = gather_blocks(blocks, spec, mesh, tuple(p.shape), p.device)
                p.sub_(u.to(p.dtype))
                return p
            tree_map_path(apply, params)
        net._apply_constraints()
        if self.params_sharded:
            self.param_blocks = self._split(net.params, self.par_specs)

    def gather_state(self):
        """The whole updater state, on the network's device."""
        first = self.state[next(iter(self.state))]

        def one(path, leaf):
            spec = tree_get(self.upd_specs, path).spec
            full = tree_get(self.net.updater_state, path)
            blocks = {c: tree_get(self.state[c], path) for c in self.state}
            return gather_blocks(blocks, spec, self.mesh, tuple(full.shape), self.net.device,
                                 full.dtype)
        return tree_map_path(one, first)


# ----------------------------------------------------------------- steps
class SyncStep:
    """One synchronous data-parallel update on a global batch (the
    reference's AVERAGING with averaging frequency 1): see the module
    docstring. Called with the ``data`` slots' shards (lists, one entry a
    slot: a tensor, a graph's tuple of streams, or None) and, under
    truncated BPTT, each slot's carried state; returns (the global batch's
    loss, each slot's detached carry out)."""

    def __init__(self, net, mesh: Mesh, axis: str = DATA_AXIS, shard_update: bool = False,
                 shard_params: bool = False, tp_rules=None, style: str = "sharding/dp_step"):
        self.net, self.mesh, self.axis = net, mesh, axis
        # a mesh without the data axis (a pure model or expert mesh) runs
        # the whole batch as one slot, on its first slot's device
        self.data_devices = (mesh.axis_devices(axis) if axis in mesh.shape
                             else [mesh.device_at()])
        self.par_specs, self.upd_specs = composed_specs(net, mesh, axis, tp_rules,
                                                        shard_update, shard_params)
        self.sharded_storage = bool(tp_rules) or shard_update or shard_params
        self.store: Optional[ShardedModel] = None
        self.slot_bytes: Dict = {}
        self.replicas = SlotReplicas(net)
        record_step(style, mesh, self.par_specs, self.upd_specs,
                    zero=shard_update or shard_params)

    def place(self):
        """Split the network's updater state (and parameters) over the
        slots; a no-op for a replicated step."""
        if self.sharded_storage and self.store is None:
            self.store = ShardedModel(self.net, self.mesh, self.par_specs, self.upd_specs)
        return self

    def gather(self):
        """Put the whole updater state back on the network; ``slot_bytes``
        keeps what each slot held ({slot coordinates: bytes})."""
        if self.store is not None:
            self.slot_bytes = {c: self.store.slot_bytes(c) for c, _ in self.mesh.slots()}
            self.net.updater_state = self.store.gather_state()
            self.store = None

    def slot_grads(self, fs, ls, fms, lms, rnn_in=None):
        """Each data slot's (loss, gradients, carry out, new layer state)
        and the shards' sizes."""
        net = self.net
        skip = net._idle_frozen()
        out = []
        for s, dev in enumerate(self.data_devices):
            rep = self.replicas.on(dev)
            loss, rnn_out, new_states = rep._train_loss(
                fs[s], ls[s], fms[s], lms[s], None if rnn_in is None else rnn_in[s],
                rng=net._gen)
            grads = rep._grads(loss, skip=skip)
            first = fs[s][0] if isinstance(fs[s], (tuple, list)) else fs[s]
            out.append((loss.detach(), grads, _detached(rnn_out), new_states,
                        int(first.shape[0])))
        return out

    def reduce(self, per_slot):
        """(loss, gradients, new layer state) of the global batch on the
        network's device: shard-weighted sums in rank order."""
        dev = self.net.device
        total = sum(r[4] for r in per_slot)
        w = [r[4] / total for r in per_slot]
        loss = slot_sum([r[0] for r in per_slot], dev, w)
        grads = tree_map(lambda *gs: slot_sum(gs, dev, w), per_slot[0][1],
                         *[r[1] for r in per_slot[1:]])
        states = _mean_states([r[3] for r in per_slot], dev)
        from .distributed import all_reduce_mean, process_count
        if process_count() > 1:         # each process's mesh, then across them
            loss = all_reduce_mean(loss)
            grads = tree_map(all_reduce_mean, grads)
        return loss, grads, states

    def __call__(self, fs, ls, fms=None, lms=None, rnn_in=None):
        """One update. ``fs``/``ls``/``fms``/``lms`` are the data slots'
        shards (lists), or whole batches (tensors, or a graph's tuples of
        streams), which are split here."""
        net = self.net
        n = len(self.data_devices)
        if not isinstance(fs, list):
            fs, ls, fms, lms = (_split_rows(None if x is None else _to_dev(x, self.data_devices[0]),
                                            n, self.data_devices) for x in (fs, ls, fms, lms))
        fms = fms if fms is not None else [None] * n
        lms = lms if lms is not None else [None] * n
        self.place()
        per_slot = self.slot_grads(fs, ls, fms, lms, rnn_in)
        loss, grads, new_states = self.reduce(per_slot)
        if self.store is None:
            net._apply_update(grads, net.iteration_count)
        else:
            if not net.gc.minimize:
                grads = tree_map(torch.neg, grads)
            self.store.update(grads, net.iteration_count)
        net._commit_states(new_states)
        net.iteration_count += 1
        return loss, [r[2] for r in per_slot]


def data_parallel_step(net, mesh: Mesh, axis: str = DATA_AXIS,
                       shard_update: bool = False, shard_params: bool = False,
                       tp_rules=None) -> SyncStep:
    """A synchronous data-parallel step for ``net`` over ``mesh``'s
    ``axis``: ``step(fs, ls, fms, lms)`` with the slots' shards
    (:func:`shard_batch`) returns the global batch's loss and updates the
    network. ``tp_rules`` and the ZeRO flags decide what each slot holds
    (:func:`composed_specs`)."""
    return SyncStep(net, mesh, axis, shard_update, shard_params, tp_rules,
                    style="sharding/dp_step")
