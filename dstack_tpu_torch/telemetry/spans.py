"""Named spans of the port's work for ``torch.profiler``.

Every range the port opens goes through this module, and costs one flag
check while no profiler runs: no range is recorded and the autograd
graph gains no node.  While ``torch.profiler`` runs, a span is a
``record_function`` range (a ``user_annotation`` event, on the profiler's
clock with the device's kernels).

- :func:`span` is a host range alone (``train.*``, ``collective.*``);
- :func:`region` is a range of model code whose backward is named too.
  Autograd runs a step's backward on a thread of its own (one a device),
  where no range of the forward is open.  :meth:`Region.inputs` passes
  the region's inputs through an identity ``autograd.Function`` whose
  backward closes the range there, and :meth:`Region.outputs` passes its
  outputs through one whose backward opens it.  Neither saves a tensor.
  The engine runs the ready node of the highest sequence number first,
  so the nodes made between the two markers (the region's backward, and
  under remat its recompute, which reruns the region's forward code and
  its ranges) run between them.

Names are layer-neutral (serving calls the MoE block too): ``model.embed``,
``model.views`` (the per-layer views of the stacked weights and their
backward), ``model.attention``, ``model.mlp``, ``model.moe.route``,
``model.moe.dispatch``, ``model.moe.experts``, ``model.moe.combine``,
``model.moe.shared`` (a shared expert beside the routed ones),
``model.head_loss``; ``train.forward``, ``train.backward``,
``train.optimizer``; ``collective.<name>``.  A kernel belongs to the
innermost span open on the thread that launched it: under remat the
recompute's ranges nest inside the backward's.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function
from torch.utils import _pytree

_OFF = contextlib.nullcontext()


def span(name: str):
    """A host range ``name`` while the profiler runs, else nothing."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


class _Off:
    """The region while no profiler runs: the trees pass unchanged."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def inputs(self, tree):
        return tree

    def outputs(self, tree):
        return tree


_OFF_REGION = _Off()


def region(name: str):
    """``with region(name) as r:`` a range ``name`` around model code;
    ``r.inputs(tree)`` and ``r.outputs(tree)`` give back the tensors of a
    tree of dicts, lists and tuples that the region reads and makes,
    marked so that the backward runs under ``name`` too."""
    if _profiler._is_profiler_enabled:
        return Region(name)
    return _OFF_REGION


class Region:
    """A region while the profiler runs (see :func:`region`)."""

    def __init__(self, name: str):
        self.name = name
        self._range = record_function(name)
        #: the backward's open range
        self._backward: Any = None
        self._armed = False

    def __enter__(self):
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return False

    def inputs(self, tree):
        tree, self._armed = _mark(_Close, self, tree)
        return tree

    def outputs(self, tree):
        # without a marked input nothing would close what this opens
        return _mark(_Open, self, tree)[0] if self._armed else tree


def _mark(fn, owner: Region, tree):
    """``tree`` with the tensors that need a gradient passed through
    ``fn`` together; (tree, whether any was)."""
    if not torch.is_grad_enabled():
        return tree, False
    leaves, spec = _pytree.tree_flatten(tree)
    at = [i for i, x in enumerate(leaves)
          if isinstance(x, torch.Tensor) and x.requires_grad]
    if not at:
        return tree, False
    marked = fn.apply(owner, *(leaves[i] for i in at))
    for i, x in zip(at, marked):
        leaves[i] = x
    return _pytree.tree_unflatten(leaves, spec), True


class _Marker(torch.autograd.Function):
    """The identity on a region's tensors, saving none."""

    @staticmethod
    def forward(ctx, owner, *xs):
        ctx.owner = owner
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)


class _Open(_Marker):
    """On a region's outputs: its backward opens the range."""

    @staticmethod
    def backward(ctx, *grads):
        owner = ctx.owner
        owner._backward = record_function(owner.name)
        owner._backward.__enter__()
        return (None, *grads)


class _Close(_Marker):
    """On a region's inputs: its backward closes the range."""

    @staticmethod
    def backward(ctx, *grads):
        owner = ctx.owner
        if owner._backward is not None:
            owner._backward.__exit__(None, None, None)
            owner._backward = None
        return (None, *grads)
