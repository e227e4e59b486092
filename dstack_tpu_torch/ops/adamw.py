"""AdamW with optax's global-norm clip folded in: ``csrc/adamw.cu`` on the
card, and its plain version.

:func:`update` is :meth:`dstack_tpu_torch.models.train.AdamW.update`'s
work.  CPU tensors take :func:`update_plain`: three passes, the gradients'
norms (``torch._foreach_norm``), the clip's multiply
(``torch._foreach_mul_`` by a device scalar) and torch's fused AdamW
(``opt_state.step()``).  CUDA tensors take the kernel, built by
``_build.py``, in two passes: one launch reads every gradient once for the
global norm's sum of squares (and adds 1 to every leaf's step), then one
launch a leaf dtype steps every leaf from its gradient clipped on the fly.
That is 16 bytes a bf16 parameter (32 an f32 one) against the three
passes' 20, and no clipped gradient is written.  The kernel repeats the
plain version's arithmetic operation for operation: the clip rounded to
the leaf's dtype, then torch's fused AdamW in f32.  Only the norm sums its
squares in another order (one f32 sum, not a norm of per-leaf norms), so
it may differ in its last bits.

The state stays torch's: ``opt_state`` is the ``torch.optim.AdamW`` that
``AdamW.init`` made, whose ``state[p]`` holds ``step`` (f32, on the
device), ``exp_avg`` and ``exp_avg_sq`` (the leaf's dtype), made at the
first step as torch makes them; the snapshots (``models/checkpoint.py``)
and the benchmark read them there.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from dstack_tpu_torch.parallel import mesh as mesh_lib

#: the leaves one launch takes (``csrc/adamw.cu``'s ``kMaxLeaves``): a longer
#: table is split into launches
MAX_LEAVES = 64
#: the norm's blocks (and so its partial sums) a streaming multiprocessor
_NORM_BLOCKS_PER_SM = 8
#: the table's flags column (``csrc/adamw.cu``'s ``kFlags``): the dtype's
#: code, and _IN_NORM where the gradient counts in the norm (this rank owns
#: it)
_FLAGS = 6
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IN_NORM = 2

#: the kernel's launches: one norm launch and one step launch a leaf dtype
#: a step (another of either for every MAX_LEAVES leaves beyond the first)
norm_launches = 0
step_launches = 0


def update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           opt_state: torch.optim.AdamW, grad_clip: float) -> torch.Tensor:
    """One step of ``opt_state`` in place on ``params`` from ``grads``
    clipped to the global norm ``grad_clip``; returns that norm (f32,
    before clipping).  See ``AdamW.update``."""
    device = mesh_lib.local_tensor(params[0]).device
    if device.type == "cpu":
        return update_plain(params, grads, opt_state, grad_clip)
    if device.type != "cuda":
        raise ValueError(f"AdamW steps CPU or CUDA tensors, got {device}")
    return _kernel_update(params, grads, opt_state, grad_clip)


def update_plain(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor],
                 opt_state: torch.optim.AdamW,
                 grad_clip: float) -> torch.Tensor:
    """:func:`update` in three passes of plain PyTorch; ``grads`` are
    clipped in place."""
    from torch.distributed.tensor import DTensor

    grads = list(grads)
    if any(isinstance(p, DTensor) for p in params):
        import torch.distributed as dist

        owned = [g for p, g in zip(params, grads)
                 if not isinstance(p, DTensor) or mesh_lib.owns(p)]
        sq = (torch.stack(torch._foreach_norm(owned, 2,
                                              dtype=torch.float32))
              .square().sum() if owned else
              torch.zeros((), device=grads[0].device))
        dist.all_reduce(sq)
        norm = sq.sqrt()
    else:
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads, 2, dtype=torch.float32)))
    torch._foreach_mul_(grads, grad_clip / torch.clamp_min(norm, grad_clip))
    for p, g in zip(params, grads):
        # the fused step takes each gradient laid out as its parameter;
        # a tied head's comes back transposed
        mesh_lib.local_tensor(p).grad = g.contiguous()
    opt_state.step()
    opt_state.zero_grad(set_to_none=True)
    return norm


def state_of(opt_state: torch.optim.AdamW, p: torch.Tensor) -> dict:
    """``opt_state.state[p]``, made first as torch's fused AdamW makes it at
    its first step: ``step`` an f32 0-dim zero on ``p``'s device, both
    moments zeros like ``p``."""
    state = opt_state.state[p]
    if not state:
        state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
        state["exp_avg"] = torch.zeros_like(
            p, memory_format=torch.preserve_format)
        state["exp_avg_sq"] = torch.zeros_like(
            p, memory_format=torch.preserve_format)
    return state


def _check(leaves: List[torch.Tensor], grads: List[torch.Tensor],
           states: List[dict]) -> None:
    """What the kernel takes: plain tensors on one device; each parameter
    bf16 or f32, contiguous, with a gradient and both moments of its shape
    and dtype (the moments contiguous too) and an f32 0-dim step."""
    device = leaves[0].device
    for p, g, s in zip(leaves, grads, states):
        m, v, step = s["exp_avg"], s["exp_avg_sq"], s["step"]
        devices = {str(t.device) for t in (p, g, m, v, step)}
        if devices != {str(device)}:
            raise ValueError(f"AdamW's kernel takes tensors on one device "
                             f"({device}); got a leaf of {tuple(p.shape)} "
                             f"with tensors on {sorted(devices)}")
        if p.dtype not in _DTYPES or any(t.dtype != p.dtype
                                         for t in (g, m, v)):
            raise ValueError(f"AdamW's kernel takes bf16 or f32 leaves whose "
                             f"gradient and moments share their dtype; got "
                             f"{p.dtype}, {g.dtype}, {m.dtype}, {v.dtype}")
        if any(t.shape != p.shape for t in (g, m, v)):
            raise ValueError(f"AdamW's kernel takes a gradient and moments "
                             f"of the leaf's shape {tuple(p.shape)}; got "
                             f"{tuple(g.shape)}, {tuple(m.shape)}, "
                             f"{tuple(v.shape)}")
        if not all(t.is_contiguous() for t in (p, m, v)):
            raise ValueError(f"AdamW's kernel takes contiguous leaves and "
                             f"moments; the leaf of {tuple(p.shape)} is not")
        if step.dtype != torch.float32 or step.numel() != 1:
            raise ValueError(f"AdamW's kernel takes an f32 0-dim step, got "
                             f"{step.dtype} {tuple(step.shape)}")


def _kernel_update(params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor],
                   opt_state: torch.optim.AdamW,
                   grad_clip: float) -> torch.Tensor:
    """:func:`update` through ``csrc/adamw.cu``: the norm launch, under a
    mesh the all-reduce of its sum of squares, then the step launches."""
    from torch.distributed.tensor import DTensor

    if len(opt_state.param_groups) != 1:
        raise ValueError("AdamW's kernel steps one parameter group")
    leaves = [mesh_lib.local_tensor(p) for p in params]
    # the step reads each gradient laid out as its parameter; a tied
    # head's comes back transposed (held here until both passes are queued)
    grads = [g.contiguous() for g in grads]
    states = [state_of(opt_state, p) for p in leaves]
    _check(leaves, grads, states)
    table = _table(leaves, grads, states, [
        not isinstance(p, DTensor) or mesh_lib.owns(p) for p in params])
    sumsq = _norm_pass(table, leaves[0].device)
    if any(isinstance(p, DTensor) for p in params):
        import torch.distributed as dist

        dist.all_reduce(sumsq)
    return _step_pass(table, sumsq, _hyper(opt_state, grad_clip))


def _hyper(opt_state: torch.optim.AdamW, grad_clip: float) -> tuple:
    """The step launch's (lr, beta1, beta2, weight_decay, eps, clip): the
    optimizer group's, as torch's fused step reads them."""
    group = opt_state.param_groups[0]
    beta1, beta2 = group["betas"]
    return (float(group["lr"]), float(beta1), float(beta2),
            float(group["weight_decay"]), float(group["eps"]),
            float(grad_clip))


def _table(leaves, grads, states, owned) -> torch.Tensor:
    """The kernel's leaf table: int64 [leaves, 7] on the host, one row a
    leaf (its, its gradient's and its moments' and step's pointers, its
    element count, its flags: dtype, and whether it counts in the norm)."""
    return torch.tensor(
        [[p.data_ptr(), g.data_ptr(), s["exp_avg"].data_ptr(),
          s["exp_avg_sq"].data_ptr(), s["step"].data_ptr(), p.numel(),
          _DTYPES[p.dtype] | (_IN_NORM if own else 0)]
         for p, g, s, own in zip(leaves, grads, states, owned)],
        dtype=torch.int64)


def _blocks(device: torch.device) -> int:
    from dstack_tpu_torch.ops.flash_attention import _sm_count

    return _sm_count(device.index) * _NORM_BLOCKS_PER_SM


def _norm_pass(table: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The norm launches over ``table``: the f32 0-dim sum of squares of
    the gradients counted in it; every leaf's step moves on by 1."""
    global norm_launches
    from dstack_tpu_torch.ops.flash_attention import _launch

    blocks = _blocks(device)
    sumsq = torch.empty((), dtype=torch.float32, device=device)
    partials = torch.empty(blocks, dtype=torch.float32, device=device)
    counter = torch.zeros(1, dtype=torch.int32, device=device)
    n = len(table)
    for i in range(0, n, MAX_LEAVES):
        chunk = table[i:i + MAX_LEAVES]
        _launch("adamw", sumsq, partials, counter, None, chunk, len(chunk),
                0, 0, int(i == 0), int(i + MAX_LEAVES >= n), blocks,
                *[0.0] * 6)
        norm_launches += 1
    return sumsq


def _step_pass(table: torch.Tensor, sumsq: torch.Tensor,
               hyper: tuple) -> torch.Tensor:
    """The step launches, one a dtype of ``table``'s leaves, clipping by
    the norm ``sqrt(sumsq)`` with ``hyper`` (lr, beta1, beta2,
    weight_decay, eps, clip); returns that norm (f32 0-dim)."""
    global step_launches
    from dstack_tpu_torch.ops.flash_attention import _launch

    norm = torch.empty((), dtype=torch.float32, device=sumsq.device)
    blocks = _blocks(sumsq.device)
    for code in _DTYPES.values():
        rows = table[(table[:, _FLAGS] & 1) == code]
        for i in range(0, len(rows), MAX_LEAVES):
            chunk = rows[i:i + MAX_LEAVES]
            _launch("adamw", sumsq, None, None, norm, chunk, len(chunk), 1,
                    code, 0, 0, blocks, *hyper)
            step_launches += 1
    return norm
