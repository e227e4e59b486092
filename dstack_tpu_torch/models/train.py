"""Training step and loop, on one card or sharded over a device mesh.

``make_train_step`` binds a model config and an optimizer into
``step(state, batch) -> (state, metrics)``: the backbone's final hidden
states go through :func:`chunked_cross_entropy` (no [B, S, V] logits), the
attention through the fused causal kernels, and the optimizer is AdamW
with optax's semantics.  Unlike the JAX step (a pure function of a donated
state), the port updates the parameters and moments in place: no second
copy of the model exists during the update.

``run_train_loop`` resumes from the newest published snapshot, saves
periodic snapshots and flushes one on a preemption notice
(:mod:`dstack_tpu_torch.models.checkpoint`).

Under a ``mesh`` (:mod:`dstack_tpu_torch.parallel.mesh`) and a
:class:`~dstack_tpu_torch.models.llama.ShardingPolicy` (FSDP x data x
dcn x tensor, and sequence or pipeline parallelism: ``seq_axis`` with
ring or Ulysses attention, ``stage_axis`` with GPipe microbatches) the
state is DTensors placed by ``param_specs``, each rank feeds its stripe
of the global batch (and under ``seq`` of the sequence), and the loss
and gradient norm are the global ones.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, ClassVar, List, Optional, Union

import torch
import torch.nn.functional as F

from dstack_tpu_torch.models import llama
from dstack_tpu_torch.models.llama import (LlamaConfig, Params,
                                           ShardingPolicy, tree_leaves)
from dstack_tpu_torch.ops import adamw
from dstack_tpu_torch.ops.loss import chunked_cross_entropy, chunked_nll_sum
from dstack_tpu_torch.parallel import mesh as mesh_lib
from dstack_tpu_torch.parallel.collectives import all_reduce_sum
from dstack_tpu_torch.telemetry import spans
from dstack_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: Any
    step: int
    #: state the step moves without a gradient (an MoE's expert bias), a
    #: tree of tensors; None for a model that has none
    buffers: Optional[Params] = None


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean NLL of f32 logits [B, S, V] at int targets [B, S], over the
    positions where ``mask`` is 1 (all when None)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(...))``.

    - clip: when the gradients' global norm is at least ``grad_clip``, each
      gradient becomes ``g * grad_clip / norm`` (optax's rule: no epsilon
      in the denominator), rounded to its dtype as optax rounds it; below
      it they pass unchanged;
    - then torch's fused AdamW arithmetic with decoupled weight decay on
      every leaf, which is optax's ``adamw``: moments ``exp_avg``,
      ``exp_avg_sq`` in the params' dtype (as optax keeps them for bf16
      params), bias-corrected by ``1 - b**count``, and the update ``mu_hat
      / (sqrt(nu_hat) + eps) + weight_decay * p`` times ``-lr``, in f32,
      rounded once into each leaf's dtype.

    Where it runs (:mod:`dstack_tpu_torch.ops.adamw`): CPU leaves take
    three plain passes (the norms, the clip's multiply, torch's fused
    AdamW); CUDA leaves take the hand-written kernel ``ops/csrc/adamw.cu``
    in two, one read of every gradient for the norm and one streaming
    pass for the step, 16 bytes a bf16 parameter, with the same
    arithmetic.

    Leaves may mix dtypes (an MoE router in f32 among bf16 weights): each
    keeps its moments in its own dtype, and the norm is accumulated in f32
    over all of them (optax sums a bf16 leaf's squares in bf16, so its
    norm may differ by ~2^-9 relative)."""

    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    #: fixed, as in the JAX package's default_optimizer
    b1: ClassVar[float] = 0.9
    b2: ClassVar[float] = 0.95
    eps: ClassVar[float] = 1e-8

    def init(self, params: Params) -> torch.optim.AdamW:
        """The fused AdamW over the leaves' local tensors (a DTensor's
        shard: the update is elementwise, so each rank steps its shard of
        the global update).  It holds the hyperparameters and, from the
        first step, each leaf's ``step``, ``exp_avg`` and ``exp_avg_sq``;
        on CUDA the kernel steps them in its place."""
        return torch.optim.AdamW(
            [mesh_lib.local_tensor(p) for p in tree_leaves(params)],
            lr=self.lr, betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay, fused=True)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads,
               opt_state: torch.optim.AdamW) -> torch.Tensor:
        """Apply one step in place to ``params`` (the leaves ``init`` was
        given, in :func:`tree_leaves` order) from ``grads`` (on the CPU
        clipped in place; on CUDA left as they are); returns the
        gradients' global norm (f32, before clipping).

        A DTensor parameter's gradient is given as its local shard's,
        already in the parameter's placements: the sharded forward's
        collectives reduce it.  The norm then sums each block's squares
        once (on the block's owner,
        :func:`dstack_tpu_torch.parallel.mesh.owns`) over every rank."""
        return adamw.update(params, grads, opt_state, self.grad_clip)


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      grad_clip: float = 1.0) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip)


def _generator_on(generator: Union[int, torch.Generator],
                  device: Optional[Union[str, torch.device]]
                  ) -> torch.Generator:
    """A generator on the resolved ``device`` (CUDA unless the caller names
    another): made there from an int seed, or the one given if it is there
    already (a generator elsewhere raises)."""

    def indexed(d: torch.device) -> torch.device:
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    dev = indexed(resolve_device(device))
    if isinstance(generator, int):
        return torch.Generator(device=dev).manual_seed(generator)
    if indexed(generator.device) != dev:
        raise ValueError(
            f"the generator is on {generator.device} and the state would go "
            f"on {dev}: pass an int seed, a generator there, or the "
            f"generator's device as device=")
    return generator


def _mesh_device(mesh: Any, device) -> torch.device:
    """The device of this rank's shards (``device`` must agree with the
    mesh when given)."""
    dev = mesh_lib.mesh_device(mesh)
    if device is not None and resolve_device(device).type != dev.type:
        raise ValueError(f"device={device} but the mesh is on "
                         f"{mesh.device_type}")
    return dev


def create_state(generator: Union[int, torch.Generator], cfg: LlamaConfig,
                 optimizer: AdamW, mesh: Any = None,
                 policy: Optional[ShardingPolicy] = None,
                 unstacked: bool = False,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> TrainState:
    """Fresh state on ``device`` (CUDA by default, raising without a card;
    the CPU only when named), drawn from ``generator``: an int seed, or a
    ``torch.Generator`` on that device.  ``unstacked`` stores each layer's
    weights (and grads, and moments) as separate buffers.

    Under a ``mesh`` the state goes on the mesh's device as DTensors
    placed by ``param_specs(cfg, policy)``: each rank draws every matrix
    in turn from its own copy of the generator and keeps its block, so
    it holds exactly its slice of the state the unsharded call draws,
    and the whole model never exists on one card."""
    if mesh is None:
        gen = _generator_on(generator, device)
        return _fresh_state(llama.init_params(cfg, gen.device, gen),
                            optimizer, unstacked)
    policy = policy or ShardingPolicy()
    # refuse what is not ported first
    llama.Layout(mesh, policy, cfg).check_stacked(not unstacked)
    gen = _generator_on(generator, _mesh_device(mesh, device))
    specs = llama.param_specs(cfg, policy)
    sizes, coord = mesh_lib.mesh_sizes(mesh), mesh_lib.mesh_coordinate(mesh)

    def block(name, shape):
        spec = specs[name] if name in specs else specs["layers"][name]
        return tuple(slice(a, b) for a, b in
                     mesh_lib.shard_index(spec, shape, sizes, coord))

    params = llama.init_params(cfg, gen.device, gen, block=block)
    return _fresh_state(params, optimizer, unstacked, sharded=(
        specs, llama.init_params(cfg, "meta", None), mesh))


def state_from_params(params: Params, cfg: LlamaConfig, optimizer: AdamW,
                      mesh: Any = None,
                      policy: Optional[ShardingPolicy] = None) -> TrainState:
    """Step 0 of training the whole tree ``params`` (imported weights,
    another package's init; stacked or unstacked), on their device; under
    a ``mesh`` each rank keeps its blocks, placed by
    ``param_specs(cfg, policy)`` on the mesh's device."""
    if mesh is None:
        return _fresh_state(params, optimizer, unstacked=False)
    policy = policy or ShardingPolicy()
    llama.Layout(mesh, policy, cfg).check_stacked(
        not isinstance(params["layers"], (list, tuple)))
    dev = mesh_lib.mesh_device(mesh)
    local = llama.map_with_specs(
        lambda sp, p: mesh_lib.copy_to(
            mesh_lib.local_block(p.detach(), sp, mesh), dev),
        llama.specs_for(params, cfg, policy), params)
    return _fresh_state(local, optimizer, unstacked=False, sharded=(
        llama.param_specs(cfg, policy), llama.init_params(cfg, "meta", None),
        mesh))


def _fresh_state(params: Params, optimizer: AdamW, unstacked: bool,
                 sharded: Optional[tuple] = None) -> TrainState:
    """Step 0 of training ``params`` (unstacked first when asked).
    ``sharded`` = (the model's stacked specs, its whole tree as meta
    tensors, mesh) wraps each leaf, this rank's block, as a DTensor of the
    model's global shape."""
    if unstacked:
        params = llama.unstack_params(params)
    if sharded is not None:
        params = _distributed(params, *sharded)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def _distributed(local: Params, specs: Params, shapes: Params,
                 mesh: Any) -> Params:
    """DTensors of the global shapes (``shapes``' leaves, stacked or
    unstacked as ``local``) from this rank's blocks."""
    if isinstance(local["layers"], (list, tuple)):
        shapes = llama.unstack_params(shapes)
        specs = llama.unstack_specs(specs, len(local["layers"]))
    return llama.map_with_specs(
        lambda sp, x, shape: mesh_lib.distribute(x, sp, mesh, shape.shape),
        specs, local, shapes)


def state_specs_from(pspecs: Params) -> TrainState:
    """The spec of every leaf of a train state, from its params' specs:
    AdamW's moments follow their parameter's spec (torch keeps them
    beside it), its step count and ``step`` are replicated.  The leaves
    in snapshot order are the JAX ``state_specs_from``'s, entry for
    entry."""
    return TrainState(params=pspecs,
                      opt_state={"count": (), "mu": pspecs, "nu": pspecs},
                      step=())


def state_specs(cfg: LlamaConfig, optimizer: AdamW,
                policy: ShardingPolicy = ShardingPolicy(),
                unstacked: bool = False) -> TrainState:
    """Llama-family state specs (see :func:`state_specs_from`)."""
    del optimizer  # AdamW's moments mirror the params whatever its settings
    pspecs = llama.param_specs(cfg, policy)
    if unstacked:
        pspecs = llama.unstack_specs(pspecs, cfg.num_layers)
    return state_specs_from(pspecs)


def make_train_step(cfg: LlamaConfig, optimizer: AdamW, mesh: Any = None,
                    policy: Optional[ShardingPolicy] = None,
                    remat: Any = True, telemetry: Any = None,
                    compile_cache: Any = None
                    ) -> Callable[[TrainState, dict], tuple]:
    """The train step.  batch: {"tokens": [B, S+1] int on the params'
    device (inputs [:, :-1], targets [:, 1:]), optional "mask" [B, S]}.

    Returns ``(state, metrics)``: the same state object, updated in place,
    and {"loss": 0-dim f32 tensor, "step": int, "grad_norm": 0-dim f32
    tensor}: the norm is computed for clipping anyway, so unlike the JAX
    step there is no ``with_grad_norm`` to drop it.  Nothing waits for the
    card: read the tensors when the host needs them.  A ``telemetry``
    (:class:`dstack_tpu_torch.telemetry.training.TrainTelemetry`) wraps
    the step, which then reads each loss on the host to time the step.

    Under a ``mesh`` the state is :func:`create_state`'s sharded one and
    the batch is this rank's stripe of the global batch
    (:meth:`dstack_tpu_torch.models.data.DataLoader.on_mesh`,
    :func:`dstack_tpu_torch.models.data.rank_tokens`): its rows, and under
    ``seq`` its stripe of the sequence, "tokens" [b, S/n + 1] (the last
    token is the next stripe's first: the targets are shifted before
    striping) and "mask" [b, S/n]; the loss is the mean over the global
    batch, and the gradients and their norm the global ones.

    ``compile_cache``: a :class:`dstack_tpu_torch.elastic.compile_cache.
    CompileCache` through which the first step on CUDA makes the flash
    kernels' libraries present (fetched from the root or a peer instead
    of built by nvcc where it can).  Defaults to the env-configured cache
    (``DSTACK_COMPILE_CACHE``); unset → the libraries are built at first
    launch."""
    # here, not at the top: elastic/ imports the checkpoints, which
    # import this module
    from dstack_tpu_torch.elastic.compile_cache import (CompileCache,
                                                        maybe_cached)

    if compile_cache is None:
        compile_cache = CompileCache.from_env()
    llama.remat_names(remat)  # reject a bad mode before the first step
    policy = policy or ShardingPolicy()
    layout = llama.Layout(mesh, policy, cfg)

    def loss_fn(params, batch):
        x = llama.backbone(params, batch["tokens"][:, :-1], cfg, mesh=mesh,
                           policy=policy, remat=remat)
        loss, ce = _head_loss(params, x, batch, cfg, layout)
        return loss, {"loss": ce}

    step = maybe_cached(
        _step_from_loss(loss_fn, optimizer, sharded=mesh is not None),
        compile_cache, tag="train_step",
        kernels=("flash_fwd", "flash_bwd", "rownorm", "adamw"),
        needs=lambda state, batch: batch["tokens"].device.type == "cuda")
    if telemetry is None:
        return step
    # each rank times its own stripe; it computes 1/tensor of the model
    # (and of the layers, 1/stage)
    return telemetry.wrap(step, cfg, n_devices=1 if mesh is None else
                          layout.tsize * layout.stage_count)


#: the leaves outside the layer stacks: what the head and loss read
_OUTER = ("embed", "final_norm", "lm_head")


def _head_loss(params: Params, x: torch.Tensor, batch: dict,
               cfg: LlamaConfig, layout: Optional[llama.Layout] = None, *,
               aux: Optional[torch.Tensor] = None,
               aux_weight: float = 0.0) -> tuple:
    """Every step's ``(loss, ce)`` in ``model.head_loss``: the value to
    differentiate and the cross entropy to report, of the backbone's
    ``x`` at ``batch``'s targets through the head of ``params``.  Under a
    mesh the loss is this rank's share of the global mean (its tokens'
    sum over every rank's count, summed over ``layout.token_axes``);
    ``aux_weight * aux`` is added to it."""
    mesh = None if layout is None else layout.mesh
    targets, mask = batch["tokens"][:, 1:], batch.get("mask")
    with spans.region("model.head_loss") as r:
        x, aux, outer = r.inputs((x, aux, {
            k: params[k] for k in _OUTER if k in params}))
        head = llama.output_head(outer, cfg, mesh,
                                 None if mesh is None else layout.policy)
        if mesh is None:
            loss = chunked_cross_entropy(x, head, targets, mask)
            ce = loss.detach()
        else:
            total, count = chunked_nll_sum(x, head, targets, mask)
            count = all_reduce_sum(count, mesh,
                                   layout.token_axes).clamp_min(1.0)
            loss = total / count
        if aux is not None:
            loss = loss + aux_weight * aux
        loss = r.outputs(loss)
        if mesh is not None:
            ce = all_reduce_sum(total, mesh, layout.token_axes) / count
        return loss, ce


def _step_from_loss(loss_fn: Callable[..., tuple],
                    optimizer: AdamW, sharded: bool = False,
                    after: Optional[Callable[[TrainState, dict], None]]
                    = None) -> Callable[[TrainState, dict], tuple]:
    """``step(state, batch)`` from ``loss_fn(params, batch) -> (loss,
    metrics)``: the gradients of ``loss`` through autograd, the AdamW
    update in place; the step's metrics are ``metrics`` with "step" and
    "grad_norm" added.  ``sharded``: the params are DTensors, and
    ``loss_fn`` gets one local view of each (so a tied embedding's two
    reads add plain gradients) whose gradients are the shards'.  A state
    with ``buffers`` gives them to ``loss_fn`` as a third argument, and
    ``after(state, metrics)`` moves them once AdamW has stepped."""

    def step(state: TrainState, batch) -> tuple:
        params = (llama.tree_map(lambda p: p.to_local(), state.params)
                  if sharded else state.params)
        # the step's phases, named while torch.profiler runs
        # (telemetry/spans.py)
        with spans.span("train.forward"):
            loss, metrics = (loss_fn(params, batch) if state.buffers is None
                             else loss_fn(params, batch, state.buffers))
        with spans.span("train.backward"):
            grads = torch.autograd.grad(loss, tree_leaves(params))
        with spans.span("train.optimizer"):
            norm = optimizer.update(tree_leaves(state.params), grads,
                                    state.opt_state)
            if after is not None:
                after(state, metrics)
        state.step += 1
        return state, {**metrics, "step": state.step, "grad_norm": norm}

    return step


# -- preemption-aware resumable training -------------------------------------


def state_template(cfg: LlamaConfig, optimizer: AdamW, mesh: Any = None,
                   policy: Optional[ShardingPolicy] = None,
                   unstacked: bool = False) -> TrainState:
    """The restore target of :func:`checkpoint.read_snapshot`: the params
    as meta tensors (shapes and dtypes, no memory on any device), the
    ``optimizer`` as ``opt_state`` (its moments mirror the params), step 0.
    Resuming therefore allocates the state once, on the restore's device,
    with no throwaway init.  Under a ``mesh`` the params are meta DTensors
    placed by ``param_specs(cfg, policy)``: a restore puts each rank's
    blocks there."""
    params = llama.init_params(cfg, "meta", None)
    if unstacked:
        params = llama.unstack_params(params)
    if mesh is not None:
        policy = policy or ShardingPolicy()
        llama.Layout(mesh, policy, cfg).check_stacked(not unstacked)
        sizes, coord = mesh_lib.mesh_sizes(mesh), mesh_lib.mesh_coordinate(
            mesh)

        def meta(spec, p):
            index = mesh_lib.shard_index(spec, p.shape, sizes, coord)
            local = torch.empty([b - a for a, b in index], dtype=p.dtype,
                                device="meta")
            return mesh_lib.distribute(local, spec, mesh, p.shape)

        params = llama.map_with_specs(
            meta, llama.specs_for(params, cfg, policy), params)
    return TrainState(params=params, opt_state=optimizer, step=0)


def resume_train_state(checkpoint_dir, cfg: LlamaConfig, optimizer: AdamW,
                       *, mesh: Any = None,
                       policy: Optional[ShardingPolicy] = None,
                       generator: Union[int, torch.Generator, None] = None,
                       unstacked: bool = False,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> tuple:
    """``(state, start_step)``: restored onto ``device`` (CUDA unless the
    caller names another) from the newest published snapshot under
    ``checkpoint_dir``, with AdamW's moments and step count; or, when no
    snapshot exists, fresh from ``generator`` (required then).  Under a
    ``mesh`` the state is placed on it, which may be smaller than the
    mesh that wrote the snapshot (elastic shrink: ``shrink_spec``)."""
    from dstack_tpu_torch.models import checkpoint as ckpt

    step = (ckpt.latest_snapshot_step(checkpoint_dir)
            if checkpoint_dir is not None else None)
    if step is None:
        if generator is None:
            raise ValueError(
                "no published snapshot to resume from and no generator to "
                "initialize fresh state")
        state = create_state(generator, cfg, optimizer, mesh=mesh,
                             policy=policy, unstacked=unstacked,
                             device=device)
        return state, 0
    template = state_template(cfg, optimizer, mesh=mesh, policy=policy,
                              unstacked=unstacked)
    if mesh is not None:
        device = _mesh_device(mesh, device)
    state, step = ckpt.read_snapshot(checkpoint_dir, template, step,
                                     device=device)
    logger.info("resumed train state from %s at step %d",
                checkpoint_dir, step)
    return state, int(step)


@dataclasses.dataclass
class TrainLoopResult:
    state: TrainState
    step: int                      # steps completed (global, not per-run)
    losses: List[float]            # per executed step, in order
    status: str                    # "completed" | "preempted"
    resumed_from: Optional[int]    # checkpoint step this run started from
    #: the run's (closed) checkpointer: its last published step, dropped
    #: snapshots and per-snapshot copy and write seconds; None without a
    #: checkpoint_dir
    checkpointer: Any = None


def run_train_loop(cfg: LlamaConfig, optimizer: AdamW,
                   batch_fn: Callable[[int], dict], *, steps: int,
                   generator: Union[int, torch.Generator, None] = None,
                   device: Optional[Union[str, torch.device]] = None,
                   mesh: Any = None, policy: Optional[ShardingPolicy] = None,
                   checkpoint_dir: Any = None, checkpoint_every: int = 100,
                   keep_last: int = 3, guard: Any = None,
                   on_step: Optional[Callable[[int, dict], None]] = None,
                   telemetry: Any = None, unstacked: bool = False,
                   **step_kw) -> TrainLoopResult:
    """Preemption-aware training loop: resume, snapshot, emergency-flush.

    The state is resumed from the newest snapshot under ``checkpoint_dir``
    or, when there is none, drawn from ``generator`` (an int seed or a
    generator), on ``device`` as :func:`create_state` puts it: CUDA
    unless the caller names the CPU.

    - ``batch_fn(step)`` must be deterministic in ``step`` so a resumed run
      replays the same data order (step is 0-based: the batch consumed BY
      step ``s`` produces the state published as step ``s+1``).
    - ``checkpoint_dir``: periodic snapshots every ``checkpoint_every``
      steps, written by a :class:`checkpoint.AsyncCheckpointer` that keeps
      the last ``keep_last``.
    - ``guard``: a :class:`checkpoint.PreemptionGuard`; when it fires
      (SIGTERM, spot notice, manual trigger) the loop publishes a snapshot
      of the current step synchronously and returns with
      ``status="preempted"``.
    - An exception from a step or from ``on_step`` publishes nothing
      in flight: a resume comes from the last periodic snapshot.
    - Under a ``mesh`` every rank runs the loop on its stripe
      (``batch_fn`` gives this rank's rows); the snapshots hold every
      rank's shards, rank 0 publishing once all have staged, and a
      completed loop returns once the final snapshot is published.

    The loop reads each step's loss on the host (monitoring-grade); a
    throughput run drives the step function itself."""
    from dstack_tpu_torch.models.checkpoint import AsyncCheckpointer

    state, start = resume_train_state(
        checkpoint_dir, cfg, optimizer, mesh=mesh, policy=policy,
        generator=generator, unstacked=unstacked, device=device)
    resumed_from = start if start > 0 else None
    step_fn = make_train_step(cfg, optimizer, mesh=mesh, policy=policy,
                              telemetry=telemetry, **step_kw)
    checkpointer = None
    if checkpoint_dir is not None:
        checkpointer = AsyncCheckpointer(
            checkpoint_dir, keep_last=keep_last, every_steps=checkpoint_every)
    losses: List[float] = []
    step = start
    status = "completed"
    failed = False
    try:
        while step < steps:
            if guard is not None and guard.preempted:
                status = "preempted"
                break
            state, metrics = step_fn(state, batch_fn(step))
            step += 1
            losses.append(float(metrics["loss"]))
            if checkpointer is not None:
                checkpointer.maybe_save(state, step)
            if on_step is not None:
                on_step(step, metrics)
        if guard is not None and guard.preempted and status == "completed":
            status = "preempted"  # notice arrived on the final step
    except BaseException:
        # a hard failure (host loss, a failed step) must not publish the
        # in-flight state: mid-step the in-place update may be half done;
        # resume comes from the last PERIODIC snapshot instead
        failed = True
        raise
    finally:
        if checkpointer is not None:
            # emergency flush on preemption; normal completion publishes
            # the final state too so a later job continues exactly here
            if not failed and checkpointer.last_enqueued != step:
                checkpointer.save(state, step, block=True)
            if failed:
                # already propagating the hard failure — a secondary
                # writer error must not mask it
                try:
                    checkpointer.close()
                except Exception:
                    logger.exception(
                        "checkpoint writer error during failure teardown")
            else:
                # close() raises on writer errors: a "completed" result
                # must never hide a failed final checkpoint write
                checkpointer.close()
                if mesh is not None:
                    # rank 0 publishes: the others wait for it, so a
                    # resume on any rank reads the final step
                    import torch.distributed as dist

                    dist.barrier()
    return TrainLoopResult(state=state, step=step, losses=losses,
                           status=status, resumed_from=resumed_from,
                           checkpointer=checkpointer)
