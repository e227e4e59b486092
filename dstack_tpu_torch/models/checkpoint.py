"""Checkpoints of the training state, and Hugging Face weight import.

- **Preemption-safe periodic snapshots**: :class:`AsyncCheckpointer`
  copies the state to host memory on the train loop's thread, then writes
  and publishes it from a writer thread: each step atomically (staging
  dir + ``os.replace`` + directory fsync), keeping the last k, with a
  synchronous flush on a preemption notice (:class:`PreemptionGuard`).
  The on-disk format is the JAX package's, byte for byte (the layout
  below, leaves in the JAX ``TrainState``'s flatten order under its key
  paths), so a snapshot written by either package restores in the other.
- **Whole-state save/restore**: :func:`save_train_state` /
  :func:`restore_train_state` write one snapshot directory at a path and
  publish it atomically.  The JAX package writes Orbax checkpoints there;
  these are not Orbax-compatible (the snapshot layout instead).
- **Real weights**: :func:`load_hf_llama` reads a Hugging Face Llama
  checkpoint directory (``*.safetensors``, parsed by
  :func:`read_safetensors`) into the port's parameter tree.

The port's AdamW updates parameters and moments in place, where the JAX
step donates immutable buffers: a snapshot is therefore complete on the
host (every device copy synchronised) before :func:`snapshot_train_state`
returns, so the next step cannot write into a copy in flight.

bf16 leaves are written as their 2-byte words under the dtype name
``bfloat16`` and rebuilt with a ``torch.bfloat16`` view: never widened,
so a restore is bitwise.

A sharded state (DTensor leaves, see :func:`dstack_tpu_torch.models.train.
create_state`) is written by every rank of the process group into its own
``host_<rank>.npz``: each block of a leaf once, by its owner
(:func:`dstack_tpu_torch.parallel.mesh.owns`), with its global index.
Rank 0 publishes once every rank's file is staged (a filesystem barrier,
as in the JAX package; the JAX package dedupes per host, the port across
ranks), and a restore reassembles each leaf whole and places this rank's
blocks onto the template's placements, which may be a smaller mesh's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import queue
import shutil
import signal
import struct
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dstack_tpu_torch.models.llama import LlamaConfig, Params
from dstack_tpu_torch.models.train import TrainState
from dstack_tpu_torch.ops.rotary import RopeScaling
from dstack_tpu_torch.parallel import mesh as mesh_lib
from dstack_tpu_torch.parallel.distributed import RESUME_ATTEMPT_ENV
from dstack_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

Device = Optional[Union[str, torch.device]]

# -- atomic filesystem publish ----------------------------------------------


def _fsync_dir(path: Path) -> None:
    """fsync a directory so a just-published rename survives power loss."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return  # platform without directory fds: best effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_file_atomic(path: str | Path, data: bytes) -> None:
    """tmp file + fsync + ``os.replace`` + parent fsync: the file is either
    the old content or the new content, never a torn mix."""
    path = Path(path)
    tmp = path.with_name(path.name + f".tmp-{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path.parent)


def publish_dir_atomic(tmp: str | Path, final: str | Path) -> None:
    """Publish a fully-written tmp directory at ``final`` via rename.

    ``os.replace`` cannot overwrite a non-empty directory, so an existing
    ``final`` is first renamed aside to ``<name>.prev-<ns>`` and removed
    only once the new one is in place.  A crash in the (tiny) window
    between the two renames leaves no ``final`` — but the old checkpoint
    survives under its ``.prev-*`` name, and `restore_train_state` falls
    back to the newest ``.prev-*`` sibling when ``final`` is missing, so
    either the old or the new content is always recoverable and a partial
    write is never visible.
    """
    tmp, final = Path(tmp), Path(final)
    prev: Optional[Path] = None
    if final.exists():
        prev = final.with_name(f"{final.name}.prev-{time.time_ns()}")
        os.rename(final, prev)
    os.replace(tmp, final)
    _fsync_dir(final.parent)
    if prev is not None:
        shutil.rmtree(prev, ignore_errors=True)


# -- the state's leaves, as the JAX package names them ------------------------

#: the AdamW state in the JAX optimizer, optax's chain(clip, adamw)
_ADAM_PATH = ".opt_state[1][0]"


def _tree_items(tree, prefix: str) -> List[Tuple[str, Any]]:
    """(key path, leaf) of a tree of dicts and lists in ``jax.tree``'s
    order (dict keys sorted) under ``jax.tree_util.keystr``'s names."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _tree_items(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, t in enumerate(tree)
                for item in _tree_items(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _moment_paths(param_paths: List[str]) -> Tuple[List[str], List[str]]:
    tails = [p[len(".params"):] for p in param_paths]
    return ([f"{_ADAM_PATH}.mu{t}" for t in tails],
            [f"{_ADAM_PATH}.nu{t}" for t in tails])


def state_leaves(state: Any) -> List[Tuple[str, torch.Tensor]]:
    """(key path, tensor) of every leaf a snapshot holds, in the JAX
    ``TrainState``'s flatten order: the params, AdamW's step count
    (``count``, int32) and moments (``mu``/``nu``, in the params' dtype,
    from torch's ``exp_avg``/``exp_avg_sq``), then ``step`` (int32), then
    the ``buffers`` where the state has them (an MoE's expert bias; the
    JAX ``TrainState`` has none).  A plain tree of dicts and lists of
    tensors is flattened as it is."""
    if not isinstance(state, TrainState):
        return _tree_items(state, "")
    params = _tree_items(state.params, ".params")
    mu_paths, nu_paths = _moment_paths([p for p, _ in params])
    per_param = [state.opt_state.state.get(mesh_lib.local_tensor(p), {})
                 for _, p in params]
    # one fused AdamW call steps every parameter: their counts are equal
    first = per_param[0]
    count = torch.tensor(int(first["step"]) if "step" in first else 0,
                         dtype=torch.int32)

    def moment(s, key, p):
        # the optimizer holds a DTensor parameter's local shard
        local = mesh_lib.local_tensor(p)
        m = s[key] if key in s else torch.zeros_like(local)
        return m if local is p else _like(m, p)

    return (params + [(f"{_ADAM_PATH}.count", count)]
            + [(path, moment(s, "exp_avg", p)) for path, s, (_, p)
               in zip(mu_paths, per_param, params)]
            + [(path, moment(s, "exp_avg_sq", p)) for path, s, (_, p)
               in zip(nu_paths, per_param, params)]
            + [(".step", torch.tensor(int(state.step), dtype=torch.int32))]
            + _buffer_items(state))


def _buffer_items(state: TrainState) -> List[Tuple[str, Any]]:
    return ([] if state.buffers is None
            else _tree_items(state.buffers, ".buffers"))


def _like(local: torch.Tensor, p: Any) -> Any:
    """``local``, a shard shaped as DTensor ``p``'s, as a DTensor placed as
    ``p``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def _process() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("bfloat16", "float32", "int32")."""
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"snapshot dtype {name!r} has no torch counterpart")
    return dtype


# -- preemption-safe periodic snapshots --------------------------------------
#
# A lightweight per-host sharded format: each published step is a directory
#
#     <dir>/step_00000042/
#         manifest.json    # step + per-leaf global shape/dtype/keypath
#         host_00000.npz   # this host's shards as raw bytes + shard index
#     <dir>/LATEST         # "42" — atomically updated pointer
#
# Every write is staged under step_*.tmp-* and published with os.replace,
# so a reader (or a resuming job) only ever sees complete checkpoints.

MANIFEST_NAME = "manifest.json"
LATEST_NAME = "LATEST"
_STEP_PREFIX = "step_"


def _step_dirname(step: int) -> str:
    return f"{_STEP_PREFIX}{step:08d}"


def _current_attempt() -> int:
    """This submission's retry attempt (0 on a first run) — stamped into
    staging dir names so files staged by a crashed earlier attempt never
    leak into a later attempt's snapshot."""
    try:
        return int(os.environ.get(RESUME_ATTEMPT_ENV, "0") or 0)
    except ValueError:
        return 0


def _staging_dirname(step: int, attempt: Optional[int] = None) -> str:
    if attempt is None:
        attempt = _current_attempt()
    return f"{_step_dirname(step)}.tmp-a{attempt}"


def sha256_file(path: str | Path, chunk: int = 1 << 20) -> str:
    """Streaming sha256 of a file — the manifest's per-shard integrity
    anchor."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: into pinned memory without waiting (the
    caller synchronises) for a CUDA tensor, a clone for a CPU one."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


def snapshot_train_state(state: Any) -> dict:
    """Copy this process's part of every leaf to host memory and wait for
    the copies.

    Called on the train loop's thread before the next step: that step
    updates the parameters and moments in place, so every copy is
    complete when this returns.  The (slow) disk write happens later on
    the writer thread against this host copy.  A DTensor leaf gives its
    local block with its global index, when this rank owns it; a plain
    leaf is copied whole by rank 0 only, so a replicated block is written
    once."""
    from torch.distributed.tensor import DTensor

    leaves = state_leaves(state)
    rank = _process()[0]
    blobs, pending = {}, []
    for i, (_, t) in enumerate(leaves):
        if isinstance(t, DTensor):
            if not mesh_lib.owns(t):
                continue
            mesh = t.device_mesh
            index = mesh_lib.shard_index(
                mesh_lib.dtensor_spec(t), t.shape, mesh_lib.mesh_sizes(mesh),
                mesh_lib.mesh_coordinate(mesh))
            local = mesh_lib.local_tensor(t)
        elif rank == 0:
            index, local = [[0, s] for s in t.shape], t
        else:
            continue
        blobs[f"{i}/0"] = {"index": index, "data": _to_host(local)}
        pending.append(local.device)
    for dev in {d for d in pending if d.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()
    meta = [{"path": path, "shape": list(t.shape),
             "dtype": _dtype_name(t.dtype)} for path, t in leaves]
    return {"meta": meta, "blobs": blobs}


def snapshot_nbytes(snapshot: dict) -> int:
    """Bytes of a snapshot's host copy."""
    return sum(b["data"].numel() * b["data"].element_size()
               for b in snapshot["blobs"].values())


def _byte_view(t: torch.Tensor) -> np.ndarray:
    """The bytes of a contiguous host tensor as a flat uint8 array, no
    copy (bf16 included: numpy has no bfloat16)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _write_host_file(staging: Path, snapshot: dict,
                     process_index: int) -> None:
    index = {
        key: {"index": blob["index"], "shape": list(blob["data"].shape),
              "dtype": _dtype_name(blob["data"].dtype)}
        for key, blob in snapshot["blobs"].items()
    }
    arrays = {key.replace("/", "_"): _byte_view(blob["data"])
              for key, blob in snapshot["blobs"].items()}
    host_file = staging / f"host_{process_index:05d}.npz"
    # tmp + os.replace: a partially-written file is never visible under
    # its final name (.tmp-* does not match the host_*.npz glob)
    tmp = staging / f"{host_file.name}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, __index__=np.array(json.dumps(index)), **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, host_file)


def _write_manifest(staging: Path, snapshot_meta: List[dict], step: int,
                    num_processes: int) -> None:
    manifest = {
        "format": 1,
        "step": int(step),
        "num_processes": int(num_processes),
        "leaves": snapshot_meta,
        # per-shard-file sha256; older manifests lack the key, readers
        # must tolerate that
        "checksums": {p.name: sha256_file(p)
                      for p in sorted(staging.glob("host_*.npz"))},
    }
    write_file_atomic(staging / MANIFEST_NAME, json.dumps(manifest).encode())


def stage_snapshot(directory: str | Path, snapshot: dict, step: int, *,
                   process_index: Optional[int] = None,
                   attempt: Optional[int] = None) -> Path:
    """Write this process's shard file into the step's staging dir (not
    yet published).  Every process stages into the same dir on a shared
    filesystem; rank 0 publishes only after all have (see
    :class:`AsyncCheckpointer`).  ``process_index`` defaults to the
    process group's rank.  The staging dir is scoped to this submission's
    retry ``attempt`` (env-derived by default, the same on every rank), so
    files staged by a crashed earlier attempt, perhaps of a bigger mesh,
    never count toward this attempt's barrier."""
    if process_index is None:
        process_index = _process()[0]
    staging = Path(directory) / _staging_dirname(step, attempt)
    staging.mkdir(parents=True, exist_ok=True)
    _write_host_file(staging, snapshot, process_index)
    return staging


def publish_snapshot(directory: str | Path, snapshot_meta: List[dict],
                     step: int, *, num_processes: Optional[int] = None,
                     keep_last: Optional[int] = None,
                     attempt: Optional[int] = None) -> Path:
    """Publish a fully-staged step: manifest + atomic rename + LATEST +
    pruning.  Rank 0 only, and only after every process has staged;
    ``num_processes`` defaults to the process group's size."""
    if num_processes is None:
        num_processes = _process()[1]
    directory = Path(directory)
    final = directory / _step_dirname(step)
    staging = directory / _staging_dirname(step, attempt)
    # drop shard files whose host index exceeds this save's host count
    # (same-attempt leftovers of a bigger mesh): read_snapshot refuses any
    # published step whose file count mismatches the manifest
    for p in staging.glob("host_*.npz"):
        try:
            if int(p.stem.split("_")[1]) >= num_processes:
                p.unlink()
        except (ValueError, OSError):
            continue
    _write_manifest(staging, snapshot_meta, step, num_processes)
    publish_dir_atomic(staging, final)
    write_file_atomic(directory / LATEST_NAME, str(int(step)).encode())
    # this step is now published: any other attempt's staging leftovers
    # for the same step are garbage by definition
    for p in directory.glob(f"{_step_dirname(step)}.tmp*"):
        shutil.rmtree(p, ignore_errors=True)
    if keep_last is not None:
        prune_snapshots(directory, keep_last)
    return final


def write_snapshot(directory: str | Path, snapshot: dict, step: int, *,
                   keep_last: Optional[int] = None,
                   attempt: Optional[int] = None) -> Path:
    """Stage + publish in one call, as the one process of a run (several
    processes go through :class:`AsyncCheckpointer`, whose rank 0 waits
    for the others' files between the two halves)."""
    stage_snapshot(directory, snapshot, step, process_index=0,
                   attempt=attempt)
    return publish_snapshot(directory, snapshot["meta"], step,
                            num_processes=1, keep_last=keep_last,
                            attempt=attempt)


def list_snapshot_steps(directory: str | Path) -> List[int]:
    """Published (complete) steps, ascending."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    out = []
    for p in directory.iterdir():
        name = p.name
        if (p.is_dir() and name.startswith(_STEP_PREFIX)
                and "." not in name and (p / MANIFEST_NAME).exists()):
            try:
                out.append(int(name[len(_STEP_PREFIX):]))
            except ValueError:
                continue
    return sorted(out)


def latest_snapshot_step(directory: str | Path) -> Optional[int]:
    """Newest published step: the LATEST pointer when it names a complete
    step, else a directory scan (the pointer update is the last, least
    critical write — a crash between publish and pointer loses nothing)."""
    directory = Path(directory)
    steps = list_snapshot_steps(directory)
    try:
        pointed = int((directory / LATEST_NAME).read_text().strip())
        if pointed in steps:
            return pointed
    except (OSError, ValueError):
        pass
    return steps[-1] if steps else None


def prune_snapshots(directory: str | Path, keep_last: int) -> None:
    """Remove all but the newest ``keep_last`` published steps (and any
    stale staging dirs older than the newest published step)."""
    directory = Path(directory)
    steps = list_snapshot_steps(directory)
    for step in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(directory / _step_dirname(step), ignore_errors=True)
    if steps:
        for p in directory.glob(f"{_STEP_PREFIX}*.tmp*"):
            try:
                if int(p.name[len(_STEP_PREFIX):].split(".")[0]) < steps[-1]:
                    shutil.rmtree(p, ignore_errors=True)
            except ValueError:
                continue


def verify_snapshot_checksums(step_dir: str | Path,
                              manifest: Optional[dict] = None) -> None:
    """Raise ValueError when any host shard file mismatches the
    manifest's recorded sha256 (or is missing from it).  No-op for
    manifests written before checksums existed."""
    step_dir = Path(step_dir)
    if manifest is None:
        manifest = json.loads((step_dir / MANIFEST_NAME).read_text())
    checksums = manifest.get("checksums")
    if not checksums:
        return
    for host_file in sorted(step_dir.glob("host_*.npz")):
        want = checksums.get(host_file.name)
        if want is None:
            raise ValueError(
                f"{host_file.name} is not in the manifest's checksums — "
                "refusing a shard the publisher never recorded")
        got = sha256_file(host_file)
        if got != want:
            raise ValueError(
                f"{host_file.name} sha256 {got[:12]}… does not match the "
                f"manifest's {want[:12]}… — refusing a corrupt shard")


def _read_step_dir(step_dir: Path, verify: bool
                   ) -> Tuple[List[dict], List[torch.Tensor]]:
    """(leaf metadata, host tensors) of one published snapshot directory,
    rebuilt from every host's shard file."""
    manifest = json.loads((step_dir / MANIFEST_NAME).read_text())
    leaves_meta = manifest["leaves"]
    host_files = sorted(step_dir.glob("host_*.npz"))
    expected_hosts = int(manifest.get("num_processes", 1))
    if len(host_files) != expected_hosts:
        # fewer: a leaf half-covered by the surviving files would resume
        # with its other half zeroed; more: stale shard files of another
        # mesh would overwrite fresh regions
        raise ValueError(
            f"snapshot {step_dir} has {len(host_files)} host shard file(s) "
            f"but the manifest records {expected_hosts} — refusing a "
            "partial restore")
    if verify:
        verify_snapshot_checksums(step_dir, manifest)
    globals_: List[Optional[torch.Tensor]] = [None] * len(leaves_meta)
    for host_file in host_files:
        with np.load(host_file) as z:
            index = json.loads(str(z["__index__"]))
            for key, entry in index.items():
                leaf_i = int(key.split("/")[0])
                m = leaves_meta[leaf_i]
                data = torch.from_numpy(z[key.replace("/", "_")]).view(
                    _torch_dtype(entry["dtype"])).reshape(entry["shape"])
                whole = [[0, s] for s in m["shape"]]
                if entry["index"] == whole:
                    globals_[leaf_i] = data
                    continue
                if globals_[leaf_i] is None:
                    globals_[leaf_i] = torch.zeros(
                        m["shape"], dtype=_torch_dtype(m["dtype"]))
                globals_[leaf_i][tuple(
                    slice(s, e) for s, e in entry["index"])] = data
    missing = [leaves_meta[i]["path"] for i, g in enumerate(globals_)
               if g is None]
    if missing:
        raise ValueError(
            f"snapshot {step_dir} is missing data for "
            f"{missing[:3]}{'…' if len(missing) > 3 else ''} — host shard "
            "file(s) absent")
    return leaves_meta, globals_


def _template_items(template: Any) -> List[Tuple[str, Any]]:
    """(path, template leaf) in snapshot order; a TrainState template's
    moments mirror its params, its counters are int32 scalars and its
    ``buffers`` come last."""
    if not isinstance(template, TrainState):
        return _tree_items(template, "")
    params = _tree_items(template.params, ".params")
    mu_paths, nu_paths = _moment_paths([p for p, _ in params])
    scalar = torch.empty((), dtype=torch.int32, device="meta")
    return (params + [(f"{_ADAM_PATH}.count", scalar)]
            + list(zip(mu_paths, [t for _, t in params]))
            + list(zip(nu_paths, [t for _, t in params]))
            + [(".step", scalar)] + _buffer_items(template))


def _restore(template: Any, leaves_meta: List[dict],
             tensors: List[torch.Tensor], where: str, device: Device) -> Any:
    """The snapshot's tensors in ``template``'s structure.

    ``template`` is a :class:`TrainState` from ``train.state_template``
    (params as meta tensors, ``opt_state`` the AdamW that will own the
    moments) or a tree of dicts and lists of tensors.  Every path, shape
    and dtype must match.  Each leaf is copied to the device once: the
    template leaf's own, or ``device`` (CUDA by default) for a meta one.
    """
    from torch.distributed.tensor import DTensor

    items = _template_items(template)
    if len(items) != len(tensors):
        raise ValueError(f"template has {len(items)} leaves but {where} "
                         f"has {len(tensors)}")
    for (path, t), m in zip(items, leaves_meta):
        want = (path, list(t.shape), _dtype_name(t.dtype))
        got = (m["path"], m["shape"], m["dtype"])
        if want != got:
            raise ValueError(f"{where}: leaf {got} does not match the "
                             f"template's {want}")
    meta = (resolve_device(device)
            if any(t.device.type == "meta" for _, t in items) else None)

    def place(t, x):
        if isinstance(t, DTensor):
            # this rank's block of the whole leaf, onto the template's
            # placements (a smaller mesh's, after an elastic shrink)
            mesh = t.device_mesh
            index = mesh_lib.shard_index(
                mesh_lib.dtensor_spec(t), t.shape, mesh_lib.mesh_sizes(mesh),
                mesh_lib.mesh_coordinate(mesh))
            block = x[tuple(slice(a, b) for a, b in index)]
            return _like(
                mesh_lib.copy_to(block, mesh_lib.mesh_device(mesh)), t)
        return x.to(meta if t.device.type == "meta" else t.device)

    by_path = {path: place(t, x) for (path, t), x in zip(items, tensors)}
    if not isinstance(template, TrainState):
        return _rebuild(template, "", by_path)
    params = _rebuild(template.params, ".params", by_path)
    opt = template.opt_state.init(params)
    count = float(by_path[f"{_ADAM_PATH}.count"])
    for path, p in _tree_items(params, ".params"):
        p.requires_grad_(True)
        tail = path[len(".params"):]
        local = mesh_lib.local_tensor(p)
        opt.state[local] = {
            # torch's fused AdamW keeps its step as f32 on the device
            "step": torch.tensor(count, dtype=torch.float32,
                                 device=local.device),
            "exp_avg": mesh_lib.local_tensor(
                by_path[f"{_ADAM_PATH}.mu{tail}"]),
            "exp_avg_sq": mesh_lib.local_tensor(
                by_path[f"{_ADAM_PATH}.nu{tail}"])}
    buffers = (None if template.buffers is None
               else _rebuild(template.buffers, ".buffers", by_path))
    return TrainState(params=params, opt_state=opt,
                      step=int(by_path[".step"]), buffers=buffers)


def _rebuild(tree, prefix: str, by_path: dict):
    """A tree shaped as ``tree`` (its own key order) whose leaves are
    ``by_path``'s under :func:`_tree_items`'s paths."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, f"{prefix}[{k!r}]", by_path)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, f"{prefix}[{i}]", by_path)
                for i, v in enumerate(tree)]
    return by_path[prefix]


def read_snapshot(directory: str | Path, template: Any,
                  step: Optional[int] = None, *, verify: bool = False,
                  device: Device = None) -> Tuple[Any, int]:
    """``(state, step)`` from a published snapshot (the newest when
    ``step`` is None), in ``template``'s structure (see :func:`_restore`):
    a TrainState template gives a TrainState whose AdamW carries the
    moments and step count on, so the bias correction continues."""
    directory = Path(directory)
    if step is None:
        step = latest_snapshot_step(directory)
        if step is None:
            raise FileNotFoundError(f"no published snapshot under {directory}")
    step_dir = directory / _step_dirname(step)
    meta, tensors = _read_step_dir(step_dir, verify)
    return _restore(template, meta, tensors, f"snapshot step {step}",
                    device), step


class PreemptionGuard:
    """SIGTERM/spot-notice awareness for train loops.

    Installs (chaining) signal handlers that set an event; the loop polls
    :attr:`preempted` once per step and triggers its emergency checkpoint
    flush.  ``trigger()`` lets tests — or an out-of-band preemption-notice
    watcher — fire the same path without a real signal.  Signal handlers
    only install from the main thread; elsewhere the guard degrades to the
    manual ``trigger()`` surface.
    """

    def __init__(self, signals=(signal.SIGTERM,)) -> None:
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict = {}
        self._installed = False

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def trigger(self) -> None:
        self._event.set()

    def _handler(self, signum, frame) -> None:
        self._event.set()
        prev = self._previous.get(signum)
        if callable(prev):
            prev(signum, frame)

    def install(self) -> "PreemptionGuard":
        try:
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self._handler)
            self._installed = True
        except ValueError:
            # not the main thread (first signal.signal raises, nothing to
            # undo) or an invalid signal part-way through the tuple: put
            # back whatever was already swapped so our handler never
            # outlives the guard, then degrade to manual trigger only
            for sig, prev in self._previous.items():
                try:
                    signal.signal(
                        sig, prev if prev is not None else signal.SIG_DFL)
                except ValueError:
                    pass
            self._previous.clear()
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        self._previous.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


class AsyncCheckpointer:
    """Periodic async snapshots with bounded keep-last-k retention.

    The train loop calls :meth:`maybe_save` once per step: on cadence it
    pays only the device->host copy; the npz write + atomic publish
    happen on a dedicated writer thread.  The pending queue is bounded and
    LATEST-WINS: if the writer falls behind, the oldest unwritten snapshot
    is dropped rather than stalling training or growing host memory.
    ``save(..., block=True)`` is the emergency-flush path (preemption
    notice): it enqueues and then drains the queue synchronously.

    ``copy_seconds`` and ``write_seconds`` (step -> seconds) record the
    loop thread's copy and the writer's stage + publish of each snapshot.

    Several processes (a sharded state): every rank stages its own file,
    and rank 0's writer publishes once all ``num_processes`` files are
    staged (:meth:`_await_staged`); the queue then blocks instead of
    dropping, since ranks dropping different steps would strand rank 0's
    barrier.  ``process_index`` and ``num_processes`` default to the
    process group's rank and size.
    """

    def __init__(self, directory: str | Path, *, keep_last: int = 3,
                 every_steps: int = 100,
                 process_index: Optional[int] = None,
                 num_processes: Optional[int] = None,
                 stage_timeout: float = 300.0,
                 attempt: Optional[int] = None) -> None:
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.every_steps = max(int(every_steps), 1)
        rank, world = _process()
        self._process_index = rank if process_index is None else process_index
        self._num_processes = world if num_processes is None else num_processes
        #: staging-dir scope: this submission's retry attempt (the same on
        #: every rank), resolved once so an env mutation mid-run cannot
        #: split the staging dirs
        self._attempt = _current_attempt() if attempt is None else int(attempt)
        #: several processes: how long rank 0's writer waits for every
        #: rank's file before giving the step up (a rank was likely lost)
        self.stage_timeout = float(stage_timeout)
        self._queue: "queue.Queue[tuple]" = queue.Queue(maxsize=2)
        self._errors: List[BaseException] = []
        self._last_published: Optional[int] = None
        self._last_enqueued: Optional[int] = None
        self._dropped = 0
        self._lock = threading.Lock()  # queue drop/put exchange only
        self._thread: Optional[threading.Thread] = None
        self.copy_seconds: Dict[int, float] = {}
        self.write_seconds: Dict[int, float] = {}
        self.snapshot_bytes = 0

    # -- writer thread ----------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer, daemon=True, name="ckpt-writer")
            self._thread.start()

    def _writer(self) -> None:
        while True:
            step, snapshot = self._queue.get()
            try:
                if step is None:
                    return  # close() sentinel
                self._write(step, snapshot)
            except BaseException as e:  # noqa: BLE001 — surfaced on flush
                logger.exception("checkpoint write for step %s failed", step)
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def _write(self, step: int, snapshot: dict) -> None:
        t0 = time.perf_counter()
        stage_snapshot(self.directory, snapshot, step,
                       process_index=self._process_index,
                       attempt=self._attempt)
        if self._process_index == 0:
            if self._num_processes > 1:
                # a filesystem barrier, never a collective: this thread
                # runs beside the train loop's own collectives.  Raises on
                # timeout: the step is abandoned unpublished.
                self._await_staged(step, self._num_processes)
            publish_snapshot(self.directory, snapshot["meta"], step,
                             num_processes=self._num_processes,
                             keep_last=self.keep_last, attempt=self._attempt)
        self.write_seconds[step] = time.perf_counter() - t0
        self._last_published = step

    def _await_staged(self, step: int, num_processes: int) -> None:
        """Wait until ``num_processes`` shard files are staged for ``step``
        under this attempt (files are renamed into place complete)."""
        staging = self.directory / _staging_dirname(step, self._attempt)
        deadline = time.monotonic() + self.stage_timeout
        while True:
            present = len(list(staging.glob("host_*.npz")))
            if present >= num_processes:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"checkpoint step {step}: {present}/{num_processes} "
                    f"processes staged after {self.stage_timeout:.0f}s — "
                    "refusing to publish a partial snapshot")
            time.sleep(0.05)

    # -- producer API ------------------------------------------------------

    @property
    def last_published(self) -> Optional[int]:
        return self._last_published

    @property
    def last_enqueued(self) -> Optional[int]:
        return self._last_enqueued

    @property
    def dropped(self) -> int:
        """Snapshots skipped because the writer fell behind."""
        return self._dropped

    def maybe_save(self, state: Any, step: int) -> bool:
        """Snapshot + enqueue when ``step`` is on the cadence."""
        if step % self.every_steps != 0:
            return False
        self.save(state, step)
        return True

    def save(self, state: Any, step: int, block: bool = False) -> None:
        """Snapshot now (device->host, complete before returning: the next
        step updates the state in place) and enqueue the disk write.
        ``block=True`` = emergency flush: wait until this snapshot is
        published before returning.  A full queue drops the oldest
        PENDING snapshot (latest wins — checkpointing must never stall
        training)."""
        self._raise_pending_errors()
        t0 = time.perf_counter()
        snapshot = snapshot_train_state(state)
        self.copy_seconds[int(step)] = time.perf_counter() - t0
        self.snapshot_bytes = snapshot_nbytes(snapshot)
        self._ensure_thread()
        if self._num_processes > 1:
            # every rank must stage every step rank 0 waits for
            self._queue.put((int(step), snapshot))
            self._last_enqueued = int(step)
        else:
            with self._lock:
                try:
                    self._queue.put_nowait((int(step), snapshot))
                except queue.Full:
                    # latest wins: drop the oldest PENDING snapshot (never
                    # the one being written)
                    try:
                        self._queue.get_nowait()
                        self._queue.task_done()
                        self._dropped += 1
                    except queue.Empty:
                        pass
                    self._queue.put((int(step), snapshot))
                self._last_enqueued = int(step)
        if block:
            self.flush()

    def flush(self) -> None:
        """Block until every enqueued snapshot is published; re-raise the
        first writer error if any write failed."""
        self._queue.join()
        self._raise_pending_errors()

    def _raise_pending_errors(self) -> None:
        if self._errors:
            err = self._errors[0]
            self._errors = []
            raise RuntimeError("checkpoint writer failed") from err

    def close(self) -> None:
        """Drain the queue, stop the writer, and RAISE if any write failed
        — a caller that only ever close()es (final step already enqueued
        via maybe_save, so the flush path is skipped) must still learn
        that the newest published checkpoint is not the step it thinks."""
        self._queue.join()
        if self._thread is not None and self._thread.is_alive():
            self._queue.put((None, None))
            self._thread.join(timeout=10)
        self._thread = None
        self._raise_pending_errors()


# -- whole-state save/restore -------------------------------------------------


def save_train_state(path: str | Path, state: Any) -> None:
    """Persist a TrainState (or a tree of tensors) atomically at ``path``.

    One snapshot directory (manifest + ``host_00000.npz``, the layout of
    the periodic snapshots) is written into a scratch directory next to
    the target and published with :func:`publish_dir_atomic` only once
    complete, so a preemption mid-write never touches the old checkpoint.
    Not Orbax-compatible: the JAX package's ``save_train_state`` writes an
    Orbax checkpoint at the same call."""
    if _process()[1] > 1:
        raise NotImplementedError(
            "save_train_state writes one process's state; several processes "
            "save through AsyncCheckpointer")
    path = Path(path).absolute()
    tmp = path.with_name(path.name + f".tmp-{os.getpid()}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    snapshot = snapshot_train_state(state)
    _write_host_file(tmp, snapshot, 0)
    step = state.step if isinstance(state, TrainState) else 0
    _write_manifest(tmp, snapshot["meta"], int(step), 1)
    publish_dir_atomic(tmp, path)


def restore_train_state(path: str | Path, template: Any,
                        device: Device = None) -> Any:
    """Restore what :func:`save_train_state` wrote into ``template``'s
    structure (see :func:`_restore`).

    When ``path`` is missing but a ``<path>.prev-*`` sibling exists, the
    newest one is restored — recovery for a crash inside
    `publish_dir_atomic`'s rename window (the old checkpoint was renamed
    aside, the new one never landed)."""
    p = Path(path).absolute()
    if not p.exists():
        prevs = sorted(p.parent.glob(p.name + ".prev-*"))
        if prevs:
            p = prevs[-1]
    meta, tensors = _read_step_dir(p, verify=False)
    return _restore(template, meta, tensors, f"checkpoint {p}", device)


# -- Hugging Face Llama import ----------------------------------------------

#: safetensors dtype names this reader takes
_SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
                       "F32": torch.float32}


def read_safetensors(path: str | Path) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor of one ``.safetensors`` file.

    The format: a little-endian u64 header length, a JSON header mapping
    each name to its ``dtype``, ``shape`` and ``data_offsets`` (begin, end
    in the byte buffer after the header; ``__metadata__`` aside), then the
    buffer.  The tensors are views of a copy-on-write memory map, so a
    large file is never held twice: its pages are read as the tensors
    are used."""
    path = Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    size = path.stat().st_size - 8 - n
    data = (np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n)
            if size > 0 else np.zeros(0, np.uint8))
    out = {}
    for name, info in header.items():
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(
                f"{path.name}: {name} is {info['dtype']}; only "
                f"{', '.join(_SAFETENSORS_DTYPES)} are read")
        begin, end = info["data_offsets"]
        shape = [int(s) for s in info["shape"]]
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if end - begin != nbytes or end > size:
            raise ValueError(f"{path.name}: {name} has data_offsets "
                             f"{begin}..{end} for {nbytes} bytes of a "
                             f"{size}-byte buffer")
        out[name] = torch.from_numpy(data[begin:end]).view(dtype).reshape(
            shape)
    return out


def _hf_tensors(ckpt_dir: Path) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor across every *.safetensors shard in the dir."""
    files = sorted(ckpt_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {ckpt_dir}")
    tensors = {}
    for f in files:
        tensors.update(read_safetensors(f))
    return tensors


def config_from_hf(ckpt_dir: str | Path, **overrides) -> LlamaConfig:
    """Build a LlamaConfig from the checkpoint's config.json."""
    cfg = json.loads((Path(ckpt_dir) / "config.json").read_text())
    rope_scaling = None
    rs = cfg.get("rope_scaling") or {}
    rs_type = rs.get("rope_type") or rs.get("type")
    if rs_type == "llama3":
        rope_scaling = RopeScaling(
            factor=float(rs.get("factor", 8.0)),
            low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            original_max_position=int(
                rs.get("original_max_position_embeddings", 8192)),
        )
    elif rs_type not in (None, "default"):
        # linear/dynamic/yarn etc.: silently dropping the scaling would
        # serve garbage past the original context window
        raise ValueError(
            f"unsupported rope_scaling type {rs_type!r} in {ckpt_dir}: "
            "only llama3 scaling is implemented (ops/rotary.py)")
    num_heads = int(cfg["num_attention_heads"])
    head_dim = int(cfg.get("head_dim")
                   or cfg["hidden_size"] // num_heads)
    kw: dict = dict(
        vocab_size=int(cfg["vocab_size"]),
        hidden_size=int(cfg["hidden_size"]),
        intermediate_size=int(cfg["intermediate_size"]),
        num_layers=int(cfg["num_hidden_layers"]),
        num_heads=num_heads,
        num_kv_heads=int(cfg.get("num_key_value_heads", num_heads)),
        head_dim=head_dim,
        # ABSENT keys take transformers' own defaults (Llama-2-era
        # config.json files omit them), not this package's Llama-3 ones
        rope_theta=float(cfg.get("rope_theta", 10_000.0)),
        rope_scaling=rope_scaling,
        rms_eps=float(cfg.get("rms_norm_eps", 1e-6)),
        max_seq_len=int(cfg.get("max_position_embeddings", 8192)),
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


def load_hf_llama(ckpt_dir: str | Path, cfg: Optional[LlamaConfig] = None,
                  dtype: Optional[torch.dtype] = None,
                  device: Device = None) -> Tuple[LlamaConfig, Params]:
    """HF Llama checkpoint directory -> (config, stacked param tree) on
    ``device`` (CUDA unless the caller names another), in ``dtype`` (the
    config's, bf16 by default).

    HF linear weights are [out_features, in_features]; the port's matmuls
    take [in, out]: each weight's file bytes are copied to the device as
    they are, then transposed and cast there into its [L, ...] stacked
    buffer."""
    ckpt_dir = Path(ckpt_dir)
    if cfg is None:
        cfg = config_from_hf(ckpt_dir)
    if dtype is not None and dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    dev = resolve_device(device)
    t = _hf_tensors(ckpt_dir)

    def load(name: str, transpose: bool, out: Optional[torch.Tensor] = None):
        src = t[name].T if transpose else t[name]
        if out is None:
            out = torch.empty(src.shape, dtype=cfg.dtype, device=dev)
        return out.copy_(src.to(dev))

    def stack(fmt: str, transpose: bool = True) -> torch.Tensor:
        first = load(fmt.format(0), transpose)
        out = torch.empty((cfg.num_layers, *first.shape), dtype=cfg.dtype,
                          device=dev)
        out[0] = first
        for i in range(1, cfg.num_layers):
            load(fmt.format(i), transpose, out[i])
        return out

    params: Params = {
        "embed": load("model.embed_tokens.weight", False),
        "layers": {
            "attn_norm": stack("model.layers.{}.input_layernorm.weight",
                               transpose=False),
            "wq": stack("model.layers.{}.self_attn.q_proj.weight"),
            "wk": stack("model.layers.{}.self_attn.k_proj.weight"),
            "wv": stack("model.layers.{}.self_attn.v_proj.weight"),
            "wo": stack("model.layers.{}.self_attn.o_proj.weight"),
            "mlp_norm": stack(
                "model.layers.{}.post_attention_layernorm.weight",
                transpose=False),
            "w_gate": stack("model.layers.{}.mlp.gate_proj.weight"),
            "w_up": stack("model.layers.{}.mlp.up_proj.weight"),
            "w_down": stack("model.layers.{}.mlp.down_proj.weight"),
        },
        "final_norm": load("model.norm.weight", False),
    }
    if not cfg.tie_embeddings:
        if "lm_head.weight" in t:
            params["lm_head"] = load("lm_head.weight", True)
        else:  # checkpoint ties even though config doesn't say so
            cfg = dataclasses.replace(cfg, tie_embeddings=True)
    return cfg, params
