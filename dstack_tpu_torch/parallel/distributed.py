"""The contract between the control plane and a job: the process group, and
resume after a retry.

The control plane injects the cluster's topology into every job
(``dstack_tpu/core/knobs.py``):

- ``DSTACK_MASTER_NODE_IP``   — the coordinator host (node 0);
- ``DSTACK_NODE_RANK``        — this node's index;
- ``DSTACK_NODES_NUM``        — the number of nodes;
- ``DSTACK_GPUS_PER_NODE``    — cards on each node (default 1);
- ``DSTACK_GPUS_NUM``         — cards in all (checked when set);
- ``DSTACK_COORDINATOR_PORT`` — the coordinator's port (default 8476).

:func:`initialize` forms one ``torch.distributed`` process group from them:
NCCL on the card, gloo on the CPU, rendezvous at
``tcp://{DSTACK_MASTER_NODE_IP}:{DSTACK_COORDINATOR_PORT}``.  The one
difference from the JAX package, whose ``jax.distributed`` runs one
process per host: PyTorch runs one process per card.  The world is
``DSTACK_NODES_NUM x DSTACK_GPUS_PER_NODE`` processes; each process's
rank is ``DSTACK_NODE_RANK x DSTACK_GPUS_PER_NODE + LOCAL_RANK``
(``LOCAL_RANK``, the card's index on its node, defaults to 0, as a
launcher such as ``torchrun`` sets it), and it drives card ``LOCAL_RANK``.

When a spot-interrupted job is resubmitted by its retry policy, the new
submission's environment carries the resume variables below, so the job
resumes from its last published snapshot instead of starting over
(:func:`dstack_tpu_torch.models.train.resume_train_state` reads
``resume_from``).  The names are the control plane's; this module is the
port's own copy of them.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Union

import torch

logger = logging.getLogger(__name__)

DEFAULT_COORDINATOR_PORT = 8476

#: 1-based resubmission attempt (absent / unset on the first submission)
RESUME_ATTEMPT_ENV = "DSTACK_RETRY_ATTEMPT"
#: checkpoint directory to resume from — the job's own declared
#: DSTACK_CHECKPOINT_DIR, echoed back by the control plane on retry
RESUME_FROM_ENV = "DSTACK_RESUME_FROM"
#: termination reason of the attempt this one replaces (e.g.
#: "interrupted_by_no_capacity" for a spot preemption)
RESUME_REASON_ENV = "DSTACK_RETRY_REASON"
#: where the job publishes checkpoints; set by the user, read by the
#: control plane to build RESUME_FROM on retry
CHECKPOINT_DIR_ENV = "DSTACK_CHECKPOINT_DIR"


def resume_info() -> Optional[dict]:
    """Resume context injected by the control plane on retried submissions,
    or None on a first (non-retry) submission.

    ``{"attempt": int, "resume_from": Optional[str], "reason": str}``.
    """
    attempt = os.environ.get(RESUME_ATTEMPT_ENV)
    if not attempt:
        return None
    try:
        n = int(attempt)
    except ValueError:
        return None
    return {
        "attempt": n,
        "resume_from": (os.environ.get(RESUME_FROM_ENV)
                        or os.environ.get(CHECKPOINT_DIR_ENV) or None),
        "reason": os.environ.get(RESUME_REASON_ENV, ""),
    }


def _cluster(ip_default: Optional[str] = None) -> dict:
    """The group the variables describe, whatever its size."""
    nodes = int(os.environ.get("DSTACK_NODES_NUM", "1") or 1)
    per_node = int(os.environ.get("DSTACK_GPUS_PER_NODE", "1") or 1)
    world = nodes * per_node
    total = os.environ.get("DSTACK_GPUS_NUM")
    if total and int(total) != world:
        raise ValueError(
            f"DSTACK_GPUS_NUM={total} but DSTACK_NODES_NUM={nodes} x "
            f"DSTACK_GPUS_PER_NODE={per_node} = {world}")
    local_rank = int(os.environ.get("LOCAL_RANK", "0") or 0)
    if not 0 <= local_rank < per_node:
        raise ValueError(f"LOCAL_RANK={local_rank} is not a card of the "
                         f"{per_node} on this node")
    ip = os.environ.get("DSTACK_MASTER_NODE_IP", ip_default)
    if ip is None:
        raise KeyError("DSTACK_MASTER_NODE_IP")
    return {
        "coordinator_ip": ip,
        "coordinator_port": int(
            os.environ.get("DSTACK_COORDINATOR_PORT", DEFAULT_COORDINATOR_PORT)
        ),
        "num_processes": world,
        "process_id": int(os.environ.get("DSTACK_NODE_RANK", "0")) * per_node
        + local_rank,
        "local_rank": local_rank,
    }


def cluster_env() -> Optional[dict]:
    """The process group the control plane's variables describe, or None
    when the job is one process on one card.

    ``{"coordinator_ip", "coordinator_port", "num_processes", "process_id",
    "local_rank"}``: with one card per node the first four are the JAX
    package's ``cluster_env`` (one process per node)."""
    nodes = int(os.environ.get("DSTACK_NODES_NUM", "1") or 1)
    per_node = int(os.environ.get("DSTACK_GPUS_PER_NODE", "1") or 1)
    if nodes * per_node <= 1:
        return None
    return _cluster()


def initialize(force: bool = False,
               device: Optional[Union[str, torch.device]] = None,
               backend: Optional[str] = None) -> bool:
    """Form the ``torch.distributed`` process group from the injected
    variables.

    Returns True when a group was formed; False (and nothing done) when
    the job is one process on one card, unless ``force``: then a group of
    one forms (at the coordinator's address, 127.0.0.1 by default), so a
    single card drives the whole sharded path.  On the card (the default;
    raises without one) the backend is NCCL and the process takes card
    ``LOCAL_RANK`` as its current device; ``device="cpu"`` forms a gloo
    group.  ``backend`` names another (gloo on the card: ranks that share
    one card, which NCCL refuses)."""
    import torch.distributed as dist

    from dstack_tpu_torch.utils.device import resolve_device

    env = cluster_env()
    if env is None:
        if not force:
            logger.debug("one process on one card: no process group")
            return False
        env = _cluster(ip_default="127.0.0.1")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(env["local_rank"])
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    init_method = f"tcp://{env['coordinator_ip']}:{env['coordinator_port']}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=env["num_processes"],
                            rank=env["process_id"])
    logger.info("torch.distributed (%s) initialized: rank %s/%s via %s",
                backend, env["process_id"], env["num_processes"], init_method)
    return True
