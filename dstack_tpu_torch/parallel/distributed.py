"""The resume contract between the control plane and a training job.

When a spot-interrupted job is resubmitted by its retry policy, the new
submission's environment carries the variables below, so the job resumes
from its last published snapshot instead of starting over
(:func:`dstack_tpu_torch.models.train.resume_train_state` reads
``resume_from``).  The names are the control plane's; this module is the
port's own copy of them.  The process-group bootstrap for multi-host
training is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional

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
