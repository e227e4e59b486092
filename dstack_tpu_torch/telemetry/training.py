"""Train-step telemetry: opt-in wall-clock/MFU wrapper for make_train_step.

The bare train step returns without waiting for the card (callers queue
steps and read a loss when they need one), so the wrapper is OPT-IN: it
reads the loss on the host every step to get a true per-step wall time,
which drains the queue.  Use it in monitoring-grade training loops and
calibration runs, not in the timed region of a throughput run.

Metric names (prefix ``dstack_train_``, the JAX package's set):

- ``step_seconds``      histogram — per-step wall time (a step recorded
  as a recompile is left out of it and counted in ``recompiles_total``)
- ``steps_total`` / ``tokens_total`` / ``recompiles_total`` counters.
  The port's step is eager PyTorch with no compile cache, so ``wrap``
  never records a recompile: ``recompiles_total`` is exposed and stays 0
  unless a caller passes ``recompiled=True`` to ``record_step``
- ``tokens_per_sec`` / ``mfu`` gauges — from the last measured step;
  MFU = the step's model operations (:func:`step_flops`) / wall / peak,
  the peak defaulting to the H100 SXM's dense bf16 rate
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from dstack_tpu_torch.telemetry.recorder import (
    MetricsRecorder,
    percentiles_from_snapshot,
)

logger = logging.getLogger(__name__)

#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet; chip_smoke.py
#: uses the same figure for its MFU)
H100_PEAK_BF16_FLOPS = 989e12

#: step-time buckets: 10 ms .. 120 s (covers tiny CPU test shapes through
#: full-depth steps)
STEP_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                30.0, 60.0, 120.0)

PREFIX = "dstack_train_"


def active_params(cfg) -> int:
    """The weights a token multiplies in a Llama or MoE config: every
    layer's attention and MLP (an MoE layer's ``experts_per_token``
    experts and its router, not all of its experts) and the output head;
    the embedding lookup and the norms multiply nothing."""
    d = cfg.hidden_size
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    mlp = 3 * d * cfg.intermediate_size * getattr(cfg, "experts_per_token",
                                                  1)
    router = d * getattr(cfg, "num_experts", 0)
    return cfg.num_layers * (attn + mlp + router) + d * cfg.vocab_size


def step_flops(cfg, batch: int, seq: int) -> int:
    """Model operations of one training step on ``batch`` rows of ``seq``
    tokens: 6 per active weight per token (forward and backward), and
    causal attention's 14 * head_dim per kept (query, key) pair per query
    head and layer (forward QK and PV, five backward products).  Remat's
    recompute, padding and empty capacity slots are not model
    operations."""
    pairs = batch * seq * (seq + 1) // 2
    return (6 * active_params(cfg) * batch * seq
            + 14 * cfg.head_dim * pairs * cfg.num_heads * cfg.num_layers)


class TrainTelemetry:
    """Recorder + the ``wrap()`` factory that instruments a train step."""

    def __init__(self, num_params: Optional[int] = None,
                 peak_flops: float = H100_PEAK_BF16_FLOPS,
                 log_every: int = 50) -> None:
        #: a caller's own count (6 operations a token each) instead of a
        #: config's :func:`step_flops`
        self.num_params = num_params
        self.cfg = None
        self.peak_flops = peak_flops
        self.log_every = log_every
        self.recorder = MetricsRecorder()
        r = self.recorder
        self.step_seconds = r.histogram(PREFIX + "step_seconds",
                                        STEP_BUCKETS)
        self.steps_total = r.counter(PREFIX + "steps_total")
        self.tokens_total = r.counter(PREFIX + "tokens_total")
        self.recompiles_total = r.counter(PREFIX + "recompiles_total")
        self.tokens_per_sec = r.gauge(PREFIX + "tokens_per_sec")
        self.mfu = r.gauge(PREFIX + "mfu")

    def wrap(self, step_fn, cfg=None, n_devices: int = 1):
        """Wrap a ``(state, batch) -> (state, metrics)`` step.

        ``cfg`` gives each step's model operations (:func:`step_flops`
        at the batch's rows and length; under ``seq`` a rank's stripe
        counts as whole sequences of its length) when the telemetry was
        built without an explicit parameter count; without either, MFU
        stays 0 and the timing metrics still record.  ``n_devices``
        divides the model FLOPs for per-card MFU.  The timed window ends
        when the step's loss has been read on the host."""
        if self.num_params is None:
            self.cfg = cfg

        def instrumented(state, batch):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            float(metrics["loss"])
            b, s1 = batch["tokens"].shape
            flops = (step_flops(self.cfg, b, s1 - 1)
                     if self.cfg is not None else None)
            self.record_step(time.perf_counter() - t0, b * (s1 - 1),
                             n_devices, flops=flops)
            return state, metrics

        return instrumented

    def record_step(self, wall: float, tokens: int, n_devices: int = 1,
                    recompiled: bool = False,
                    flops: Optional[float] = None) -> None:
        """Record one measured step (also the entry point for callers
        that time steps themselves instead of using ``wrap``).  ``flops``:
        the step's model operations; without them MFU counts 6 *
        ``num_params`` a token, when that was given."""
        self.steps_total.inc()
        self.tokens_total.inc(tokens)
        if recompiled:
            self.recompiles_total.inc()
            return  # compile time must not enter the step-time histogram
        self.step_seconds.observe(wall)
        if wall > 0 and tokens:
            self.tokens_per_sec.set(tokens / wall)
            if flops is None and self.num_params:
                flops = 6.0 * self.num_params * tokens
            if flops:
                self.mfu.set(flops / wall / max(n_devices, 1)
                             / self.peak_flops)
        n = int(self.steps_total.value)
        if self.log_every and n % self.log_every == 0:
            p = percentiles_from_snapshot(self.step_seconds.snapshot())
            logger.info(
                "train step %d: %.3fs (p50 %.3fs) %.0f tok/s MFU %.1f%% "
                "recompiles %d", n, wall, p["p50"],
                self.tokens_per_sec.value, self.mfu.value * 100,
                int(self.recompiles_total.value))

    def prometheus_samples(self):
        return self.recorder.samples()

    def stats(self) -> dict:
        return self.recorder.summary()
