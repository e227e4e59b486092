"""OpenAI-compatible HTTP server over the continuous-batching engine.

Standard-library HTTP (``http.server.ThreadingHTTPServer``): one thread per
connection, the engine on its own thread.  Endpoints: /health, /v1/models,
/v1/completions, /v1/chat/completions (non-streaming and SSE streaming, and
the two legs of prefill/decode disaggregation), /metrics (Prometheus text,
OpenMetrics on request), /stats, /load, /drain, /traces, /traces/{id}, and
the elastic routes: /elastic/compile/{key} (a kernel library from the
compile cache), /elastic/weights/manifest and /elastic/weights/{shard}
(the published snapshot, seeded to joining replicas), /elastic/standby
and /elastic/standby/activate.

Run: python -m dstack_tpu_torch.serving.server --config llama3-8b --paged
(CUDA by default; ``--device cpu`` runs on the CPU).

``--tensor-parallel N`` serves the model sharded over N cards of this
host, one process a card: the command's process is rank 0 (the HTTP
server and the scheduler) and starts the N - 1 others itself, each a
follower of rank 0's engine (serving/lockstep.py) on card ``LOCAL_RANK``
of one NCCL world; both prefill/decode legs run there too.  A follower
that exits, or a step that fails on rank 0, fails the replica: /health
and /load answer 503, the followers are killed and rank 0 exits
non-zero.

A replica's cold start (``dstack_tpu_torch/elastic/``): ``--weight-peers``
with ``--snapshot-dir`` pulls the published snapshot from a live replica
and serves it; ``--compile-cache``/``--compile-cache-peers`` resolve the
paged-decode kernel's library from a cache root or a peer instead of
running nvcc; ``--standby`` warms, then refuses /v1 until
``POST /elastic/standby/activate``.
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import os
import queue
import re
import socket
import subprocess
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from dstack_tpu_torch.elastic.compile_cache import (
    ENV_CACHE_DIR,
    ENV_CACHE_PEERS,
    CompileCache,
)
from dstack_tpu_torch.elastic.weight_stream import (
    ENV_SEED_RATE_BPS,
    ENV_WEIGHT_PEERS,
    WeightStreamError,
    pull_weights,
)
from dstack_tpu_torch.models.checkpoint import (
    MANIFEST_NAME,
    _dtype_name,
    _torch_dtype,
    latest_snapshot_step,
    load_hf_llama,
    read_snapshot,
)
from dstack_tpu_torch.models.llama import LlamaConfig, init_params
from dstack_tpu_torch.ops.flash_attention import paged_decode_attention
from dstack_tpu_torch.serving import deadlines
from dstack_tpu_torch.serving.engine import (
    EngineDraining,
    InferenceEngine,
    Request,
)
from dstack_tpu_torch.serving.tokenizer import ByteTokenizer, load_tokenizer
from dstack_tpu_torch.serving.wire import PD_PHASE_HEADER
from dstack_tpu_torch.telemetry import tracing
from dstack_tpu_torch.telemetry.exposition import render
from dstack_tpu_torch.telemetry.serving import (
    load_headers,
    make_engine_telemetry,
)

logger = logging.getLogger(__name__)

CONFIGS = {
    "tiny": LlamaConfig.tiny,
    "llama3-1b": LlamaConfig.llama3_1b,
    "llama3-8b": LlamaConfig.llama3_8b,
    "llama3-70b": LlamaConfig.llama3_70b,
}


def _arr_to_wire(t: torch.Tensor) -> dict:
    """An array as JSON: its raw bytes in base64, its shape and numpy's
    name of its dtype (bf16 travels as raw 2-byte words named
    "bfloat16"), the JAX replica's prefill_result encoding."""
    t = t.detach().cpu().contiguous()
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return {"b64": base64.b64encode(raw).decode(), "shape": list(t.shape),
            "dtype": _dtype_name(t.dtype)}


def _arr_from_wire(obj: dict) -> torch.Tensor:
    """Inverse of :func:`_arr_to_wire`: a host tensor, bit for bit."""
    raw = np.frombuffer(base64.b64decode(obj["b64"]), np.uint8).copy()
    return torch.from_numpy(raw).view(_torch_dtype(obj["dtype"])).reshape(
        obj["shape"])


class Response:
    """A finished (non-streaming) HTTP response."""

    def __init__(self, status: int, body: bytes, content_type: str,
                 headers: Optional[dict] = None) -> None:
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = dict(headers or {})


def json_response(obj, status: int = 200,
                  headers: Optional[dict] = None) -> Response:
    return Response(status, json.dumps(obj).encode(), "application/json",
                    headers)


#: chunk of a seeded shard file (and of its pacing)
SEED_CHUNK_BYTES = 1 << 20
_SHARD_NAME = re.compile(r"host_\d{5}\.npz")


class ServingApp:
    def __init__(self, engine: InferenceEngine, tokenizer,
                 model_name: str = "dstack-tpu-model",
                 snapshot_dir: Optional[str] = None, standby: bool = False,
                 seed_rate_bps: float = 0.0,
                 weight_pull: Optional[dict] = None) -> None:
        self.engine = engine
        #: why the replica can no longer serve (a tensor-parallel rank
        #: exited), or None
        self.failed: Optional[str] = None
        self.tokenizer = tokenizer
        self.model_name = model_name
        #: published snapshot dir this replica can SEED to joining peers
        #: (GET /elastic/weights/*) — None disables the seeding routes
        self.snapshot_dir = snapshot_dir
        #: seeder-side transfer pacing (bytes/s; 0 = unlimited) so weight
        #: streaming stays below serving traffic
        self.seed_rate_bps = float(seed_rate_bps)
        #: standby replica: warmed but refusing /v1 until the gateway
        #: activates it (POST /elastic/standby/activate)
        self.standby = standby
        #: still warming (the kernel's library resolved, one request
        #: driven) — reported on /load as ``warming`` so routers and
        #: admission never count this replica as capacity
        self.warming = False
        self._activated_at: Optional[float] = None
        #: the startup's weight pull report (elastic/weight_stream.py
        #: pull_weights), or None when it pulled nothing
        self.weight_pull = weight_pull
        #: request tracer — rides the engine's telemetry so scheduler spans
        #: and HTTP spans share one ring; None when telemetry or tracing is
        #: off
        self.tracer = getattr(
            getattr(engine, "telemetry", None), "tracer", None)
        self._thread = threading.Thread(
            target=engine.run_forever, daemon=True, name="engine")

    def start_engine(self, warm: bool = False) -> None:
        """Start the engine loop; ``warm=True`` first drives one warmup
        request on a background thread (the kernel's library built or
        pulled from the compile cache, the card's first launches made)
        with ``warming`` visible on ``/load`` the whole time, then starts
        the loop.  The warmup runs BEFORE the engine thread so the two
        never race ``step()``."""
        if not warm:
            self._thread.start()
            return
        self.warming = True

        def _warm() -> None:
            try:
                self.engine.warmup()
            except Exception:  # noqa: BLE001 — warming must not wedge
                logger.exception("standby warmup failed")
            finally:
                self.warming = False
                self._thread.start()

        threading.Thread(target=_warm, daemon=True,
                         name="engine-warm").start()

    def activate_standby(self) -> dict:
        """Flip a standby replica live: the entire scale-up critical
        path once warming is done — no provision, no weights, no
        compile.  Idempotent; returns the activation report."""
        was_standby = self.standby
        self.standby = False
        if was_standby and self._activated_at is None:
            self._activated_at = time.time()
        return {"activated": was_standby, "warming": bool(self.warming),
                "standby": False}

    def join_engine(self, timeout: float) -> None:
        """Wait for the engine thread to end after ``engine.stop()`` (a
        sharded engine's rank 0 then releases its followers)."""
        if self._thread.is_alive():
            self._thread.join(timeout)

    # -- request plumbing -------------------------------------------------

    def _make_request(self, prompt_ids, payload) -> Request:
        return Request(
            tokens=prompt_ids,
            max_new_tokens=int(payload.get("max_tokens", 128)),
            temperature=float(payload.get("temperature") or 0.0),
            top_p=float(payload.get("top_p") or 1.0),
            top_k=int(payload.get("top_k") or 0),
            eos_id=self.tokenizer.eos_id,
        )

    def _install_stop(self, req: Request, payload) -> dict:
        """OpenAI ``stop`` sequences: watch the decoded text as tokens
        arrive, cancel the request at the first match, and remember the
        clip offset so responses exclude the stop string.  Chains any
        on_token already installed.  Returns the watcher state."""
        stops = payload.get("stop")
        if isinstance(stops, str):
            stops = [stops]
        # non-string entries must not reach the engine thread
        stops = [s for s in (stops or []) if isinstance(s, str) and s][:4]
        state: dict = {"clip": None, "stops": stops}
        req._stop_state = state
        if not stops:
            return state
        prev = req.on_token
        # runs per token on the engine thread: scan only a bounded decoded
        # tail (bounded by ENCODED length: a multi-byte stop string can
        # span one token per UTF-8 byte)
        tail_tokens = max(len(s.encode("utf-8")) for s in stops) + 8

        def watch(token: int) -> None:
            if prev is not None:
                prev(token)
            if state["clip"] is not None:
                return
            tail = self.tokenizer.decode(req.output[-tail_tokens:])
            if not any(s in tail for s in stops):
                return
            text = self.tokenizer.decode(req.output)
            hits = [i for i in (text.find(s) for s in stops) if i >= 0]
            if hits:
                state["clip"] = min(hits)
                req.cancel(reason="stop")

        req.on_token = watch
        return state

    @staticmethod
    def _clip_text(req: Request, text: str) -> str:
        clip = getattr(req, "_stop_state", {}).get("clip")
        return text if clip is None else text[:clip]

    @staticmethod
    def _await_done(req: Request) -> None:
        # bounded waits so a cancelled-while-queued request frees this
        # handler thread promptly
        while not req.done.wait(timeout=0.5):
            if req.cancelled:
                return

    def load_snapshot(self) -> Optional[dict]:
        """O(1) load view for ``/load`` and the load response headers;
        None when telemetry is disabled."""
        tel = getattr(self.engine, "telemetry", None)
        if tel is None:
            return None
        snap = tel.load_snapshot()
        cap = int(self.engine.batch_size)
        snap["capacity_slots"] = cap
        busy = snap["active_slots"] + snap["queue_depth"]
        snap["load"] = round(busy / cap, 4) if cap else float(busy)
        snap["draining"] = int(bool(self.engine.draining))
        # warming is DISTINCT from draining: a still-warming (or
        # not-yet-activated standby) replica has never served and must
        # not count toward routable capacity — but it is healthy and
        # about to be, so orchestrators must not tear it down either
        snap["warming"] = int(bool(self.warming or self.standby))
        cache = self.engine.compile_cache
        if cache is not None:
            snap.update(cache.snapshot())
        return snap

    @staticmethod
    def _draining_response() -> Response:
        return json_response({"detail": "replica draining, retry elsewhere"},
                             status=503, headers={"Retry-After": "1"})

    @staticmethod
    def _warming_response() -> Response:
        return json_response({"detail": "replica warming, not yet serving"},
                             status=503, headers={"Retry-After": "2"})

    @staticmethod
    def _deadline_response() -> Response:
        return json_response({"detail": "deadline exceeded"}, status=504)

    def _wedged_response(self) -> Optional[Response]:
        failed = self.failed or getattr(self.engine, "failed", None)
        if failed is not None:
            return json_response({"detail": failed}, status=503)
        if self.engine.wedged:
            return json_response(
                {"detail": "engine wedged: decode step stuck past the "
                           "watchdog window"},
                status=503, headers={"Retry-After": "5"})
        return None

    # -- handlers ----------------------------------------------------------

    def _speculation(self) -> dict:
        """Speculation's acceptance so far (read once: the engine thread
        updates the counters)."""
        steps = self.engine.spec_stats["steps"]
        accepted = self.engine.spec_stats["accepted"]
        return {"steps": steps, "accepted": accepted,
                "accept_rate": accepted / steps if steps else 0.0}

    def health(self, handler) -> Response:
        wedged = self._wedged_response()
        if wedged is not None:
            return wedged
        status = ("warming" if self.warming or self.standby
                  else "draining" if self.engine.draining else "ok")
        out = {"status": status, "model": self.model_name}
        if self.engine.speculation:
            out["speculation"] = self._speculation()
        return json_response(out)

    def drain(self, handler) -> Response:
        """Enter drain mode (idempotent): stop admitting, finish what is in
        flight; the answer says whether the engine is already drained, so
        an orchestrator can poll this endpoint.  A body ``{"drain":
        false}`` leaves drain mode."""
        try:
            body = handler.json_body()
        except BadRequest:
            body = None
        if isinstance(body, dict) and body.get("drain") is False:
            self.engine.end_drain()
        else:
            self.engine.begin_drain()
        return json_response({
            "status": "draining" if self.engine.draining else "accepting",
            "drained": bool(self.engine.drained)})

    def traces(self, handler) -> Response:
        """Recent and tail-retained traces, newest first; 404 when tracing
        is off."""
        if self.tracer is None:
            return json_response({"detail": "tracing disabled"}, status=404)
        return json_response(self.tracer.summary())

    def trace_detail(self, handler) -> Response:
        if self.tracer is None:
            return json_response({"detail": "tracing disabled"}, status=404)
        trace_id = handler.route_path[len("/traces/"):]
        spans = self.tracer.trace(trace_id)
        if not spans:
            return json_response({"detail": f"unknown trace {trace_id}"},
                                 status=404)
        return json_response({"trace_id": trace_id, "spans": spans})

    def load(self, handler) -> Response:
        wedged = self._wedged_response()
        if wedged is not None:
            return wedged
        snap = self.load_snapshot()
        if snap is None:
            return json_response({"detail": "telemetry disabled"}, status=404)
        return json_response(snap)

    def metrics(self, handler) -> Response:
        """Prometheus text exposition of the engine's telemetry; scrapers
        that negotiate OpenMetrics also get exemplars (trace ids)."""
        openmetrics = "application/openmetrics-text" in (
            handler.headers.get("Accept") or "")
        tel = self.engine.telemetry
        lines = [] if tel is None else render(tel.prometheus_samples(),
                                              openmetrics=openmetrics)
        if openmetrics:
            lines.append("# EOF")
        return Response(200, ("\n".join(lines) + "\n").encode(),
                        ("application/openmetrics-text; charset=utf-8"
                         if openmetrics else "text/plain; charset=utf-8"))

    def stats(self, handler) -> Response:
        """JSON latency/throughput summary plus the decode steps dispatched
        and the paged-decode kernel's launch count (a paged engine
        launches it once per layer per decode step)."""
        out = {"model": self.model_name}
        tel = self.engine.telemetry
        if tel is not None:
            out.update(tel.stats())
        out["decode_steps"] = self.engine.decode_steps
        out["num_layers"] = self.engine.cfg.num_layers
        out["kernels"] = {
            "paged_decode_attention": {
                "launches": paged_decode_attention.launches}}
        cache = self.engine.compile_cache
        if cache is not None:
            out["compile_cache"] = cache.snapshot()
            out["compile_cache_resolved"] = dict(cache.resolved)
        out["warming"] = bool(self.warming)
        out["standby"] = bool(self.standby)
        if self.weight_pull is not None:
            out["weight_pull"] = self.weight_pull
        if self.engine.speculation:
            out["speculation"] = self._speculation()
        return json_response(out)

    # -- elastic: compile cache + weight seeding, standby ------------------

    def elastic_compile(self, handler) -> Response:
        """One kernel library from the local compile cache — the
        peer-fetch path a scaling-up replica hits on a local miss
        (elastic/compile_cache.py)."""
        cache = self.engine.compile_cache
        if cache is None:
            return json_response({"detail": "compile cache disabled"},
                                 status=404)
        key = handler.route_path[len("/elastic/compile/"):]
        if not (key and all(c in "0123456789abcdef" for c in key)):
            return json_response({"detail": "bad cache key"}, status=400)
        data = cache.get_bytes(key)
        if data is None:
            return json_response(
                {"detail": f"no cached library {key[:12]}…"}, status=404)
        return Response(200, data, "application/octet-stream")

    def _seed_step_dir(self) -> Optional[Path]:
        """Latest published snapshot step dir to seed from, or None."""
        if not self.snapshot_dir:
            return None
        step = latest_snapshot_step(self.snapshot_dir)
        if step is None:
            return None
        return Path(self.snapshot_dir) / f"step_{step:08d}"

    def elastic_weights_manifest(self, handler) -> Response:
        step_dir = self._seed_step_dir()
        if step_dir is None:
            return json_response({"detail": "no published snapshot to seed"},
                                 status=404)
        return Response(200, (step_dir / MANIFEST_NAME).read_bytes(),
                        "application/json")

    def elastic_weights_shard(self, handler) -> Optional[Response]:
        """Stream one host shard file, chunked and paced below serving
        traffic (``seed_rate_bps``; 0 = unlimited).  Only names the
        manifest format can produce are served — no path traversal."""
        step_dir = self._seed_step_dir()
        if step_dir is None:
            return json_response({"detail": "no published snapshot to seed"},
                                 status=404)
        name = handler.route_path[len("/elastic/weights/"):]
        if not _SHARD_NAME.fullmatch(name):
            return json_response({"detail": "not a shard file name"},
                                 status=400)
        path = step_dir / name
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            return json_response({"detail": f"no shard {name}"}, status=404)
        with f:
            handler.start_stream(200, "application/octet-stream", {
                "Content-Length": str(os.fstat(f.fileno()).st_size)})
            while block := f.read(SEED_CHUNK_BYTES):
                handler.send_raw(block)
                if self.seed_rate_bps > 0:
                    # seeding must lose to serving: pace the transfer
                    time.sleep(len(block) / self.seed_rate_bps)
        return None

    def elastic_standby_status(self, handler) -> Response:
        return json_response({"standby": bool(self.standby),
                              "warming": bool(self.warming),
                              "activated_at": self._activated_at})

    def elastic_standby_activate(self, handler) -> Response:
        """Gateway scale-up path: flip this pre-warmed standby live.
        409 while still warming — the caller should pick another standby
        or fall back to a cold provision rather than wait here."""
        if self.warming:
            return json_response(
                {"detail": "standby still warming", "warming": True},
                status=409, headers={"Retry-After": "2"})
        return json_response(self.activate_standby())

    def models(self, handler) -> Response:
        return json_response({
            "object": "list",
            "data": [{"id": self.model_name, "object": "model",
                      "created": int(time.time()),
                      "owned_by": "dstack-tpu"}],
        })

    def completions(self, handler):
        payload = handler.json_body()
        prompt = payload.get("prompt", "")
        if isinstance(prompt, list):
            prompt = "".join(prompt)
        return self._generate(handler, payload, self.tokenizer.encode(prompt),
                              chat=False)

    def chat_completions(self, handler):
        payload = handler.json_body()
        prompt = self.tokenizer.apply_chat_template(
            payload.get("messages") or [])
        return self._generate(handler, payload, self.tokenizer.encode(prompt),
                              chat=True)

    # -- prefill/decode disaggregation ---------------------------------------

    def _prefill_phase(self, ids: List[int], payload) -> Response:
        """The prefill leg: the prompt's K/V and last-position logits,
        computed here with no slot taken, for the router to hand to a
        decode replica as ``prefill_result``."""
        result = self.engine.prefill_export(
            ids, max_new_tokens=int(payload.get("max_tokens", 128)))
        return json_response({
            "object": "prefill_result",
            "model": payload.get("model", self.model_name),
            "first_token": result["first_token"],
            "length": result["length"],
            "prompt_ids": list(ids),
            "kv_k": _arr_to_wire(result["ks"]),
            "kv_v": _arr_to_wire(result["vs"]),
            "logits": _arr_to_wire(result["logits"]),
        })

    def _request_from_prefill(self, payload) -> Request:
        p = payload["prefill_result"]
        req = self._make_request(list(p["prompt_ids"]), payload)
        req.prefill = {
            "ks": _arr_from_wire(p["kv_k"]),
            "vs": _arr_from_wire(p["kv_v"]),
            "logits": (_arr_from_wire(p["logits"])
                       if p.get("logits") else None),
            "first_token": int(p["first_token"]),
            "length": int(p["length"]),
        }
        return req

    def _phase_request(self, ids: List[int], payload, handler):
        """The leg a request is, from the router's phase header: ("prefill",
        None), or (None, the engine request: a decode leg installs its
        ``prefill_result``, any other request prefills here)."""
        phase = handler.headers.get(PD_PHASE_HEADER, "")
        if phase == "prefill":
            return "prefill", None
        if phase == "decode" and payload.get("prefill_result"):
            req = self._request_from_prefill(payload)
        else:
            req = self._make_request(ids, payload)
        if handler.trace is not None:
            req.trace_id, req.parent_span_id = handler.trace
        return None, req

    def _generate(self, handler, payload, ids: List[int], chat: bool):
        if self.engine.draining:
            return self._draining_response()
        if self.warming or self.standby:
            # the engine loop is not running yet: accepting would hang
            return self._warming_response()
        marker, req = self._phase_request(ids, payload, handler)
        remaining = deadlines.parse_remaining(handler.headers)
        if remaining is not None:
            if remaining <= 0.0:
                return self._deadline_response()
            if req is not None:
                req.deadline = time.time() + remaining
        if marker == "prefill":
            return self._prefill_phase(ids, payload)
        if payload.get("stream"):
            return self._stream(handler, req, chat, payload)
        self._install_stop(req, payload)
        try:
            self.engine.submit(req)
        except EngineDraining:
            return self._draining_response()
        self._await_done(req)
        if req.finish_reason == "deadline":
            return self._deadline_response()
        text = self._clip_text(req, self.tokenizer.decode(req.output))
        model = payload.get("model", self.model_name)
        usage = {"prompt_tokens": len(ids),
                 "completion_tokens": len(req.output),
                 "total_tokens": len(ids) + len(req.output)}
        if chat:
            choice = {"index": 0,
                      "message": {"role": "assistant", "content": text},
                      "finish_reason": req.finish_reason}
        else:
            choice = {"index": 0, "text": text,
                      "finish_reason": req.finish_reason}
        if payload.get("return_token_ids"):
            # the generated ids (vLLM's extension of the OpenAI API): a
            # replica's greedy tokens compared with another's, token for
            # token, whatever the tokenizer prints for them
            choice["token_ids"] = list(req.output)
        return json_response({
            "id": f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:12]}",
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()),
            "model": model,
            "choices": [choice],
            "usage": usage,
        })

    @staticmethod
    def _sse_chunk(rid: str, chat: bool, model: str, *, delta: str = None,
                   finish: str = None) -> dict:
        """One OpenAI streaming chunk (content delta or the final marker)."""
        if finish is None:
            choice = {"index": 0,
                      **({"delta": {"content": delta}} if chat
                         else {"text": delta}),
                      "finish_reason": None}
        else:
            choice = {"index": 0, "delta": {} if chat else None,
                      "text": None if chat else "", "finish_reason": finish}
        return {
            "id": rid,
            "object": "chat.completion.chunk" if chat else "text_completion",
            "created": int(time.time()),
            "model": model,
            "choices": [choice],
        }

    def _stream(self, handler, req: Request, chat: bool, payload: dict):
        """SSE token streaming (OpenAI chunk format).  Returns None: the
        response is written here."""
        token_q: "queue.Queue[int]" = queue.Queue()
        req.on_token = token_q.put
        stop_state = self._install_stop(req, payload)
        # submit BEFORE sending the status line, so a drain that races the
        # check above still surfaces as a 503
        try:
            self.engine.submit(req)
        except EngineDraining:
            return self._draining_response()
        headers = {"Cache-Control": "no-cache"}
        snap = self.load_snapshot()
        if snap is not None:
            headers.update(load_headers(snap))
        if handler.trace is not None:
            headers[tracing.TRACE_ID_HEADER] = handler.trace[0]
        model = payload.get("model", self.model_name)
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        try:
            handler.start_stream(200, "text/event-stream", headers)
            self._stream_loop(handler, req, chat, model, token_q, stop_state,
                              rid)
        except (BrokenPipeError, ConnectionResetError):
            req.cancel()  # client went away mid-stream: free the slot
        return None

    def _stream_loop(self, handler, req, chat, model, token_q, stop_state,
                     rid) -> None:
        sent = 0
        emitted_chars = 0
        pending: list = []
        while True:
            if req.done.is_set() and token_q.empty() and not pending:
                break
            try:
                pending.append(token_q.get(timeout=0.1))
            except queue.Empty:
                continue
            # emit only complete new text, up to any stop clip point;
            # tokens with no printable text are consumed all the same
            text = self.tokenizer.decode(req.output[: sent + len(pending)])
            clip = stop_state["clip"]
            if clip is not None:
                text = text[:clip]
            elif stop_state["stops"]:
                # hold back a tail that could be the START of a stop string
                hold = 0
                for s in stop_state["stops"]:
                    for k in range(min(len(s), len(text)), 0, -1):
                        if text.endswith(s[:k]):
                            hold = max(hold, k)
                            break
                if hold:
                    text = text[: len(text) - hold]
            delta = text[emitted_chars:]
            emitted_chars = max(emitted_chars, len(text))
            sent += len(pending)
            pending = []
            if delta:
                handler.send_event(self._sse_chunk(rid, chat, model,
                                                   delta=delta))
        # flush any text held back for a stop match that never completed
        text = self.tokenizer.decode(req.output)
        if stop_state["clip"] is not None:
            text = text[: stop_state["clip"]]
        tail = text[emitted_chars:]
        if tail:
            handler.send_event(self._sse_chunk(rid, chat, model, delta=tail))
        handler.send_event(self._sse_chunk(
            rid, chat, model, finish=req.finish_reason or "stop"))
        handler.send_raw(b"data: [DONE]\n\n")

    # -- HTTP binding ------------------------------------------------------

    def routes(self) -> dict:
        return {
            ("GET", "/health"): self.health,
            ("GET", "/metrics"): self.metrics,
            ("GET", "/stats"): self.stats,
            ("GET", "/load"): self.load,
            ("POST", "/drain"): self.drain,
            # the exact paths win over the prefix "/elastic/weights/"
            ("GET", "/elastic/compile/"): self.elastic_compile,
            ("GET", "/elastic/weights/manifest"):
                self.elastic_weights_manifest,
            ("GET", "/elastic/weights/"): self.elastic_weights_shard,
            ("GET", "/elastic/standby"): self.elastic_standby_status,
            ("POST", "/elastic/standby/activate"):
                self.elastic_standby_activate,
            ("GET", "/traces"): self.traces,
            # a key ending in "/" matches every path under it
            ("GET", "/traces/"): self.trace_detail,
            ("GET", "/v1/models"): self.models,
            ("POST", "/v1/completions"): self.completions,
            # OpenAI-compatible surface for external clients
            ("POST", "/v1/chat/completions"): self.chat_completions,
        }

    def make_server(self, host: str, port: int) -> ThreadingHTTPServer:
        """An HTTP server bound to (host, port) — port 0 picks a free one
        (``server.server_address``).  The caller runs ``serve_forever``."""
        handler = type("Handler", (_Handler,), {"app": self,
                                                "table": self.routes()})
        server = ThreadingHTTPServer((host, port), handler)
        server.daemon_threads = True
        return server


class BadRequest(ValueError):
    pass


class _Handler(BaseHTTPRequestHandler):
    """Routes one request to a ``ServingApp`` handler: load headers on
    every finished response, a ``replica.request`` span around /v1/."""

    app: ServingApp
    table: dict
    trace = None
    #: the request's path without its query
    route_path = ""

    def log_message(self, fmt, *args) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)

    def do_GET(self) -> None:
        self._dispatch("GET")

    def do_POST(self) -> None:
        self._dispatch("POST")

    def json_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        try:
            body = json.loads(self.rfile.read(n) or b"{}")
        except ValueError as e:
            raise BadRequest(f"invalid JSON body: {e}") from None
        if not isinstance(body, dict):
            raise BadRequest("the JSON body must be an object")
        return body

    def _dispatch(self, method: str) -> None:
        path = self.route_path = self.path.split("?", 1)[0]
        fn = self.table.get((method, path))
        if fn is None and "/" in path[1:]:
            fn = self.table.get((method, path[:path.rindex("/") + 1]))
        if fn is None:
            self._send(json_response({"detail": "not found"}, status=404))
            return
        tracer = self.app.tracer
        if tracer is None or not path.startswith("/v1/"):
            self._run(fn)
            return
        ctx = tracing.parse_traceparent(
            self.headers.get(tracing.TRACEPARENT_HEADER))
        trace_id, parent = ctx if ctx is not None else (
            tracing.new_trace_id(), None)
        span = tracer.start_span("replica.request", trace_id=trace_id,
                                 parent_id=parent, attrs={"path": path})
        self.trace = (trace_id, span.span_id)
        status = 500
        try:
            status = self._run(fn)
        finally:
            if status >= 500:
                span.status = "error"
            span.set_attr("status", status)
            span.end()
            tracer.finish_trace(trace_id, span.duration,
                                error=span.status == "error")

    def _run(self, fn) -> int:
        try:
            resp = fn(self)
        except BadRequest as e:
            resp = json_response({"detail": str(e)}, status=400)
        if resp is None:  # streamed by the handler itself
            return 200
        self._send(resp)
        return resp.status

    def _send(self, resp: Response) -> None:
        headers = dict(resp.headers)
        snap = self.app.load_snapshot()
        if snap is not None:
            headers.update(load_headers(snap))
        if self.trace is not None:
            headers[tracing.TRACE_ID_HEADER] = self.trace[0]
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(resp.body)

    # streaming (SSE): no Content-Length; the connection closes at the end
    def start_stream(self, status: int, content_type: str,
                     headers: dict) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.flush()

    def send_event(self, obj: dict) -> None:
        self.send_raw(f"data: {json.dumps(obj)}\n\n".encode())

    def send_raw(self, data: bytes) -> None:
        self.wfile.write(data)
        self.wfile.flush()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="tiny", choices=sorted(CONFIGS))
    parser.add_argument("--device", default="cuda",
                        help="torch device; the CPU runs only when named "
                             "(--device cpu)")
    parser.add_argument("--checkpoint", default=None,
                        help="HF Llama checkpoint dir: config, weights and "
                             "(unless --tokenizer) the tokenizer")
    parser.add_argument("--quantize", default=None, choices=["int8"],
                        help="weight-only quantization (serving/quant.py)")
    parser.add_argument("--tokenizer", default=None,
                        help="HF tokenizer name/path (byte fallback if unset)")
    parser.add_argument("--model-name", default=None)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--max-len", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights")
    parser.add_argument("--tensor-parallel", type=int, default=1, metavar="N",
                        help="shard the model over the first N cards of "
                             "this host, one process a card (Megatron-style "
                             "TP; for models too big for one card)")
    parser.add_argument("--follower", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument(
        "--paged", action="store_true",
        help="block-paged KV cache (serving/paging.py), decoded through the "
             "paged-decode kernel")
    parser.add_argument("--kv-block-size", type=int, default=32)
    parser.add_argument(
        "--total-kv-blocks", type=int, default=None,
        help="paged-mode pool size; default = batch_size * max_len / block")
    parser.add_argument(
        "--prefix-cache", action="store_true",
        help="reuse the KV of shared prompt prefixes across requests; "
             "implies --paged")
    parser.add_argument(
        "--kv-quantize", choices=["int8", "int4"], default=None,
        help="store the KV cache quantized with per-row scales: int8, or "
             "int4 packed two values per byte (~6%% RMS row error)")
    parser.add_argument(
        "--prefill-chunk", type=int, default=None, metavar="N",
        help="prefill long prompts in N-token chunks interleaved with "
             f"decode windows; default {InferenceEngine.TUNED_PREFILL_CHUNK}; "
             "0 disables chunking")
    parser.add_argument(
        "--speculation", choices=["ngram"], default=None,
        help="n-gram speculative decoding for greedy requests (dense cache)")
    parser.add_argument(
        "--speculation-k", type=int, default=None, metavar="K",
        help="draft tokens verified per speculative step; default "
             f"{InferenceEngine.TUNED_SPECULATION_K}")
    parser.add_argument(
        "--no-telemetry", action="store_true",
        help="disable the in-process serving telemetry (/metrics + /stats "
             "then serve empty; also DSTACK_TPU_SERVING_TELEMETRY=0)")
    parser.add_argument(
        "--compile-cache", default=None, metavar="DIR",
        help="compile cache root (elastic/compile_cache.py): the kernels' "
             "nvcc libraries keyed by source + card + nvcc + driver, shared "
             "with peers; also DSTACK_COMPILE_CACHE")
    parser.add_argument(
        "--compile-cache-peers", default=None, metavar="URLS",
        help="comma-separated peer base URLs to fetch cached libraries from "
             "on a local miss; also DSTACK_COMPILE_CACHE_PEERS")
    parser.add_argument(
        "--snapshot-dir", default=None, metavar="DIR",
        help="published snapshot dir (models/checkpoint.py manifest format) "
             "this replica seeds to joining peers over /elastic/weights/*")
    parser.add_argument(
        "--weight-peers", default=None, metavar="URLS",
        help="comma-separated live-replica base URLs to stream weights from "
             "into --snapshot-dir before start, then serve them (the seed's "
             "random weights are the fallback); also DSTACK_WEIGHT_PEERS")
    parser.add_argument(
        "--seed-rate-bps", type=float, default=0.0, metavar="BPS",
        help="cap seeding transfers at this many bytes/s so weight streaming "
             "stays below serving traffic (0 = unlimited; also "
             "DSTACK_SEED_RATE_BPS)")
    parser.add_argument(
        "--standby", action="store_true",
        help="start as a pre-warmed standby: warm up, then refuse /v1 (503) "
             "until POST /elastic/standby/activate")
    parser.add_argument("--from-snapshot", action="store_true",
                        help=argparse.SUPPRESS)
    return parser


def _urls(text: str) -> List[str]:
    return [p.strip() for p in text.split(",") if p.strip()]


def elastic_plan(args, env=None) -> dict:
    """What the elastic flags, or their environment variables, set up:
    the compile cache's root and peers, the weight peers, whether this
    rank pulls weights (rank 0, with --weight-peers and --snapshot-dir),
    whether it warms (a standby, or any replica with a cache: cheap on a
    hit, and it fills the cache for the fleet on a miss), whether it
    starts as a standby, and the seeding rate."""
    env = os.environ if env is None else env
    root = args.compile_cache or env.get(ENV_CACHE_DIR, "").strip()
    cache_peers = _urls(args.compile_cache_peers
                        or env.get(ENV_CACHE_PEERS, ""))
    weight_peers = _urls(args.weight_peers or env.get(ENV_WEIGHT_PEERS, ""))
    cache = bool(root or cache_peers)
    lead = not args.follower
    return {"cache_root": root or None, "cache_peers": cache_peers,
            "weight_peers": weight_peers,
            "pull": lead and bool(weight_peers and args.snapshot_dir),
            "warm": lead and (args.standby or cache),
            "standby": lead and args.standby,
            "seed_rate_bps": args.seed_rate_bps or float(
                env.get(ENV_SEED_RATE_BPS, "0") or 0)}


def compile_cache_of(plan: dict) -> Optional[CompileCache]:
    if not (plan["cache_root"] or plan["cache_peers"]):
        return None
    return CompileCache(plan["cache_root"], plan["cache_peers"])


def pull_snapshot(args, plan: dict, cold_fallback=lambda: -1) -> dict:
    """Pull the published snapshot from the weight peers into
    --snapshot-dir before the engine is built: the report of
    :func:`~dstack_tpu_torch.elastic.weight_stream.pull_weights`.  A
    failure is not fatal: the replica starts from its cold source (its
    seed's weights, or --checkpoint), step -1."""
    try:
        report = pull_weights(plan["weight_peers"], args.snapshot_dir,
                              cold_fallback=cold_fallback)
    except WeightStreamError as e:
        logger.warning("weight pull failed, cold start: %s", e)
        report = {"source": "cold", "peer": None, "step": -1,
                  "errors": [str(e)]}
    logger.info("weight pull: %s", report)
    return report


def serves_pulled(args, report: Optional[dict]) -> bool:
    """Whether this rank serves the snapshot in --snapshot-dir: rank 0
    pulled it from a peer (a follower is told so by --from-snapshot), and
    no --checkpoint names other weights."""
    pulled = args.from_snapshot or (report is not None
                                    and report["source"] == "peer")
    return pulled and not args.checkpoint


def read_pulled(args, cfg: LlamaConfig):
    """The engine's params from the pulled snapshot (sha256-verified
    again on read) on --device, or on the host under --tensor-parallel
    (each rank keeps its blocks, as with --checkpoint); None when it is
    not a param tree of ``cfg`` (a full train state, another model): the
    replica then starts from its seed's weights."""
    device = "cpu" if args.tensor_parallel > 1 else args.device
    try:
        params, step = read_snapshot(args.snapshot_dir,
                                     init_params(cfg, "meta", None),
                                     verify=True, device=device)
    except (ValueError, KeyError) as e:
        logger.warning("pulled snapshot is not an engine param tree (%s); "
                       "cold init instead", e)
        return None
    logger.info("engine params restored from peer snapshot step %d", step)
    return params


def load_model(args) -> tuple:
    """``(cfg, params, tokenizer, model_name)`` of the command line: with
    ``--checkpoint``, the HF checkpoint's config and weights (on
    ``--device``) and its tokenizer (``--tokenizer`` overrides); else the
    named config, whose weights the engine draws from ``--seed``."""
    if not args.checkpoint:
        return (CONFIGS[args.config](), None, load_tokenizer(args.tokenizer),
                args.model_name or args.config)
    tokenizer = load_tokenizer(args.tokenizer or args.checkpoint)
    if isinstance(tokenizer, ByteTokenizer):
        # real weights + byte fallback = fluent-looking garbage; fail
        # loudly instead
        raise SystemExit(f"could not load a tokenizer for {args.checkpoint} "
                         "(pass --tokenizer explicitly)")
    # under --tensor-parallel each rank keeps its blocks of the host's tree
    cfg, params = load_hf_llama(
        args.checkpoint,
        device="cpu" if args.tensor_parallel > 1 else args.device)
    return (cfg, params, tokenizer,
            args.model_name or Path(args.checkpoint).name)


def build_engine(args, cfg: LlamaConfig, params, mesh=None,
                 compile_cache: Optional[CompileCache] = None
                 ) -> InferenceEngine:
    """The engine of the command line (sharded over ``mesh`` when given;
    a follower rank's has no telemetry)."""
    return InferenceEngine(
        cfg, params=params, batch_size=args.batch_size, max_len=args.max_len,
        rng_seed=args.seed, quantize=args.quantize,
        paged=args.paged or args.prefix_cache,
        kv_block_size=args.kv_block_size,
        total_kv_blocks=args.total_kv_blocks,
        prefix_cache=args.prefix_cache,
        kv_quantize=args.kv_quantize,
        # the engine's None means DISABLED, so the default lives here;
        # --prefill-chunk 0 opts out
        prefill_chunk=(InferenceEngine.TUNED_PREFILL_CHUNK
                       if args.prefill_chunk is None
                       else (args.prefill_chunk or None)),
        speculation=args.speculation,
        speculation_k=args.speculation_k,
        telemetry=(None if args.no_telemetry or args.follower
                   else make_engine_telemetry()),
        device=args.device,
        mesh=mesh,
        compile_cache=compile_cache,
    )


def start_replica(args, cfg: LlamaConfig, params, tokenizer, model_name: str,
                  *, mesh=None, plan: Optional[dict] = None,
                  report: Optional[dict] = None,
                  cold_fallback=lambda: -1) -> ServingApp:
    """Rank 0's startup: pull the weights (unless ``report`` says it
    pulled already), serve them when they came from a peer, build the
    engine with its compile cache and start it, warming first when the
    plan says so.  Returns the app; the caller serves its HTTP."""
    plan = plan or elastic_plan(args)
    if report is None and plan["pull"]:
        report = pull_snapshot(args, plan, cold_fallback)
    if params is None and serves_pulled(args, report):
        params = read_pulled(args, cfg)
    engine = build_engine(args, cfg, params, mesh, compile_cache_of(plan))
    app = ServingApp(engine, tokenizer, model_name=model_name,
                     snapshot_dir=args.snapshot_dir, standby=plan["standby"],
                     seed_rate_bps=plan["seed_rate_bps"], weight_pull=report)
    app.start_engine(warm=plan["warm"])
    return app


def visible_devices(device: str) -> Optional[int]:
    """Cards the ranks can take: CUDA's count, or None on the CPU (gloo
    ranks, any number)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.device_count()


def check_tensor_parallel(n: int, device: str) -> None:
    """Exit, as the JAX server does, when fewer than ``n`` cards are
    visible."""
    if n < 1:
        raise SystemExit(f"--tensor-parallel must be at least 1, got {n}")
    visible = visible_devices(device) if n > 1 else None
    if visible is not None and visible < n:
        raise SystemExit(f"--tensor-parallel {n} but only {visible} "
                         f"device(s) visible")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(n: int, port: int, rank: int) -> dict:
    """The control plane's variables for rank ``rank`` of an ``n``-card
    world on this host (``parallel/distributed.py``)."""
    return {"DSTACK_MASTER_NODE_IP": "127.0.0.1", "DSTACK_NODES_NUM": "1",
            "DSTACK_NODE_RANK": "0", "DSTACK_GPUS_PER_NODE": str(n),
            "DSTACK_COORDINATOR_PORT": str(port), "LOCAL_RANK": str(rank)}


def start_followers(argv: List[str], n: int, port: int) -> list:
    """Ranks 1..n-1: this command again as followers, one a card."""
    env = {k: v for k, v in os.environ.items() if k != "DSTACK_GPUS_NUM"}
    return [subprocess.Popen(
        [sys.executable, "-m", "dstack_tpu_torch.serving.server", *argv,
         "--follower"], env={**env, **rank_env(n, port, r)})
        for r in range(1, n)]


def watch_followers(app: "ServingApp", procs: list, exit_fn=os._exit,
                    poll_s: float = 0.5) -> threading.Thread:
    """A thread that fails the replica when a follower exits or rank 0's
    engine stops on a failed step (``engine.failed``): ``app`` answers
    /health and /load with 503, and ``exit_fn(1)`` ends rank 0 (whose
    collectives would wait on the lost rank forever, and whose followers
    may wait in a collective of the failed operation)."""
    def watch():
        while True:
            for r, p in enumerate(procs, start=1):
                code = p.poll()
                if code is not None and app.engine._stop:
                    return  # rank 0 is shutting down: its followers end
                if code is not None:
                    app.failed = (f"tensor-parallel rank {r} exited with "
                                  f"code {code}")
                    logger.error("%s: this replica stops", app.failed)
            if app.failed is not None or app.engine.failed is not None:
                time.sleep(poll_s)
                for p in procs:  # they may wait in a collective forever
                    if p.poll() is None:
                        p.kill()
                exit_fn(1)
                return
            time.sleep(poll_s)

    thread = threading.Thread(target=watch, daemon=True, name="followers")
    thread.start()
    return thread


def _join_world(args) -> object:
    """This rank's place in the --tensor-parallel world: the process group
    (NCCL on cards, gloo on the CPU) and the mesh MeshSpec(tensor=N)."""
    from dstack_tpu_torch.parallel import distributed
    from dstack_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    distributed.initialize(force=True, device=args.device)
    return build_mesh(MeshSpec(tensor=args.tensor_parallel),
                      torch.device(args.device).type)


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    n = args.tensor_parallel
    check_tensor_parallel(n, args.device)
    plan = elastic_plan(args)
    # rank 0 pulls before its followers start: every rank then reads the
    # same snapshot
    report = pull_snapshot(args, plan) if plan["pull"] else None
    followers, mesh = [], None
    if n > 1 and not args.follower:
        port = _free_port()
        os.environ.update(rank_env(n, port, 0))
        os.environ.pop("DSTACK_GPUS_NUM", None)
        followers = start_followers(
            argv + (["--from-snapshot"] if serves_pulled(args, report)
                    else []), n, port)
    try:
        cfg, params, tokenizer, model_name = load_model(args)
        if tokenizer.vocab_size > cfg.vocab_size:
            raise SystemExit(f"tokenizer vocab {tokenizer.vocab_size} "
                             f"exceeds model vocab {cfg.vocab_size}")
        if args.follower and serves_pulled(args, None):
            params = read_pulled(args, cfg)
        if n > 1:
            mesh = _join_world(args)
        if args.follower:
            engine = build_engine(args, cfg, params, mesh,
                                  compile_cache_of(plan))
            logger.info("tensor-parallel follower: %s", engine.follow())
            torch.distributed.destroy_process_group()
            return
        app = start_replica(args, cfg, params, tokenizer, model_name,
                            mesh=mesh, plan=plan, report=report)
        engine = app.engine
        if followers:
            watch_followers(app, followers)
        server = app.make_server("0.0.0.0", args.port)
        logger.info("serving %s on port %d (%s, tensor-parallel %d)",
                    model_name, server.server_address[1], engine.device, n)
        try:
            server.serve_forever()
        finally:
            server.server_close()
            engine.stop()
            app.join_engine(timeout=30)
    finally:
        for p in followers:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


if __name__ == "__main__":
    main()
