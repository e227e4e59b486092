"""OpenAI-compatible HTTP server over the continuous-batching engine.

Standard-library HTTP (``http.server.ThreadingHTTPServer``): one thread per
connection, the engine on its own thread.  Endpoints: /health, /v1/models,
/v1/completions, /v1/chat/completions (non-streaming and SSE streaming, and
the two legs of prefill/decode disaggregation), /metrics (Prometheus text,
OpenMetrics on request), /stats, /load, /drain, /traces, /traces/{id}.

Run: python -m dstack_tpu_torch.serving.server --config llama3-8b --paged
(CUDA by default; ``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from dstack_tpu_torch.models.checkpoint import (
    _dtype_name,
    _torch_dtype,
    load_hf_llama,
)
from dstack_tpu_torch.models.llama import LlamaConfig
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


class ServingApp:
    def __init__(self, engine: InferenceEngine, tokenizer,
                 model_name: str = "dstack-tpu-model") -> None:
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        #: request tracer — rides the engine's telemetry so scheduler spans
        #: and HTTP spans share one ring; None when telemetry or tracing is
        #: off
        self.tracer = getattr(
            getattr(engine, "telemetry", None), "tracer", None)
        self._thread = threading.Thread(
            target=engine.run_forever, daemon=True, name="engine")

    def start_engine(self) -> None:
        self._thread.start()

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
        snap["warming"] = 0
        return snap

    @staticmethod
    def _draining_response() -> Response:
        return json_response({"detail": "replica draining, retry elsewhere"},
                             status=503, headers={"Retry-After": "1"})

    @staticmethod
    def _deadline_response() -> Response:
        return json_response({"detail": "deadline exceeded"}, status=504)

    def _wedged_response(self) -> Optional[Response]:
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
        status = "draining" if self.engine.draining else "ok"
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
        if self.engine.speculation:
            out["speculation"] = self._speculation()
        return json_response(out)

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
            return json_response({
                "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": model,
                "choices": [{"index": 0,
                             "message": {"role": "assistant",
                                         "content": text},
                             "finish_reason": req.finish_reason}],
                "usage": usage,
            })
        return json_response({
            "id": f"cmpl-{uuid.uuid4().hex[:12]}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": model,
            "choices": [{"index": 0, "text": text,
                         "finish_reason": req.finish_reason}],
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
                        help="tensor-parallel degree (only 1 is ported)")
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
    parser.add_argument("--compile-cache", default=None, metavar="DIR",
                        help="(not yet ported)")
    parser.add_argument("--compile-cache-peers", default=None,
                        metavar="URLS", help="(not yet ported)")
    parser.add_argument("--snapshot-dir", default=None, metavar="DIR",
                        help="(not yet ported)")
    parser.add_argument("--weight-peers", default=None, metavar="URLS",
                        help="(not yet ported)")
    parser.add_argument("--seed-rate-bps", type=float, default=0.0,
                        metavar="BPS", help="(not yet ported)")
    parser.add_argument("--standby", action="store_true",
                        help="(not yet ported)")
    return parser


def unported_flags(args) -> List[str]:
    """Flags set on the command line whose feature the port lacks."""
    checks = [
        ("--tensor-parallel", args.tensor_parallel > 1),
        ("--compile-cache", args.compile_cache is not None),
        ("--compile-cache-peers", args.compile_cache_peers is not None),
        ("--snapshot-dir", args.snapshot_dir is not None),
        ("--weight-peers", args.weight_peers is not None),
        ("--seed-rate-bps", bool(args.seed_rate_bps)),
        ("--standby", args.standby),
    ]
    return [flag for flag, on in checks if on]


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
    cfg, params = load_hf_llama(args.checkpoint, device=args.device)
    return (cfg, params, tokenizer,
            args.model_name or Path(args.checkpoint).name)


def build_engine(args, cfg: LlamaConfig, params) -> InferenceEngine:
    """The engine of the command line."""
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
        telemetry=None if args.no_telemetry else make_engine_telemetry(),
        device=args.device,
    )


def main(argv: Optional[List[str]] = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    missing = unported_flags(args)
    if missing:
        parser.exit(2, f"not yet ported: {', '.join(missing)}\n")
    logging.basicConfig(level=logging.INFO)
    cfg, params, tokenizer, model_name = load_model(args)
    if tokenizer.vocab_size > cfg.vocab_size:
        raise SystemExit(f"tokenizer vocab {tokenizer.vocab_size} exceeds "
                         f"model vocab {cfg.vocab_size}")
    engine = build_engine(args, cfg, params)
    app = ServingApp(engine, tokenizer, model_name=model_name)
    app.start_engine()
    server = app.make_server("0.0.0.0", args.port)
    logger.info("serving %s on port %d (%s)", model_name,
                server.server_address[1], engine.device)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.stop()


if __name__ == "__main__":
    main()
