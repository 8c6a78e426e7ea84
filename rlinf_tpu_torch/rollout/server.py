"""Server-mode rollout: continuous serving loop + OpenAI-style HTTP API.

Port of ``rlinf_tpu/rollout/server.py``. One serving thread wraps the
continuous-batching engine's pool core (``init_pool``, ``refill``,
``decode_and_harvest``, rollout/continuous_engine.py) around a submit
queue: requests stream in at any time, finished slots free at once, and
each request's future resolves on its own. Weight sync while serving swaps
the params between decode chunks.

Where the port differs from the JAX loop, by design:

  * randomness is one host ``torch.Generator`` seeded once, handed to every
    refill and decode chunk (the JAX loop splits a PRNG key for each);
  * each round takes the queued requests first and reads the params after,
    so a request submitted after ``update_params`` returns is always
    prefilled and decoded with the new params;
  * an exception in the serving thread is set on every in-flight and queued
    future and on every later ``submit``, and the loop ends (the JAX loop's
    thread dies silently and its callers wait out their timeouts);
  * the loop runs under ``torch.inference_mode()``: grad mode is
    thread-local, and the pool-core calls are not decorated.

The HTTP layer is the standard library's ThreadingHTTPServer (control
plane only: tokens/s is decided by the decode loop, not the HTTP stack).
``RouterServer`` round-robins /v1/* calls across backend servers.
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.request
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence

import torch

from rlinf_tpu_torch.rollout.continuous_engine import ContinuousBatchingEngine


class _Request:
    __slots__ = ("prompt_ids", "max_new_tokens", "future")

    def __init__(self, prompt_ids: List[int], max_new_tokens: Optional[int]):
        self.prompt_ids = prompt_ids
        self.max_new_tokens = max_new_tokens
        self.future: Future = Future()


class GenerationServer:
    """Continuous serving loop over a ContinuousBatchingEngine.

    ``submit`` returns a Future resolving to {"tokens": [...], "logprobs":
    [...]}; ``update_params`` swaps weights between decode chunks (serving
    never stops: the async-RL weight sync semantics). The server holds the
    params it is given: a caller that updates its own tensors in place hands
    the server a copy.
    """

    def __init__(self, engine: ContinuousBatchingEngine, params, *,
                 seed: int = 0, idle_wait_s: float = 0.01):
        self.engine = engine
        self._params = params
        self._params_lock = threading.Lock()
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._generator = torch.Generator().manual_seed(seed)
        self._idle_wait_s = idle_wait_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: set when the loop has ended (the error, or "server stopped");
        #: later submits fail with it
        self._closed: Optional[Exception] = None
        self._closed_lock = threading.Lock()
        self.num_served = 0

    # -- public API --------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)

    def submit(self, prompt_ids: Sequence[int],
               max_new_tokens: Optional[int] = None) -> Future:
        req = _Request(list(prompt_ids), max_new_tokens)
        with self._closed_lock:
            if self._closed is not None:
                req.future.set_exception(self._closed)
            else:
                self._queue.put(req)
        return req.future

    def generate(self, prompt_ids: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = 300.0) -> Dict[str, List]:
        return self.submit(prompt_ids, max_new_tokens).result(timeout)

    def update_params(self, new_params):
        with self._params_lock:
            self._params = new_params

    # -- serving loop -------------------------------------------------------
    def _serve_loop(self):
        inflight: Dict[int, _Request] = {}       # key -> request
        err: Exception = RuntimeError("server stopped")
        try:
            with torch.inference_mode():
                self._serve(inflight)
        except Exception as e:   # handed to every pending and later request
            err = e
        finally:
            with self._closed_lock:
                self._closed = err
                pending = list(inflight.values())
                while True:
                    try:
                        pending.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
            for req in pending:
                if not req.future.done():
                    req.future.set_exception(err)

    def _serve(self, inflight: Dict[int, _Request]):
        eng = self.engine
        sp = eng.sampling
        pool = eng.init_pool()
        next_key = 0
        cached_params = None
        prepared = None

        def req_budget(req: _Request) -> int:
            if req.max_new_tokens is None:
                return sp.max_new_tokens
            return min(req.max_new_tokens, sp.max_new_tokens)

        while not self._stop.is_set():
            # 1. take queued requests for the free slots, THEN read the
            # params: a request submitted after update_params returned is
            # served by the new params
            n_free = sum(1 for s in pool.slots if s.request_idx < 0)
            entries = []
            while len(entries) < n_free:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                inflight[next_key] = req
                entries.append((next_key, req.prompt_ids, req_budget(req)))
                next_key += 1
            with self._params_lock:
                params = self._params
            if params is not cached_params:
                # weight swap between decode chunks: re-quantize the decode
                # params once per new set of params
                prepared = eng.prepare_params(params)
                cached_params = params
            pparams, dparams = prepared

            # 2. refill free slots (batched prefill)
            if entries:
                eng.refill(pool, pparams, entries, self._generator)

            if pool.num_active == 0:
                if not entries:
                    self._stop.wait(self._idle_wait_s)
                continue

            # 3. chunked decode + harvest; resolve futures
            for fin in eng.decode_and_harvest(pool, dparams, self._generator):
                req = inflight.pop(fin.request_idx)
                req.future.set_result(
                    {"tokens": fin.tokens, "logprobs": fin.logprobs}
                )
                self.num_served += 1


# ---------------------------------------------------------------------------
# OpenAI-style HTTP layer
# ---------------------------------------------------------------------------


def _render_chat(messages: List[Dict[str, Any]]) -> str:
    """Minimal chat template (role-tagged turns + assistant cue)."""
    parts = [f"<|{m.get('role', 'user')}|>{m.get('content', '')}"
             for m in messages]
    return "".join(parts) + "<|assistant|>"


def _send_json(handler: BaseHTTPRequestHandler, code: int, data: bytes):
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(data)))
    handler.end_headers()
    handler.wfile.write(data)


class _HTTPServing:
    """A ThreadingHTTPServer on its own daemon thread."""

    def __init__(self, handler, host: str, port: int):
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)


class OpenAIHTTPServer(_HTTPServing):
    """OpenAI-compatible /v1/completions + /v1/chat/completions over a
    GenerationServer."""

    def __init__(self, gen_server: GenerationServer, tokenizer, *,
                 host: str = "127.0.0.1", port: int = 0):
        self.gen_server = gen_server
        self.tokenizer = tokenizer
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):     # silence request logging
                pass

            def _json(self, code: int, body: Dict[str, Any]):
                _send_json(self, code, json.dumps(body).encode())

            def do_GET(self):
                if self.path == "/health":
                    self._json(200, {"status": "ok",
                                     "served": outer.gen_server.num_served})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._json(400, {"error": "bad json"})
                    return
                try:
                    if self.path == "/v1/completions":
                        self._json(200, outer._completions(body))
                    elif self.path == "/v1/chat/completions":
                        self._json(200, outer._chat(body))
                    else:
                        self._json(404, {"error": "not found"})
                except Exception as e:   # noqa: BLE001 -- surface to client
                    self._json(500, {"error": str(e)})

        super().__init__(Handler, host, port)

    def _generate_text(self, prompt: str, max_tokens: Optional[int]):
        ids = self.tokenizer.encode(prompt)
        out = self.gen_server.generate(ids, max_new_tokens=max_tokens)
        text = self.tokenizer.decode(out["tokens"])
        return text, len(ids), len(out["tokens"])

    def _completions(self, body: Dict[str, Any]) -> Dict[str, Any]:
        text, n_in, n_out = self._generate_text(
            body.get("prompt", ""), body.get("max_tokens"))
        return {
            "object": "text_completion",
            "choices": [{"index": 0, "text": text,
                         "finish_reason": "stop"}],
            "usage": {"prompt_tokens": n_in, "completion_tokens": n_out,
                      "total_tokens": n_in + n_out},
        }

    def _chat(self, body: Dict[str, Any]) -> Dict[str, Any]:
        prompt = _render_chat(body.get("messages", []))
        text, n_in, n_out = self._generate_text(
            prompt, body.get("max_tokens"))
        return {
            "object": "chat.completion",
            "choices": [{"index": 0,
                         "message": {"role": "assistant", "content": text},
                         "finish_reason": "stop"}],
            "usage": {"prompt_tokens": n_in, "completion_tokens": n_out,
                      "total_tokens": n_in + n_out},
        }


class RouterServer(_HTTPServing):
    """HTTP round-robin router over backend OpenAI servers."""

    def __init__(self, backend_urls: List[str], *, host: str = "127.0.0.1",
                 port: int = 0, timeout: float = 300.0):
        self.backends = list(backend_urls)
        self.timeout = timeout
        self._i = 0
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/health":
                    _send_json(self, 200, json.dumps(
                        {"status": "ok", "backends": len(outer.backends)}).encode())
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                payload = self.rfile.read(length)
                backend = outer._next_backend()
                req = urllib.request.Request(
                    backend + self.path, data=payload,
                    headers={"Content-Type": "application/json"})
                try:
                    with urllib.request.urlopen(
                            req, timeout=outer.timeout) as r:
                        data, code = r.read(), r.status
                except Exception as e:   # noqa: BLE001
                    data, code = json.dumps({"error": str(e)}).encode(), 502
                _send_json(self, code, data)

        super().__init__(Handler, host, port)

    def _next_backend(self) -> str:
        with self._lock:
            url = self.backends[self._i % len(self.backends)]
            self._i += 1
        return url
