"""Minimal HTTP inference server over the port's engines.

A trimmed copy of ``gptq_gguf_tpu/serving/server.py``: one background
thread steps the engine (``ContinuousBatchingEngine`` or
``PagedContinuousBatchingEngine``) while HTTP workers enqueue requests and
block on completion events. stdlib only (http.server + threading).

Endpoints (JSON):
  POST /completion   {"prompt_tokens": [..], "max_new_tokens": N,
                      "temperature": t, "top_k": k, "top_p": p, "min_p": m,
                      "presence_penalty": a, "frequency_penalty": b,
                      "repetition_penalty": r, "seed": s, "logprobs": n}
                     -> {"tokens": [...], "finish_reason": .., "latency_s": ..,
                         "logprobs": {"token_logprobs": [..], "top": [..]}}
                     (or {"prompt": "text"} when a tokenizer is loaded)
  POST /v1/completions, /v1/chat/completions
                     OpenAI-compatible subsets (need a tokenizer; chat
                     needs one with a chat template); chat takes "n"
                     choices (seed + i for choice i when seeded) and
                     "logprobs" / "top_logprobs"
  POST /tokenize {"content": ..}, /detokenize {"tokens": [..]}
  GET  /health, /v1/models

/completion and /v1/chat/completions take "stream": true and then reply as
server-sent events ending with "data: [DONE]". A stop-string hit cancels
the in-flight request, freeing its slot at once.

Embeddings, reranking and image messages answer 400, as the JAX package's
server does with no such model loaded.

If a step of the engine raises (a CUDA error, say), every waiting request
ends with 500 and the engine is not stepped again.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from .sampling import SamplingParams

_SAMPLING_KEYS = ("temperature", "top_k", "top_p", "min_p", "presence_penalty",
                  "frequency_penalty", "repetition_penalty", "seed")


def _sampling_from_json(req: Dict[str, Any]) -> Optional[SamplingParams]:
    """The request's sampling settings, or None (the engine's default)."""
    if not any(k in req for k in _SAMPLING_KEYS):
        return None
    return SamplingParams(
        temperature=float(req.get("temperature", 0.0)),
        top_k=int(req.get("top_k", 0)),
        top_p=float(req.get("top_p", 1.0)),
        min_p=float(req.get("min_p", 0.0)),
        presence_penalty=float(req.get("presence_penalty", 0.0)),
        frequency_penalty=float(req.get("frequency_penalty", 0.0)),
        repetition_penalty=float(req.get("repetition_penalty", 1.0)),
        seed=int(req["seed"]) if req.get("seed") is not None else None,
    )


class EngineRunner:
    """Background thread stepping the engine; completion events per uid.

    Streaming: submit(stream=True) attaches a per-uid queue that receives
    (new_tokens, done) after every engine step; done is None, the finished
    request, or the exception that stopped the engine.
    """

    def __init__(self, engine, poll_idle_s: float = 0.005):
        self.engine = engine
        self.lock = threading.Lock()
        self.events: Dict[int, threading.Event] = {}
        self.results: Dict[int, Any] = {}
        self.streams: Dict[int, "queue.Queue"] = {}
        self._sent: Dict[int, int] = {}
        self.error: Optional[BaseException] = None
        self.poll_idle_s = poll_idle_s
        self._stop = False
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def stop(self):
        self._stop = True
        self.thread.join(timeout=5)

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               sampling_params: Optional[SamplingParams] = None, stream: bool = False,
               logprobs: int = 0) -> int:
        ev = threading.Event()
        with self.lock:
            if self.error is not None:
                raise RuntimeError(f"the engine stopped: {type(self.error).__name__}: "
                                   f"{self.error}")
            uid = self.engine.submit(prompt, max_new_tokens, sampling_params=sampling_params,
                                     logprobs=logprobs)
            self.events[uid] = ev
            if stream:
                self.streams[uid] = queue.Queue()
                self._sent[uid] = 0
        return uid

    def wait(self, uid: int, timeout: Optional[float] = None):
        """The finished request; raises RuntimeError if the engine failed."""
        ev = self.events[uid]
        if not ev.wait(timeout):
            raise TimeoutError(f"request {uid} timed out")
        with self.lock:
            self.events.pop(uid, None)
            result = self.results.pop(uid)
        if isinstance(result, BaseException):
            raise RuntimeError(f"the engine failed: {type(result).__name__}: {result}")
        return result

    def stream_queue(self, uid: int) -> "queue.Queue":
        return self.streams[uid]

    def cancel(self, uid: int) -> bool:
        with self.lock:
            ok = self.engine.cancel(uid)
            self.events.pop(uid, None)
            self.results.pop(uid, None)
            self.streams.pop(uid, None)
            self._sent.pop(uid, None)
        return ok

    def _push_stream(self, req, done: bool) -> None:
        q = self.streams.get(req.uid)
        if q is None:
            return
        sent = self._sent.get(req.uid, 0)
        fresh = req.output[sent:]
        self._sent[req.uid] = len(req.output)
        if fresh or done:
            q.put((fresh, req if done else None))
        if done:
            self.streams.pop(req.uid, None)
            self._sent.pop(req.uid, None)

    def _fail(self, err: BaseException) -> None:
        """End every waiting request with ``err`` (under the lock)."""
        self.error = err
        for uid, ev in self.events.items():
            if not ev.is_set():
                self.results[uid] = err
                ev.set()
        for q in self.streams.values():
            q.put(([], err))
        self.streams.clear()
        self._sent.clear()

    def _loop(self):
        while not self._stop:
            with self.lock:
                try:
                    active = self.engine.step()
                except Exception as e:  # noqa: BLE001 - handed to every waiting request
                    self._fail(e)
                    return
                if self.streams:
                    for req in self.engine.slot_req:
                        if req is not None:
                            self._push_stream(req, done=False)
                for req in self.engine.completed:
                    self._push_stream(req, done=True)
                    ev = self.events.get(req.uid)
                    if ev is not None and not ev.is_set():
                        self.results[req.uid] = req
                        ev.set()
                self.engine.completed.clear()
            if active == 0:
                time.sleep(self.poll_idle_s)


def wrap_gguf_tokenizer(gg):
    """A GGUFTokenizer in the shape the handlers call (HF-like: callable
    returning {"input_ids": ...}, ``decode``, and ``apply_chat_template``
    when the GGUF carries a chat template)."""

    class _Wrap:
        eos_token_id = gg.eos_id

        def __call__(self, text):
            return {"input_ids": gg.encode(text)}

        def decode(self, ids):
            return gg.decode(ids)

    if gg.chat_template:
        _Wrap.apply_chat_template = staticmethod(gg.apply_chat_template)
    return _Wrap()


def _stops(req) -> list:
    stops = req.get("stop") or []
    return [stops] if isinstance(stops, str) else list(stops)


def make_handler(runner: EngineRunner, tokenizer=None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _sse_start(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

        def _sse_send(self, payload):
            data = payload if isinstance(payload, str) else json.dumps(payload)
            self.wfile.write(f"data: {data}\n\n".encode())
            self.wfile.flush()

        def do_GET(self):
            if self.path == "/health":
                eng = runner.engine
                if runner.error is not None:
                    self._json(500, {"status": "error", "error": repr(runner.error)})
                    return
                self._json(200, {"status": "ok",
                                 "active": sum(r is not None for r in eng.slot_req),
                                 "queued": len(eng.queue)})
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": "gptq-gguf-tpu", "object": "model", "owned_by": "gptq-gguf-tpu"}]})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                route = {"/completion": self._completion,
                         "/v1/completions": self._v1_completions,
                         "/v1/chat/completions": self._chat,
                         "/tokenize": self._tokenize, "/detokenize": self._detokenize}
                if self.path in route:
                    route[self.path](req)
                elif self.path == "/v1/embeddings":
                    self._json(400, {"error": "no embedding model loaded"})
                elif self.path in ("/v1/rerank", "/rerank"):
                    self._json(400, {"error": "no reranker model loaded"})
                else:
                    self._json(404, {"error": "unknown path"})
            except NotImplementedError as e:
                self._json(501, {"error": str(e)})
            except TimeoutError as e:
                self._json(504, {"error": str(e)})
            except ValueError as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 - surface to the client
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def _next_chunk(self, uid, q, timeout, started: bool):
            """The next (fresh, done) of a stream. An engine failure before
            the first chunk raises (500); after it, ends the stream with an
            error event and returns None."""
            fresh, done = q.get(timeout=timeout)
            if not isinstance(done, BaseException):
                return fresh, done
            if not started:
                runner.wait(uid, timeout=1)  # raises the engine's error
            self._sse_send({"error": f"the engine failed: {type(done).__name__}: {done}"})
            self._sse_send("[DONE]")
            return None

        def _completion(self, req):
            if "prompt_tokens" in req:
                prompt = np.asarray(req["prompt_tokens"], np.int64)
            elif "prompt" in req and tokenizer is not None:
                prompt = np.asarray(tokenizer(req["prompt"])["input_ids"], np.int64)
            else:
                self._json(400, {"error": "need prompt_tokens (or prompt with a tokenizer)"})
                return
            sp = _sampling_from_json(req)
            max_new = int(req.get("max_new_tokens", 64))
            timeout = float(req.get("timeout_s", 600))
            t0 = time.time()
            if req.get("stream"):
                uid = runner.submit(prompt, max_new, sp, stream=True)
                q = runner.stream_queue(uid)
                started = False
                while True:
                    chunk = self._next_chunk(uid, q, timeout, started)
                    if chunk is None:
                        return
                    fresh, done = chunk
                    if not started:
                        self._sse_start()
                        started = True
                    if fresh:
                        self._sse_send({"tokens": fresh})
                    if done is not None:
                        self._sse_send({"finish_reason": done.finish_reason,
                                        "latency_s": round(time.time() - t0, 3)})
                        self._sse_send("[DONE]")
                        runner.wait(uid, timeout=1)  # reap the result entry
                        return
            uid = runner.submit(prompt, max_new, sp, logprobs=int(req.get("logprobs", 0)))
            result = runner.wait(uid, timeout=timeout)
            out: Dict[str, Any] = {"tokens": result.output,
                                   "finish_reason": result.finish_reason,
                                   "latency_s": round(time.time() - t0, 3)}
            if result.logprob_data:
                out["logprobs"] = {
                    "token_logprobs": [d[0] for d in result.logprob_data],
                    "top": [[{"id": i, "logprob": v} for i, v in zip(d[1], d[2])]
                            for d in result.logprob_data]}
            if tokenizer is not None:
                out["text"] = tokenizer.decode(result.output)
            self._json(200, out)

        def _finish_text(self, tokens, finish, stops):
            """Decoded text of a finished request: eos dropped, cut at the
            first stop string."""
            eos = getattr(runner.engine, "eos", None)
            if eos is not None and tokens and tokens[-1] == eos:
                tokens = tokens[:-1]
            text = tokenizer.decode(tokens)
            for s in stops:
                i = text.find(s)
                if i >= 0:
                    text, finish = text[:i], "stop"
            return text, finish

        def _chat_messages(self, req):
            """The chat prompt's token ids, or None after answering 400."""
            if tokenizer is None or not hasattr(tokenizer, "apply_chat_template"):
                self._json(400, {"error": "no chat-capable tokenizer loaded"})
                return None
            messages = req.get("messages")
            if not messages:
                self._json(400, {"error": "need messages"})
                return None
            flat = []
            for msg in messages:
                content = msg.get("content")
                if isinstance(content, list):  # OpenAI multi-part content
                    if any(part.get("type") == "image_url" for part in content):
                        self._json(400, {"error": "no vision tower loaded"})
                        return None
                    msg = {**msg, "content": "".join(part.get("text", "") for part in content
                                                     if part.get("type") == "text")}
                flat.append(msg)
            text = tokenizer.apply_chat_template(flat, add_generation_prompt=True,
                                                 tokenize=False)
            return np.asarray(tokenizer(text)["input_ids"], np.int64)

        def _chat(self, req):
            """OpenAI-compatible chat completion: renders the tokenizer's
            chat template, generates, trims at eos and any "stop" strings."""
            prompt = self._chat_messages(req)
            if prompt is None:
                return
            max_new = int(req.get("max_tokens", req.get("max_new_tokens", 128)))
            sp = _sampling_from_json(req)
            stops = _stops(req)
            want_lp = int(req.get("top_logprobs", 1)) if req.get("logprobs") else 0
            t0 = time.time()
            if req.get("stream"):
                self._chat_stream(req, prompt, max_new, sp, stops, t0)
                return
            n = max(1, int(req.get("n", 1)))
            uids = []
            for i in range(n):
                sp_i = sp
                if n > 1 and sp is not None and sp.seed is not None:
                    sp_i = dataclasses.replace(sp, seed=sp.seed + i)  # distinct draws
                uids.append(runner.submit(prompt, max_new, sp_i, logprobs=want_lp))
            timeout = float(req.get("timeout_s", 600))
            results = [runner.wait(u, timeout=timeout) for u in uids]
            choices = []
            for idx, result in enumerate(results):
                content, finish = self._finish_text(list(result.output),
                                                    result.finish_reason or "length", stops)
                choice: Dict[str, Any] = {
                    "index": idx, "message": {"role": "assistant", "content": content},
                    "finish_reason": finish}
                if result.logprob_data:
                    choice["logprobs"] = {"content": [
                        {"token": tokenizer.decode([t]), "logprob": d[0],
                         "top_logprobs": [{"token": tokenizer.decode([i]), "logprob": v}
                                          for i, v in zip(d[1], d[2])]}
                        for t, d in zip(result.output, result.logprob_data)]}
                choices.append(choice)
            n_out = sum(len(r.output) for r in results)
            self._json(200, {
                "id": f"chatcmpl-{results[0].uid}", "object": "chat.completion",
                "created": int(t0), "model": req.get("model", "gptq-gguf-tpu"),
                "choices": choices,
                "usage": {"prompt_tokens": int(prompt.size), "completion_tokens": n_out,
                          "total_tokens": int(prompt.size) + n_out},
            })

        def _chat_stream(self, req, prompt, max_new, sp, stops, t0):
            """OpenAI chat.completion.chunk SSE stream. Decoded text is held
            back by max(len(stop)) - 1 characters so a stop string across
            two chunks is never partly sent."""
            uid = runner.submit(prompt, max_new, sp, stream=True)
            q = runner.stream_queue(uid)
            eos = getattr(runner.engine, "eos", None)
            base = {"id": f"chatcmpl-{uid}", "object": "chat.completion.chunk",
                    "created": int(t0), "model": req.get("model", "gptq-gguf-tpu")}
            hold = max((len(s) for s in stops), default=0)
            toks: list = []
            emitted = 0
            started = False
            timeout = float(req.get("timeout_s", 600))
            while True:
                chunk = self._next_chunk(uid, q, timeout, started)
                if chunk is None:
                    return
                fresh, done = chunk
                if not started:
                    self._sse_start()
                    self._sse_send({**base, "choices": [{
                        "index": 0, "delta": {"role": "assistant"}, "finish_reason": None}]})
                    started = True
                toks.extend(fresh)
                shown = list(toks)
                if done is not None and eos is not None and shown and shown[-1] == eos:
                    shown = shown[:-1]
                text = tokenizer.decode(shown)
                finish = None
                cuts = [i for i in (text.find(s) for s in stops) if i >= 0]
                if cuts:
                    text, finish = text[:min(cuts)], "stop"
                elif done is not None:
                    finish = done.finish_reason or "length"
                safe = len(text) if finish else max(emitted, len(text) - hold)
                if safe > emitted:
                    self._sse_send({**base, "choices": [{
                        "index": 0, "delta": {"content": text[emitted:safe]},
                        "finish_reason": None}]})
                    emitted = safe
                if finish:
                    self._sse_send({**base, "choices": [{
                        "index": 0, "delta": {}, "finish_reason": finish}]})
                    self._sse_send("[DONE]")
                    if done is not None:
                        runner.wait(uid, timeout=1)
                    else:  # stop-string hit: free the slot at once
                        runner.cancel(uid)
                    return

        def _tokenize(self, req):
            if tokenizer is None or "content" not in req:
                self._json(400, {"error": "need content (and a tokenizer)"})
                return
            self._json(200, {"tokens": list(map(int, tokenizer(req["content"])["input_ids"]))})

        def _detokenize(self, req):
            if tokenizer is None or "tokens" not in req:
                self._json(400, {"error": "need tokens (and a tokenizer)"})
                return
            self._json(200, {"content": tokenizer.decode([int(t) for t in req["tokens"]])})

        def _v1_completions(self, req):
            """OpenAI legacy text-completions shape over the engine."""
            prompt = req.get("prompt")
            if prompt is None or tokenizer is None:
                self._json(400, {"error": "need prompt (and a tokenizer)"})
                return
            ids = np.asarray(tokenizer(prompt)["input_ids"], np.int64)
            sp = _sampling_from_json(req)
            t0 = time.time()
            uid = runner.submit(ids, int(req.get("max_tokens", 16)), sp)
            result = runner.wait(uid, timeout=float(req.get("timeout_s", 600)))
            text, finish = self._finish_text(list(result.output),
                                             result.finish_reason or "length", _stops(req))
            self._json(200, {
                "id": f"cmpl-{result.uid}", "object": "text_completion", "created": int(t0),
                "model": req.get("model", "gptq-gguf-tpu"),
                "choices": [{"index": 0, "text": text, "finish_reason": finish}],
                "usage": {"prompt_tokens": int(ids.size),
                          "completion_tokens": len(result.output),
                          "total_tokens": int(ids.size) + len(result.output)},
            })

    return Handler


def serve_http(engine, host: str = "127.0.0.1", port: int = 8080, tokenizer=None,
               block: bool = True):
    """Start the engine thread and the HTTP server. With block=False returns
    (server, runner); the caller shuts down with server.shutdown() and
    runner.stop()."""
    runner = EngineRunner(engine).start()
    server = ThreadingHTTPServer((host, port), make_handler(runner, tokenizer))
    if not block:
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server, runner
    try:
        print(f"serving on http://{host}:{server.server_address[1]}", flush=True)
        server.serve_forever()
    finally:
        runner.stop()
