"""HTTP front end over InferenceServer, standard library only.

Counterpart of kfunca_tpu/models/api_server.py, with the same endpoints,
request fields, response bodies and errors:

    POST /v1/completions   {"prompt": "text" | [tokens], "max_tokens": N,
                            "temperature", "top_p", "top_k", "min_p", "eos",
                            "stop": [[tok, ...], ...], "lora_id",
                            "repetition_penalty", "presence_penalty",
                            "frequency_penalty", "logit_bias",
                            "stream": false}
                           -> {"id", "object", "choices": [{"text"?,
                               "tokens", "logprobs", "finish_reason"}],
                               "usage"}
                           stream=true -> text/event-stream, one
                           `data: {"id", "token", "text"?, "logprob",
                           "finished"}` event a token, then `data: [DONE]`
    POST /v1/chat/completions  {"messages": [{"role", "content"}, ...]}
                           rendered as ChatML (needs a tokenizer with the
                           ChatML specials), ending at <|im_end|>
    POST /v1/cancel        {"id": N} -> {"cancelled": bool}
    GET  /v1/stats         the engine's throughput_stats and queue depth
    GET  /v1/models        a summary of the model config
    400 for a bad body, 404 for an unknown path.

One engine thread owns the InferenceServer; HTTP handler threads never
touch it.  A handler puts (operation, payload, event queue) into an inbox
and waits on its queue; the engine thread drains the inbox, advances the
scheduler one iteration (`stream(max_steps=1)`) and routes each token to
its request's queue, so requests that arrive mid-flight join the running
batch.  Idle, it blocks on the inbox.  The current CUDA device is per
thread, and the kernel wrappers launch on the current device's stream, so
the engine thread enters the server's device before it runs anything.

Text: with a tokenizer (models/tokenizer.BPETokenizer, or anything with
encode / decode / decode_bytes / special_id), string prompts are encoded
on the server and streamed tokens are decoded incrementally, a partial
UTF-8 sequence held back until its last byte arrives.
"""

from __future__ import annotations

import codecs
import contextlib
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


class _Utf8Carry:
    """Incremental UTF-8 decode: emits complete characters only, carrying
    a partial trailing sequence to the next chunk (malformed bytes become
    replacement characters; nothing stalls)."""

    def __init__(self):
        self._dec = codecs.getincrementaldecoder("utf-8")(errors="replace")

    def feed(self, data: bytes) -> str:
        return self._dec.decode(data, False)

    @property
    def pending(self) -> bytes:
        return self._dec.getstate()[0]


CHAT_SPECIALS = ("<|im_start|>", "<|im_end|>")


def chatml_prompt(tokenizer, messages) -> np.ndarray:
    """[{"role", "content"}] rendered as ChatML and encoded:

        <|im_start|>role\\ncontent<|im_end|>\\n ... <|im_start|>assistant\\n

    The tokenizer must register CHAT_SPECIALS (KeyError otherwise)."""
    for lit in CHAT_SPECIALS:
        tokenizer.special_id(lit)
    text = "".join(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
                   for m in messages)
    return tokenizer.encode(text + "<|im_start|>assistant\n")


# request fields passed to InferenceServer.submit under the same name
_FORWARDED = ("temperature", "top_p", "top_k", "min_p", "eos", "stop",
              "lora_id", "repetition_penalty", "presence_penalty",
              "frequency_penalty")


class ApiServer:
    """HTTP API around an InferenceServer.  start() starts the engine
    thread and the listener; shutdown() stops both.  port=0 binds a free
    port (read it back from `.port`)."""

    def __init__(self, engine, tokenizer=None, host: str = "127.0.0.1",
                 port: int = 0):
        self.engine = engine
        self.tokenizer = tokenizer
        self._inbox: queue.Queue = queue.Queue()
        self._events: dict[int, queue.Queue] = {}
        self._lock = threading.Lock()  # guards _events
        self._stop = threading.Event()
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="kfunca-engine", daemon=True)
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.host, self.port = self._httpd.server_address[:2]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="kfunca-http", daemon=True)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._engine_thread.start()
        self._http_thread.start()
        return self

    def shutdown(self):
        self._stop.set()
        self._inbox.put(None)  # wake the engine thread
        self._httpd.shutdown()
        self._httpd.server_close()
        self._engine_thread.join(timeout=30)

    # -- engine thread -----------------------------------------------------
    def _engine_loop(self):
        try:
            dev = self.engine.device
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                self._engine_loop_inner()
        except Exception as e:  # the engine died: fail every waiter
            self._stop.set()
            with self._lock:
                for evq in self._events.values():
                    evq.put(("error", f"engine thread died: {e!r}"))
                self._events.clear()
            while True:
                try:
                    item = self._inbox.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[2].put(("error", f"engine thread died: {e!r}"))

    def _engine_loop_inner(self):
        while not self._stop.is_set():
            # drain the inbox; block while the engine is idle
            idle = not self._engine_busy()
            try:
                item = self._inbox.get(block=idle,
                                       timeout=0.5 if idle else None)
            except queue.Empty:
                item = False  # idle timeout: look again
            while item is not False:
                if item is None:  # shutdown's wake-up
                    if self._stop.is_set():
                        return
                    break
                op, payload, evq = item
                if op == "submit":
                    try:
                        rid = self.engine.submit(**payload)
                    except (TypeError, ValueError) as e:  # bad parameters
                        evq.put(("error", str(e)))
                    else:
                        with self._lock:
                            self._events[rid] = evq
                        evq.put(("rid", rid))
                else:  # "cancel": the engine's state changes on this thread
                    evq.put(("cancelled", self.engine.cancel(payload)))
                try:
                    item = self._inbox.get_nowait()
                except queue.Empty:
                    item = False
            # one scheduler iteration: admission, prefill chunks, decode
            for rid, token, logprob, finished in self.engine.stream(
                    max_steps=1):
                with self._lock:
                    evq = self._events.get(rid)
                if evq is None:
                    continue
                evq.put(("token", (int(token), float(logprob), finished)))
                if finished:
                    evq.put(("done", None))
                    with self._lock:
                        self._events.pop(rid, None)
            # a cancelled request ends without a token event
            with self._lock:
                ended = [rid for rid in self._events
                         if self.engine.requests[rid].done]
                for rid in ended:
                    self._events.pop(rid).put(("done", None))

    def _engine_busy(self) -> bool:
        e = self.engine
        return (len(e.queue) > 0 or bool(e._prefill_state)
                or any(r is not None for r in e.slot_req))

    # -- called from handler threads ---------------------------------------
    def submit_async(self, spec: dict) -> tuple[int, queue.Queue]:
        """Hand a request to the engine thread and wait for its id."""
        evq: queue.Queue = queue.Queue()
        self._inbox.put(("submit", spec, evq))
        kind, val = evq.get(timeout=120)
        if kind == "error":
            raise ValueError(val)
        return val, evq

    def cancel(self, rid: int) -> bool:
        """Cancel a request; the engine thread does it."""
        evq: queue.Queue = queue.Queue()
        self._inbox.put(("cancel", rid, evq))
        return bool(evq.get(timeout=120)[1])


def _make_handler(api: ApiServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet: no line a request
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):  # noqa: N802 (http.server's name)
            if self.path == "/v1/stats":
                stats = dict(api.engine.throughput_stats())
                stats["queued"] = len(api.engine.queue)
                self._json(200, stats)
            elif self.path == "/v1/models":
                cfg = api.engine.cfg
                self._json(200, {
                    "d_model": cfg.d_model, "n_layers": cfg.n_layers,
                    "n_heads": cfg.n_heads, "vocab_size": cfg.vocab_size,
                    "n_experts": cfg.n_experts,
                    "text": api.tokenizer is not None})
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            try:
                body = self._read_body()
            except ValueError as e:  # json.JSONDecodeError included
                return self._json(400, {"error": f"bad json: {e}"})
            if self.path == "/v1/cancel":
                return self._json(
                    200, {"cancelled": api.cancel(int(body.get("id", -1)))})
            if self.path == "/v1/chat/completions":
                if api.tokenizer is None:
                    return self._json(400, {
                        "error": "chat needs a server tokenizer"})
                msgs = body.get("messages")
                if not isinstance(msgs, list) or not all(
                        isinstance(m, dict) and "role" in m
                        and "content" in m for m in msgs):
                    return self._json(400, {
                        "error": "messages: [{role, content}, ...]"})
                try:
                    body["prompt"] = chatml_prompt(api.tokenizer,
                                                   msgs).tolist()
                except KeyError as e:
                    return self._json(400, {
                        "error": f"tokenizer lacks chat special token {e}"})
                # the default stop: the end-of-turn marker
                body.setdefault("stop", [[int(api.tokenizer.special_id(
                    "<|im_end|>"))]])
            elif self.path != "/v1/completions":
                return self._json(404, {"error": f"unknown path {self.path}"})

            prompt = body.get("prompt")
            if isinstance(prompt, str):
                if api.tokenizer is None:
                    return self._json(400, {
                        "error": "string prompt needs a server tokenizer; "
                                 "send token ids"})
                prompt_ids = np.asarray(api.tokenizer.encode(prompt),
                                        np.int32)
            elif isinstance(prompt, list):
                prompt_ids = np.asarray(prompt, np.int32)
            else:
                return self._json(400, {"error": "prompt: string or [ids]"})

            spec = {"prompt": prompt_ids,
                    "max_new": int(body.get("max_tokens", 16))}
            spec.update({k: body[k] for k in _FORWARDED if k in body})
            if "logit_bias" in body:  # JSON keys are strings
                spec["logit_bias"] = {int(k): float(v) for k, v in
                                      body["logit_bias"].items()}
            try:
                rid, evq = api.submit_async(spec)
            except ValueError as e:
                return self._json(400, {"error": str(e)})

            if body.get("stream"):
                return self._stream_response(rid, evq)
            tokens, logprobs = [], []
            finished = False
            while not finished:
                kind, val = evq.get(timeout=600)
                if kind == "error":
                    return self._json(500, {"error": val})
                if kind == "done":
                    break
                tok, lp, finished = val
                tokens.append(tok)
                logprobs.append(lp)
            req = api.engine.requests[rid]
            reason = "cancelled" if req.cancelled else (
                "stop" if len(tokens) < spec["max_new"] else "length")
            choice = {"tokens": tokens, "logprobs": logprobs,
                      "finish_reason": reason}
            if api.tokenizer is not None:
                choice["text"] = api.tokenizer.decode(tokens)
            is_chat = self.path == "/v1/chat/completions"
            if is_chat:
                end_id = api.tokenizer.special_id("<|im_end|>")
                shown = (tokens[:-1] if tokens and tokens[-1] == end_id
                         else tokens)
                choice["message"] = {"role": "assistant",
                                     "content": api.tokenizer.decode(shown)}
            self._json(200, {
                "id": rid,
                "object": "chat.completion" if is_chat else "text_completion",
                "choices": [choice],
                "usage": {"prompt_tokens": int(prompt_ids.size),
                          "completion_tokens": len(tokens),
                          "total_tokens": int(prompt_ids.size) + len(tokens)},
            })

        def _stream_response(self, rid: int, evq: queue.Queue):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            carry = _Utf8Carry() if api.tokenizer is not None else None
            while True:
                kind, val = evq.get(timeout=600)
                if kind in ("done", "error"):
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                    return
                tok, lp, finished = val
                ev = {"id": rid, "token": tok, "logprob": lp,
                      "finished": finished}
                if carry is not None:
                    ev["text"] = carry.feed(api.tokenizer.decode_bytes([tok]))
                self.wfile.write(b"data: " + json.dumps(ev).encode() + b"\n\n")
                self.wfile.flush()

    return Handler
