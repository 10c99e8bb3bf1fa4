"""OpenAI-compatible HTTP server over the continuous-batching engine.

Counterpart of `paroquant_tpu/serve/api.py`, with the same endpoints,
bodies, status codes and JSON shapes:

  POST /v1/chat/completions   (stream + non-stream)
  POST /v1/completions        (by `prompt` or `prompt_token_ids`; echo scoring)
  GET  /v1/models
  GET  /health, /metrics

The JAX package serves on aiohttp, which the card's machine does not have.
This server is the standard library's: `Server.handle(method, path, body)`
maps a request to a `Response` (status, headers, and a body or an iterator
of server-sent-event chunks) and knows nothing of sockets; the transport is
`http.server.ThreadingHTTPServer`, one handler thread a connection, which
blocks on the request's `out_queue` and writes each SSE chunk (chunked
transfer encoding) as it comes. The Engine steps on its own thread
(`Engine.start`); handler threads call `submit`, `cancel` and `score_sync`,
all on the default stream of the current device, so the kernels' launches
stay in stream order. If the Engine's thread dies, the requests it holds
wait forever: a client sets its own timeout.

Images, as in JAX: `/v1/completions` takes a raw `pixel_values` array
([N_img, C, H, W], beside `prompt_token_ids` whose image_token_id runs mark
the images), and chat messages with image parts go through the `processor`
given to the Server (a transformers AutoProcessor: its chat template and
pixel preprocessing); without one they get 400. The difference from the
JAX server: a body that is not a JSON object gets 400 (aiohttp answers
500).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import threading
import time
import traceback
import uuid
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Iterator

import numpy as np

from .engine import Engine, EngineOverloaded
from .sampling import SamplingParams


def _sampling_from_body(body: dict[str, Any], engine: Engine, prompt_len: int = 0) -> SamplingParams:
    room = max(engine.max_len - prompt_len, 1)
    stop = body.get("stop") or ()
    if isinstance(stop, str):
        stop = (stop,)
    logprobs = body.get("logprobs")
    return SamplingParams(
        max_tokens=min(int(body.get("max_tokens") or 512), room),
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", 0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        seed=body.get("seed"),
        # completions: integer `logprobs` = N alternatives; chat: boolean
        # `logprobs` + integer `top_logprobs`
        top_logprobs=min(
            int(body.get("top_logprobs")
                or (logprobs if isinstance(logprobs, int) and not isinstance(logprobs, bool)
                    else 0)
                or 0),
            8,
        ),
        stop=tuple(stop),
        logit_bias=tuple((int(t), float(b)) for t, b in (body.get("logit_bias") or {}).items()),
    )


def _find_stop(text: str, stops: tuple[str, ...]) -> int:
    """Earliest index of any stop sequence in text, or -1."""
    hit = -1
    for s in stops:
        i = text.find(s)
        if i >= 0 and (hit < 0 or i < hit):
            hit = i
    return hit


@dataclasses.dataclass
class Response:
    """An HTTP response: `body` bytes, or `chunks` (an iterator of SSE chunk
    bytes) for a stream. Closing `chunks` early cancels its request."""

    status: int
    headers: dict[str, str]
    body: bytes = b""
    chunks: Iterator[bytes] | None = None
    reason: str | None = None

    def json(self) -> Any:
        return json.loads(self.body)


class HTTPError(Exception):
    """An error answer: aiohttp's shape, text "<status>: <reason>"."""

    def __init__(self, status: int, reason: str, headers: dict[str, str] | None = None):
        super().__init__(reason)
        self.status, self.reason, self.headers = status, reason, headers or {}

    def response(self) -> Response:
        return Response(self.status, {"Content-Type": "text/plain; charset=utf-8", **self.headers},
                        f"{self.status}: {self.reason}".encode(), reason=self.reason)


def json_response(payload: Any) -> Response:
    return Response(200, {"Content-Type": "application/json; charset=utf-8"},
                    json.dumps(payload).encode())


class Server:
    def __init__(self, engine: Engine, model_name: str = "paroquant-tpu", processor: Any = None):
        # `processor` (a transformers AutoProcessor, optional) serves chat
        # messages with image parts: the model's image templating and pixel
        # preprocessing
        self.engine = engine
        self.model_name = model_name
        self.processor = processor
        # handler threads submit one request's choices at a time, as JAX's
        # event loop does (the Engine's counters are not thread-safe)
        self._submit_lock = threading.Lock()
        self.routes = {
            ("POST", "/v1/chat/completions"): self.chat_completions,
            ("POST", "/v1/completions"): self.completions,
            ("GET", "/v1/models"): self.models,
            ("GET", "/health"): self.health,
            ("GET", "/metrics"): self.metrics,
        }

    # ------------------------------------------------------------------
    # request handling (no sockets)
    # ------------------------------------------------------------------

    def handle(self, method: str, path: str, body: bytes = b"") -> Response:
        """The answer to one request; `body` is the raw request body."""
        path = path.split("?", 1)[0]
        fn = self.routes.get((method, path))
        try:
            if fn is None:
                if any(p == path for _, p in self.routes):
                    raise HTTPError(405, "Method Not Allowed")
                raise HTTPError(404, "Not Found")
            if method == "GET":
                return fn()
            try:
                body = json.loads(body or b"null")
            except ValueError as e:
                raise HTTPError(400, f"invalid JSON body: {e}") from None
            if not isinstance(body, dict):
                raise HTTPError(400, "the body must be a JSON object")
            return fn(body)
        except HTTPError as e:
            return e.response()

    def health(self) -> Response:
        return json_response({"status": "ok"})

    def metrics(self) -> Response:
        out = dict(self.engine.metrics)
        out.update(self.engine.ttft_stats())
        out.update(self.engine.step_time_stats())
        return json_response(out)

    def models(self) -> Response:
        return json_response({
            "object": "list",
            "data": [{"id": self.model_name, "object": "model", "owned_by": "paroquant-tpu"}],
        })

    @staticmethod
    def _has_image_parts(messages: list[dict]) -> bool:
        return any(
            isinstance(m.get("content"), list)
            and any(p.get("type") in ("image_url", "image") for p in m["content"])
            for m in messages
        )

    def chat_completions(self, body: dict) -> Response:
        if "messages" not in body:
            raise HTTPError(400, "missing 'messages'")
        messages = body["messages"]
        pixel_values = None
        if self._has_image_parts(messages):
            if self.processor is None:
                raise HTTPError(400, "image content requires a vision processor "
                                     "(serve a VLM checkpoint with processor files)")
            enc = self.processor.apply_chat_template(
                messages, add_generation_prompt=True, tokenize=True, return_dict=True)
            prompt = list(map(int, enc["input_ids"][0]))
            pixel_values = np.asarray(enc["pixel_values"], np.float32)
        else:
            tok = self.engine.tokenizer
            if tok is None:
                raise HTTPError(400, "server has no tokenizer loaded")
            prompt = tok.apply_chat_template(messages, add_generation_prompt=True)
        return self._run(body, prompt, chat=True, pixel_values=pixel_values)

    def completions(self, body: dict) -> Response:
        tok = self.engine.tokenizer
        if "prompt_token_ids" in body:
            prompt = list(body["prompt_token_ids"])
        elif tok is not None and "prompt" in body:
            prompt = tok.encode(body["prompt"])
        else:
            raise HTTPError(400, "missing 'prompt'")
        pixel_values = None
        if "pixel_values" in body:  # raw engine-level image input
            pixel_values = np.asarray(body["pixel_values"], np.float32)
        if body.get("echo"):
            # prompt scoring (echo + logprobs + max_tokens=0): the lm_eval /
            # OpenAI loglikelihood protocol; echo with generation is refused
            if body.get("max_tokens") is None or int(body["max_tokens"]) != 0:
                raise HTTPError(400, "echo requires explicit max_tokens: 0 "
                                     "(prompt scoring); echo with generation is unsupported")
            lps = self.engine.score_sync(prompt)
            token_texts = [tok.decode([t]) for t in prompt] if tok else [str(t) for t in prompt]
            return json_response({
                "id": f"cmpl-{uuid.uuid4().hex[:12]}",
                "object": "text_completion",
                "created": int(time.time()),
                "model": self.model_name,
                "choices": [{
                    "index": 0,
                    "text": tok.decode(prompt, skip_special_tokens=True) if tok else "",
                    "logprobs": {"tokens": token_texts, "token_logprobs": lps,
                                 "text_offset": [], "top_logprobs": None},
                    "finish_reason": "stop",
                }],
                "usage": {"prompt_tokens": len(prompt), "completion_tokens": 0,
                          "total_tokens": len(prompt)},
            })
        return self._run(body, prompt, chat=False, pixel_values=pixel_values)

    def _submit_all(self, prompt: list[int], sp: SamplingParams, n: int, pixel_values=None) -> list:
        """Submit the n choices up front, so they decode concurrently; on a
        refusal, cancel those already submitted."""
        reqs = []
        try:
            with self._submit_lock:
                reqs.append(self.engine.submit(prompt, sp, pixel_values=pixel_values))
                for i in range(1, n):
                    # distinct sampling streams per choice: shift an explicit seed
                    seed = (sp.seed + i) if sp.seed is not None else None
                    reqs.append(self.engine.submit(prompt, dataclasses.replace(sp, seed=seed),
                                                   pixel_values=pixel_values))
        except EngineOverloaded as e:
            for r in reqs:
                self.engine.cancel(r)
            raise HTTPError(429, str(e), {"Retry-After": "1"}) from None
        except ValueError as e:
            for r in reqs:
                self.engine.cancel(r)
            raise HTTPError(400, str(e)) from None
        return reqs

    def _run(self, body: dict, prompt: list[int], chat: bool, pixel_values=None) -> Response:
        sp = _sampling_from_body(body, self.engine, len(prompt))
        n = max(int(body.get("n") or 1), 1)
        if n > 1 and body.get("stream"):
            raise HTTPError(400, "n>1 with stream is not supported")
        reqs = self._submit_all(prompt, sp, n, pixel_values)
        created = int(time.time())
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}" if chat else f"cmpl-{uuid.uuid4().hex[:12]}"
        if body.get("stream"):
            return Response(200, {"Content-Type": "text/event-stream", "Cache-Control": "no-cache"},
                            chunks=self._stream(reqs[0], sp, chat, rid, created))
        return json_response(self._complete(reqs, sp, body, prompt, chat, rid, created))

    def _stream(self, req, sp: SamplingParams, chat: bool, rid: str, created: int) -> Iterator[bytes]:
        tok = self.engine.tokenizer
        stops = sp.stop if tok else ()
        holdback = max((len(s) for s in stops), default=1) - 1

        def chunk(text: str, t: int | None, reason: str | None) -> bytes:
            out = {
                "id": rid,
                "object": "chat.completion.chunk" if chat else "text_completion",
                "created": created,
                "model": self.model_name,
                "choices": [{"index": 0, **({"delta": {"content": text}} if chat else {"text": text}),
                             "finish_reason": reason}],
            }
            if not tok and t is not None:
                out["choices"][0]["token_ids"] = [t]
            return f"data: {json.dumps(out)}\n\n".encode()

        # incremental detokenization: each delta is decoded from a window that
        # keeps the previous tokens' context, so tokenizers whose decoding is
        # not concatenation-stable still stream exact substrings of the full
        # decode; with stop strings, deltas go to `buf`, which keeps the last
        # `holdback` characters back so a stop that straddles chunks is caught
        all_toks: list[int] = []
        prefix_off = 0  # decode-window start
        read_off = 0  # tokens already turned into emitted text
        buf = ""
        n_recv = 0
        finish_reason = "stop"
        stopped = False  # a stop string ended the stream
        finished = False  # the engine is done with the request

        def delta() -> str | None:
            """Text of tokens read_off.. (None: an incomplete byte sequence)."""
            new_text = tok.decode(all_toks[prefix_off:], skip_special_tokens=True)
            if new_text.endswith("\ufffd"):
                return None
            prev_text = tok.decode(all_toks[prefix_off:read_off], skip_special_tokens=True)
            return new_text[len(prev_text):]

        try:
            while True:
                kind, t = req.out_queue.get()
                if kind == "done":
                    finished = True
                    if n_recv >= sp.max_tokens:
                        finish_reason = "length"
                    break
                n_recv += 1
                if not tok:
                    yield chunk("", t, None)  # token-ids-only protocol
                    continue
                all_toks.append(t)
                d = delta()
                if d is None:
                    continue
                prefix_off, read_off = read_off, len(all_toks)
                if not d:
                    continue
                if not stops:
                    yield chunk(d, t, None)
                    continue
                buf += d
                hit = _find_stop(buf, stops)
                if hit >= 0:
                    if hit > 0:
                        yield chunk(buf[:hit], t, None)
                    buf = ""
                    stopped = finished = True
                    self.engine.cancel(req)
                    break
                if len(buf) > holdback:
                    yield chunk(buf[:-holdback] if holdback else buf, t, None)
                    buf = buf[-holdback:] if holdback else ""
        finally:
            if not finished:  # the client went away mid-stream
                self.engine.cancel(req)
        if not stopped and tok:
            # the held-back tail and any trailing token fragment
            new_text = tok.decode(all_toks[prefix_off:], skip_special_tokens=True)
            prev_text = tok.decode(all_toks[prefix_off:read_off], skip_special_tokens=True)
            tail = buf + new_text[len(prev_text):]
            if tail:
                yield chunk(tail, None, None)
        yield chunk("", None, finish_reason)
        yield b"data: [DONE]\n\n"

    def _complete(self, reqs, sp, body, prompt, chat, rid, created) -> dict:
        tok = self.engine.tokenizer
        stops = sp.stop if tok else ()
        # stop detection decodes a tail window only: a character can take up
        # to 4 byte-fallback tokens, so 4x the stop length plus slack; the full
        # decode below still truncates exactly
        stop_win = 4 * max((len(s) for s in stops), default=0) + 8

        def collect(r):
            out: list[int] = []
            finish_reason = None
            while True:
                kind, t = r.out_queue.get()
                if kind == "done":
                    break
                out.append(t)
                if stops and _find_stop(tok.decode(out[-stop_win:], skip_special_tokens=True),
                                        stops) >= 0:
                    finish_reason = "stop"
                    self.engine.cancel(r)
                    break
            text = tok.decode(out, skip_special_tokens=True) if tok else ""
            if stops:
                hit = _find_stop(text, stops)
                if hit >= 0:
                    text = text[:hit]
                    finish_reason = "stop"
            if finish_reason is None:
                finish_reason = "length" if len(out) >= sp.max_tokens else "stop"
            return out, text, finish_reason

        choices = []
        total_completion = 0
        for idx, r in enumerate(reqs):
            out, text, finish_reason = collect(r)
            total_completion += len(out)
            logprobs_obj = None
            if body.get("logprobs"):
                logprobs_obj = self._logprobs(r, out, sp.top_logprobs, chat)
            choices.append({
                "index": idx,
                **({"message": {"role": "assistant", "content": text}} if chat else {"text": text}),
                "token_ids": out,
                **({"logprobs": logprobs_obj} if logprobs_obj else {}),
                "finish_reason": finish_reason,
            })
        return {
            "id": rid,
            "object": "chat.completion" if chat else "text_completion",
            "created": created,
            "model": self.model_name,
            "usage": {"prompt_tokens": len(prompt), "completion_tokens": total_completion,
                      "total_tokens": len(prompt) + total_completion},
            "choices": choices,
        }

    def _logprobs(self, r, out: list[int], n_top: int, chat: bool) -> dict:
        """Chat's or completions' `logprobs` object of one choice."""
        tok = self.engine.tokenizer
        lps = r.logprobs[: len(out)]
        tok_texts = [tok.decode([t]) for t in out] if tok else [str(t) for t in out]
        tops = r.top_logprobs[: len(out)] if n_top else []

        def top_entries(pos):
            if not n_top or pos >= len(tops):
                return None
            return [{"token": tok.decode([tid]) if tok else str(tid), "logprob": tlp}
                    for tid, tlp in tops[pos][:n_top]]

        if chat:
            return {"content": [
                {"token": s, "logprob": lp, **({"top_logprobs": top_entries(j)} if n_top else {})}
                for j, (s, lp) in enumerate(zip(tok_texts, lps))]}
        return {
            "tokens": tok_texts,
            "token_logprobs": lps,
            "text_offset": [],
            "top_logprobs": [{e["token"]: e["logprob"] for e in (top_entries(j) or [])}
                             for j in range(len(out))] if n_top else None,
        }

    # ------------------------------------------------------------------
    # transport
    # ------------------------------------------------------------------

    def listen(self, host: str = "0.0.0.0", port: int = 8000, access_log: bool = True
               ) -> ThreadingHTTPServer:
        """An HTTP server bound to (host, port) that answers through `handle`
        (port 0: any free port, read back from `server_address`)."""
        httpd = _HTTPServer((host, port), _Handler)
        httpd.app = self
        httpd.access_log = access_log
        return httpd

    @contextlib.contextmanager
    def serving(self, host: str = "127.0.0.1", port: int = 0):
        """Serve from a background thread; yields the base URL and shuts the
        HTTP server down on exit. The Engine is started and stopped by the
        caller."""
        httpd = self.listen(host, port, access_log=False)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            h, p = httpd.server_address[:2]
            yield f"http://{h}:{p}"
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=10)

    def run(self, host: str = "0.0.0.0", port: int = 8000):
        """Start the Engine and serve until interrupted."""
        self.engine.start()
        httpd = self.listen(host, port)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
            self.engine.stop()


class _HTTPServer(ThreadingHTTPServer):
    """aiohttp's listen backlog (128), which JAX's server has. With the
    standard library's 5, connections that arrive together while the accept
    loop waits for the interpreter lock overflow the queue, and the client
    resends its SYN only after a second."""

    request_queue_size = 128


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "paroquant-tpu-torch"

    def do_GET(self):
        self._answer("GET")

    def do_POST(self):
        self._answer("POST")

    def _answer(self, method: str) -> None:
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        try:
            resp = self.server.app.handle(method, self.path, body)
        except Exception:  # the server keeps serving: a 500, as aiohttp answers
            traceback.print_exc(file=sys.stderr)
            resp = HTTPError(500, "Internal Server Error").response()
        self.send_response(resp.status, resp.reason or HTTPStatus(resp.status).phrase)
        for k, v in resp.headers.items():
            self.send_header(k, v)
        if resp.chunks is None:
            self.send_header("Content-Length", str(len(resp.body)))
            self.end_headers()
            self.wfile.write(resp.body)
            return
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        with contextlib.closing(resp.chunks):
            for piece in resp.chunks:
                if piece:
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(piece), piece))
                    self.wfile.flush()
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def log_message(self, format, *args):
        if self.server.access_log:
            super().log_message(format, *args)
