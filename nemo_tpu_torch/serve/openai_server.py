"""LLM serving with an OpenAI-compatible HTTP API (counterpart of
nemo_tpu/serve/openai_server.py, GPT family).

    srv = LLMServer(cfg, params, tokenizer, max_slots=8, max_len=1024,
                    quantize_weights=True, quantize_kv_cache=True)
    srv.serve(port=0, blocking=False)      # srv.port is the bound port
    ...                                    # POST /v1/completions, /v1/chat/completions
    srv.shutdown()

A stdlib ThreadingHTTPServer in front of one worker thread that runs a
`ContinuousBatchingEngine` on the card (or `device="cpu"`): it admits queued
requests into free slots (registering a prompt prefix shared with a recent
one, so that later admissions skip it), then decodes every active slot,
`decode_chunk` tokens a call, each slot sampled with its own request's
parameters. `quantize_weights` serves int8-resident PTQ weights
(`llm/api.py:ptq(algorithm="int8_serve")`), `quantize_kv_cache` an int8 KV
cache. `score` runs a plain forward with no cache (the flash kernel K5
where the backend is "flash" and the padded length a multiple of 128).
Routes: POST /v1/completions (with logprobs + max_tokens 0: scoring),
POST /v1/chat/completions (with `stream`: server-sent events), GET
/v1/models, GET /health.

Not ported, and refused with NotImplementedError: the SSM engine (configs
other than GPTConfig), the VLM sidecar (`vlm`, image content parts) and
sharded serving (`mesh_cfg`, ROADMAP A8).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from nemo_tpu_torch.models.llm.config import GPTConfig
from nemo_tpu_torch.models.llm.generate import ContinuousBatchingEngine, SamplingParams

log = logging.getLogger(__name__)

_END = object()  # stream sentinel


class _StreamRequest:
    def __init__(self, prompt_ids, max_new: int, eos_id: int, temperature: float,
                 top_k: int = 0, top_p: float = 0.0):
        self.prompt_ids = prompt_ids
        self.max_new = max_new
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.tokens: "queue.Queue" = queue.Queue()
        self.produced = 0


def _decode_image_url(url: str):
    raise NotImplementedError("image inputs (the VLM sidecar) are not ported")


def extract_chat_media(messages: Sequence[Dict]):
    raise NotImplementedError("image inputs (the VLM sidecar) are not ported")


def format_chat(messages: Sequence[Dict[str, str]], template: str = "chatml") -> str:
    """Chat template: chatml, or a plain "role: content" fallback
    (openai_server.py:86)."""
    if template == "chatml":
        parts = [f"<|im_start|>{m.get('role', 'user')}\n{m.get('content', '')}<|im_end|>"
                 for m in messages]
        return "\n".join(parts) + "\n<|im_start|>assistant\n"
    return "\n".join(f"{m.get('role', 'user')}: {m.get('content', '')}"
                     for m in messages) + "\nassistant:"


class LLMServer:
    """Continuous-batching scheduler and HTTP frontend (openai_server.py:97)."""

    def __init__(self, cfg, params, tokenizer, *, max_slots: int = 4, max_len: int = 512,
                 model_name: str = "nemo-tpu-llm", chat_template: str = "chatml",
                 enable_prefix_caching: bool = True, auto_prefix_min_tokens: int = 16,
                 quantize_weights: bool = False, quantize_kv_cache: bool = False,
                 decode_chunk: int = 8, mesh_cfg=None, vlm=None,
                 device: Union[str, torch.device, None] = None):
        if not isinstance(cfg, GPTConfig):
            raise NotImplementedError("only the GPT family is served: the SSM engine is not "
                                      "ported")
        if vlm is not None:
            raise NotImplementedError("the VLM sidecar is not ported")
        if quantize_weights and cfg.quantization != "int8_ptq":
            from nemo_tpu_torch.llm.api import ptq

            cfg, params = ptq(cfg, params, algorithm="int8_serve")
        self.engine = ContinuousBatchingEngine(
            cfg, params, max_slots=max_slots, max_len=max_len,
            cache_dtype=torch.int8 if quantize_kv_cache else torch.bfloat16, mesh_cfg=mesh_cfg,
            device=device)
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.chat_template = chat_template
        self.max_slots = max_slots
        self.max_len = max_len
        self.enable_prefix_caching = enable_prefix_caching
        self.auto_prefix_min_tokens = auto_prefix_min_tokens
        self.decode_chunk = decode_chunk  # tokens a decode call; 1 steps one at a time
        self.port: Optional[int] = None
        self._recent_prompts: deque = deque(maxlen=8)
        self._queue: "queue.Queue[_StreamRequest]" = queue.Queue()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._http: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None

    def submit_vlm(self, messages, sampling: SamplingParams) -> str:
        raise NotImplementedError("the VLM sidecar is not ported")

    def _maybe_register_prefix(self, ids) -> None:
        """Worker thread only: register the longest prefix this prompt shares
        with a recent one, where it is at least auto_prefix_min_tokens long
        and shorter than the prompt (openai_server.py:205)."""
        key = tuple(ids)
        best = 0
        for prev in self._recent_prompts:
            n = 0
            for a, b in zip(prev, key):
                if a != b:
                    break
                n += 1
            best = max(best, n)
        self._recent_prompts.append(key)
        if self.auto_prefix_min_tokens <= best < len(key):
            try:
                self.engine.register_prefix(list(key[:best]))
            except ValueError:
                pass  # longer than max_len: admitted without the prefix

    # -- continuous-batching scheduler ----------------------------------------
    def _run(self) -> None:
        """The worker: `_loop` until shutdown. A failure ends every request
        held or queued (their streams end) and is kept: later submissions
        raise it."""
        slots: List[Optional[_StreamRequest]] = [None] * self.max_slots
        try:
            self._loop(slots)
        except Exception as e:  # the worker's boundary: report, end every stream
            log.exception("LLMServer worker failed")
            self._error = e
            for req in slots:
                if req is not None:
                    req.tokens.put(_END)
            while True:
                try:
                    self._queue.get_nowait().tokens.put(_END)
                except queue.Empty:
                    break

    def _loop(self, slots: List[Optional[_StreamRequest]]) -> None:
        """Admit waiting requests into free slots, then one decode call for
        every active slot (openai_server.py:225)."""
        feed = np.zeros(self.max_slots, np.int64)
        step = 0
        while not self._stop.is_set():
            admitted = False
            for s in range(self.max_slots):
                if slots[s] is not None:
                    continue
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                try:
                    if self.enable_prefix_caching:
                        self._maybe_register_prefix(req.prompt_ids)
                    tok = self.engine.prefill_slot(s, req.prompt_ids, req.temperature,
                                                   seed=step, top_k=req.top_k, top_p=req.top_p)
                except Exception:  # one request's failure: it ends, the others go on
                    log.exception("LLMServer prefill failed")
                    req.tokens.put(_END)
                    continue
                slots[s] = req
                feed[s] = tok
                self._emit(slots, feed, s)
                admitted = True
            active = np.asarray([r is not None for r in slots])
            if not active.any():
                if not admitted:
                    time.sleep(0.002)
                continue
            temps = np.asarray([r.temperature if r else 0.0 for r in slots], np.float32)
            top_ks = np.asarray([r.top_k if r else 0 for r in slots], np.int64)
            top_ps = np.asarray([r.top_p if r else 0.0 for r in slots], np.float32)
            if self.decode_chunk > 1:
                # the chunk is capped by the smallest remaining budget, so no
                # request overshoots its max_new on the card
                budget = min(r.max_new - r.produced for r in slots if r is not None)
                n = max(1, min(self.decode_chunk, budget))
                eos = np.asarray([r.eos_id if r else -1 for r in slots], np.int64)
                toks, emitted, _ = self.engine.decode_steps(
                    feed, active, n_steps=n, temperature=temps, seed=step, top_k=top_ks,
                    top_p=top_ps, eos_id=eos)
                step += n
                for i in range(n):
                    for s, req in enumerate(slots):
                        if req is None or not emitted[i, s]:
                            continue
                        feed[s] = toks[i, s]
                        self._emit(slots, feed, s)
                continue
            nxt = self.engine.decode_step(feed, active, temps, seed=step, top_k=top_ks,
                                          top_p=top_ps)
            step += 1
            for s, req in enumerate(slots):
                if req is not None:
                    feed[s] = nxt[s]
                    self._emit(slots, feed, s)

    def _emit(self, slots, feed, s) -> None:
        """Push slot s's latest token; retire it at its eos, its budget or
        the end of the cache (openai_server.py:296)."""
        req = slots[s]
        tok = int(feed[s])
        done = (tok == req.eos_id or req.produced + 1 >= req.max_new
                or self.engine.cur_len[s] + 1 >= self.max_len)
        if tok != req.eos_id:
            req.tokens.put(tok)
            req.produced += 1
        if done:
            req.tokens.put(_END)
            slots[s] = None
            feed[s] = 0
            self.engine.free_slot(s)

    # -- client API -------------------------------------------------------------
    def submit_stream(self, prompt: str, sampling: SamplingParams) -> "queue.Queue":
        """Queue a request; its tokens arrive on the returned queue, then the
        end sentinel."""
        if self._error is not None:
            raise RuntimeError("the LLMServer worker failed") from self._error
        ids = self.tokenizer.text_to_ids(prompt)
        req = _StreamRequest(ids, sampling.max_new_tokens, sampling.eos_id,
                             0.0 if sampling.greedy else sampling.temperature,
                             top_k=0 if sampling.greedy else sampling.top_k,
                             top_p=0.0 if sampling.greedy else sampling.top_p)
        self._queue.put(req)
        return req.tokens

    def submit(self, prompt: str, sampling: SamplingParams) -> str:
        q = self.submit_stream(prompt, sampling)
        out = []
        while True:
            t = q.get()
            if t is _END:
                break
            out.append(t)
        if self._error is not None:
            raise RuntimeError("the LLMServer worker failed") from self._error
        return self.tokenizer.ids_to_text(out)

    @torch.no_grad()
    def score(self, prompt: str):
        """Prompt-token logprobs (openai_server.py:331): the prompt padded to
        a power of two (at least 8) through one forward with no cache;
        returns (ids, [None] + the log-probability of each later token)."""
        ids = self.tokenizer.text_to_ids(prompt)
        if not ids:
            return [], []
        S = max(8, int(2 ** np.ceil(np.log2(len(ids)))))
        toks = torch.zeros(1, S, dtype=torch.long)
        toks[0, :len(ids)] = torch.tensor(ids)
        model = self.engine.model
        logits = model(toks.to(self.engine.device))[0, :len(ids) - 1]
        lp = torch.log_softmax(logits, dim=-1)
        picked = lp.gather(-1, torch.tensor(ids[1:], device=lp.device)[:, None])[:, 0]
        return ids, [None] + picked.cpu().tolist()

    # -- HTTP frontend ----------------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              blocking: bool = True) -> ThreadingHTTPServer:
        """Start the worker and listen on (host, port); port 0 takes a free
        one, which `self.port` then holds."""
        self._worker.start()
        server = ThreadingHTTPServer((host, port), self._make_handler())
        self._http = server
        self.port = server.server_address[1]
        log.info("LLMServer listening on %s:%d", host, self.port)
        if blocking:
            server.serve_forever()
        else:
            self._http_thread = threading.Thread(target=server.serve_forever, daemon=True)
            self._http_thread.start()
        return server

    def shutdown(self, timeout: float = 60.0) -> None:
        """Stop the worker and the HTTP server and wait for their threads."""
        self._stop.set()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        for t in (self._worker, self._http_thread):
            if t is not None and t.is_alive():
                t.join(timeout)

    def _make_handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _json(self, code: int, payload: Dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/v1/models":
                    self._json(200, {"object": "list", "data": [
                        {"id": outer.model_name, "object": "model"}]})
                elif self.path == "/health":
                    self._json(200, {"status": "ok"})
                else:
                    self._json(404, {"error": "not found"})

            def _sse(self, rid: str, obj: str, token_q, chat: bool):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                while True:
                    t = token_q.get()
                    if t is _END:
                        break
                    piece = outer.tokenizer.ids_to_text([t])
                    if chat:
                        delta = {"choices": [{"index": 0, "delta": {"content": piece}}]}
                    else:
                        delta = {"choices": [{"index": 0, "text": piece}]}
                    delta.update(id=rid, object=obj, model=outer.model_name)
                    self.wfile.write(f"data: {json.dumps(delta)}\n\n".encode())
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, UnicodeDecodeError):
                    return self._json(400, {"error": {"message": "invalid JSON body"}})

                chat = self.path == "/v1/chat/completions"
                if self.path == "/v1/completions":
                    prompt = req.get("prompt", "")
                    if isinstance(prompt, list):
                        prompt = prompt[0] if prompt else ""
                elif chat:
                    messages = req.get("messages", [])
                    if any(isinstance(m.get("content"), list) for m in messages):
                        return self._json(501, {"error": {
                            "message": "content parts (images) are not served: the VLM "
                                       "sidecar is not ported"}})
                    prompt = format_chat(messages, outer.chat_template)
                else:
                    return self._json(404, {"error": "not found"})

                rid = f"cmpl-{uuid.uuid4().hex[:12]}"
                if not chat and req.get("logprobs") and int(req.get("max_tokens", 64)) == 0:
                    ids, token_lp = outer.score(prompt)
                    return self._json(200, {
                        "id": rid, "object": "text_completion", "model": outer.model_name,
                        "choices": [{"index": 0, "text": prompt if req.get("echo") else "",
                                     "finish_reason": "length",
                                     "logprobs": {"token_logprobs": token_lp,
                                                  "tokens": ids}}],
                    })
                sampling = SamplingParams(
                    greedy=not req.get("temperature"),
                    temperature=float(req.get("temperature") or 1.0),
                    top_p=float(req.get("top_p") or 0.0),
                    top_k=int(req.get("top_k") or 0),
                    max_new_tokens=int(req.get("max_tokens", 64)),
                )
                if req.get("stream"):
                    q = outer.submit_stream(prompt, sampling)
                    obj = "chat.completion.chunk" if chat else "text_completion"
                    return self._sse(rid, obj, q, chat)
                text = outer.submit(prompt, sampling)
                if chat:
                    self._json(200, {
                        "id": rid, "object": "chat.completion", "model": outer.model_name,
                        "choices": [{"index": 0,
                                     "message": {"role": "assistant", "content": text},
                                     "finish_reason": "length"}],
                    })
                else:
                    self._json(200, {
                        "id": rid, "object": "text_completion", "model": outer.model_name,
                        "choices": [{"index": 0, "text": text, "finish_reason": "length"}],
                    })

        return Handler
