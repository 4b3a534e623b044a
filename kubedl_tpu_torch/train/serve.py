"""HTTP serving workload over the continuous-batching engine
(kubedl_tpu/train/serve.py), on PyTorch:

    POST /generate   {"tokens": [..], "max_new_tokens": 32, "eos_token": 2?,
                      "temperature"?, "top_k"?, "top_p"?, "logprobs"?,
                      "stop"?: [[ids], ...], "prefix_id"?, "adapter_id"?,
                      "stream"?}  -> {"tokens": [...]}
                     (with an --hf-model tokenizer, {"text": "..."} or
                      {"messages": [{"role", "content"}, ...]} in place of
                      "tokens", string stops, and a decoded "text" in the
                      answer)
    POST /generate   {"requests": [{...}, ...]}  (batch form; each entry
                      rides its own engine slot)  -> {"results": [...]}
    POST /prefix     {"tokens": [...]}  -> {"prefix_id": N}  (a shared
                      system prompt, prefilled once; register_prefix)
    POST /adapter    {"checkpoint_path": DIR, "alpha"?}  -> {"adapter_id": N}
                      (a trainer --lora-rank checkpoint; register_adapter)
    GET  /stats      -> ServingEngine.stats()
    GET  /metrics    -> Prometheus text (kubedl_serving_* gauges)
    GET  /healthz    -> {"ok": true}

"stream": true (single-request form only) answers with server-sent events:
one `data:` event a token as the engine emits it ({"token", "request_id",
"logprob"?, "text_delta"?}), then a final event with "done", "tokens",
"error"?, "logprobs"? and "text"?; tokens a stop sequence could still take
back are held until the request ends. With a tokenizer the text deltas
come from an incremental detokenizer and concatenate to the final text.
Serve with --decode-block 1 for one event a tick.

One background thread drives the engine whenever work is pending; handlers
only enqueue and wait, so concurrent clients batch onto the same decode
ticks. Run it with

    python -m kubedl_tpu_torch.train.serve --model llama-7b --checkpoint-path DIR

It serves the newest params the port's trainer saved under
--checkpoint-path (train/generate.py restore_params), a local Hugging Face
checkpoint directory with --hf-model (models/import_hf.py; its tokenizer,
when transformers imports, serves text), or fresh ones with
--allow-fresh-init. It runs on the card unless --device cpu is given;
--int8 serves the weight-only int8 tree (models/quant.py), --kv-int8 keeps
the KV cache in int8 codes with bf16 scales (models/decode.py).
--draft-model with --draft-checkpoint-path, or --draft-hf-model, turns on
speculative serving (--spec-k drafts a round; the draft must share the
target's vocabulary); a draft without weights exits 1 unless
--allow-fresh-init is given. --lora-checkpoint-path merges one adapter
checkpoint into the weights at startup; each --adapter CKPT[:ALPHA]
registers one for per-request selection (ids from 1; a failure exits 1).
The server is one process on one device, as the reference's is.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


def parse_args(argv=None):
    p = argparse.ArgumentParser("kubedl-serve-torch")
    p.add_argument("--model", default=os.environ.get("KUBEDL_MODEL", "tiny"),
                   choices=["tiny", "bench-150m", "bench-1b", "llama-7b"])
    p.add_argument("--checkpoint-path",
                   default=os.environ.get("KUBEDL_CHECKPOINT_PATH", ""))
    p.add_argument("--hf-model", default=os.environ.get("KUBEDL_HF_MODEL", ""),
                   help="local Hugging Face checkpoint dir; overrides --model/"
                        "--checkpoint-path (models/import_hf.py)")
    p.add_argument("--allow-fresh-init", action="store_true")
    p.add_argument("--lora-checkpoint-path", default="",
                   help="merge the newest adapter checkpoint from a trainer "
                        "--lora-rank run into the base weights")
    p.add_argument("--lora-alpha", type=float, default=None)
    p.add_argument("--adapter", action="append", default=[], metavar="CKPT[:ALPHA]",
                   help="register a LoRA adapter checkpoint at startup for "
                        "per-request selection (repeatable; ids from 1)")
    p.add_argument("--bind", default="0.0.0.0")
    p.add_argument("--port", type=int, default=int(os.environ.get("PORT", 8000)),
                   help="0 picks a free port (printed at start)")
    p.add_argument("--slots", type=int,
                   default=int(os.environ.get("KUBEDL_SERVING_SLOTS", 8)))
    p.add_argument("--max-len", type=int,
                   default=int(os.environ.get("KUBEDL_SERVING_MAX_LEN", 1024)))
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--kv-int8", action="store_true")
    p.add_argument("--draft-model", default="")
    p.add_argument("--draft-checkpoint-path", default="")
    p.add_argument("--draft-hf-model", default="",
                   help="local Hugging Face checkpoint dir of the draft (must "
                        "share the target's tokenizer)")
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop after N pump passes (smoke tests); 0 = forever")
    p.add_argument("--decode-block", type=int, default=8,
                   help="max ticks fused per host sync (ServingEngine.step_block)")
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


class _Service:
    """Engine + queue pump shared by all HTTP handler threads."""

    def __init__(self, engine, tokenizer=None, decode_block: int = 8) -> None:
        self.engine = engine
        self.tokenizer = tokenizer
        self.decode_block = max(int(decode_block), 1)
        self._lock = threading.Lock()  # engine calls are single-threaded
        self._work = threading.Event()
        self._stop = threading.Event()
        self.ticks = 0
        self._thread = threading.Thread(target=self._pump, name="serve-pump",
                                        daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        while not self._stop.is_set():
            if not self._work.wait(timeout=0.1):
                continue
            with self._lock:
                if not self.engine.has_pending():
                    self._work.clear()
                    continue
                try:
                    if self.decode_block > 1:
                        self.engine.step_block(self.decode_block)
                    else:
                        self.engine.step()
                except Exception as e:  # noqa: BLE001
                    # a step that throws must not kill the pump silently:
                    # fail the in-flight work loudly and keep serving
                    print(f"serve pump: engine step failed: "
                          f"{type(e).__name__}: {e}", flush=True)
                    for req in list(self.engine._queue) + [
                            r for r in self.engine._slot_req if r is not None]:
                        req.error = f"engine step failed: {e}"
                        self.engine.cancel(req)
                self.ticks += 1

    def submit(self, prompt, max_new_tokens: int, eos_token: Optional[int],
               prefix_id: Optional[int] = None, temperature: Optional[float] = None,
               top_k: int = 0, top_p: float = 1.0, logprobs: bool = False,
               adapter_id: int = 0, stop=None):
        with self._lock:
            req = self.engine.submit(prompt, max_new_tokens, eos_token,
                                     prefix_id=prefix_id, temperature=temperature,
                                     top_k=top_k, top_p=top_p, logprobs=logprobs,
                                     adapter_id=adapter_id, stop=stop)
        self._work.set()
        return req

    def register_adapter(self, checkpoint_path: str, alpha=None) -> int:
        """Load a trainer --lora-rank adapter checkpoint and register it for
        per-request selection. The restore runs outside the service lock;
        only the registry swap holds it."""
        from kubedl_tpu_torch.train.generate import restore_params

        adapters = restore_params(checkpoint_path, label="lora adapters",
                                  device=self.engine.device)
        if adapters is None:
            raise ValueError(f"no adapter checkpoint under {checkpoint_path!r}")
        with self._lock:
            return self.engine.register_adapter(adapters, alpha=alpha)

    def register_prefix(self, tokens) -> int:
        # not under the service lock: the prefill must not stall the pump;
        # the engine's own lock guards its registry
        return self.engine.register_prefix(tokens)

    def kick(self) -> None:
        """Nudge the pump (streaming handlers poll instead of wait())."""
        self._work.set()

    def wait(self, reqs, timeout: float = 300.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(r.done for r in reqs):
                return True
            self._work.set()
            time.sleep(0.005)
        return False

    def cancel(self, reqs) -> None:
        with self._lock:
            for r in reqs:
                self.engine.cancel(r)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)


def _parse_stop(value, tok):
    """"stop" field -> list of token-id sequences: one string, a list of
    strings (they need a tokenizer; encoded without special tokens) or a
    list of id lists. A string stop is encoded once and matched on tokens,
    so text that merges differently (leading-space variants) may contain
    it without a match; id lists give exact control."""
    if value is None:
        return None
    if isinstance(value, str):
        value = [value]
    if not isinstance(value, list):
        raise ValueError("stop must be a string or a list")
    out = []
    for s in value:
        if isinstance(s, str):
            if tok is None:
                raise ValueError("string stop sequences need a tokenizer "
                                 "— start the server with --hf-model, or "
                                 "pass token-id lists")
            out.append(tok.encode(s, add_special_tokens=False))
        elif isinstance(s, list):
            out.append([int(t) for t in s])
        else:
            raise ValueError("each stop entry must be a string or id list")
    return out


def _parse_bool(value, field: str) -> bool:
    if value is None:
        return False
    if isinstance(value, bool):
        return value
    raise ValueError(f"{field} must be a JSON boolean, got {value!r}")


class _StreamDecoder:
    """Incremental detokenization for SSE text deltas. Decoding every prefix
    anew is quadratic and wrong for a character split across tokens (it
    decodes to U+FFFD until its last byte arrives), so each push decodes a
    short window [prefix:read) against [prefix:], emits the extension once
    it no longer ends in a replacement character, and moves the window on.
    The deltas concatenate to the final text, but for a held-back tail that
    the final event's full decode supplies."""

    def __init__(self, tok) -> None:
        self.tok = tok
        self.toks: list = []
        self.prefix = 0  # window start
        self.read = 0    # tokens already in the emitted text

    def push(self, token: int) -> str:
        self.toks.append(token)
        prev = self.tok.decode(self.toks[self.prefix:self.read], skip_special_tokens=True)
        full = self.tok.decode(self.toks[self.prefix:], skip_special_tokens=True)
        if full.endswith("\ufffd"):
            return ""  # mid-character: hold until it completes
        if len(full) > len(prev) and full.startswith(prev):
            self.prefix = self.read
            self.read = len(self.toks)
            return full[len(prev):]
        return ""


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003 — quiet
        pass

    @property
    def svc(self) -> _Service:
        return self.server.svc  # type: ignore[attr-defined]

    def _send(self, status: int, body: dict) -> None:
        payload = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _stats(self) -> dict:
        stats = self.svc.engine.stats()
        stats["ticks"] = self.svc.ticks
        return stats

    def do_GET(self) -> None:  # noqa: N802
        if self.path == "/healthz":
            return self._send(200, {"ok": True})
        if self.path == "/stats":
            return self._send(200, self._stats())
        if self.path == "/metrics":
            # Prometheus text format: every numeric stat as a
            # kubedl_serving_<key> gauge
            lines = []
            for key, val in sorted(self._stats().items()):
                if not isinstance(val, (int, float)):
                    continue
                name = f"kubedl_serving_{key}"
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {float(val)}")
            payload = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
            return
        self._send(404, {"error": f"unknown path {self.path}"})

    def _event(self, body: dict) -> None:
        self.wfile.write(b"data: " + json.dumps(body).encode() + b"\n\n")

    def _stream_response(self, req, timeout: float = 300.0) -> None:
        """Server-sent events: one `data:` event a token as the engine emits
        it, then a final event. Any exit before the request finishes (a
        disconnect, a socket error, the deadline) cancels it, so an
        abandoned stream frees its slot."""
        tok = self.svc.tokenizer
        dec = _StreamDecoder(tok) if tok is not None else None
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        # no Content-Length: the stream ends at EOF, so the connection closes
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        sent = 0
        # a stop sequence deletes its match from the tail when it completes,
        # so tokens within the longest stop's reach are held until the
        # request ends: the stream never shows what the final answer drops
        margin = max((len(s) for s in req.stop_sequences), default=0)
        deadline = time.monotonic() + timeout
        try:
            while True:
                done = req.done  # read before draining: no lost wake-up
                toks = list(req.tokens)
                lps = list(req.token_logprobs)
                limit = len(toks) if done else max(len(toks) - margin, 0)
                while sent < limit:
                    event = {"token": toks[sent], "request_id": req.request_id}
                    if req.logprobs and sent < len(lps):
                        event["logprob"] = lps[sent]
                    if dec is not None:
                        event["text_delta"] = dec.push(toks[sent])
                    self._event(event)
                    sent += 1
                self.wfile.flush()
                if done:
                    final = {"done": True, "tokens": toks, "request_id": req.request_id}
                    if req.error:
                        final["error"] = req.error
                    if req.logprobs:
                        final["logprobs"] = list(req.token_logprobs)
                    if tok is not None:
                        # a full decode: what the deltas held back for an
                        # incomplete character lands here
                        final["text"] = tok.decode(toks, skip_special_tokens=True)
                    self._event(final)
                    self.wfile.flush()
                    return
                if time.monotonic() > deadline:
                    self._event({"error": "generation timed out",
                                 "request_id": req.request_id})
                    self.wfile.flush()
                    return
                self.svc.kick()
                time.sleep(0.005)
        except (BrokenPipeError, ConnectionResetError):
            pass  # the finally clause frees the slot
        finally:
            if not req.done:
                self.svc.cancel([req])

    def do_POST(self) -> None:  # noqa: N802
        if self.path not in ("/generate", "/prefix", "/adapter"):
            return self._send(404, {"error": f"unknown path {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", "0") or "0")
            body = json.loads(self.rfile.read(length))
        except (json.JSONDecodeError, ValueError) as e:
            return self._send(400, {"error": f"bad JSON: {e}"})
        if not isinstance(body, dict):
            return self._send(400, {"error": "body must be a JSON object"})
        if self.path == "/prefix":
            try:
                pid = self.svc.register_prefix(body.get("tokens") or [])
            except (ValueError, TypeError, NotImplementedError) as e:
                return self._send(422, {"error": str(e)})
            return self._send(200, {"prefix_id": pid})
        if self.path == "/adapter":
            alpha = body.get("alpha")
            try:
                aid = self.svc.register_adapter(str(body.get("checkpoint_path") or ""),
                                                alpha=None if alpha is None else float(alpha))
            except (ValueError, TypeError, NotImplementedError) as e:
                return self._send(422, {"error": str(e)})
            return self._send(200, {"adapter_id": aid})
        try:
            stream = _parse_bool(body.get("stream"), "stream")
        except ValueError as e:
            return self._send(422, {"error": str(e)})
        entries = body.get("requests")
        single = entries is None
        if single:
            entries = [body]
        if stream and not single:
            return self._send(422, {"error": "stream only supports the "
                                             "single-request form"})
        tok = self.svc.tokenizer
        reqs = []
        try:
            for e in entries:
                if not isinstance(e, dict):
                    raise ValueError("each request must be a JSON object")
                tokens, is_text = _prompt_tokens(e, tok)
                # the eos default applies to text requests only (a natural
                # stop); the token-id API keeps exact-length answers, and an
                # explicit "eos_token": null opts text requests out too
                if "eos_token" in e:
                    eos = e["eos_token"]
                elif is_text:  # a text prompt came through the tokenizer
                    eos = tok.eos_token_id
                else:
                    eos = None
                temp = e.get("temperature")
                top_k = e.get("top_k")
                top_p = e.get("top_p")
                reqs.append(self.svc.submit(
                    tokens or [],
                    int(e.get("max_new_tokens") or 32),
                    eos,
                    prefix_id=e.get("prefix_id"),
                    temperature=None if temp is None else float(temp),
                    top_k=0 if top_k is None else int(top_k),
                    top_p=1.0 if top_p is None else float(top_p),
                    logprobs=_parse_bool(e.get("logprobs"), "logprobs"),
                    adapter_id=int(e.get("adapter_id") or 0),
                    stop=_parse_stop(e.get("stop"), tok),
                ))
        except (ValueError, TypeError) as e:
            # partially-submitted batch: release what already went in
            self.svc.cancel(reqs)
            return self._send(422, {"error": str(e)})
        if stream:
            return self._stream_response(reqs[0])
        if not self.svc.wait(reqs):
            self.svc.cancel(reqs)
            return self._send(504, {"error": "generation timed out"})
        results = []
        for r in reqs:
            entry = {"tokens": r.tokens, "request_id": r.request_id}
            if r.error:
                entry["error"] = r.error
            if r.logprobs:
                entry["logprobs"] = r.token_logprobs
            if tok is not None:
                entry["text"] = tok.decode(r.tokens, skip_special_tokens=True)
            results.append(entry)
        self._send(200, results[0] if single else {"results": results})


def _prompt_tokens(e: dict, tok):
    """(prompt ids, whether the prompt is text) of one request: exactly one
    of "tokens", "text" (encoded with the tokenizer's special tokens) and
    "messages" (rendered by the tokenizer's chat template with the
    generation prompt)."""
    provided = [k for k in ("tokens", "text", "messages") if e.get(k) is not None]
    if len(provided) > 1:
        raise ValueError(f"pass exactly one of tokens / text / messages, "
                         f"got {'+'.join(provided)}")
    msgs = e.get("messages")
    if msgs is not None:
        if tok is None:
            raise ValueError("messages need a tokenizer — start the server with --hf-model")
        if not (isinstance(msgs, list) and msgs and all(
                isinstance(m, dict) and "role" in m and "content" in m for m in msgs)):
            raise ValueError("messages must be a non-empty list of {role, content} objects")
        try:
            # return_dict=False: ids, whichever default the installed
            # transformers has
            return tok.apply_chat_template(msgs, add_generation_prompt=True, tokenize=True,
                                           return_dict=False), True
        except Exception as exc:
            # a template's own raise_exception (jinja's TemplateError) is no
            # ValueError: rewrapped, it takes the 422 path and the batch's
            # partial submits are cancelled
            raise ValueError(f"chat template failed: {exc}") from exc
    if e.get("text") is not None:
        if tok is None:
            raise ValueError("text requests need a tokenizer — start the server "
                             "with --hf-model")
        return tok.encode(str(e["text"])), True
    return e.get("tokens"), False


def build_server(args):
    """Resolve weights, build the engine, register the --adapter
    checkpoints, bind the HTTP server: returns (httpd, service), or None
    when weights or adapters are missing (the error is printed). The caller
    runs ``httpd.serve_forever()`` and, when done, ``httpd.shutdown()``,
    ``httpd.server_close()`` and ``service.stop()``."""
    from kubedl_tpu_torch.models.serving import ServingEngine
    from kubedl_tpu_torch.train.generate import load_tokenizer, resolve_params

    try:
        params, config = resolve_params(
            args.model, args.hf_model, args.checkpoint_path, args.allow_fresh_init,
            lora_checkpoint_path=args.lora_checkpoint_path, lora_alpha=args.lora_alpha,
            device=args.device)
    except ValueError as e:  # --lora-checkpoint-path holds no adapters
        print(f"error: {e}", file=sys.stderr)
        return None
    if params is None:
        return None
    tokenizer = load_tokenizer(args.hf_model)
    if args.int8:
        from kubedl_tpu_torch.models import quant

        params = quant.quantize_params(params)
    draft_params = draft_config = None
    if args.draft_model or args.draft_hf_model or args.draft_checkpoint_path:
        if not (args.draft_hf_model or args.draft_checkpoint_path):
            # a random draft floors acceptance: speculation would be
            # strictly slower than the plain engine
            if not args.allow_fresh_init:
                print("error: --draft-model needs weights (--draft-checkpoint-path "
                      "or --draft-hf-model); pass --allow-fresh-init to force a "
                      "random draft for tests", file=sys.stderr)
                return None
            print("warning: random-init draft — speculation will be slower than "
                  "plain serving (test mode)", file=sys.stderr)
        draft_params, draft_config = resolve_params(
            args.draft_model or "tiny", args.draft_hf_model, args.draft_checkpoint_path,
            args.allow_fresh_init, label="draft", device=args.device)
        if draft_params is None:
            return None
    engine = ServingEngine(params, config, slots=args.slots,
                           max_len=args.max_len, temperature=args.temperature,
                           kv_dtype="int8" if args.kv_int8 else None,
                           draft_params=draft_params, draft_config=draft_config,
                           spec_k=args.spec_k)
    svc = _Service(engine, tokenizer=tokenizer, decode_block=args.decode_block)
    for spec in args.adapter:
        # CKPT[:ALPHA]; a failure is fatal: a deployment that dropped an
        # adapter would 422 every request naming it
        path, _, alpha_s = spec.rpartition(":")
        if path and alpha_s.replace(".", "", 1).isdigit():
            alpha = float(alpha_s)
        else:
            path, alpha = spec, None
        try:
            aid = svc.register_adapter(path, alpha=alpha)
        except ValueError as e:
            print(f"error: --adapter {spec!r}: {e}", file=sys.stderr)
            svc.stop()
            return None
        print(f"adapter {aid}: {path} (alpha={alpha})", flush=True)
    httpd = ThreadingHTTPServer((args.bind, args.port), _Handler)
    httpd.daemon_threads = True
    httpd.svc = svc  # type: ignore[attr-defined]
    return httpd, svc


def main(argv=None) -> int:
    args = parse_args(argv)
    built = build_server(args)
    if built is None:
        return 1
    httpd, svc = built
    host, port = httpd.server_address[:2]
    print(f"serving {args.hf_model or args.model} on http://{host}:{port} "
          f"(device={svc.engine.device}, slots={args.slots}, "
          f"max_len={args.max_len})", flush=True)
    try:
        if args.max_steps:
            # smoke mode: serve in the background until N pump passes
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
            while svc.ticks < args.max_steps:
                time.sleep(0.05)
            httpd.shutdown()
            t.join(timeout=30)
        else:
            httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        svc.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
