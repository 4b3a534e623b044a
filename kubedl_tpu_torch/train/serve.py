"""HTTP serving workload over the continuous-batching engine
(kubedl_tpu/train/serve.py), on PyTorch:

    POST /generate   {"tokens": [..], "max_new_tokens": 32, "eos_token": 2?,
                      "temperature"?, "top_k"?, "top_p"?, "logprobs"?,
                      "stop"?: [[ids], ...], "prefix_id"?}  -> {"tokens": [...]}
    POST /generate   {"requests": [{...}, ...]}  (batch form; each entry
                      rides its own engine slot)  -> {"results": [...]}
    POST /prefix     {"tokens": [...]}  -> {"prefix_id": N}  (a shared
                      system prompt, prefilled once; register_prefix)
    GET  /stats      -> ServingEngine.stats()
    GET  /healthz    -> {"ok": true}

One background thread drives the engine whenever work is pending; handlers
only enqueue and wait, so concurrent clients batch onto the same decode
ticks. Run it with

    python -m kubedl_tpu_torch.train.serve --model llama-7b --checkpoint-path DIR

It serves the newest params the port's trainer saved under
--checkpoint-path (train/generate.py restore_params), or fresh ones with
--allow-fresh-init. It runs on the card unless --device cpu is given;
--int8 serves the weight-only int8 tree (models/quant.py), --kv-int8 keeps
the KV cache in int8 codes with bf16 scales (models/decode.py).
--draft-model with --draft-checkpoint-path turns on speculative serving
(--spec-k drafts a round); a draft without weights exits 1 unless
--allow-fresh-init is given. The server is one process on one device, as
the reference's is. Text prompts (they need a tokenizer), streaming,
adapters, --hf-model and --draft-hf-model are not ported yet and are
refused.
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
    p.add_argument("--hf-model", default=os.environ.get("KUBEDL_HF_MODEL", ""))
    p.add_argument("--allow-fresh-init", action="store_true")
    p.add_argument("--lora-checkpoint-path", default="")
    p.add_argument("--lora-alpha", type=float, default=None)
    p.add_argument("--adapter", action="append", default=[], metavar="CKPT[:ALPHA]")
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
    p.add_argument("--draft-hf-model", default="")
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop after N pump passes (smoke tests); 0 = forever")
    p.add_argument("--decode-block", type=int, default=8,
                   help="max ticks fused per host sync (ServingEngine.step_block)")
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


_UNPORTED_FLAGS = (
    ("lora_checkpoint_path", "--lora-checkpoint-path"),
    ("adapter", "--adapter"),
    ("draft_hf_model", "--draft-hf-model"),
)


class _Service:
    """Engine + queue pump shared by all HTTP handler threads."""

    def __init__(self, engine, decode_block: int = 8) -> None:
        self.engine = engine
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
               top_k: int = 0, top_p: float = 1.0, logprobs: bool = False, stop=None):
        with self._lock:
            req = self.engine.submit(prompt, max_new_tokens, eos_token,
                                     prefix_id=prefix_id, temperature=temperature,
                                     top_k=top_k, top_p=top_p, logprobs=logprobs,
                                     stop=stop)
        self._work.set()
        return req

    def register_prefix(self, tokens) -> int:
        # not under the service lock: the prefill must not stall the pump;
        # the engine's own lock guards its registry
        return self.engine.register_prefix(tokens)

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


def _parse_stop(value):
    """"stop" field -> list of token-id sequences (id lists only: string
    stops need a tokenizer, which is not ported yet)."""
    if value is None:
        return None
    if not isinstance(value, list) or not all(isinstance(s, list) for s in value):
        raise ValueError("stop must be a list of token-id lists (string stop "
                         "sequences need a tokenizer, not ported yet)")
    return [[int(t) for t in s] for s in value]


def _parse_bool(value, field: str) -> bool:
    if value is None:
        return False
    if isinstance(value, bool):
        return value
    raise ValueError(f"{field} must be a JSON boolean, got {value!r}")


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

    def do_GET(self) -> None:  # noqa: N802
        if self.path == "/healthz":
            return self._send(200, {"ok": True})
        if self.path == "/stats":
            stats = self.svc.engine.stats()
            stats["ticks"] = self.svc.ticks
            return self._send(200, stats)
        self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        if self.path not in ("/generate", "/prefix"):
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
        entries = body.get("requests")
        single = entries is None
        if single:
            entries = [body]
        reqs = []
        try:
            if _parse_bool(body.get("stream"), "stream"):
                raise ValueError("streaming is not ported to kubedl_tpu_torch yet")
            for e in entries:
                if not isinstance(e, dict):
                    raise ValueError("each request must be a JSON object")
                for key in ("text", "messages"):
                    if e.get(key) is not None:
                        raise ValueError(f"{key!r} prompts need a tokenizer, "
                                         f"not ported yet; send token ids")
                if e.get("adapter_id"):
                    raise ValueError("adapter_id is not ported to kubedl_tpu_torch yet")
                temp = e.get("temperature")
                top_k = e.get("top_k")
                top_p = e.get("top_p")
                reqs.append(self.svc.submit(
                    e.get("tokens") or [],
                    int(e.get("max_new_tokens") or 32),
                    e.get("eos_token"),
                    prefix_id=e.get("prefix_id"),
                    temperature=None if temp is None else float(temp),
                    top_k=0 if top_k is None else int(top_k),
                    top_p=1.0 if top_p is None else float(top_p),
                    logprobs=_parse_bool(e.get("logprobs"), "logprobs"),
                    stop=_parse_stop(e.get("stop")),
                ))
        except (ValueError, TypeError) as e:
            # partially-submitted batch: release what already went in
            self.svc.cancel(reqs)
            return self._send(422, {"error": str(e)})
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
            results.append(entry)
        self._send(200, results[0] if single else {"results": results})


def build_server(args):
    """Resolve weights, build the engine, bind the HTTP server: returns
    (httpd, service), or None when weights are missing (the error is
    printed). The caller runs ``httpd.serve_forever()`` and, when done,
    ``httpd.shutdown()``, ``httpd.server_close()`` and ``service.stop()``."""
    for attr, flag in _UNPORTED_FLAGS:
        if getattr(args, attr):
            raise NotImplementedError(f"{flag} is not yet ported to "
                                      f"kubedl_tpu_torch (ROADMAP.md)")
    from kubedl_tpu_torch.models.serving import ServingEngine
    from kubedl_tpu_torch.train.generate import resolve_params

    params, config = resolve_params(
        args.model, args.hf_model, args.checkpoint_path, args.allow_fresh_init,
        device=args.device)
    if params is None:
        return None
    if args.int8:
        from kubedl_tpu_torch.models import quant

        params = quant.quantize_params(params)
    draft_params = draft_config = None
    if args.draft_model or args.draft_checkpoint_path:
        if not args.draft_checkpoint_path:
            # a random draft floors acceptance: speculation would be
            # strictly slower than the plain engine
            if not args.allow_fresh_init:
                print("error: --draft-model needs weights (--draft-checkpoint-path); "
                      "pass --allow-fresh-init to force a random draft for tests",
                      file=sys.stderr)
                return None
            print("warning: random-init draft — speculation will be slower than "
                  "plain serving (test mode)", file=sys.stderr)
        draft_params, draft_config = resolve_params(
            args.draft_model or "tiny", "", args.draft_checkpoint_path,
            args.allow_fresh_init, label="draft", device=args.device)
        if draft_params is None:
            return None
    engine = ServingEngine(params, config, slots=args.slots,
                           max_len=args.max_len, temperature=args.temperature,
                           kv_dtype="int8" if args.kv_int8 else None,
                           draft_params=draft_params, draft_config=draft_config,
                           spec_k=args.spec_k)
    svc = _Service(engine, decode_block=args.decode_block)
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
    print(f"serving {args.model} on http://{host}:{port} "
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
