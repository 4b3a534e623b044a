"""The port's HTTP server (kubedl_tpu_torch/train/serve.py) on the CPU, as
tests/test_serve_http.py holds the JAX server: GET /metrics against
stats(); SSE streaming of token ids (one event a token, then the final
event; the stream equals the plain answer, never leaks a partial stop
match, and a disconnect frees the slot); multi-LoRA over HTTP (POST
/adapter, per-request adapter_id, 422s) with the adapted tokens equal to
JAX's decode on JAX's merged weights; and serve --adapter CKPT[:ALPHA] at
startup, a bad path exiting 1."""
import json
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import decode as jdecode
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models import lora as jlora
from kubedl_tpu_torch.models import decode, llama, lora
from kubedl_tpu_torch.models.serving import ServingEngine
from kubedl_tpu_torch.parallel.train_step import TrainState
from kubedl_tpu_torch.train import checkpoint, serve
from kubedl_tpu_torch.train.serve import _Handler, _Service
from kubedl_tpu_torch.utils.convert import params_from_numpy


def _start(engine, decode_block=8):
    svc = _Service(engine, decode_block=decode_block)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    httpd.daemon_threads = True
    httpd.svc = svc
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", svc, httpd, t


def _stop(svc, httpd, t):
    httpd.shutdown()
    t.join(timeout=30)
    httpd.server_close()
    svc.stop()


@pytest.fixture(scope="module")
def server():
    """Fresh tiny weights (seed 0) on 3 slots, one tick a pump pass."""
    cfg = llama.LlamaConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    base, svc, httpd, t = _start(ServingEngine(params, cfg, slots=3, max_len=64),
                                 decode_block=1)
    yield base, svc
    _stop(svc, httpd, t)


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _stream(base, body):
    """(content type, the parsed data events) of a stream: true request."""
    req = urllib.request.Request(f"{base}/generate",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        ctype = r.headers["Content-Type"]
        for raw in r:
            raw = raw.strip()
            if raw.startswith(b"data: "):
                events.append(json.loads(raw[len(b"data: "):]))
    return ctype, events


def test_prometheus_metrics_endpoint(server):
    base, svc = server
    _post(f"{base}/generate", {"tokens": [3, 4], "max_new_tokens": 2})
    body = urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
    with urllib.request.urlopen(f"{base}/stats", timeout=10) as r:
        stats = json.loads(r.read())
    assert "# TYPE kubedl_serving_tokens_out gauge" in body
    lines = dict(line.split(" ", 1) for line in body.splitlines() if not line.startswith("#"))
    numeric = {k for k, v in stats.items() if isinstance(v, (int, float))}
    assert set(lines) == {f"kubedl_serving_{k}" for k in numeric}
    for key in ("slots", "admitted", "tokens_out", "ticks", "adapters_registered",
                "prefixes_registered", "prefill_batches"):
        assert float(lines[f"kubedl_serving_{key}"]) == float(stats[key]), key
    assert float(lines["kubedl_serving_tokens_out"]) >= 2
    assert float(lines["kubedl_serving_slots"]) == 3


def test_streaming_sse(server):
    """One data event a token as generated, then the final event; the
    tokens equal the plain answer's; logprobs ride each event when asked;
    the batch form is refused."""
    base, _ = server
    prompt = [2, 7, 1]
    plain = _post(f"{base}/generate", {"tokens": prompt, "max_new_tokens": 5,
                                       "logprobs": True})
    ctype, events = _stream(base, {"tokens": prompt, "max_new_tokens": 5, "logprobs": True})
    assert ctype.startswith("text/event-stream")
    assert len(events) == 6  # 5 token events + final
    assert [e["token"] for e in events[:5]] == plain["tokens"]
    assert [e["logprob"] for e in events[:5]] == plain["logprobs"]
    final = events[-1]
    assert final["done"] and final["tokens"] == plain["tokens"]
    assert final["logprobs"] == plain["logprobs"] and "error" not in final
    assert len({e["request_id"] for e in events}) == 1
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(f"{base}/generate", {"stream": True,
                                   "requests": [{"tokens": prompt, "max_new_tokens": 2}]})
    assert exc.value.code == 422
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(f"{base}/generate", {"tokens": prompt, "stream": "yes"})
    assert exc.value.code == 422


def test_streaming_with_stop_never_leaks_partial_match(server):
    base, _ = server
    full = _post(f"{base}/generate", {"tokens": [2, 7, 1], "max_new_tokens": 8})
    stop = full["tokens"][3:5]
    _, events = _stream(base, {"tokens": [2, 7, 1], "max_new_tokens": 8, "stop": [stop]})
    final = events[-1]
    assert final["done"] and final["tokens"] == full["tokens"][:3]
    assert [e["token"] for e in events[:-1]] == final["tokens"]


def test_a_dropped_stream_frees_its_slot(server):
    """The client reads one event and hangs up: the handler cancels the
    request and the engine drains."""
    base, svc = server
    host, port = base.rsplit(":", 1)[0][len("http://"):], int(base.rsplit(":", 1)[1])
    body = json.dumps({"tokens": [5, 6, 7], "max_new_tokens": 60, "stream": True}).encode()
    with socket.create_connection((host, port), timeout=60) as s:
        s.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        got = b""
        while b"data: " not in got:
            got += s.recv(4096)
    deadline = time.monotonic() + 60
    while svc.engine.has_pending() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not svc.engine.has_pending()
    assert svc.engine.stats()["tokens_out"] < 1000


def _jax_adapter(jp, seed, targets):
    ad = jlora.lora_init(jax.random.PRNGKey(1), jp, rank=4, targets=targets)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape) * 0.1, jnp.float32), ad)


def _save(path, adapters):
    """An adapter checkpoint as the trainer's --lora-rank run writes one."""
    checkpoint.CheckpointManager(path).save(1, TrainState(params=adapters, opt_state={},
                                                          step=1))


def test_multi_lora_over_http(tmp_path):
    """POST /adapter registers a checkpoint; adapter_id selects it; the
    adapted answer is JAX's greedy decode on JAX's merged weights; base
    traffic is untouched; unknown ids and bad paths are 422."""
    jcfg = jllama.LlamaConfig.tiny(use_flash=False, dtype=jnp.float32)
    jp = jllama.init(jcfg, jax.random.PRNGKey(0))
    ad = _jax_adapter(jp, 5, ("wq", "wv"))
    ckpt = str(tmp_path / "adapters")
    _save(ckpt, params_from_numpy(jax.device_get(ad)))
    tcfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    tp = params_from_numpy(jax.device_get(jp))
    base, svc, httpd, t = _start(ServingEngine(tp, tcfg, slots=2, max_len=64))
    try:
        assert _post(f"{base}/adapter", {"checkpoint_path": ckpt}) == {"adapter_id": 1}
        prompt = [3, 1, 4, 1, 5]
        plain = _post(f"{base}/generate", {"tokens": prompt, "max_new_tokens": 4})
        adapted = _post(f"{base}/generate", {"tokens": prompt, "max_new_tokens": 4,
                                             "adapter_id": 1})
        ref = jax.device_get(jdecode.generate(jlora.merge(jp, ad), jnp.asarray(prompt)[None],
                                              jcfg, max_new_tokens=4, max_len=9))
        assert adapted["tokens"] == [int(x) for x in ref[0]]
        assert plain["tokens"] != adapted["tokens"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"{base}/generate", {"tokens": prompt, "max_new_tokens": 2, "adapter_id": 9})
        assert exc.value.code == 422
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"{base}/adapter", {"checkpoint_path": str(tmp_path / "x")})
        assert exc.value.code == 422
        assert "no adapter checkpoint" in json.loads(exc.value.read())["error"]
    finally:
        _stop(svc, httpd, t)


def test_startup_adapter_flag(tmp_path, capsys):
    """--adapter CKPT:8 registers before the server opens (the answer is
    the merged model's at alpha 8); a bad path is a fatal startup error."""
    cfg = llama.LlamaConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ad = lora.lora_init(torch.Generator().manual_seed(1), params, rank=4, targets=("wq",))
    for entry in ad["layers"]:
        entry["wq"]["b"] = torch.randn(entry["wq"]["b"].shape,
                                       generator=torch.Generator().manual_seed(3)) * 0.1
    ckpt = str(tmp_path / "ad")
    _save(ckpt, ad)
    args = serve.parse_args(["--device", "cpu", "--port", "0", "--bind", "127.0.0.1",
                             "--slots", "2", "--max-len", "32", "--adapter", f"{ckpt}:8"])
    httpd, svc = serve.build_server(args)
    assert f"adapter 1: {ckpt} (alpha=8.0)" in capsys.readouterr().out
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        out = _post(f"http://127.0.0.1:{httpd.server_address[1]}/generate",
                    {"tokens": [1, 2], "max_new_tokens": 3, "adapter_id": 1})
    finally:
        _stop(svc, httpd, t)
    want = decode.generate(lora.merge(params, ad, alpha=8.0),
                           torch.tensor([[1, 2]], dtype=torch.int32), cfg, 3)[0].tolist()
    assert out["tokens"] == want
    missing = str(tmp_path / "missing")
    assert serve.main(["--device", "cpu", "--slots", "2", "--max-len", "32", "--adapter",
                       missing, "--bind", "127.0.0.1", "--port", "0"]) == 1
    assert f"error: --adapter {missing!r}: no adapter checkpoint under" in \
        capsys.readouterr().err
