"""The tokenizer paths of the port's HTTP server (kubedl_tpu_torch/train/
serve.py) against the JAX server's handler, each on its own engine over the
same tiny Gemma-2 directory (f32) and the same in-process word-level
tokenizer saved beside it: "text" and "messages" prompts, the eos default
of text requests, string stops and the decoded "text" of each answer
equal the JAX server's; SSE "text_delta"s concatenate to the final text
and equal JAX's events; the errors of a server without a tokenizer are
JAX's word for word. Then `serve --hf-model DIR` itself: its tokens equal
`generate --hf-model DIR`'s path, --draft-hf-model speculates with the
same answer, a draft of another vocabulary is refused."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import pytest
import torch

transformers = pytest.importorskip("transformers")

from kubedl_tpu.models import import_hf as jimport
from kubedl_tpu.models.serving import ServingEngine as JEngine
from kubedl_tpu.train import generate as jgenerate
from kubedl_tpu.train import serve as jserve
from kubedl_tpu_torch.models import decode, import_hf
from kubedl_tpu_torch.models.serving import ServingEngine
from kubedl_tpu_torch.train import generate, serve
from hf_dirs import GEMMA2, save_hf, save_word_tokenizer


def _start(module, engine, tok):
    svc = module._Service(engine, tokenizer=tok, decode_block=4)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), module._Handler)
    httpd.daemon_threads = True
    httpd.svc = svc
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", (svc, httpd, t)


def _stop(svc, httpd, t):
    httpd.shutdown()
    t.join(timeout=30)
    httpd.server_close()
    svc.stop()


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gemma2-tok"))
    save_hf(path, *GEMMA2, seed=3)
    save_word_tokenizer(path, GEMMA2[1]["vocab_size"])
    return path


@pytest.fixture(scope="module")
def servers(hf_dir):
    """(JAX base url, port base url, JAX service, port service): one engine
    each, f32."""
    jp, jc = jimport.load_hf(hf_dir, config_overrides={"dtype": jnp.float32,
                                                       "use_flash": False})
    tp, tc = import_hf.load_hf(hf_dir, {"dtype": torch.float32}, device="cpu")
    jbase, jrun = _start(jserve, JEngine(jp, jc, slots=4, max_len=64),
                         jgenerate.load_tokenizer(hf_dir))
    tbase, trun = _start(serve, ServingEngine(tp, tc, slots=4, max_len=64),
                         generate.load_tokenizer(hf_dir))
    yield jbase, tbase, jrun[0], trun[0]
    _stop(*jrun)
    _stop(*trun)


def _post(base, body, timeout=300):
    req = urllib.request.Request(f"{base}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stream(base, body):
    req = urllib.request.Request(f"{base}/generate",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return [json.loads(raw.strip()[len(b"data: "):]) for raw in r
                if raw.strip().startswith(b"data: ")]


def _strip(answer):
    return {k: v for k, v in answer.items() if k != "request_id"}


REQUESTS = [
    {"text": "w25 w26 w27 w28", "max_new_tokens": 8},
    {"messages": [{"role": "system", "content": "w29"},
                  {"role": "user", "content": "w10 w11"}], "max_new_tokens": 8},
    {"text": "w12 w13", "max_new_tokens": 8, "eos_token": None},
    {"tokens": [1, 20, 21, 22], "max_new_tokens": 8},
]


def test_text_messages_stops_and_text_equal_jax(servers, hf_dir):
    """One batch of text, messages, text without the eos default and ids:
    tokens and "text" equal the JAX server's. Then a word of those answers
    as a string stop (and a list of one string and one id list): the
    answers cut there, equal to JAX's."""
    jbase, tbase, _, _ = servers
    js, jans = _post(jbase, {"requests": REQUESTS})
    ts, tans = _post(tbase, {"requests": REQUESTS})
    assert js == ts == 200
    assert [_strip(a) for a in tans["results"]] == [_strip(a) for a in jans["results"]]
    tok = transformers.AutoTokenizer.from_pretrained(hf_dir)
    for req, ans in zip(REQUESTS, tans["results"]):
        assert ans["text"] == tok.decode(ans["tokens"], skip_special_tokens=True)
        assert ans["tokens"]
    assert tans["results"][1]["tokens"] != tans["results"][0]["tokens"]
    long = tans["results"][2]["tokens"]
    assert len(long) == 8  # eos_token: null opts a text request out of the eos stop
    word = tok.decode([long[3]])
    stopped = []
    for stop in (word, [word], [word, [long[5]]]):
        body = dict(REQUESTS[2], stop=stop)
        (js, ja), (ts, ta) = _post(jbase, body), _post(tbase, body)
        assert js == ts == 200 and _strip(ta) == _strip(ja), stop
        stopped.append(ta["tokens"])
    assert len(stopped[0]) <= 3 and stopped[0] == long[:len(stopped[0])]


def test_sse_text_deltas_equal_jax_and_concatenate(servers):
    """A streamed text request: one event a token with its text_delta, the
    deltas concatenate to the final event's text, which is the unstreamed
    answer's; every event equals the JAX server's."""
    jbase, tbase, _, _ = servers
    body = {"text": "w30 w31 w32", "max_new_tokens": 8, "eos_token": None}
    tev, jev = _stream(tbase, body), _stream(jbase, body)
    assert [_strip(e) for e in tev] == [_strip(e) for e in jev]
    final = tev[-1]
    assert final["done"] and len(tev) == len(final["tokens"]) + 1
    assert "".join(e["text_delta"] for e in tev[:-1]) == final["text"]
    assert [e["token"] for e in tev[:-1]] == final["tokens"]
    assert final["text"] == _post(tbase, body)[1]["text"]


BAD = [
    {"tokens": [1, 2], "text": "w25"},
    {"text": "w25", "messages": [{"role": "user", "content": "w25"}]},
    {"messages": []},
    {"messages": [{"role": "user"}]},
    {"text": "w25", "stop": 7},
    {"text": "w25", "stop": [7]},
]
NO_TOKENIZER = [{"text": "w25"}, {"messages": [{"role": "user", "content": "w25"}]},
                {"tokens": [1, 2], "stop": "w25"}, {"tokens": [1, 2], "stop": ["w25"]}]


def test_errors_equal_jax(servers):
    """Malformed prompts and stops are 422s with JAX's messages, with and
    without a tokenizer (the reference's 'start the server with
    --hf-model' ones)."""
    jbase, tbase, jsvc, tsvc = servers
    for body in BAD:
        (js, ja), (ts, ta) = _post(jbase, body), _post(tbase, body)
        assert js == ts == 422 and ta == ja, body
    toks = jsvc.tokenizer, tsvc.tokenizer
    try:
        jsvc.tokenizer = tsvc.tokenizer = None
        for body in NO_TOKENIZER:
            (js, ja), (ts, ta) = _post(jbase, body), _post(tbase, body)
            assert js == ts == 422 and ta == ja, body
            assert "start the server with --hf-model" in ta["error"]
    finally:
        jsvc.tokenizer, tsvc.tokenizer = toks


def test_load_tokenizer_without_files_and_generate_main(tmp_path, hf_dir, capsys):
    """A directory without tokenizer files loads none, with the reference's
    line; generate --hf-model runs on the directory's weights."""
    save_hf(str(tmp_path), *GEMMA2, seed=3)
    assert generate.load_tokenizer(str(tmp_path)) is None
    assert "; id-list data only" in capsys.readouterr().out
    assert generate.load_tokenizer("") is None
    assert generate.main(["--device", "cpu", "--hf-model", hf_dir, "--batch", "2",
                          "--prompt-len", "5", "--max-new-tokens", "3"]) == 0
    assert "done: generated 2x3 tokens" in capsys.readouterr().out


def test_serve_hf_model_and_draft_hf_model(hf_dir, tmp_path):
    """serve --hf-model DIR (bf16, as a user runs it): a text answer is the
    greedy continuation decode.generate gives on load_hf's tree; with
    --draft-hf-model DIR the engine speculates and answers the same; a draft
    of another vocabulary is refused."""
    params, config = import_hf.load_hf(hf_dir, device="cpu")
    tok = generate.load_tokenizer(hf_dir)
    prompt = tok.encode("w40 w41 w42")
    want = decode.generate(params, torch.tensor([prompt]), config, 6,
                           max_len=len(prompt) + 6)[0].tolist()
    for extra in ([], ["--draft-hf-model", hf_dir, "--spec-k", "3"]):
        args = serve.parse_args(["--device", "cpu", "--hf-model", hf_dir, "--port", "0",
                                 "--bind", "127.0.0.1", "--max-len", "64", "--slots", "2"]
                                + extra)
        httpd, svc = serve.build_server(args)
        assert svc.tokenizer is not None
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            status, ans = _post(base, {"text": "w40 w41 w42", "max_new_tokens": 6,
                                       "eos_token": None})
            assert status == 200 and ans["tokens"] == want, extra
            assert ans["text"] == tok.decode(want, skip_special_tokens=True)
            if extra:
                assert svc.engine.stats()["spec_rounds"] > 0
        finally:
            _stop(svc, httpd, t)
    other = str(tmp_path / "other")
    save_hf(other, GEMMA2[0], dict(GEMMA2[1], vocab_size=64), seed=4)
    args = serve.parse_args(["--device", "cpu", "--hf-model", hf_dir, "--port", "0",
                             "--draft-hf-model", other])
    with pytest.raises(ValueError, match="draft vocab 64 != target 96"):
        serve.build_server(args)
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "nope")):
        serve.build_server(serve.parse_args(["--device", "cpu", "--hf-model",
                                             str(tmp_path / "nope")]))
