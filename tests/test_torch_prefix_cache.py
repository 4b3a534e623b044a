"""Prefix caching of kubedl_tpu_torch/models/serving.py (register_prefix,
prefix_id, POST /prefix) against the JAX engine's (tests/test_serving.py
holds the JAX side to full prompts): the same f32 parameters, prompts from
a numpy seed. First-token logits within 1e-4 of max|JAX|, greedy tokens
equal to JAX's and to the full prompt sent without a prefix, the
registered cache unchanged bit for bit by the requests that append to it,
and JAX's validation errors."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses
import json
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models.serving import ServingEngine as JaxEngine
from kubedl_tpu_torch.models import decode as tdecode
from kubedl_tpu_torch.models.serving import ServingEngine
from kubedl_tpu_torch.parallel import mesh as tmesh
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(use_flash=False, dtype=jnp.float32)
    jp = jllama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(config_from_fields(**dataclasses.asdict(jcfg)), use_flash=True)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp))


def _prompt(n, rng):
    return rng.integers(1, 256, size=n).astype(np.int32)


def _run(eng, reqs):
    while not all(r.done for r in reqs):
        eng.step()
    return [r.tokens for r in reqs]


def _ref(tp, tcfg, prompt, n):
    return tdecode.generate(tp, torch.from_numpy(prompt)[None], tcfg, n)[0].tolist()


def _snapshot(cache):
    return {name: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
            for name, v in cache.items()}


@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefix_requests_match_jax_and_full_prompts(model, kv):
    """Suffixes of 4, 19 and 33 tokens (JAX appends them in 16-token
    blocks, the port in one block step) on a 21-token prefix: JAX's tokens, and the full prompt's without a
    prefix; the registered cache is the same bits after every request."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(3)
    system = _prompt(21, rng)
    suffixes = [_prompt(n, rng) for n in (4, 19, 33)]
    j = JaxEngine(jp, jcfg, slots=2, max_len=96, kv_dtype=kv)
    jpid = j.register_prefix(system)
    want = _run(j, [j.submit(s, 5, prefix_id=jpid) for s in suffixes])
    eng = ServingEngine(tp, tcfg, slots=2, max_len=96, kv_dtype=kv)
    pid = eng.register_prefix(system)
    kept = _snapshot(eng._prefixes[pid][0])
    got = _run(eng, [eng.submit(s, 5, prefix_id=pid) for s in suffixes])
    assert got == [list(map(int, x)) for x in want]
    full = ServingEngine(tp, tcfg, slots=2, max_len=96, kv_dtype=kv)
    assert got == _run(full, [full.submit(np.concatenate([system, s]), 5) for s in suffixes])
    if kv is None:
        assert got == [_ref(tp, tcfg, np.concatenate([system, s]), 5) for s in suffixes]
    again = _run(eng, [eng.submit(suffixes[1], 5, prefix_id=pid)])
    assert again == [got[1]]
    after = eng._prefixes[pid][0]
    for name, v in kept.items():
        for a, b in zip(v if isinstance(v, list) else [v],
                        after[name] if isinstance(after[name], list) else [after[name]]):
            assert torch.equal(a, b), name
    assert eng.stats()["prefixes_registered"] == 1


def test_suffix_prefill_logits_match_jax(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(4)
    system, suffix = _prompt(11, rng), _prompt(20, rng)
    j = JaxEngine(jp, jcfg, slots=1, max_len=64)
    eng = ServingEngine(tp, tcfg, slots=1, max_len=64)
    jl, jc = j._suffix_prefill(j.register_prefix(system), suffix)
    tl, tc = eng._suffix_prefill(eng.register_prefix(system), suffix)
    want = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    assert int(tc["lengths"]) == int(jc["lengths"]) == 31
    for i in range(tcfg.n_layers):
        np.testing.assert_allclose(tc["k"][i][:, :, :31].numpy(),
                                   np.asarray(jc["k"][i])[:, :, :31], rtol=1e-4, atol=1e-5)


def _raises_like(jfn, tfn):
    with pytest.raises(ValueError) as je:
        jfn()
    with pytest.raises(ValueError) as te:
        tfn()
    assert str(te.value) == str(je.value)


def test_prefix_validation_matches_jax(model):
    jcfg, jp, tcfg, tp = model
    j = JaxEngine(jp, jcfg, slots=1, max_len=32)
    t = ServingEngine(tp, tcfg, slots=1, max_len=32)
    _raises_like(lambda: j.register_prefix(np.zeros(0, np.int32)),
                 lambda: t.register_prefix(np.zeros(0, np.int32)))
    _raises_like(lambda: j.register_prefix(np.ones(32, np.int32)),
                 lambda: t.register_prefix(np.ones(32, np.int32)))
    jpid, pid = j.register_prefix(np.ones(20, np.int32)), t.register_prefix(np.ones(20, np.int32))
    assert jpid == pid == 0
    _raises_like(lambda: j.submit(np.ones(8, np.int32), 8, prefix_id=jpid),
                 lambda: t.submit(np.ones(8, np.int32), 8, prefix_id=pid))
    _raises_like(lambda: j.submit(np.ones(2, np.int32), 2, prefix_id=99),
                 lambda: t.submit(np.ones(2, np.int32), 2, prefix_id=99))
    _raises_like(lambda: j.submit(np.zeros(0, np.int32), 2, prefix_id=jpid),
                 lambda: t.submit(np.zeros(0, np.int32), 2, prefix_id=pid))
    # prefix requests bypass the prompt-bucket cap
    eng = ServingEngine(tp, tcfg, slots=1, max_len=64, prompt_buckets=[8])
    req = eng.submit(np.ones(20, np.int32), 2, prefix_id=eng.register_prefix(np.ones(4, np.int32)))
    assert len(_run(eng, [req])[0]) == 2


def test_prefix_registry_cap_and_unregister(model):
    jcfg, jp, tcfg, tp = model
    j = JaxEngine(jp, jcfg, slots=1, max_len=64, max_prefixes=2)
    eng = ServingEngine(tp, tcfg, slots=1, max_len=64, max_prefixes=2)
    for e in (j, eng):
        e.register_prefix(np.ones(3, np.int32))
        e.register_prefix(np.ones(4, np.int32))
    _raises_like(lambda: j.register_prefix(np.ones(5, np.int32)),
                 lambda: eng.register_prefix(np.ones(5, np.int32)))
    eng.unregister_prefix(0)
    c = eng.register_prefix(np.ones(6, np.int32))
    assert c == 2
    req = eng.submit(np.ones(2, np.int32), 3, prefix_id=c)
    eng.unregister_prefix(c)
    eng.step()
    assert req.done and req.tokens == []  # its prefix went while it queued


def test_prefix_under_a_mesh_is_refused(model):
    """Once refused, prefix caching under a mesh now runs (ROADMAP.md 12c; a
    tensor-2 gang holds it to JAX in tests/test_torch_tp_serving_features.py):
    on a one-device stand-in mesh, suffix requests give the one-device
    engine's tokens."""
    _, _, tcfg, tp = model
    mesh = types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_ORDER,
                                 mesh=np.zeros([1] * len(tmesh.AXIS_ORDER)),
                                 get_local_rank=lambda axis: 0)
    rng = np.random.default_rng(5)
    prefix, suffixes = _prompt(13, rng), [_prompt(3, rng), _prompt(8, rng)]
    got = []
    for kw in (dict(mesh=mesh), {}):
        eng = ServingEngine(tp, tcfg, slots=2, max_len=64, **kw)
        pid = eng.register_prefix(prefix)
        got.append(_run(eng, [eng.submit(s, 5, prefix_id=pid) for s in suffixes]))
    assert got[0] == got[1]


def _post(base, path, body):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_http_prefix_round_trip():
    """POST /prefix, then /generate with prefix_id: the tokens of the full
    prompt on the same fresh-init weights; bad prefixes answer 422."""
    from kubedl_tpu_torch.train import serve
    from kubedl_tpu_torch.train.generate import resolve_params

    args = serve.parse_args(["--model", "tiny", "--device", "cpu", "--port", "0",
                             "--bind", "127.0.0.1", "--max-len", "64"])
    httpd, svc = serve.build_server(args)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        rng = np.random.default_rng(5)
        system, suffix = _prompt(12, rng), _prompt(6, rng)
        pid = _post(base, "/prefix", {"tokens": system.tolist()})["prefix_id"]
        got = _post(base, "/generate", {"tokens": suffix.tolist(), "max_new_tokens": 4,
                                        "prefix_id": pid})
        tp, tcfg = resolve_params("tiny", device="cpu")
        assert got["tokens"] == _ref(tp, tcfg, np.concatenate([system, suffix]), 4)
        for path, bad in (("/prefix", {"tokens": []}),
                          ("/generate", {"tokens": [1], "prefix_id": 7})):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base, path, bad)
            assert e.value.code == 422
    finally:
        httpd.shutdown()
        t.join(timeout=30)
        httpd.server_close()
        svc.stop()
