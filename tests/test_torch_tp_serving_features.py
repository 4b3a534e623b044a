"""The serving features under a mesh (ROADMAP.md 12c): one gloo gang of 4
(tests/torch_gang.py kind "features", one process a device) on tensor2·data2
against the JAX package on the same mesh of 4 CPU devices, on a windowed
tiny model (sliding_window 8) in f32: a ring engine, chunked prefill
(prompt_buckets [16], prefill_chunk 16, a 40-token prompt beside two short
ones), a registered prefix with suffix requests, a self-draft speculative
engine, and direct `prefill_chunked` and `generate_speculative` calls. The
same LlamaConfig.tiny parameters, carried across with utils/convert.py; the
JAX side runs its ServingEngine and jitted functions on its sharded tree,
while the gang runs. Every rank's greedy tokens equal JAX's; the ring and the
chunker's caches hold the rank's 1 of 2 KV heads."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from kubedl_tpu.models import decode as jdecode
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models.serving import ServingEngine as JaxEngine
from kubedl_tpu.parallel.mesh import ShardingRules, build_mesh
from torch_gang import _drive, run_gang

ICI = {"tensor": 2, "data": 2}
WINDOW = 8


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).astype(np.int32) for n in lengths]


ENGINE = dict(slots=2, max_len=64)
RUNS = {
    "ring": dict(what="engine", engine=dict(ENGINE, ring=True),
                 prompts=_prompts((5, 11, 20), 1), new_tokens=6),
    "chunked": dict(what="engine",
                    engine=dict(ENGINE, ring=False, prompt_buckets=[16], prefill_chunk=16),
                    prompts=_prompts((40, 6, 9), 2), new_tokens=4),
    "prefix": dict(what="engine", engine=dict(ENGINE, ring=False),
                   prefix=_prompts((12,), 3)[0], suffixes=_prompts((3, 5), 4),
                   prompts=_prompts((7,), 5), new_tokens=4),
    "speculative": dict(what="engine", engine=dict(ENGINE, ring=False), self_draft=True,
                        prompts=_prompts((6, 10), 6), new_tokens=8),
    "prefill_chunked": dict(what="prefill_chunked",
                            prompt=np.stack(_prompts((37, 37), 7)), chunk=16, max_len=48,
                            new_tokens=4),
    "generate_speculative": dict(what="generate_speculative",
                                 prompt=_prompts((9,), 8)[0][None], new_tokens=10, k=4),
}


def _jax_runs(jcfg, jparams):
    """JAX's results of every run, on its sharded tree."""
    mesh = build_mesh(ICI, devices=jax.devices()[:4])
    specs = jllama.param_specs(jcfg, ShardingRules())
    p = jax.tree_util.tree_map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                               jparams, specs, is_leaf=lambda x: isinstance(x, JP))
    out = {}
    for name, run in RUNS.items():
        if run["what"] == "engine":
            kw = dict(run["engine"])
            if run.get("self_draft"):
                kw.update(draft_params=p, draft_config=jcfg)
            eng = JaxEngine(p, jcfg, **kw)
            out[name] = {"tokens": _drive(eng, run), "stats": eng.stats()}
        elif run["what"] == "prefill_chunked":
            def chunked(p, pr):
                cache = jdecode.init_kv_cache(jcfg, pr.shape[0], run["max_len"], uniform=True)
                logits, cache = jdecode.prefill_chunked(p, pr, cache, jcfg,
                                                        chunk_size=run["chunk"])
                first, toks = logits, [jnp.argmax(logits, -1).astype(jnp.int32)]
                for _ in range(run["new_tokens"] - 1):
                    logits, cache = jdecode.decode_step(p, toks[-1], cache, jcfg)
                    toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
                return first, jnp.stack(toks, 1)
            first, toks = jax.jit(chunked)(p, jnp.asarray(run["prompt"]))
            out[name] = {"logits": np.asarray(first), "tokens": np.asarray(toks).tolist()}
        else:
            toks, stats = jdecode.generate_speculative(
                p, p, jnp.asarray(run["prompt"]), jcfg, jcfg, run["new_tokens"], k=run["k"],
                return_stats=True)
            out[name] = {"tokens": np.asarray(toks).tolist(), "stats": stats}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False, sliding_window=WINDOW)
    jparams = jllama.init(jcfg, jax.random.PRNGKey(0))
    fields = dataclasses.asdict(jcfg)
    fields.update(dtype="float32", use_flash=True)  # the port's flash wrapper (plain on CPU)
    case = dict(name="features", kind="features", ici=ICI, config=fields,
                params=jax.device_get(jparams), runs=RUNS)
    port, ref = run_gang([case], 4, tmp_path_factory.mktemp("features"),
                         meanwhile=lambda: _jax_runs(jcfg, jparams))
    return port["features"], ref


@pytest.mark.parametrize("name", list(RUNS))
def test_every_rank_gives_the_jax_tokens(name, runs):
    port, ref = runs
    assert port["mesh"] == {**{a: 1 for a in port["mesh"]}, **ICI}
    assert len(port["ranks"]) == 4
    for rank, out in enumerate(port["ranks"]):
        assert out[name]["tokens"] == ref[name]["tokens"], (rank, out[name]["tokens"],
                                                            ref[name]["tokens"])


def test_features_take_their_paths_as_jax_does(runs):
    """The chunker ran once, the self-draft accepted what JAX's did, and the
    direct calls' first logits agree within 1e-4 of max|JAX|."""
    port, ref = runs
    for out in port["ranks"]:
        assert out["chunked"]["stats"]["chunked_prefills"] == \
            ref["chunked"]["stats"]["chunked_prefills"] == 1
        assert out["speculative"]["stats"]["spec_acceptance"] == \
            ref["speculative"]["stats"]["spec_acceptance"]
        assert out["prefix"]["stats"]["prefixes_registered"] == 1
        assert out["generate_speculative"]["stats"] == pytest.approx(
            ref["generate_speculative"]["stats"])
        want = ref["prefill_chunked"]["logits"]
        np.testing.assert_allclose(out["prefill_chunked"]["logits"], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_ring_and_caches_hold_the_local_heads(runs):
    """Each rank's ring holds the window's rows of its 1 of 2 KV heads;
    the full caches the same heads at max_len."""
    port, _ = runs
    kv = jllama.LlamaConfig.tiny().n_kv_heads // ICI["tensor"]
    for out in port["ranks"]:
        assert (out["ring"]["cache_heads"], out["ring"]["cache_rows"]) == (kv, WINDOW)
        for name in ("chunked", "prefix", "speculative"):
            assert (out[name]["cache_heads"], out[name]["cache_rows"]) == (kv, 64)
