"""The port's sharded MoE train step on a gloo gang against the JAX step on
the same mesh, for the expert meshes of the JAX package's dry run:
expert4·data2 on the capacity route, expert4·data2 dropless and
expert2·tensor2·data2 dropless (n_experts = the expert axis). Each rank owns
its rows (the token blocks: data, then expert). The dropless cases run at
quota factor 1.0 (0.5 on expert2, where top 2 of 2 sends every token to
both shards), so some destination shards overflow their quota and drop
entries. Compared as in test_torch_sharded_step.py, and on the dropless
route the routing and dispatch integers of layer 0 exactly: each block's
expert choices against the JAX package's `_top_k_gating` on the JAX
layer-0 hidden states, and which entries the quota kept against the
quota rule applied to them."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import jax.numpy as jnp
import numpy as np
import pytest

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models import moe as jmoe
from kubedl_tpu.parallel.mesh import ShardingRules
from test_torch_sharded_step import compare, run_cases

CASES = {
    "expert4_data2_capacity": dict(
        ici={"expert": 4, "data": 2}, rows=16, seq=65,
        cfg=dict(n_experts=4, moe_dropless=False)),
    "expert4_data2_dropless": dict(
        ici={"expert": 4, "data": 2}, rows=16, seq=129,
        cfg=dict(n_experts=4, moe_dropless=True, expert_capacity_factor=1.0)),
    "expert2_tensor2_data2_dropless": dict(
        ici={"expert": 2, "tensor": 2, "data": 2}, rows=8, seq=129,
        cfg=dict(n_experts=2, moe_dropless=True, expert_capacity_factor=0.5)),
}


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    return run_cases(CASES, 8, tmp_path_factory.mktemp("moe"))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_moe_step_matches_jax(name, moe_runs):
    port, ref, _ = moe_runs
    want = {a: 1 for a in port[name]["mesh"]}
    want.update(CASES[name]["ici"])
    assert port[name]["mesh"] == want
    compare(port[name], ref[name])


def _layer0_moe_input(jcfg, jparams, batch):
    """The JAX model's layer-0 MoE input for the global batch [B, T, d]."""
    layer = jparams["layers"][0]
    toks = jnp.asarray(batch[:, :-1])
    b, t = toks.shape
    x = jparams["embed"][toks].astype(jcfg.dtype)
    pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[None], (b, t))
    x = jllama._attention_block(x, layer, jcfg, pos, None, ShardingRules(), 1)
    return jllama.rms_norm(x, layer["mlp_norm"], jcfg.rms_eps, jcfg.norm_offset)


def _kept(experts, e_loc, n_e, quota):
    """The quota rule: entries (choice-major) sorted stably by expert; an
    entry is kept when it is among the first `quota` of its destination
    shard."""
    ef = np.asarray(experts).reshape(-1)
    order = np.argsort(ef, kind="stable")
    dest = ef[order] // e_loc
    starts = np.concatenate([[0], np.cumsum(np.bincount(dest, minlength=n_e))[:-1]])
    kept = np.empty(ef.shape, bool)
    kept[order] = np.arange(ef.size) - starts[dest] < quota
    return kept.reshape(np.asarray(experts).shape)


@pytest.mark.parametrize("name", [n for n in CASES if "dropless" in n])
def test_dropless_routing_and_quota_drops_are_exact(name, moe_runs):
    port, _, built = moe_runs
    case, (jcfg, jparams, _) = built[name]
    stats = port[name]["stats"]
    ici = CASES[name]["ici"]
    n_e = ici["expert"]
    n_tok = ici["data"] * n_e
    assert sorted(stats) == list(range(n_tok))
    h = np.asarray(_layer0_moe_input(jcfg, jparams, case["batches"][0]))
    rows = h.shape[0] // n_tok
    router = jparams["layers"][0]["moe"]["router"]
    e, k = jcfg.n_experts, jcfg.expert_top_k
    s_loc = rows * h.shape[1]
    quota = int(np.ceil(k * s_loc * jcfg.expert_capacity_factor / n_e / 128)) * 128
    dropped = 0
    for blk in range(n_tok):
        hf = jnp.asarray(h[blk * rows:(blk + 1) * rows].reshape(s_loc, -1))
        experts = np.asarray(jmoe._top_k_gating(hf @ router, k, s_loc + 1,
                                                need_slots=False)[0])
        got = stats[blk]
        np.testing.assert_array_equal(got["experts"], experts, err_msg=f"block {blk}")
        np.testing.assert_array_equal(got["kept"], _kept(experts, e // n_e, n_e, quota),
                                      err_msg=f"block {blk}")
        dropped += int((~got["kept"]).sum())
    assert dropped > 0, "no entry dropped: the case does not test the quota"
