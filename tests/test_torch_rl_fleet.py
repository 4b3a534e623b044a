"""The port's actor/learner fleet (kubedl_tpu_torch/rl/) on LlamaConfig.tiny
in f32: trajectory groups made by the JAX package's ActorRuntime cross a
DirChannel into the port's LearnerRuntime, whose losses and parameters
hold to the JAX learner's on the same groups; the lockstep in-process
fleet equals the port's own monolithic GRPO loop bit for bit (the recipe
of tests/test_rl.py); stale trajectories are dropped and counted; a failed
actor channel leaves the rotation; the behavior logprobs equal the
training forward's recompute, with the decode engine and with the serving
plane (engine="serving", whose later waves share prompt blocks); a JAX
learner and a port actor train over one socket pair of the two packages'
transport planes."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.parallel import pipeline_mpmd as jmpmd
from kubedl_tpu.parallel.mesh import build_mesh
from kubedl_tpu.rl import actor as jactor
from kubedl_tpu.rl import learner as jlearner
from kubedl_tpu.rl import trajectory as jtraj
from kubedl_tpu_torch.models import decode, llama
from kubedl_tpu_torch.parallel import optim
from kubedl_tpu_torch.parallel.pipeline_mpmd import DirChannel, QueueChannel
from kubedl_tpu_torch.rl.actor import ActorConfig, ActorRuntime
from kubedl_tpu_torch.rl.fleet import RLFleet, fleet_goodput_split
from kubedl_tpu_torch.rl.learner import LearnerConfig, LearnerRuntime
from kubedl_tpu_torch.rl.metrics import rl_metrics
from kubedl_tpu_torch.rl.trajectory import Trajectory, TrajectoryConsumer, TrajectoryProducer
from kubedl_tpu_torch.rl.weights import WeightBroadcaster, sorted_leaves
from kubedl_tpu_torch.train import grpo, rl
from kubedl_tpu_torch.train.preference import sequence_logprobs
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy

LR, CLIP_EPS, KL = 1e-4, 0.2, 0.04


@pytest.fixture(autouse=True)
def _reset_metrics():
    rl_metrics.reset()
    yield
    rl_metrics.reset()


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False)
    jp = jllama.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, config_from_fields(**dataclasses.asdict(jcfg))


def _tp(jp):
    return params_from_numpy(jax.device_get(jp))


def _prompts(config, n=8, p=6, seed=0):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, config.vocab_size, p)) for _ in range(n)]


def _reward_token5(prompt_ids, completion_ids):
    if not completion_ids:
        return 0.0
    return sum(1 for t in completion_ids if t == 5) / len(completion_ids)


def test_port_learner_on_jax_actor_trajectories(model, tmp_path):
    """The JAX ActorRuntime rolls 2 iterations of 2 groups (ragged prompts,
    EOS trimming) onto a DirChannel; the port's LearnerRuntime takes them
    off the directory and runs 2 updates on the behavior logprobs. The JAX
    LearnerRuntime (data4·tensor2 mesh) updates on the same groups: losses
    within 1e-5 relative, parameters within 1e-5."""
    jcfg, jp, tcfg = model
    B, G, K, steps = 2, 2, 4, 2
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, tcfg.vocab_size, n)) for n in (5, 6, 4, 6, 5, 3)]
    queue = str(tmp_path / "traj-actor-0")
    actor = jactor.ActorRuntime(
        jp, jcfg, jactor.ActorConfig(seed=3, group_size=G, prompts_per_step=B,
                                     max_new_tokens=K, eos_id=7),
        prompts, _reward_token5,
        producer=jtraj.TrajectoryProducer(jmpmd.DirChannel(queue), "actor-0", job="x"))
    made = [actor.step(it) for it in range(1, steps + 1)]
    jl = jlearner.LearnerRuntime(
        jp, jcfg, jlearner.LearnerConfig(prompts_per_step=B, group_size=G, lr=LR,
                                         clip_eps=CLIP_EPS, kl_coef=KL),
        consumer=jtraj.TrajectoryConsumer({"actor-0": jmpmd.QueueChannel()}),
        mesh=build_mesh({"data": 4, "tensor": 2}))
    want = [jl.train_step(groups)["loss"] for groups in made]
    tl = LearnerRuntime(
        _tp(jp), tcfg, LearnerConfig(prompts_per_step=B, group_size=G, lr=LR,
                                     clip_eps=CLIP_EPS, kl_coef=KL, take_timeout_s=10.0),
        consumer=TrajectoryConsumer({"actor-0": DirChannel(queue)}))
    got = []
    stats = tl.run(steps, on_step=lambda s, m: got.append(m["loss"]))
    assert stats.consumed == B * steps and stats.stale_dropped == 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for a, b in zip(sorted_leaves(tl.state.params),
                    jax.tree_util.tree_leaves(jax.device_get(jl.state.params))):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=1e-5)
    assert {"pg_loss", "kl", "ratio_mean", "clip_frac"} <= set(tl.stats.last_metrics)


def _monolith(params, config, prompts, seed, B, G, K, steps):
    """The monolithic loop of tests/test_rl.py on the port: grpo.py's
    rollout with sampling-time logprobs and the same seeds, one update a
    rollout on those logprobs. Returns (losses, params)."""
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(LR, weight_decay=0.0))
    init_state, _, ref_fn, step = rl.make_grpo_step(params, config, tx, clip_eps=CLIP_EPS,
                                                    kl_coef=KL, use_old_logprobs=True)
    state = init_state(params)
    P = len(prompts[0])
    losses = []
    for it in range(1, steps + 1):
        pick = np.random.default_rng((seed, it)).choice(len(prompts), size=B,
                                                        replace=len(prompts) < B)
        tiled = np.repeat(np.array([prompts[i] for i in pick], np.int32), G, axis=0)
        with torch.no_grad():
            comp, lps = decode.generate(state.params, torch.from_numpy(tiled), config, K,
                                        temperature=1.0,
                                        generator=grpo.sampling_generator("cpu", seed, it),
                                        with_logprobs=True)
        n = B * G
        full = torch.cat([torch.from_numpy(tiled), comp], 1)
        rewards = np.array([_reward_token5(list(tiled[i]), comp[i].tolist())
                            for i in range(n)], np.float32)
        grid = torch.zeros((n, P + K - 1))
        grid[:, P - 1:] = lps
        adv = rl.group_advantages(rewards.reshape(B, G)).reshape(n)
        batch = (full, torch.full((n,), P, dtype=torch.int32),
                 torch.full((n,), P + K, dtype=torch.int32))
        state, m = step(state, (*batch, adv, grid, ref_fn(batch)))
        losses.append(float(m["loss"]))
    return losses, state.params


def test_lockstep_fleet_equals_the_monolith_bit_for_bit(model):
    """1 actor, maxWeightLag 0 (lockstep), 3 learner steps: the same prompt
    picks, rollouts and updates as the monolithic loop; losses and final
    parameters equal bit for bit, no stale drops, lag 0."""
    jcfg, jp, tcfg = model
    seed, B, G, K, steps = 0, 2, 2, 4, 3
    prompts = _prompts(tcfg)
    want, mono = _monolith(_tp(jp), tcfg, prompts, seed, B, G, K, steps)
    fleet = RLFleet(
        _tp(jp), tcfg, prompts, _reward_token5,
        ActorConfig(seed=seed, group_size=G, prompts_per_step=B, max_new_tokens=K,
                    max_weight_lag=0, lockstep=True),
        LearnerConfig(prompts_per_step=B, group_size=G, max_weight_lag=0, lr=LR,
                      clip_eps=CLIP_EPS, kl_coef=KL, take_timeout_s=60.0))
    assert not fleet.use_weight_tree and fleet.actor_steps_for(steps) == steps
    got = []
    stats = fleet.run(steps, on_step=lambda s, m: got.append(m["loss"]))
    assert got == want
    assert stats.stale_dropped == 0 and stats.max_lag_observed == 0
    for a, b in zip(llama.tree_leaves(fleet.learner.state.params), llama.tree_leaves(mono)):
        assert torch.equal(a, b)
    split = fleet_goodput_split(stats, fleet.actors)
    assert split["rollout_tokens"] == steps * B * G * K and split["stale_dropped"] == 0
    # the actor sampled its last iteration from the learner's version 2
    assert fleet.actors[0].weight_version == steps - 1
    snap = rl_metrics.snapshot()["jobs"]["rl"]
    assert snap["produced"] == snap["consumed"] == steps * B and snap["weight_version"] == 3


def _traj(g=2, t=8, pl=3, version=0, seed=0):
    rng = np.random.default_rng(seed)
    return Trajectory(
        tokens=rng.integers(1, 100, (g, t)).astype(np.int32), prompt_len=pl,
        seq_lens=np.full(g, t, np.int32), rewards=rng.normal(size=g).astype(np.float32),
        behavior_logprobs=rng.normal(size=(g, t - 1)).astype(np.float32),
        weight_version=version)


def test_stale_trajectories_dropped_and_counted(model):
    """Trajectories staler than maxWeightLag versions are dropped AND
    counted; the fresh one is consumed (tests/test_rl.py's case)."""
    jcfg, jp, tcfg = model
    traj_ch, weight_ch = QueueChannel(), QueueChannel()
    params = _tp(jp)
    learner = LearnerRuntime(
        params, tcfg,
        LearnerConfig(prompts_per_step=1, group_size=2, max_weight_lag=1,
                      take_timeout_s=10.0, job="stale-job"),
        consumer=TrajectoryConsumer({"actor-0": traj_ch}, job="stale-job"),
        broadcaster=WeightBroadcaster([weight_ch]))
    for step in (1, 2, 3):
        learner.broadcaster.publish(params, step)
    producer = TrajectoryProducer(traj_ch, "actor-0", job="stale-job")
    for version, seed in ((0, 1), (1, 2), (2, 3)):
        producer.send(_traj(version=version, seed=seed))
    groups = learner._collect_batch()
    assert [t.weight_version for t in groups] == [2]
    assert (learner.stats.stale_dropped, learner.stats.consumed,
            learner.stats.max_lag_observed) == (2, 1, 1)
    rec = rl_metrics.snapshot()["jobs"]["stale-job"]
    assert rec["stale_dropped"] == 2 and rec["consumed"] == 1 and rec["weight_lag"] == 1
    learner.cfg.group_size = 3
    with pytest.raises(ValueError, match="group of 2 != configured group size 3"):
        learner.train_step(groups)


class _Broken:
    def recv(self, tag, timeout=0.0):
        raise OSError("inbox poisoned")


def test_failed_actor_channel_leaves_the_rotation(capsys):
    good = QueueChannel()
    TrajectoryProducer(good, "actor-1").send(_traj(seed=4))
    consumer = TrajectoryConsumer({"actor-0": _Broken(), "actor-1": good})
    assert consumer.take(timeout=1.0).actor == "actor-1"
    assert list(consumer.failed_actors()) == ["actor-0"]
    assert "actor actor-0 channel failed" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="every actor channel failed"):
        TrajectoryConsumer({"actor-0": _Broken()}).take(timeout=0.1)


def test_behavior_logprobs_equal_the_recompute(model):
    """The actor's sampling-time logprobs, placed in the grid, equal the
    training forward's (sequence_logprobs) within 1e-5 at every completion
    position and are zero elsewhere; the rows equal grpo.py's."""
    jcfg, jp, tcfg = model
    prompts = _prompts(tcfg, n=4, p=5, seed=2)
    actor = ActorRuntime(_tp(jp), tcfg, ActorConfig(seed=1, group_size=2, prompts_per_step=2,
                                                    max_new_tokens=6),
                         prompts, _reward_token5,
                         producer=TrajectoryProducer(QueueChannel(), "actor-0"))
    for traj in actor.step(1):
        g = traj.tokens.shape[0]
        (lp, mask), _ = sequence_logprobs(
            actor.params, torch.from_numpy(traj.tokens), torch.full((g,), traj.prompt_len),
            torch.from_numpy(traj.seq_lens), tcfg, with_aux=True, per_token=True)
        np.testing.assert_allclose(traj.behavior_logprobs, (lp * mask).detach().numpy(),
                                   rtol=0, atol=1e-5)
        assert not traj.behavior_logprobs[mask.numpy() == 0].any()


def test_engines_refused(model):
    """Unknown engines and degenerate sampling are refused; "serving"
    builds the paged rollout engine (B * G slots, max_len the longest
    prompt plus K, seed + actor index)."""
    jcfg, jp, tcfg = model
    mk = lambda **kw: ActorRuntime(_tp(jp), tcfg, ActorConfig(**kw), [[1, 2, 3]],  # noqa: E731
                                   _reward_token5, producer=None)
    eng = mk(engine="serving", group_size=4, prompts_per_step=2, max_new_tokens=13,
             actor_index=1, seed=5)._serving.engine
    assert (eng.slots, eng.max_len, eng.temperature) == (8, 16, 1.0)
    assert mk()._serving is None
    with pytest.raises(ValueError, match="unknown rollout engine"):
        mk(engine="vllm")
    with pytest.raises(ValueError, match="temperature"):
        mk(temperature=0.0)
    with pytest.raises(ValueError, match="group_size"):
        mk(group_size=1)


def test_serving_engine_actor_logprobs_and_shared_prompt_blocks(model):
    """engine="serving": the behavior logprobs equal the training
    forward's recompute within 1e-4 (f32), and the second iteration's
    groups are admitted on the prompt blocks the first one indexed."""
    jcfg, jp, tcfg = model
    prompts = _prompts(tcfg, n=2, p=20, seed=4)
    actor = ActorRuntime(_tp(jp), tcfg, ActorConfig(seed=1, group_size=2, prompts_per_step=2,
                                                    max_new_tokens=12, engine="serving"),
                         prompts, _reward_token5,
                         producer=TrajectoryProducer(QueueChannel(), "actor-0"))
    for it in (1, 2):
        for traj in actor.step(it):
            g = traj.tokens.shape[0]
            (lp, mask), _ = sequence_logprobs(
                actor.params, torch.from_numpy(traj.tokens), torch.full((g,), traj.prompt_len),
                torch.from_numpy(traj.seq_lens), tcfg, with_aux=True, per_token=True)
            np.testing.assert_allclose(traj.behavior_logprobs, (lp * mask).detach().numpy(),
                                       rtol=0, atol=1e-4)
            assert not traj.behavior_logprobs[mask.numpy() == 0].any()
        st = actor._serving.stats()
        # 20-token prompts, 16-token blocks: one full block a prompt
        assert st["prefix_entries"] == 2
        assert st["prefix_hit_tokens"] == (0 if it == 1 else 2 * 2 * 16)
    assert actor.tokens_generated == 2 * 2 * 2 * 12


def test_jax_learner_and_port_actor_over_one_socket_pair(model):
    """The port's ActorRuntime (lockstep, on its socket plane) sends groups
    to the JAX LearnerRuntime (on the JAX plane), which broadcasts each
    version back: 2 steps, every group consumed once, and the actor ends
    on the JAX learner's final parameters bit for bit."""
    import threading

    from kubedl_tpu.rl import weights as jweights
    from kubedl_tpu.transport import TransportPlane as JaxPlane
    from kubedl_tpu_torch.rl.weights import WeightReceiver
    from kubedl_tpu_torch.transport import TransportPlane

    jcfg, jp, tcfg = model
    B, G, K, steps = 2, 2, 4, 2
    jplane, tplane = JaxPlane(token="rl-pair", service="learner"),         TransportPlane(token="rl-pair", service="actor-0")
    try:
        j_addr, t_addr = jplane.listen("127.0.0.1:0"), tplane.listen("127.0.0.1:0")
        learner = jlearner.LearnerRuntime(
            jp, jcfg, jlearner.LearnerConfig(prompts_per_step=B, group_size=G,
                                             max_weight_lag=0, lr=LR, clip_eps=CLIP_EPS,
                                             kl_coef=KL, take_timeout_s=60.0),
            consumer=jtraj.TrajectoryConsumer(
                {"actor-0": jplane.channel("rl-traj.actor-0")}),
            broadcaster=jweights.WeightBroadcaster(
                [jplane.channel("rl-weights", peer_addr=t_addr)]),
            mesh=build_mesh({"data": 4, "tensor": 2}))
        actor = ActorRuntime(
            _tp(jp), tcfg, ActorConfig(seed=0, group_size=G, prompts_per_step=B,
                                       max_new_tokens=K, max_weight_lag=0, lockstep=True,
                                       weight_wait_s=60.0),
            _prompts(tcfg), _reward_token5,
            producer=TrajectoryProducer(tplane.channel("rl-traj.actor-0", peer_addr=j_addr),
                                        "actor-0"),
            receiver=WeightReceiver(tplane.channel("rl-weights")))
        out = {}
        thread = threading.Thread(target=lambda: out.update(stats=learner.run(steps)))
        thread.start()
        for it in range(1, steps + 1):
            actor.step(it)
        actor.finish(steps)
        thread.join(timeout=120)
        assert not thread.is_alive() and out["stats"].consumed == B * steps
        assert out["stats"].stale_dropped == 0
        assert (actor.weight_version, actor.weight_step) == (2, 2)
        for a, b in zip(sorted_leaves(actor.params),
                        jax.tree_util.tree_leaves(jax.device_get(learner.state.params))):
            assert np.array_equal(a.numpy(), np.asarray(b))
    finally:
        jplane.close()
        tplane.close()
