"""GRPO -- critic-free RL post-training on the port's model and train step
(kubedl_tpu/train/rl.py).

Group Relative Policy Optimization (Shao et al., 2024, DeepSeekMath):
sample G completions a prompt from the current policy, score each with a
scalar reward, and use the group-normalized reward as the advantage of
every token of that completion:

    A_i = (r_i - mean_G(r)) / (std_G(r) + eps)

The update is the PPO clipped surrogate over per-token importance ratios
plus a per-token KL penalty to the frozen reference policy (the k3
estimator -- unbiased, always >= 0):

    rho_t  = exp(logp_t - logp_old_t)
    L_pg   = -mean_t[ min(rho_t A, clip(rho_t, 1-eps, 1+eps) A) ]
    KL_t   = exp(ref_t - logp_t) - (ref_t - logp_t) - 1
    L      = L_pg + kl_coef * mean_t[KL_t]   (+ MoE router aux term)

Built as train/preference.py's DPO is: a loss over the Llama backbone
(`sequence_logprobs(per_token=True)`, so the flash kernels run its
attention) on parallel/train_step.py's `make_train_step`. The frozen
reference and the sampling-time ("old") policy never enter autograd:
their per-token logprobs are computed without it and passed into the
step as batch data. The reference is a detached copy of the starting
weights taken at construction.

With a mesh, each rank computes on its token block's rows, as DPO does
(train/preference.py), and the reference is laid out like the policy.
Every token mean is over the global batch: the masked sums and the token
count are summed over the token blocks before any division, so ranks
whose completions differ in length still give the reference's loss.
"""
from __future__ import annotations

from typing import Dict

import torch

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.train.preference import _sequence_logprobs, sequence_logprobs


def group_advantages(rewards, eps: float = 1e-6):
    """[b, G] rewards -> [b, G] group-normalized advantages (f32 tensor).

    Each prompt's G samples are normalized against their own mean and
    (population) std; a constant group (std 0) gets zero advantage rather
    than an eps-amplified noise direction."""
    r = torch.as_tensor(rewards, dtype=torch.float32)
    mean = r.mean(dim=-1, keepdim=True)
    std = r.std(dim=-1, keepdim=True, correction=0)
    return (r - mean) / (std + eps)


def grpo_loss(params: Dict, tokens, prompt_lens, seq_lens, advantages, old_logprobs,
              ref_logprobs, config: llama.LlamaConfig, clip_eps: float = 0.2,
              kl_coef: float = 0.04, mesh=None, rules=None):
    """(scalar loss, metrics): token-mean over completion positions (the
    sequence advantage broadcast to its tokens). tokens [n, T] prompt +
    completion, padded; prompt_lens [n] where the completion starts;
    seq_lens [n] true lengths; advantages [n]; old_logprobs and
    ref_logprobs [n, T-1] in sequence_logprobs' grid.

    old_logprobs=None means strictly on-policy (one update a rollout): the
    loss uses the detached logprobs of its own forward, so the ratio is
    exactly 1 and the surrogate is REINFORCE with the group baseline, one
    forward cheaper a step."""
    par = llama._par(mesh, rules, config)
    (lp, mask), aux = _sequence_logprobs(params, tokens, prompt_lens, seq_lens, config, par,
                                         with_aux=True, per_token=True)
    if old_logprobs is None:
        old_logprobs = lp.detach()
    total = _global_sum(par)
    n_tok = torch.clamp(total(mask.sum()), min=1.0)
    adv = advantages[:, None].float()  # broadcast over tokens
    ratio = torch.exp(lp - old_logprobs)
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
    surrogate = torch.minimum(ratio * adv, clipped * adv)
    pg_loss = -total((surrogate * mask).sum()) / n_tok
    if kl_coef > 0:
        # k3 KL estimator against the frozen reference (Schulman): unbiased,
        # non-negative, low-variance near the reference
        delta = ref_logprobs - lp
        kl = total(((torch.exp(delta) - delta - 1.0) * mask).sum()) / n_tok
        loss = pg_loss + kl_coef * kl
    else:
        # pure clipped-surrogate GRPO: ref_logprobs is a placeholder that
        # make_grpo_step never computes, so no KL is reported against it
        kl = torch.zeros((), dtype=torch.float32, device=lp.device)
        loss = pg_loss
    if config.n_experts > 0:
        loss = loss + config.moe_aux_coef * aux
    with torch.no_grad():
        metrics = {
            "pg_loss": pg_loss.detach(),
            "kl": kl.detach(),
            "ratio_mean": total((ratio * mask).sum()) / n_tok,
            "clip_frac": total((((ratio < 1.0 - clip_eps) | (ratio > 1.0 + clip_eps))
                                * mask).sum()) / n_tok,
            "completion_logprob": total((lp * mask).sum()) / n_tok,
        }
    return loss, metrics


def _global_sum(par):
    """x -> its sum over the token blocks (and context blocks), whose
    gradient is each rank's own part; the identity without a mesh."""
    if par is None:
        return lambda x: x
    from kubedl_tpu_torch.parallel import collectives
    from kubedl_tpu_torch.parallel.mesh import token_axes

    axes = token_axes(par.rules) + par.seq
    return lambda x: collectives.psum(x, par.mesh, axes)


def make_grpo_step(ref_params: Dict, config: llama.LlamaConfig, tx, mesh=None, rules=None,
                   clip_eps: float = 0.2, kl_coef: float = 0.04, param_spec_tree=None,
                   accum_steps: int = 1, use_old_logprobs: bool = True):
    """(init_state, logprob_fn, ref_logprob_fn, grpo_step).

    `logprob_fn(params, (tokens, prompt_lens, seq_lens)) -> ([n, T-1] lp,
    mask)` is the forward without autograd, for sampling-time ("old")
    logprobs. `ref_logprob_fn(batch)` runs the frozen reference, a detached
    copy of `ref_params` taken here (so `init_state(ref_params)` may train
    the tree it was given). `grpo_step(state, (tokens, prompt_lens,
    seq_lens, advantages, old_lp, ref_lp))` is make_train_step's update.

    use_old_logprobs=False (strictly on-policy) drops old_lp from the
    step's batch tuple. kl_coef == 0 keeps no reference copy: the reference
    function returns zeros that the loss never reads."""
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, shard_tree
    from kubedl_tpu_torch.parallel.train_step import make_train_step

    if mesh is not None:
        rules = rules or ShardingRules()
        if param_spec_tree is None:
            param_spec_tree = llama.param_specs(config, rules)
    ref = None
    if kl_coef > 0:
        ref = llama.tree_map(lambda t: t.detach().clone(), ref_params)
        if mesh is not None:  # laid out like the policy, as DPO's reference
            ref = shard_tree(ref, mesh, param_spec_tree)

    def logprob_fn(p, batch):
        tokens, prompt_lens, seq_lens = batch
        with torch.no_grad():
            return sequence_logprobs(p, tokens, prompt_lens, seq_lens, config, mesh=mesh,
                                     rules=rules, per_token=True)

    def ref_logprob_fn(batch):
        if ref is None:
            tokens = batch[0]
            return torch.zeros((tokens.shape[0], tokens.shape[1] - 1), dtype=torch.float32,
                               device=tokens.device)
        return logprob_fn(ref, batch)[0]

    def loss_fn(params, batch):
        if use_old_logprobs:
            tokens, prompt_lens, seq_lens, advantages, old_lp, ref_lp = batch
        else:
            tokens, prompt_lens, seq_lens, advantages, ref_lp = batch
            old_lp = None
        return grpo_loss(params, tokens, prompt_lens, seq_lens, advantages, old_lp, ref_lp,
                         config, clip_eps=clip_eps, kl_coef=kl_coef, mesh=mesh, rules=rules)

    init_state, grpo_step = make_train_step(loss_fn, tx, mesh, param_spec_tree,
                                            accum_steps=accum_steps, has_aux=True, rules=rules)
    return init_state, logprob_fn, ref_logprob_fn, grpo_step
