"""Preference optimization (DPO) on the port's model and train step
(kubedl_tpu/train/preference.py).

Direct Preference Optimization (Rafailov et al., 2023): for pairs of
(chosen, rejected) continuations of a shared prompt, push the policy's
log-ratio over a frozen reference apart by the preference margin:

    L = -log sigmoid(beta * ((pi_c - ref_c) - (pi_r - ref_r)))

The loss runs on parallel/train_step.py `make_train_step`, so gradient
accumulation and the optimizer are pretraining's. The reference's logprobs
are computed once a batch without autograd, by the same forward, from a
copy of the starting weights. MoE configs keep the router's balance term
(`moe_aux_coef * aux`), as models/llama.py `loss_fn` does.

`config.ce_chunks > 1` computes each position's target logprob with an
online logsumexp over vocabulary chunks (each chunk's logits recomputed in
backward), never holding the [n, T, V] f32 log-softmax.

Batch layout: tokens [b, 2, T] (dim 1 = chosen | rejected), `prompt_lens`
[b] where the continuations start, `seq_lens` [b, 2] the true lengths;
prompt and pad positions do not count.

With a mesh (parallel/mesh.py), each rank computes on its token block's
rows (parallel/mesh.py `token_index`; ranks of one block, such as the
peers of a tensor axis, hold the same rows) and on local views of the
sharded tree (models/llama.py `_Par`). When the tensor axis shards the
vocabulary, each position's target logprob comes from the sharded
logsumexp (models/llama.py `sharded_target_logprobs`) and `ce_chunks` is
ignored with a warning, as pretraining's loss does. The loss and every
metric are the global batch's means, the same on every rank. The frozen
reference is laid out like the policy, never as a replicated copy.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubedl_tpu_torch.models import llama

NEG_INF = -1e30


def _target_logprobs_chunked(x, params, config: llama.LlamaConfig, targets):
    """log p(targets) at each position without [.., V] logits: an online
    logsumexp over `config.ce_chunks` vocabulary chunks (ceil-sized, the
    last one short) and an in-chunk gather of the target's logit. x [n, t,
    d] comes before the final norm; targets [n, t]."""
    head = llama._head_matrix(params, config)  # [d, V]
    x = llama.rms_norm(x, params["final_norm"], config.rms_eps, config.norm_offset)
    v = head.shape[1]
    csize = -(-v // config.ce_chunks)
    targets = targets.long()

    def stats(h_c, lo: int, m):
        """(new running max, the chunk's sum of exponentials under it,
        whether the target is in the chunk, the target's logit there)."""
        logits = (x @ h_c.to(x.dtype)).float()
        if config.final_logit_softcap:
            # elementwise, so capping a chunk caps the full logits: the
            # distribution the decode stack samples from
            logits = llama.softcap(logits, config.final_logit_softcap)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        idx = targets - lo
        inside = (idx >= 0) & (idx < h_c.shape[1])
        picked = torch.gather(logits, -1, idx.clamp(0, h_c.shape[1] - 1)[..., None])[..., 0]
        return m_new, torch.exp(logits - m_new[..., None]).sum(dim=-1), inside, picked

    m = torch.full(targets.shape, NEG_INF, dtype=torch.float32, device=x.device)
    s = torch.zeros(targets.shape, dtype=torch.float32, device=x.device)
    tgt = torch.zeros(targets.shape, dtype=torch.float32, device=x.device)
    for lo in range(0, v, csize):
        h_c = head[:, lo:lo + csize]
        if torch.is_grad_enabled():
            m_new, part, inside, picked = checkpoint(stats, h_c, lo, m, use_reentrant=False)
        else:
            m_new, part, inside, picked = stats(h_c, lo, m)
        s = s * torch.exp(m - m_new) + part
        m = m_new
        tgt = torch.where(inside, picked, tgt)
    return tgt - (m + torch.log(s))


def sequence_logprobs(params: Dict, tokens, prompt_lens, seq_lens, config: llama.LlamaConfig,
                      mesh=None, rules=None, with_aux: bool = False, per_token: bool = False):
    """Sum of log p(token_i | <i) over the continuation positions: [n] f32
    (and the MoE aux loss with `with_aux`). tokens [n, T], prompt_lens [n]
    (the continuation starts there), seq_lens [n] (true lengths, prompt
    included); with a mesh, this rank's rows. per_token=True returns ([n,
    T-1] logprobs, [n, T-1] f32 continuation mask) instead of the sum, as
    GRPO's per-token ratios need."""
    return _sequence_logprobs(params, tokens, prompt_lens, seq_lens, config,
                              llama._par(mesh, rules, config), with_aux, per_token)


def _sequence_logprobs(params, tokens, prompt_lens, seq_lens, config: llama.LlamaConfig,
                       par, with_aux: bool = False, per_token: bool = False):
    if par is not None and par.n_ctx > 1:
        raise NotImplementedError(
            f"a mesh context axis ({par.n_ctx}) in sequence log-probs is not ported to "
            f"kubedl_tpu_torch yet (ROADMAP.md)")
    x, aux = llama._backbone(params, tokens, config, par)
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    head = llama._local_head(params, par)
    targets = tokens[:, 1:]
    chunked = config.ce_chunks > 1 and torch.is_tensor(llama._head_matrix(head, config))
    if chunked and par is not None and par.n_tp > 1:
        llama._warn_ce_chunks_ignored(par.n_tp)
        chunked = False
    if chunked:
        pred = _target_logprobs_chunked(x[:, :-1], head, config, targets)
    elif par is not None and par.n_tp > 1:
        logits = llama._lm_head(x[:, :-1], head, config, par)
        pred = llama.sharded_target_logprobs(logits, targets, par)
    else:
        logps = torch.log_softmax(llama._lm_head(x, head, config, par).float(), dim=-1)
        pred = torch.gather(logps[:, :-1], -1, targets.long()[..., None])[..., 0]
    pos = torch.arange(tokens.shape[1] - 1, device=tokens.device)[None, :]
    # the target at position i + 1 is the continuation's when
    # prompt_len <= i + 1 < seq_len
    mask = (pos + 1 >= prompt_lens[:, None]) & (pos + 1 < seq_lens[:, None])
    if per_token:
        out = (pred, mask.float())
    else:
        out = (pred * mask).sum(dim=-1)
    return (out, aux) if with_aux else out


def _pair_logprobs(params: Dict, tokens, prompt_lens, seq_lens, config: llama.LlamaConfig,
                   par=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """([b, 2] continuation logprobs, MoE aux loss): the one place the [b, 2,
    T] pair layout becomes [2b, T]; policy and reference share it, so chosen
    and rejected cannot misalign."""
    b, _, t = tokens.shape
    lp, aux = _sequence_logprobs(params, tokens.reshape(b * 2, t),
                                 prompt_lens.repeat_interleave(2), seq_lens.reshape(-1),
                                 config, par, with_aux=True)
    return lp.reshape(b, 2), aux


def _global_mean(x, par):
    """The global batch's mean of a per-rank mean over equal token blocks."""
    return x if par is None else par.mean_over_tokens(x)


def dpo_loss(params: Dict, ref_logprobs, tokens, prompt_lens, seq_lens,
             config: llama.LlamaConfig, beta: float = 0.1, mesh=None, rules=None):
    """(loss, metrics): the implicit reward margin, the preference accuracy
    and the mean chosen and rejected logprobs, 0-d tensors. With a mesh the
    batch is this rank's pairs (every token block holds as many), and the
    loss and metrics are the global batch's means."""
    par = llama._par(mesh, rules, config)
    lp, aux = _pair_logprobs(params, tokens, prompt_lens, seq_lens, config, par)
    pi_ratio = lp[:, 0] - lp[:, 1]
    ref_ratio = ref_logprobs[:, 0] - ref_logprobs[:, 1]
    margin = beta * (pi_ratio - ref_ratio)
    loss = _global_mean((-F.logsigmoid(margin)).mean(), par)
    if config.n_experts > 0:
        # the router's balance term, as in pretraining: dropping it for a
        # whole DPO phase invites expert collapse
        loss = loss + config.moe_aux_coef * aux
    with torch.no_grad():
        metrics = {
            "reward_margin": _global_mean(margin.mean(), par),
            "preference_accuracy": _global_mean((margin > 0).float().mean(), par),
            "chosen_logprob": _global_mean(lp[:, 0].mean(), par),
            "rejected_logprob": _global_mean(lp[:, 1].mean(), par),
        }
    return loss, metrics


def make_dpo_step(ref_params: Dict, config: llama.LlamaConfig, tx, mesh=None, rules=None,
                  beta: float = 0.1, param_spec_tree=None, accum_steps: int = 1):
    """(init_state, ref_logprob_fn, dpo_step). The reference is a detached
    copy of `ref_params` taken here, so `init_state(ref_params)` may train
    the tree it was given; with a mesh it is laid out by `param_spec_tree`
    (default `llama.param_specs(config, rules)`), as the policy is.
    ref_logprob_fn((tokens, prompt_lens, seq_lens)) -> [b, 2] runs the
    frozen reference without autograd on this rank's pairs;
    dpo_step(state, (tokens, prompt_lens, seq_lens, ref_logprobs)) ->
    (state, {"loss", "grad_norm", **metrics}) is make_train_step's
    update."""
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, shard_tree
    from kubedl_tpu_torch.parallel.train_step import make_train_step

    ref = llama.tree_map(lambda t: t.detach().clone(), ref_params)
    if mesh is not None:
        rules = rules or ShardingRules()
        if param_spec_tree is None:
            param_spec_tree = llama.param_specs(config, rules)
        # sharded like the policy: a replicated copy would hold the whole
        # tree on every rank, at exactly the scales DPO shards for
        ref = shard_tree(ref, mesh, param_spec_tree)

    def ref_logprob_fn(batch):
        tokens, prompt_lens, seq_lens = batch
        with torch.no_grad():
            return _pair_logprobs(ref, tokens, prompt_lens, seq_lens, config,
                                  llama._par(mesh, rules, config))[0]

    def loss_fn(params, batch):
        tokens, prompt_lens, seq_lens, ref_lp = batch
        return dpo_loss(params, ref_lp, tokens, prompt_lens, seq_lens, config, beta=beta,
                        mesh=mesh, rules=rules)

    init_state, train_step = make_train_step(loss_fn, tx, mesh, param_spec_tree,
                                             accum_steps=accum_steps, has_aux=True, rules=rules)
    return init_state, ref_logprob_fn, train_step
