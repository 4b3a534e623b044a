"""MPMD pipeline stage runtime -- a stage-local train step under a 1F1B
schedule, joined by the serialized boundary (parallel/pipeline_mpmd.py);
the port of kubedl_tpu/train/pipeline_runtime.py.

Each StageRuntime is ONE program owning one layer chunk and its optimizer
state. Per microbatch it runs an explicit forward (send the activation
downstream) and an explicit backward (receive the activation-gradient,
recompute the stage forward from the stashed input, backpropagate, send
the input-gradient upstream), so live activations are bounded by the
IN-FLIGHT microbatches of the 1F1B schedule (<= S - stage a stage), not
all M: a stage keeps only each in-flight microbatch's INPUT, and its
forward pass runs without autograd.

Schedule (plain 1F1B): stage s runs warmup = min(S - 1 - s, M) forwards,
then alternates one forward and one backward, then drains the remaining
backwards; the last stage runs each microbatch's forward and backward as
one pass (loss and gradients together). Sends are async and double
buffered and receives prefetched (AsyncSender / Prefetcher), so stage s
computes microbatch i while its send of i-1 and its receive of i+1 are in
flight.

Math (the single-program pipeline's, models/llama.py `loss_fn_pp`): the
microbatch objective is L_i = CE_i/M + coef * aux_i/M, where aux_i sums
every stage's MoE aux for that microbatch (the value rides the boundary
header; its cotangent is the constant coef/M, applied at each stage to
its own aux), so sum_i L_i is the pipelined loss and the accumulated
per-stage gradients are the sliced whole-model gradients.

On the card an activation leaves through a host copy made by the compute
thread after the work that wrote it (`encode_boundary` copies to the
host), and a received gradient comes back in its activation's dtype.

Every boundary message carries the sender's incarnation id: a receiver
latches its peer's id and refuses a change loudly. It also carries
``"stop": true`` once any stage asked to stop in this step
(`request_stop`, e.g. on SIGTERM), and `run_step` reports whether any
stage did: every stage learns it within the same step, so the stages of a
preempted pipeline checkpoint the same step.

A stage spanning several devices (the reference's `mesh` argument) needs
one process a device and a process group a stage; it is refused here
(ROADMAP.md, item 12e).
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.parallel import pipeline
from kubedl_tpu_torch.parallel.mesh import ShardingRules
from kubedl_tpu_torch.parallel.pipeline_mpmd import (
    AsyncSender,
    Prefetcher,
    TIED_REFUSED,
    QueueChannel,
    StagePlan,
    decode_boundary,
    encode_boundary,
    make_stage_plan,
    split_stage_params,
)

MESH_REFUSED = ("a stage spanning several devices (mesh=...) needs one process a device "
                "and a process group a stage, which kubedl_tpu_torch does not run yet "
                "(ROADMAP.md, item 12e)")


def init_stage_params(config: llama.LlamaConfig, plan: StagePlan, stage: int,
                      generator: Optional[torch.Generator] = None, device="cuda") -> Dict:
    """This stage's part of `llama.init(config, generator, device)`, bit for
    bit: the same draws in the same order (the layers, then the embedding,
    then the LM head), each layer drawn and dropped unless the stage owns
    it, so a stage never holds the rest of the model."""
    from kubedl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    lo, hi = plan.layer_range(stage)
    first, last = stage == 0, stage == plan.n_stages - 1
    # the endcaps come after every layer's draws
    n_draw = config.n_layers if first or last else hi
    out: Dict = {"layers": []}
    for i in range(n_draw):
        layer = llama.init_layer(config, generator, dev)
        if lo <= i < hi:
            out["layers"].append(layer)
        del layer
    d = config.d_model
    if first or last:
        embed = llama._dense((config.vocab_size, d), d, config.dtype, generator, dev)
        if first:
            out["embed"] = embed
        del embed
    if last:
        if config.tie_embeddings:
            raise ValueError(TIED_REFUSED)
        out["final_norm"] = llama._norm(config, dev)
        out["lm_head"] = llama._dense((d, config.vocab_size), d, config.dtype, generator, dev)
    return out


def _like(tree, leaves):
    """`leaves` (in llama.tree_leaves order) laid out as `tree`."""
    it = iter(leaves)
    return llama.tree_map(lambda _: next(it), tree)


class StageRuntime:
    """One MPMD pipeline stage: local params + optimizer, the forward and
    backward passes, and the 1F1B loop (`run_step`).

    `act_in`/`grad_out` face the previous stage, `act_out`/`grad_in` the
    next; stage 0 leaves the former None, the last stage the latter. The
    stage runs on the device its parameters lie on; `tx` is a
    parallel/optim.py transform."""

    def __init__(
        self,
        stage: int,
        plan: StagePlan,
        config: llama.LlamaConfig,
        stage_params: Dict,
        tx,
        *,
        act_in=None,
        act_out=None,
        grad_in=None,
        grad_out=None,
        mesh=None,
        rules: Optional[ShardingRules] = None,
        recv_timeout: float = 60.0,
    ) -> None:
        if mesh is not None:
            raise NotImplementedError(MESH_REFUSED)
        self.stage = stage
        self.plan = plan
        self.config = config
        self.tx = tx
        self.rules = rules or ShardingRules()
        self._recv_timeout = recv_timeout
        self._step = 0
        # incarnation id, stamped on every boundary message: a receiver
        # latches its peer's id and REFUSES a change, so data a crashed
        # earlier incarnation left on a durable transport is never read as
        # current activations or gradients (it fails loud and retryable)
        self.boot_id = uuid.uuid4().hex[:12]
        self._peer_boot: Dict[int, str] = {}
        self.transport_plane = None  # socket mode: closed with close()
        self.request_stop = False    # latched at the start of each step
        self._stop = False
        self.last_loss: Optional[float] = None
        # the last step's gradients: the leaves' .grad, zeroed and refilled
        # by the next step
        self.last_grads: Optional[Dict] = None
        self.stats: Dict[str, float] = {
            "steps": 0, "sent_bytes": 0, "recv_bytes": 0, "step_s": 0.0, "wait_s": 0.0}
        self.params = stage_params
        leaves = self._leaves()
        for p in leaves:
            if p.is_floating_point():
                p.requires_grad_(True)
        self.device = leaves[0].device
        self.opt_state = tx.init(leaves)

        self._senders: List[AsyncSender] = []
        self._rx: List[Prefetcher] = []
        self._act_tx = self._wrap_sender(act_out)
        self._grad_tx = self._wrap_sender(grad_out)
        self._act_rx = self._wrap_rx(act_in)
        self._grad_rx = self._wrap_rx(grad_in)

    def _leaves(self) -> List[torch.Tensor]:
        return list(llama.tree_leaves(self.params))

    def _wrap_sender(self, channel):
        if channel is None:
            return None
        s = AsyncSender(channel)
        self._senders.append(s)
        return s

    def _wrap_rx(self, channel):
        if channel is None:
            return None
        r = Prefetcher(channel, timeout=self._recv_timeout)
        self._rx.append(r)
        return r

    # -- the stage's passes ----------------------------------------------

    def _forward(self, x):
        """The stage's layers (the embedding first on stage 0): (act, aux of
        this stage's layers; 0.0 when dense). Each layer under remat when
        autograd records and config.remat asks for it."""
        config = self.config
        if self.stage == 0:
            x = llama._embed(self.params, x, config)
        layer_fn = llama.pipeline_layer_fn(config, x.shape[1], self.rules)
        if config.remat and torch.is_grad_enabled():
            layer_fn = llama._remat(layer_fn, config.remat_policy)
        aux = 0.0
        for layer in self.params["layers"]:
            x, da = layer_fn(x, layer)
            aux = aux + da
        return x, aux

    def _loss(self, x, targets, aux_up: float):
        """The last stage's microbatch objective CE/M + coef*(aux + aux_up)/M."""
        c, m = self.config, self.plan.n_microbatches
        x, aux = self._forward(x)
        ce = llama._next_token_ce(llama._lm_head(x, self.params, c), targets)
        return ce / m + c.moe_aux_coef * (aux + aux_up) / m

    def _backward(self, outputs, cotangents, x):
        """Accumulate the gradients of `outputs` into the leaves' ``.grad``
        (in place, a leaf at a time, so no second whole-stage gradient tree
        is ever live); returns x's gradient when x is an activation."""
        inputs = self._leaves() + ([x] if x.requires_grad else [])
        torch.autograd.backward(outputs, cotangents, inputs=inputs)
        return x.grad if x.requires_grad else None

    # -- wire helpers ------------------------------------------------------

    def _meta(self, **kw) -> Dict:
        meta = dict(kw, boot=self.boot_id)
        if self._stop:
            meta["stop"] = True
        return meta

    def _send_act(self, step: int, mb: int, act, aux_val: float) -> None:
        data = encode_boundary([act], meta=self._meta(mb=mb, aux=float(aux_val)))
        self._act_tx.send(f"a{step}.{mb}", data)

    def _send_grad(self, step: int, mb: int, g) -> None:
        data = encode_boundary([g], meta=self._meta(mb=mb))
        self._grad_tx.send(f"g{step}.{mb}", data)

    def _recv(self, rx: Prefetcher, tag: str):
        t0 = time.perf_counter()
        data = rx.get(tag)
        self.stats["wait_s"] += time.perf_counter() - t0
        arrays, meta = decode_boundary(data)
        # incarnation guard (see boot_id): the peer's id never changes
        # mid-run -- a change means this message and the latched one
        # straddle a peer restart, i.e. one of them is stale
        boot = meta.get("boot", "")
        latched = self._peer_boot.setdefault(id(rx), boot)
        if boot != latched:
            raise RuntimeError(
                f"stage {self.stage}: boundary message {tag!r} carries "
                f"peer incarnation {boot!r} != latched {latched!r} — a "
                f"neighbor restarted (or stale pre-crash messages are "
                f"draining); exiting for a clean gang restart")
        self._stop = self._stop or bool(meta.get("stop", False))
        return arrays, meta

    def _recv_act(self, step: int, i: int):
        """(activation on this stage's device, the upstream aux)."""
        (arr,), meta = self._recv(self._act_rx, f"a{step}.{i}")
        return arr.to(self.device, self.config.dtype, copy=True), float(meta.get("aux", 0.0))

    def _recv_grad(self, step: int, i: int) -> torch.Tensor:
        """The activation-gradient of microbatch i, in the activation's dtype."""
        (arr,), _ = self._recv(self._grad_rx, f"g{step}.{i}")
        return arr.to(self.device, self.config.dtype, copy=True)

    # -- the 1F1B loop -----------------------------------------------------

    def run_step(self, tokens: Optional[Union[np.ndarray, torch.Tensor]] = None) -> Dict:
        """One optimizer step over M microbatches. `tokens` [B, T] is needed
        on the FIRST stage (inputs) and the LAST stage (targets) -- both
        run the data loader, the middle stages never see data. Returns
        stage-local metrics; the loss is reported by the last stage (None
        elsewhere); "stop" is whether any stage asked to stop. The byte
        counts and "send_s" (the sender threads' seconds in the channels'
        send) add up over the runtime's steps."""
        plan, stage, config = self.plan, self.stage, self.config
        S, M = plan.n_stages, plan.n_microbatches
        first, last = stage == 0, stage == S - 1
        self._step += 1
        step = self._step
        self._stop = bool(self.request_stop)
        t_start = time.perf_counter()
        self.stats["wait_s"] = 0.0

        inputs = targets = None
        if first or last:
            if tokens is None:
                raise ValueError(f"stage {stage} (an endpoint) needs the token batch")
            tokens = torch.as_tensor(tokens).to(self.device)
            if tokens.shape[0] % M:
                raise ValueError(
                    f"batch {tokens.shape[0]} not divisible by {M} microbatches")
        if first:
            inputs = pipeline.microbatch(tokens[:, :-1], M)
        if last:
            targets = pipeline.microbatch(tokens[:, 1:], M)

        if self._act_rx is not None:
            self._act_rx.expect([f"a{step}.{i}" for i in range(M)])
        if self._grad_rx is not None:
            self._grad_rx.expect([f"g{step}.{i}" for i in range(M)])

        for p in self._leaves():  # the step's gradients accumulate from 0
            if p.grad is not None:
                p.grad.zero_()
        loss_total = 0.0
        stash: Dict[int, torch.Tensor] = {}
        aux_cot = config.moe_aux_coef / M

        def fwd_in(i):
            """This stage's forward input for microbatch i (+ upstream aux)."""
            if first:
                return inputs[i], 0.0
            return self._recv_act(step, i)

        def do_forward(i):
            nonlocal loss_total
            x, aux_up = fwd_in(i)
            if last:
                # forward and backward in one pass: the loss, the parameter
                # gradients and the upstream gradient -- the last stage
                # never stashes activations
                with torch.enable_grad():
                    if not first:
                        x.requires_grad_(True)
                    loss_i = self._loss(x, targets[i], aux_up)
                    gx = self._backward([loss_i], None, x)
                if not first:
                    self._send_grad(step, i, gx)
                loss_total += float(loss_i.detach())
                return
            with torch.no_grad():
                act, aux = self._forward(x)
            stash[i] = x
            self._send_act(step, i, act, aux_up + float(aux))

        def do_backward(i):
            g = self._recv_grad(step, i)
            x = stash.pop(i)
            with torch.enable_grad():
                # stage-level remat: recompute the forward from the stashed
                # INPUT, then backpropagate -- only inputs stay live
                if not first:
                    x.requires_grad_(True)
                act, aux = self._forward(x)
                outs, cots = [act], [g]
                if torch.is_tensor(aux) and aux.requires_grad:
                    outs.append(aux)
                    cots.append(torch.full_like(aux, aux_cot))
                gx = self._backward(outs, cots, x)
            if not first:
                self._send_grad(step, i, gx)

        if last:
            for i in range(M):
                do_forward(i)
        else:
            warmup = min(S - 1 - stage, M)
            for i in range(warmup):
                do_forward(i)
            for k in range(M - warmup):
                do_forward(warmup + k)  # one forward...
                do_backward(k)          # ...one backward
            for k in range(max(M - warmup, 0), M):
                do_backward(k)

        assert not stash, f"stage {stage}: {len(stash)} unconsumed stashes"
        leaves = self._leaves()
        for p in leaves:  # a leaf no microbatch reached
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in leaves]
        self.last_grads = _like(self.params, grads)
        self.tx.apply(leaves, grads, self.opt_state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for s in self._senders:
            s.flush()

        self.last_loss = loss_total if last else None
        step_s = time.perf_counter() - t_start
        self.stats["steps"] += 1
        self.stats["step_s"] = step_s
        self.stats["sent_bytes"] = sum(s.sent_bytes for s in self._senders)
        self.stats["recv_bytes"] = sum(r.recv_bytes for r in self._rx)
        return {
            "stage": stage,
            "loss": self.last_loss,
            "step_s": step_s,
            "wait_s": self.stats["wait_s"],
            "sent_bytes": self.stats["sent_bytes"],
            "recv_bytes": self.stats["recv_bytes"],
            "send_s": sum(s.send_s for s in self._senders),
            "stop": self._stop,
        }

    def close(self) -> None:
        for s in self._senders:
            s.close()
        for r in self._rx:
            r.close()
        if self.transport_plane is not None:
            self.transport_plane.close()


class MPMDPipeline:
    """In-process MPMD harness: S stage programs joined by QueueChannels,
    each driven on its own thread -- the local lane of the pipeline, for
    the parity tests and chip_smoke.py. Every boundary crossing is
    SERIALIZED (the wire discipline) even in-process."""

    def __init__(
        self,
        config: llama.LlamaConfig,
        params: Dict,
        tx,
        *,
        n_stages: int,
        n_microbatches: int,
        meshes: Optional[List] = None,
        rules: Optional[ShardingRules] = None,
        recv_timeout: float = 60.0,
    ) -> None:
        self.plan = make_stage_plan(config.n_layers, n_stages, n_microbatches)
        self.config = config
        if meshes is not None:
            if len(meshes) != n_stages:
                raise ValueError(
                    f"need one mesh per stage, got {len(meshes)} for {n_stages}")
            raise NotImplementedError(MESH_REFUSED)
        act_ch = [QueueChannel() for _ in range(n_stages - 1)]
        grad_ch = [QueueChannel() for _ in range(n_stages - 1)]
        self.stages: List[StageRuntime] = []
        for s in range(n_stages):
            self.stages.append(StageRuntime(
                s, self.plan, config, split_stage_params(params, self.plan, s), tx,
                act_in=act_ch[s - 1] if s > 0 else None,
                act_out=act_ch[s] if s < n_stages - 1 else None,
                grad_in=grad_ch[s] if s < n_stages - 1 else None,
                grad_out=grad_ch[s - 1] if s > 0 else None,
                rules=rules,
                recv_timeout=recv_timeout,
            ))

    def step(self, tokens) -> Dict:
        """One synchronized train step across every stage program; the
        stages run concurrently on their own threads (the processes of a
        real deployment) and meet only at the boundary channels."""
        S = self.plan.n_stages
        results: List[Optional[Dict]] = [None] * S
        errors: List[BaseException] = []

        def run(s: int) -> None:
            try:
                need_tokens = s == 0 or s == S - 1
                results[s] = self.stages[s].run_step(tokens if need_tokens else None)
            except BaseException as e:  # noqa: BLE001 -- surfaced below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(s,)) for s in range(S)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            # a stage's receive timeout is usually the SECONDARY symptom of
            # a neighbor dying first (stale incarnation, a poisoned message):
            # surface the root cause, not the timeout that followed it
            def _is_timeout(e: BaseException) -> bool:
                seen = 0
                while e is not None and seen < 8:
                    if isinstance(e, TimeoutError):
                        return True
                    e = e.__cause__
                    seen += 1
                return False

            raise next((e for e in errors if not _is_timeout(e)), errors[0])
        return {
            "loss": results[S - 1]["loss"],
            "stage_step_s": [r["step_s"] for r in results],
            "stage_wait_s": [r["wait_s"] for r in results],
            "serialized_bytes": sum(r["sent_bytes"] for r in results),
            "bubble_frac_analytic": pipeline.bubble_fraction(
                self.plan.n_microbatches, S, 1),
        }

    def close(self) -> None:
        for s in self.stages:
            s.close()


def runtime_from_env(
    config: llama.LlamaConfig,
    params: Union[Dict, Callable[[StagePlan, int], Dict]],
    tx,
    *,
    mesh=None,
    rules: Optional[ShardingRules] = None,
    env: Optional[Dict[str, str]] = None,
    started_at: Optional[float] = None,
) -> StageRuntime:
    """THIS pod's stage runtime from the operator-injected KUBEDL_PP_*
    environment: the stage id, the shape knobs and the boundary transport.
    ``KUBEDL_TRANSPORT=socket`` runs the edges over the authenticated socket
    plane (transport/plane.py), dialing ``KUBEDL_PP_PREV_ADDR`` /
    ``KUBEDL_PP_NEXT_ADDR`` and listening on ``KUBEDL_TRANSPORT_BIND``; the
    default rides DirChannel over the per-edge directories under
    ``KUBEDL_PP_BOUNDARY_DIR``, purging the ones this stage receives on of
    the messages written before `started_at` (the process's start, a
    time.time() value; None purges them all). The boundary bytes are the
    same on both.

    `params` is the whole model's tree, or a function (plan, stage) -> this
    stage's subtree (`init_stage_params`), so a process never holds the
    other stages' parameters."""
    import os

    from kubedl_tpu_torch.parallel.pipeline_mpmd import DirChannel

    if mesh is not None:
        raise NotImplementedError(MESH_REFUSED)
    env = os.environ if env is None else env
    stage = int(env.get("KUBEDL_PP_STAGE", "0"))
    n_stages = int(env.get("KUBEDL_PP_STAGES", "1"))
    n_micro = int(env.get("KUBEDL_PP_MICROBATCHES", str(n_stages)))
    plan = make_stage_plan(config.n_layers, n_stages, n_micro)

    def own_params():
        if callable(params):
            return params(plan, stage)
        return split_stage_params(params, plan, stage)

    if env.get("KUBEDL_TRANSPORT", "") == "socket" and n_stages > 1:
        from kubedl_tpu_torch.transport import plane_from_env

        prev = env.get("KUBEDL_PP_PREV_ADDR", "")
        next_ = env.get("KUBEDL_PP_NEXT_ADDR", "")
        if (stage > 0 and not prev) or (stage < n_stages - 1 and not next_):
            raise ValueError(
                "KUBEDL_TRANSPORT=socket needs KUBEDL_PP_PREV_ADDR/"
                "NEXT_ADDR for this stage's ring neighbors")
        # listen first: a neighbor may dial while this stage draws its init
        plane = plane_from_env(service=f"pp-stage-{stage}", env=env)
        try:
            stage_params = own_params()
        except BaseException:
            plane.close()
            raise
        # a fresh process's socket inboxes start empty (no durable backlog
        # to purge); a RESTARTED neighbor's stream is refused by the
        # plane's boot-id latch -- the same loud failure the DirChannel
        # purge and the meta guard give
        rt = StageRuntime(
            stage, plan, config, stage_params, tx,
            act_in=plane.channel(f"act{stage - 1}") if stage > 0 else None,
            act_out=(plane.channel(f"act{stage}", peer_addr=next_)
                     if stage < n_stages - 1 else None),
            grad_in=plane.channel(f"grad{stage}") if stage < n_stages - 1 else None,
            grad_out=(plane.channel(f"grad{stage - 1}", peer_addr=prev)
                      if stage > 0 else None),
            rules=rules,
        )
        rt.transport_plane = plane  # closed with the runtime
        return rt

    bdir = env.get("KUBEDL_PP_BOUNDARY_DIR", "")
    if n_stages > 1 and not bdir:
        raise ValueError(
            "KUBEDL_PP_BOUNDARY_DIR is required for a multi-stage MPMD "
            "pipeline on the dir transport (or set KUBEDL_TRANSPORT="
            "socket with neighbor addresses)")

    def edge(i: int, kind: str):
        return DirChannel(os.path.join(bdir, f"{kind}{i}"))

    act_in = edge(stage - 1, "act") if stage > 0 else None
    grad_in = edge(stage, "grad") if stage < n_stages - 1 else None
    # purge the dirs THIS stage receives on: a crashed earlier
    # incarnation's undelivered messages must not be replayed as current
    # data (tags restart from 1). Only messages from before this process
    # started go, so a peer that sent first keeps its message; one that
    # started much earlier degrades to a receive timeout -- loud and
    # retryable, never silent; the boot-id guard catches whatever slips
    # past the purge.
    for ch in (act_in, grad_in):
        if ch is not None:
            purged = ch.purge(started_at)
            if purged:
                print(f"stage {stage}: purged {purged} stale boundary "
                      f"message(s) from {ch.path}", flush=True)

    return StageRuntime(
        stage, plan, config, own_params(), tx,
        act_in=act_in,
        act_out=edge(stage, "act") if stage < n_stages - 1 else None,
        grad_in=grad_in,
        grad_out=edge(stage - 1, "grad") if stage > 0 else None,
        rules=rules,
    )
