"""Drive kubedl_tpu_torch's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases, each printing its own line of numbers:
  1. device and build: the card's name and power limit, the CUDA kernels
     built from ops/csrc/ in parallel, one nvcc a source (seconds,
     registers, spills; flash_fwd_sm90.cu, flash_bwd_sm90.cu and
     gmm_sm90.cu must show no spill and no wgmma wait that ptxas injected);
  2. the flash forward against its plain PyTorch version on the card, at
     the 7B prefill shapes, serving's short buckets and the variants the
     model can ask for (GQA, window, softcap, d=64, a long sequence) and
     phase 13's one-pass prefills (GQA with a window at S=8192, S=4096) and
     phase 15's Gemma-2-2B prefills at d 256 (GQA 8/4, softcap 50, window
     4096 at S=5000 where it binds, and the twin without the softcap) and
     phase 18's ViT-B/16 attention (not causal: b 128, 12 heads, S 197, d
     64, with a non-ragged twin at S 1024, d 128): the
     kernel kernel_source routes to (flash_fwd_sm90.cu at every head dim,
     its Fwd<256> geometry at d 256), rerun bit for bit, the mma.sync
     kernel of flash_fwd.cu at the same shape, and the library
     (scaled_dot_product_attention, or on the d 256 row of the kernels
     line flex_attention compiled with the softcap as its score_mod; the
     other softcap rows time no library call), each timed
     as device time (10 launches in a CUDA graph, median of 7 replays), the
     plain version and one whole wrapper call (CUDA events, median of 7
     after 2 warm-ups), beside the least time the card could take. On the
     softcap rows q is scaled x8 so that the scores reach the cap, and on
     every row with a softcap or a binding window the kernel run without
     it, and on a non-causal row the kernel run causal, must fail the check
     (a planted fault the check has to see);
  3. full-width, full-depth Llama-7B, fresh init on the card: one
     1000-token prefill through the kernel and through plain attention,
     last-token logits compared;
  4. the HTTP server (kubedl_tpu_torch.train.serve) in this process on a
     free port, 8 greedy requests (6 concurrent clients across buckets,
     then one batch of a prompt twice), every answer checked, launch
     counts checked against the prefill dispatches.
  2b. the backward kernels (dq, dkv) against the f32 plain backward at the
     7B training shapes and the variants (GQA, window, softcap, d=64,
     d=256, a long sequence, and phase 15c's Gemma-2-2B shape at d 256 with
     GQA 8/4 and softcap 50, the same with window 4096 at S=5000, and its
     twin without the softcap, and phase 2's two non-causal rows): the sources bwd_kernel_source routes each
     kernel to (flash_bwd_sm90.cu's dq and dkv at every head dim, its
     Dq256 and Dkv256 kernels at d 256) and flash_bwd.cu's mma.sync
     kernels at the same shape, each two
     launches bit-identical and timed as device time (CUDA graphs), beside
     one whole wrapper call of each, the plain version and the library
     (scaled_dot_product_attention's backward, or flex_attention's on the
     d 256 row of the kernels line: forward and backward less forward,
     device time; the other softcap and window rows time none); q scaled and the options dropped as in phase 2;
  5. gradients through the model at full width, 2 layers: loss_fn and
     every gradient through the kernels against plain attention, with the
     launch counts of full remat;
  6. the trainer (kubedl_tpu_torch.train.trainer) on full-width,
     full-depth Llama-7B in this process: 6 steps, losses and gradient
     norms finite, launch counts, step time, tokens/s, model FLOP share,
     peak memory, and one step under torch.profiler;
  7. the trainer's options (bench-1b: accumulation, chunked CE, "dots"
     remat, cosine schedule) and its preemption contract: a subprocess
     trainer SIGTERMed after its first checkpoint exits 113, and its rerun
     resumes from that checkpoint for 2 steps and exits 0. That contract,
     11c's and 19c's run right after phase 1, side by side, each in a
     thread of its own (each is tiny processes starting, a SIGTERM and a
     rerun, so side by side they take about the longest one's time), while
     the main thread compiles the flex_attention calls of phases 2 and 2b;
  2c. the grouped matmul kernels of gmm_sm90.cu (K6 and its
     transposed-weight use, K7 with f32 and bf16 output, K5 and K8 on bf16
     and int8 weights) against their plain versions at Mixtral-8x7B widths
     on tile maps from the real dispatch plan of seeded routing (training,
     prefill, decode, 512-row tiles, two experts unrouted), two launches of
     each bit-identical and K7's unrouted experts exactly zero, with
     kernel, plain and library (torch._grouped_mm) times beside the bound;
  8. MoE gradients at Mixtral width, 2 layers, b=2, S=1024: loss_fn and
     every gradient through the kernels against the same model with
     models/moe.py's grouped products pointed at the plain versions, and
     the launch counts of full remat;
  9. MoE training at Mixtral width, 4 of 32 layers: 6 steps of
     make_train_step with AdamW and clip 1.0 at b=4, 1024-token rows;
     losses, grad norms, step time, tokens/s, active-parameter FLOP share,
     peak memory, one profiled step;
  10. MoE serving, Mixtral-8x7B at full width and 8 of its 32 layers
     (MOE_SERVE_LAYERS) in int8, built layer by layer on the card: a 2-layer prefill through the kernels
     against the plain versions, then the serving engine (8 slots, 1024
     positions) answers 8 greedy requests and one prompt sent twice.
  11. the sharded slice, on a one-rank NCCL group formed by
     train/coordinator.py's rendezvous: (a) full-width, full-depth
     Llama-7B through make_train_step on a one-device DeviceMesh (the
     sharded code: DTensor leaves, local views, the sharded optimizer), 3
     steps at b=4 and 1024-token rows, in turns with the one-device step on
     the same init and batches (one device, sharded, sharded, one device);
     its first loss against the one-device loss, the flash launch counts
     against phase 6's (scaled to 3 steps), step time and peak memory beside the one-device
     step's and phase 6's; (b)
     the expert-parallel dropless body (models/moe.py
     `_dropless_mlp_sharded`) at Mixtral widths on a one-rank expert group,
     2 layers, b=2, S=1024, forward and backward against `_dropless_mlp`
     on the same inputs: routing exact, nothing dropped, outputs and
     gradients within phase 8's tolerance, K5, K6 and K7 launched; (c) the
     gang's preemption contract at `tiny` (cut from bench-1b to pay for
     phase 17; the trainer takes tiny, bench-1b or llama-7b, and the
     contract does not depend on the size): a subprocess trainer in a
     one-rank group, started through train/launch.py (one child for the
     one card), SIGTERMed at the launcher after its first sharded
     checkpoint: the child and the launcher exit 113, and the rerun
     resumes from it and exits 0 (run after phase 1, beside phase 7's
     contract);
  12. tensor-parallel serving and the int8 KV cache, in the same one-rank
     group: full-width Llama-7B at TP_LAYERS of its 32 layers (fresh init,
     bf16) on the
     serving engine with phase 4's traffic (8 slots, 1024 positions, 6
     prompts at once, then one prompt twice, 32 greedy tokens each), in
     turns one device, mesh, int8 KV, int8 KV, mesh, one device: (a) the
     parameters through shard_tree onto a {"tensor": 1} DeviceMesh into
     ServingEngine(mesh=...), the same tokens bit for bit and the same flash
     launches as the one-device engine, decode ms a tick and prompt tok/s
     beside it; (b) ServingEngine(kv_dtype="int8"): int8 cache leaves, the
     cache's bytes against the bf16 cache's, every request's first token
     equal to the bf16 run's, peak memory, decode ms a tick, and the share
     of greedy tokens that agree with the bf16 run. On the same mesh, each
     against the one-device engine bit for bit: (c) Mixtral-8x7B int8 at
     full width and MOE_TP_LAYERS of its 32 layers, built layer by layer as
     phase 10 builds it, quantized whole and then sharded, with phase 4's
     traffic in turns one device, mesh, mesh, one device: tokens, equal
     K5 and K8 launches, decode ms a tick; then its bf16 tree one turn
     each, through K5 and K6; (d) the serving features on
     the 7B tree: a FEAT_CHUNK_PROMPT-token prompt chunked at 256 while
     seven slots decode, then a 1,024-token registered prefix with suffix
     requests, a self-draft speculative engine (acceptance >=
     SELF_ACCEPT_MIN), and a ring cache at Mistral-7B widths (2 of 32
     layers) on a prompt past the 4,096 window.
  24. MoE int8 decode across ranks, a gloo pair on the card, started
     beside phase 12 and checked at its end: two processes of this script
     (--moe-pair-rank, hidden flags), Mixtral-8x7B widths, int8, 2 of 32
     layers (12c's seeded tree, quantized whole in each process), each
     running decode.generate on b 4 x 512 prompt tokens for 16 greedy
     tokens on {"tensor": 2} and then {"expert": 2}: both ranks' tokens
     equal, their first tokens one process's (12c's tree), teacher-forced
     one-process logits along a rank's tokens within LOGIT_TOL of its own,
     each rank's K5/K8 launches and local stack shapes as the mesh implies,
     and each rank's gang_report line.
  13. the serving features, after phase 12's group is gone: (a) Llama-7B
     on ServingEngine (8 slots, max_len 4096, buckets to 1024, chunks of
     256): a 3,840-token prompt chunk-prefills while seven slots decode;
     its first-token logits against a one-pass decode.prefill, and the
     longest gap between two tokens of a decoding slot against an engine
     whose buckets reach 4096; (b) the HTTP server: a 1,024-token prefix
     through POST /prefix, 8 requests naming it against the full prompts
     (first-token logits, greedy tokens, prefill time), the registered
     cache unchanged bit for bit; (c) the trainer trains and checkpoints
     bench-1b, serve --draft-model bench-1b --draft-checkpoint-path answers
     8 greedy requests (restored draft equal to the saved one, acceptance,
     agreement with the plain engine), plain and speculative engines in
     turns, the 7B drafting for itself (acceptance >= 0.9), the verify
     block against decode_step; (d) Mistral-7B-v0.1 widths at 8 of its
     32 layers (RING_LAYERS; 13e uses the same weights), max_len 8192:
     the default ring cache (4096 rows) against a full cache on a
     6,000-token prompt (tokens equal, logits of every sampling call, half
     the cache's bytes, peak memory); (e) generate(with_logprobs=True)
     against a teacher-forced forward's log_softmax at the chosen tokens
     (a tolerance that two wrong logprobs exceed) and against the same
     path's logits replayed. K1 must launch on
     a-d; its counts join the kernels line's launches_by_path. Every
     line carries nvidia-smi's name and power limit.
  14. LoRA, after phase 13: (a) the trainer at --lora-rank 16 on
     full-width, full-depth Llama-7B (6 steps, b=4, 1024-token rows,
     checkpoints, one profiled step): losses and grad norms finite, the
     adapter count, the optimizer state's bytes, K1/K2/K3 launches equal to
     phase 6's, the base unchanged bit for bit (init's draws replayed),
     the merge and the adapters' optimizer alone, then the LoRA step
     beside phase 6's full step on the same init, one turn each; (b) Llama-7B
     (full width, LORA_SERVING_LAYERS of its 32 layers, cut for phase 23) on
     ServingEngine with phase 4's traffic, two rank-16 adapters with noise
     in B registered: adapter-0 requests equal the no-adapter engine's
     tokens bit for bit (one turn each, decode ms a tick and kernels a
     tick beside), each adapter's first-token logits against an engine on the
     merged weights (LOGIT_TOL) and the share of greedy tokens that agree;
     (c) serve --adapter with (a)'s checkpoint and POST /adapter of it (ids
     1 and 2 give the same tokens), generate --lora-checkpoint-path against
     serve --lora-checkpoint-path on generate's prompts; (d) on that server
     at --decode-block 1, one stream: true request equal to the unstreamed
     answer, the gaps between its events (p50, p90, max), and GET /metrics
     against GET /stats. K1 launches of a-d and K2/K3 of (a) join the
     kernels line's launches_by_path.
  15. Gemma-2-2B from a local Hugging Face directory, after phase 14: (a)
     the published google/gemma-2-2b config.json (full width, G2_MAIN_LAYERS
     of its 26 layers, tie_word_embeddings left out as save_pretrained
     writes it) and seeded
     bf16 weights in two safetensors shards with an index, written by this
     script into build/chip_smoke/; models/import_hf.py load_hf onto the
     card, every leaf against the seeded tensor bit for bit, load seconds
     and bytes; a 5000-token prefill (past the sliding layers' 4096
     window) through flash_fwd_sm90.cu (d 256) against plain attention; (b)
     generate --hf-model, whose rows must not be degenerate (the seed's
     weight scales are chosen for that), then serve --hf-model with phase
     4's traffic and generate's prompts (a served row may leave
     generate's only where a teacher-forced prefill puts the two tokens'
     logits within phase 3's bound);
     where transformers imports, a word-level tokenizer saved into the
     directory serves a text, a messages, a string-stop and an SSE request;
     (c) trainer --hf-model, 4 steps at b=4, 1024-token rows, chunked CE
     over the 256000 vocabulary; (d) on 16a's directory (2 of 26 layers,
     cut from 26 to pay for phase 23), dpo --hf-model, 3 steps of 2
     pairs x 512 tokens from a seeded JSONL, and evaluate --hf-model on a
     seeded shard: phase 23's one-process baselines. The directories are
     removed after. K1 launches of a-d and K2/K3 of (c) and (d) are the
     kernels line's d 256 rows.
  16. RL, inside phase 15: (a) grpo --hf-model on
     Gemma-2-2B's config cut to 2 of its 26 layers (a directory of its
     own, seeded as phase 15's), 3 on-policy steps of 4 prompts x 8 samples x 32 new tokens (KL 0.04,
     lr 1e-4, reward_low_ids through --reward-module) with a checkpoint,
     then a resume to step 4 with 2 inner
     epochs on the rollout's behavior logprobs: losses, KL and grad norms
     finite, on-policy ratio exactly 1 and clip 0, step-1 KL <= 1e-3, the
     off-policy first-epoch ratio within LP_TOL of 1, the checkpoint
     generate reads equal to the state the resume restored bit for bit,
     K1/K2/K3 launches counted, rollout and learner seconds a step, peak
     memory; (b) on (a)'s directory, the lockstep RLFleet (1 actor, B 2, G 4,
     K 32, 2 learner steps) against the monolithic loop with the same seeds, run first and
     freed: losses and grad norms within 1e-5 relative (floor 1e-3),
     every grad norm above 0, no stale drop, the last weight
     record decoded against the learner's parameters bit for bit, publish
     seconds and GB/s; (c) rl_pod's learner and actor as two processes on
     the dir lane at bench-1b (head dim 128), 3 steps of B 4, G 4, K 32,
     maxWeightLag 1: both exit 0, 12 groups consumed, the actor ends on
     version 3. The launches of (a) and (b) join the d 256 rows as
     gemma2_grpo and gemma2_rl_fleet; phase 16's numbers are a JSON line
     of their own ({"rl": ...}) before the kernels line.
  17. the disaggregated serving plane (serving/) on the socket transport
     plane (transport/): (a) DisaggregatedEngine on full-width Llama-7B at
     DISAGG_LAYERS of its 32 layers (bf16, seeded) against the monolithic
     ServingEngine with phase 4's traffic in turns: tokens equal up to phase 15's near-tie
     rule, K1 launches equal, decode ms a tick and peak memory of both,
     the pool's stats; then 32 slots over the [8, 1024] cache's KV bytes
     in blocks, the most streams decoding at once against 8; (b), inside
     phase 15 on 16a's directory (2 of 26 layers): RolloutEngine on
     Gemma-2-2B with 16a's rollout shape, a cold and a warm wave of the same prompts in turns
     with decode.generate: behavior logprobs within LP_TOL of a
     teacher-forced sequence_logprobs, the pool's blocks at the tick
     (G prompt caches cold, one prompt's blocks a group warm), Fwd<256>
     launches; (c) one PrefillPod and two DecodePods on the 7B weights,
     every handoff serialized and carried over a SocketChannel pair of two
     TransportPlanes on 127.0.0.1, one decode pod drained mid-stream:
     tokens equal to (a)'s monolithic ones up to the near-tie rule, MB a
     handoff and MB/s of the hop; (d) 16c's pods over the socket plane
     with KUBEDL_RL_ENGINE=serving and 16c's checks (run inside
     phase 16's window, after 16c, beside phase 23's pairs). The launches of (a),
     (b) and (c) join the kernels line; phase 17's numbers are a JSON line
     of their own ({"disagg": ...}).
  18. the one-card workload programs: (a) ViT-B/16 (full width and depth,
     bf16, seeded): a forward and one step's gradients at b 128 through the
     non-causal flash kernels against use_flash=False on the same tree and
     batch (logits within LOGIT_TOL, every gradient within GRAD_TOL, 12
     launches of K1 a forward and of K1/K2/K3 a step), then train.vision
     --model vit-b16 --batch 128 --steps 10 (step ms, img/s, peak memory,
     the launch counts asserted); (b) train.sparse at the full
     FEATURE_DEFS vocabularies, batch 4096, hidden 512, 20 steps (step ms,
     lookups/s, peak), and a --vocab-scale 100 run on the card against
     the same run on the CPU (every loss within SPARSE_LOSS_TOL); (c)
     train.mnist --steps 200 --batch 256 (step/s, BASELINE.json's metric)
     and its losses against the same run on the CPU. The launches of (a)'s
     program run are the kernels line's non-causal rows; phase 18's numbers
     are a JSON line of their own ({"workloads": ...}).
  19. pipeline parallelism, the MPMD stage programs: (a) MPMDPipeline
     (two stage programs on QueueChannels, a thread each) at Llama-7B
     widths, 4 layers, bf16, b 4 x 1024, M 4, against loss_fn on the same
     parameters over the same four microbatches (loss within 1e-2
     relative, each stage's gradients within GRAD_TOL of the one-program
     gradients split by split_stage_params, K1/K2/K3 launches as
     `_pp_launches` derives them), and stage 0 on a zeroed received
     gradient, which must miss the check by more than 10x; (b) two
     pipeline_trainer processes on the card over DirChannel at full depth
     (16 layers a stage), 6 steps: both exit 0, losses finite, the first
     within 1.5 of ln 32000, launches summed over both as derived; step
     and wait of each stage, its boundary bytes and send MB/s, each process's
     peak; then the one-process trainer at the same depth, one turn each;
     (c) two tiny stage processes over the socket plane SIGTERMed: both
     exit 113 with a checkpoint at the same step, the rerun resumes it
     (run after phase 1, beside phase 7's contract). The
     SPMD stage axis above 1 needs several cards (the CPU gang holds it).
     The launches of (a) and (b) join the kernels line; phase 19's numbers
     are a JSON line of their own ({"pipeline": ...}).
  20. context parallelism: (a) two processes of this script share the card
     in a gloo group (printed; an nccl group fails the phase) whose mesh is
     {"context": 2} with device type cuda, at Llama-7B widths, 2 layers,
     bf16, full remat, b 1 x 4,097 seeded tokens (4,096 positions, 2,048 a
     rank). One value-and-grad step of loss_fn with context_parallel
     "ring" and one with "ulysses" against rank 0's one-process loss_fn on
     the whole sequence with the same weights: the loss within 1e-2
     relative, each position's loss within LOGIT_TOL of the max (phase 3's
     bound), layer 0's wq, wk and w2 gradients summed over the ranks
     within GRAD_TOL by relative norm; per strategy and rank the step ms
     (a second step), peak GB, the bytes staged through the host against
     the count the hops imply (equal), and the K1/K2/K3 launches: Ulysses
     2/1/1 a layer (forward and remat recompute), the ring none. The ring
     with every rank's offset set to 0 must miss the per-position bound.
     Ulysses' launches join the kernels line; phase 20's numbers are a JSON
     line of their own ({"context": ...}). Across cards (NCCL) the context
     axis is not run here: tests/test_torch_context.py holds it against
     JAX on a CPU gloo gang of 8.
  21. live reshard, a bench-1b gang (full width, RESHARD_LAYERS of its 16
     layers, bf16, full remat, AdamW; a Llama checkpoint directory of that
     config, seeded, which the trainer reads with --hf-model) resharded
     2 -> 1 -> 2 through the staging: (a) two
     processes of this script share the card in a gloo group (printed; an
     nccl group fails the phase), take two steps on {"data": 2} (b 2 x 1024
     a rank), print the sha256 of the whole state (gathered on the host),
     move it onto {"fsdp": 2} with reshard_state and stage its blocks for 1
     chip (refit_axes, plan_reshard, addressable_blocks, stage_shards,
     write_manifest); (b) the trainer entry point under train/launch.py (a
     one-rank NCCL group, --hf-model DIR --batch 4 --seq-len 1024,
     KUBEDL_LIVE_RESHARD=1) restores that staging, its sha256 equal to
     (a)'s, trains with finite and falling losses, answers a RESIZE to 2
     chips with "staged", stages and exits 113; (c) the pair fills a fresh
     state on the staging's {"data": 2} through restore_staged and
     state_from_staging, its sha256 equal to the trainer's, and one step's
     loss within RESHARD_LOSS_TOL of rank 0's one-process loss_fn; the
     staging's index with one member left out must raise the coverage
     PlanError, a marker with a changed digest must make restore_staged
     return None. Each hop prints its moved and local MB, stage, manifest
     and restore seconds, read MB/s, peak memory and K1/K2/K3 launches
     (asserted: 2 K1 a layer a step, K2 and K3 one). The launches join the
     kernels line; phase 21's numbers are a JSON line of their own
     ({"reshard": ...}). Across cards (NCCL) and over the socket fetch the
     reshard is not run here: tests/test_torch_reshard_trainer.py holds the
     sharded stagings on a CPU gloo gang.
  22. asynchronous checkpoints, the MNIST gang and the rendezvous smoke:
     (a) bench-1b (full width and depth, bf16, full remat, clip + AdamW, b 4
     x 1024) on the card through make_train_step and CheckpointManager:
     the state's GB and the host's MemTotal, the pinned buffers' one-time
     registration, an interval save's stall in the loop, the step beside
     its write against steps without one, the writer's seconds and GB/s,
     then the same save done synchronously (save and wait_until_finished);
     the published step reloaded must equal bit for bit the phase's own
     snapshot at that step after a step ran in place over the live state,
     and a planted manager that hands the writer the live tensors must
     fail that comparison; K1/K2/K3 launches (2/1/1 a layer a step) join
     the kernels line. (b) phases 7 and 11c (SIGTERM -> 113 -> resume, one
     device and sharded) and 16a run the asynchronous saves; 16a prints
     each (final) save's stall beside its write and fsync. (c) MNIST (phase 18c's flags) as two processes of the entry
     point sharing the card in a gloo group (--backend gloo: NCCL cannot
     hold two ranks on one device): both exit 0 with devices=2, every
     step's loss within MNIST_LOSS_TOL of one process on the same global
     batch; the rendezvous smoke (train/smoke_distributed.py) as two
     processes beside it: both exit 0 with psum=2.0. Phase 22's numbers are
     a JSON line of their own ({"async_checkpoints": ...}).
  23. post-training under a mesh, inside phase 15 on 16a's directory:
     each program as two processes of `python -m` sharing the card in a
     gloo group from the operator's env (--backend gloo; each rank's
     backend line printed, an nccl group fails the phase), started after
     16a, beside 16b, 16c and 17d (run in phase 16's window for that):
     (a) dpo on tensor=2, 15d's run with a sharded
     checkpoint: step 1's loss and margin within POST_LOSS_TOL of 15d's;
     (b) grpo on data=2, 16a's argv for POST_GRPO_STEPS steps with a
     sharded checkpoint, then a resume for one step more: step 1's
     rollout on both ranks equal to 16a's (a row may part only at a
     near-tie, phase 15's rule), its loss and grad norm within
     POST_LOSS_TOL of 16a's; (c) evaluate on tensor=2: tokens equal, nll
     within POST_NLL_TOL of 15d's. Every rank's K1/K2/K3 launches (d 256,
     on its local heads or rows) equal the counts the shapes imply and
     join the d 256 rows; each rank's step seconds beside one process's,
     its host-staged collectives (MB and seconds) and peak memory; a JSON
     line of their own ({"post_training": ...}).
Each phase prints its seconds. Then one JSON line of per-kernel numbers
and, last, the device line.
`--out PATH` also writes every number of the run to PATH as JSON. Any
failure raises; the script exits non-zero and prints no result. It needs a
CUDA device and the repository beside it.
"""
import argparse
import contextlib
import dataclasses
import gc
import glob
import hashlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
OUT_TOL, LSE_TOL = 2e-2, 1e-3
MODEL_PROMPT = 1000
SERVE_LENGTHS = (17, 100, 250, 513, 700, 992)  # + 32 new tokens <= max_len 1024
SERVE_NEW = 32
# the serving prefill cluster of the longest prompts: 4 rows padded to 1024
MAIN_SHAPE = "7b_b4_s1024"
# the training path's attention: --batch 4 --seq-len 1024 feeds tokens[:, :-1]
MAIN_BWD_SHAPE = "7b_b4_s1023"
MAIN_VIT = "vit_b16_s197"  # phase 18a's attention: the non-causal rows of phases 2 and 2b
MAIN_D256, MAIN_BWD_D256 = "gemma2_s1024", "gemma2_s1023"  # phase 15's shapes at d 256
# flex_attention, the library call of a softcap row, compiles its kernels
# for each row (15-35 s a row on the card): phases 2 and 2b time it on the
# d 256 rows of the kernels line only, compiled ahead beside the preemption
# contracts (_compile_flex); their other softcap and window rows time no
# library call
FLEX_SHAPES = {MAIN_D256: (4, 8, 4, 1024, 256, True, None, 50.0),
               MAIN_BWD_D256: (4, 8, 4, 1023, 256, True, None, 50.0)}
FLEX_ROWS = tuple(FLEX_SHAPES)
# the kernels phase 15 runs at d 256: K1, K2, K3
D256_NAMES = ("flash_fwd_sm90.cu", "flash_bwd_sm90.cu dq", "flash_bwd_sm90.cu dkv")
# phases 2 and 2b scale q by this on their softcap rows: at unit q and k the
# scaled scores are about N(0, 1), where 50 tanh(s / 50) differs from s by
# under 1e-2 and no tolerance would see a dropped softcap; x8 puts them near
# +-25, where the cap moves them by a tenth
SOFTCAP_Q_SCALE = 8.0
G2_PREFILL = 5000         # 15a's prompt: past the 4096 window of the sliding layers
BWD_TOL = 2e-2            # max|kernel - plain| / max|plain|, each of dq, dk, dv
GRAD_TOL = 5e-2           # phases 5 and 8, per gradient leaf (bf16 model, 2 layers)
GMM_TOL, TGMM_TOL = 2e-2, 1e-3  # max|kernel - plain| / max|plain|: bf16 out, f32 out
# phase 2c: (tokens routed top-2 of 8, experts that may take a row)
GMM_SHAPES = {
    "train_R8184": (4092, 8),       # b=4 rows of 1024, S=1023 after the shift
    "prefill_R8192": (4096, 8),     # the serving prefill cluster: 4 rows of 1024
    "decode_R16": (8, 8),           # one tick of 8 slots
    "tile512_R32768": (16384, 8),   # large enough for 512-row tiles
    "skewed_R8184": (4092, 6),      # two experts own no row
}
# the shape each kernel's JSON numbers come from: its main path's
MAIN_GMM = {"gmm_swiglu": "train_R8184", "gmm": "train_R8184", "tgmm": "train_R8184",
            "gmm_scaled": "decode_R16"}
# the case each kernel's JSON numbers come from: the training step's K7
# writes bf16 (the weights' dtype)
MAIN_CASE = {"gmm_swiglu": "gmm_swiglu", "gmm": "gmm", "tgmm": "tgmm_bf16",
             "gmm_scaled": "gmm_scaled"}
# each gmm kernel's place in a (K5, K6, K7, K8) launch count
MAIN_INDEX = {"gmm_swiglu": 0, "gmm": 1, "tgmm": 2, "gmm_scaled": 3}
SOURCES = ("flash_fwd_sm90", "flash_fwd", "flash_bwd_sm90", "flash_bwd", "gmm", "gmm_sm90")
# held to no spill and no injected wait
WGMMA_SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90", "gmm_sm90")
MOE_SERVE_LENGTHS = (17, 100, 250, 400, 513, 700, 850, 992)  # + 32 new <= 1024
# phase 10 serves Mixtral-8x7B int8 at 8 of its 32 layers (11.8 GB of the
# 46.86 GB tree; full depth until phase 21 came, which the cut pays for)
MOE_SERVE_LAYERS = 8
WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")


def _time_ms(fn, warmup=2, iters=7):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_ms(fn, reps=10, iters=7):
    """Device time of one call of fn: reps calls captured in a CUDA graph,
    replayed between CUDA events (median of iters); the host's cost of each
    call, which _time_ms includes when it exceeds the kernel's, is not."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def _attended_pairs(s, causal, window):
    """(query, key) pairs the masks keep: the work these inputs need."""
    if not causal:
        return s * s
    if window is None:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


_FLEX_FNS = {}


def _flex(s, causal, window, softcap, gqa):
    """torch's flex_attention, compiled, with the softcap as its score_mod
    and the causal or window mask as its block mask: one PyTorch call of
    the kernels' function where scaled_dot_product_attention has no
    softcap. Returns fn(q, k, v) -> (out, natural-log lse), one a row for
    the whole run, so that what _compile_flex compiled is what the phases
    call."""
    key = (s, causal, window, softcap, gqa)
    if key not in _FLEX_FNS:
        _FLEX_FNS[key] = _make_flex(*key)
    return _FLEX_FNS[key]


def _make_flex(s, causal, window, softcap, gqa):
    import torch._dynamo
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    import torch._inductor.config

    for knob in ("recompile_limit", "cache_size_limit"):  # a compile per row
        if hasattr(torch._dynamo.config, knob):
            setattr(torch._dynamo.config, knob, 64)
    # compile in this process: a pool of compile workers, each importing
    # torch first, takes longer to start than the few kernels take to build
    torch._inductor.config.compile_threads = 1

    def score_mod(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki
        if window is not None:
            keep = keep & (qi - ki < window)
        return keep

    block_mask = create_block_mask(mask_mod, None, None, s, s, device="cuda") if causal else None
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda q, k, v: flex(q, k, v, score_mod=None if softcap is None else score_mod,
                                block_mask=block_mask, enable_gqa=gqa, return_lse=True)


def _compile_flex():
    """FLEX_ROWS' library calls compiled ahead, called as phases 2 and 2b
    call them: phase 2's forward on inputs without grad; 2b's forward and
    backward on leaves that need grad, and its forward under no_grad. Twice:
    the first graph compiled guards on flex_attention's warn-once set, which
    its own first call changes, so the second round compiles it again and
    after that every call finds its graph."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in FLEX_ROWS * 2:
        b, hq, hkv, s, d, causal, window, softcap = FLEX_SHAPES[name]
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        q = q * SOFTCAP_Q_SCALE
        flex = _flex(s, causal, window, softcap, hq != hkv)
        if name == MAIN_D256:
            flex(q, k, v)
            continue
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        dout = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        torch.autograd.grad(flex(qg, kg, vg)[0], (qg, kg, vg), dout)
        with torch.no_grad():
            flex(qg, kg, vg)
    torch.cuda.synchronize()


def _dropped(s, window, softcap, causal=True):
    """The planted faults a check must see at this shape, as {name: the
    options changed}: the softcap dropped, the window dropped where it
    masks a key (window < s), and a non-causal shape run causal (the
    kernel ignoring its flag)."""
    faults = {}
    if softcap is not None:
        faults["softcap"] = {"softcap": None}
    if window is not None and window < s:
        faults["window"] = {"window": None}
    if not causal:
        faults["causal"] = {"causal": True}
    return faults


def _fault_label(opt):
    return "causal_on" if opt == "causal" else f"no_{opt}"


def phase_device():
    from kubedl_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {name} (count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda})", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    _build.build(*SOURCES)
    print(f"build: {len(SOURCES)} sources in {time.perf_counter() - t0:.2f} s (parallel nvcc)",
          flush=True)
    for src in SOURCES:
        print(f"build: {src}.cu in {_build.build_seconds[src]:.2f} s -> "
              f"{_build.library_path(src)}", flush=True)
        for line in _build.ptxas_report(src).splitlines():
            print(f"build:   {line}", flush=True)
    for src in WGMMA_SOURCES:
        report = _build.ptxas_report(src)
        spills = [ln for ln in report.splitlines()
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        if spills or "warpgroup.wait is injected" in report:
            raise AssertionError(f"{src}.cu: ptxas spilled or serialized wgmma:\n" + report)
    build = {src: dict(seconds=_build.build_seconds[src], ptxas=_build.ptxas_report(src))
             for src in SOURCES}
    return name, smi, build


def phase_kernels(only=None):
    """The flash forward vs its plain version on the card; returns {shape
    name: numbers}. `only`: the shape names to run (all by default)."""
    import torch.nn.functional as F

    from kubedl_tpu_torch.ops import flash_attention as fa

    # name: (b, hq, hkv, s, d, causal, window, softcap)
    shapes = {
        "7b_b8_s128": (8, 32, 32, 128, 128, True, None, None),    # serving's short buckets
        "7b_b8_s256": (8, 32, 32, 256, 128, True, None, None),
        "7b_b4_s512": (4, 32, 32, 512, 128, True, None, None),
        "7b_b4_s1000": (4, 32, 32, 1000, 128, True, None, None),
        MAIN_SHAPE: (4, 32, 32, 1024, 128, True, None, None),
        "7b_b4_s2048": (4, 32, 32, 2048, 128, True, None, None),
        "gqa_32q_8kv_s1024": (4, 32, 8, 1024, 128, True, None, None),
        "window256_s2048": (4, 32, 32, 2048, 128, True, 256, None),
        "softcap50_s1024": (4, 32, 32, 1024, 128, True, None, 50.0),
        "d64_s1024": (4, 32, 32, 1024, 64, True, None, None),
        "long_b1_h8_s8320": (1, 8, 8, 8320, 128, True, None, None),
        # phase 13's prefills: 13d's 6000-token prompt in the 8192 bucket
        # (Mistral-7B: GQA 32/8, window 4096), 13a's one-pass 3840 in 4096
        "mistral_w4096_s8192": (1, 32, 8, 8192, 128, True, 4096, None),
        "7b_b1_s4096": (1, 32, 32, 4096, 128, True, None, None),
        # phase 15's Gemma-2-2B (flash_fwd_sm90.cu's Fwd<256>): GQA 8/4, softcap 50;
        # 15a's prefill on the sliding layers, where the 4096 window binds;
        # the twin without the softcap that scaled_dot_product_attention takes
        MAIN_D256: FLEX_SHAPES[MAIN_D256],
        "gemma2_w4096_b1_s5000": (1, 8, 4, G2_PREFILL, 256, True, 4096, 50.0),
        "d256_gqa_s1024": (4, 8, 4, 1024, 256, True, None, None),
        # phase 18's ViT-B/16 (the one non-causal path): b 128, 12 heads of
        # 64, S 197 ragged inside 128-row items; and a non-ragged twin, so
        # that a fault shows whether it is the tail's or the flag's
        MAIN_VIT: (128, 12, 12, 197, 64, False, None, None),
        "noncausal_s1024": (4, 32, 32, 1024, 128, False, None, None),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, (b, hq, hkv, s, d, causal, window, softcap) in shapes.items():
        if only is not None and name not in only:
            continue
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        if softcap is not None:
            q = q * SOFTCAP_Q_SCALE
        kw = dict(causal=causal, window=window, softcap=softcap)
        source = fa.kernel_source(d)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        again, again_lse = fa.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        same = torch.equal(out, again) and torch.equal(lse, again_lse)
        del again, again_lse
        ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        out_err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all())
        # a planted fault: the kernel without one of its options must fail
        # the same check, or the check could not see that option dropped
        dropped = {}
        for opt, change in _dropped(s, window, softcap, causal).items():
            bad, bad_lse = fa.flash_attention_fwd(q, k, v, **dict(kw, **change))
            dropped[opt] = max((bad.float() - ref).abs().max().item() / OUT_TOL,
                               (bad_lse - ref_lse).abs().max().item() / LSE_TOL)
            del bad, bad_lse
            if dropped[opt] <= 1:
                raise AssertionError(f"phase 2 cannot see the planted fault {_fault_label(opt)} "
                                     f"at {name}: it reads {dropped[opt]:.3f} of the tolerance")
        library, library_err = "sdpa", None
        if softcap is not None and name not in FLEX_ROWS:
            library = None
        elif softcap is not None:
            library, flex = "flex_attention", _flex(s, causal, window, softcap, hq != hkv)
            lib_out, lib_lse = flex(q, k, v)
            library_err = (lib_out.float() - ref).abs().max().item()
            if library_err > OUT_TOL or (lib_lse - ref_lse).abs().max().item() > LSE_TOL:
                raise AssertionError(f"flex_attention does not compute the kernel's function at "
                                     f"{name}: out {library_err}")
            del lib_out, lib_lse
        mma_sync_ms = mma_sync_err = mma_sync_lse_err = None
        if source != fa.MMA_SYNC:  # the mma.sync kernel at the same shape, in the same run
            old, old_lse = fa.flash_attention_fwd(q, k, v, source=fa.MMA_SYNC, **kw)
            torch.cuda.synchronize()
            mma_sync_err = (old.float() - ref).abs().max().item()
            mma_sync_lse_err = (old_lse - ref_lse).abs().max().item()
            del old, old_lse
            mma_sync_ms = _graph_ms(lambda: fa.flash_attention_fwd(
                q, k, v, source=fa.MMA_SYNC, **kw))
        del ref, ref_lse
        kernel_ms = _graph_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw))
        wrapper_ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw))
        plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw))
        if library is None:
            library_ms = None
        elif softcap is None:  # scaled_dot_product_attention has no softcap
            mask = None
            if window is not None:
                mask = fa._mask(s, causal, window, q.device)
            library_ms = _graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=hq != hkv))
        else:
            library_ms = _graph_ms(lambda: flex(q, k, v))
        flops = 4 * b * hq * d * _attended_pairs(s, causal, window)
        nbytes = 2 * s * d * b * (2 * hq + 2 * hkv) + 4 * b * hq * s
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        r = dict(shape=[b, hq, hkv, s, d], causal=causal, window=window,
                 softcap=softcap, q_scale=SOFTCAP_Q_SCALE if softcap is not None else 1.0,
                 dropped_option_reads=dropped, library=library, library_out_err=library_err,
                 source=f"{source}.cu", out_max_abs_err=out_err,
                 lse_max_abs_err=lse_err, deterministic=same, kernel_ms=kernel_ms,
                 wrapper_ms=wrapper_ms,
                 mma_sync_ms=mma_sync_ms, mma_sync_err=mma_sync_err,
                 mma_sync_lse_err=mma_sync_lse_err,
                 speedup_vs_mma_sync=None if mma_sync_ms is None else mma_sync_ms / kernel_ms,
                 plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 share_of_bound=bound_ms / kernel_ms,
                 tflops=flops / kernel_ms / 1e9)
        results[name] = r
        lib = "not timed" if library is None else f"{library_ms:.4f} ({library})"
        old = "n/a" if mma_sync_ms is None else \
            f"{mma_sync_ms:.4f} (x{r['speedup_vs_mma_sync']:.2f}, err {mma_sync_err:.2e})"
        faults = "".join(f" {_fault_label(o)}_reads={x:.1f}xtol" for o, x in dropped.items())
        print(f"kernel {name} [{source}.cu]: kernel_ms={kernel_ms:.4f} "
              f"wrapper_ms={wrapper_ms:.4f} mma_sync_ms={old} plain_ms={plain_ms:.4f} "
              f"library_ms={lib} bound_ms={bound_ms:.4f} ({r['bound_by']}) "
              f"share={r['share_of_bound']:.3f} tflops={r['tflops']:.1f} "
              f"out_err={out_err:.3e} lse_err={lse_err:.3e} deterministic={same}{faults}",
              flush=True)
        if not finite or not same or out_err > OUT_TOL or lse_err > LSE_TOL:
            raise AssertionError(
                f"flash_fwd disagrees with its plain version at {name}: "
                f"finite={finite} deterministic={same} out_err={out_err} (tol {OUT_TOL}) "
                f"lse_err={lse_err} (tol {LSE_TOL})")
        if mma_sync_err is not None and (mma_sync_err > OUT_TOL or mma_sync_lse_err > LSE_TOL):
            raise AssertionError(f"the mma.sync forward disagrees at {name}: out "
                                 f"{mma_sync_err} lse {mma_sync_lse_err}")
        del q, k, v, out, lse
    return results


def phase_model():
    """7B prefill through the kernel vs through plain attention."""
    import dataclasses

    from kubedl_tpu_torch.models import decode, llama
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    config = llama.LlamaConfig.llama_7b()
    t0 = time.perf_counter()
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = llama.param_count(params)
    prompt = torch.randint(0, config.vocab_size, (1, MODEL_PROMPT),
                           generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda", dtype=torch.int32)
    out = {}
    for label, cfg in (("kernel", config),
                       ("plain", dataclasses.replace(config, use_flash=False))):
        for _ in range(2):  # the first call warms cuBLAS; the second is timed
            flash_attention.launches = 0
            cache = decode.init_kv_cache(cfg, 1, MODEL_PROMPT, uniform=True,
                                         device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = decode.prefill(params, prompt, cache, cfg)
            torch.cuda.synchronize()
            out[label] = (logits[0].float(), time.perf_counter() - t0,
                          flash_attention.launches)
            del cache
    (lk, tk, nk), (lp, tp, npl) = out["kernel"], out["plain"]
    if nk != config.n_layers or npl != 0:
        raise AssertionError(f"prefill launched the kernel {nk} times (expected "
                             f"{config.n_layers}), the plain path {npl} (expected 0)")
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("non-finite 7B logits")
    max_abs = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    ak, ap = int(lk.argmax()), int(lp.argmax())
    # a differing argmax passes only as a near-tie within the measured error
    tie_gap = (lp[ap] - lp[ak]).item()
    print(f"model: llama-7b {n_params / 1e9:.3f}B params, init {init_s:.2f} s; "
          f"prefill {MODEL_PROMPT} tokens kernel {tk * 1e3:.1f} ms "
          f"plain {tp * 1e3:.1f} ms (second calls); last-token logits "
          f"max_abs_diff={max_abs:.4e} (max |logit| {scale:.3f}, rel "
          f"{max_abs / scale:.3e}) argmax {ak} vs {ap} "
          f"{'agree' if ak == ap else f'gap {tie_gap:.3e}'}", flush=True)
    # bf16 activations through 32 layers: the kernel rounds p to bf16 before
    # p.v and sums in another order than the f32 plain attention
    if max_abs > 0.05 * scale or (ak != ap and tie_gap > max_abs):
        raise AssertionError("7B prefill through the kernel disagrees with "
                             "plain attention")
    del params
    torch.cuda.empty_cache()
    return dict(n_params=n_params, init_s=init_s, logits_max_abs=max_abs,
                logits_max=scale, argmax_agree=ak == ap)


def _post(base, body, timeout=600, path="/generate"):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _profile_engine(engine):
    """Where the serving time goes: one admission wave (8 prompts of 500
    tokens, one prefill) and 8 decode ticks of the full slot batch, each
    under torch.profiler. Device busy time is the union of the CUDA kernel
    intervals; idle share = 1 - busy / wall (the profiler's own host cost
    is inside wall, so idle is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = torch.Generator().manual_seed(3)
    for _ in range(engine.slots):
        engine.submit(torch.randint(1, 32000, (500,), generator=rng).tolist(), 9)
    out = {}
    for label, fn, ticks in (("prefill", engine._admit, 0),
                             ("decode", lambda: engine.step_block(8), 8)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy_us, end = 0.0, float("-inf")
        for r0, r1 in spans:  # union of kernel intervals
            start = max(r0, end)
            if r1 > start:
                busy_us += r1 - start
            end = max(end, r1)
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        out[label] = dict(
            wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
            idle_share=1 - busy_us / 1e3 / wall_ms if spans else None,
            kernels=len(spans), ticks=ticks,
            top=[(name[:60], us / 1e3) for name, us in top])
        share = "not measured" if not spans else f"{out[label]['idle_share']:.3f}"
        per = f", {len(spans) / ticks:.0f} kernels/tick" if ticks else ""
        print(f"profile {label}: wall {wall_ms:.1f} ms (profiled), device busy "
              f"{busy_us / 1e3:.1f} ms, idle share {share}, {len(spans)} kernels{per}; "
              f"top: " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in out[label]["top"]),
              flush=True)
    while engine.has_pending():
        engine.step_block(8)
    return out


def phase_serve():
    """The port's HTTP server on Llama-7B: returns (numbers, kernel launches)."""
    from kubedl_tpu_torch.ops.flash_attention import flash_attention
    from kubedl_tpu_torch.train import serve

    args = serve.parse_args(["--model", "llama-7b", "--allow-fresh-init",
                             "--slots", "8", "--max-len", "1024", "--port", "0",
                             "--bind", "127.0.0.1"])
    t0 = time.perf_counter()
    httpd, svc = serve.build_server(args)
    setup_s = time.perf_counter() - t0
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    print(f"serve: {base} up in {setup_s:.2f} s (fresh 7B init on the card)",
          flush=True)
    try:
        rng = torch.Generator().manual_seed(2)
        prompts = [torch.randint(1, 32000, (n,), generator=rng).tolist()
                   for n in SERVE_LENGTHS]
        dup = prompts[2]
        flash_attention.launches = 0
        results = [None] * len(prompts)

        def client(i):
            results[i] = _post(base, {"tokens": prompts[i],
                                      "max_new_tokens": SERVE_NEW})

        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        pair = _post(base, {"requests": [{"tokens": dup, "max_new_tokens": SERVE_NEW},
                                         {"tokens": dup, "max_new_tokens": SERVE_NEW}]})
        wall_s = time.perf_counter() - t0
        launches = flash_attention.launches
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        engine_ticks = svc.engine.stats()["ticks"]
        with svc._lock:  # the pump is idle; keep it off the engine meanwhile
            profile = _profile_engine(svc.engine)
    finally:
        httpd.shutdown()
        thread.join(timeout=60)
        httpd.server_close()
        svc.stop()
    del httpd, svc, thread  # the engine and its 7B weights go with them
    answers = results + pair["results"]
    for n, a in zip(list(SERVE_LENGTHS) + [len(dup)] * 2, answers):
        if a is None or a.get("error") or len(a["tokens"]) != SERVE_NEW:
            raise AssertionError(f"request of {n} prompt tokens failed: {a}")
        if not all(0 <= t < 32000 for t in a["tokens"]):
            raise AssertionError(f"token out of vocab: {a['tokens']}")
    if pair["results"][0]["tokens"] != pair["results"][1]["tokens"]:
        raise AssertionError("one prompt sent twice gave different tokens")
    if health != {"ok": True}:
        raise AssertionError(f"/healthz: {health}")
    n_layers = 32
    if launches < n_layers * stats["prefill_batches"] or launches == 0:
        raise AssertionError(
            f"flash kernel launched {launches} times for "
            f"{stats['prefill_batches']} prefill dispatches x {n_layers} layers")
    prompt_tokens = sum(SERVE_LENGTHS) + 2 * len(dup)
    decode_tokens = stats["tokens_out"] - len(answers)  # first tokens come from prefill
    numbers = dict(
        requests=len(answers), wall_s=wall_s, prompt_tokens=prompt_tokens,
        tokens_out=stats["tokens_out"], prefill_batches=stats["prefill_batches"],
        prefill_time_s=stats["prefill_time_s"], decode_time_s=stats["decode_time_s"],
        ticks=engine_ticks, profile=profile,
        prefill_tok_s=prompt_tokens / stats["prefill_time_s"],
        decode_tok_s=decode_tokens / stats["decode_time_s"],
        served_tok_s=stats["tokens_out"] / wall_s, flash_launches=launches)
    print(f"serve: {len(answers)} requests ok in {wall_s:.2f} s; prefill "
          f"{stats['prefill_batches']} dispatches {stats['prefill_time_s']:.3f} s "
          f"({numbers['prefill_tok_s']:.0f} prompt tok/s); decode "
          f"{stats['decode_time_s']:.3f} s over {engine_ticks} ticks "
          f"({stats['decode_time_s'] / max(engine_ticks, 1) * 1e3:.1f} ms/tick, "
          f"{numbers['decode_tok_s']:.1f} tok/s); "
          f"tokens_out {stats['tokens_out']} ({numbers['served_tok_s']:.1f} tok/s "
          f"served); flash launches {launches}", flush=True)
    return numbers, launches


def _bwd_bounds(b, hq, hkv, s, d, causal, window):
    """(flop, bytes) of the least work: dq alone (3 products: s, dO.v^T,
    ds.k), dkv alone (4: s, dO.v^T, p^T.dO, ds^T.q) and the whole backward
    (5 products, 10 b h d pairs FLOP) against q, k, v, o, dO, LSE read once
    and dq, dk, dv written once."""
    pairs = b * hq * d * _attended_pairs(s, causal, window)
    q_b, kv_b, row_b = 2 * b * hq * s * d, 2 * b * hkv * s * d, 4 * b * hq * s
    dq = (6 * pairs, 2 * q_b + 2 * kv_b + 2 * row_b + q_b)   # q dO k v lse delta -> dq
    dkv = (8 * pairs, 2 * q_b + 2 * kv_b + 2 * row_b + 2 * kv_b)
    whole = (10 * pairs, 3 * q_b + 2 * kv_b + row_b + q_b + 2 * kv_b)  # + o; lse
    return {"dq": dq, "dkv": dkv, "bwd": whole}


def _bound(flop, nbytes):
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# flash_bwd.cu's tiles: (q rows, key rows) of a dq item's tile, (key rows,
# q rows) of a dkv item's tile; flash_bwd_sm90.cu's are fa.sm90_tiles'
MMA_SYNC_BWD_TILES = {"dq": (64, 64), "dkv": (64, 32)}


def _loaded_pairs(s, causal, window, rows, cols, by_key):
    """(query, key) pairs of the tiles a kernel loads for one head: items
    of `rows` query rows (key rows when by_key) over streamed tiles of
    `cols` rows, from the diagonal and within the window, as the kernels'
    live ranges run; masked pairs included."""
    tiles = 0
    for t in range(-(-s // rows)):
        r0, n = t * rows, -(-s // cols)
        if by_key:
            if window:
                n = min(n, (min(r0 + rows, s) - 1 + window - 1) // cols + 1)
            tiles += max(n - (r0 // cols if causal else 0), 0)
        else:
            if causal:
                n = min(n, (r0 + rows - 1) // cols + 1)
            lo = r0 - window + 1 if window else 0
            tiles += n - (lo // cols if lo > 0 else 0)
    return tiles * rows * cols


def _executed_share(sources, b, hq, s, d, causal, window):
    """The least backward work (5 products a kept pair) over what the two
    kernels (sources: {"dq": csrc name, "dkv": csrc name}) run: 3 products a
    loaded pair in dq, 4 in dkv."""
    from kubedl_tpu_torch.ops import flash_attention as fa

    (qr, kc), (kr, qc) = (fa.sm90_tiles(kind, d) if sources[kind] == fa.BWD_SM90
                          else MMA_SYNC_BWD_TILES[kind] for kind in ("dq", "dkv"))
    run = 6 * d * _loaded_pairs(s, causal, window, qr, kc, False) \
        + 8 * d * _loaded_pairs(s, causal, window, kr, qc, True)
    return 10 * d * _attended_pairs(s, causal, window) / run


def phase_bwd_kernels(only=None):
    """The dq and dkv kernels against the f32 plain backward; returns
    {shape name: numbers}: the routed kernels' at the top level (their
    sources under "sources"), flash_bwd.cu's mma.sync kernels' at the same
    shape under "mma_sync". `only`: the shape names to run (all by
    default)."""
    import torch.nn.functional as F

    from kubedl_tpu_torch.ops import flash_attention as fa

    # name: (b, hq, hkv, s, d, causal, window, softcap)
    shapes = {
        MAIN_BWD_SHAPE: (4, 32, 32, 1023, 128, True, None, None),
        "7b_b4_s1024": (4, 32, 32, 1024, 128, True, None, None),
        "7b_b4_s2048": (4, 32, 32, 2048, 128, True, None, None),
        "gqa_32q_8kv_s1024": (4, 32, 8, 1024, 128, True, None, None),
        "window256_s2048": (4, 32, 32, 2048, 128, True, 256, None),
        "softcap50_s1024": (4, 32, 32, 1024, 128, True, None, 50.0),
        "d64_s1024": (4, 32, 32, 1024, 64, True, None, None),
        "d256_b2_h8_s1024": (2, 8, 8, 1024, 256, True, None, None),
        "b1_h8_s8192": (1, 8, 8, 8192, 128, True, None, None),
        # phase 15c's Gemma-2-2B training shape (d 256: flash_bwd_sm90.cu's
        # Dq256 and Dkv256): GQA 8/4, softcap 50; the sliding layers at a
        # length where the 4096 window binds; the twin without the softcap
        # that SDPA's backward takes
        MAIN_BWD_D256: FLEX_SHAPES[MAIN_BWD_D256],
        "gemma2_w4096_b1_s5000": (1, 8, 4, G2_PREFILL, 256, True, 4096, 50.0),
        "d256_gqa_s1023": (4, 8, 4, 1023, 256, True, None, None),
        # phase 18a's ViT-B/16 step and the non-ragged twin, both not causal
        MAIN_VIT: (128, 12, 12, 197, 64, False, None, None),
        "noncausal_s1024": (4, 32, 32, 1024, 128, False, None, None),
    }
    gen = torch.Generator(device="cuda").manual_seed(3)
    results = {}
    for name, (b, hq, hkv, s, d, causal, window, softcap) in shapes.items():
        if only is not None and name not in only:
            continue
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        dout = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        if softcap is not None:
            q = q * SOFTCAP_Q_SCALE
        kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(),
                                           lse, dout.float(), **kw)
        routed = {kind: fa.bwd_kernel_source(d, kind) for kind in ("dq", "dkv")}
        runs = {}
        # the routed kernels, then flash_bwd.cu's mma.sync kernels at the same shape
        for run, source in (("routed", None), ("mma_sync", fa.BWD_MMA_SYNC)):
            sources = routed if source is None else {"dq": source, "dkv": source}
            got = fa.flash_attention_bwd(q, k, v, out, lse, dout, source=source, **kw)
            again = fa.flash_attention_bwd(q, k, v, out, lse, dout, source=source, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, g) for a, g in zip(again, got))
            errs, finite = {}, True
            for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
                finite = finite and bool(torch.isfinite(g.float()).all())
                errs[gname] = ((g.float() - r).abs().max() / r.abs().max()).item()
                errs[gname + "_abs"] = (g.float() - r).abs().max().item()
            del got, again
            launch_args, _ = fa._bwd_launch_args(q, k, v, out, lse, dout, causal, None,
                                                 window, softcap, source)
            dq_ms = _graph_ms(lambda: fa._launch_bwd("dq", launch_args["dq"]))
            dkv_ms = _graph_ms(lambda: fa._launch_bwd("dkv", launch_args["dkv"]))
            del launch_args
            label = "+".join(dict.fromkeys(f"{x}.cu" for x in sources.values()))
            runs[run] = dict(source=label, sources={kd: f"{x}.cu" for kd, x in sources.items()},
                             errors=errs, finite=finite, deterministic=same, dq_ms=dq_ms,
                             dkv_ms=dkv_ms,
                             executed_work_share=_executed_share(sources, b, hq, s, d, causal,
                                                                 window))
            if not finite or not same or max(errs[g] for g in ("dq", "dk", "dv")) > BWD_TOL:
                raise AssertionError(
                    f"{label} disagrees with the plain backward at {name}: finite={finite} "
                    f"deterministic={same} errors={errs} (tol {BWD_TOL})")
        # a planted fault: the routed kernels without one of their options
        # (the forward's out and lse kept) must fail the same check
        dropped = {}
        for opt, change in _dropped(s, window, softcap, causal).items():
            bad = fa.flash_attention_bwd(q, k, v, out, lse, dout, **dict(kw, **change))
            dropped[opt] = max(((g.float() - r).abs().max() / r.abs().max()).item()
                               for g, r in zip(bad, ref)) / BWD_TOL
            del bad
            if dropped[opt] <= 1:
                raise AssertionError(f"phase 2b cannot see the planted fault "
                                     f"{_fault_label(opt)} at {name}: {dropped[opt]:.3f} of "
                                     f"the tolerance")
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        library, library_err = None, None
        if softcap is None and window is None:
            library = "sdpa"

            def attend():
                return F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                                      enable_gqa=hq != hkv)
        elif name in FLEX_ROWS:  # SDPA has no softcap, nor a window but a mask
            library, flex = "flex_attention", _flex(s, causal, window, softcap, hq != hkv)

            def attend():
                return flex(qg, kg, vg)[0]

            library_err = max(((g.float() - r).abs().max() / r.abs().max()).item() for g, r in
                              zip(torch.autograd.grad(attend(), (qg, kg, vg), dout), ref))
            if library_err > BWD_TOL:
                raise AssertionError(f"flex_attention's backward does not compute the "
                                     f"kernels' function at {name}: {library_err}")
        del ref
        wrapper_ms = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw))
        runs["mma_sync"]["wrapper_ms"] = _time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, dout, source=fa.BWD_MMA_SYNC, **kw))
        plain_ms = _time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw),
                            iters=3)
        # device time, as the kernels': forward and backward less forward,
        # each timed in a CUDA graph
        library_ms = None
        if library is not None:
            fwd_bwd = _graph_ms(lambda: torch.autograd.grad(attend(), (qg, kg, vg), dout))
            with torch.no_grad():
                fwd_only = _graph_ms(attend)
            library_ms = fwd_bwd - fwd_only
        del qg, kg, vg
        work = _bwd_bounds(b, hq, hkv, s, d, causal, window)
        r = dict(shape=[b, hq, hkv, s, d], causal=causal, window=window, softcap=softcap,
                 q_scale=SOFTCAP_Q_SCALE if softcap is not None else 1.0,
                 dropped_option_reads=dropped, **runs["routed"], wrapper_ms=wrapper_ms,
                 plain_ms=plain_ms, library=library, library_rel_err=library_err,
                 library_ms=library_ms)
        for part in ("dq", "dkv", "bwd"):
            r[f"{part}_bound_ms"], r[f"{part}_bound_by"] = _bound(*work[part])
        kernel_ms = r["dq_ms"] + r["dkv_ms"]
        r["share_of_bound"] = r["bwd_bound_ms"] / kernel_ms
        r["tflops"] = work["bwd"][0] / kernel_ms / 1e9
        old = runs["mma_sync"]
        r["mma_sync"] = old
        r["speedup_vs_mma_sync"] = (old["dq_ms"] + old["dkv_ms"]) / kernel_ms
        r["dq_speedup_vs_mma_sync"] = old["dq_ms"] / r["dq_ms"]
        r["dkv_speedup_vs_mma_sync"] = old["dkv_ms"] / r["dkv_ms"]
        results[name] = r
        lib = "not timed" if library is None else f"{library_ms:.4f} ({library})"
        errs = r["errors"]
        vs = (f"{old['dq_ms']:.4f}+{old['dkv_ms']:.4f} (x{r['speedup_vs_mma_sync']:.2f}, "
              f"dq x{r['dq_speedup_vs_mma_sync']:.2f}, dkv x{r['dkv_speedup_vs_mma_sync']:.2f}, "
              f"wrapper_ms {old['wrapper_ms']:.4f}, "
              f"rel_err dq={old['errors']['dq']:.2e} dk={old['errors']['dk']:.2e} "
              f"dv={old['errors']['dv']:.2e})")
        print(f"bwd {name} [dq {routed['dq']}.cu, dkv {routed['dkv']}.cu]: dq_ms={r['dq_ms']:.4f} (bound {r['dq_bound_ms']:.4f} "
              f"{r['dq_bound_by']}) dkv_ms={r['dkv_ms']:.4f} (bound {r['dkv_bound_ms']:.4f} "
              f"{r['dkv_bound_by']}) mma_sync={vs} wrapper_ms={wrapper_ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib} bwd_bound_ms={r['bwd_bound_ms']:.4f} "
              f"({r['bwd_bound_by']}) share={r['share_of_bound']:.3f} "
              f"executed_work_share={r['executed_work_share']:.3f} tflops={r['tflops']:.1f} "
              f"rel_err dq={errs['dq']:.3e} dk={errs['dk']:.3e} dv={errs['dv']:.3e} "
              f"deterministic={r['deterministic']}"
              + "".join(f" {_fault_label(o)}_reads={x:.1f}xtol" for o, x in dropped.items()),
              flush=True)
        del q, k, v, out, lse, dout
    return results


def _counts():
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    return (flash_attention.launches, flash_attention.bwd_dq_launches,
            flash_attention.bwd_dkv_launches)


def _reset_counts():
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    flash_attention.launches = 0
    flash_attention.bwd_dq_launches = 0
    flash_attention.bwd_dkv_launches = 0


def phase_grads():
    """loss_fn and every gradient at full width, 2 layers, b=2, S=1024,
    through the kernels against plain attention."""
    import dataclasses

    from kubedl_tpu_torch.models import llama

    config = dataclasses.replace(llama.LlamaConfig.llama_7b(), n_layers=2)
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.randint(0, config.vocab_size, (2, 1025), device="cuda", dtype=torch.int32,
                           generator=torch.Generator(device="cuda").manual_seed(4))
    out = {}
    for label, cfg in (("kernel", config),
                       ("plain", dataclasses.replace(config, use_flash=False))):
        tree = llama.tree_map(lambda x: x.detach().requires_grad_(True), params)
        leaves = list(llama.tree_leaves(tree))
        _reset_counts()
        loss = llama.loss_fn(tree, tokens, cfg)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[label] = (loss.item(), grads, _counts())
    n = config.n_layers
    (lk, gk, ck), (lp, gp, cp) = out["kernel"], out["plain"]
    if ck != (2 * n, n, n) or cp != (0, 0, 0):
        raise AssertionError(f"gradient launches (fwd, dq, dkv): kernel path {ck} "
                             f"(expected {(2 * n, n, n)} under full remat), plain {cp}")
    names = ["embed"] + [f"layers.{i}.{k}" for i, layer in enumerate(params["layers"])
                         for k in layer] + [k for k in params if k not in ("embed", "layers")]
    errs = {}
    for nm, a, b in zip(names, gk, gp):
        if a.dtype != b.dtype or not bool(torch.isfinite(a.float()).all()):
            raise AssertionError(f"gradient {nm}: dtype {a.dtype} vs {b.dtype} or not finite")
        errs[nm] = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
    worst = max(errs, key=errs.get)
    loss_rel = abs(lk - lp) / abs(lp)
    print(f"grads: llama-7b width, 2 layers, b=2 S=1024: loss kernel {lk:.6f} plain "
          f"{lp:.6f} (rel {loss_rel:.2e}); worst gradient {worst} rel {errs[worst]:.3e} "
          f"over {len(errs)} leaves (tol {GRAD_TOL}); launches fwd/dq/dkv {ck}", flush=True)
    if loss_rel > 1e-2 or errs[worst] > GRAD_TOL:
        raise AssertionError("gradients through the kernels disagree with plain attention")
    del params, out, gk, gp
    return dict(loss_kernel=lk, loss_plain=lp, loss_rel=loss_rel, grad_rel_err=errs,
                launches=list(ck))


def _trace_spans(trace_dir):
    spans = []
    for path in sorted(glob.glob(os.path.join(trace_dir, "*.jsonl"))):
        if path.endswith(".steps.jsonl"):
            continue
        with open(path) as f:
            spans += [json.loads(line) for line in f if line.strip()]
    return spans


def _kernel_profile(trace_json, wall_ms):
    """Device busy time (union of kernel intervals), idle share and top
    kernels of a torch.profiler Chrome trace."""
    with open(trace_json) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kern)
    busy_us, end = 0.0, float("-inf")
    for r0, r1 in spans:
        start = max(r0, end)
        if r1 > start:
            busy_us += r1 - start
        end = max(end, r1)
    by_name = {}
    for e in kern:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    groups = {"gmm kernels": 0.0, "flash kernels": 0.0, "GEMM (cuBLAS)": 0.0,
              "elementwise and other": 0.0}
    for n, us in by_name.items():
        if "gmm_kernel" in n:  # gmm_kernel<...>, gmm_sm90_gmm_kernel, tgmm_sm90_gmm_kernel
            groups["gmm kernels"] += us / 1e3
        elif "flash_" in n:
            groups["flash kernels"] += us / 1e3
        elif any(t in n.lower() for t in ("nvjet", "gemm", "gemv", "cutlass", "xmma")):
            groups["GEMM (cuBLAS)"] += us / 1e3
        else:
            groups["elementwise and other"] += us / 1e3
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3, kernels=len(kern),
                idle_share=(1 - busy_us / 1e3 / wall_ms) if kern else None,
                top=[(n[:70], us / 1e3) for n, us in top], groups=groups)


@contextlib.contextmanager
def _traced(tag):
    """An entry point run in this process exports its spans to a fresh
    trace dir (yielded) under POD_NAME chip-smoke-<tag>."""
    trace_dir = os.path.join(WORK, f"trace-{tag}")
    shutil.rmtree(trace_dir, ignore_errors=True)
    saved = {k: os.environ.get(k) for k in ("KUBEDL_TRACE_DIR", "POD_NAME")}
    os.environ.update(KUBEDL_TRACE_DIR=trace_dir, POD_NAME=f"chip-smoke-{tag}")
    try:
        yield trace_dir
    finally:
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val


def _run_trainer(argv, tag):
    """trainer.main(argv) in this process with its spans exported to a
    fresh trace dir; returns (rc, train spans, trace dir)."""
    from kubedl_tpu_torch.train import trainer

    with _traced(tag) as trace_dir:
        rc = trainer.main(argv)
    steps = [sp for sp in _trace_spans(trace_dir)
             if sp["name"] in ("train.compile", "train.step")]
    steps.sort(key=lambda sp: sp["attrs"]["step"])
    return rc, steps, trace_dir


def phase_train(n_params):
    """The trainer on full-width, full-depth Llama-7B, 6 steps; n_params is
    the model's parameter count (phase 3)."""
    from kubedl_tpu_torch.models import llama

    steps, n_layers, batch, seq = 6, 32, 4, 1024
    profile_dir = os.path.join(WORK, "profile-7b")
    shutil.rmtree(profile_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    rc, spans, _ = _run_trainer(
        ["--model", "llama-7b", "--batch", str(batch), "--seq-len", str(seq),
         "--steps", str(steps), "--log-every", "1", "--grad-clip", "1.0",
         "--profile-dir", profile_dir, "--profile-steps", "1"], "7b")
    wall_s = time.perf_counter() - t0
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0 or len(spans) != steps:
        raise AssertionError(f"7B trainer: rc={rc}, {len(spans)} step spans of {steps}")
    losses = [sp["attrs"]["loss"] for sp in spans]
    gnorms = [sp["attrs"]["grad_norm"] for sp in spans]
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"7B trainer: non-finite loss or grad_norm {losses} {gnorms}")
    if abs(losses[0] - math.log(32000)) > 1.5:
        raise AssertionError(f"7B first loss {losses[0]} not within 1.5 of ln 32000")
    want = (2 * steps * n_layers, steps * n_layers, steps * n_layers)
    if counts != want:
        raise AssertionError(f"7B trainer launches (fwd, dq, dkv) {counts}, expected {want}")
    step_s = statistics.median(sp["dur"] for sp in spans[1:])
    tokens = batch * (seq - 1)
    config = llama.LlamaConfig.llama_7b()
    attn_flop = 12 * n_layers * batch * config.n_heads * config.head_dim * \
        _attended_pairs(seq - 1, True, None)
    model_flop = 6 * n_params * tokens + attn_flop
    mfu = model_flop / (step_s * PEAK_BF16_FLOPS)
    traces = glob.glob(os.path.join(profile_dir, "*.json"))
    if len(traces) != 1:
        raise AssertionError(f"7B trainer wrote {len(traces)} profile traces")
    prof = _kernel_profile(traces[0], spans[1]["dur"] * 1e3)
    share = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}"
    print(f"train: llama-7b {steps} steps b={batch} seq={seq} in {wall_s:.1f} s (init "
          f"included); losses {', '.join(f'{x:.4f}' for x in losses)}; grad_norm "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}", flush=True)
    print(f"train: step {step_s * 1e3:.1f} ms (median of steps 2-{steps}; first step "
          f"{spans[0]['dur'] * 1e3:.1f} ms), {tokens / step_s:.0f} tok/s, model FLOP "
          f"share (6*N*T + 12*L*b*h*d*pairs over step time x 989e12) {mfu:.3f}; peak "
          f"allocated {peak_gb:.2f} GB; launches fwd/dq/dkv {counts}", flush=True)
    print(f"profile train step: wall {prof['wall_ms']:.1f} ms (profiled), device busy "
          f"{prof['device_busy_ms']:.1f} ms, idle share {share}, {prof['kernels']} kernels; "
          f"top: " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in prof["top"]), flush=True)
    print("profile train step by kind: " + "; ".join(
        f"{k} {ms:.1f} ms" for k, ms in prof["groups"].items()), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    opt = _optimizer_alone(config)
    return dict(optimizer=opt, losses=losses, grad_norms=gnorms, step_ms=step_s * 1e3,
                first_step_ms=spans[0]["dur"] * 1e3, tok_s=tokens / step_s,
                model_flop_per_step=model_flop, model_flop_share=mfu, peak_gb=peak_gb,
                launches=list(counts), wall_s=wall_s, profile=prof)


def _optimizer_alone(config):
    """The trainer's optimizer (clip + AdamW, leaf by leaf) alone on the 7B
    leaves, against its bound: p, g, mu, nu read and p, mu, nu written."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim

    leaves = list(llama.tree_leaves(
        llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")))
    gen = torch.Generator(device="cuda").manual_seed(5)
    grads = [torch.randn(p.shape, generator=gen, device="cuda").mul_(1e-3).to(p.dtype)
             for p in leaves]
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(3e-4, weight_decay=0.01))
    state = tx.init(leaves)
    ms = _time_ms(lambda: tx.apply(leaves, grads, state), warmup=1, iters=3)
    nbytes = 7 * sum(p.numel() * p.element_size() for p in leaves)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    print(f"optimizer: clip + AdamW over {len(leaves)} leaves of 7B: {ms:.1f} ms a step, "
          f"bound {bound_ms:.1f} ms (bytes)", flush=True)
    del leaves, grads, state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ms=ms, bound_ms=bound_ms)


def _latest_ckpt(path):
    steps = [int(d) for d in os.listdir(path) if d.isdigit()] if os.path.isdir(path) else []
    return max(steps) if steps else None


def phase_options():
    """bench-1b with the trainer's options in process (the preemption
    contract of phase 7 runs in phase_preemption_contracts)."""
    _reset_counts()
    steps = 4
    rc, spans, _ = _run_trainer(
        ["--model", "bench-1b", "--batch", "4", "--seq-len", "512", "--steps", str(steps),
         "--accum-steps", "2", "--ce-chunks", "4", "--remat", "dots",
         "--lr-schedule", "cosine", "--warmup-steps", "2", "--log-every", "1"], "1b")
    counts = _counts()
    losses = [sp["attrs"]["loss"] for sp in spans]
    gnorms = [sp["attrs"]["grad_norm"] for sp in spans]
    if rc != 0 or len(spans) != steps or not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"bench-1b trainer: rc={rc} losses={losses} grad_norm={gnorms}")
    # "dots" recomputes the flash forward too: twice a layer a micro-step
    if counts != (2 * steps * 16, steps * 16, steps * 16):
        raise AssertionError(f"bench-1b launches (fwd, dq, dkv) {counts}")
    print(f"options: bench-1b accum 2, ce_chunks 4, remat dots, cosine warmup 2: "
          f"{steps} steps, losses {', '.join(f'{x:.4f}' for x in losses)}, grad_norm "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}, launches fwd/dq/dkv {counts}", flush=True)
    return dict(bench_1b=dict(losses=losses, grad_norms=gnorms, launches=list(counts)))


def _7_preemption():
    """7: a subprocess trainer preempted by SIGTERM after its first
    checkpoint, and resumed."""
    ckpt = os.path.join(WORK, "ckpt-tiny")
    shutil.rmtree(ckpt, ignore_errors=True)
    cmd = [sys.executable, "-m", "kubedl_tpu_torch.train.trainer", "--model", "tiny",
           "--steps", "500", "--batch", "8", "--seq-len", "65", "--log-every", "1000",
           "--checkpoint-path", ckpt, "--checkpoint-interval", "10"]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 300
        while _latest_ckpt(ckpt) is None and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        if proc.poll() is not None or _latest_ckpt(ckpt) is None:
            raise AssertionError(f"tiny trainer ended or stalled before its first "
                                 f"checkpoint: rc={proc.poll()}")
        proc.send_signal(signal.SIGTERM)
        first_out = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    at = _latest_ckpt(ckpt)
    if proc.returncode != 113 or at is None or "preempted: checkpoint saved" not in first_out:
        raise AssertionError(f"SIGTERM: rc={proc.returncode} (expected 113), checkpoint "
                             f"{at}:\n{first_out[-2000:]}")
    # the rerun resumes for 2 steps: the contract is the restore and the
    # clean exit, not the remaining 500-step schedule
    rerun = subprocess.run(cmd[:cmd.index("--steps") + 1] + [str(at + 2)]
                           + cmd[cmd.index("--steps") + 2:], cwd=root, env=env,
                           capture_output=True, text=True, timeout=600)
    if rerun.returncode != 0 or f"restored checkpoint at step {at}" not in rerun.stdout \
            or _latest_ckpt(ckpt) != at + 2:
        raise AssertionError(f"resume: rc={rerun.returncode}, latest {_latest_ckpt(ckpt)}:\n"
                             f"{rerun.stdout[-2000:]}{rerun.stderr[-2000:]}")
    print(f"preemption: tiny trainer SIGTERMed, exit 113 with a checkpoint at step {at}; "
          f"rerun restored step {at}, exit 0, final checkpoint at step {at + 2}", flush=True)
    return dict(preempted_at=at)


def phase_preemption_contracts(smi):
    """The preemption contracts of phases 7, 11c and 19c side by side, each
    in a thread of its own: tiny programs as subprocesses, SIGTERMed and
    rerun, whose checks are exit codes, checkpoint steps and restores. Each
    is mostly the start-up of its processes, so side by side they take about
    the longest one's time; meanwhile this thread compiles phases 2 and 2b's
    flex_attention (_compile_flex), which measures nothing. Returns {"7",
    "11c", "19c": its numbers}."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = {"7": (_7_preemption, ()), "11c": (phase_gang_preemption, ()),
            "19c": (_19c_socket_preemption, (smi,))}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(_phase, f"{k} preemption (side by side)", fn, *args)
                   for k, (fn, args) in jobs.items()}
        _phase("2 and 2b: flex_attention compiled (beside the contracts)", _compile_flex)
        return {k: f.result() for k, f in futures.items()}


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _one_rank_group():
    """This process as a group of one over NCCL, formed by the port's own
    rendezvous from an address, as a pod of one would form it."""
    import torch.distributed as dist

    from kubedl_tpu_torch.train import coordinator

    if not dist.is_initialized():
        torch.cuda.set_device(0)
        coordinator.initialize(coordinator.ProcessInfo(
            coordinator_address=f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0),
            backend="nccl")


def _run_7b_steps(config, batches, mesh=None, lora_rank=0):
    """make_train_step on a fresh 7B init (seed 0) over `batches`, on one
    device (mesh None) or through the sharded code on `mesh`: (losses,
    grad norms, step times in s, flash launches (fwd, dq, dkv), peak GB,
    the one-device loss of the first batch before any step). lora_rank > 0
    trains adapters of that rank through models/lora.py `make_lora_step`
    on one device instead, and raises unless the base is unchanged bit for
    bit after the steps."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import ShardingRules
    from kubedl_tpu_torch.parallel.train_step import make_train_step

    rules = ShardingRules()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    with torch.no_grad():
        plain_loss = llama.loss_fn(params, batches[0], config).item()
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(3e-4, weight_decay=0.01))
    base = trained = params
    if lora_rank:
        from kubedl_tpu_torch.models import lora

        trained, init_state, train_step = lora.make_lora_step(params, config, tx,
                                                              rank=lora_rank)
    elif mesh is None:
        init_state, train_step = make_train_step(lambda p, b: llama.loss_fn(p, b, config), tx)
    else:
        init_state, train_step = make_train_step(
            lambda p, b: llama.loss_fn(p, b, config, mesh=mesh, rules=rules), tx, mesh,
            llama.param_specs(config, rules), rules.spec("batch", None), rules)
    state = init_state(trained)
    del params, trained
    kind = type(next(iter(llama.tree_leaves(state.params)))).__name__
    if (kind == "DTensor") != (mesh is not None):
        raise AssertionError(f"7B step on mesh {mesh}: leaves are {kind}")
    _reset_counts()
    losses, gnorms, times = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, b)
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
        times.append(time.perf_counter() - t0)
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state, metrics
    if lora_rank and not _base_unchanged(base, config):
        raise AssertionError("7B LoRA steps changed the base weights")
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return losses, gnorms, times, counts, peak_gb, plain_loss


def phase_sharded_step(train):
    """11a: the 7B step through the sharded code on a one-device mesh, in
    turns with the one-device step on the same init and batches (one
    device, sharded, sharded, one device), beside phase 6 (`train`, the
    trainer's numbers on the same card)."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel.mesh import build_mesh

    _one_rank_group()
    steps, batch, seq = 3, 4, 1024
    config = llama.LlamaConfig.llama_7b()
    mesh = build_mesh({"data": 1}, device_type="cuda")
    # phase 6's launches over its 6 steps, scaled to these steps
    want = [x // len(train["losses"]) * steps for x in train["launches"]]
    gen = torch.Generator(device="cuda").manual_seed(11)
    batches = [torch.randint(0, config.vocab_size, (batch, seq), generator=gen, device="cuda",
                             dtype=torch.int32) for _ in range(steps)]
    turns = {}
    for label in ("one_device", "sharded", "sharded", "one_device"):
        turns.setdefault(label, []).append(
            _run_7b_steps(config, batches, mesh if label == "sharded" else None))
    for losses, gnorms, _, counts, _, plain_loss in turns["sharded"]:
        if not all(math.isfinite(x) for x in losses + gnorms):
            raise AssertionError(f"sharded 7B step: non-finite loss or grad_norm {losses} "
                                 f"{gnorms}")
        loss_rel = abs(losses[0] - plain_loss) / abs(plain_loss)
        if loss_rel > 1e-2:  # phase 5's bf16 loss tolerance
            raise AssertionError(f"sharded 7B first loss {losses[0]} vs one-device "
                                 f"{plain_loss}")
        if list(counts) != want:
            raise AssertionError(f"sharded 7B launches (fwd, dq, dkv) {counts}, phase 6's "
                                 f"over {steps} steps {want}")
    med = {k: [statistics.median(t[2][1:]) * 1e3 for t in v] for k, v in turns.items()}
    losses, gnorms, times, counts, peak_gb, plain_loss = turns["sharded"][0]
    loss_rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    one_losses = turns["one_device"][0][0]
    step_ms = statistics.mean(med["sharded"])
    ratio6 = step_ms / train["step_ms"]
    ratio1 = step_ms / statistics.mean(med["one_device"])
    print(f"sharded step: llama-7b on a one-device DeviceMesh (one-rank NCCL group), "
          f"{steps} steps b={batch} seq={seq}; first loss {losses[0]:.6f} vs one-device "
          f"{plain_loss:.6f} (rel {loss_rel:.2e}); losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} (one-device step: "
          f"{', '.join(f'{x:.4f}' for x in one_losses)}); grad_norm "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}", flush=True)
    print(f"sharded step: step {step_ms:.1f} ms (median of steps 2-{steps}, turns "
          f"{', '.join(f'{x:.1f}' for x in med['sharded'])}) vs the one-device step "
          f"{', '.join(f'{x:.1f}' for x in med['one_device'])} in turns (ratio {ratio1:.4f}) "
          f"and phase 6's {train['step_ms']:.1f} ms (ratio {ratio6:.4f}); peak allocated "
          f"{peak_gb:.2f} GB vs phase 6's {train['peak_gb']:.2f} GB; launches fwd/dq/dkv "
          f"{counts}", flush=True)
    return dict(losses=losses, grad_norms=gnorms, plain_loss=plain_loss, loss_rel=loss_rel,
                one_device_losses=one_losses, step_ms=step_ms, turns_ms=med,
                first_step_ms=times[0] * 1e3, ratio_to_one_device=ratio1,
                ratio_to_phase6=ratio6, peak_gb=peak_gb, launches=list(counts))


def phase_ep_body():
    """11b: the expert-parallel dropless body on a one-rank expert group at
    Mixtral widths, 2 layers, against the one-device dropless route."""
    from kubedl_tpu_torch.models import moe
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh

    _one_rank_group()
    mesh = build_mesh({"expert": 1}, device_type="cuda")
    rules = ShardingRules()
    config = _mixtral(2)
    e, k, d = config.n_experts, config.expert_top_k, config.d_model
    s = 2 * 1024
    gen = torch.Generator(device="cuda").manual_seed(12)
    layers, worst, counts, want_counts = [], {}, (0, 0, 0, 0), (0, 0, 0, 0)
    names = ("router", "w1", "w3", "w2")
    for li in range(config.n_layers):
        params = moe.moe_init(d, config.d_ff, e, dtype=torch.bfloat16, generator=gen,
                              device="cuda")
        h = (torch.randn(s, d, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        dy = torch.randn(s, d, generator=gen, device="cuda").to(torch.bfloat16)
        out = {}
        for route in ("one_device", "sharded"):
            leaves = [h.detach().requires_grad_(True)] + [
                params[n].detach().requires_grad_(True) for n in names]
            p = dict(zip(names, leaves[1:]))
            _reset_gmm_counts()
            if route == "sharded":
                stats = {}
                y, aux = moe._dropless_mlp_sharded(
                    leaves[0], p, top_k=k, quota_factor=1.0, mesh=mesh, rules=rules, e=e,
                    stats=stats)
            else:
                experts, _, gates, _, (me, ce) = moe._top_k_gating(
                    leaves[0].float() @ p["router"], k, s + 1, need_slots=False)
                y = moe._dropless_mlp(leaves[0], p, experts, gates, e)
                aux = e * (me * ce).sum()
                stats = dict(experts=experts)
            grads = torch.autograd.grad((y.float() * dy.float()).sum() + aux, leaves)
            torch.cuda.synchronize()
            out[route] = (y.detach(), aux.item(), grads, stats, _gmm_counts())
        (yp, ap, gp, sp, cp), (ys, as_, gs, ss, cs) = out["one_device"], out["sharded"]
        if not torch.equal(ss["experts"], sp["experts"]) or not bool(ss["kept"].all()):
            raise AssertionError(f"EP body layer {li}: routing differs or an entry dropped")
        groups_p = moe._counts(sp["experts"].reshape(-1), e)
        groups_s = moe._counts(ss["experts"].reshape(-1)[ss["kept"].reshape(-1)], e)
        if not torch.equal(groups_p, groups_s):
            raise AssertionError(f"EP body layer {li}: expert group sizes differ")
        errs = {"y": _rel(ys, yp), "aux": abs(as_ - ap) / abs(ap)}
        for nm, a, b in zip(("h",) + names, gs, gp):
            errs["d" + nm] = _rel(a, b)
        if max(errs.values()) > GRAD_TOL or not all(c > 0 for c in cs[:3]) or cs != cp:
            raise AssertionError(f"EP body layer {li}: errors {errs}, launches K5/K6/K7/K8 "
                                 f"sharded {cs} vs the one-device route {cp}")
        counts = tuple(a + b for a, b in zip(counts, cs))
        want_counts = tuple(a + b for a, b in zip(want_counts, cp))
        layers.append(dict(errors=errs, launches=list(cs), group_sizes=groups_s.tolist()))
        for nm, v in errs.items():
            worst[nm] = max(worst.get(nm, 0.0), v)
        del params, h, dy, out, gp, gs
    print(f"ep body: _dropless_mlp_sharded on a one-rank expert group, Mixtral widths, "
          f"{config.n_layers} layers of S={s}: routing and group sizes exact, nothing "
          f"dropped; worst rel errors " + ", ".join(f"{n} {v:.2e}" for n, v in worst.items())
          + f" (tol {GRAD_TOL}); launches K5/K6/K7/K8 {counts} (one-device route "
          f"{want_counts})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=layers, worst=worst, launches=list(counts))


def phase_gang_preemption():
    """11c: a subprocess trainer in a one-rank group (tiny, sharded
    checkpoints) SIGTERMed after its first checkpoint, then resumed."""
    ckpt = os.path.join(WORK, "ckpt-gang")
    shutil.rmtree(ckpt, ignore_errors=True)
    # the pod's command: the launcher, one trainer child a visible card
    argv = [sys.executable, "-m", "kubedl_tpu_torch.train.launch", "--",
            "kubedl_tpu_torch.train.trainer", "--model", "tiny",
            "--batch", "4", "--seq-len", "128", "--log-every", "1000",
            "--checkpoint-path", ckpt, "--checkpoint-interval", "5", "--checkpoint-keep", "1"]
    root = os.path.dirname(os.path.abspath(__file__))

    def env():
        return dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                    KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
                    KUBEDL_NUM_PROCESSES="1", KUBEDL_PROCESS_ID="0", KUBEDL_MESH="data=1")

    proc = subprocess.Popen(argv + ["--steps", "1000"], cwd=root, env=env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 300
        while _latest_ckpt(ckpt) is None and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        if proc.poll() is not None or _latest_ckpt(ckpt) is None:
            raise AssertionError(f"tiny gang trainer ended or stalled before its first "
                                 f"checkpoint: rc={proc.poll()}")
        proc.send_signal(signal.SIGTERM)
        first_out = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    at = _latest_ckpt(ckpt)
    sharded = at is not None and os.path.isfile(os.path.join(ckpt, str(at), ".metadata"))
    if proc.returncode != 113 or not sharded or "preempted: checkpoint saved" not in first_out \
            or "devices=1" not in first_out or "launch: rank 0 exited 113" not in first_out:
        raise AssertionError(f"gang SIGTERM: rc={proc.returncode} (expected 113), sharded "
                             f"checkpoint {at} {sharded}:\n{first_out[-2000:]}")
    rerun = subprocess.run(argv + ["--steps", str(at + 2)], cwd=root, env=env(),
                           capture_output=True, text=True, timeout=600)
    if rerun.returncode != 0 or f"restored checkpoint at step {at}" not in rerun.stdout \
            or "launch: rank 0 exited 0" not in rerun.stderr \
            or _latest_ckpt(ckpt) != at + 2:
        raise AssertionError(f"gang resume: rc={rerun.returncode}, latest "
                             f"{_latest_ckpt(ckpt)}:\n{rerun.stdout[-2000:]}{rerun.stderr[-2000:]}")
    print(f"gang preemption: tiny trainer in a one-rank NCCL group under train/launch.py "
          f"(one child), the launcher SIGTERMed: child and launcher exit 113 with a sharded "
          f"checkpoint at step {at}; rerun restored step {at}, exit 0, final checkpoint at "
          f"step {at + 2}", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return dict(preempted_at=at)

def _drive_engine(engine, prompts, dup, adapters=None):
    """Phase 4's traffic on a ServingEngine, driven as the server's pump
    drives it (step_block(8)): every prompt at once, then `dup` twice.
    Counts the flash launches of this run alone. `adapters`: each
    request's adapter id, in submission order (None: all 0)."""
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    ids = iter(adapters or [0] * (len(prompts) + 2))
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_tick = []  # decode seconds a tick of each step_block that ticked
    reqs = []
    for wave in (prompts, [dup, dup]):
        batch = [engine.submit(p, SERVE_NEW, adapter_id=next(ids)) for p in wave]
        reqs += batch
        while not all(r.done for r in batch):
            ticks, dec = engine._ticks, engine._decode_time
            engine.step_block(8)
            if engine._ticks > ticks:
                per_tick.append((engine._decode_time - dec) / (engine._ticks - ticks))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = flash_attention.launches
    st = engine.stats()
    prompt_tokens = sum(len(p) for p in prompts) + 2 * len(dup)
    return dict(tokens=[r.tokens for r in reqs], errors=[r.error for r in reqs],
                launches=launches, wall_s=wall_s, ticks=st["ticks"],
                tick_ms_median=statistics.median(per_tick) * 1e3,
                decode_ms_per_tick=st["decode_time_s"] / st["ticks"] * 1e3,
                prefill_tok_s=prompt_tokens / st["prefill_time_s"],
                kv_cache_bytes=st["kv_cache_bytes"],
                cache_dtypes=sorted({str(t.dtype) for name in ("k", "v")
                                     for t in engine.cache[name]}))


TP_TURNS = ("one_device", "mesh", "int8_kv", "int8_kv", "mesh", "one_device")
# phase 12 serves Llama-7B at 8 of its 32 layers (full depth until phase 22
# came, which the cut pays for): its checks compare engines in turns at one
# depth, and the int8 cache's bytes ratio is per layer
TP_LAYERS = 8


def phase_tp_serving(smi, pair):
    """12: Llama-7B (TP_LAYERS of its 32 layers) on the serving engine
    through the sharded decode on a one-device mesh (a) and with the int8 KV
    cache (b), in turns with the one-device bf16-cache engine on the same
    parameters and traffic; then on the same mesh Mixtral-8x7B int8 (c) and
    the serving features (d), each against the one-device engine; then
    phase 24's pair (started beside this phase) against 12c's tree."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.models.serving import ServingEngine
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh, shard_tree

    _one_rank_group()
    config = dataclasses.replace(llama.LlamaConfig.llama_7b(), n_layers=TP_LAYERS)
    rules = ShardingRules()
    mesh = build_mesh({"tensor": 1}, device_type="cuda")
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    sharded = shard_tree(params, mesh, llama.param_specs(config, rules))
    kinds = {"one_device": (params, {}), "mesh": (sharded, dict(mesh=mesh, rules=rules)),
             "int8_kv": (params, dict(kv_dtype="int8"))}
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, config.vocab_size, (n,), generator=rng).tolist()
               for n in SERVE_LENGTHS]
    dup = prompts[2]
    turns = {}
    for label in TP_TURNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tree, kw = kinds[label]
        engine = ServingEngine(tree, config, slots=8, max_len=1024, **kw)
        out = _drive_engine(engine, prompts, dup)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del engine
        turns.setdefault(label, []).append(out)
    del kinds
    ref = turns["one_device"][0]
    for label, runs in turns.items():
        for run in runs:
            bad = [(n, e, len(t)) for n, e, t in zip(list(SERVE_LENGTHS) + [len(dup)] * 2,
                                                     run["errors"], run["tokens"])
                   if e or len(t) != SERVE_NEW or not all(0 <= x < 32000 for x in t)]
            if bad:
                raise AssertionError(f"12 {label}: failed requests (prompt, error, tokens) {bad}")
            if run["tokens"][-1] != run["tokens"][-2]:
                raise AssertionError(f"12 {label}: one prompt sent twice gave different tokens")
            if run["launches"] < config.n_layers:
                raise AssertionError(f"12 {label}: flash launched {run['launches']} times")
            if label != "int8_kv":  # 12a: bit for bit, the same launches
                if run["tokens"] != ref["tokens"] or run["launches"] != ref["launches"]:
                    raise AssertionError(
                        f"12a {label}: tokens equal {run['tokens'] == ref['tokens']}, "
                        f"launches {run['launches']} vs {ref['launches']}")
                if run["cache_dtypes"] != ["torch.bfloat16"]:
                    raise AssertionError(f"12a {label}: cache {run['cache_dtypes']}")
            else:  # 12b
                if run["cache_dtypes"] != ["torch.int8"]:
                    raise AssertionError(f"12b: the int8 engine's cache is {run['cache_dtypes']}")
                if run["kv_cache_bytes"] > 0.51 * ref["kv_cache_bytes"]:
                    raise AssertionError(f"12b: cache {run['kv_cache_bytes']} bytes against "
                                         f"bf16's {ref['kv_cache_bytes']}")
                firsts = [t[0] for t in run["tokens"]]
                if firsts != [t[0] for t in ref["tokens"]]:
                    raise AssertionError("12b: a first token differs from the bf16 run's "
                                         "(prefill does not read the cache)")

    def mean(label, key):
        return statistics.mean(r[key] for r in turns[label])

    tick_ratio = mean("mesh", "tick_ms_median") / mean("one_device", "tick_ms_median")
    i8 = turns["int8_kv"][0]
    agree = sum(a == b for x, y in zip(i8["tokens"], ref["tokens"]) for a, b in zip(x, y))
    agree_share = agree / sum(len(t) for t in ref["tokens"])
    bytes_ratio = i8["kv_cache_bytes"] / ref["kv_cache_bytes"]
    for label, runs in turns.items():
        print(f"tp serving {label}: " + "; ".join(
            f"decode {r['decode_ms_per_tick']:.2f} ms/tick (median {r['tick_ms_median']:.2f}, "
            f"{r['ticks']} ticks), prefill {r['prefill_tok_s']:.0f} prompt tok/s, "
            f"peak {r['peak_gb']:.2f} GB, cache {r['kv_cache_bytes'] / 1e9:.3f} GB "
            f"{r['cache_dtypes']}, flash launches {r['launches']}" for r in runs), flush=True)
    print(f"tp serving: 12a mesh tokens equal the one-device engine's bit for bit, median "
          f"tick ratio mesh/one-device {tick_ratio:.4f}; 12b int8 cache "
          f"{i8['kv_cache_bytes'] / 1e9:.3f} GB vs bf16 {ref['kv_cache_bytes'] / 1e9:.3f} GB "
          f"(ratio {bytes_ratio:.4f}), first tokens equal, greedy tokens agreeing with the "
          f"bf16 run {agree}/{sum(len(t) for t in ref['tokens'])} ({agree_share:.4f})",
          flush=True)
    features = _phase("12d", _12d_features, params, sharded, config, mesh, rules, smi)
    del params, sharded
    gc.collect()
    torch.cuda.empty_cache()
    moe, moe_params, moe_config = _phase("12c", _12c_moe_int8, mesh, rules, smi)
    moe_pair = _phase("24 MoE int8 decode on tensor=2 and expert=2: a gloo pair",
                      _24_finish, pair, moe_params, moe_config, smi)
    del moe_params
    return dict(turns=turns, order=list(TP_TURNS), tick_ratio=tick_ratio,
                bytes_ratio=bytes_ratio, agree_share=agree_share,
                launches_mesh=turns["mesh"][0]["launches"],
                launches_int8=turns["int8_kv"][0]["launches"],
                c_moe=moe, d_features=features, moe_pair=moe_pair)


# 12c: Mixtral-8x7B int8 on the one-device mesh, in turns with the
# one-device engine; its tree (MOE_TP_SEED) is phase 24's one-process
# reference, which each rank of the pair builds alike
MOE_TP_LAYERS = 2
MOE_TP_SEED = 24
MOE_TP_TURNS = ("one_device", "mesh", "mesh", "one_device")
# 12d: the serving features on the mesh against one device
FEAT_CHUNK_PROMPT, FEAT_MAX_LEN = 2048, 2304  # 8 chunks of 256; buckets stop at 1024
FEAT_BUCKETS = [16, 32, 64, 128, 256, 512, 1024]
FEAT_PREFIX_NEW = 16
FEAT_RING_LAYERS, FEAT_RING_PROMPT, FEAT_RING_MAX_LEN = 2, 4400, 4608
# 24: the pair's meshes and traffic
MOE_PAIR_MESHES = ({"tensor": 2}, {"expert": 2})
MOE_PAIR_B, MOE_PAIR_PROMPT, MOE_PAIR_NEW, MOE_PAIR_SEED = 4, 512, 16, 25


def _12c_moe_int8(mesh, rules, smi):
    """Mixtral-8x7B (MOE_TP_LAYERS of 32) through the sharded decode on the
    one-device mesh, in turns with the one-device engine: the int8 tree is
    quantized whole (built layer by layer as phase 10 builds it) and then
    sharded, tokens bit for bit and K5 and K8 launches equal; then the bf16
    tree of the same depth, one turn each, through K5 and K6."""
    from kubedl_tpu_torch.models import llama, quant
    from kubedl_tpu_torch.parallel.mesh import shard_tree

    config = _mixtral(MOE_TP_LAYERS)
    params = _int8_tree(config, torch.Generator(device="cuda").manual_seed(MOE_TP_SEED))
    sharded = shard_tree(params, mesh, llama.param_specs(config, rules))
    if not quant.is_quantized(sharded["layers"][0]["moe"]["w1"]):
        raise AssertionError("12c: shard_tree did not keep the int8 leaves")
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, config.vocab_size, (n,), generator=rng).tolist()
               for n in SERVE_LENGTHS]
    turns, ref = _12c_turns(params, sharded, config, mesh, rules, prompts, MOE_TP_TURNS, "int8")
    del sharded
    # the bf16 stacks take K6 where the int8 ones take K8
    bf16 = llama.init(config, torch.Generator(device="cuda").manual_seed(MOE_TP_SEED),
                      device="cuda")
    b_turns, b_ref = _12c_turns(bf16, shard_tree(bf16, mesh, llama.param_specs(config, rules)),
                                config, mesh, rules, prompts, MOE_TP_TURNS[:2], "bf16")
    del bf16

    def mean(runs, label):
        return statistics.mean(r["tick_ms_median"] for r in runs[label])

    def ticks(runs):
        return "; ".join(f"{label} " + ", ".join(f"{r['tick_ms_median']:.2f}" for r in rs)
                         for label, rs in runs.items())

    print(f"12c moe int8 under a mesh [{smi}]: Mixtral-8x7B int8, {config.n_layers} of 32 "
          f"layers, quantized whole then shard_tree onto {{'tensor': 1}}, phase 4's traffic in "
          f"turns {' / '.join(MOE_TP_TURNS)}: tokens bit for bit, launches K5/K6/K7/K8 "
          f"{ref['gmm']} each turn; median tick {ticks(turns)} ms (mesh/one-device "
          f"{mean(turns, 'mesh') / mean(turns, 'one_device'):.4f}); flash launches "
          f"{ref['launches']}; bf16 tree in turns {' / '.join(MOE_TP_TURNS[:2])}: tokens bit "
          f"for bit, launches K5/K6/K7/K8 {b_ref['gmm']}, median tick {ticks(b_turns)} ms",
          flush=True)
    return dict(turns=turns, gmm=ref["gmm"], launches=ref["launches"],
                tick_ratio=mean(turns, "mesh") / mean(turns, "one_device"),
                bf16_turns=b_turns, bf16_gmm=b_ref["gmm"],
                bf16_launches=b_ref["launches"]), params, config


def _12c_turns(params, sharded, config, mesh, rules, prompts, order, kind):
    """Phase 4's traffic on the one-device and the mesh engine in the turns
    of `order`: every turn's tokens and grouped-matmul launches equal the
    first one-device turn's, the expert FFN's launches K5 with K8 (int8) or
    K6 (bf16), once a layer a forward at least."""
    from kubedl_tpu_torch.models.serving import ServingEngine

    turns = {}
    for label in order:
        gc.collect()
        torch.cuda.empty_cache()
        tree, kw = (params, {}) if label == "one_device" else (sharded,
                                                               dict(mesh=mesh, rules=rules))
        engine = ServingEngine(tree, config, slots=8, max_len=1024, **kw)
        _reset_gmm_counts()
        out = _drive_engine(engine, prompts, prompts[2])
        out["gmm"] = list(_gmm_counts())
        del engine
        turns.setdefault(label, []).append(out)
    ref = turns["one_device"][0]
    second = 3 if kind == "int8" else 1  # K8 or K6 beside K5
    for label, runs in turns.items():
        for run in runs:
            if any(run["errors"]) or any(len(t) != SERVE_NEW for t in run["tokens"]):
                raise AssertionError(f"12c {kind} {label}: failed requests {run['errors']}")
            g = run["gmm"]
            if g[0] != g[second] or g[0] < config.n_layers \
                    or any(g[i] for i in range(1, 4) if i != second):
                raise AssertionError(f"12c {kind} {label}: launches K5/K6/K7/K8 {g}")
            if run["tokens"] != ref["tokens"] or g != ref["gmm"]:
                raise AssertionError(f"12c {kind} {label}: tokens equal "
                                     f"{run['tokens'] == ref['tokens']}, launches {g} vs "
                                     f"{ref['gmm']}")
    return turns, ref


def _12d_features(params, sharded, config, mesh, rules, smi):
    """The serving features on the one-device mesh against the one-device
    engine on phase 12's 7B tree, bit for bit: chunked prefill beside
    decoding slots then a registered prefix (one engine a turn), a
    self-draft speculative engine; then ring caches at Mistral-7B widths."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.models.serving import ServingEngine
    from kubedl_tpu_torch.ops.flash_attention import flash_attention
    from kubedl_tpu_torch.parallel.mesh import shard_tree

    rng = torch.Generator().manual_seed(23)

    def draw(n):
        return torch.randint(1, config.vocab_size, (n,), generator=rng).tolist()

    long_prompt, shorts = draw(FEAT_CHUNK_PROMPT), [draw(CHUNK_SHORT) for _ in range(7)]
    prefix, suffixes = draw(PREFIX_LEN), [draw(n) for n in PREFIX_SUFFIXES[:4]]
    spec_prompts = [draw(n) for n in SERVE_LENGTHS[:4]]
    on = {"one_device": (params, {}), "mesh": (sharded, dict(mesh=mesh, rules=rules))}
    res, launches = {}, 0
    for label, (tree, kw) in on.items():
        gc.collect()
        torch.cuda.empty_cache()
        engine = ServingEngine(tree, config, slots=8, max_len=FEAT_MAX_LEN,
                               prompt_buckets=FEAT_BUCKETS, prefill_chunk=256, **kw)
        gap, long_req, ttft, n_fwd, short_reqs = _chunk_traffic(engine, shorts, long_prompt)
        chunked = engine.stats()["chunked_prefills"]
        flash_attention.launches = 0
        t0 = time.perf_counter()
        pid = engine.register_prefix(prefix)
        reqs = [engine.submit(sfx, FEAT_PREFIX_NEW, prefix_id=pid) for sfx in suffixes]
        while engine.has_pending():
            engine.step_block(8)
        torch.cuda.synchronize()
        prefix_s = time.perf_counter() - t0
        n_fwd += flash_attention.launches
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        flash_attention.launches = 0
        engine = ServingEngine(tree, config, slots=8, max_len=1024, draft_params=tree,
                               draft_config=config, **kw)
        spec_toks, round_ms, st = _spec_turn(engine, spec_prompts)
        n_fwd += flash_attention.launches
        del engine
        res[label] = dict(chunk=[r.tokens for r in short_reqs] + [long_req.tokens],
                          chunked=chunked, gap_ms=gap * 1e3, ttft_s=ttft,
                          prefix=[r.tokens for r in reqs], prefix_errors=[r.error for r in reqs],
                          prefix_s=prefix_s, spec=spec_toks, round_ms=round_ms,
                          acceptance=st["spec_acceptance"], launches=n_fwd)
        if label == "mesh":
            launches += n_fwd
    one, m = res["one_device"], res["mesh"]
    for label, r in res.items():
        if r["chunked"] != 1 or any(r["prefix_errors"]) \
                or any(len(t) != FEAT_PREFIX_NEW for t in r["prefix"]):
            raise AssertionError(f"12d {label}: chunked prefills {r['chunked']}, prefix "
                                 f"errors {r['prefix_errors']}")
        if r["acceptance"] < SELF_ACCEPT_MIN:
            raise AssertionError(f"12d {label}: self-draft acceptance {r['acceptance']}")
    for what in ("chunk", "prefix", "spec"):
        if m[what] != one[what]:
            raise AssertionError(f"12d: the mesh's {what} tokens differ from one device's")
    # ring caches at Mistral-7B widths, a prompt past the window
    mcfg = dataclasses.replace(_mistral(), n_layers=FEAT_RING_LAYERS)
    mp = llama.init(mcfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    ring_on = {"one_device": (mp, {}),
               "mesh": (shard_tree(mp, mesh, llama.param_specs(mcfg, rules)),
                        dict(mesh=mesh, rules=rules))}
    ring_prompts = [draw(FEAT_RING_PROMPT), draw(500)]
    ring = {}
    for label, (tree, kw) in ring_on.items():
        flash_attention.launches = 0
        engine = ServingEngine(tree, mcfg, slots=2, max_len=FEAT_RING_MAX_LEN, **kw)
        reqs = [engine.submit(p, RING_NEW) for p in ring_prompts]
        while engine.has_pending():
            engine.step_block(8)
        st = engine.stats()
        ring[label] = dict(tokens=[r.tokens for r in reqs], errors=[r.error for r in reqs],
                           ring=engine.ring, rows=engine.cache["k"][0].shape[2],
                           launches=flash_attention.launches,
                           decode_ms=st["decode_time_s"] / max(st["ticks"], 1) * 1e3)
        del engine
    del ring_on, mp
    for label, r in ring.items():
        if any(r["errors"]) or not r["ring"] or r["rows"] != mcfg.sliding_window:
            raise AssertionError(f"12d ring {label}: errors {r['errors']}, ring {r['ring']}, "
                                 f"rows {r['rows']}")
    if ring["mesh"]["tokens"] != ring["one_device"]["tokens"]:
        raise AssertionError("12d: the mesh's ring tokens differ from one device's")
    launches += ring["mesh"]["launches"]
    print(f"12d serving features under a mesh [{smi}]: Llama-7B {config.n_layers} of 32 layers "
          f"on {{'tensor': 1}} against one device, bit for bit: a {FEAT_CHUNK_PROMPT}-token "
          f"prompt chunked at 256 beside 7 decoding slots (longest token gap "
          f"{m['gap_ms']:.1f} ms against {one['gap_ms']:.1f}, first token after "
          f"{m['ttft_s']:.3f} s against {one['ttft_s']:.3f}); a {PREFIX_LEN}-token prefix and "
          f"{len(suffixes)} suffix requests ({m['prefix_s']:.3f} s against "
          f"{one['prefix_s']:.3f}); a self-draft, acceptance {m['acceptance']:.4f} "
          f"({one['acceptance']:.4f}), {m['round_ms']:.2f} ms a round against "
          f"{one['round_ms']:.2f}; ring at Mistral-7B widths ({mcfg.n_layers} of 32 layers), "
          f"a {FEAT_RING_PROMPT}-token prompt into {ring['mesh']['rows']} rows, decode "
          f"{ring['mesh']['decode_ms']:.2f} ms a tick against "
          f"{ring['one_device']['decode_ms']:.2f}; flash launches on the mesh {launches}",
          flush=True)
    return dict(features=res, ring=ring, launches=launches)


def _moe_pair_rank(rank, port, out_path):
    """One rank of phase 24's pair (run as `chip_smoke.py --moe-pair-rank R
    --moe-pair-port P --moe-pair-out PATH`): the seeded int8 tree quantized
    whole, sharded onto each mesh of MOE_PAIR_MESHES in turn, then
    `decode.generate` and a teacher-forced pass along its own tokens."""
    import torch.distributed as dist

    from kubedl_tpu_torch.models import decode, llama
    from kubedl_tpu_torch.parallel import collectives
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh, shard_tree
    from kubedl_tpu_torch.utils.device import gang_report

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    backend = dist.get_backend()
    print(f"24 rank {rank}: process group backend {backend}, 2 ranks sharing "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    if backend != "gloo":  # NCCL cannot hold two ranks on one device: no switch
        raise AssertionError(f"24: backend {backend} with two ranks on one card")
    config, rules = _mixtral(MOE_TP_LAYERS), ShardingRules()
    params = _int8_tree(config, torch.Generator(device="cuda").manual_seed(MOE_TP_SEED))
    prompt = _moe_pair_prompt(config)
    out = {}
    for axes in MOE_PAIR_MESHES:
        name = ",".join(f"{a}={n}" for a, n in axes.items())
        mesh = build_mesh(axes, device_type="cuda")
        sharded = shard_tree(params, mesh, llama.param_specs(config, rules))
        dist.barrier()
        _reset_gmm_counts()
        _reset_counts()
        collectives.staged_bytes, collectives.staged_s = 0, 0.0
        t0 = time.perf_counter()
        with torch.no_grad():
            toks = decode.generate(sharded, prompt, config, MOE_PAIR_NEW, mesh=mesh,
                                   rules=rules)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gmm, flash = list(_gmm_counts()), list(_counts())
        staged = (collectives.staged_bytes, collectives.staged_s)
        # the rank's logits (and router inputs) along its own tokens
        gates = []
        with torch.no_grad(), _gates_recorded(gates):
            local, par = decode._mesh_context(sharded, config, mesh, rules)
            cache = decode.init_kv_cache(config, MOE_PAIR_B, MOE_PAIR_PROMPT + MOE_PAIR_NEW,
                                         uniform=True, device="cuda", mesh=mesh, rules=rules)
            logits, cache = decode._prefill(local, prompt, cache, config, par=par)
            rows = [logits.float()]
            for i in range(MOE_PAIR_NEW - 1):
                logits, cache = decode._decode_block_step(local, toks[:, i:i + 1], cache,
                                                          config, check=False, par=par)
                rows.append(logits[:, 0].float())
        shapes = {n: list(local["layers"][0]["moe"][n]["q"].shape) for n in ("w1", "w3", "w2")}
        # the router's inputs come out of a sum over the ranks: every rank's
        # must be the same bits, or the ranks would route apart
        digest = hashlib.sha256(b"".join(g.cpu().numpy().tobytes() for g in gates)).hexdigest()
        mine = dict(tokens=toks.tolist(), gmm=gmm, flash=flash, shapes=shapes, gen_s=gen_s,
                    gates_sha256=digest,
                    staged_mb=staged[0] / 1e6, staged_s=staged[1],
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        ranks = [None, None]
        dist.all_gather_object(ranks, mine)
        if rank == 0:
            torch.save({"logits": torch.stack(rows, 1).cpu(), "gates": [g.cpu() for g in gates]},
                       out_path + f".{name}.pt")
            out[name] = dict(ranks=ranks)
        del sharded, local, par, cache, logits, rows
        torch.cuda.empty_cache()
    print(f"24 rank {rank}: {gang_report(torch.device('cuda', 0))}", flush=True)
    if rank == 0:
        out["backend"] = backend
        with open(out_path, "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _moe_pair_prompt(config):
    return torch.randint(1, config.vocab_size, (MOE_PAIR_B, MOE_PAIR_PROMPT), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(MOE_PAIR_SEED)).cuda()


def _24_start():
    """Phase 24's two processes, started to run beside phase 12."""
    os.makedirs(WORK, exist_ok=True)
    out_path = os.path.join(WORK, "moe-pair.json")
    logs = [os.path.join(WORK, f"moe-pair-rank{r}.log") for r in range(2)]
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--moe-pair-rank",
                               str(r), "--moe-pair-port", str(port), "--moe-pair-out", out_path],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              stdout=open(log, "w"), stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    return dict(procs=procs, logs=logs, out=out_path, t0=time.perf_counter())


def _routing_parted(got, ref, n_layers):
    """Rows and steps ([b, steps] bool) where a rank's routing of the row's
    current token (the prompt's last at step 0) differs from one process's
    in any layer, and how many of those partings the measured difference
    of the two gate logits does not explain: a parting is a near-tie when
    one process's margin between its choice and the rank's is no larger
    than twice the largest |gate logit difference| of that token."""
    k = 2
    steps = len(ref) // n_layers
    parted = torch.zeros((MOE_PAIR_B, steps), dtype=torch.bool)
    unexplained = 0
    for c, (g, r) in enumerate(zip(got, ref)):
        step = c // n_layers
        rows = (torch.arange(MOE_PAIR_B) + 1) * MOE_PAIR_PROMPT - 1 if step == 0 \
            else torch.arange(MOE_PAIR_B)
        for b, t in enumerate(rows.tolist()):
            mine = set(torch.topk(g[t], k).indices.tolist())
            theirs = set(torch.topk(r[t], k).indices.tolist())
            if mine == theirs:
                continue
            parted[b, step] = True
            margin = (min(r[t][e] for e in theirs - mine)
                      - max(r[t][e] for e in mine - theirs)).item()
            # the two choices' gap moves by at most twice the largest difference
            if margin > 2 * (g[t] - r[t]).abs().max().item():
                unexplained += 1
    return parted, unexplained


def _24_finish(pair, params, config, smi):
    """Wait for phase 24's pair and hold it to one process on the same
    tree: both ranks' tokens equal, first tokens one process's, the
    one-process logits along a rank's tokens within LOGIT_TOL of its own,
    K5/K8 launches and local stack shapes as each mesh implies."""
    from kubedl_tpu_torch.models import decode

    procs = pair["procs"]
    try:
        for p in procs:
            p.wait(timeout=900)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - pair["t0"]
    texts = [open(x).read() for x in pair["logs"]]
    if [p.returncode for p in procs] != [0, 0]:
        raise AssertionError(f"24 ranks exit {[p.returncode for p in procs]}:\n"
                             + "\n".join(t[-3000:] for t in texts))
    for t in texts:  # each rank's backend line and its gang_report line
        for line in t.strip().splitlines():
            if line.startswith("24 rank"):
                print(line, flush=True)
    with open(pair["out"]) as f:
        res = json.load(f)
    prompt = _moe_pair_prompt(config)
    with torch.no_grad():
        one = decode.generate(params, prompt, config, MOE_PAIR_NEW)
    n, e, ff = config.n_layers, config.n_experts, config.d_ff
    want_shapes = {"tensor=2": {"w1": [e, 4096, ff // 2], "w3": [e, 4096, ff // 2],
                                "w2": [e, ff // 2, 4096]},
                   "expert=2": {"w1": [e // 2, 4096, ff], "w3": [e // 2, 4096, ff],
                                "w2": [e // 2, ff, 4096]}}
    out, bad = {"wall_s": wall_s, "backend": res["backend"]}, []
    launches = [0, 0, 0, 0]
    for axes in MOE_PAIR_MESHES:
        name = ",".join(f"{a}={k}" for a, k in axes.items())
        ranks = res[name]["ranks"]
        toks = torch.tensor(ranks[0]["tokens"], dtype=torch.int32, device="cuda")
        # one process's logits (and router inputs) along the rank's tokens
        gates = []
        with torch.no_grad(), _gates_recorded(gates):
            cache = decode.init_kv_cache(config, MOE_PAIR_B, MOE_PAIR_PROMPT + MOE_PAIR_NEW,
                                         uniform=True, device="cuda")
            logits, cache = decode.prefill(params, prompt, cache, config)
            rows = [logits.float()]
            for i in range(MOE_PAIR_NEW - 1):
                logits, cache = decode.decode_step(params, toks[:, i], cache, config,
                                                   check=False)
                rows.append(logits.float())
        ref = torch.stack(rows, 1).cpu()
        saved = torch.load(pair["out"] + f".{name}.pt")
        got = saved["logits"]
        parted, unexplained = _routing_parted(saved["gates"], [g.cpu() for g in gates], n)
        rels = (got - ref).abs().amax(-1) / ref.abs().amax(-1)  # [b, step]
        rel = rels.masked_fill(parted, 0.0).max().item()
        same = ranks[0]["tokens"] == ranks[1]["tokens"]
        gates_same = ranks[0]["gates_sha256"] == ranks[1]["gates_sha256"]
        firsts = all(r[0] == o or bool(parted[b, 0]) for b, (r, o) in
                     enumerate(zip(ranks[0]["tokens"], one[:, 0].tolist())))
        agree = sum(a == b for x, y in zip(ranks[0]["tokens"], one.tolist())
                    for a, b in zip(x, y)) / one.numel()
        want_gmm = [n * MOE_PAIR_NEW, 0, 0, n * MOE_PAIR_NEW]  # a prefill + 15 steps
        for i, rk in enumerate(ranks):
            print(f"24 {name} rank {i} [{smi}]: generate {rk['gen_s']:.2f} s, launches "
                  f"K5/K6/K7/K8 {rk['gmm']} (expected {want_gmm}), flash fwd {rk['flash'][0]}, "
                  f"local stacks {rk['shapes']}, host-staged {rk['staged_mb']:.1f} MB in "
                  f"{rk['staged_s']:.3f} s, peak {rk['peak_gb']:.2f} GB", flush=True)
            if rk["gmm"] != want_gmm or rk["shapes"] != want_shapes[name] \
                    or rk["flash"][0] != n:
                bad.append(f"{name} rank {i}: launches {rk['gmm']}, flash {rk['flash']}, "
                           f"shapes {rk['shapes']}")
            launches = [a + b for a, b in zip(launches, rk["gmm"])]
        print(f"24 {name} [{smi}]: Mixtral-8x7B int8, {n} of 32 layers, b {MOE_PAIR_B} x "
              f"{MOE_PAIR_PROMPT}, {MOE_PAIR_NEW} greedy tokens: ranks equal {same}, router "
              f"inputs bitwise equal on both ranks {gates_same} ({len(saved['gates'])} routing "
              f"calls), first "
              f"tokens equal one process's {firsts}, tokens agreeing with one process "
              f"{agree:.4f}; one process's logits along the rank's tokens max rel {rel:.3e} "
              f"(tol {LOGIT_TOL}) over the {int((~parted).sum())} of {parted.numel()} row-steps "
              f"whose routing equals one process's; the {int(parted.sum())} others part at a "
              f"router near-tie within the gate logits' measured difference (unexplained "
              f"{unexplained}), their logits max rel {rels[parted].max().item() if parted.any() else 0.0:.3e}",
              flush=True)
        if not same or not gates_same or not firsts or rel > LOGIT_TOL or unexplained \
                or parted.float().mean().item() > 0.25:
            bad.append(f"{name}: ranks equal {same}, router inputs {gates_same}, first tokens "
                       f"{firsts}, logits rel {rel}, "
                       f"parted routings {int(parted.sum())}, unexplained {unexplained}")
        out[name] = dict(ranks=ranks, logits_rel=rel, agree=agree,
                         routing_parted=int(parted.sum()), gen_s=[rk["gen_s"] for rk in ranks])
    print(f"24 [{smi}]: pair wall {wall_s:.1f} s from its start beside phase 12", flush=True)
    if bad:
        raise AssertionError("24: " + "; ".join(bad))
    out["launches"] = launches
    return out

# -- the MoE slice: grouped matmul kernels, gradients, training, int8 serving --


def _mixtral(n_layers):
    """Mixtral-8x7B's widths (mistralai/Mixtral-8x7B-v0.1 config.json:
    d_model 4096, 32 q / 8 kv heads, d_ff 14336, 8 experts top 2, vocab
    32000, rope_theta 1e6, rms_eps 1e-5, bf16) at n_layers of its 32."""
    from kubedl_tpu_torch.models import llama

    return llama.LlamaConfig(vocab_size=32000, d_model=4096, n_layers=n_layers, n_heads=32,
                             n_kv_heads=8, d_ff=14336, max_seq_len=32768, rope_theta=1e6,
                             rms_eps=1e-5, n_experts=8, expert_top_k=2)


def _gmm_counts():
    from kubedl_tpu_torch.ops import gmm as G

    return (G.gmm_swiglu.launches, G.gmm.launches, G.tgmm.launches, G.gmm_scaled.launches)


def _reset_gmm_counts():
    from kubedl_tpu_torch.ops import gmm as G

    G.gmm_swiglu.launches = G.gmm.launches = G.tgmm.launches = G.gmm_scaled.launches = 0


@contextlib.contextmanager
def _moe_through_plain(routing):
    """For the length of the block, models/moe.py's grouped products are the
    plain versions (autograd of plain PyTorch) and its routing replays the
    expert choices of the kernel run (`routing`, recorded by `_recorded`):
    the reference side of phases 8 and 10. bf16 rounding that differs
    between the two sides would otherwise flip a near-tie and send a token
    to another expert, which is a different computation. The package itself
    has no such switch. Yields the number of replayed choices that the
    plain side's own routing would have made differently."""
    from kubedl_tpu_torch.models import moe
    from kubedl_tpu_torch.ops import gmm as G

    saved = moe.gmm, moe.gmm_scaled, moe.gmm_swiglu, moe._top_k_gating
    calls = iter(routing)
    flips = [0]

    def gating(gate_logits, top_k, capacity, need_slots=True):
        if need_slots:
            raise AssertionError("routing replay covers the dropless route only")
        own = saved[3](gate_logits, top_k, capacity, need_slots=False)
        experts = next(calls)
        flips[0] += int((own[0] != experts).sum())
        probs = torch.softmax(gate_logits, dim=-1)
        gates = probs.gather(1, experts.T.long()).T.float()
        weights = gates / gates.sum(dim=0, keepdim=True).clamp_min(1e-9)
        s = gate_logits.shape[0]
        ce = torch.zeros_like(own[4][1]).index_add_(
            0, experts[0].long(), torch.full((s,), 1.0 / s, device=gate_logits.device))
        return experts, own[1], weights, own[3], (probs.mean(dim=0), ce)

    moe.gmm = lambda lhs, rhs, te, row_tile=G.TILE_M: G.gmm_plain(lhs, rhs, te)
    moe.gmm_scaled = lambda lhs, rhs, te, s, row_tile=G.TILE_M: G.gmm_scaled_plain(
        lhs, rhs, te, s)
    moe.gmm_swiglu = lambda lhs, w1, w3, te, s1, s3, row_tile=G.TILE_M: G.gmm_swiglu_plain(
        lhs, w1, w3, te, s1, s3)
    moe._top_k_gating = gating
    try:
        yield flips
    finally:
        moe.gmm, moe.gmm_scaled, moe.gmm_swiglu, moe._top_k_gating = saved
        if next(calls, None) is not None:
            raise AssertionError("the plain run routed fewer times than the kernel run")


@contextlib.contextmanager
def _recorded(routing):
    """Append the expert choices of every routing call in the block to
    `routing` (the kernel side of phases 8 and 10)."""
    from kubedl_tpu_torch.models import moe

    real = moe._top_k_gating

    def gating(*args, **kwargs):
        out = real(*args, **kwargs)
        routing.append(out[0].detach().clone())
        return out

    moe._top_k_gating = gating
    try:
        yield
    finally:
        moe._top_k_gating = real


@contextlib.contextmanager
def _gates_recorded(gates):
    """Append the router's gate logits [S, E] of every routing call in the
    block to `gates` (phase 24's teacher-forced passes)."""
    from kubedl_tpu_torch.models import moe

    real = moe._top_k_gating

    def gating(gate_logits, *args, **kwargs):
        gates.append(gate_logits.detach().float().clone())
        return real(gate_logits, *args, **kwargs)

    moe._top_k_gating = gating
    try:
        yield
    finally:
        moe._top_k_gating = real


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _library(fn):
    """(ms, None) for one PyTorch call, or (None, why) when this torch has
    no such call for these layouts: the yardstick only, never the port."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, AttributeError, TypeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return _time_ms(fn), None


def phase_gmm_kernels():
    """K5-K8 against their plain versions at Mixtral widths; returns
    {shape: {kernel case: numbers}}."""
    from kubedl_tpu_torch.models import moe
    from kubedl_tpu_torch.ops import gmm as G

    d, ff, e = 4096, 14336, 8
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def scales(n, fan_in):  # ~max|w| / 127 of a trunc-normal / sqrt(fan_in) column
        return (torch.rand((e, n), generator=gen, device="cuda") * 0.5 + 0.75) * (
            2 * fan_in ** -0.5 / 127)

    w1, w3, w2 = randn(e, d, ff, scale=d ** -0.5), randn(e, d, ff, scale=d ** -0.5), \
        randn(e, ff, d, scale=ff ** -0.5)
    q1, q3, q2 = codes(e, d, ff), codes(e, d, ff), codes(e, ff, d)
    s1, s3, s2 = scales(ff, d), scales(ff, d), scales(d, ff)
    ones = torch.ones((e, ff), device="cuda")
    results = {}
    for name, (t, live) in GMM_SHAPES.items():
        logits = torch.randn((t, e), generator=gen, device="cuda")
        logits[:, live:] = -1e4
        experts = moe._top_k_gating(logits, 2, t + 1, need_slots=False)[0]
        eid = experts.reshape(-1)
        order, dest, _, te, m_pad = moe._dispatch_plan(eid, e)
        r, tile = eid.numel(), m_pad // te.numel()
        group = moe._counts(eid, e)
        owned = int((group > 0).sum())
        offs = torch.cumsum((group + tile - 1) // tile * tile, 0).to(torch.int32)
        src_rows = torch.arange(t, device="cuda").repeat(2)

        def routed(width, scale=1.0):  # real rows in the padded layout, zero padding
            return moe._permute(randn(t, width, scale=scale), src_rows, order, dest, m_pad)

        x = routed(d)
        h = G.gmm_swiglu_cuda(x, w1, w3, te, ones, ones)
        dy, dg = routed(d), routed(ff, 0.1)
        wb, sb = 2 * owned * d * ff, 4 * owned * ff  # one stack's bytes (bf16), scales
        io = 2 * r * (d + ff)                        # the routed rows in and out
        bf16 = torch.bfloat16
        cases = {  # name: (kernel, plain, library or None, tolerance, flop, bytes)
            "gmm_swiglu": (lambda: G.gmm_swiglu_cuda(x, w1, w3, te, ones, ones),
                           lambda: G.gmm_swiglu_plain(x, w1, w3, te, ones, ones),
                           None, GMM_TOL, 4 * r * d * ff, 2 * wb + io),
            "gmm_swiglu_int8": (lambda: G.gmm_swiglu_cuda(x, q1, q3, te, s1, s3),
                                lambda: G.gmm_swiglu_plain(x, q1, q3, te, s1, s3),
                                None, GMM_TOL, 4 * r * d * ff, wb + 2 * sb + io),
            "gmm": (lambda: G.gmm_cuda(h, w2, te), lambda: G.gmm_plain(h, w2, te),
                    lambda: torch._grouped_mm(h, w2, offs=offs), GMM_TOL,
                    2 * r * d * ff, wb + io),
            "gmm_T": (lambda: G.gmm_cuda(dy, w2.transpose(1, 2), te),
                      lambda: G.gmm_plain(dy, w2.transpose(1, 2), te),
                      lambda: torch._grouped_mm(dy, w2.transpose(1, 2), offs=offs), GMM_TOL,
                      2 * r * d * ff, wb + io),
            "gmm_scaled": (lambda: G.gmm_cuda(h, q2, te, s2),
                           lambda: G.gmm_scaled_plain(h, q2, te, s2), None, GMM_TOL,
                           2 * r * d * ff, wb // 2 + 4 * owned * d + io),
            "gmm_scaled_bf16": (lambda: G.gmm_cuda(h, w2, te, s2),
                                lambda: G.gmm_scaled_plain(h, w2, te, s2), None, GMM_TOL,
                                2 * r * d * ff, wb + 4 * owned * d + io),
            "tgmm": (lambda: G.tgmm_cuda(x, dg, te, e), lambda: G.tgmm_plain(x, dg, te, e),
                     lambda: torch._grouped_mm(x.t(), dg, offs=offs), TGMM_TOL,
                     2 * r * d * ff, io + 4 * e * d * ff),
            # the training step's K7: the weights' dtype, one rounding of the f32 sum
            "tgmm_bf16": (lambda: G.tgmm_cuda(x, dg, te, e, out_dtype=bf16),
                          lambda: G.tgmm_plain(x, dg, te, e, out_dtype=bf16),
                          lambda: torch._grouped_mm(x.t(), dg, offs=offs), GMM_TOL,
                          2 * r * d * ff, io + 2 * e * d * ff),
        }
        unrouted = [i for i in range(e) if int(group[i]) == 0]
        shape = {}
        for kname, (kern, plain, lib, tol, flop, nbytes) in cases.items():
            got = kern()
            same, zero = torch.equal(got, kern()), True
            if kname.startswith("tgmm"):
                zero = all(got[i].abs().max().item() == 0.0 for i in unrouted)
            torch.cuda.synchronize()
            ref = plain()
            err, abs_err = _rel(got, ref), (got.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(got.float()).all())
            del got, ref
            kernel_ms = _time_ms(kern)
            plain_ms = _time_ms(plain, warmup=1, iters=3)
            library_ms, why = (None, "no single PyTorch call computes it") if lib is None \
                else _library(lib)
            if kname == "tgmm" and library_ms is not None:
                why = "bf16 output: torch._grouped_mm refuses an f32 out_dtype here"
            elif kname == "tgmm_bf16" and library_ms is not None:
                why = "like for like: bf16 output"
            bound_ms, bound_by = _bound(flop, nbytes)
            n = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                     library_note=why, bound_ms=bound_ms, bound_by=bound_by,
                     share_of_bound=bound_ms / kernel_ms, tflops=flop / kernel_ms / 1e9,
                     rel_err=err, max_abs_err=abs_err, deterministic=same,
                     unrouted_zero=zero, routed_rows=r,
                     m_pad=m_pad, row_tile=tile, executed_share=m_pad / r,
                     experts_owning_rows=owned)
            shape[kname] = n
            lib_s = f"{library_ms:.4f}" if library_ms is not None else f"n/a ({why})"
            print(f"gmm {name} {kname}: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.3f} "
                  f"library_ms={lib_s} bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"share={n['share_of_bound']:.3f} tflops={n['tflops']:.1f} rel_err={err:.2e} "
                  f"R={r} m_pad={m_pad} tile={tile} m_pad/R={m_pad / r:.3f} owned={owned} "
                  f"deterministic={same}"
                  + (f" unrouted_zero={zero} ({len(unrouted)} unrouted)"
                     if kname.startswith("tgmm") else "")
                  + (f" tile_n={G.sm90_tile_n(m_pad, d, G.EPI_SCALE, G._sms(x.device))}"
                     if kname.startswith("gmm_scaled") else ""), flush=True)
            if not finite or not same or not zero or err > tol:
                raise AssertionError(f"{kname} disagrees with its plain version at {name}: "
                                     f"finite={finite} deterministic={same} "
                                     f"unrouted_zero={zero} rel_err={err} (tol {tol})")
        results[name] = shape
        del x, h, dy, dg
    del w1, w3, w2, q1, q3, q2
    gc.collect()
    torch.cuda.empty_cache()
    return results


def _leaf_names(tree, prefix=""):
    """Dotted names in llama.tree_leaves order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_names(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_names(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1]


def phase_moe_grads():
    """loss_fn and every gradient of a 2-layer Mixtral-width model, b=2,
    S=1024, through the gmm kernels against the plain versions."""
    from kubedl_tpu_torch.models import llama

    config = _mixtral(2)
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.randint(0, config.vocab_size, (2, 1025), device="cuda", dtype=torch.int32,
                           generator=torch.Generator(device="cuda").manual_seed(9))
    out, routing, flips = {}, [], [0]
    for label in ("kernel", "plain"):
        tree = llama.tree_map(lambda x: x.detach().requires_grad_(True), params)
        leaves = list(llama.tree_leaves(tree))
        _reset_gmm_counts()
        with _recorded(routing) if label == "kernel" else _moe_through_plain(routing) as f:
            loss = llama.loss_fn(tree, tokens, config)
            grads = torch.autograd.grad(loss, leaves)
        flips = f if label == "plain" else flips
        torch.cuda.synchronize()
        out[label] = (loss.item(), grads, _gmm_counts())
        del tree, leaves, loss
    n = config.n_layers
    (lk, gk, ck), (lp, gp, cp) = out["kernel"], out["plain"]
    # per layer under full remat: forward K5 + K6 (w2), again in the
    # recompute; w2's backward K6 (dlhs) + K7; the SwiGLU's backward 2 K6
    # recomputing gate and up, 2 K6 for dlhs, 2 K7 for dw1 and dw3
    want = (2 * n, 7 * n, 3 * n, 0)
    if ck != want or cp != (0, 0, 0, 0):
        raise AssertionError(f"MoE gradient launches (K5, K6, K7, K8): kernel path {ck} "
                             f"(expected {want}), plain path {cp}")
    errs = {}
    for nm, a, b in zip(_leaf_names(params), gk, gp):
        if a.dtype != b.dtype or not bool(torch.isfinite(a.float()).all()):
            raise AssertionError(f"gradient {nm}: dtype {a.dtype} vs {b.dtype} or not finite")
        errs[nm] = _rel(a, b)
    worst = max(errs, key=errs.get)
    loss_rel = abs(lk - lp) / abs(lp)
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    print(f"moe grads: Mixtral width, 2 layers, b=2 S=1024: loss kernel {lk:.6f} plain "
          f"{lp:.6f} (rel {loss_rel:.2e}); worst gradient {worst} rel {errs[worst]:.3e} over "
          f"{len(errs)} leaves (tol {GRAD_TOL}; next: "
          + ", ".join(f"{k} {v:.2e}" for k, v in top[1:]) + f"); launches K5/K6/K7/K8 {ck}; "
          f"{len(routing)} routing calls replayed, {flips[0]} of "
          f"{sum(r.numel() for r in routing)} choices a near-tie flipped", flush=True)
    if loss_rel > 1e-2 or errs[worst] > GRAD_TOL:
        raise AssertionError("MoE gradients through the kernels disagree with the plain path")
    del params, out, gk, gp
    gc.collect()
    torch.cuda.empty_cache()
    return dict(loss_kernel=lk, loss_plain=lp, loss_rel=loss_rel, grad_rel_err=errs,
                launches=list(ck), routing_flips=flips[0])


def phase_moe_train():
    """Mixtral width, 4 of 32 layers: 6 make_train_step steps, b=4, rows of
    1024 tokens, AdamW with clip 1.0 (the trainer's optimizer)."""
    from torch.profiler import ProfilerActivity, profile

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import make_train_step

    steps, batch, seq = 6, 4, 1024
    config = _mixtral(4)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = llama.param_count(params)
    expert = sum(layer["moe"][w].numel() for layer in params["layers"]
                 for w in ("w1", "w3", "w2"))
    active = n_params - expert * (1 - config.expert_top_k / config.n_experts)
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(3e-4, weight_decay=0.01))
    init_state, train_step = make_train_step(lambda p, b: llama.loss_fn(p, b, config), tx)
    state = init_state(params)
    del params
    gen = torch.Generator(device="cuda").manual_seed(10)
    batches = [torch.randint(0, config.vocab_size, (batch, seq), generator=gen, device="cuda",
                             dtype=torch.int32) for _ in range(steps + 1)]
    _reset_gmm_counts()
    _reset_counts()
    losses, gnorms, times = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[i])
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
        times.append(time.perf_counter() - t0)
    counts, flash = _gmm_counts(), _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = config.n_layers
    want = (2 * n * steps, 7 * n * steps, 3 * n * steps, 0)
    if counts != want:
        raise AssertionError(f"MoE train launches (K5, K6, K7, K8) {counts}, expected {want}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"MoE train: non-finite loss or grad_norm {losses} {gnorms}")
    if abs(losses[0] - math.log(config.vocab_size)) > 1.5:
        raise AssertionError(f"MoE first loss {losses[0]} not within 1.5 of ln 32000")
    step_s = statistics.median(times[1:])
    tokens = batch * (seq - 1)
    attn_flop = 12 * n * batch * config.n_heads * config.head_dim * \
        _attended_pairs(seq - 1, True, None)
    model_flop = 6 * active * tokens + attn_flop
    mfu = model_flop / (step_s * PEAK_BF16_FLOPS)
    profile_dir = os.path.join(WORK, "profile-moe")
    shutil.rmtree(profile_dir, ignore_errors=True)
    os.makedirs(profile_dir)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[steps])
        metrics["loss"].item()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = os.path.join(profile_dir, "step.json")
    prof.export_chrome_trace(trace)
    prof_numbers = _kernel_profile(trace, wall_ms)
    share = "not measured" if prof_numbers["idle_share"] is None else \
        f"{prof_numbers['idle_share']:.3f}"
    print(f"moe train: Mixtral width, {n} layers ({n_params / 1e9:.3f}B params, "
          f"{active / 1e9:.3f}B active), {steps} steps b={batch} seq={seq}; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; grad_norm "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}", flush=True)
    print(f"moe train: step {step_s * 1e3:.1f} ms (median of steps 2-{steps}; first "
          f"{times[0] * 1e3:.1f} ms), {tokens / step_s:.0f} tok/s, active-parameter FLOP "
          f"share (6*N_active*T + attention = {model_flop:.3e} over step x 989e12) {mfu:.3f}; "
          f"peak allocated {peak_gb:.2f} GB; launches K5/K6/K7/K8 {counts}, flash "
          f"fwd/dq/dkv {flash}", flush=True)
    print(f"profile moe train step: wall {prof_numbers['wall_ms']:.1f} ms (profiled), device "
          f"busy {prof_numbers['device_busy_ms']:.1f} ms, idle share {share}, "
          f"{prof_numbers['kernels']} kernels; top: " + "; ".join(
              f"{nm} {ms:.2f} ms" for nm, ms in prof_numbers["top"]), flush=True)
    print("profile moe train step by kind: " + "; ".join(
        f"{k} {ms:.1f} ms" for k, ms in prof_numbers["groups"].items()), flush=True)
    print(f"moe train summary: step {step_s * 1e3:.1f} ms, gmm kernels "
          f"{prof_numbers['groups']['gmm kernels']:.1f} ms of "
          f"{prof_numbers['device_busy_ms']:.1f} ms device time in the profiled step",
          flush=True)
    del state, batches, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return dict(n_params=n_params, active_params=active, losses=losses, grad_norms=gnorms,
                step_ms=step_s * 1e3, first_step_ms=times[0] * 1e3, tok_s=tokens / step_s,
                model_flop_per_step=model_flop, active_flop_share=mfu, peak_gb=peak_gb,
                launches=list(counts), flash_launches=list(flash), profile=prof_numbers)


def _int8_tree(config, gen):
    """The int8 tree of a fresh init built layer by layer on the card: each
    layer is drawn in bf16 and quantized before the next is drawn, so the
    bf16 model never exists whole."""
    from kubedl_tpu_torch.models import llama, quant

    params = quant.quantize_params(llama.init(dataclasses.replace(config, n_layers=0), gen,
                                              device="cuda"))
    for _ in range(config.n_layers):
        params["layers"].append(quant.quantize_layer(llama.init_layer(config, gen, "cuda")))
        torch.cuda.empty_cache()
    return params


def phase_moe_serve():
    """Mixtral-8x7B, int8, full width, MOE_SERVE_LAYERS deep, on the
    serving engine."""
    from kubedl_tpu_torch.models import decode, quant
    from kubedl_tpu_torch.models.serving import ServingEngine

    gen = torch.Generator(device="cuda").manual_seed(11)
    # a 2-layer int8 prefill through the kernels against the plain versions
    cfg2 = _mixtral(2)
    small = _int8_tree(cfg2, gen)
    prompt = torch.randint(1, cfg2.vocab_size, (2, 512), generator=gen, device="cuda",
                           dtype=torch.int32)
    got, routing = {}, []
    for label in ("kernel", "plain"):
        _reset_gmm_counts()
        cache = decode.init_kv_cache(cfg2, 2, 512, uniform=True, device="cuda")
        with _recorded(routing) if label == "kernel" else _moe_through_plain(routing):
            logits, _ = decode.prefill(small, prompt, cache, cfg2)
        torch.cuda.synchronize()
        got[label] = (logits.float(), _gmm_counts())
        del cache
    (lk, ck), (lp, cp) = got["kernel"], got["plain"]
    prefill_rel = _rel(lk, lp)
    print(f"moe serve: 2-layer int8 prefill of 2 x 512 tokens, last-token logits through the "
          f"kernels vs plain: rel {prefill_rel:.3e} (tol {GRAD_TOL}); launches K5/K6/K7/K8 "
          f"{ck} vs {cp}", flush=True)
    if ck != (2, 0, 0, 2) or cp != (0, 0, 0, 0) or prefill_rel > GRAD_TOL \
            or not bool(torch.isfinite(lk).all()):
        raise AssertionError("int8 MoE prefill through the kernels disagrees with the plain path")
    # a decode step of the 2-layer tree with any host sync made an error:
    # routing, dispatch and the kernels must not stall a tick on the host
    cache = decode.init_kv_cache(cfg2, 2, 520, device="cuda")
    _, cache = decode.prefill(small, prompt, cache, cfg2)
    tok = lk.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_logits, _ = decode.decode_step(small, tok, cache, cfg2, check=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not bool(torch.isfinite(step_logits).all()):
        raise AssertionError("non-finite int8 MoE decode-step logits")
    print("moe serve: a 2-layer int8 decode step ran with host syncs made errors "
          "(torch.cuda.set_sync_debug_mode): none", flush=True)
    del small, got, lk, lp, cache, step_logits
    gc.collect()
    torch.cuda.empty_cache()

    config = _mixtral(MOE_SERVE_LAYERS)
    n = config.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _int8_tree(config, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tree_gb = quant.tree_bytes(params) / 1e9
    engine = ServingEngine(params, config, slots=8, max_len=1024)
    rng = torch.Generator().manual_seed(12)
    prompts = [torch.randint(1, config.vocab_size, (n,), generator=rng).tolist()
               for n in MOE_SERVE_LENGTHS]
    dup = prompts[2]
    _reset_gmm_counts()
    _reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, SERVE_NEW) for p in prompts]
    while engine.has_pending():
        engine.step_block()
    pair = [engine.submit(dup, SERVE_NEW) for _ in range(2)]
    while engine.has_pending():
        engine.step_block()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts, flash = _gmm_counts(), _counts()
    stats = engine.stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in reqs + pair:
        if r.error or len(r.tokens) != SERVE_NEW or not all(0 <= x < 32000 for x in r.tokens):
            raise AssertionError(f"request of {len(r.prompt)} prompt tokens: error "
                                 f"{r.error}, {len(r.tokens)} tokens")
    if pair[0].tokens != pair[1].tokens:
        raise AssertionError("one prompt sent twice gave different tokens")
    forwards = stats["prefill_batches"] + stats["ticks"]
    if counts != (n * forwards, 0, 0, n * forwards):
        raise AssertionError(f"int8 serving launches (K5, K6, K7, K8) {counts}; expected K5 = "
                             f"K8 = {n} layers x {forwards} forwards and no K6, K7")
    if flash[0] < n * stats["prefill_batches"] or flash[1:] != (0, 0):
        raise AssertionError(f"int8 serving flash launches (fwd, dq, dkv) {flash} for "
                             f"{stats['prefill_batches']} prefill dispatches x {n} layers")
    n_req = len(reqs) + len(pair)
    prompt_tokens = sum(MOE_SERVE_LENGTHS) + 2 * len(dup)
    numbers = dict(
        layers=config.n_layers, tree_gb=tree_gb, init_s=init_s, requests=n_req,
        wall_s=wall_s, prompt_tokens=prompt_tokens, tokens_out=stats["tokens_out"],
        prefill_batches=stats["prefill_batches"], ticks=stats["ticks"],
        prefill_time_s=stats["prefill_time_s"], decode_time_s=stats["decode_time_s"],
        prefill_tok_s=prompt_tokens / stats["prefill_time_s"],
        decode_tok_s=(stats["tokens_out"] - n_req) / stats["decode_time_s"],
        peak_gb=peak_gb, launches=list(counts), flash_launches=flash[0],
        prefill_rel_err=prefill_rel)
    print(f"moe serve: Mixtral-8x7B int8, {n} of 32 layers, tree {tree_gb:.2f} GB built in "
          f"{init_s:.1f} s; {n_req} requests ok in {wall_s:.2f} s; prefill "
          f"{stats['prefill_batches']} dispatches {stats['prefill_time_s']:.3f} s "
          f"({numbers['prefill_tok_s']:.0f} prompt tok/s); decode {stats['decode_time_s']:.3f} s "
          f"over {stats['ticks']} ticks ({stats['decode_time_s'] / max(stats['ticks'], 1) * 1e3:.1f}"
          f" ms/tick, {numbers['decode_tok_s']:.1f} tok/s); launches K5/K6/K7/K8 {counts}, "
          f"flash fwd {flash[0]}; "
          f"peak allocated {peak_gb:.2f} GB", flush=True)
    numbers["profile"] = _profile_engine(engine)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return numbers


# -- phase 13: the serving features (chunked prefill, prefixes, speculative
# serving, ring caches, logprobs) --------------------------------------------

CHUNK_PROMPT, CHUNK_NEW = 3840, 8      # 13a: 15 chunks of 256 into max_len 4096
CHUNK_SHORT, CHUNK_SHORT_NEW = 64, 48  # the seven slots decoding meanwhile
LOGIT_TOL = 0.05          # max|a - b| / max|b| of two bf16 7B paths (phase 3's bound)
PREFIX_LEN, PREFIX_SUFFIXES = 1024, (32, 44, 56, 68, 80, 96, 112, 128)
SPEC_NEW, SELF_ACCEPT_MIN = 32, 0.9
RING_PROMPT, RING_NEW = 6000, 32       # 13d: wraps a 4096-row ring of max_len 8192
RING_LAYERS = 8                        # 13d and 13e: 8 of Mistral-7B's 32 (cut for phase 21)
# 13e: |logprob - teacher-forced log_softmax| of bf16 7B logits; on an H100
# a sound run read 0.031 and the two wrong logprobs 1.02 and 1.24 (PERF.md)
LP_TOL = 0.1
LP_REPLAY_TOL = 1e-5      # 13e: |logprob - log_softmax of the same path's logits|


def _compare_logits(got, ref, what):
    """(max_abs, scale, argmax agree) of two [V] logit rows; raises past
    LOGIT_TOL, or on a differing argmax that is not a near-tie within the
    measured error."""
    got, ref = got.float(), ref.float()
    if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise AssertionError(f"{what}: non-finite logits")
    max_abs = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    ag, ar = int(got.argmax()), int(ref.argmax())
    if max_abs > LOGIT_TOL * scale or (ag != ar and (ref[ar] - ref[ag]).item() > max_abs):
        raise AssertionError(f"{what}: max_abs {max_abs:.4e} of max|logit| {scale:.3f}, "
                             f"argmax {ag} vs {ar}")
    return max_abs, scale, ag == ar


def _agree(a, b):
    """Share of equal greedy tokens over request lists a and b."""
    n = sum(len(x) for x in b)
    return sum(p == q for x, y in zip(a, b) for p, q in zip(x, y)) / n


def _chunk_traffic(engine, prompts, long_prompt):
    """Seven short requests decoding, then the long prompt arrives; the
    engine driven by step(). Returns (longest gap between two tokens of a
    short request while the long prompt enters, s; the long request;
    seconds from its submit to its first token)."""
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    flash_attention.launches = 0
    shorts = [engine.submit(p, CHUNK_SHORT_NEW) for p in prompts]
    for r in shorts:
        r.token_times = []
    for _ in range(4):
        engine.step()
    torch.cuda.synchronize()
    t_sub = time.monotonic()
    long_req = engine.submit(long_prompt, CHUNK_NEW)
    while not long_req.tokens:
        engine.step()
    t_first = long_req.first_token_at
    while engine.has_pending():
        engine.step()
    gaps = [b - a for r in shorts for a, b in zip(r.token_times, r.token_times[1:])
            if b > t_sub and a < t_first]
    bad = [r.error for r in shorts + [long_req] if r.error or not r.done]
    if bad or len(long_req.tokens) != CHUNK_NEW:
        raise AssertionError(f"13a: failed requests {bad}")
    return max(gaps), long_req, t_first - t_sub, flash_attention.launches, shorts


def _13a_chunked(params, config, smi):
    from kubedl_tpu_torch.models import decode
    from kubedl_tpu_torch.models.serving import ServingEngine

    rng = torch.Generator().manual_seed(13)
    prompts = [torch.randint(1, config.vocab_size, (CHUNK_SHORT,), generator=rng).tolist()
               for _ in range(7)]
    long_prompt = torch.randint(1, config.vocab_size, (CHUNK_PROMPT,), generator=rng).tolist()
    buckets = [16 << i for i in range(7)]  # 16 .. 1024
    out = {}
    for label, kw in (("chunked", dict(prompt_buckets=buckets, prefill_chunk=256)),
                      ("one_pass", dict(prompt_buckets=buckets + [2048, 4096],
                                        prefill_chunk=0))):
        engine = ServingEngine(params, config, slots=8, max_len=4096, **kw)
        firsts, chunks = [], [0]
        sample_first, append = engine._sample_first, engine._append_block

        def keep_first(logits, req, _f=sample_first):
            firsts.append((req, logits[0].float().clone()))
            return _f(logits, req)

        def count_chunk(*a, _f=append):
            chunks[0] += 1
            return _f(*a)

        engine._sample_first, engine._append_block = keep_first, count_chunk
        gap, long_req, ttft, launches, shorts = _chunk_traffic(engine, prompts, long_prompt)
        st = engine.stats()
        out[label] = dict(gap_ms=gap * 1e3, ttft_s=ttft, launches=launches, chunks=chunks[0],
                          chunked_prefills=st["chunked_prefills"],
                          tokens=[r.tokens for r in shorts] + [long_req.tokens],
                          first_logits=[lg for r, lg in firsts if r is long_req])
        del engine, firsts
        gc.collect()
        torch.cuda.empty_cache()
    ch = out["chunked"]
    if ch["chunked_prefills"] != 1 or ch["chunks"] != CHUNK_PROMPT // 256 \
            or out["one_pass"]["chunked_prefills"] != 0:
        raise AssertionError(f"13a: chunked prefills {ch['chunked_prefills']}, chunks "
                             f"{ch['chunks']}, one-pass engine "
                             f"{out['one_pass']['chunked_prefills']}")
    if ch["launches"] <= 0 or out["one_pass"]["launches"] <= 0:
        raise AssertionError(f"13a: flash launches {ch['launches']}, "
                             f"{out['one_pass']['launches']}")
    cache = decode.init_kv_cache(config, 1, CHUNK_PROMPT, uniform=True, device="cuda")
    ref, _ = decode.prefill(params, torch.tensor([long_prompt], dtype=torch.int32,
                                                 device="cuda"), cache, config)
    del cache
    max_abs, scale, agree = _compare_logits(ch["first_logits"][0], ref[0], "13a")
    share = _agree(ch["tokens"], out["one_pass"]["tokens"])
    print(f"13a chunked prefill [{smi}]: llama-7b, 8 slots, max_len 4096, a {CHUNK_PROMPT}-token "
          f"prompt in {ch['chunks']} chunks of 256 beside 7 decoding slots; longest gap between "
          f"two tokens of a decoding slot while it entered {ch['gap_ms']:.1f} ms vs "
          f"{out['one_pass']['gap_ms']:.1f} ms with a one-pass prefill (buckets to 4096); "
          f"first token {ch['ttft_s']:.3f} s vs {out['one_pass']['ttft_s']:.3f} s after "
          f"submit; first-token logits vs one-pass decode.prefill max_abs {max_abs:.4e} "
          f"(max |logit| {scale:.3f}, rel {max_abs / scale:.3e}, tol {LOGIT_TOL}), argmax "
          f"{'agree' if agree else 'near-tie'}; greedy tokens agreeing with the one-pass "
          f"engine {share:.4f}; flash launches {ch['launches']} (one-pass engine "
          f"{out['one_pass']['launches']})", flush=True)
    return dict(gap_ms=ch["gap_ms"], gap_ms_one_pass=out["one_pass"]["gap_ms"],
                ttft_s=ch["ttft_s"], ttft_s_one_pass=out["one_pass"]["ttft_s"],
                chunks=ch["chunks"], logits_max_abs=max_abs, logits_scale=scale,
                agree_share=share, launches=ch["launches"],
                launches_one_pass=out["one_pass"]["launches"])


def _serve_args(*extra):
    from kubedl_tpu_torch.train import serve

    return serve.parse_args(["--model", "llama-7b", "--allow-fresh-init", "--slots", "8",
                             "--port", "0", "--bind", "127.0.0.1", *extra])


@contextlib.contextmanager
def _server(args):
    from kubedl_tpu_torch.train import serve

    built = serve.build_server(args)
    if built is None:
        raise AssertionError("serve.build_server found no weights")
    httpd, svc = built
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", svc
    finally:
        httpd.shutdown()
        thread.join(timeout=60)
        httpd.server_close()
        svc.stop()


def _13b_prefix(smi):
    """POST /prefix of a 1024-token prefix, 8 requests naming it, the same
    8 full prompts without it. Returns (numbers, the server's params)."""
    from kubedl_tpu_torch.models import decode
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    rng = torch.Generator().manual_seed(14)
    prefix = torch.randint(1, 32000, (PREFIX_LEN,), generator=rng).tolist()
    suffixes = [torch.randint(1, 32000, (n,), generator=rng).tolist() for n in PREFIX_SUFFIXES]
    with _server(_serve_args("--max-len", "2048")) as (base, svc):
        engine = svc.engine
        flash_attention.launches = 0
        pid = _post(base, {"tokens": prefix}, path="/prefix")["prefix_id"]
        registered = decode.clone_cache(engine._prefixes[pid][0])
        p0 = engine.stats()["prefill_time_s"]
        with_prefix = _post(base, {"requests": [
            {"tokens": s, "max_new_tokens": SERVE_NEW, "prefix_id": pid} for s in suffixes]})
        p1 = engine.stats()["prefill_time_s"]
        launches = flash_attention.launches
        full = _post(base, {"requests": [
            {"tokens": prefix + s, "max_new_tokens": SERVE_NEW} for s in suffixes]})
        p2 = engine.stats()["prefill_time_s"]
        with svc._lock:  # the pump is idle; first-token logits of both paths
            worst = (0.0, 1.0)
            for s in suffixes:
                lg, _ = engine._suffix_prefill(pid, np.asarray(s, np.int32))
                cache = decode.init_kv_cache(engine.config, 1, PREFIX_LEN + len(s),
                                             uniform=True, device="cuda")
                ref, _ = decode.prefill(engine.params, torch.tensor(
                    [prefix + s], dtype=torch.int32, device="cuda"), cache, engine.config)
                max_abs, scale, _ = _compare_logits(lg[0], ref[0], "13b")
                worst = max(worst, (max_abs / scale, max_abs))
                del cache
        after = engine._prefixes[pid][0]
        unchanged = all(torch.equal(a, b) for name in ("k", "v")
                        for a, b in zip(registered[name], after[name])) \
            and torch.equal(registered["lengths"], after["lengths"])
        params = engine.params
    toks_p = [r["tokens"] for r in with_prefix["results"]]
    toks_f = [r["tokens"] for r in full["results"]]
    errors = [r.get("error") for r in with_prefix["results"] + full["results"] if r.get("error")]
    if errors or any(len(t) != SERVE_NEW for t in toks_p + toks_f):
        raise AssertionError(f"13b: failed requests {errors}")
    if not unchanged:
        raise AssertionError("13b: the registered prefix's cache changed")
    if launches < 32:
        raise AssertionError(f"13b: flash launched {launches} times for the prefix")
    firsts = sum(a[0] == b[0] for a, b in zip(toks_p, toks_f))
    if firsts < len(suffixes) - 1:  # one near-tie flip allowed, as the logits check allows
        raise AssertionError(f"13b: first tokens agree on {firsts} of {len(suffixes)}")
    share = _agree(toks_p, toks_f)
    print(f"13b prefix caching [{smi}]: a {PREFIX_LEN}-token prefix through POST /prefix, 8 "
          f"requests of prefix + {PREFIX_SUFFIXES[0]}-{PREFIX_SUFFIXES[-1]} suffix tokens; "
          f"prefill time {p1 - p0:.4f} s with the prefix vs {p2 - p1:.4f} s for the full "
          f"prompts; first-token logits vs a one-pass prefill of the full prompt worst rel "
          f"{worst[0]:.3e} (max_abs {worst[1]:.4e}, tol {LOGIT_TOL}); first tokens equal "
          f"{firsts}/8, greedy tokens agreeing {share:.4f}; registered cache unchanged bit "
          f"for bit; flash launches {launches}", flush=True)
    return dict(prefill_s_prefix=p1 - p0, prefill_s_full=p2 - p1, logits_rel=worst[0],
                first_tokens_equal=firsts, agree_share=share, launches=launches), params


def _spec_turn(engine, prompts):
    """8 greedy requests driven by step_block(8): (tokens, decode ms a
    tick (a round on a speculative engine), stats)."""
    engine._ticks, engine._decode_time = 0, 0.0
    reqs = [engine.submit(p, SPEC_NEW) for p in prompts]
    while engine.has_pending():
        engine.step_block(8)
    if any(r.error or len(r.tokens) != SPEC_NEW for r in reqs):
        raise AssertionError(f"13c: failed requests {[r.error for r in reqs]}")
    st = engine.stats()
    return [r.tokens for r in reqs], st["decode_time_s"] / max(st["ticks"], 1) * 1e3, st


def _13c_speculative(smi):
    from kubedl_tpu_torch.models import decode, llama
    from kubedl_tpu_torch.models.serving import ServingEngine
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    ckpt = os.path.join(WORK, "ckpt-draft-1b")
    shutil.rmtree(ckpt, ignore_errors=True)
    rc, spans, _ = _run_trainer(["--model", "bench-1b", "--batch", "2", "--seq-len", "256",
                                 "--steps", "3", "--log-every", "100",
                                 "--checkpoint-path", ckpt], "draft")
    if rc != 0 or _latest_ckpt(ckpt) != 3:
        raise AssertionError(f"13c: bench-1b trainer rc={rc}, checkpoint {_latest_ckpt(ckpt)}")
    saved = torch.load(os.path.join(ckpt, "3", "state.pt"), map_location="cpu", mmap=True,
                       weights_only=True)["params"]
    rng = torch.Generator().manual_seed(15)
    prompts = [torch.randint(1, 32000, (n,), generator=rng).tolist() for n in SERVE_LENGTHS] \
        + [torch.randint(1, 32000, (n,), generator=rng).tolist() for n in (40, 300)]
    flash_attention.launches = 0
    with _server(_serve_args("--max-len", "1024", "--draft-model", "bench-1b",
                             "--draft-checkpoint-path", ckpt)) as (base, svc):
        answers = _post(base, {"requests": [
            {"tokens": p, "max_new_tokens": SPEC_NEW} for p in prompts]})["results"]
        launches = flash_attention.launches
        engine = svc.engine
        restored = all(torch.equal(a.cpu(), b) for a, b in
                       zip(llama.tree_leaves(engine.draft_params), llama.tree_leaves(saved)))
        http_stats = engine.stats()
        params, config = engine.params, engine.config
        draft, draft_config = engine.draft_params, engine.draft_config
    del svc, engine, saved
    if any(a.get("error") or len(a["tokens"]) != SPEC_NEW for a in answers):
        raise AssertionError(f"13c: failed requests {[a.get('error') for a in answers]}")
    if not restored:
        raise AssertionError("13c: the restored draft params differ from the saved ones")
    if launches < 2 * 16 or http_stats["spec_rounds"] <= 0:
        raise AssertionError(f"13c: flash launches {launches}, rounds "
                             f"{http_stats['spec_rounds']}")
    turns = {}
    for label in ("plain", "spec", "spec", "plain"):
        kw = dict(draft_params=draft, draft_config=draft_config) if label == "spec" else {}
        engine = ServingEngine(params, config, slots=8, max_len=1024, **kw)
        turns.setdefault(label, []).append(_spec_turn(engine, prompts))
        del engine
    engine = ServingEngine(params, config, slots=8, max_len=1024, draft_params=params,
                           draft_config=config)
    self_toks, self_ms, self_st = _spec_turn(engine, prompts)
    del engine
    # the verify block against single decode steps on one cache
    prompt = torch.tensor([prompts[1]], dtype=torch.int32, device="cuda")
    cache = decode.init_kv_cache(config, 1, 200, uniform=True, device="cuda")
    logits, cache = decode.prefill(params, prompt, cache, config)
    blk = torch.tensor([[int(logits.argmax())] + turns["plain"][0][0][1][:3]],
                       dtype=torch.int32, device="cuda")
    step_cache = decode.clone_cache(cache)
    blk_logits, _ = decode.decode_block_step(params, blk, cache, config, check=False)
    worst = (0.0, 1.0)
    for i in range(blk.shape[1]):
        lg, step_cache = decode.decode_step(params, blk[:, i], step_cache, config, check=False)
        max_abs, scale, _ = _compare_logits(blk_logits[0, i], lg[0], "13c verify")
        worst = max(worst, (max_abs / scale, max_abs))
    del cache, step_cache
    plain_toks = turns["plain"][0][0]
    served = [a["tokens"] for a in answers]
    share = _agree(served, plain_toks)
    firsts = sum(a[0] == b[0] for a, b in zip(served, plain_toks))
    self_share = _agree(self_toks, plain_toks)
    if firsts != len(prompts):
        raise AssertionError(f"13c: first tokens (one prefill) equal {firsts}/{len(prompts)}")
    if self_st["spec_acceptance"] < SELF_ACCEPT_MIN:
        raise AssertionError(f"13c: self-draft acceptance {self_st['spec_acceptance']}")

    def mean(label, i):
        return statistics.mean(t[i] for t in turns[label])

    spec_st = turns["spec"][0][2]
    per_round = SPEC_NEW * len(prompts) / max(spec_st["spec_rounds"], 1) / len(prompts)
    print(f"13c speculative serving [{smi}]: serve --model llama-7b --draft-model bench-1b "
          f"--draft-checkpoint-path (3 trainer steps, restored params equal the saved ones "
          f"bit for bit), 8 greedy requests of {SPEC_NEW} tokens: acceptance "
          f"{http_stats['spec_acceptance']:.4f} over {http_stats['spec_rounds']} rounds; "
          f"greedy tokens agreeing with the plain engine {share:.4f}, first tokens {firsts}/8; "
          f"in turns plain, spec, spec, plain: decode {mean('plain', 1):.2f} ms a tick (plain) "
          f"vs {mean('spec', 1):.2f} ms a round (spec, {per_round:.3f} tokens a slot a round, "
          f"acceptance {spec_st['spec_acceptance']:.4f}); self-draft (7B drafting for itself): "
          f"acceptance {self_st['spec_acceptance']:.4f}, {self_ms:.2f} ms a round, "
          f"{self_st['spec_rounds']} rounds, tokens agreeing with plain {self_share:.4f}; "
          f"verify block vs decode_step logits worst rel {worst[0]:.3e} (max_abs "
          f"{worst[1]:.4e}, tol {LOGIT_TOL}); flash launches {launches}", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return dict(acceptance=http_stats["spec_acceptance"], rounds=http_stats["spec_rounds"],
                agree_share=share, tick_ms_plain=mean("plain", 1),
                round_ms_spec=mean("spec", 1), tokens_per_round=per_round,
                self_acceptance=self_st["spec_acceptance"], self_round_ms=self_ms,
                self_agree_share=self_share, verify_rel=worst[0], launches=launches)


def _mistral():
    """Mistral-7B-v0.1's published config (mistralai/Mistral-7B-v0.1
    config.json: d_model 4096, 32 layers, 32 q / 8 kv heads, d_ff 14336,
    sliding_window 4096, vocab 32000, rope_theta 1e4, bf16); random weights."""
    from kubedl_tpu_torch.models import llama

    return llama.LlamaConfig(n_kv_heads=8, d_ff=14336, sliding_window=4096, max_seq_len=8192)


def _13d_ring(smi):
    from kubedl_tpu_torch.models import llama, serving
    from kubedl_tpu_torch.models.serving import ServingEngine
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    config = dataclasses.replace(_mistral(), n_layers=RING_LAYERS)
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = torch.Generator().manual_seed(16)
    prompts = [torch.randint(1, 32000, (n,), generator=rng).tolist() for n in (RING_PROMPT, 500)]
    out = {}
    sample = serving.sample_tokens
    for label, ring in (("ring", None), ("full", False)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        engine = ServingEngine(params, config, slots=2, max_len=8192, ring=ring)
        seen = []  # the logits every sampling call saw: admission, then each tick

        def keep(logits, *a, **kw):
            seen.append(logits.float().cpu())
            return sample(logits, *a, **kw)

        serving.sample_tokens = keep
        try:
            reqs = [engine.submit(p, RING_NEW) for p in prompts]
            while engine.has_pending():
                engine.step_block(8)
            torch.cuda.synchronize()
        finally:
            serving.sample_tokens = sample
        st = engine.stats()
        out[label] = dict(tokens=[r.tokens for r in reqs], logits=seen,
                          errors=[r.error for r in reqs], ring=engine.ring,
                          rows=engine.cache["k"][0].shape[2], bytes=st["kv_cache_bytes"],
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          launches=flash_attention.launches,
                          decode_ms=st["decode_time_s"] / max(st["ticks"], 1) * 1e3)
        del engine
    r, f = out["ring"], out["full"]
    if any(r["errors"] + f["errors"]) or not r["ring"] or f["ring"] or r["rows"] != 4096:
        raise AssertionError(f"13d: errors {r['errors']} {f['errors']}, ring {r['ring']} "
                             f"rows {r['rows']}")
    ratio = r["bytes"] / f["bytes"]
    if abs(ratio - 0.5) > 1e-3:
        raise AssertionError(f"13d: ring cache {r['bytes']} bytes vs {f['bytes']}")
    if r["launches"] <= 0:
        raise AssertionError("13d: no flash launch")
    if r["tokens"] != f["tokens"] or len(r["logits"]) != len(f["logits"]):
        raise AssertionError(f"13d: ring tokens {r['tokens']} vs full {f['tokens']}")
    worst = (0.0, 0.0)
    for a, b in zip(r["logits"], f["logits"]):
        for row in range(a.shape[0]):
            max_abs, scale, _ = _compare_logits(a[row], b[row], "13d")
            worst = max(worst, (max_abs / scale, max_abs))
    print(f"13d ring caches [{smi}]: Mistral-7B-v0.1 widths, {config.n_layers} of 32 layers "
          f"(random weights), max_len 8192, "
          f"a {RING_PROMPT}-token and a 500-token prompt, {RING_NEW} greedy tokens each: ring "
          f"of {r['rows']} rows, greedy tokens equal the full cache's; logits of "
          f"{len(r['logits'])} sampling calls worst rel {worst[0]:.3e} (max_abs "
          f"{worst[1]:.4e}, tol {LOGIT_TOL}); cache {r['bytes'] / 1e9:.3f} GB vs "
          f"{f['bytes'] / 1e9:.3f} GB (ratio {ratio:.4f}); peak allocated {r['peak_gb']:.2f} GB "
          f"vs {f['peak_gb']:.2f} GB; decode {r['decode_ms']:.2f} vs {f['decode_ms']:.2f} ms a "
          f"tick; flash launches {r['launches']}", flush=True)
    return dict(bytes_ratio=ratio, peak_gb_ring=r["peak_gb"], peak_gb_full=f["peak_gb"],
                logits_rel=worst[0], decode_ms_ring=r["decode_ms"],
                decode_ms_full=f["decode_ms"], launches=r["launches"]), params, config


def _13e_logprobs(params, config, smi):
    """generate's logprobs against a teacher-forced forward (llama.forward
    over prompt + generated tokens, log_softmax at the chosen tokens),
    which must tell them from two wrong logprobs (one position late, and
    tempered by 0.7); and against log_softmax of the same decode path's
    logits, replayed step by step on a cache of the same shape."""
    from kubedl_tpu_torch.models import decode, llama

    b, t, n = 2, 128, 16
    prompt = torch.randint(1, config.vocab_size, (b, t),
                           generator=torch.Generator(device="cuda").manual_seed(17),
                           device="cuda", dtype=torch.int32)
    toks, lps = decode.generate(params, prompt, config, n, with_logprobs=True)
    plain = decode.generate(params, prompt, config, n)
    idx = toks[:, :, None].long()
    with torch.no_grad():
        full = llama.forward(params, torch.cat([prompt, toks], 1), config).float()

    def at_chosen(logits):
        return torch.log_softmax(logits, -1).gather(-1, idx)[..., 0]

    teacher = (lps - at_chosen(full[:, t - 1:-1])).abs().max().item()
    wrong = {"one_late": (lps - at_chosen(full[:, t:])).abs().max().item(),
             "tempered_0.7": (lps - at_chosen(full[:, t - 1:-1] / 0.7)).abs().max().item()}
    del full
    cache = decode.init_kv_cache(config, b, t + n, uniform=True, device="cuda")
    logits, cache = decode.prefill(params, prompt, cache, config)
    ref = []
    for i in range(n):
        ref.append(torch.log_softmax(logits.float(), -1).gather(
            -1, toks[:, i:i + 1].long())[:, 0])
        if i + 1 < n:
            logits, cache = decode.decode_step(params, toks[:, i], cache, config, check=False)
    replay = (lps - torch.stack(ref, 1)).abs().max().item()
    print(f"13e logprobs [{smi}]: generate(with_logprobs=True) at Mistral-7B widths, {b} x "
          f"{t} prompt tokens, {n} new: tokens equal generate's {torch.equal(plain, toks)}; "
          f"logprobs against a teacher-forced forward's log_softmax at the chosen tokens max "
          f"diff {teacher:.4e} (tol {LP_TOL}); a wrong logprob reads one position late "
          f"{wrong['one_late']:.4e}, tempered by 0.7 {wrong['tempered_0.7']:.4e}; against "
          f"the replayed decode path's log_softmax {replay:.4e} (tol {LP_REPLAY_TOL}); mean "
          f"logprob {lps.mean().item():.4f}", flush=True)
    if not torch.equal(plain, toks) or not torch.isfinite(lps).all() or teacher > LP_TOL \
            or replay > LP_REPLAY_TOL or min(wrong.values()) <= LP_TOL:
        raise AssertionError(f"13e: tokens equal {torch.equal(plain, toks)}, logprob diff "
                             f"teacher-forced {teacher}, replay {replay}, wrong {wrong}")
    return dict(lp_teacher_max_diff=teacher, lp_wrong_max_diff=wrong, lp_replay_max_diff=replay,
                lp_mean=lps.mean().item())


def phase_serving_features(smi):
    """13: the serving features on one card. a) chunked prefill beside
    decoding slots; b) a registered prefix over HTTP; c) speculative
    serving with a trained, checkpointed bench-1b draft; d) ring caches at
    Mistral-7B widths; e) generate's logprobs. K1 launch counts by path."""
    from kubedl_tpu_torch.models import llama

    out = {}
    out["b_prefix"], params = _13b_prefix(smi)
    out["a_chunked"] = _13a_chunked(params, llama.LlamaConfig.llama_7b(), smi)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["c_speculative"] = _13c_speculative(smi)
    gc.collect()
    torch.cuda.empty_cache()
    out["d_ring"], params, config = _13d_ring(smi)
    out["e_logprobs"] = _13e_logprobs(params, config, smi)
    del params
    out["launches"] = {"7b_chunked_prefill_serving": out["a_chunked"]["launches"],
                       "7b_prefix_serving": out["b_prefix"]["launches"],
                       "7b_speculative_serving": out["c_speculative"]["launches"],
                       "mistral_ring_serving": out["d_ring"]["launches"]}
    return out

# ---------------------------------------------------------------------------
# phase 14: LoRA training, adapter serving, SSE and /metrics
# ---------------------------------------------------------------------------

LORA_RANK = 16
LORA_ADAPTER_PARAMS = 39_976_960  # rank 16 on wq, wk, wv, wo, w1, w3, w2 of 32 7B layers
# 14b's B noise: A @ B then has std 0.05 * sqrt(16 / 4096), a fifth of a 7B
# weight's (1 / sqrt(4096)), so the adapters change greedy tokens
LORA_B_STD = 0.05
# 14b serves Llama-7B at 8 of its 32 layers (full depth before phase 23, cut
# to pay for it): full width, every check kept
LORA_SERVING_LAYERS = 8
LORA_TURN_STEPS = 4
STREAM_PROMPT, STREAM_NEW = 100, 128


def _base_unchanged(base, config):
    """Every leaf of a fresh 7B tree (llama.init, seed 0 on the card) equal
    bit for bit to a replay of init's draws, made one layer at a time."""
    from kubedl_tpu_torch.models import llama

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for layer in base["layers"]:  # init draws the layers, then embed, then lm_head
        fresh = llama.init_layer(config, gen, dev)
        if not all(torch.equal(layer[k], fresh[k]) for k in fresh) or set(layer) != set(fresh):
            return False
    d = config.d_model
    for name, shape in (("embed", (config.vocab_size, d)), ("lm_head", (d, config.vocab_size))):
        if not torch.equal(base[name], llama._dense(shape, d, config.dtype, gen, dev)):
            return False
    return True


def _14a_lora_train(train, smi):
    """trainer --lora-rank 16 on Llama-7B (6 steps, b=4, 1024-token rows,
    checkpoints, one profiled step), the base checked bit for bit after,
    then the step beside phase 6's full step on the same init."""
    from kubedl_tpu_torch.models import llama, lora
    from kubedl_tpu_torch.parallel import optim

    steps, n_layers, batch, seq = 6, 32, 4, 1024
    config = llama.LlamaConfig.llama_7b()
    ckpt = os.path.join(WORK, "ckpt-lora-7b")
    profile_dir = os.path.join(WORK, "profile-lora-7b")
    for d in (ckpt, profile_dir):
        shutil.rmtree(d, ignore_errors=True)
    kept, real = {}, lora.make_lora_step

    def keep(base_params, *a, **kw):  # the trainer's base, to check after
        kept["base"] = base_params
        return real(base_params, *a, **kw)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    lora.make_lora_step = keep
    t0 = time.perf_counter()
    try:
        rc, spans, _ = _run_trainer(
            ["--model", "llama-7b", "--batch", str(batch), "--seq-len", str(seq),
             "--steps", str(steps), "--log-every", "1", "--grad-clip", "1.0",
             "--lora-rank", str(LORA_RANK), "--checkpoint-path", ckpt,
             "--checkpoint-interval", "3", "--profile-dir", profile_dir,
             "--profile-steps", "1"], "lora7b")
    finally:
        lora.make_lora_step = real
    wall_s = time.perf_counter() - t0
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0 or len(spans) != steps:
        raise AssertionError(f"7B LoRA trainer: rc={rc}, {len(spans)} step spans of {steps}")
    losses = [sp["attrs"]["loss"] for sp in spans]
    gnorms = [sp["attrs"]["grad_norm"] for sp in spans]
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"7B LoRA trainer: non-finite loss or grad_norm {losses} {gnorms}")
    if abs(losses[0] - math.log(32000)) > 1.5:
        raise AssertionError(f"7B LoRA first loss {losses[0]} not within 1.5 of ln 32000")
    want = (2 * steps * n_layers, steps * n_layers, steps * n_layers)
    if counts != want or list(counts) != train["launches"]:
        raise AssertionError(f"7B LoRA launches (fwd, dq, dkv) {counts}, expected {want}")
    base = kept.pop("base")
    n_base = llama.param_count(base)
    if not _base_unchanged(base, config):
        raise AssertionError("7B LoRA trainer changed the base weights")
    saved_steps = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())
    saved = torch.load(os.path.join(ckpt, str(steps), "state.pt"), map_location="cuda",
                       weights_only=True)
    adapters = saved["params"]
    n_ad = lora.adapter_count(adapters)
    opt_bytes = sum(t.numel() * t.element_size() for t in llama.tree_leaves(saved["opt_state"])
                    if torch.is_tensor(t))
    if saved_steps != [3, 6] or n_ad != LORA_ADAPTER_PARAMS or set(adapters) != {"layers"}:
        raise AssertionError(f"7B LoRA checkpoints {saved_steps}, {n_ad} adapter params")
    with torch.no_grad():
        merge_ms = _time_ms(lambda: lora.merge(base, adapters), warmup=1, iters=3)
    leaves = list(llama.tree_leaves(adapters))
    grads = [torch.randn_like(p).mul_(1e-3) for p in leaves]
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(3e-4, weight_decay=0.01))
    opt_state = tx.init(leaves)
    opt_ms = _time_ms(lambda: tx.apply(leaves, grads, opt_state), warmup=1, iters=3)
    del base, saved, adapters, leaves, grads, opt_state
    step_s = statistics.median(sp["dur"] for sp in spans[1:])
    tokens = batch * (seq - 1)
    traces = glob.glob(os.path.join(profile_dir, "*.json"))
    if len(traces) != 1:
        raise AssertionError(f"7B LoRA trainer wrote {len(traces)} profile traces")
    prof = _kernel_profile(traces[0], spans[1]["dur"] * 1e3)
    share = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}"
    print(f"14a lora train [{smi}]: trainer --lora-rank {LORA_RANK} on llama-7b, {steps} steps "
          f"b={batch} seq={seq} in {wall_s:.1f} s (init included); {n_ad} adapter params "
          f"({100.0 * n_ad / n_base:.2f}% of {n_base}); optimizer state {opt_bytes / 1e6:.1f} "
          f"MB; losses {', '.join(f'{x:.4f}' for x in losses)}; grad_norm "
          f"{', '.join(f'{x:.4f}' for x in gnorms)}; base unchanged bit for bit; "
          f"checkpoints at steps {saved_steps}", flush=True)
    print(f"14a lora train [{smi}]: step {step_s * 1e3:.1f} ms (median of steps 2-{steps}; "
          f"first {spans[0]['dur'] * 1e3:.1f} ms), {tokens / step_s:.0f} tok/s, peak allocated "
          f"{peak_gb:.2f} GB (phase 6: {train['peak_gb']:.2f}); launches fwd/dq/dkv {counts}; "
          f"merge alone {merge_ms:.1f} ms, clip + AdamW on the adapters alone {opt_ms:.2f} ms",
          flush=True)
    print(f"14a profile lora step [{smi}]: wall {prof['wall_ms']:.1f} ms (profiled), device "
          f"busy {prof['device_busy_ms']:.1f} ms, idle share {share}, {prof['kernels']} "
          f"kernels; by kind: " + "; ".join(f"{k} {ms:.1f} ms" for k, ms in
                                            prof["groups"].items())
          + "; top: " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in prof["top"]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    batches = [torch.randint(0, config.vocab_size, (batch, seq), generator=gen, device="cuda",
                             dtype=torch.int32) for _ in range(LORA_TURN_STEPS)]
    turns = {}
    for label in ("full", "lora"):  # one turn each: the run's time budget
        turns.setdefault(label, []).append(
            _run_7b_steps(config, batches, lora_rank=LORA_RANK if label == "lora" else 0))
    med = {k: [statistics.median(t[2][1:]) * 1e3 for t in v] for k, v in turns.items()}
    peaks = {k: [t[4] for t in v] for k, v in turns.items()}
    for label, runs in turns.items():
        for losses_t, gnorms_t, _, counts_t, _, plain_loss in runs:
            if not all(math.isfinite(x) for x in losses_t + gnorms_t) or \
                    abs(losses_t[0] - plain_loss) > 1e-2 * abs(plain_loss):
                raise AssertionError(f"14a turn {label}: losses {losses_t} vs {plain_loss}")
    ratio = statistics.mean(med["lora"]) / statistics.mean(med["full"])
    print(f"14a turns [{smi}]: {LORA_TURN_STEPS} steps each on the same init and batches, "
          f"median of steps 2-{LORA_TURN_STEPS}: full step {', '.join(f'{x:.1f}' for x in med['full'])} "
          f"ms, LoRA step {', '.join(f'{x:.1f}' for x in med['lora'])} ms (ratio "
          f"{ratio:.4f}); peak {', '.join(f'{x:.2f}' for x in peaks['full'])} GB full, "
          f"{', '.join(f'{x:.2f}' for x in peaks['lora'])} GB LoRA", flush=True)
    return dict(losses=losses, grad_norms=gnorms, adapter_params=n_ad, base_params=n_base,
                opt_state_bytes=opt_bytes, step_ms=step_s * 1e3,
                first_step_ms=spans[0]["dur"] * 1e3, tok_s=tokens / step_s, peak_gb=peak_gb,
                launches=list(counts), merge_ms=merge_ms, adapter_opt_ms=opt_ms,
                profile=prof, turns_ms=med, turns_peak_gb=peaks, lora_over_full=ratio,
                wall_s=wall_s), ckpt


def _kernels_a_tick(engine, prompts, adapters, ticks=4):
    """CUDA kernels a decode tick (torch.profiler over `ticks` engine steps
    with every slot decoding)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reqs = [engine.submit(p, 2 * ticks, adapter_id=a) for p, a in zip(prompts, adapters)]
    engine._admit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    while not all(r.done for r in reqs):
        engine.step_block(8)
    return n / ticks


def _14b_adapter_serving(smi):
    """Llama-7B (LORA_SERVING_LAYERS of its 32 layers) on ServingEngine with
    phase 4's traffic: no adapter against two registered rank-16 adapters
    (requests naming adapter 0) in turns, tokens bit for bit; then each
    adapter against an engine on the merged weights (first-token logits,
    greedy agreement)."""
    from kubedl_tpu_torch.models import llama, lora
    from kubedl_tpu_torch.models.serving import ServingEngine, _bucket

    config = dataclasses.replace(llama.LlamaConfig.llama_7b(), n_layers=LORA_SERVING_LAYERS)
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(14)
    adapters = []
    for _ in range(2):
        ad = lora.lora_init(gen, params, rank=LORA_RANK)
        for entry in ad["layers"]:
            for ab in entry.values():
                ab["b"].normal_(0.0, LORA_B_STD, generator=gen)
        adapters.append(ad)
    engines = {"0": ServingEngine(params, config, slots=8, max_len=1024),
               "2": ServingEngine(params, config, slots=8, max_len=1024)}
    for ad in adapters:
        engines["2"].register_adapter(ad)
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, config.vocab_size, (n,), generator=rng).tolist()
               for n in SERVE_LENGTHS]
    dup = prompts[2]
    turns = {}
    # one turn each: the whole run has to stay within its time budget
    for label in ("0", "2"):
        turns.setdefault(label, []).append(_drive_engine(engines[label], prompts, dup))
    runs = turns["0"] + turns["2"]
    if any(e for r in runs for e in r["errors"]) or any(r["tokens"] != runs[0]["tokens"]
                                                        for r in runs):
        raise AssertionError("14b: adapter-0 requests differ from the no-adapter engine's")
    if turns["2"][0]["launches"] != turns["0"][0]["launches"] or \
            turns["2"][0]["launches"] < config.n_layers:  # one prefill launch a layer at least
        raise AssertionError(f"14b: flash launches {[r['launches'] for r in runs]}")
    tick = {k: [r["tick_ms_median"] for r in v] for k, v in turns.items()}
    mixed = [1 + i % 2 for i in range(len(prompts) + 2)]
    kernels = {k: _kernels_a_tick(engines[k], prompts + [dup, dup], mixed if k == "2"
                                  else [0] * 8) for k in ("0", "2")}
    adapted = _drive_engine(engines["2"], prompts, dup, mixed)
    launches = adapted["launches"]
    del engines["0"]
    every = prompts + [dup, dup]
    per_adapter = {}
    for k in (1, 2):
        merged = lora.merge(params, adapters[k - 1])
        engm = ServingEngine(merged, config, slots=8, max_len=1024)
        idx = [i for i, a in enumerate(mixed) if a == k]
        reqs = [engm.submit(every[i], SERVE_NEW) for i in idx]
        while not all(r.done for r in reqs):
            engm.step_block(8)
        share = _agree([adapted["tokens"][i] for i in idx], [r.tokens for r in reqs])
        p = np.asarray(prompts[3], np.int32)  # 513 tokens
        bucket = _bucket(len(p), engm.prompt_buckets)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :len(p)] = p
        lengths = np.array([len(p)], np.int32)
        eng2 = engines["2"]
        la, _ = eng2._prefill_rows(eng2._local, config, padded, lengths, None,
                                   np.array([k], np.int32))
        lm, _ = engm._prefill_rows(engm._local, config, padded, lengths)
        max_abs, scale, argmax_equal = _compare_logits(la[0], lm[0], f"14b adapter {k}")
        changed = _agree([adapted["tokens"][i] for i in idx], [runs[0]["tokens"][i] for i in idx])
        per_adapter[k] = dict(logits_rel=max_abs / scale, max_abs=max_abs,
                              argmax_equal=argmax_equal, agree_share=share,
                              agree_with_base=changed)
        del merged, engm, reqs, la, lm
        gc.collect()
        torch.cuda.empty_cache()
    if max(v["agree_with_base"] for v in per_adapter.values()) > 0.9:
        raise AssertionError(f"14b: the adapters barely change greedy tokens {per_adapter}")
    del engines, params, adapters
    print(f"14b adapter serving [{smi}]: llama-7b at {config.n_layers} of 32 layers, 8 slots, "
          f"1024 positions, phase 4's traffic; "
          f"2 rank-{LORA_RANK} adapters registered (B ~ N(0, {LORA_B_STD})): adapter-0 requests "
          f"equal the no-adapter engine's tokens bit for bit in every turn; decode ms a tick "
          f"(median) with 0 adapters {', '.join(f'{x:.2f}' for x in tick['0'])}, with 2 "
          f"{', '.join(f'{x:.2f}' for x in tick['2'])} (ratio "
          f"{statistics.mean(tick['2']) / statistics.mean(tick['0']):.4f}); CUDA kernels a "
          f"tick {kernels['0']:.0f} without, {kernels['2']:.0f} with adapters; flash launches "
          f"{launches} (the traffic naming adapters 1 and 2)", flush=True)
    for k, v in per_adapter.items():
        print(f"14b adapter {k} [{smi}]: first-token logits (513-token prompt) against an "
              f"engine on merge(base, adapter {k}) rel {v['logits_rel']:.3e} (max_abs "
              f"{v['max_abs']:.4e}, tol {LOGIT_TOL}), argmax equal {v['argmax_equal']}; greedy "
              f"tokens agreeing with the merged engine {v['agree_share']:.4f}, with the base "
              f"{v['agree_with_base']:.4f}", flush=True)
    return dict(tick_ms=tick, kernels_a_tick=kernels, per_adapter=per_adapter,
                launches=launches, prefill_tok_s={k: [r["prefill_tok_s"] for r in v]
                                                  for k, v in turns.items()})


def _14c_entry_points(ckpt, smi):
    """serve --adapter CKPT and POST /adapter with the same checkpoint;
    generate --lora-checkpoint-path CKPT. Returns (numbers, flash launches,
    generate's prompts and tokens)."""
    from kubedl_tpu_torch.models import decode
    from kubedl_tpu_torch.ops.flash_attention import flash_attention
    from kubedl_tpu_torch.train import generate

    rng = torch.Generator().manual_seed(15)
    # two prompts under three adapter ids: six requests, all in the first
    # wave of 8 slots, so the rows naming 1 and 2 share every shape
    prompts = [torch.randint(1, 32000, (n,), generator=rng).tolist() for n in (40, 700)]
    flash_attention.launches = 0
    with _server(_serve_args("--max-len", "1024", "--adapter", ckpt)) as (base, svc):
        registered = svc.engine.stats()["adapters_registered"]
        second = _post(base, {"checkpoint_path": ckpt}, path="/adapter")["adapter_id"]
        out = _post(base, {"requests": [{"tokens": p, "max_new_tokens": SERVE_NEW,
                                         "adapter_id": a} for p in prompts for a in (0, 1, 2)]})
    answers = [r["tokens"] for r in out["results"]]
    errors = [r.get("error") for r in out["results"] if r.get("error")]
    if registered != 1 or second != 2 or errors or any(len(t) != SERVE_NEW for t in answers):
        raise AssertionError(f"14c: adapters {registered}, POST /adapter {second}, {errors}")
    if any(answers[3 * i + 1] != answers[3 * i + 2] for i in range(len(prompts))):
        raise AssertionError("14c: --adapter and POST /adapter of one checkpoint differ")
    trained_vs_base = _agree([answers[3 * i + 1] for i in range(len(prompts))],
                             [answers[3 * i] for i in range(len(prompts))])
    kept, real = [], decode.generate

    def record(*a, **kw):
        toks = real(*a, **kw)
        kept.append(toks.cpu())
        return toks

    decode.generate = record
    t0 = time.perf_counter()
    try:
        rc = generate.main(["--model", "llama-7b", "--lora-checkpoint-path", ckpt,
                            "--batch", "8", "--prompt-len", "64", "--max-new-tokens", "16"])
    finally:
        decode.generate = real
    gen_s = time.perf_counter() - t0
    if rc != 0 or len(kept) != 2 or not torch.equal(kept[0], kept[1]):
        raise AssertionError(f"14c: generate rc {rc}, {len(kept)} runs")
    # generate's prompts: its seed + 1 on the host, as train/generate.py draws them
    gen_prompts = torch.randint(0, 32000, (8, 64), generator=torch.Generator().manual_seed(1),
                                dtype=torch.int32)
    launches = flash_attention.launches
    numbers = dict(adapter_ids=[1, second], trained_vs_base_agree=trained_vs_base,
                   generate_s=gen_s)
    print(f"14c entry points [{smi}]: serve --adapter {os.path.basename(ckpt)} (id 1) and POST "
          f"/adapter of the same checkpoint (id {second}): {len(answers)} answers of "
          f"{SERVE_NEW} tokens, ids 1 and 2 equal bit for bit, the trained adapter agreeing "
          f"with the base on {trained_vs_base:.4f} of tokens; generate --lora-checkpoint-path: "
          f"8 x 16 tokens in {gen_s:.1f} s (7B init and merge included)", flush=True)
    return numbers, launches, gen_prompts.tolist(), kept[-1].tolist()


def _14d_stream(base, svc, smi):
    """One stream: true request at --decode-block 1 against the same
    request unstreamed; the gaps between its events; GET /metrics against
    GET /stats."""
    rng = torch.Generator().manual_seed(16)
    prompt = torch.randint(1, 32000, (STREAM_PROMPT,), generator=rng).tolist()
    body = {"tokens": prompt, "max_new_tokens": STREAM_NEW}
    plain = _post(base, body)
    req = urllib.request.Request(f"{base}/generate", data=json.dumps(dict(body, stream=True))
                                 .encode(), headers={"Content-Type": "application/json"})
    events, arrivals = [], []
    with urllib.request.urlopen(req, timeout=600) as r:
        ctype = r.headers["Content-Type"]
        for raw in r:
            if raw.startswith(b"data: "):
                arrivals.append(time.perf_counter())
                events.append(json.loads(raw[len(b"data: "):]))
    toks = [e["token"] for e in events[:-1]]
    final = events[-1] if events else {}
    if not ctype.startswith("text/event-stream") or not final.get("done") or \
            toks != plain["tokens"] or final["tokens"] != plain["tokens"] or \
            len(toks) != STREAM_NEW:
        raise AssertionError(f"14d: stream of {len(toks)} tokens, final {final.keys()}, "
                             f"equal to the plain answer {toks == plain['tokens']}")
    gaps = [(b - a) * 1e3 for a, b in zip(arrivals[:len(toks)], arrivals[1:len(toks)])]
    q = statistics.quantiles(gaps, n=10)
    metrics = urllib.request.urlopen(f"{base}/metrics", timeout=60).read().decode()
    with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
        stats = json.loads(r.read())
    gauges = dict(line.split(" ", 1) for line in metrics.splitlines()
                  if not line.startswith("#"))
    numeric = {k for k, v in stats.items() if isinstance(v, (int, float))}
    stable = ("slots", "admitted", "tokens_out", "ticks", "prefill_batches",
              "adapters_registered")
    if set(gauges) != {f"kubedl_serving_{k}" for k in numeric} or any(
            float(gauges[f"kubedl_serving_{k}"]) != float(stats[k]) for k in stable):
        raise AssertionError(f"14d: /metrics {sorted(gauges)} against /stats {stats}")
    print(f"14d stream [{smi}]: one stream of {len(toks)} tokens ({STREAM_PROMPT}-token "
          f"prompt, --decode-block 1) equal to the unstreamed answer; gaps between events "
          f"p50 {statistics.median(gaps):.2f} ms, p90 {q[8]:.2f} ms, max {max(gaps):.2f} ms "
          f"over {len(gaps)} gaps; GET /metrics {len(gauges)} gauges, equal to GET /stats",
          flush=True)
    return dict(tokens=len(toks), gap_p50_ms=statistics.median(gaps), gap_p90_ms=q[8],
                gap_max_ms=max(gaps), gaps=len(gaps), gauges=len(gauges))


def phase_lora(train, smi):
    """14: LoRA on one card. a) the trainer's --lora-rank on Llama-7B and
    the step in turns with phase 6's; b) two adapters on the serving engine;
    c) serve --adapter, POST /adapter and generate --lora-checkpoint-path
    on (a)'s checkpoint, against serve --lora-checkpoint-path; d) an SSE
    stream and GET /metrics on that server. K1-K3 launch counts by path."""
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    out = {}
    out["a_train"], ckpt = _phase("14a", _14a_lora_train, train, smi)
    out["b_serving"] = _phase("14b", _14b_adapter_serving, smi)
    gc.collect()
    torch.cuda.empty_cache()
    out["c_entry_points"], launches_c, gen_prompts, gen_toks = _phase(
        "14c", _14c_entry_points, ckpt, smi)
    gc.collect()
    torch.cuda.empty_cache()
    with _server(_serve_args("--max-len", "1024", "--lora-checkpoint-path", ckpt,
                             "--decode-block", "1")) as (base, svc):
        flash_attention.launches = 0
        merged = _post(base, {"requests": [{"tokens": p, "max_new_tokens": 16}
                                           for p in gen_prompts]})
        launches_c += flash_attention.launches
        served = [r["tokens"] for r in merged["results"]]
        flash_attention.launches = 0
        out["d_stream"] = _14d_stream(base, svc, smi)
        launches_d = flash_attention.launches
    firsts = sum(a[0] == b[0] for a, b in zip(served, gen_toks))
    share = _agree(served, gen_toks)
    print(f"14c merged [{smi}]: serve --lora-checkpoint-path against generate "
          f"--lora-checkpoint-path on generate's 8 prompts of 64 tokens: first tokens equal "
          f"{firsts}/8, greedy tokens agreeing {share:.4f}", flush=True)
    if firsts < len(served) - 1:  # one near-tie flip allowed, as 13b allows
        raise AssertionError(f"14c: generate and serve agree on {firsts} first tokens of 8")
    out["c_entry_points"].update(generate_first_tokens_equal=firsts, generate_agree=share)
    out["launches"] = {"7b_lora_train": out["a_train"]["launches"][0],
                       "7b_adapter_serving": out["b_serving"]["launches"],
                       "7b_adapter_entry_points": launches_c, "7b_sse_stream": launches_d}
    for path, n in out["launches"].items():
        if n <= 0:
            raise AssertionError(f"14: flash forward never launched on {path}")
    return out


# phase 15: google/gemma-2-2b's published config.json at full width and
# depth, tie_word_embeddings left out as save_pretrained writes it (its
# default, True); the weights are seeded
GEMMA2_2B = dict(
    architectures=["Gemma2ForCausalLM"], model_type="gemma2", vocab_size=256000,
    hidden_size=2304, intermediate_size=9216, num_hidden_layers=26, num_attention_heads=8,
    num_key_value_heads=4, head_dim=256, query_pre_attn_scalar=256, sliding_window=4096,
    layer_types=["sliding_attention" if i % 2 == 0 else "full_attention" for i in range(26)],
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0, rms_norm_eps=1e-6,
    rope_theta=10000.0, max_position_embeddings=8192, hidden_activation="gelu_pytorch_tanh",
    attention_bias=False, bos_token_id=2, eos_token_id=1, pad_token_id=0,
    torch_dtype="bfloat16")
# 15a-c write, load, serve and train G2_MAIN_LAYERS of its 26 layers (full
# depth before phases 12c, 12d and 24 came, which the cut pays for): full
# width, sliding and global layers alternating as published
G2_MAIN_LAYERS = 8
GEMMA2_MAIN = dict(GEMMA2_2B, num_hidden_layers=G2_MAIN_LAYERS,
                   layer_types=GEMMA2_2B["layer_types"][:G2_MAIN_LAYERS])
G2_SHARDS = 2
# seeded weights at N(0, 1/fan_in) (transformers' own init of a Gemma-2 is
# about that) give greedy rows that repeat one token: the tied embedding
# of the current token, x sqrt(hidden) in the residual, outscores every
# other logit after the final norm, and near-uniform attention adds much
# the same vector at every position. Embeddings at a tenth of that (the
# copy's edge over the other logits grows as sqrt(hidden)) and q at 2x
# (attention that picks keys) give varied rows; q at 4x makes the 26
# layers chaotic, so that two bf16 paths no longer agree on the logits.
G2_STD = {"model.embed_tokens.weight": 0.1, "q_proj": 2.0}
G2_GEN = dict(batch=8, prompt=64, new=16)     # generate --hf-model, then the same prompts served
G2_TRAIN = dict(steps=4, batch=4, seq=1024, ce_chunks=8)
G2_DPO = dict(steps=3, batch=2, seq=512, pairs=6)
G2_EVAL = dict(batch=4, seq=1024, batches=2)


def _hf_names(c):
    """(name, HF shape [out, in], fan_in or 0 for a norm) of a Gemma-2
    checkpoint (or of a Llama one, model_type "llama"), in file order."""
    llama_type = c.get("model_type") == "llama"
    d, dff = c["hidden_size"], c["intermediate_size"]
    hd = c.get("head_dim") or d // c["num_attention_heads"]
    nq, nkv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    out = [("model.embed_tokens.weight", (c["vocab_size"], d), d)]
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}"
        out += [(f"{p}.input_layernorm.weight", (d,), 0),
                (f"{p}.self_attn.q_proj.weight", (nq, d), d),
                (f"{p}.self_attn.k_proj.weight", (nkv, d), d),
                (f"{p}.self_attn.v_proj.weight", (nkv, d), d),
                (f"{p}.self_attn.o_proj.weight", (d, nq), nq),
                (f"{p}.post_attention_layernorm.weight", (d,), 0)]
        if not llama_type:
            out += [(f"{p}.pre_feedforward_layernorm.weight", (d,), 0),
                    (f"{p}.post_feedforward_layernorm.weight", (d,), 0)]
        out += [(f"{p}.mlp.gate_proj.weight", (dff, d), d),
                (f"{p}.mlp.up_proj.weight", (dff, d), d),
                (f"{p}.mlp.down_proj.weight", (d, dff), dff)]
    out.append(("model.norm.weight", (d,), 0))
    if llama_type and not c.get("tie_word_embeddings", False):
        out.append(("lm_head.weight", (c["vocab_size"], d), d))
    return out


def write_hf_checkpoint(path, hf_config, seed=0, shards=G2_SHARDS, device="cuda"):
    """A Hugging Face checkpoint directory: config.json and seeded bf16
    weights in `shards` safetensors files with model.safetensors.index.json
    (an 8-byte little-endian header length, the JSON header, the raw
    bytes). Matrices are N(0, 1/fan_in) times G2_STD's factor for their
    name, norms N(0, 0.1) (Gemma stores w - 1). Returns ({name: the seeded
    tensor on `device`}, bytes)."""
    names = _hf_names(hf_config)
    sizes = [2 * math.prod(shape) for _, shape, _ in names]
    total, cut, acc = sum(sizes), [], 0
    for i, n in enumerate(sizes):  # shard boundaries at equal shares of the bytes
        if acc >= total * (len(cut) + 1) / shards and len(cut) < shards - 1:
            cut.append(i)
        acc += n
    bounds = [0] + cut + [len(names)]
    gen = torch.Generator(device=device).manual_seed(seed)
    seeded, weight_map = {}, {}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    for s in range(shards):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        part = list(range(bounds[s], bounds[s + 1]))
        header, off = {"__metadata__": {"format": "pt"}}, 0
        for i in part:
            name, shape, _ = names[i]
            header[name] = {"dtype": "BF16", "shape": list(shape),
                            "data_offsets": [off, off + sizes[i]]}
            off += sizes[i]
            weight_map[name] = fname
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
        with open(os.path.join(path, fname), "wb") as f:
            f.write(len(raw).to_bytes(8, "little"))
            f.write(raw)
            for i in part:
                name, shape, fan_in = names[i]
                t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
                std = fan_in ** -0.5 if fan_in else 0.1
                std *= math.prod(f for key, f in G2_STD.items() if key in name)
                t = (t * std).to(torch.bfloat16)
                seeded[name] = t
                f.write(t.cpu().view(torch.uint8).numpy().data)
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return seeded, total


def _leaf_sources(config):
    """(path in the port's tree, HF name, transposed) of every leaf."""
    out = [(("embed",), "model.embed_tokens.weight", False),
           (("final_norm",), "model.norm.weight", False)]
    names = {"attn_norm": ("input_layernorm", False), "wq": ("self_attn.q_proj", True),
             "wk": ("self_attn.k_proj", True), "wv": ("self_attn.v_proj", True),
             "wo": ("self_attn.o_proj", True), "mlp_norm": ("pre_feedforward_layernorm", False),
             "post_attn_norm": ("post_attention_layernorm", False),
             "post_mlp_norm": ("post_feedforward_layernorm", False),
             "w1": ("mlp.gate_proj", True), "w3": ("mlp.up_proj", True),
             "w2": ("mlp.down_proj", True)}
    for i in range(config.n_layers):
        out += [(("layers", i, leaf), f"model.layers.{i}.{hf}.weight", t)
                for leaf, (hf, t) in names.items()]
    return out


class _Tee:
    """sys.stdout that also keeps what is written (an entry point's printed
    lines are its results)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.lines)


@contextlib.contextmanager
def _captured():
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        yield tee


def _15a_load(path, smi):
    """Write the directory, load_hf it onto the card (every leaf bit for bit
    against the seeded tensors), and a G2_PREFILL-token prefill (past the
    sliding layers' window) through the d 256 kernel against plain
    attention."""
    from kubedl_tpu_torch.models import decode
    from kubedl_tpu_torch.models.import_hf import load_hf
    from kubedl_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    seeded, nbytes = write_hf_checkpoint(path, GEMMA2_MAIN)
    write_s = time.perf_counter() - t0
    free_gb = shutil.disk_usage(path).free / 1e9
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, config = load_hf(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if (fa.kernel_source(config.head_dim), fa.bwd_kernel_source(config.head_dim, "dq"),
            fa.bwd_kernel_source(config.head_dim, "dkv")) != (fa.SM90, fa.BWD_SM90,
                                                              fa.BWD_SM90):
        raise AssertionError(f"15a: head dim {config.head_dim} does not route to the d 256 "
                             f"kernels")
    want_windows = tuple(GEMMA2_MAIN["sliding_window"] if t == "sliding_attention" else None
                         for t in GEMMA2_MAIN["layer_types"])
    if (config.head_dim, config.tie_embeddings, config.layer_windows, "lm_head" in params,
            config.attn_logit_softcap, config.final_logit_softcap) != \
            (256, True, want_windows, False, 50.0, 30.0):
        raise AssertionError(f"15a: config {config}")
    leaves = _leaf_sources(config)
    for where, name, transposed in leaves:
        leaf = params
        for k in where:
            leaf = leaf[k]
        want = seeded[name].T if transposed else seeded[name]
        if leaf.dtype != torch.bfloat16:
            want = want.float()
        if leaf.shape != want.shape or leaf.dtype != want.dtype or not torch.equal(leaf, want):
            raise AssertionError(f"15a: leaf {where} differs from {name}")
    n_params = sum(t.numel() for t in seeded.values())
    if len(leaves) != len(seeded):
        raise AssertionError(f"15a: {len(leaves)} leaves for {len(seeded)} tensors")
    del seeded
    prompt = torch.randint(0, config.vocab_size, (1, G2_PREFILL),
                           generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda", dtype=torch.int32)
    out = {}
    for label, cfg in (("kernel", config),
                       ("plain", dataclasses.replace(config, use_flash=False))):
        for _ in range(2):  # the first call warms cuBLAS; the second is timed
            _reset_counts()
            cache = decode.init_kv_cache(cfg, 1, G2_PREFILL, uniform=True, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = decode.prefill(params, prompt, cache, cfg)
            torch.cuda.synchronize()
            out[label] = (logits[0].float(), time.perf_counter() - t0, _counts()[0])
            del cache
    (lk, tk, nk), (lp, tp, npl) = out["kernel"], out["plain"]
    if nk != config.n_layers or npl != 0:
        raise AssertionError(f"15a: prefill launched K1 {nk} times (expected "
                             f"{config.n_layers}), the plain path {npl}")
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("15a: non-finite Gemma-2 logits")
    max_abs, scale = (lk - lp).abs().max().item(), lp.abs().max().item()
    ak, ap = int(lk.argmax()), int(lp.argmax())
    tie_gap = (lp[ap] - lp[ak]).item()
    print(f"15a load [{smi}]: gemma-2-2b directory (published config, {config.n_layers} layers, "
          f"{n_params:,} params, {G2_SHARDS} safetensors shards + index) written in "
          f"{write_s:.1f} s ({nbytes / 1e9:.3f} GB, {free_gb:.0f} GB free after); load_hf "
          f"onto the card {load_s:.2f} s ({nbytes / 1e9 / load_s:.2f} GB/s), {len(leaves)} "
          f"leaves equal to the seeded tensors bit for bit; prefill {G2_PREFILL} tokens "
          f"through {fa.SM90}.cu (d 256) {tk * 1e3:.1f} ms, plain {tp * 1e3:.1f} ms; "
          f"last-token logits max_abs_diff {max_abs:.4e} (max |logit| {scale:.3f}, rel "
          f"{max_abs / scale:.3e}), argmax {ak} vs {ap} "
          f"{'agree' if ak == ap else f'gap {tie_gap:.3e}'}; K1 launches {nk}", flush=True)
    if max_abs > LOGIT_TOL * scale or (ak != ap and tie_gap > max_abs):
        raise AssertionError("15a: Gemma-2 prefill through the kernel disagrees with plain "
                             "attention")
    del params, out, lk, lp
    return dict(n_params=n_params, bytes=nbytes, write_s=write_s, load_s=load_s,
                disk_free_gb=free_gb, leaves=len(leaves), prefill_kernel_ms=tk * 1e3,
                prefill_plain_ms=tp * 1e3, logits_max_abs=max_abs, logits_max=scale,
                argmax_agree=ak == ap, launches=nk)


def _15b_serve(path, smi):
    """generate --hf-model DIR, then serve --hf-model DIR with phase 4's
    traffic and generate's prompts; with transformers on the card, text,
    messages, a string stop and an SSE stream too."""
    import importlib.util

    from kubedl_tpu_torch.models import decode
    from kubedl_tpu_torch.train import generate, serve

    vocab = GEMMA2_2B["vocab_size"]
    tokenizer = importlib.util.find_spec("transformers") is not None
    if tokenizer:  # tests/hf_dirs.py by its path: a `tests` package elsewhere would shadow it
        spec = importlib.util.spec_from_file_location("hf_dirs", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests", "hf_dirs.py"))
        hf_dirs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(hf_dirs)
        hf_dirs.save_word_tokenizer(path, vocab)
    kept, real = [], decode.generate

    def record(*a, **kw):
        toks = real(*a, **kw)
        kept.append(toks.cpu())
        return toks

    decode.generate = record
    _reset_counts()
    t0 = time.perf_counter()
    try:
        rc = generate.main(["--hf-model", path, "--batch", str(G2_GEN["batch"]),
                            "--prompt-len", str(G2_GEN["prompt"]),
                            "--max-new-tokens", str(G2_GEN["new"])])
    finally:
        decode.generate = real
    gen_s, gen_launches = time.perf_counter() - t0, _counts()[0]
    if rc != 0 or len(kept) != 2 or not torch.equal(kept[0], kept[1]):
        raise AssertionError(f"15b: generate rc {rc}, {len(kept)} runs")
    # generate's prompts: its seed + 1 on the host, as train/generate.py draws them
    gen_prompts = torch.randint(0, vocab, (G2_GEN["batch"], G2_GEN["prompt"]),
                                generator=torch.Generator().manual_seed(1),
                                dtype=torch.int32).tolist()
    gen_toks = kept[-1].tolist()
    gc.collect()
    torch.cuda.empty_cache()
    args = serve.parse_args(["--hf-model", path, "--slots", "8", "--max-len", "1024",
                             "--port", "0", "--bind", "127.0.0.1"])
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, vocab, (n,), generator=rng).tolist() for n in SERVE_LENGTHS]
    dup = prompts[2]
    text = {}
    t0 = time.perf_counter()
    with _server(args) as (base, svc):
        setup_s = time.perf_counter() - t0
        if (svc.tokenizer is not None) != tokenizer:
            raise AssertionError(f"15b: tokenizer saved {tokenizer}, loaded "
                                 f"{svc.tokenizer is not None}")
        _reset_counts()
        results = [None] * len(prompts)

        def client(i):
            results[i] = _post(base, {"tokens": prompts[i], "max_new_tokens": SERVE_NEW})

        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        pair = _post(base, {"requests": [{"tokens": dup, "max_new_tokens": SERVE_NEW}] * 2})
        wall_s = time.perf_counter() - t0
        launches = _counts()[0]
        stats = svc.engine.stats()
        served = [r["tokens"] for r in _post(base, {"requests": [
            {"tokens": p, "max_new_tokens": G2_GEN["new"]} for p in gen_prompts]})["results"]]
        if tokenizer:
            text = _15b_text(base, svc.tokenizer)
        launches_all = _counts()[0]
        splits = _first_splits(svc.engine.params, svc.engine.config, gen_prompts, gen_toks,
                               served)
    answers = results + pair["results"]
    for n, a in zip(list(SERVE_LENGTHS) + [len(dup)] * 2, answers):
        if a is None or a.get("error") or len(a["tokens"]) != SERVE_NEW or \
                not all(0 <= t < vocab for t in a["tokens"]):
            raise AssertionError(f"15b: request of {n} prompt tokens failed: {a}")
    if pair["results"][0]["tokens"] != pair["results"][1]["tokens"]:
        raise AssertionError("15b: one prompt sent twice gave different tokens")
    n_layers = GEMMA2_MAIN["num_hidden_layers"]
    if launches < n_layers * stats["prefill_batches"] or gen_launches != 2 * n_layers:
        raise AssertionError(f"15b: K1 launched {launches} times for {stats['prefill_batches']} "
                             f"prefill dispatches x {n_layers} layers; generate {gen_launches}")
    if [len(r) for r in served] != [len(r) for r in gen_toks]:
        raise AssertionError("15b: served and generated rows differ in length")
    equal = sum(a == b for a, b in zip(served, gen_toks))
    share = _agree(served, gen_toks)
    # is the seeded model's output degenerate (rows of one repeated token)?
    repeats = sum(a == b for r in gen_toks for a, b in zip(r, r[1:])) / \
        sum(len(r) - 1 for r in gen_toks)
    distinct = [len(set(r)) for r in gen_toks]
    firsts = len({r[0] for r in gen_toks})
    ticks = max(stats["ticks"], 1)
    print(f"15b serve [{smi}]: serve --hf-model up in {setup_s:.1f} s (load included); "
          f"{len(answers)} requests of phase 4's traffic ok in {wall_s:.2f} s, the duplicate "
          f"equal; prefill {stats['prefill_batches']} dispatches {stats['prefill_time_s']:.3f} s "
          f"({(sum(SERVE_LENGTHS) + 2 * len(dup)) / stats['prefill_time_s']:.0f} prompt tok/s); "
          f"decode {stats['decode_time_s']:.3f} s over {stats['ticks']} ticks "
          f"({stats['decode_time_s'] / ticks * 1e3:.1f} ms/tick); K1 ({D256_NAMES[0]}) launches "
          f"{launches}; generate --hf-model {G2_GEN['batch']}x{G2_GEN['new']} tokens in "
          f"{gen_s:.1f} s (load included, K1 {gen_launches}); generate's rows: distinct "
          f"tokens of {G2_GEN['new']} {distinct}, {firsts} distinct first tokens, next token "
          f"repeating the last {repeats:.3f}; served on generate's prompts: {equal}/{len(served)} rows equal to "
          f"generate's, greedy tokens agreeing {share:.4f}, rows that part at (row, position, "
          f"logit gap, max |logit|) {[(i, j, round(g, 4), round(m, 3)) for i, j, g, m in splits]}"
          f"; tokenizer: "
          f"{text['line'] if tokenizer else 'no transformers here, id lists only'}", flush=True)
    if repeats > 0.25 or firsts < len(gen_toks) // 2:
        raise AssertionError(f"15b: the seeded model's greedy rows are degenerate: repeats "
                             f"{repeats}, {firsts} distinct first tokens")
    # two bf16 paths may part only where the two tokens' logits lie within
    # phase 3's bound of each other
    far = [sp for sp in splits if sp[2] > LOGIT_TOL * sp[3]]
    if far:
        raise AssertionError(f"15b: serve parts from generate away from a near-tie: {far}")
    return dict(setup_s=setup_s, wall_s=wall_s, requests=len(answers),
                prefill_batches=stats["prefill_batches"],
                prefill_time_s=stats["prefill_time_s"], decode_time_s=stats["decode_time_s"],
                ticks=stats["ticks"], tick_ms=stats["decode_time_s"] / ticks * 1e3,
                generate_s=gen_s, generate_rows_equal=equal, generate_agree=share,
                generate_splits=splits, generate_repeats=repeats,
                generate_distinct=distinct, generate_distinct_firsts=firsts, tokenizer=tokenizer, text=text,
                launches=launches_all + gen_launches)


def _first_splits(params, config, prompts, want, got):
    """(row, position, |logit gap| of the two tokens, max |logit|) where a
    row of `got` first leaves `want`, from one prefill of the prompt and
    the tokens the two share."""
    from kubedl_tpu_torch.models import decode

    out = []
    for i, (prompt, a, b) in enumerate(zip(prompts, want, got)):
        if a == b:
            continue
        j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = torch.tensor([prompt + a[:j]], dtype=torch.int32, device="cuda")
        cache = decode.init_kv_cache(config, 1, ctx.shape[1], uniform=True, device="cuda")
        logits = decode.prefill(params, ctx, cache, config)[0][0].float()
        out.append((i, j, (logits[a[j]] - logits[b[j]]).abs().item(),
                    logits.abs().max().item()))
        del cache
    return out


def _15b_text(base, tok):
    """One text request, one messages request, one string stop and one SSE
    stream whose text deltas concatenate to its final text."""
    body = {"text": "w10 w11 w12", "max_new_tokens": 8, "eos_token": None}
    plain = _post(base, body)
    msgs = _post(base, {"messages": [{"role": "user", "content": "w13 w14"}],
                        "max_new_tokens": 8})
    # a word of the answer as a string stop: the answer ends before its
    # first occurrence
    stop_id = plain["tokens"][3]
    stopped = _post(base, dict(body, stop=tok.decode([stop_id])))
    req = urllib.request.Request(f"{base}/generate", data=json.dumps(dict(body, stream=True))
                                 .encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        events = [json.loads(raw[len(b"data: "):]) for raw in r if raw.startswith(b"data: ")]
    deltas = "".join(e["text_delta"] for e in events[:-1])
    ok = (plain["text"] == tok.decode(plain["tokens"], skip_special_tokens=True)
          and msgs["tokens"] and "text" in msgs
          and stopped["tokens"] == plain["tokens"][:plain["tokens"].index(stop_id)]
          and events[-1]["text"] == plain["text"] == deltas)
    if not ok:
        raise AssertionError(f"15b text: {plain} {msgs} {stopped} {events[-1]} {deltas!r}")
    import transformers

    return dict(line=f"transformers {transformers.__version__}: a word-level tokenizer saved "
                     f"into the directory and served: text, messages, a string stop cutting "
                     f"at {len(stopped['tokens'])} tokens, an SSE stream of {len(events) - 1} "
                     f"text deltas equal to its final text", stream_events=len(events))


def _15c_train(path, smi):
    """trainer --hf-model DIR: 4 steps at b=4, 1024-token rows, chunked CE
    over the 256000 vocabulary."""
    c, n_layers = G2_TRAIN, GEMMA2_MAIN["num_hidden_layers"]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    rc, spans, _ = _run_trainer(
        ["--hf-model", path, "--batch", str(c["batch"]), "--seq-len", str(c["seq"]),
         "--steps", str(c["steps"]), "--log-every", "1", "--grad-clip", "1.0",
         "--ce-chunks", str(c["ce_chunks"])], "gemma2")
    wall_s = time.perf_counter() - t0
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0 or len(spans) != c["steps"]:
        raise AssertionError(f"15c: trainer rc={rc}, {len(spans)} step spans of {c['steps']}")
    losses = [sp["attrs"]["loss"] for sp in spans]
    gnorms = [sp["attrs"]["grad_norm"] for sp in spans]
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"15c: non-finite loss or grad_norm {losses} {gnorms}")
    want = (2 * c["steps"] * n_layers, c["steps"] * n_layers, c["steps"] * n_layers)
    if counts != want:
        raise AssertionError(f"15c: launches (fwd, dq, dkv) {counts}, expected {want} at d 256")
    step_s = statistics.median(sp["dur"] for sp in spans[1:])
    tokens = c["batch"] * (c["seq"] - 1)
    print(f"15c train [{smi}]: trainer --hf-model {c['steps']} steps b={c['batch']} "
          f"seq={c['seq']} ce_chunks={c['ce_chunks']} in {wall_s:.1f} s (load included); "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}; grad_norm "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}; step {step_s * 1e3:.1f} ms (median of "
          f"steps 2-{c['steps']}; first {spans[0]['dur'] * 1e3:.1f} ms), {tokens / step_s:.0f} "
          f"tok/s, peak allocated {peak_gb:.2f} GB; K1/K2/K3 ({', '.join(D256_NAMES)}) "
          f"launches {counts}",
          flush=True)
    return dict(losses=losses, grad_norms=gnorms, step_ms=step_s * 1e3,
                first_step_ms=spans[0]["dur"] * 1e3, tok_s=tokens / step_s, peak_gb=peak_gb,
                launches=list(counts), wall_s=wall_s)


def _15d_data(path):
    """15d's seeded id-list pairs (pairs.jsonl) and token shard (eval-0.bin)
    in `path`, which phase 23's pairs read too."""
    from kubedl_tpu_torch.native.loader import write_shard

    vocab, c, e = GEMMA2_2B["vocab_size"], G2_DPO, G2_EVAL
    rng = np.random.default_rng(15)
    pairs = os.path.join(path, "pairs.jsonl")
    with open(pairs, "w") as f:
        for _ in range(c["pairs"]):
            prompt = rng.integers(1, vocab, 128).tolist()
            f.write(json.dumps({"prompt": prompt,
                                "chosen": rng.integers(1, vocab, c["seq"] - 128).tolist(),
                                "rejected": rng.integers(1, vocab, 300).tolist()}) + "\n")
    shard = os.path.join(path, "eval-0.bin")
    write_shard(shard, rng.integers(1, vocab, e["batch"] * e["seq"] * e["batches"]))
    return pairs, shard


def _dpo_launches(n_layers):
    """K1/K2/K3 launches of G2_DPO's run: the reference's forward once a
    distinct batch, the policy's twice a step (forward and its recompute in
    backward)."""
    c = G2_DPO
    refs = len({(it * c["batch"]) % c["pairs"] for it in range(c["steps"])})
    return (n_layers * (refs + 2 * c["steps"]), n_layers * c["steps"], n_layers * c["steps"])


def _15d_dpo_eval(path, smi, pairs, shard):
    """dpo --hf-model DIR on 15d's seeded id-list pairs; evaluate --hf-model
    DIR on its seeded shard: one process each, phase 23's baselines. DIR is
    the directory of Gemma-2-2B's config cut to G2_GRPO's layers."""
    from kubedl_tpu_torch.train import dpo, evaluate

    n_layers = G2_GRPO["layers"]
    c = G2_DPO
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    with _traced("dpo-one") as trace_dir, _captured() as out:
        rc = dpo.main(["--hf-model", path, "--data-path", pairs, "--batch", str(c["batch"]),
                       "--seq-len", str(c["seq"]), "--steps", str(c["steps"]),
                       "--log-every", "1", "--lr", "1e-6"])
    dpo_s, dpo_counts = time.perf_counter() - t0, _counts()
    dpo_peak = torch.cuda.max_memory_allocated() / 1e9
    steps = re.findall(r"step (\d+): loss=(\S+) margin=(\S+) acc=(\S+)", out.text())
    losses = [float(s[1]) for s in steps]
    margins = [float(s[2]) for s in steps]
    spans = [sp for sp in _trace_spans(trace_dir) if sp["name"] == "dpo.step"]
    step_s = [sp["dur"] for sp in sorted(spans, key=lambda sp: sp["attrs"]["step"])]
    if rc != 0 or len(steps) != c["steps"] or len(step_s) != c["steps"] or not all(
            math.isfinite(x) for x in losses + margins):
        raise AssertionError(f"15d: dpo rc {rc}, steps {steps}")
    want = _dpo_launches(n_layers)
    if dpo_counts != want:
        raise AssertionError(f"15d: dpo launches (fwd, dq, dkv) {dpo_counts}, expected {want}")
    e = G2_EVAL
    _reset_counts()
    t0 = time.perf_counter()
    with _captured() as out:
        rc = evaluate.main(["--hf-model", path, "--data-path", shard, "--batch",
                            str(e["batch"]), "--seq-len", str(e["seq"]), "--log-every", "0"])
    eval_s, eval_launches = time.perf_counter() - t0, _counts()[0]
    line = json.loads(out.text().strip().splitlines()[-1])
    if rc != 0 or not math.isfinite(line["nll"]) or \
            line["tokens"] != e["batches"] * e["batch"] * (e["seq"] - 1) or \
            eval_launches != e["batches"] * n_layers:
        raise AssertionError(f"15d: evaluate rc {rc}, {line}, K1 {eval_launches}")
    print(f"15d dpo/eval [{smi}]: Gemma-2-2B's widths at {n_layers} of 26 layers: dpo "
          f"--hf-model {c['steps']} steps of {c['batch']} pairs x {c['seq']} tokens in "
          f"{dpo_s:.1f} s (load included), steps {', '.join(f'{x:.3f}' for x in step_s)} s: "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}, margins "
          f"{', '.join(f'{x:.3f}' for x in margins)}, peak {dpo_peak:.2f} GB, K1/K2/K3 "
          f"launches {dpo_counts}; evaluate --hf-model on a seeded shard in {eval_s:.1f} s: "
          f"{json.dumps(line)}, K1 launches {eval_launches}", flush=True)
    return dict(dpo_s=dpo_s, dpo_step_s=step_s, dpo_losses=losses, dpo_margins=margins,
                dpo_peak_gb=dpo_peak, dpo_launches=list(dpo_counts), eval_s=eval_s, eval=line,
                eval_launches=eval_launches)


# phase 16: GRPO on Gemma-2-2B, the in-process fleet on the same weights, and
# the fleet's pods at bench-1b (head dim 128) as two processes
# K 32 rather than 64 keeps the whole run nearer its time target; lr 1e-4
# because Adam's first updates (~lr an element) under ~1e-4 fall below the
# rounding step of most bf16 weights, and the parameters would not move
# 16a runs GRPO on Gemma-2-2B at full width and 2 of its 26 layers (a
# sliding and a global one): its checkpoint round trip (the policy's params,
# mu and nu written twice and read twice) took ~40 s at full depth, cut to 4
# layers to pay for phase 21 and to 2 for phase 22; the 256k-row embedding
# is most of what is left. 16b and 17b run on the same directory
G2_GRPO = dict(prompts=16, prompt_len=64, B=4, G=8, K=32, steps=3, kl=0.04, lr=1e-4,
               layers=2)
G2_FLEET = dict(B=2, G=4, K=32, steps=2, lr=1e-4)
RL_REWARD = "chip_smoke:reward_low_ids"
RL_POD = dict(model="bench-1b", steps=3, B=4, G=4, K=32, lag=1)
RL_LP_TOL = LP_TOL  # 16a's off-policy ratio: behavior logprobs against the training forward


def reward_low_ids(prompt_ids, completion_ids):
    """Phase 16's reward: the share of completion ids in the lower half of
    Gemma-2's vocabulary. A seeded policy scores about 0.5 with a spread
    that a group of 8 resolves, so advantages are not all 0 (token-match
    on one id of 256,000 scores 0 everywhere and trains nothing)."""
    half = GEMMA2_2B["vocab_size"] // 2
    return sum(1 for t in completion_ids if t < half) / max(len(completion_ids), 1)


def _run_grpo(argv, tag):
    """grpo.main(argv) in this process with its spans exported to a fresh
    trace dir; returns (rc, printed text, spans by name)."""
    from kubedl_tpu_torch.train import grpo

    with _traced(tag) as trace_dir, _captured() as out:
        rc = grpo.main(argv)
    spans = {}
    for sp in _trace_spans(trace_dir):
        spans.setdefault(sp["name"], []).append(sp)
    for v in spans.values():
        v.sort(key=lambda sp: (sp["attrs"]["step"], sp["attrs"].get("epoch", 0)))
    return rc, out.text(), spans


def _grpo_prompts(path, c, vocab):
    data = os.path.join(path, "grpo-prompts.jsonl")
    rng = np.random.default_rng(16)
    prompts = [rng.integers(1, vocab, c["prompt_len"]).tolist() for _ in range(c["prompts"])]
    with open(data, "w") as f:
        for p in prompts:
            f.write(json.dumps({"prompt": p}) + "\n")
    return data, prompts


def _16a_grpo(path, smi):
    """grpo --hf-model DIR: 3 on-policy steps of 4 prompts x 8 samples x 64
    new tokens with a checkpoint, then a resume to step 4 with two inner
    epochs on the rollout's behavior logprobs; DIR (`path`) is Gemma-2-2B's
    config cut to G2_GRPO's layers."""
    c, n_layers = G2_GRPO, G2_GRPO["layers"]
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.train import checkpoint, generate

    data, _ = _grpo_prompts(path, c, GEMMA2_2B["vocab_size"])
    ckpt = os.path.join(WORK, "ckpt-grpo-gemma2")
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--hf-model", path, "--data-path", data, "--prompts-per-step", str(c["B"]),
            "--group-size", str(c["G"]), "--max-new-tokens", str(c["K"]), "--kl-coef",
            str(c["kl"]), "--lr", str(c["lr"]), "--reward-module", RL_REWARD, "--log-every", "1",
            "--checkpoint-path", ckpt]
    from kubedl_tpu_torch.models import decode

    runs = {}
    real_generate = decode.generate
    for label, extra in (("on_policy", ["--steps", str(c["steps"])]),
                         ("resume", ["--steps", str(c["steps"] + 1), "--inner-epochs", "2"])):
        captured = {}
        if label == "on_policy":  # step 1's prompts and rollout: phase 23b's baseline
            def first(params, prompt, *a, **kw):
                got = real_generate(params, prompt, *a, **kw)
                if "rollout1" not in captured:
                    captured.update(prompts1=prompt.tolist(), rollout1=got.tolist())
                return got

            decode.generate = first
        if label == "resume":
            saved = generate.restore_params(ckpt, "policy", device="cpu")  # step 3
            restore = checkpoint.CheckpointManager.restore

            def keep(self, step, state):
                state = restore(self, step, state)
                captured["params"] = llama.tree_map(lambda t: t.detach().to("cpu", copy=True),
                                                    state.params)
                return state

            checkpoint.CheckpointManager.restore = keep
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        try:
            rc, text, spans = _run_grpo(argv + extra, f"grpo-{label}")
        finally:
            decode.generate = real_generate
            if label == "resume":
                checkpoint.CheckpointManager.restore = restore
        runs[label] = dict(rc=rc, text=text, spans=spans, counts=_counts(),
                           wall_s=time.perf_counter() - t0,
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9, **captured)
    on, res = runs["on_policy"], runs["resume"]
    for label, r in runs.items():
        if r["rc"] != 0:
            raise AssertionError(f"16a: grpo {label} rc {r['rc']}:\n{r['text'][-2000:]}")
    ups = on["spans"]["grpo.update"] + res["spans"]["grpo.update"]
    for sp in ups:
        if not all(math.isfinite(sp["attrs"][k]) for k in ("loss", "kl", "grad_norm")):
            raise AssertionError(f"16a: non-finite metrics {sp['attrs']}")
    if not any(sp["attrs"]["grad_norm"] > 0 for sp in ups):
        raise AssertionError("16a: every gradient is 0 (constant rewards): nothing trained")
    on_ups = on["spans"]["grpo.update"]
    if [sp["attrs"]["step"] for sp in on_ups] != [1, 2, 3] or any(
            sp["attrs"]["ratio_mean"] != 1.0 or sp["attrs"]["clip_frac"] != 0.0
            for sp in on_ups):
        raise AssertionError(f"16a: on-policy updates {[sp['attrs'] for sp in on_ups]}")
    if on_ups[0]["attrs"]["kl"] > 1e-3:
        raise AssertionError(f"16a: step 1 KL {on_ups[0]['attrs']['kl']} > 1e-3 at the "
                             f"reference")
    off = res["spans"]["grpo.update"]
    if "restored policy checkpoint at step 3" not in res["text"] or \
            [(sp["attrs"]["step"], sp["attrs"]["epoch"]) for sp in off] != [(4, 0), (4, 1)]:
        raise AssertionError(f"16a: resume did not restore step 3 and run step 4 twice:\n"
                             f"{res['text'][-2000:]}")
    ratio0 = off[0]["attrs"]["ratio_mean"]
    if abs(ratio0 - 1.0) > RL_LP_TOL:
        raise AssertionError(f"16a: off-policy first-epoch ratio_mean {ratio0} (limit "
                             f"{RL_LP_TOL} from 1)")
    mism = [i for i, (a, b) in enumerate(zip(llama.tree_leaves(saved),
                                             llama.tree_leaves(res["params"])))
            if a.dtype != b.dtype or not torch.equal(a, b)]
    if mism or len(list(llama.tree_leaves(saved))) != len(list(llama.tree_leaves(res["params"]))):
        raise AssertionError(f"16a: the checkpoint generate reads differs from the restored "
                             f"state at leaves {mism[:5]}")
    per_step = (4 * n_layers, n_layers, n_layers)  # rollout prefill, reference, policy x2
    want_on = tuple(c["steps"] * x for x in per_step)
    want_res = (6 * n_layers, 2 * n_layers, 2 * n_layers)
    if on["counts"] != want_on or res["counts"] != want_res:
        raise AssertionError(f"16a: launches (fwd, dq, dkv) {on['counts']} and "
                             f"{res['counts']}, expected {want_on} and {want_res}")
    # 22b: each save's stall in the step loop (ckpt.save) beside its write
    # on the writer thread (ckpt.write); both runs save only at their end,
    # a final save, which waits for its write
    saves = []
    for r in (on, res):
        writes = {sp["attrs"]["step"]: sp for sp in r["spans"].get("ckpt.write", [])}
        for sp in r["spans"].get("ckpt.save", []):
            w = writes.get(sp["attrs"]["step"])
            if w is None:
                raise AssertionError(f"16a: no write span for the save at step "
                                     f"{sp['attrs']['step']}")
            saves.append(dict(step=sp["attrs"]["step"], final=sp["attrs"]["final"],
                              stall_s=sp["dur"], write_s=w["dur"],
                              fsync_s=w["attrs"]["fsync_s"], gb=w["attrs"]["bytes"] / 1e9))
    if [(x["step"], x["final"]) for x in saves] != [(3, True), (4, True)]:
        raise AssertionError(f"16a: saves {saves}, expected final ones at 3 and 4")
    print(f"16a checkpoints [{smi}]: " + "; ".join(
        f"step {x['step']} final: stall {x['stall_s']:.2f} s (the snapshot, the pinned "
        f"buffers' first registration included, and the wait), write {x['write_s']:.2f} s "
        f"(fsync {x['fsync_s']:.2f} s; {x['gb']:.2f} GB, {x['gb'] / x['write_s']:.2f} GB/s)"
        for x in saves), flush=True)
    steps = on["spans"]["grpo.step"] + res["spans"]["grpo.step"]
    rolls = on["spans"]["grpo.rollout"] + res["spans"]["grpo.rollout"]
    tokens = c["B"] * c["G"] * c["K"]
    roll_s = [sp["dur"] for sp in rolls]
    learn_s = [sp["dur"] - sp["attrs"]["rollout_s"] for sp in steps]
    print(f"16a grpo [{smi}]: grpo --hf-model (Gemma-2-2B's widths, {n_layers} of 26 layers) "
          f"{c['steps']} on-policy steps of {c['B']} prompts "
          f"x {c['G']} samples x {c['K']} new tokens ({c['B'] * c['G']} rows of "
          f"{c['prompt_len'] + c['K']}) in {on['wall_s']:.1f} s, resumed at step 3 for one "
          f"off-policy step of 2 epochs in {res['wall_s']:.1f} s (loads and checkpoints "
          f"included); losses {', '.join(f'{sp['attrs']['loss']:.4f}' for sp in ups)}; kl "
          f"{', '.join(f'{sp['attrs']['kl']:.2e}' for sp in ups)}; grad_norm "
          f"{', '.join(f'{sp['attrs']['grad_norm']:.3f}' for sp in ups)}; on-policy ratio 1, "
          f"clip 0; off-policy epoch 0 ratio {ratio0:.6f} clip "
          f"{off[0]['attrs']['clip_frac']:.4f}, epoch 1 ratio {off[1]['attrs']['ratio_mean']:.6f}; "
          f"rollout s a step {', '.join(f'{x:.2f}' for x in roll_s)} ("
          f"{', '.join(f'{tokens / x:.0f}' for x in roll_s)} new tok/s); learner s a step "
          f"{', '.join(f'{x:.2f}' for x in learn_s)}; peak {on['peak_gb']:.2f} / "
          f"{res['peak_gb']:.2f} GB; the checkpoint read by generate equals the restored "
          f"state bit for bit; K1/K2/K3 launches {on['counts']} + {res['counts']}", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return dict(losses=[sp["attrs"]["loss"] for sp in ups], kl=[sp["attrs"]["kl"] for sp in ups],
                grad_norms=[sp["attrs"]["grad_norm"] for sp in ups], off_ratio=ratio0,
                off_clip=off[0]["attrs"]["clip_frac"], rollout_s=roll_s,
                rollout_tok_s=[tokens / x for x in roll_s], learner_s=learn_s,
                peak_gb=[on["peak_gb"], res["peak_gb"]], wall_s=[on["wall_s"], res["wall_s"]],
                launches=[a + b for a, b in zip(on["counts"], res["counts"])], saves=saves,
                argv=argv, prompts1=on["prompts1"], rollout1=on["rollout1"],
                loss1=on_ups[0]["attrs"]["loss"],
                update_s=[sp["dur"] for sp in on_ups])


def _16b_fleet(path, smi):
    """The in-process lockstep RLFleet on the Gemma-2-2B weights in `path`
    (16a's directory, cut to G2_GRPO's layers) against the port's monolithic
    loop with the same seeds (tests/test_rl.py's recipe), run first and
    freed; then the weight record the learner published last decoded
    against its parameters."""
    from kubedl_tpu_torch.models import decode, llama
    from kubedl_tpu_torch.models.import_hf import load_hf
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.rl.actor import ActorConfig
    from kubedl_tpu_torch.rl.fleet import RLFleet, fleet_goodput_split
    from kubedl_tpu_torch.rl.learner import LearnerConfig
    from kubedl_tpu_torch.rl.weights import sorted_leaves
    from kubedl_tpu_torch.train import grpo, rl

    c = G2_FLEET
    _, prompts = _grpo_prompts(path, G2_GRPO, GEMMA2_2B["vocab_size"])
    base, config = load_hf(path, device="cuda")
    n_layers = config.n_layers
    reward_fn = grpo.make_reward_fn(grpo.parse_args(["--reward-module", RL_REWARD]))
    seed, B, G, K, P = 0, c["B"], c["G"], c["K"], G2_GRPO["prompt_len"]
    t0 = time.perf_counter()
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(c["lr"], weight_decay=0.0))
    init_state, _, ref_fn, step = rl.make_grpo_step(base, config, tx, kl_coef=0.04)
    state = init_state(llama.tree_map(lambda t: t.detach().clone(), base))
    mono, mono_g = [], []
    for it in range(1, c["steps"] + 1):
        pick = np.random.default_rng((seed, it)).choice(len(prompts), size=B,
                                                        replace=len(prompts) < B)
        tiled = np.repeat(np.array([prompts[i] for i in pick], np.int32), G, axis=0)
        with torch.no_grad():
            comp, lps = decode.generate(state.params, torch.from_numpy(tiled).cuda(), config, K,
                                        temperature=1.0,
                                        generator=grpo.sampling_generator("cuda", seed, it),
                                        with_logprobs=True)
        full, slens, rewards, grid = grpo.completion_rows(
            comp.cpu().numpy(), tiled, np.full(B * G, P, np.int32), -1, reward_fn, P + K,
            lps.cpu().numpy())
        adv = rl.group_advantages(rewards.reshape(B, G)).reshape(-1).cuda()
        batch = tuple(torch.from_numpy(a).cuda() for a in (full, np.full(B * G, P, np.int32),
                                                           slens))
        state, m = step(state, (*batch, adv, torch.from_numpy(grid).cuda(), ref_fn(batch)))
        mono.append(float(m["loss"]))
        mono_g.append(float(m["grad_norm"]))
    mono_params = [t.detach().cpu() for t in sorted_leaves(state.params)]
    mono_s = time.perf_counter() - t0
    del state, init_state, ref_fn, step, tx, m, comp, lps, batch, adv
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fleet = RLFleet(
        base, config, prompts, reward_fn,
        ActorConfig(seed=seed, group_size=G, prompts_per_step=B, max_new_tokens=K,
                    max_weight_lag=0, lockstep=True, weight_wait_s=600.0),
        LearnerConfig(prompts_per_step=B, group_size=G, max_weight_lag=0, lr=c["lr"],
                      kl_coef=0.04, take_timeout_s=600.0))
    del base
    losses, gnorms = [], []
    _reset_counts()
    t0 = time.perf_counter()
    stats = fleet.run(c["steps"], on_step=lambda s, m: (losses.append(m["loss"]),
                                                         gnorms.append(m["grad_norm"])))
    torch.cuda.synchronize()
    fleet_s, counts = time.perf_counter() - t0, _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    learner, caster = fleet.learner, fleet.learner.broadcaster
    # relative, floored at 1e-3: a group-normalized surrogate is ~0 by
    # design, a sum of O(1) terms that cancel
    loss_rel = max(abs(a - b) / max(abs(b), 1e-3)
                   for a, b in zip(losses + gnorms, mono + mono_g))
    param_diff = max((a.detach().cpu().float() - b.float()).abs().max().item()
                     for a, b in zip(sorted_leaves(learner.state.params), mono_params))
    t1 = time.perf_counter()
    leaves, version, wstep = fleet.actors[0].receiver.poll(timeout=60.0)
    decode_s = time.perf_counter() - t1
    live = sorted_leaves(learner.state.params)
    bad = [i for i, (a, b) in enumerate(zip(leaves, live))
           if a.dtype != b.dtype or not torch.equal(a, b.detach().cpu())]
    publish_s = stats.weight_sync_s / max(caster.version, 1)
    split = fleet_goodput_split(stats, fleet.actors)
    want = (c["steps"] * 4 * n_layers, c["steps"] * n_layers, c["steps"] * n_layers)
    print(f"16b fleet [{smi}]: lockstep RLFleet (Gemma-2-2B's widths, {n_layers} of "
          f"{GEMMA2_2B['num_hidden_layers']} layers; 1 actor, maxWeightLag 0, B={B}, G={G}, "
          f"K={K}) {c['steps']} learner steps in {fleet_s:.1f} s against the monolithic loop "
          f"in {mono_s:.1f} s: losses {', '.join(f'{x:.6f}' for x in losses)} vs "
          f"{', '.join(f'{x:.6f}' for x in mono)}, grad norms "
          f"{', '.join(f'{x:.6f}' for x in gnorms)} vs {', '.join(f'{x:.6f}' for x in mono_g)} "
          f"(max rel diff {loss_rel:.3e}), final params "
          f"max_abs_diff {param_diff:.3e}; stale drops {stats.stale_dropped}, lag max "
          f"{stats.max_lag_observed}; weight record v{version} (step {wstep}) "
          f"{caster.last_payload_bytes / 1e9:.3f} GB, {len(leaves)} leaves decoded bit for bit "
          f"{'yes' if not bad else f'NO at {bad[:5]}'} in {decode_s:.2f} s; publish "
          f"{publish_s:.2f} s a version ({caster.last_payload_bytes / 1e9 / publish_s:.2f} "
          f"GB/s encode + send); rollout {split['rollout_s']:.2f} s, learn "
          f"{split['learn_s']:.2f} s, actor-starved {split['actor_starved_s']:.2f} s, "
          f"learner-starved {split['learner_starved_s']:.2f} s; peak {peak:.2f} GB; K1/K2/K3 "
          f"launches {counts}", flush=True)
    if loss_rel > 1e-5 or not all(g > 0 for g in gnorms) or stats.stale_dropped or bad or \
            version != caster.version:
        raise AssertionError("16b: the fleet disagrees with the monolith, dropped stale "
                             "groups or published a record that differs from its parameters")
    if counts != want:
        raise AssertionError(f"16b: launches (fwd, dq, dkv) {counts}, expected {want}")
    payload_gb = caster.last_payload_bytes / 1e9
    del fleet, learner, caster, leaves, live, mono_params
    return dict(losses=losses, mono_losses=mono, grad_norms=gnorms, mono_grad_norms=mono_g,
                loss_max_rel=loss_rel,
                param_max_abs=param_diff, stale_dropped=stats.stale_dropped, fleet_s=fleet_s,
                mono_s=mono_s, payload_gb=payload_gb, publish_s=publish_s,
                publish_gb_s=payload_gb / publish_s, decode_s=decode_s, peak_gb=peak,
                split=split, launches=list(counts))


def _16c_pods(smi, lane="dir"):
    """rl_pod as two processes on the card at bench-1b: a learner of 3
    steps (B 4, G 4, K 32, maxWeightLag 1; a checkpoint on the dir lane)
    and its actor, on the dir lane (16c), or (17d, lane="socket") over the authenticated
    socket plane on loopback addresses with one shared token, the actor
    rolling out through the serving plane (KUBEDL_RL_ENGINE=serving)."""
    c = RL_POD
    root = os.path.join(WORK, f"rl-pod-{lane}")
    shutil.rmtree(root, ignore_errors=True)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""),
               KUBEDL_RL_GROUP_SIZE=str(c["G"]), KUBEDL_RL_PROMPTS_PER_STEP=str(c["B"]),
               KUBEDL_RL_MAX_NEW_TOKENS=str(c["K"]), KUBEDL_RL_MAX_WEIGHT_LAG=str(c["lag"]),
               KUBEDL_TRACE_DIR=os.path.join(root, "trace"), KUBEDL_TRACE_ID="chip-smoke-rl")
    for k in ("KUBEDL_TRANSPORT", "KUBEDL_RL_ENGINE", "KUBEDL_RL_ACTORS", "KUBEDL_MESH",
              "KUBEDL_RL_QUEUE_DIR"):
        env.pop(k, None)
    role_env = {"learner": {}, "actor": {}}
    if lane == "dir":
        env["KUBEDL_RL_QUEUE_DIR"] = os.path.join(root, "queue")
    else:
        addrs = {role: f"127.0.0.1:{_free_port()}" for role in role_env}
        env.update(KUBEDL_TRANSPORT="socket", KUBEDL_TRANSPORT_TOKEN="chip-smoke-17d",
                   KUBEDL_RL_ENGINE="serving", KUBEDL_RL_LEARNER_ADDR=addrs["learner"],
                   KUBEDL_RL_ACTOR_ADDRS=addrs["actor"])
        for role, addr in addrs.items():
            role_env[role]["KUBEDL_TRANSPORT_BIND"] = addr
    cmd = [sys.executable, "-m", "kubedl_tpu_torch.train.rl_pod", "--model", c["model"],
           "--steps", str(c["steps"]), "--log-every", "1"]
    if lane == "dir":  # the learner's bench-1b checkpoint once; 17d takes the sockets
        cmd += ["--checkpoint-path", os.path.join(root, "ckpt")]
    t0 = time.perf_counter()
    procs = {role: subprocess.Popen(cmd, cwd=here, env=dict(env, KUBEDL_RL_ROLE=role,
                                                              POD_NAME=f"rl-{role}",
                                                              **role_env[role]),
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for role in ("learner", "actor")}
    outs = {}
    try:
        for role, proc in procs.items():
            outs[role] = proc.communicate(timeout=600)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall_s = time.perf_counter() - t0
    rcs = {role: proc.returncode for role, proc in procs.items()}
    lout, aout = outs["learner"], outs["actor"]
    groups = c["steps"] * c["B"]
    spans = _trace_spans(os.path.join(root, "trace"))
    learn = [sp["dur"] for sp in spans if sp["name"] == "rl.learn"]
    rolls = [sp["dur"] for sp in spans if sp["name"] == "rl.rollout"]
    tag = "16c pods" if lane == "dir" else "17d pods"
    how = ("on the dir lane" if lane == "dir" else
           "over the socket plane (loopback, one token) with KUBEDL_RL_ENGINE=serving")
    print(f"{tag} [{smi}]: rl_pod --model {c['model']} learner + actor as two processes "
          f"{how} ({c['steps']} learner steps, B={c['B']}, G={c['G']}, K={c['K']}, "
          f"maxWeightLag {c['lag']}) in {wall_s:.1f} s (start-up included): exit codes {rcs}; "
          f"learn s {', '.join(f'{x:.2f}' for x in learn)}; rollout s "
          f"{', '.join(f'{x:.2f}' for x in rolls)}; "
          f"{(re.findall(r'learner: done — .*', lout) or ['learner: ?'])[0]}; "
          f"{(re.findall(r'actor-0: done — .*', aout) or ['actor-0: ?'])[0]}", flush=True)
    if rcs != {"learner": 0, "actor": 0} or \
            f"consumed={groups} stale_dropped=0" not in lout or \
            f"published_version={c['steps']}" not in lout or \
            f"final weight version {c['steps']} (step {c['steps']})" not in aout or \
            (lane == "socket" and "engine=serving" not in aout) or \
            (lane == "dir" and
             not os.path.isdir(os.path.join(root, "ckpt", "learner", str(c["steps"])))):
        raise AssertionError(f"{tag}: rl_pod roles failed:\nlearner:\n{lout[-3000:]}\n"
                             f"actor:\n{aout[-3000:]}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(wall_s=wall_s, rcs=rcs, learn_s=learn, rollout_s=rolls, consumed=groups)


def phase_rl(path, smi, beside=None):
    """16: a) grpo --hf-model on Gemma-2-2B, with a resume; b) the lockstep
    RLFleet on the same weights against the monolithic loop; c) rl_pod's two
    roles as processes at bench-1b. `beside(16a's numbers)`, when given,
    starts work that runs in processes of its own (phase 23's pairs) after
    a, beside b, c and phase 17d (rl_pod over sockets, which only waits on
    its pods too, run here then); what it returns comes back under
    "beside", 17d's numbers under "d_socket_pods"."""
    out = {"a_grpo": _16a_grpo(path, smi)}
    _free("16a")
    if beside is not None:
        out["beside"] = beside(out["a_grpo"])
    out["b_fleet"] = _16b_fleet(path, smi)
    _free("16b")
    out["c_pods"] = _16c_pods(smi)
    if beside is not None:
        out["d_socket_pods"] = _phase("17d (beside phase 23's pairs)", _16c_pods, smi,
                                      "socket")
    return out


# phase 23: DPO, GRPO and evaluation under a mesh. Each program runs as two
# processes sharing the card in a gloo group (--backend gloo: NCCL cannot
# hold two ranks on one device), from the operator's env, on 16a's
# directory (Gemma-2-2B at full width, G2_GRPO's 2 of 26 layers), started
# after 16a, beside 16b and the pods of 16c and 17d (its ranks spend their
# first seconds importing torch on the host; 17d runs there, in phase 16's
# window, for that). 15d's one-process dpo and evaluate and 16a's first
# steps on the same directory are the baselines.
POST_MESH = {"dpo": "tensor=2", "grpo": "data=2", "evaluate": "tensor=2"}
POST_GRPO_STEPS = 2       # 23b's first run; its resume takes one step more
POST_LOSS_TOL = 2e-2      # 23a, 23b: step 1 against one process (bf16)
POST_NLL_TOL = 1e-2       # 23c: nll against one process (bf16)
_POST_REPORT = re.compile(
    r"process (\d)/2: peak allocated (\S+) GB; flash launches fwd/dq/dkv \((\d+), (\d+), "
    r"(\d+)\); host-staged collectives (\S+) MB in (\S+) s")

# 23b's first run: the program as `python -m` runs it, its first rollout
# written beside
_GRPO_RANK = """
import json, runpy, sys
from kubedl_tpu_torch.models import decode
out, generate = sys.argv[1], decode.generate
def first(params, prompt, *a, **kw):
    got = generate(params, prompt, *a, **kw)
    if not hasattr(first, "done"):
        first.done = True
        with open(out, "w") as f:
            json.dump(got.tolist(), f)
    return got
decode.generate = first
sys.argv = ["kubedl_tpu_torch.train.grpo"] + sys.argv[2:]
runpy.run_module("kubedl_tpu_torch.train.grpo", run_name="__main__")
"""


def _post_pair(argvs, tag, mesh):
    """Two ranks of one gloo gang (the operator's env: a loopback
    coordinator, KUBEDL_NUM_PROCESSES 2, KUBEDL_PROCESS_ID, KUBEDL_MESH),
    spans exported per rank (POD_NAME <tag>-rank<r>); started."""
    root = os.path.dirname(os.path.abspath(__file__))
    port, trace = _free_port(), os.path.join(WORK, f"trace-{tag}")
    shutil.rmtree(trace, ignore_errors=True)
    logs = [os.path.join(WORK, f"{tag}-rank{r}.log") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable] + argvs[r], cwd=root, stdout=open(logs[r], "w"),
        stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                 KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", KUBEDL_NUM_PROCESSES="2",
                 KUBEDL_PROCESS_ID=str(r), KUBEDL_MESH=mesh, KUBEDL_TRACE_DIR=trace,
                 POD_NAME=f"{tag}-rank{r}")) for r in range(2)]
    return dict(tag=tag, procs=procs, logs=logs, trace=trace, t0=time.perf_counter())


def _post_wait(pair, timeout=600):
    """Wait for a pair: its exit codes, texts, wall seconds and each rank's
    spans, gloo backend and report line (launches, staged collectives)."""
    try:
        for p in pair["procs"]:
            p.wait(timeout=max(timeout - (time.perf_counter() - pair["t0"]), 1))
    finally:
        for p in pair["procs"]:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = dict(tag=pair["tag"], wall_s=time.perf_counter() - pair["t0"],
               rcs=[p.returncode for p in pair["procs"]],
               texts=[open(x).read() for x in pair["logs"]])
    if out["rcs"] != [0, 0]:
        raise AssertionError(f"{pair['tag']}: exits {out['rcs']}:\n" +
                             "\n".join(t[-2500:] for t in out["texts"]))
    spans = _trace_spans(pair["trace"])
    out["ranks"] = []
    for r, text in enumerate(out["texts"]):
        backend = re.search(rf"process {r}/2: process group backend (\w+)", text)
        if backend is None or backend.group(1) != "gloo":
            # NCCL cannot hold two ranks on one device: no switch
            raise AssertionError(f"{pair['tag']} rank {r}: backend "
                                 f"{backend and backend.group(1)}, not gloo")
        print(backend.group(0), f"({pair['tag']})", flush=True)  # each rank's backend line
        rep = [m for m in _POST_REPORT.finditer(text) if int(m.group(1)) == r]
        if not rep:
            raise AssertionError(f"{pair['tag']} rank {r}: no report line:\n{text[-2000:]}")
        m = rep[-1]
        out["ranks"].append(dict(
            peak_gb=float(m.group(2)), counts=tuple(int(m.group(i)) for i in (3, 4, 5)),
            staged_mb=float(m.group(6)), staged_s=float(m.group(7)),
            spans=[sp for sp in spans if sp["service"] == f"{pair['tag']}-rank{r}"]))
    return out


def _post_counts(res, want):
    for r, rk in enumerate(res["ranks"]):
        if rk["counts"] != want:
            raise AssertionError(f"{res['tag']} rank {r}: launches (fwd, dq, dkv) "
                                 f"{rk['counts']}, expected {want}")


def _near(a, b, tol, floor):
    return abs(a - b) <= tol * max(abs(b), floor)


def _23_start(cut, pairs, shard, grpo):
    """Start 23a (dpo, tensor=2, with a checkpoint) and 23c (evaluate,
    tensor=2), and on a thread 23b (grpo, data=2, POST_GRPO_STEPS steps
    with a checkpoint, then a resume for one step more); returns what
    `_23_finish` waits for."""
    c, e = G2_DPO, G2_EVAL
    gloo = ["--backend", "gloo"]
    ckpt = {k: os.path.join(WORK, f"ckpt-23{k}") for k in "ab"}
    for d in ckpt.values():
        shutil.rmtree(d, ignore_errors=True)
    dpo_argv = ["-m", "kubedl_tpu_torch.train.dpo", "--hf-model", cut, "--data-path", pairs,
                "--batch", str(c["batch"]), "--seq-len", str(c["seq"]), "--steps",
                str(c["steps"]), "--log-every", "1", "--lr", "1e-6", "--checkpoint-path",
                ckpt["a"]] + gloo
    eval_argv = ["-m", "kubedl_tpu_torch.train.evaluate", "--hf-model", cut, "--data-path",
                 shard, "--batch", str(e["batch"]), "--seq-len", str(e["seq"]),
                 "--log-every", "0"] + gloo
    i = grpo["argv"].index("--checkpoint-path")  # 16a's argv, 16a's checkpoint dropped
    grpo_argv = grpo["argv"][:i] + grpo["argv"][i + 2:] + ["--checkpoint-path", ckpt["b"]] + gloo
    rollouts = [os.path.join(WORK, f"23b-rollout{r}.json") for r in range(2)]
    started = dict(t0=time.perf_counter(), ckpt=ckpt, rollouts=rollouts,
                   a=_post_pair([dpo_argv] * 2, "23a", POST_MESH["dpo"]),
                   c=_post_pair([eval_argv] * 2, "23c", POST_MESH["evaluate"]))

    def chain():
        try:
            started["b_live"] = _post_pair(
                [["-c", _GRPO_RANK, rollouts[r], *grpo_argv, "--steps",
                  str(POST_GRPO_STEPS)] for r in range(2)], "23b", POST_MESH["grpo"])
            started["b"] = _post_wait(started["b_live"])
            started["b_live"] = _post_pair(
                [["-m", "kubedl_tpu_torch.train.grpo", *grpo_argv, "--steps",
                  str(POST_GRPO_STEPS + 1)]] * 2, "23b-resume", POST_MESH["grpo"])
            started["b_resume"] = _post_wait(started["b_live"])
        except BaseException as err:  # noqa: BLE001 -- raised again by _23_finish
            started["b_error"] = err

    started["thread"] = threading.Thread(target=chain)
    started["thread"].start()
    return started


def _23_finish(started, cut, one, grpo, smi):
    """Wait for phase 23's pairs and hold each to one process: 23a's step-1
    loss and margin against 15d's dpo (POST_LOSS_TOL), 23b's step-1 rollout
    against 16a's (equal, or parting only at a near-tie) and its step-1
    loss and grad norm against 16a's (POST_LOSS_TOL), its resume from the
    sharded checkpoint, 23c's tokens and nll against 15d's evaluate
    (POST_NLL_TOL); every rank's K1/K2/K3 launches against the counts the
    shapes imply."""
    n_layers = G2_GRPO["layers"]
    try:
        a = _post_wait(started["a"])
        ce = _post_wait(started["c"])
    finally:
        started["thread"].join()
    if "b_error" in started:
        raise started["b_error"]
    b, br = started["b"], started["b_resume"]
    wall_s = time.perf_counter() - started["t0"]

    # 23a: dpo on tensor=2
    steps = re.findall(r"step (\d+): loss=(\S+) margin=(\S+) acc=(\S+)", a["texts"][0])
    losses, margins = [float(x[1]) for x in steps], [float(x[2]) for x in steps]
    if len(steps) != G2_DPO["steps"] or re.search(r"step \d+: loss=", a["texts"][1]):
        raise AssertionError(f"23a: step lines {steps} (rank 0 alone prints them)")
    want_l, want_m = one["dpo_losses"][0], one["dpo_margins"][0]
    if not (_near(losses[0], want_l, POST_LOSS_TOL, 1e-3) and
            _near(margins[0], want_m, POST_LOSS_TOL, 1e-3)):
        raise AssertionError(f"23a: step 1 loss {losses[0]} margin {margins[0]} against one "
                             f"process's {want_l} {want_m}")
    if f"saved policy checkpoint at step {G2_DPO['steps']}" not in a["texts"][0] or \
            not os.path.isdir(os.path.join(started["ckpt"]["a"], str(G2_DPO["steps"]))):
        raise AssertionError("23a: no sharded checkpoint")
    _post_counts(a, _dpo_launches(n_layers))
    a_step_s = [[sp["dur"] for sp in sorted(rk["spans"], key=lambda sp: sp["attrs"]["step"])
                 if sp["name"] == "dpo.step"] for rk in a["ranks"]]

    # 23b: grpo on data=2, then the resume
    got = [json.load(open(x)) for x in started["rollouts"]]
    if got[0] != got[1]:
        raise AssertionError("23b: the two ranks rolled out different tokens")
    want_roll = grpo["rollout1"]
    splits = []
    if got[0] != want_roll:
        from kubedl_tpu_torch.models.import_hf import load_hf

        params, config = load_hf(cut, device="cuda")
        prompts = [p[:G2_GRPO["prompt_len"]] for p in grpo["prompts1"]]
        splits = _near_ties_only(params, config, prompts, want_roll, got[0],
                                 "23b rollout against 16a's")
        del params
    ups = [sorted((sp for sp in rk["spans"] if sp["name"] == "grpo.update"),
                  key=lambda sp: sp["attrs"]["step"]) for rk in b["ranks"]]
    if any(len(u) != POST_GRPO_STEPS for u in ups) or \
            any(u0["attrs"]["loss"] != u1["attrs"]["loss"] for u0, u1 in zip(*ups)):
        raise AssertionError(f"23b: updates {[[sp['attrs'] for sp in u] for u in ups]}")
    loss1, gn1 = ups[0][0]["attrs"]["loss"], ups[0][0]["attrs"]["grad_norm"]
    if not (_near(loss1, grpo["loss1"], POST_LOSS_TOL, 1e-3) and
            _near(gn1, grpo["grad_norms"][0], POST_LOSS_TOL, 1e-3)):
        raise AssertionError(f"23b: step 1 loss {loss1} grad_norm {gn1} against one "
                             f"process's {grpo['loss1']} {grpo['grad_norms'][0]}")
    if f"restored policy checkpoint at step {POST_GRPO_STEPS}" not in br["texts"][0] or \
            f"step {POST_GRPO_STEPS + 1}: reward=" not in br["texts"][0]:
        raise AssertionError(f"23b: the resume did not restore step {POST_GRPO_STEPS}:\n"
                             f"{br['texts'][0][-2000:]}")
    per_step = (4 * n_layers, n_layers, n_layers)  # rollout prefill, reference, policy x2
    _post_counts(b, tuple(POST_GRPO_STEPS * x for x in per_step))
    _post_counts(br, per_step)
    b_up_s = [[sp["dur"] for sp in u] for u in ups]
    b_roll_s = [[sp["dur"] for sp in rk["spans"] if sp["name"] == "grpo.rollout"]
                for rk in b["ranks"]]

    # 23c: evaluate on tensor=2
    lines = [ln for ln in ce["texts"][0].splitlines() if '"eval_perplexity"' in ln]
    if not lines or '"eval_perplexity"' in ce["texts"][1]:
        raise AssertionError(f"23c: JSON lines {lines} (rank 0 alone prints one)")
    line, want = json.loads(lines[-1]), one["eval"]
    if line["tokens"] != want["tokens"] or not _near(line["nll"], want["nll"], POST_NLL_TOL,
                                                     0.0):
        raise AssertionError(f"23c: {line} against one process's {want}")
    _post_counts(ce, (G2_EVAL["batches"] * n_layers, 0, 0))

    def ranks(res, key, fmt):
        return " / ".join(fmt.format(rk[key]) for rk in res["ranks"])

    def staged(res):
        return " / ".join(f"{rk['staged_mb']:.1f} MB in {rk['staged_s']:.3f} s"
                          for rk in res["ranks"])

    print(f"23a dpo pair [{smi}]: dpo --hf-model (Gemma-2-2B's widths, {n_layers} of 26 "
          f"layers) on {POST_MESH['dpo']}, two processes sharing the card over gloo, "
          f"{G2_DPO['steps']} steps of {G2_DPO['batch']} pairs x {G2_DPO['seq']} tokens and a "
          f"sharded checkpoint in {a['wall_s']:.1f} s (start-up included): losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}, margins "
          f"{', '.join(f'{x:.3f}' for x in margins)}; step 1 against one process's "
          f"{want_l:.4f} / {want_m:.3f}; steps s rank 0 "
          f"{', '.join(f'{x:.3f}' for x in a_step_s[0])}, rank 1 "
          f"{', '.join(f'{x:.3f}' for x in a_step_s[1])} (one process "
          f"{', '.join(f'{x:.3f}' for x in one['dpo_step_s'])}); host-staged collectives "
          f"{staged(a)}; peak {ranks(a, 'peak_gb', '{:.2f}')} GB; K1/K2/K3 launches a rank "
          f"{ranks(a, 'counts', '{}')}", flush=True)
    print(f"23b grpo pair [{smi}]: grpo --hf-model on {POST_MESH['grpo']}, {G2_GRPO['B']} "
          f"prompts x {G2_GRPO['G']} samples x {G2_GRPO['K']} new tokens, "
          f"{POST_GRPO_STEPS} steps with a sharded checkpoint in {b['wall_s']:.1f} s, resumed "
          f"for step {POST_GRPO_STEPS + 1} in {br['wall_s']:.1f} s: step-1 rollout "
          f"{'equal to' if not splits else f'parting at near-ties {splits} from'} 16a's on "
          f"both ranks; step-1 loss {loss1:.6f} grad_norm {gn1:.4f} against one process's "
          f"{grpo['loss1']:.6f} {grpo['grad_norms'][0]:.4f}; update s rank 0 "
          f"{', '.join(f'{x:.3f}' for x in b_up_s[0])}, rank 1 "
          f"{', '.join(f'{x:.3f}' for x in b_up_s[1])} (one process "
          f"{', '.join(f'{x:.3f}' for x in grpo['update_s'][:POST_GRPO_STEPS])}); rollout s "
          f"rank 0 {', '.join(f'{x:.2f}' for x in b_roll_s[0])}; host-staged collectives "
          f"{staged(b)}; peak {ranks(b, 'peak_gb', '{:.2f}')} GB; K1/K2/K3 launches a rank "
          f"{ranks(b, 'counts', '{}')} + resume {ranks(br, 'counts', '{}')}", flush=True)
    print(f"23c evaluate pair [{smi}]: evaluate --hf-model on {POST_MESH['evaluate']} in "
          f"{ce['wall_s']:.1f} s: {json.dumps(line)} against one process's nll "
          f"{want['nll']:.6f}, {want['tokens_per_sec']:.0f} tok/s; host-staged collectives "
          f"{staged(ce)}; peak {ranks(ce, 'peak_gb', '{:.2f}')} GB; K1 launches a rank "
          f"{ranks(ce, 'counts', '{}')}; phase 23 from its start {wall_s:.1f} s", flush=True)
    for d in started["ckpt"].values():
        shutil.rmtree(d, ignore_errors=True)

    def launches(res, tag):
        return {f"gemma2_{tag}_rank{r}": rk["counts"] for r, rk in enumerate(res["ranks"])}
    return dict(wall_s=wall_s, dpo_losses=losses, dpo_margins=margins, dpo_step_s=a_step_s,
                grpo_loss1=loss1, grpo_grad_norm1=gn1, grpo_splits=splits,
                grpo_update_s=b_up_s, grpo_rollout_s=b_roll_s, eval=line,
                staged={res["tag"]: [(rk["staged_mb"], rk["staged_s"]) for rk in res["ranks"]]
                        for res in (a, b, br, ce)},
                peak_gb={res["tag"]: [rk["peak_gb"] for rk in res["ranks"]]
                         for res in (a, b, br, ce)},
                pair_s={res["tag"]: res["wall_s"] for res in (a, b, br, ce)},
                launches={**launches(a, "dpo_tensor2"), **launches(b, "grpo_data2"),
                          **launches(br, "grpo_data2_resume"),
                          **launches(ce, "eval_tensor2")})


def phase_gemma2(smi):
    """15: Gemma-2-2B from a local Hugging Face directory through the d 256
    kernels: a) write and load it, prefill; b) generate and serve; c) the
    trainer; then a directory of its config cut to G2_GRPO's layers for d)
    dpo and evaluate, phase 16, phase 23's pairs and 17b. The directories
    are removed after."""
    import tempfile

    os.makedirs(WORK, exist_ok=True)
    path = tempfile.mkdtemp(prefix="gemma-2-2b-", dir=WORK)
    out, cut, started = {}, None, None
    try:
        out["a_load"] = _15a_load(path, smi)
        _free("15a")
        out["b_serve"] = _15b_serve(path, smi)
        _free("15b")
        out["c_train"] = _15c_train(path, smi)
        _free("15c")
        shutil.rmtree(path, ignore_errors=True)
        # 15d, 16, 17b and 23: Gemma-2-2B's config cut to G2_GRPO's layers,
        # a directory of its own, seeded as the full one
        n_layers = G2_GRPO["layers"]
        cut = tempfile.mkdtemp(prefix="gemma-2-2b-grpo-", dir=WORK)
        write_hf_checkpoint(cut, dict(GEMMA2_2B, num_hidden_layers=n_layers,
                                      layer_types=GEMMA2_2B["layer_types"][:n_layers]))
        pairs, shard = _15d_data(cut)
        out["d_dpo_eval"] = _15d_dpo_eval(cut, smi, pairs, shard)
        _free("15d")

        def start_23(grpo):
            nonlocal started
            started = _23_start(cut, pairs, shard, grpo)
            return started

        out["rl"] = _phase("16 RL: GRPO, the fleet and the pods (23's pairs beside 16b, 16c, 17d)",
                           phase_rl, cut, smi, start_23)
        out["post"] = _phase("23 post-training under a mesh: dpo, grpo and evaluate as gloo "
                             "pairs (the rest of it)", _23_finish, out["rl"].pop("beside"),
                             cut, out["d_dpo_eval"], out["rl"]["a_grpo"], smi)
        started = None
        _free("16 and 23")
        out["rollout"] = _phase("17b serving-plane rollout at d 256", _17b_rollout, cut, smi)
    finally:
        if started is not None:  # a failure before 23 finished: its pairs go
            for k in "ac":
                for proc in started[k]["procs"]:
                    if proc.poll() is None:
                        proc.kill()
            started["thread"].join(timeout=5)
            for proc in started.get("b_live", {}).get("procs", []):
                if proc.poll() is None:
                    proc.kill()
            started["thread"].join()
        shutil.rmtree(path, ignore_errors=True)
        if cut is not None:
            shutil.rmtree(cut, ignore_errors=True)
    d, post = out["d_dpo_eval"], out["post"]["launches"]
    g, f = out["rl"]["a_grpo"]["launches"], out["rl"]["b_fleet"]["launches"]
    out["launches"] = {"fwd": {"gemma2_prefill": out["a_load"]["launches"],
                               "gemma2_serving": out["b_serve"]["launches"],
                               "gemma2_train": out["c_train"]["launches"][0],
                               "gemma2_dpo": d["dpo_launches"][0],
                               "gemma2_eval": d["eval_launches"],
                               "gemma2_grpo": g[0], "gemma2_rl_fleet": f[0],
                               "gemma2_serving_rollout": out["rollout"]["launches"],
                               **{k: v[0] for k, v in post.items()}},
                       "dq": {"gemma2_train": out["c_train"]["launches"][1],
                              "gemma2_dpo": d["dpo_launches"][1],
                              "gemma2_grpo": g[1], "gemma2_rl_fleet": f[1],
                              **{k: v[1] for k, v in post.items() if v[1]}},
                       "dkv": {"gemma2_train": out["c_train"]["launches"][2],
                               "gemma2_dpo": d["dpo_launches"][2],
                               "gemma2_grpo": g[2], "gemma2_rl_fleet": f[2],
                               **{k: v[2] for k, v in post.items() if v[2]}}}
    return out




# -- phase 17: the disaggregated serving plane (serving/) on the socket
# transport plane (transport/) -----------------------------------------------

PAGED_BLOCK = 16          # KV rows a block of the paged pool
PAGED_TURNS = ("mono", "paged", "paged", "mono")
PAGED_PROBE_SLOTS = 32    # 17a: slots over a pool of the [8, 1024] cache's KV bytes
ROUTER_K, ROUTER_DRAIN_AFTER = 8, 4   # 17c: ticks a round; rounds before the drain


def _drive_any(engine, prompts, dup):
    """Phase 4's traffic (every prompt at once, then `dup` twice) through
    step_block(8) of a ServingEngine or a DisaggregatedEngine: tokens, K1
    launches, decode ms a tick (median over the blocks that ticked), peak
    memory above the engine's resident state."""
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    _reset_counts()
    t0 = time.perf_counter()
    per_tick, reqs = [], []
    for wave in (prompts, [dup, dup]):
        batch = [engine.submit(p, SERVE_NEW) for p in wave]
        reqs += batch
        while not all(r.done for r in batch):
            st = engine.stats()
            ticks, dec = st["ticks"], st["decode_time_s"]
            engine.step_block(8)
            st = engine.stats()
            if st["ticks"] > ticks:
                per_tick.append((st["decode_time_s"] - dec) / (st["ticks"] - ticks))
    torch.cuda.synchronize()
    return dict(tokens=[r.tokens for r in reqs], errors=[r.error for r in reqs],
                launches=flash_attention.launches, wall_s=time.perf_counter() - t0,
                tick_ms=statistics.median(per_tick) * 1e3,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                transient_gb=(torch.cuda.max_memory_allocated() - resident) / 1e9)


def _near_ties_only(params, config, prompts, want, got, what):
    """Phase 15's rule: two bf16 paths may part only where the two tokens'
    logits lie within LOGIT_TOL of max|logit|. Returns the split points."""
    splits = _first_splits(params, config, prompts, want, got)
    far = [sp for sp in splits if sp[2] > LOGIT_TOL * sp[3]]
    if far:
        raise AssertionError(f"{what}: tokens part away from a near-tie: {far}")
    return splits


def _17a_facade(smi):
    """DisaggregatedEngine on Llama-7B (full width, DISAGG_LAYERS of its 32
    layers, bf16, seeded) against the monolithic ServingEngine with phase 4's traffic, in turns;
    then the paged pool's concurrency at the contiguous cache's KV bytes."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.models.serving import ServingEngine
    from kubedl_tpu_torch.serving import DisaggregatedEngine

    config = dataclasses.replace(llama.LlamaConfig.llama_7b(), n_layers=DISAGG_LAYERS)
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, config.vocab_size, (n,), generator=rng).tolist()
               for n in SERVE_LENGTHS]
    dup = prompts[2]
    every = prompts + [dup, dup]
    engines = {"mono": ServingEngine(params, config, slots=8, max_len=1024),
               # prefix sharing off: the repeated prompt prefills as a wave,
               # as the monolithic engine's does (a matched prefix appends
               # its suffix in block steps, which launch no K1)
               "paged": DisaggregatedEngine(params, config, slots=8, max_len=1024,
                                            block_size=PAGED_BLOCK, share_prefixes=False)}
    turns = {}
    for label in PAGED_TURNS:
        turns.setdefault(label, []).append(_drive_any(engines[label], prompts, dup))
    for label, runs in turns.items():
        if any(e for r in runs for e in r["errors"]) or runs[0]["tokens"] != runs[1]["tokens"]:
            raise AssertionError(f"17a: the {label} engine's turns differ or failed")
    mono, paged = turns["mono"][0], turns["paged"][0]
    if paged["launches"] != mono["launches"] or paged["launches"] < config.n_layers:
        raise AssertionError(f"17a: K1 launches paged {paged['launches']}, monolithic "
                             f"{mono['launches']}")
    pool = engines["paged"].stats()
    pool = {k: pool[k] for k in ("num_blocks", "block_size", "blocks_free", "blocks_in_use",
                                 "alloc_count", "cow_copies", "handoffs", "evictions")}
    splits = _near_ties_only(params, config, every, mono["tokens"], paged["tokens"], "17a")
    equal = sum(a == b for a, b in zip(mono["tokens"], paged["tokens"]))
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    # the concurrency probe: PAGED_PROBE_SLOTS slots over the blocks of the
    # [8, 1024] cache (+ the trash block), phase 4's lengths cycled
    num_blocks = 8 * (1024 // PAGED_BLOCK) + 1
    probe = DisaggregatedEngine(params, config, slots=PAGED_PROBE_SLOTS, max_len=1024,
                                block_size=PAGED_BLOCK, num_blocks=num_blocks,
                                share_prefixes=False)
    reqs = [probe.submit(prompts[i % len(prompts)], SERVE_NEW)
            for i in range(PAGED_PROBE_SLOTS)]
    streams = []
    for _ in range(3):
        probe.step_block(8)
        streams.append(probe.stats()["slots_busy"])
    most = max(streams)
    probe_stats = probe.stats()
    for r in reqs:
        probe.cancel(r)
    del probe, reqs
    ticks = {k: [r["tick_ms"] for r in v] for k, v in turns.items()}
    peaks = {k: [r["peak_gb"] for r in v] for k, v in turns.items()}
    trans = {k: [r["transient_gb"] for r in v] for k, v in turns.items()}
    print(f"17a facade [{smi}]: llama-7b bf16, 8 slots, 1024 positions, phase 4's traffic "
          f"(block {PAGED_BLOCK}, prefix sharing off); turns {'/'.join(PAGED_TURNS)}: "
          f"{equal}/{len(every)} rows equal to the monolithic engine's, rows that part at "
          f"(row, position, logit gap, max |logit|) "
          f"{[(i, j, round(g, 4), round(m, 3)) for i, j, g, m in splits]}; K1 launches "
          f"{paged['launches']} both; decode ms a tick (median) paged "
          f"{', '.join(f'{x:.2f}' for x in ticks['paged'])}, contiguous "
          f"{', '.join(f'{x:.2f}' for x in ticks['mono'])}; peak allocated GB paged "
          f"{', '.join(f'{x:.2f}' for x in peaks['paged'])} (above resident "
          f"{', '.join(f'{x:.2f}' for x in trans['paged'])}), contiguous "
          f"{', '.join(f'{x:.2f}' for x in peaks['mono'])} (above resident "
          f"{', '.join(f'{x:.2f}' for x in trans['mono'])}); pool {pool}", flush=True)
    print(f"17a concurrency [{smi}]: {PAGED_PROBE_SLOTS} slots over {num_blocks} blocks of "
          f"{PAGED_BLOCK} rows (the [8, 1024] cache's KV bytes + the trash block), phase 4's "
          f"lengths cycled, {SERVE_NEW} new tokens each: streams decoding after each of 3 "
          f"blocks {streams}, most {most} against 8 contiguous slots (ratio "
          f"{most / 8:.3f}); evictions {probe_stats['evictions']}, requeues "
          f"{probe_stats['requeues']}", flush=True)
    if most <= 8:
        raise AssertionError(f"17a: the paged pool decoded at most {most} streams at the "
                             f"contiguous cache's KV bytes")
    out = dict(rows_equal=equal, splits=splits, launches=paged["launches"], tick_ms=ticks,
               peak_gb=peaks, transient_gb=trans, pool=pool, wall_s={
                   k: [r["wall_s"] for r in v] for k, v in turns.items()},
               probe_streams=streams, probe_most=most, concurrency_ratio=most / 8,
               probe_evictions=probe_stats["evictions"])
    return out, params, config, every, mono["tokens"]


class _Hop:
    """The cross-pod hop as two planes: the prefill side's channel sends to
    the decode side's plane, whose inbox receives. Times each half."""

    def __init__(self, send_ch, recv_ch):
        self.send_ch, self.recv_ch = send_ch, recv_ch
        self.seconds = 0.0

    def send(self, tag, data):
        t0 = time.perf_counter()
        self.send_ch.send(tag, data)
        self.seconds += time.perf_counter() - t0

    def recv(self, tag, timeout=60.0):
        t0 = time.perf_counter()
        data = self.recv_ch.recv(tag, timeout)
        self.seconds += time.perf_counter() - t0
        return data


def _17c_router(params, config, every, want, smi):
    """One PrefillPod and two DecodePods in this process, every handoff
    serialized and carried over a SocketChannel pair of two
    TransportPlanes on 127.0.0.1; one decode pod drained mid-stream."""
    from kubedl_tpu_torch.ops.flash_attention import flash_attention
    from kubedl_tpu_torch.serving import router as rt
    from kubedl_tpu_torch.transport import TransportPlane, transport_metrics

    transport_metrics.reset()
    prefill_side = TransportPlane(token="chip-smoke-17c", service="prefill-pod")
    decode_side = TransportPlane(token="chip-smoke-17c", service="decode-pods")
    timed = {"serialize": 0.0, "deserialize": 0.0}
    real = (rt.serialize_item, rt.deserialize_item)

    def timing(name, fn):
        def wrapped(x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x)
            timed[name] += time.perf_counter() - t0
            return out
        return wrapped

    rt.serialize_item = timing("serialize", real[0])
    rt.deserialize_item = timing("deserialize", real[1])
    try:
        addr = decode_side.listen("127.0.0.1:0")
        hop = _Hop(prefill_side.channel("kv", peer_addr=addr), decode_side.channel("kv"))
        router = rt.ServingRouter(
            [rt.PrefillPod("p0", params, config, max_len=1024)],
            [rt.DecodePod(n, params, config, slots=8, max_len=1024, block_size=PAGED_BLOCK)
             for n in ("d0", "d1")], cross_pod=True, transport=hop)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [router.submit(p, SERVE_NEW) for p in every]
        for _ in range(ROUTER_DRAIN_AFTER):
            router.step_all(k=ROUTER_K)
        victim = max(router.decode_pods, key=lambda p: len(p.in_flight()))
        moved_ids = {r.request_id for r in victim.in_flight()}
        moved = router.drain(victim.name)
        while not all(r.done for r in reqs):
            router.step_all(k=ROUTER_K)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = flash_attention.launches
        st = router.stats()
    finally:
        rt.serialize_item, rt.deserialize_item = real
        prefill_side.close()
        decode_side.close()
    got = [r.tokens for r in reqs]
    if any(r.error for r in reqs) or moved <= 0 or victim.in_flight():
        raise AssertionError(f"17c: errors {[r.error for r in reqs]}, moved {moved}")
    splits = _near_ties_only(params, config, every, want, got, "17c")
    equal = sum(a == b for a, b in zip(want, got))
    migrated_equal = sum(a == b for r, a, b in zip(reqs, want, got) if r.request_id in moved_ids)
    hops = st["handoffs_total"]
    mb = st["serialized_bytes"] / 1e6
    hop_s = timed["serialize"] + timed["deserialize"] + hop.seconds
    wire = transport_metrics.snapshot()
    if hops != len(every) + moved or wire["messages_total"].get("kv/recv") != hops:
        raise AssertionError(f"17c: {hops} handoffs for {len(every)} requests + {moved} "
                             f"migrations; the plane carried {wire['messages_total']}")
    if launches < hops * config.n_layers:
        raise AssertionError(f"17c: K1 launched {launches} times for {hops} prefills")
    print(f"17c router [{smi}]: llama-7b, 1 prefill pod + 2 decode pods (8 slots, block "
          f"{PAGED_BLOCK}), cross_pod over a SocketChannel pair of two TransportPlanes on "
          f"127.0.0.1, phase 4's traffic; {victim.name} drained after {ROUTER_DRAIN_AFTER} "
          f"rounds of k={ROUTER_K}: {moved} streams migrated, {migrated_equal}/{moved} of them "
          f"equal to 17a's monolithic tokens; {equal}/{len(every)} rows equal overall, rows "
          f"that part at {[(i, j, round(g, 4), round(m, 3)) for i, j, g, m in splits]}; "
          f"{hops} handoffs, {mb:.1f} MB serialized ({mb / hops:.1f} MB a handoff), hop "
          f"{hop_s:.2f} s (serialize {timed['serialize']:.2f}, socket {hop.seconds:.2f}, "
          f"deserialize {timed['deserialize']:.2f}) = {mb / hop_s:.0f} MB/s; K1 launches "
          f"{launches}; wall {wall_s:.1f} s", flush=True)
    return dict(rows_equal=equal, migrated=moved, migrated_equal=migrated_equal, splits=splits,
                handoffs=hops, serialized_mb=mb, mb_per_handoff=mb / hops, hop_s=hop_s,
                serialize_s=timed["serialize"], socket_s=hop.seconds,
                deserialize_s=timed["deserialize"], hop_mb_s=mb / hop_s, launches=launches,
                wall_s=wall_s)


def _17b_rollout(path, smi):
    """RolloutEngine on 16a's Gemma-2-2B directory (d 256, G2_GRPO's layers):
    16a's rollout shape
    (4 prompts x G 8 x 32 new tokens), a cold wave and a warm wave of the
    same prompts, in turns with decode.generate's rollout of the same rows;
    behavior logprobs against a teacher-forced sequence_logprobs."""
    from kubedl_tpu_torch.models import decode
    from kubedl_tpu_torch.models.import_hf import load_hf
    from kubedl_tpu_torch.ops.flash_attention import flash_attention
    from kubedl_tpu_torch.serving import RolloutEngine
    from kubedl_tpu_torch.train.grpo import sampling_generator
    from kubedl_tpu_torch.train.preference import sequence_logprobs

    c = G2_GRPO
    B, G, K, P = c["B"], c["G"], c["K"], c["prompt_len"]
    _, prompts = _grpo_prompts(path, c, GEMMA2_2B["vocab_size"])
    prompts = prompts[:B]
    params, config = load_hf(path, device="cuda")
    eng = RolloutEngine(params, config, slots=B * G, max_len=P + K, temperature=1.0, seed=0,
                        block_size=PAGED_BLOCK)
    decode_eng = eng.engine.decode
    at_tick = []
    inner = decode_eng.tick_block

    def tick_block(k, generator=None):
        at_tick.append(decode_eng.pool.blocks_in_use)  # capacity for k ticks allocated
        return inner(k, generator)

    decode_eng.tick_block = tick_block
    tiled = torch.tensor(np.repeat(np.array(prompts, np.int32), G, axis=0), device="cuda")
    runs, waves = {"generate": [], "serving": []}, []
    for label in ("generate", "serving", "serving", "generate"):
        torch.cuda.synchronize()
        _reset_counts()
        at_tick.clear()
        t0 = time.perf_counter()
        with torch.no_grad():
            if label == "generate":
                toks, lps = decode.generate(params, tiled, config, K, temperature=1.0,
                                            generator=sampling_generator(tiled.device, 0, 1),
                                            with_logprobs=True)
                rows = [(toks[i].tolist(), lps[i].tolist()) for i in range(B * G)]
            else:
                rows = [r for grp in eng.rollout(prompts, G, K) for r in grp]
        torch.cuda.synchronize()
        runs[label].append(dict(s=time.perf_counter() - t0, launches=flash_attention.launches,
                                blocks=max(at_tick, default=0)))
        if label == "serving":
            waves.append((rows, eng.stats()))
    worst = 0.0
    for rows, _ in waves:
        full = torch.tensor([prompts[i // G] + rows[i][0] for i in range(B * G)],
                            dtype=torch.int32, device="cuda")
        with torch.no_grad():
            (grid, _), _ = sequence_logprobs(
                params, full, torch.full((B * G,), P, device="cuda"),
                torch.full((B * G,), P + K, device="cuda"), config, with_aux=True,
                per_token=True)
        lp = torch.tensor([r[1] for r in rows], device="cuda")
        worst = max(worst, (grid[:, P - 1:P - 1 + K].float() - lp).abs().max().item())
        if any(len(r[0]) != K for r in rows):
            raise AssertionError("17b: a completion is not K tokens long")
    per_req = -(-(P + K) // PAGED_BLOCK)
    cold_want = 1 + B * G * per_req
    indexed = B * (P // PAGED_BLOCK)
    matched = (P - 1) // PAGED_BLOCK
    warm_want = 1 + indexed + B * G * (per_req - matched)
    cold, warm = (r["blocks"] for r in runs["serving"])
    hits = waves[1][1]["prefix_hit_tokens"] - waves[0][1]["prefix_hit_tokens"]
    launches = runs["serving"][0]["launches"]
    gen_s = [r["s"] for r in runs["generate"]]
    srv_s = [r["s"] for r in runs["serving"]]
    print(f"17b rollout [{smi}]: gemma-2-2b (d 256, {config.n_layers} of "
          f"{GEMMA2_2B['num_hidden_layers']} layers) RolloutEngine, {B} prompts of {P} x G {G} "
          f"x {K} new tokens ({B * G} slots, block {PAGED_BLOCK}), turns generate/serving/"
          f"serving/generate: rollout s serving {', '.join(f'{x:.2f}' for x in srv_s)} "
          f"(cold, warm) against decode.generate {', '.join(f'{x:.2f}' for x in gen_s)}; "
          f"behavior logprobs against teacher-forced sequence_logprobs max |diff| "
          f"{worst:.4f} (limit {LP_TOL}); pool blocks in use at the tick cold {cold} "
          f"(G prompt caches: {cold_want}), warm {warm} (one prompt's blocks a group + the "
          f"tails: {warm_want}), warm prefix hits {hits} tokens; Fwd<256> launches a wave "
          f"{launches} (decode.generate {runs['generate'][0]['launches']})", flush=True)
    if worst > LP_TOL:
        raise AssertionError(f"17b: behavior logprobs {worst} from the teacher-forced ones")
    if (cold, warm) != (cold_want, warm_want) or hits != B * G * matched * PAGED_BLOCK:
        raise AssertionError(f"17b: pool blocks cold {cold} warm {warm} (expected "
                             f"{cold_want}, {warm_want}), warm hits {hits}")
    if launches != config.n_layers:  # one wave prefill of the B*G rows
        raise AssertionError(f"17b: Fwd<256> launched {launches} times in a cold wave")
    del eng, decode_eng, params
    return dict(serving_s=srv_s, generate_s=gen_s, lp_max_diff=worst, blocks_cold=cold,
                blocks_warm=warm, warm_hit_tokens=hits, launches=launches,
                warm_launches=runs["serving"][1]["launches"])


# 17a and 17c serve Llama-7B at 8 of its 32 layers (full depth until phase 22
# came, which the cut pays for): the plane's host-side work a tick and a
# handoff is per layer, as the paths' checks are
DISAGG_LAYERS = 8


def phase_disagg(smi, rollout, d_pods=None):
    """17: a) the facade on Llama-7B against the monolithic engine, and the
    paged pool's concurrency; c) the router across pods over loopback
    sockets with a drain; d) rl_pod over sockets with the serving engine,
    unless `d_pods` holds its numbers (run in phase 16, beside phase 23).
    (b), the rollout at d 256, ran inside phase 15 on its directory."""
    out = {"b_rollout": rollout}
    out["a_facade"], params, config, every, want = _phase("17a", _17a_facade, smi)
    out["c_router"] = _phase("17c", _17c_router, params, config, every, want, smi)
    del params
    _free("17a-c")
    out["d_pods"] = d_pods or _phase("17d", _16c_pods, smi, "socket")
    return out


# -- phase 18: the one-card workload programs (ViT-B/16, the sparse CTR
# model, MNIST) ---------------------------------------------------------------

VIT_BATCH, VIT_STEPS = 128, 10
SPARSE_ARGS = ["--batch", "4096", "--hidden", "512"]
SPARSE_STEPS, SPARSE_CHECK_SCALE, SPARSE_CHECK_STEPS = 20, 100, 5
# card against CPU, same seed and batch: each loss's relative difference.
# The deep tower and the MLP compute in bf16, where cuBLAS and the CPU's
# GEMMs sum in other orders and one product may round one bf16 step (2^-8)
# apart; Adam or Adagrad then carries that along the run (225 MNIST steps,
# 6 sparse ones).
SPARSE_LOSS_TOL, MNIST_LOSS_TOL = 1e-2, 5e-2
MNIST_ARGS = ["--steps", "200", "--batch", "256"]


def _profile_step(tag, step, warm=2):
    """One call of step() under torch.profiler after `warm` calls: device
    busy time, idle share and time by kind (`_kernel_profile`)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, f"profile-{tag}.json")
    prof.export_chrome_trace(path)
    out = _kernel_profile(path, wall_ms)
    os.remove(path)
    share = "not measured" if out["idle_share"] is None else f"{out['idle_share']:.3f}"
    print(f"profile {tag} step: wall {wall_ms:.2f} ms (profiled), device busy "
          f"{out['device_busy_ms']:.2f} ms, idle share {share}, {out['kernels']} kernels; "
          "by kind: " + "; ".join(f"{k} {ms:.2f} ms" for k, ms in out["groups"].items())
          + "; top: " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in out["top"]), flush=True)
    return out


def _line_numbers(text, keys):
    """{key: float} of the last printed line holding `key=`."""
    line = [ln for ln in text.splitlines() if f"{keys[0]}=" in ln][-1]
    return {k: float(re.search(rf"\b{re.escape(k)}=(\S+)", line).group(1)) for k in keys}


def _18a_vit(smi):
    """ViT-B/16 at full width and depth (bf16): a forward and one step's
    gradients through the non-causal kernels against use_flash=False on
    one tree and batch, with the launch counts; then the vision program."""
    from kubedl_tpu_torch.models import llama, vit
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.train import vision

    cfg = vit.ViTConfig.base()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = vit.init(cfg, gen, device="cuda")
    images = torch.rand((VIT_BATCH, cfg.image_size, cfg.image_size, cfg.n_channels),
                        generator=gen, device="cuda")
    labels = torch.randint(0, cfg.n_classes, (VIT_BATCH,), generator=gen, device="cuda")
    n = cfg.n_layers
    out = {}
    for label, c in (("kernel", cfg), ("plain", dataclasses.replace(cfg, use_flash=False))):
        _reset_counts()
        with torch.no_grad():
            logits = vit.forward(params, images, c)
        fwd_counts = _counts()
        tree = llama.tree_map(lambda x: x.detach().requires_grad_(True), params)
        _reset_counts()
        loss = vit.loss_fn(tree, (images, labels), c)
        grads = torch.autograd.grad(loss, list(llama.tree_leaves(tree)))
        torch.cuda.synchronize()
        out[label] = (logits, loss.item(), grads, fwd_counts, _counts())
        del tree, loss
    (lk, sk, gk, fk, ck), (lp, sp, gp, fp, cp) = out["kernel"], out["plain"]
    del out
    if fk != (n, 0, 0) or ck != (n, n, n) or fp != (0, 0, 0) or cp != (0, 0, 0):
        raise AssertionError(f"18a ViT launches (fwd, dq, dkv): forward {fk}, step {ck} "
                             f"(expected {(n, 0, 0)} and {(n, n, n)}); plain {fp}, {cp}")
    finite = bool(torch.isfinite(lk).all()) and all(bool(torch.isfinite(g.float()).all())
                                                    for g in gk)
    logit_rel = _rel(lk, lp)
    errs = {}
    for nm, a, b in zip(_leaf_names(params), gk, gp):
        if a.dtype != b.dtype:
            raise AssertionError(f"18a gradient {nm}: dtype {a.dtype} vs {b.dtype}")
        errs[nm] = _rel(a, b)
    worst = max(errs, key=errs.get)
    n_params = vit.param_count(params)
    del lp, gp
    loss_rel = abs(sk - sp) / abs(sp)
    print(f"18a vit-b16: b={VIT_BATCH} S={cfg.n_patches + 1} d_head {cfg.head_dim}, "
          f"{n} layers: logits rel {logit_rel:.3e} (tol {LOGIT_TOL}); loss kernel {sk:.6f} "
          f"plain {sp:.6f} (rel {loss_rel:.2e}); worst gradient {worst} rel "
          f"{errs[worst]:.3e} over {len(errs)} leaves (tol {GRAD_TOL}); launches fwd/dq/dkv "
          f"forward {fk} step {ck}", flush=True)
    if not finite or logit_rel > LOGIT_TOL or loss_rel > 1e-2 or errs[worst] > GRAD_TOL:
        raise AssertionError("18a: ViT-B/16 through the non-causal kernels disagrees with "
                             "plain attention")
    del lk, gk
    init_state, train_step = make_train_step(lambda p, b: vit.loss_fn(p, b, cfg),
                                             optim.adamw(1e-3, weight_decay=1e-4))
    state = init_state(params)
    prof = _profile_step("vit_b16", lambda: train_step(state, (images, labels)))
    del state, params, images, labels
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    argv = ["--model", "vit-b16", "--batch", str(VIT_BATCH), "--steps", str(VIT_STEPS)]
    with _captured() as tee:
        rc = vision.main(argv)
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got = _line_numbers(tee.text(), ["steps", "loss", "step/sec", "img/sec", "params"])
    want = tuple([(VIT_STEPS + 1) * n] * 3)  # the warm-up step and the timed ones
    if rc != 0 or counts != want or not math.isfinite(got["loss"]) or \
            got["params"] != n_params:
        raise AssertionError(f"18a vision: rc {rc}, launches {counts} (expected {want}), "
                             f"{got}")
    step_ms = 1e3 / got["step/sec"]
    print(f"18a vision --model vit-b16 --batch {VIT_BATCH} --steps {VIT_STEPS}: step "
          f"{step_ms:.2f} ms, {got['img/sec']:.0f} img/s, loss {got['loss']:.4f}, peak "
          f"allocated {peak_gb:.2f} GB, launches fwd/dq/dkv {counts} [{smi}]", flush=True)
    return dict(logit_rel=logit_rel, loss_kernel=sk, loss_plain=sp, grad_rel_err=errs,
                launches_step=list(ck), launches_forward=list(fk), step_ms=step_ms,
                img_s=got["img/sec"], loss=got["loss"], peak_gb=peak_gb,
                launches=list(counts), argv=argv, profile=prof)


def _18b_sparse(smi):
    """train.sparse at the full FEATURE_DEFS vocabularies, then a
    --vocab-scale run on the card against the same run on the CPU."""
    from kubedl_tpu_torch.train import coordinator, sparse

    torch.cuda.reset_peak_memory_stats()
    argv = SPARSE_ARGS + ["--steps", str(SPARSE_STEPS)]
    with _captured() as tee:
        rc = sparse.main(argv)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    got = _line_numbers(tee.text(), ["steps", "batch", "loss", "step/sec", "lookups/sec"])
    if rc != 0 or not math.isfinite(got["loss"]):
        raise AssertionError(f"18b sparse: rc {rc}, {got}")
    rows = sum(v for _, v, _, _, _ in sparse.FEATURE_DEFS)
    info = coordinator.process_info()
    axes, refused = sparse._mesh_axes(info)
    if refused:
        raise AssertionError(refused)
    args = sparse.parse_args(argv)
    features = sparse.features_for()
    init_state, train_step = sparse.make_step(features, args.lr)
    dev = torch.device("cuda")
    state = init_state(sparse.init_params(features, args.hidden, device=dev))
    ids, labels = sparse.draw_batch(np.random.default_rng(0), features, args.batch)
    batch = ({k: torch.from_numpy(v).to(dev) for k, v in ids.items()},
             torch.from_numpy(labels).to(dev))
    prof = _profile_step("sparse", lambda: train_step(state, batch))
    del state, batch
    args = sparse.parse_args(SPARSE_ARGS + ["--steps", str(SPARSE_CHECK_STEPS),
                                            "--vocab-scale", str(SPARSE_CHECK_SCALE)])
    card = sparse.run(args, info, axes, torch.device("cuda"))["losses"]
    cpu = sparse.run(args, info, axes, torch.device("cpu"))["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    step_ms = 1e3 / got["step/sec"]
    print(f"18b sparse {' '.join(argv)}: {rows} table rows, step {step_ms:.3f} ms, "
          f"{got['lookups/sec']:.3g} lookups/s, loss {got['loss']:.4f}, peak allocated "
          f"{peak_gb:.2f} GB; --vocab-scale {SPARSE_CHECK_SCALE}: losses card "
          f"{', '.join(f'{x:.6f}' for x in card)} against CPU "
          f"{', '.join(f'{x:.6f}' for x in cpu)} (max rel {loss_rel:.2e}, tol "
          f"{SPARSE_LOSS_TOL}) [{smi}]", flush=True)
    if loss_rel > SPARSE_LOSS_TOL or not all(math.isfinite(x) for x in card):
        raise AssertionError("18b: the sparse model on the card disagrees with the CPU run")
    return dict(step_ms=step_ms, lookups_s=got["lookups/sec"], loss=got["loss"],
                peak_gb=peak_gb, table_rows=rows, losses_card=card, losses_cpu=cpu,
                loss_rel=loss_rel, argv=argv, profile=prof)


def _18c_mnist(smi):
    """train.mnist as BASELINE.json's metric names it (step/s), its losses
    on the card against the same run on the CPU."""
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.train import mnist

    with _captured() as tee:
        rc = mnist.main(MNIST_ARGS)
    got = _line_numbers(tee.text(), ["steps", "loss", "step/sec"])
    if rc != 0 or not math.isfinite(got["loss"]):
        raise AssertionError(f"18c mnist: rc {rc}, {got}")
    args = mnist.parse_args(MNIST_ARGS)
    init_state, train_step = make_train_step(mnist.loss_fn, optim.adam(args.lr))
    dev = torch.device("cuda")
    state = init_state(mnist.init_params(args.hidden, device=dev))
    xs, ys = mnist.draw_batches(np.random.default_rng(0), 1, args.batch)
    batch = (torch.from_numpy(xs[0]).to(dev), torch.from_numpy(ys[0]).to(dev))
    prof = _profile_step("mnist", lambda: train_step(state, batch))
    del state, batch
    card = mnist.run(args, 0, dev)
    cpu = mnist.run(args, 0, torch.device("cpu"))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    print(f"18c mnist {' '.join(MNIST_ARGS)}: {got['step/sec']:.1f} step/s (again "
          f"{card['steps'] / card['seconds']:.1f}), loss {got['loss']:.4f}; "
          f"{len(card['losses'])} losses card against CPU: final {card['losses'][-1]:.6f} / "
          f"{cpu['losses'][-1]:.6f}, max rel {loss_rel:.2e} (tol {MNIST_LOSS_TOL}); CPU "
          f"{cpu['steps'] / cpu['seconds']:.1f} step/s [{smi}]", flush=True)
    if loss_rel > MNIST_LOSS_TOL:
        raise AssertionError("18c: MNIST on the card disagrees with the CPU run")
    return dict(step_s=got["step/sec"], step_s_again=card["steps"] / card["seconds"],
                loss=got["loss"], final_card=card["losses"][-1], final_cpu=cpu["losses"][-1],
                loss_rel=loss_rel, cpu_step_s=cpu["steps"] / cpu["seconds"], argv=MNIST_ARGS,
                profile=prof)


def phase_workloads(smi):
    """18: a) ViT-B/16 through the non-causal flash kernels; b) the sparse
    CTR model at its full vocabularies; c) MNIST."""
    out = {"a_vit": _phase("18a", _18a_vit, smi)}
    _free("18a")
    out["b_sparse"] = _phase("18b", _18b_sparse, smi)
    _free("18b")
    out["c_mnist"] = _phase("18c", _18c_mnist, smi)
    return out


# -- phase 19: pipeline parallelism -- the MPMD stage programs on one card ------

PP_MICRO = 4              # microbatches of a step (19a, 19b): b 4 -> 4 x b 1
PP_BATCH, PP_SEQ, PP_STEPS = 4, 1024, 6


def _pp_launches(n_layers, n_stages, n_micro, steps=1):
    """(K1, K2, K3) launches of the 1F1B stage programs under full remat.
    A stage that is not last runs each microbatch's forward without
    autograd (L_s K1), then its backward recomputes the forward under
    autograd with every layer checkpointed (L_s K1) and each layer's
    backward recomputes that layer (L_s K1) before its dq and dkv (L_s K2,
    L_s K3): 3 L_s K1. The last stage runs the forward under autograd (L_s
    K1) and the backward (L_s K1 again, L_s K2, L_s K3): 2 L_s K1. So a
    step makes M * L_s * (3 (S-1) + 2) K1 and M * L K2 and K3."""
    per = n_layers // n_stages
    k1 = n_micro * per * (3 * (n_stages - 1) + 2)
    return (steps * k1, steps * n_micro * n_layers, steps * n_micro * n_layers)


def _pp_grad_errs(got_tree, want_tree):
    """{leaf name: max|got - want| / max|want|} over two trees of one shape."""
    from kubedl_tpu_torch.models import llama

    names = _leaf_names(want_tree)
    out = {}
    for nm, a, b in zip(names, llama.tree_leaves(got_tree), llama.tree_leaves(want_tree)):
        if not bool(torch.isfinite(a.float()).all()):
            raise AssertionError(f"19a gradient {nm} not finite")
        out[nm] = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
    return out


def _19a_mpmd(smi):
    """The in-process MPMD pipeline (two stage programs on QueueChannels,
    each on its thread) at Llama-7B widths, 4 layers, against loss_fn on
    the same parameters over the same four microbatches; then stage 0 on a
    zeroed received gradient, a fault the gradient check must see."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.pipeline_mpmd import split_stage_params
    from kubedl_tpu_torch.train.pipeline_runtime import MPMDPipeline

    n_layers, n_stages = 4, 2
    config = dataclasses.replace(llama.LlamaConfig.llama_7b(), n_layers=n_layers)
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.randint(0, config.vocab_size, (PP_BATCH, PP_SEQ), device="cuda",
                           dtype=torch.int32,
                           generator=torch.Generator(device="cuda").manual_seed(11))
    mb = PP_BATCH // PP_MICRO
    tree = llama.tree_map(lambda x: x.detach().requires_grad_(True), params)
    leaves = list(llama.tree_leaves(tree))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = sum(llama.loss_fn(tree, tokens[i * mb:(i + 1) * mb], config)
               for i in range(PP_MICRO)) / PP_MICRO
    it = iter(torch.autograd.grad(loss, leaves))
    want = llama.tree_map(lambda _: next(it), tree)
    loss_ref = loss.item()
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    del loss, tree, leaves
    mp = MPMDPipeline(config, params, optim.sgd(0.0), n_stages=n_stages,
                      n_microbatches=PP_MICRO)
    try:
        _reset_counts()
        t0 = time.perf_counter()
        out = mp.step(tokens)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        expected = _pp_launches(n_layers, n_stages, PP_MICRO)
        errs = {}
        for s in range(n_stages):
            ref = split_stage_params(want, mp.plan, s)
            errs.update({f"stage{s}.{k}": v
                         for k, v in _pp_grad_errs(mp.stages[s].last_grads, ref).items()})
        worst = max(errs, key=errs.get)
        loss_rel = abs(out["loss"] - loss_ref) / abs(loss_ref)
        # planted fault: stage 0's backward on a zeroed received gradient
        st0 = mp.stages[0]
        real = st0._recv_grad
        st0._recv_grad = lambda step, i: torch.zeros_like(real(step, i))
        mp.step(tokens)
        st0._recv_grad = real
        fault = max(_pp_grad_errs(st0.last_grads, split_stage_params(want, mp.plan, 0)).values())
    finally:
        mp.close()
    print(f"19a MPMD [{smi}]: llama-7b width, {n_layers} layers over {n_stages} stage programs "
          f"(QueueChannels, one thread each), b {PP_BATCH} x {PP_SEQ}, M {PP_MICRO}, bf16: loss "
          f"{out['loss']:.6f} against loss_fn's {loss_ref:.6f} (rel {loss_rel:.2e}, tol 1e-2); "
          f"worst gradient {worst} rel {errs[worst]:.3e} over {len(errs)} leaves (tol "
          f"{GRAD_TOL}); launches fwd/dq/dkv {counts} (expected {expected}); step {step_ms:.1f} "
          f"ms (first), one-program forward+backward {ref_ms:.1f} ms; {out['serialized_bytes'] / 1e6:.1f} "
          f"MB serialized; planted fault (stage 0 on a zeroed gradient) reads "
          f"{fault / GRAD_TOL:.1f}x the tolerance", flush=True)
    if loss_rel > 1e-2 or errs[worst] > GRAD_TOL:
        raise AssertionError("19a: the MPMD stages disagree with the one-program loss_fn")
    if counts != expected:
        raise AssertionError(f"19a launches (fwd, dq, dkv) {counts}, expected {expected}")
    if fault <= 10 * GRAD_TOL:
        raise AssertionError(f"19a cannot see the planted fault: {fault:.3e}")
    del params, want, mp
    return dict(loss=out["loss"], loss_ref=loss_ref, loss_rel=loss_rel, grad_rel_err=errs,
                launches=list(counts), step_ms=step_ms, ref_ms=ref_ms,
                fault_over_tol=fault / GRAD_TOL, serialized_mb=out["serialized_bytes"] / 1e6)


def _pp_env(**kw):
    root = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                KUBEDL_PP_STAGES="2", KUBEDL_PP_MICROBATCHES=str(PP_MICRO), **kw)


def _pp_run(envs, argv, tag, timeout=600, stop_after=None):
    """The two stage processes (`pipeline_trainer`), output to files under
    WORK; with `stop_after` (a line the last stage prints), both are
    SIGTERMed once it appears. Returns (rcs, outputs, seconds from the
    start to each stage's plan line (its set-up done), to the last stage's
    first step line, to the SIGTERM (None without one) and to each exit)."""
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(WORK, exist_ok=True)
    logs = [os.path.join(WORK, f"{tag}-stage{s}.log") for s in range(2)]
    cmd = [sys.executable, "-m", "kubedl_tpu_torch.train.pipeline_trainer"] + argv
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=root, env=env, stdout=open(log, "w"),
                              stderr=subprocess.STDOUT) for env, log in zip(envs, logs)]
    term_s, exit_s, ready_s, first_s = None, [None, None], [None, None], None

    def watch():
        nonlocal first_s
        now = time.perf_counter() - t0
        texts = [open(x).read() for x in logs]
        for s in range(2):
            if ready_s[s] is None and f"stage {s}/2:" in texts[s]:
                ready_s[s] = now
            if exit_s[s] is None and procs[s].poll() is not None:
                exit_s[s] = now
        if first_s is None and "step 0:" in texts[1]:
            first_s = now
        return texts

    try:
        deadline = time.monotonic() + timeout
        if stop_after is not None:
            while stop_after not in watch()[1]:
                if time.monotonic() > deadline or any(p.poll() is not None for p in procs):
                    raise AssertionError(f"{tag}: no {stop_after!r} before the stages ended:\n"
                                         + "\n".join(open(x).read()[-1500:] for x in logs))
                time.sleep(0.02)
            term_s = time.perf_counter() - t0
            for p in procs:
                p.send_signal(signal.SIGTERM)
        while any(s is None for s in exit_s) and time.monotonic() < deadline:
            watch()
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [open(x).read() for x in logs]
    return [p.returncode for p in procs], outs, dict(ready_s=ready_s, first_step_s=first_s,
                                                     term_s=term_s, exit_s=exit_s)


def _19b_stage_trainers(smi):
    """Two pipeline_trainer processes on the card over DirChannel, Llama-7B
    at full depth (16 layers a stage), then the one-process trainer at the
    same depth and batch, one turn each."""
    from kubedl_tpu_torch.models import llama

    config = llama.LlamaConfig.llama_7b()
    bdir, trace = os.path.join(WORK, "pp-boundary"), os.path.join(WORK, "trace-pp")
    for d in (bdir, trace):
        shutil.rmtree(d, ignore_errors=True)
    envs = [_pp_env(KUBEDL_PP_STAGE=str(s), KUBEDL_PP_BOUNDARY_DIR=bdir,
                    KUBEDL_TRACE_DIR=trace, POD_NAME=f"pp-stage-{s}") for s in range(2)]
    t0 = time.perf_counter()
    rcs, outs, times = _pp_run(envs, ["--model", "llama-7b", "--batch", str(PP_BATCH),
                                  "--seq-len", str(PP_SEQ), "--steps", str(PP_STEPS),
                                  "--log-every", "1"], "pp-7b")
    wall_s = time.perf_counter() - t0
    if rcs != [0, 0]:
        raise AssertionError(f"19b stage trainers exit {rcs}:\n"
                             + "\n".join(o[-3000:] for o in outs))
    losses = [float(x) for x in re.findall(r"step \d+: loss=([0-9.naif-]+)", outs[1])]
    if len(losses) != PP_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"19b losses {losses}")
    if abs(losses[0] - math.log(config.vocab_size)) > 1.5:
        raise AssertionError(f"19b first loss {losses[0]} not within 1.5 of ln 32000")
    peaks, launches = [], [0, 0, 0]
    for s, o in enumerate(outs):
        m = re.search(r"stage \d: memory: peak allocated ([0-9.]+) GB; flash launches "
                      r"fwd/dq/dkv \((\d+), (\d+), (\d+)\)", o)
        peaks.append(float(m.group(1)))
        launches = [a + int(b) for a, b in zip(launches, m.groups()[1:])]
    expected = _pp_launches(config.n_layers, 2, PP_MICRO, PP_STEPS)
    if tuple(launches) != expected:
        raise AssertionError(f"19b launches (fwd, dq, dkv) {launches}, expected {expected}")
    spans = [sp for sp in _trace_spans(trace) if sp["name"] in ("train.compile", "pipeline.step")]
    step_ms, wait_ms, msg_mb, send_mb_s = {}, {}, {}, {}
    for s in range(2):
        mine = sorted((sp for sp in spans if sp["attrs"].get("stage") == s),
                      key=lambda sp: sp["attrs"]["step"])
        if len(mine) != PP_STEPS:
            raise AssertionError(f"19b stage {s}: {len(mine)} step spans of {PP_STEPS}")
        step_ms[s] = statistics.median(sp["dur"] for sp in mine[1:]) * 1e3
        wait_ms[s] = statistics.median(sp["attrs"]["wait_s"] for sp in mine[1:]) * 1e3
        # the stage's own boundary counters over steps 2-6: the bytes it sent
        # (M messages a step) and its sender thread's seconds in DirChannel's
        # write + fsync, which overlap the compute
        a, b = mine[0]["attrs"], mine[-1]["attrs"]
        sent = b["sent_bytes"] - a["sent_bytes"]
        msg_mb[s] = sent / ((PP_STEPS - 1) * PP_MICRO) / 1e6
        send_mb_s[s] = sent / (b["send_s"] - a["send_s"]) / 1e6
    # the one-process trainer at the same depth, batch and optimizer (no clip)
    torch.cuda.reset_peak_memory_stats()
    rc, one, _ = _run_trainer(["--model", "llama-7b", "--batch", str(PP_BATCH), "--seq-len",
                               str(PP_SEQ), "--steps", "3", "--log-every", "1"], "pp-1proc")
    if rc != 0 or len(one) != 3:
        raise AssertionError(f"19b one-process trainer rc={rc}, {len(one)} step spans")
    one_ms = statistics.median(sp["dur"] for sp in one[1:]) * 1e3
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = PP_BATCH * (PP_SEQ - 1)
    pp_ms = max(step_ms.values())
    print(f"19b stage trainers [{smi}]: llama-7b, 32 layers, 16 a stage, two processes on one "
          f"card over DirChannel, b {PP_BATCH} x {PP_SEQ}, M {PP_MICRO}, {PP_STEPS} steps in "
          f"{wall_s:.1f} s (start-up included); losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"step {step_ms[0]:.1f} / {step_ms[1]:.1f} ms (stage 0 / 1, median of steps 2-"
          f"{PP_STEPS}), {tokens / pp_ms * 1e3:.0f} tok/s; wait {wait_ms[0]:.1f} / "
          f"{wait_ms[1]:.1f} ms a step; boundary {msg_mb[0]:.2f} / {msg_mb[1]:.2f} MB a "
          f"message, sent at {send_mb_s[0]:.0f} / {send_mb_s[1]:.0f} MB/s (the sender "
          f"threads' DirChannel write + fsync, steps 2-{PP_STEPS}); "
          f"peak allocated {peaks[0]:.2f} + {peaks[1]:.2f} GB; launches fwd/dq/dkv "
          f"{tuple(launches)} (expected {expected}); set-up done at {times['ready_s'][0]:.1f} / "
          f"{times['ready_s'][1]:.1f} s, first step line at {times['first_step_s']:.1f} s; "
          f"one-process trainer at the same depth "
          f"in turn: step {one_ms:.1f} ms, peak {one_peak:.2f} GB (ratio pipeline / one "
          f"process {pp_ms / one_ms:.3f})", flush=True)
    shutil.rmtree(bdir, ignore_errors=True)
    boundary = dict(mb_per_msg=[msg_mb[0], msg_mb[1]], send_mb_s=[send_mb_s[0], send_mb_s[1]])
    return dict(losses=losses, step_ms=[step_ms[0], step_ms[1]],
                wait_ms=[wait_ms[0], wait_ms[1]], boundary=boundary, peak_gb=peaks,
                launches=launches, one_process_step_ms=one_ms, one_process_peak_gb=one_peak,
                ratio=pp_ms / one_ms, tok_s=tokens / pp_ms * 1e3, wall_s=wall_s, times=times)


def _19c_socket_preemption(smi):
    """Two tiny stage processes over the socket plane on 127.0.0.1,
    SIGTERMed mid-run: both exit 113 with a checkpoint at the same step;
    the rerun restores it on both and exits 0."""
    ckpt = os.path.join(WORK, "ckpt-pp-socket")
    shutil.rmtree(ckpt, ignore_errors=True)

    def envs():
        ports = [_free_port(), _free_port()]
        base = dict(KUBEDL_TRANSPORT="socket", KUBEDL_TRANSPORT_TOKEN="chip-smoke-pp")
        return [_pp_env(KUBEDL_PP_STAGE="0", KUBEDL_TRANSPORT_BIND=f"127.0.0.1:{ports[0]}",
                        KUBEDL_PP_NEXT_ADDR=f"127.0.0.1:{ports[1]}", **base),
                _pp_env(KUBEDL_PP_STAGE="1", KUBEDL_TRANSPORT_BIND=f"127.0.0.1:{ports[1]}",
                        KUBEDL_PP_PREV_ADDR=f"127.0.0.1:{ports[0]}", **base)]

    argv = ["--model", "tiny", "--batch", "8", "--seq-len", "128", "--log-every", "1",
            "--checkpoint-path", ckpt]
    rcs, outs, first = _pp_run(envs(), argv + ["--steps", "100000"], "pp-sigterm",
                               timeout=300, stop_after="step 1:")
    saved = [re.findall(r"stage \d: saved final checkpoint at step (\d+)", o) for o in outs]
    if rcs != [113, 113] or len(saved[0]) != 1 or saved[0] != saved[1]:
        raise AssertionError(f"19c SIGTERM: exits {rcs} (expected 113, 113), saved {saved}:\n"
                             + "\n".join(o[-2000:] for o in outs))
    at = int(saved[0][0])
    rcs, outs, second = _pp_run(envs(), argv + ["--steps", str(at + 1)], "pp-resume",
                                timeout=300)
    restored = all(f"stage {s}: restored gang-common checkpoint at step {at}" in outs[s]
                   and f"stage {s}: done at step {at + 1}" in outs[s] for s in range(2))
    if rcs != [0, 0] or not restored:
        raise AssertionError(f"19c resume: exits {rcs}, restored {restored}:\n"
                             + "\n".join(o[-2000:] for o in outs))
    print(f"19c socket preemption [{smi}]: two tiny stage processes over the socket plane on "
          f"127.0.0.1 SIGTERMed, both exit 113 with a checkpoint at step {at}; the rerun "
          f"restored step {at} on both, exit 0 at step {at + 1}; set-up done at "
          f"{first['ready_s'][0]:.1f} / {first['ready_s'][1]:.1f} s, first step line at "
          f"{first['first_step_s']:.1f} s, SIGTERM at "
          f"{first['term_s']:.1f} s, exits at {first['exit_s'][0]:.1f} / "
          f"{first['exit_s'][1]:.1f} s; the rerun's exits at {second['exit_s'][0]:.1f} / "
          f"{second['exit_s'][1]:.1f} s", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return dict(preempted_at=at, first=first, second=second)


def phase_pipeline(smi):
    """19: the MPMD pipeline -- (a) in process at Llama-7B widths against
    loss_fn, (b) two stage processes at full depth beside the one-process
    trainer, (c) preemption over the socket plane. The SPMD stage axis
    above 1 needs a group of several cards: the CPU gloo gang holds it."""
    out = {"a_mpmd": _phase("19a", _19a_mpmd, smi)}
    _free("19a")
    out["b_trainers"] = _phase("19b", _19b_stage_trainers, smi)
    _free("19b")
    print("19: the SPMD stage axis above 1 (parallel/pipeline.py) is not run here: one card "
          "cannot form a group of two stage ranks; tests/test_torch_pipeline_spmd.py holds it "
          "against JAX on a CPU gloo gang of 8", flush=True)
    return out


CTX_SEQ, CTX_LAYERS = 4096, 2  # 20a: Llama-7B's max_seq_len, 2,048 positions a rank
CTX_STRATEGIES = ("ring", "ulysses")


class _ZeroOffset:
    """A mesh whose ranks all say they hold context block 0 (the planted
    fault of 20a): RoPE and the ring's masks read offset 0 on every rank,
    while the collectives still run over the real groups."""

    def __init__(self, mesh):
        self._mesh = mesh

    def __getattr__(self, name):
        return getattr(self._mesh, name)

    def get_local_rank(self, mesh_dim=None):
        return 0 if mesh_dim == "context" else self._mesh.get_local_rank(mesh_dim)


def _ctx_expected_staged(strategy, config, b, t_loc, n=2):
    """Bytes a rank stages through the host in one value-and-grad step, by
    the hops: each layer's collectives run in the forward, again in the
    remat recompute and mirrored in the backward, every byte copied out and
    back in; plus the loss's one f32 all-reduce."""
    blk = b * config.n_heads * t_loc * config.head_dim * 2  # one of q, k, v, o in bf16
    if strategy == "ring":
        fwd = (n - 1) * 2 * (2 * blk)      # n - 1 hops of stacked K and V, out and in
    else:
        fwd = 2 * (3 * blk) + 2 * blk      # q, k, v stacked, then o: out and in
    return config.n_layers * 3 * fwd + 2 * 4


def _context_rank(rank, port, out_path):
    """One rank of 20a's context pair (run as `chip_smoke.py --context-rank
    R --context-port P --context-out PATH`)."""
    import torch.distributed as dist

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import collectives
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh, seq_block

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    backend = dist.get_backend()
    print(f"20a rank {rank}: process group backend {backend}, 2 ranks sharing "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    if backend != "gloo":  # NCCL cannot hold two ranks on one device: no switch
        raise AssertionError(f"20a: backend {backend} with two ranks on one card")
    mesh, rules = build_mesh({"context": 2}, device_type="cuda"), ShardingRules()
    config = dataclasses.replace(llama.LlamaConfig.llama_7b(), n_layers=CTX_LAYERS)
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.randint(0, config.vocab_size, (1, CTX_SEQ + 1), device="cuda",
                           dtype=torch.int32,
                           generator=torch.Generator(device="cuda").manual_seed(4))
    local = seq_block(tokens, mesh, rules)
    names = ("wq", "wk", "w2")

    def value_and_grad(cfg, m, toks):
        tree = llama.tree_map(lambda x: x.detach().requires_grad_(True), params)
        loss = llama.loss_fn(tree, toks, cfg, mesh=m, rules=rules)
        grads = torch.autograd.grad(loss, [tree["layers"][0][n] for n in names])
        torch.cuda.synchronize()
        return loss.item(), grads

    def position_losses(cfg, m, toks):
        """Each position's next-token loss (f32, on the host); with a mesh,
        both ranks' blocks gathered in order."""
        with torch.no_grad():
            logits = llama.forward(params, toks[:, :-1], cfg, mesh=m, rules=rules)
            nll = -torch.log_softmax(logits, -1).gather(-1, toks[:, 1:, None].long())[..., 0]
        nll = nll.float().cpu()
        if m is None:
            return nll
        parts = [torch.empty_like(nll) for _ in range(2)]
        dist.all_gather(parts, nll)
        return torch.cat(parts, dim=1)

    def timed(fn):
        """fn's value and its ms (value_and_grad ends in a synchronize)."""
        t0 = time.perf_counter()
        value = fn()
        return value, (time.perf_counter() - t0) * 1e3

    ref = None
    if rank == 0:  # the one-process loss_fn over the whole sequence, same weights
        value_and_grad(config, None, tokens)  # warm
        (ref_loss, ref_grads), ref_ms = timed(lambda: value_and_grad(config, None, tokens))
        ref = dict(loss=ref_loss, grads=[g.float().cpu() for g in ref_grads],
                   tokens=position_losses(config, None, tokens), ms=ref_ms,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del ref_grads
    out = {}
    for strategy in CTX_STRATEGIES:
        cfg = dataclasses.replace(config, context_parallel=strategy)
        dist.barrier()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        collectives.staged_bytes = 0
        loss, grads = value_and_grad(cfg, mesh, local)
        counts, staged = _counts(), collectives.staged_bytes
        dist.barrier()
        ms = timed(lambda: value_and_grad(cfg, mesh, local))[1]
        peak = torch.cuda.max_memory_allocated() / 1e9
        summed = []
        for g in grads:  # each rank's part of the gradient, summed over the axis
            h = g.float().cpu()
            dist.all_reduce(h)
            summed.append(h)
        del grads
        pos = position_losses(cfg, mesh, local)
        mine = dict(loss=loss, counts=list(counts), staged=staged, ms=ms, peak_gb=peak,
                    expected=_ctx_expected_staged(strategy, config, 1, local.shape[1] - 1))
        ranks = [None, None]
        dist.all_gather_object(ranks, mine)
        if rank == 0:
            errs = {n: ((a - b).norm() / b.norm()).item()
                    for n, a, b in zip(names, summed, ref["grads"])}
            out[strategy] = dict(
                ranks=ranks, loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]),
                position_err=((pos - ref["tokens"]).abs().max()
                              / ref["tokens"].abs().max()).item(), grad_rel=errs)
    # the planted fault: every rank's offset 0 (RoPE positions and ring masks)
    with torch.no_grad():
        fault_loss = llama.loss_fn(params, local, config, mesh=_ZeroOffset(mesh),
                                   rules=rules).item()
    fault_pos = position_losses(config, _ZeroOffset(mesh), local)
    if rank == 0:
        out["fault"] = dict(loss_rel=abs(fault_loss - ref["loss"]) / abs(ref["loss"]),
                            position_err=((fault_pos - ref["tokens"]).abs().max()
                                          / ref["tokens"].abs().max()).item())
        out["reference"] = dict(loss=ref["loss"], ms=ref["ms"], peak_gb=ref["peak_gb"])
        out["backend"] = backend
        with open(out_path, "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _20a_context_pair(smi):
    """Two processes of this script on the card in a gloo group, the
    context axis 2: ring and Ulysses against the one-process loss_fn."""
    os.makedirs(WORK, exist_ok=True)
    out_path = os.path.join(WORK, "context-pair.json")
    logs = [os.path.join(WORK, f"context-rank{r}.log") for r in range(2)]
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--context-rank",
                               str(r), "--context-port", str(port), "--context-out", out_path],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              stdout=open(log, "w"), stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    texts = [open(x).read() for x in logs]
    if [p.returncode for p in procs] != [0, 0]:
        raise AssertionError(f"20a context ranks exit {[p.returncode for p in procs]}:\n"
                             + "\n".join(t[-3000:] for t in texts))
    for t in texts:
        print(t.strip().splitlines()[0], flush=True)  # each rank's backend line
    with open(out_path) as f:
        res = json.load(f)
    want = {"ring": [0, 0, 0], "ulysses": [2 * CTX_LAYERS, CTX_LAYERS, CTX_LAYERS]}
    bad = []
    for st in CTX_STRATEGIES:
        r = res[st]
        for i, rk in enumerate(r["ranks"]):
            print(f"20a {st} rank {i} [{smi}]: step {rk['ms']:.1f} ms (the second step), peak "
                  f"{rk['peak_gb']:.2f} GB, staged through the host {rk['staged']:,} bytes "
                  f"(the hops imply {rk['expected']:,}), launches fwd/dq/dkv "
                  f"{tuple(rk['counts'])} (expected {tuple(want[st])})", flush=True)
            if rk["counts"] != want[st] or rk["staged"] != rk["expected"]:
                bad.append(f"{st} rank {i}")
        print(f"20a {st} [{smi}]: llama-7b widths, {CTX_LAYERS} layers, b 1 x {CTX_SEQ + 1} "
              f"over context 2: loss rel {r['loss_rel']:.2e} (tol 1e-2), position losses "
              f"max rel {r['position_err']:.3e} (tol {LOGIT_TOL}), gradients rel norm "
              + ", ".join(f"{n} {e:.3e}" for n, e in r["grad_rel"].items())
              + f" (tol {GRAD_TOL})", flush=True)
        if r["loss_rel"] > 1e-2 or r["position_err"] > LOGIT_TOL \
                or max(r["grad_rel"].values()) > GRAD_TOL:
            bad.append(f"{st} against the one-process loss_fn")
    fault, ref = res["fault"], res["reference"]
    print(f"20a fault [{smi}]: the ring with every rank's offset 0: loss rel "
          f"{fault['loss_rel']:.2e}, position losses max rel {fault['position_err']:.3e} "
          f"({fault['position_err'] / LOGIT_TOL:.1f}x the bound); one-process reference "
          f"value-and-grad {ref['ms']:.1f} ms, peak {ref['peak_gb']:.2f} GB; pair wall "
          f"{wall_s:.1f} s", flush=True)
    if fault["position_err"] <= LOGIT_TOL:
        bad.append("the planted offset fault passed the position-loss bound")
    if bad:
        raise AssertionError("20a: " + "; ".join(bad))
    return dict(res, wall_s=wall_s,
                launches=[sum(rk["counts"][i] for rk in res["ulysses"]["ranks"])
                          for i in range(3)])


def phase_context(smi):
    """20: the context axis on one card (a gloo pair). Across cards the
    collectives need NCCL over several cards: the CPU gloo gang of
    tests/test_torch_context.py holds the semantics against JAX."""
    out = {"a_pair": _phase("20a", _20a_context_pair, smi)}
    print("20: context parallelism across cards (NCCL) is not run here: one card cannot "
          "form an NCCL group of two ranks", flush=True)
    return out


# -- phase 21: live reshard -- a bench-1b gang resharded 2 -> 1 -> 2 through
# the staging (parallel/reshard.py, train/reshard_runtime.py) ----------------

RESHARD_SEQ = 1024        # --seq-len of every hop: attention at S 1023
RESHARD_ROWS = 2          # rows a rank of the pair takes (21a, 21c)
RESHARD_TRAINER_ROWS = 4  # the trainer's --batch (21b)
RESHARD_TRAINER_STEPS = 4  # 21b's logged steps before the RESIZE is posted
RESHARD_LOSS_TOL = 1e-2   # 21c: the pair's loss against one process's (20a's bound)
# 21 runs bench-1b's widths at 4 of its 16 layers (a cut of depth that pays
# for phase 22): the state the hops stage, hash and restore is a third of
# the whole model's, and the planner's blocks a layer are the same
RESHARD_LAYERS = 4
RESHARD_MODEL = "bench-1b-4l"  # its checkpoint directory under phase 21's work dir


def _reshard_config():
    from kubedl_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.bench_1b(), n_layers=RESHARD_LAYERS)


def _write_reshard_model(path):
    """_reshard_config() as a seeded Llama checkpoint directory, for the
    trainer's --hf-model; raises unless the directory's config.json maps
    back onto the same config."""
    from kubedl_tpu_torch.models.import_hf import config_from_hf

    c = _reshard_config()
    hf = dict(model_type="llama", vocab_size=c.vocab_size, hidden_size=c.d_model,
              intermediate_size=c.d_ff, num_hidden_layers=c.n_layers,
              num_attention_heads=c.n_heads, num_key_value_heads=c.n_kv_heads,
              max_position_embeddings=c.max_seq_len, rope_theta=c.rope_theta,
              rms_norm_eps=c.rms_eps, tie_word_embeddings=c.tie_embeddings,
              torch_dtype="bfloat16")
    if config_from_hf(hf) != c:
        raise AssertionError(f"21: {hf} does not map onto {c}")
    write_hf_checkpoint(path, hf)


def _reshard_batch(config, seed):
    """A global [2 * RESHARD_ROWS, RESHARD_SEQ] batch of seeded tokens."""
    return torch.randint(0, config.vocab_size, (2 * RESHARD_ROWS, RESHARD_SEQ),
                         device="cuda", dtype=torch.int32,
                         generator=torch.Generator(device="cuda").manual_seed(seed))


def _wait_file(path, timeout=900.0):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise AssertionError(f"{path} never appeared")
        time.sleep(0.2)


def _reshard_rank(rank, port, out_dir, staging):
    """One rank of phase 21's pair (run as `chip_smoke.py --reshard-rank R
    --reshard-port P --reshard-out DIR --reshard-dir D`). 21a: two AdamW
    steps on {"data": 2}, the state's sha256, the in-process lane's move
    onto {"fsdp": 2} and the staged lane for 1 chip from those shards; then
    it waits while the trainer (21b) restores, trains and stages for 2. 21c:
    a fresh init_state on the staging's mesh filled through restore_staged
    and state_from_staging, its sha256, the planted faults, one step against
    one process's loss_fn. The steps run on a data mesh: over gloo,
    DTensor's own all-gather of a CUDA shard (Shard -> Replicate, which an
    fsdp step runs for every weight) kills the process with SIGSEGV on the
    card, where gloo's all-reduce, the c10d all-gather and DTensor's
    reduce-scatter run."""
    import torch.distributed as dist

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh, token_index
    from kubedl_tpu_torch.parallel.reshard import PlanError
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.train import reshard_runtime as rt

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    backend = dist.get_backend()
    print(f"21a rank {rank}: process group backend {backend}, 2 ranks sharing "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    if backend != "gloo":  # NCCL cannot hold two ranks on one device: no switch
        raise AssertionError(f"21: backend {backend} with two ranks on one card")
    rules = ShardingRules()
    config = _reshard_config()
    specs = llama.param_specs(config, rules)

    def fresh(axes):
        mesh = build_mesh(axes, device_type="cuda")

        def loss(p, b):
            return llama.loss_fn(p, b, config, mesh=mesh, rules=rules)

        init_state, train_step = make_train_step(
            loss, optim.adamw(3e-4, weight_decay=0.01), mesh, specs,
            rules.spec("batch", None), rules)
        state = init_state(llama.init(config, torch.Generator(device="cuda").manual_seed(0),
                                      device="cuda"))
        tok, n_tok = token_index(mesh, rules)
        each = 2 * RESHARD_ROWS // n_tok
        return mesh, state, train_step, slice(tok * each, (tok + 1) * each)

    def report(name, mine):
        ranks = [None, None]
        dist.all_gather_object(ranks, mine)
        if rank == 0:
            tmp = os.path.join(out_dir, f".{name}.tmp")
            with open(tmp, "w") as f:
                json.dump(dict(ranks=ranks, backend=backend), f)
            os.replace(tmp, os.path.join(out_dir, name))

    # 21a
    mesh, state, train_step, rows = fresh({"data": 2})
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    a = dict(rank=rank, losses=[])
    for i in range(2):
        state, m = train_step(state, _reshard_batch(config, 210 + i)[rows])
        a["losses"].append(m["loss"].item())
    torch.cuda.synchronize()
    a["counts"] = list(_counts())
    a["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    a["digest"] = rt.state_digest(state, specs)
    a["digest_s"] = time.perf_counter() - t0
    # the in-process lane's move onto {"fsdp": 2} over the same ranks
    # (replicated leaves: each rank keeps its chunk, nothing crosses)
    t0 = time.perf_counter()
    mesh = build_mesh({"fsdp": 2}, device_type="cuda")
    state = rt.reshard_state(state, mesh, specs)
    torch.cuda.synchronize()
    a["move_s"] = time.perf_counter() - t0
    a["shard_mb"] = sum(x.to_local().numel() * x.element_size()
                        for x in llama.tree_leaves(state.params)) / 2**20
    # the staged lane for 1 chip, through the trainer's functions
    t0 = time.perf_counter()
    old = rt.mesh_axes(mesh)
    new = rt.refit_axes(old, 1)
    plan = rt.plan_reshard(rt.leaves_from_state(state, specs), old, new, 2, 1)
    rt.stage_shards(staging, plan, rt.mesh_pod(mesh),
                    rt.provider_from_blocks(rt.addressable_blocks(state, specs)), state.step)
    a["stage_s"] = time.perf_counter() - t0
    a["plan"] = dict(moved_mb=plan.moved_bytes / 2**20, local_mb=plan.local_bytes / 2**20,
                     step=state.step)
    dist.barrier()
    if rank == 0:
        t0 = time.perf_counter()
        if not rt.write_manifest(staging, plan, state.step, 2, timeout=60.0):
            raise AssertionError("21a: the manifest was not published")
        a["manifest_s"] = time.perf_counter() - t0
    del state, train_step
    gc.collect()
    torch.cuda.empty_cache()
    report("a.json", a)
    # the trainer runs (21b); then 21c from its staging
    _wait_file(os.path.join(out_dir, "go"))
    dist.barrier()
    staged = rt.restore_staged(staging, rank, 2)
    if staged is None:
        raise AssertionError("21c: the trainer's staging did not validate for 2 pods")
    mesh, state, train_step, rows = fresh(staged[1])
    c = dict(rank=rank, step=staged[0])
    read = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = rt.state_from_staging(staged[2], state, specs, stats=read)
    torch.cuda.synchronize()
    c["restore_s"] = time.perf_counter() - t0
    c["read_mb"] = read["bytes"] / 2**20
    t0 = time.perf_counter()
    c["digest"] = rt.state_digest(state, specs)
    c["digest_s"] = time.perf_counter() - t0
    # the planted faults: one npz member left out of the staging's index
    # (refused before a byte is written), and a marker whose digest changed
    missing = sorted(staged[2].keys())[len(staged[2].keys()) // 2]
    short = rt.StagedBlocks()
    for k in staged[2].keys():
        if k != missing:
            short.add(k, *staged[2]._index[k])
    try:
        rt.state_from_staging(short, state, specs)
        c["fault_coverage"] = "accepted"
    except PlanError as e:
        c["fault_coverage"] = str(e)
    staged[2].close()
    bad = os.path.join(out_dir, f"fault-{rank}")
    os.makedirs(bad)
    for name in os.listdir(staging):
        if name == "manifest.json" or name.startswith("src-"):
            os.symlink(os.path.join(staging, name), os.path.join(bad, name))
    marker = os.path.join(bad, "src-0.json")
    with open(marker) as f:
        info = json.load(f)
    os.remove(marker)
    with open(marker, "w") as f:
        json.dump(dict(info, digest="0" * 64), f)
    c["fault_digest"] = rt.restore_staged(bad, rank, 2) is None
    # one step on a fixed batch against rank 0's one-process loss_fn on the
    # same (replicated) parameters
    batch = _reshard_batch(config, 212)
    if rank == 0:
        with torch.no_grad():
            whole = llama.tree_map(lambda p: p.to_local(), state.params)
            c["ref_loss"] = llama.loss_fn(whole, batch, config).item()
        del whole
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    state, m = train_step(state, batch[rows])
    c["losses"] = [m["loss"].item()]
    torch.cuda.synchronize()
    c["counts"] = list(_counts())
    c["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report("c.json", c)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _digest_line(text, what):
    m = re.search(rf"live reshard: state sha256 {what} at step (\d+): ([0-9a-f]{{64}})", text)
    if m is None:
        raise AssertionError(f"21b: no 'state sha256 {what}' line:\n{text[-3000:]}")
    return int(m.group(1)), m.group(2)


def _21b_trainer(staging, ctl, at0, want_digest, model_dir):
    """The trainer entry point on the card (train/launch.py, one child, a
    one-rank NCCL group): restores 21a's staging, trains, gets RESIZE chips
    2, stages for 2 and exits 113."""
    root = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "kubedl_tpu_torch.train.launch", "--",
            "kubedl_tpu_torch.train.trainer", "--hf-model", model_dir,
            "--batch", str(RESHARD_TRAINER_ROWS), "--seq-len", str(RESHARD_SEQ),
            "--steps", "1000", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
               KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               KUBEDL_NUM_PROCESSES="1", KUBEDL_PROCESS_ID="0", KUBEDL_LIVE_RESHARD="1",
               KUBEDL_RESHARD_DIR=staging, KUBEDL_CONTROL_DIR=ctl, KUBEDL_RESHARD_TEST_DIGEST="1")
    for k in ("KUBEDL_MESH", "KUBEDL_DCN_MESH", "KUBEDL_CHECKPOINT_PATH"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, times = [], {}
    try:
        for line in proc.stdout:
            lines.append(line)
            if "restored live-reshard staging" in line:
                times["restored"] = time.perf_counter() - t0
            if f"step {at0 + RESHARD_TRAINER_STEPS}: loss=" in line and "posted" not in times:
                tmp = os.path.join(ctl, ".msg-0001.tmp")
                with open(tmp, "w") as f:
                    json.dump({"type": "RESIZE", "chips": 2}, f)
                os.replace(tmp, os.path.join(ctl, "msg-0001.json"))
                times["posted"] = time.perf_counter() - t0
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines)
    if proc.returncode != 113 or "launch: rank 0 exited 113" not in text:
        raise AssertionError(f"21b: trainer rc {proc.returncode} (expected 113):\n{text[-3000:]}")
    if f"restored live-reshard staging at step {at0} (mesh " not in text:
        raise AssertionError(f"21b: no restore of step {at0}:\n{text[-3000:]}")
    restored = _digest_line(text, "restored")
    staged_at, staged_digest = _digest_line(text, "staged")
    with open(os.path.join(ctl, "reply-0001.json")) as f:
        reply = json.load(f)
    losses = [float(x) for x in re.findall(r"step \d+: loss=([0-9.naninf]+)", text)]
    read = re.search(r"live reshard: read ([0-9.]+) MB in \d+ blocks in ([0-9.]+) s", text)
    stage = re.search(r"live reshard: staged ([0-9.]+) MB moved and ([0-9.]+) MB local for 2 "
                      r"chips \(mesh [^)]*\) in ([0-9.]+) s, manifest ([0-9.]+) s", text)
    mem = re.search(r"memory: peak allocated ([0-9.]+) GB on .*; flash launches fwd/dq/dkv "
                    r"\((\d+), (\d+), (\d+)\)", text)
    bad = []
    if restored != (at0, want_digest):
        bad.append(f"restored state {restored} is not 21a's {(at0, want_digest)}")
    if reply != {"outcome": "staged", "step": staged_at}:
        bad.append(f"reply {reply}")
    if len(losses) < RESHARD_TRAINER_STEPS or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        bad.append(f"losses {losses} (finite and falling expected)")
    if read is None or stage is None or mem is None:
        bad.append("no read, staged or memory line")
    if bad:
        raise AssertionError("21b: " + "; ".join(bad) + f"\n{text[-3000:]}")
    return dict(wall_s=time.perf_counter() - t0, restored_at_s=times["restored"],
                posted_at_s=times["posted"], step=staged_at, digest=staged_digest,
                losses=losses, read_mb=float(read.group(1)), restore_s=float(read.group(2)),
                moved_mb=float(stage.group(1)), local_mb=float(stage.group(2)),
                stage_s=float(stage.group(3)), manifest_s=float(stage.group(4)),
                peak_gb=float(mem.group(1)), counts=[int(mem.group(i)) for i in (2, 3, 4)])


def _wait_pair(procs, path, logs, timeout=900.0):
    """Wait for `path` from the pair; a rank that dies first fails the phase."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        dead = [p.returncode for p in procs if p.poll() is not None]
        if dead or time.monotonic() > deadline:
            raise AssertionError(f"21 pair exit {[p.poll() for p in procs]} before "
                                 f"{os.path.basename(path)}:\n"
                                 + "\n".join(open(x).read()[-3000:] for x in logs))
        time.sleep(0.2)
    with open(path) as f:
        return json.load(f)


def phase_reshard(smi):
    """21: a bench-1b gang resharded 2 -> 1 -> 2 on one card, through the
    staging: 21a a gloo pair trains on {"data": 2}, moves its state onto
    {"fsdp": 2} in process and stages for 1 chip, 21b the trainer entry
    point restores it on one card, trains and stages for 2 on RESIZE, 21c
    the pair fills a fresh state from that staging. Across cards (NCCL
    gangs) and over the socket fetch the reshard is not run here."""
    work = os.path.join(WORK, "reshard")
    staging, ctl = os.path.join(work, "staging"), os.path.join(work, "ctl")
    model_dir = os.path.join(work, RESHARD_MODEL)
    shutil.rmtree(work, ignore_errors=True)
    for d in (staging, ctl):
        os.makedirs(d)
    _write_reshard_model(model_dir)
    logs = [os.path.join(work, f"rank{r}.log") for r in range(2)]
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--reshard-rank",
                               str(r), "--reshard-port", str(port), "--reshard-out", work,
                               "--reshard-dir", staging],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              stdout=open(log, "w"), stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    try:
        a = _wait_pair(procs, os.path.join(work, "a.json"), logs)
        a_s = time.perf_counter() - t0
        for x in logs:
            print(open(x).read().strip().splitlines()[0], flush=True)  # each backend line
        r0, r1 = a["ranks"]
        at0, digest_a = r0["plan"]["step"], r0["digest"]["*"]
        if a["backend"] != "gloo" or not all(math.isfinite(x) for r in a["ranks"]
                                             for x in r["losses"]):
            raise AssertionError(f"21a: {a}")
        print(f"21a pair [{smi}]: bench-1b ({RESHARD_LAYERS} of 16 layers, d 2048, bf16, full "
              f"remat, AdamW) on "
              f"{{'data': 2}}, 2 steps of b {RESHARD_ROWS} x {RESHARD_SEQ} a rank: losses "
              f"{', '.join(f'{x:.4f}' for x in r0['losses'])}; state sha256 {digest_a[:16]} "
              f"(gathered on the host in {r0['digest_s']:.2f} s); reshard_state onto "
              f"{{'fsdp': 2}} in {r0['move_s']:.2f} / {r1['move_s']:.2f} s "
              f"({r0['shard_mb']:.1f} MB of params a rank); staged for 1 chip at step {at0}: "
              f"{r0['plan']['moved_mb']:.1f} MB moved, {r0['plan']['local_mb']:.1f} MB local; "
              f"stage s {r0['stage_s']:.2f} / {r1['stage_s']:.2f}, manifest s "
              f"{r0['manifest_s']:.2f}; peak {r0['peak_gb']:.2f} / {r1['peak_gb']:.2f} GB; "
              f"launches fwd/dq/dkv {tuple(r0['counts'])} + {tuple(r1['counts'])}; "
              f"{a_s:.1f} s from the pair's start", flush=True)
        print(f"phase 21a: {a_s:.1f} s", flush=True)
        t1 = time.perf_counter()
        b = _21b_trainer(staging, ctl, at0, digest_a, model_dir)
        print(f"21b trainer [{smi}]: trainer --hf-model {RESHARD_MODEL} (bench-1b, "
              f"{RESHARD_LAYERS} of 16 layers) --batch {RESHARD_TRAINER_ROWS} "
              f"--seq-len {RESHARD_SEQ} under train/launch.py (a one-rank NCCL group): "
              f"restored 21a's staging at step {at0} ({b['read_mb']:.1f} MB in "
              f"{b['restore_s']:.2f} s, {b['read_mb'] / b['restore_s']:.0f} MB/s; "
              f"{b['restored_at_s']:.1f} s after the start), the state bit for bit 21a's; "
              f"losses {', '.join(f'{x:.4f}' for x in b['losses'])}; RESIZE chips 2 -> reply "
              f"staged at step {b['step']}, {b['moved_mb']:.1f} MB moved, "
              f"{b['local_mb']:.1f} MB local, stage s {b['stage_s']:.2f} (the sha256 "
              f"included), manifest s {b['manifest_s']:.2f}; exit 113; peak "
              f"{b['peak_gb']:.2f} GB; launches fwd/dq/dkv {tuple(b['counts'])}; wall "
              f"{b['wall_s']:.1f} s", flush=True)
        print(f"phase 21b: {time.perf_counter() - t1:.1f} s", flush=True)
        t2 = time.perf_counter()
        with open(os.path.join(work, "go"), "w") as f:
            f.write("go")
        c = _wait_pair(procs, os.path.join(work, "c.json"), logs)
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if [p.returncode for p in procs] != [0, 0]:
        raise AssertionError(f"21 pair exit {[p.returncode for p in procs]}:\n"
                             + "\n".join(open(x).read()[-3000:] for x in logs))
    c0, c1 = c["ranks"]
    bad = []
    if c0["digest"]["*"] != b["digest"]:
        bad.append(f"restored state {c0['digest']['*']} is not the trainer's {b['digest']}")
    if c0["step"] != b["step"]:
        bad.append(f"restored step {c0['step']} != {b['step']}")
    rel = abs(c0["losses"][0] - c0["ref_loss"]) / abs(c0["ref_loss"])
    if not rel <= RESHARD_LOSS_TOL:
        bad.append(f"loss {c0['losses'][0]} against one process's {c0['ref_loss']}")
    for r in c["ranks"]:
        if "coverage violation" not in r["fault_coverage"] or not r["fault_digest"]:
            bad.append(f"planted faults on rank {r['rank']}: {r['fault_coverage']!r}, "
                       f"digest marker refused {r['fault_digest']}")
    # K1/K2/K3 on every hop's steps: a step launches K1 twice a layer (the
    # forward and full remat's recompute) and K2, K3 once
    n = RESHARD_LAYERS

    def want(steps):
        return [2 * n * steps, n * steps, n * steps]
    hops = [("21a rank 0", r0["counts"], want(2)), ("21a rank 1", r1["counts"], want(2)),
            ("21b", b["counts"], want(b["step"] - at0)),
            ("21c rank 0", c0["counts"], want(1)), ("21c rank 1", c1["counts"], want(1))]
    bad += [f"launches fwd/dq/dkv of {h} {got} (expected {w})" for h, got, w in hops
            if list(got) != w]
    if bad:
        raise AssertionError("21: " + "; ".join(bad))
    print(f"21c pair [{smi}]: a fresh state on {{'data': 2}} filled from the trainer's "
          f"staging at step {c0['step']} in {c0['restore_s']:.2f} / {c1['restore_s']:.2f} s "
          f"({c0['read_mb'] / c0['restore_s']:.0f} / {c1['read_mb'] / c1['restore_s']:.0f} "
          f"MB/s read, {c0['read_mb']:.1f} MB a rank), sha256 the trainer's at step "
          f"{b['step']} (hashed in {c0['digest_s']:.2f} s); one step loss "
          f"{c0['losses'][0]:.6f} against one process's {c0['ref_loss']:.6f} (rel {rel:.2e}, "
          f"tol {RESHARD_LOSS_TOL}); planted faults: a member left out -> "
          f"{c0['fault_coverage'][:60]}..., a changed marker digest -> restore_staged None; "
          f"peak {c0['peak_gb']:.2f} / {c1['peak_gb']:.2f} GB; launches fwd/dq/dkv "
          f"{tuple(c0['counts'])} + {tuple(c1['counts'])}", flush=True)
    print(f"phase 21c: {time.perf_counter() - t2:.1f} s", flush=True)
    print("21: live reshard across cards (NCCL gangs) and over the socket fetch at this size "
          "is not run here: one card cannot form an NCCL group of two ranks", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    launches = [sum(h[1][i] for h in hops) for i in range(3)]
    return dict(a_pair=a, a_s=a_s, b_trainer=b, c_pair=c, launches=launches, loss_rel=rel)


# -- phase 22: asynchronous checkpoints, the MNIST gang, the rendezvous smoke --

ASYNC_ROWS, ASYNC_SEQ = 4, 1024  # 22a's batch: the trainer's at phase 21b
ASYNC_PLAIN_STEPS = 2             # 22a's steps without a save in flight, timed


def _host_mem_gb():
    """The host's MemTotal (/proc/meminfo) in GB."""
    with open("/proc/meminfo") as f:
        kb = next(int(ln.split()[1]) for ln in f if ln.startswith("MemTotal:"))
    return kb * 1024 / 1e9


class _SpanList:
    """A tracer that keeps the spans it is given (CheckpointManager's
    ckpt.write)."""

    def __init__(self):
        self.spans = []

    def record(self, name, duration_s=0.0, **attrs):
        self.spans.append(dict(name=name, dur=duration_s, **attrs))


def _state_leaves(state):
    from kubedl_tpu_torch.models import llama

    return [t for t in llama.tree_leaves({"params": state.params,
                                          "opt_state": state.opt_state})
            if isinstance(t, torch.Tensor)]


def _published_differs(path, step, want):
    """Leaves of <path>/<step>/state.pt (read on the card) that differ from
    `want` (tensors on the card, in the state's order), and whether the
    step number does."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.train import checkpoint

    saved = torch.load(os.path.join(path, str(step), checkpoint.STATE_FILE), map_location="cpu",
                       mmap=True, weights_only=True)
    got = [t for t in llama.tree_leaves({"params": saved["params"],
                                         "opt_state": saved["opt_state"]})
           if isinstance(t, torch.Tensor)]
    if len(got) != len(want):
        raise AssertionError(f"22a: step {step} holds {len(got)} tensors, the state {len(want)}")
    bad = sum(1 for g, w in zip(got, want)
              if g.dtype != w.dtype or not torch.equal(g.to(w.device), w))
    return bad, saved["step"] != step


def _22a_async_saves(smi):
    """bench-1b (full width and depth, bf16, full remat, clip + AdamW) on
    the card through make_train_step and CheckpointManager: steps without a
    save, then an asynchronous save with the next step overlapping its
    write, then the same save done synchronously; the published step
    against the phase's own snapshot after a step ran in place over the
    live state, and a planted manager that hands the writer the live
    tensors, which must fail that comparison."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.train import checkpoint

    held = threading.Event()

    class LiveWriter(checkpoint.CheckpointManager):
        """The planted fault: the writer gets the live tensors. Its write
        waits for `held`, so the steps the phase runs meanwhile land first
        (the hazard, without a race against the write's speed)."""

        def _snapshot(self, payload):
            return payload

        def _write(self, *args):
            if not held.wait(600):
                raise TimeoutError("22a: the planted writer was never released")
            return super()._write(*args)

    config = llama.LlamaConfig.bench_1b()
    dirs = [os.path.join(WORK, name) for name in ("ckpt-async", "ckpt-async-live")]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(3e-4, weight_decay=0.01))
    init_state, train_step = make_train_step(lambda p, b: llama.loss_fn(p, b, config), tx)
    state = init_state(params)
    del params
    batch = torch.randint(0, config.vocab_size, (ASYNC_ROWS, ASYNC_SEQ), device="cuda",
                          dtype=torch.int32,
                          generator=torch.Generator(device="cuda").manual_seed(22))
    spans = _SpanList()
    mngr = checkpoint.CheckpointManager(dirs[0], max_to_keep=2, tracer=spans)
    losses = []

    def step():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        losses.append(m["loss"].item())  # waits for the step
        return time.perf_counter() - t0

    def own_snapshot():
        return [t.detach().clone() for t in _state_leaves(state)]

    _reset_counts()
    step()
    step()  # warm
    plain_s = [step() for _ in range(ASYNC_PLAIN_STEPS)]
    leaves = _state_leaves(state)
    n_tensors, state_gb = len(leaves), sum(t.numel() * t.element_size() for t in leaves) / 1e9
    del leaves
    t0 = time.perf_counter()  # the buffers' registration and one copy, once
    mngr._snapshot({"params": state.params, "opt_state": state.opt_state, "step": state.step})
    pin_s = time.perf_counter() - t0

    # the interval save: the loop's stall, then a step beside the write
    at = state.step
    want = own_snapshot()
    t0 = time.perf_counter()
    mngr.save(at, state)
    stall_s = time.perf_counter() - t0
    in_flight = mngr.latest_step() != at
    overlap_s = step()  # in place over the live state, the write in flight
    t0 = time.perf_counter()
    mngr.wait_until_finished()
    tail_s = time.perf_counter() - t0
    write = spans.spans[-1]
    bad, bad_step = _published_differs(dirs[0], at, want)
    if bad or bad_step:
        raise AssertionError(f"22a: the published step {at} differs from the state at save "
                             f"in {bad} leaves (step number differs: {bad_step})")
    del want

    # the same save done synchronously
    t0 = time.perf_counter()
    mngr.save(state.step, state)
    mngr.wait_until_finished()
    sync_s = time.perf_counter() - t0
    sync_write = spans.spans[-1]

    # the planted fault: the live tensors to the writer, two steps in place
    live = LiveWriter(dirs[1], tracer=spans)
    at_live = state.step
    want = own_snapshot()
    live.save(at_live, state)
    step()
    step()
    held.set()
    live.wait_until_finished()
    bad_live, _ = _published_differs(dirs[1], at_live, want)
    del want
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = config.n_layers
    n_steps = len(losses)
    if counts != (2 * n * n_steps, n * n_steps, n * n_steps):
        raise AssertionError(f"22a: launches (fwd, dq, dkv) {counts} over {n_steps} steps")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"22a: losses {losses}")
    if not bad_live:
        raise AssertionError("22a: the planted live-tensor writer published the state at save: "
                             "the comparison cannot see a save that reads the live state")
    plain_ms = statistics.median(plain_s) * 1e3
    mem_gb = _host_mem_gb()
    print(f"22a async checkpoints [{smi}]: bench-1b (full width and depth, bf16, clip + AdamW) "
          f"b {ASYNC_ROWS} x {ASYNC_SEQ}, state {state_gb:.2f} GB in {n_tensors} tensors "
          f"(host MemTotal {mem_gb:.1f} GB); pinned buffers registered and filled once in "
          f"{pin_s:.2f} s; interval save at step {at}: stall {stall_s * 1e3:.1f} ms "
          f"(latest_step lagging: {in_flight}), the step beside the write "
          f"{overlap_s * 1e3:.1f} ms against {plain_ms:.1f} ms without one (steps "
          f"{', '.join(f'{x * 1e3:.1f}' for x in plain_s)}), then {tail_s:.2f} s waited; write "
          f"{write['dur']:.2f} s (fsync {write['fsync_s']:.2f} s; "
          f"{write['bytes'] / 1e9 / write['dur']:.2f} GB/s); the same save synchronously: stall "
          f"{sync_s:.2f} s (write {sync_write['dur']:.2f} s, fsync {sync_write['fsync_s']:.2f} s; "
          f"{sync_write['bytes'] / 1e9 / sync_write['dur']:.2f} GB/s); step {at} reloaded equals "
          f"the phase's snapshot bit for bit after a step in place; the planted live-tensor "
          f"writer: {bad_live} of {n_tensors} leaves differ (seen); peak {peak_gb:.2f} GB; "
          f"K1/K2/K3 launches {counts} over {n_steps} steps", flush=True)
    del state, mngr, live
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    return dict(state_gb=state_gb, tensors=n_tensors, pin_s=pin_s,
                stall_ms=stall_s * 1e3, overlap_step_ms=overlap_s * 1e3, plain_step_ms=plain_ms,
                plain_steps_ms=[x * 1e3 for x in plain_s], tail_wait_s=tail_s,
                write_s=write["dur"], write_gb_s=write["bytes"] / 1e9 / write["dur"],
                fsync_s=write["fsync_s"], sync_fsync_s=sync_write["fsync_s"],
                sync_stall_s=sync_s, sync_write_s=sync_write["dur"],
                sync_write_gb_s=sync_write["bytes"] / 1e9 / sync_write["dur"],
                lagging=in_flight, planted_bad_leaves=bad_live, losses=losses,
                launches=list(counts), peak_gb=peak_gb, host_mem_gb=mem_gb)


_MNIST_RANK = """
import json, sys
from kubedl_tpu_torch.train import mnist
run = mnist.run
def keep(*a, **kw):
    out = run(*a, **kw)
    with open(sys.argv[1], "w") as f:
        json.dump(out["losses"], f)
    return out
mnist.run = keep
sys.exit(mnist.main(sys.argv[2:]))
"""


def _pair(argvs, tag, timeout=300):
    """Two processes of one gloo gang sharing the card (the operator's env:
    a loopback coordinator, KUBEDL_NUM_PROCESSES 2, KUBEDL_PROCESS_ID
    0 and 1); returns the started processes and their log paths."""
    root = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    logs = [os.path.join(WORK, f"{tag}-rank{r}.log") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable] + argvs[r], cwd=root, stdout=open(logs[r], "w"),
        stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                 KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", KUBEDL_NUM_PROCESSES="2",
                 KUBEDL_PROCESS_ID=str(r))) for r in range(2)]
    return procs, logs


def _22c_gangs(smi):
    """MNIST as two processes sharing the card over gloo (the entry point's
    main in each, its losses written beside), against one process on the
    same global batch; the rendezvous smoke as two processes meanwhile."""
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.train import mnist

    os.makedirs(WORK, exist_ok=True)
    outs = [os.path.join(WORK, f"22c-mnist-losses{r}.json") for r in range(2)]
    for o in outs:
        if os.path.exists(o):
            os.remove(o)
    t0 = time.perf_counter()
    m_procs, m_logs = _pair([["-c", _MNIST_RANK, outs[r], *MNIST_ARGS, "--backend", "gloo"]
                             for r in range(2)], "22c-mnist")
    s_procs, s_logs = _pair([["-m", "kubedl_tpu_torch.train.smoke_distributed", "--backend",
                              "gloo"]] * 2, "22c-smoke")
    try:
        for p in m_procs + s_procs:
            p.wait(timeout=300)
    finally:
        for p in m_procs + s_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    texts = [open(x).read() for x in m_logs + s_logs]
    rcs = [p.returncode for p in m_procs + s_procs]
    if rcs != [0, 0, 0, 0]:
        raise AssertionError(f"22c: exits {rcs}:\n" + "\n".join(t[-1500:] for t in texts))
    args = mnist.parse_args(MNIST_ARGS)
    lines = [_line_numbers(t, ["steps", "batch", "loss", "step/sec", "devices"])
             for t in texts[:2]]
    if any(ln["devices"] != 2 or ln["batch"] != args.batch // 2 * 2 for ln in lines):
        raise AssertionError(f"22c: MNIST lines {lines}")
    for r, t in enumerate(texts[2:]):
        if f"distributed ok: process {r}/2 devices 1 local / 2 global, psum=2.0" not in t:
            raise AssertionError(f"22c: the rendezvous smoke's rank {r}:\n{t[-1500:]}")
    got = [json.load(open(o)) for o in outs]
    if got[0] != got[1]:
        raise AssertionError("22c: the MNIST ranks read different losses")

    # one process on the card on the same global batch: process r's rows of
    # its own draw from default_rng(r)
    k = mnist.steps_per_call(args.steps, args.steps_per_call)
    half = args.batch // 2  # the global batch is 2 * half
    draws = [mnist.draw_batches(np.random.default_rng(r), k, 2 * half) for r in range(2)]
    xs = np.concatenate([draws[0][0][:, :half], draws[1][0][:, half:]], axis=1)
    ys = np.concatenate([draws[0][1][:, :half], draws[1][1][:, half:]], axis=1)
    dev = torch.device("cuda")
    init_state, train_step = make_train_step(mnist.loss_fn, optim.adam(args.lr))
    state = init_state(mnist.init_params(args.hidden, device=dev))
    batches = [(torch.from_numpy(xs[i]).to(dev), torch.from_numpy(ys[i]).to(dev))
               for i in range(k)]
    want = []
    for i in range(len(got[0])):
        state, m = train_step(state, batches[i % k])
        want.append(m["loss"])
    want = torch.stack(want).tolist()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got[0], want))
    print(f"22c mnist gang [{smi}]: two processes sharing the card in a gloo group "
          f"(--backend gloo; NCCL cannot hold two ranks on one device), {' '.join(MNIST_ARGS)}, "
          f"devices=2, global batch {args.batch}: {lines[0]['step/sec']:.1f} / {lines[1]['step/sec']:.1f} "
          f"step/s; {len(want)} losses against one process on the same global batch: final "
          f"{got[0][-1]:.6f} / {want[-1]:.6f}, max rel {loss_rel:.2e} (tol {MNIST_LOSS_TOL}); "
          f"rendezvous smoke: both ranks 'distributed ok ... psum=2.0' in a gloo group; both "
          f"pairs in {wall_s:.1f} s", flush=True)
    if len(got[0]) != len(want) or loss_rel > MNIST_LOSS_TOL:
        raise AssertionError("22c: the MNIST gang disagrees with one process")
    return dict(step_s=[ln["step/sec"] for ln in lines], loss_rel=loss_rel,
                final=[got[0][-1], want[-1]], wall_s=wall_s, backend="gloo")


def phase_async(smi):
    """22: a) asynchronous saves at bench-1b; c) the MNIST gang and the
    rendezvous smoke (22b rides in phases 7, 11c and 16a)."""
    out = {"a_saves": _phase("22a", _22a_async_saves, smi)}
    _free("22a")
    out["c_gangs"] = _phase("22c", _22c_gangs, smi)
    return out


def _phase(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _free(after):
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"memory: {left / 1e9:.3f} GB allocated after {after}", flush=True)
    if left >= 1e9:
        raise AssertionError(f"{left / 1e9:.2f} GB still allocated after {after}")


def _keep_bytecode():
    """Cache Python's bytecode under build/ for this process and the ones it
    starts. Where the environment sets PYTHONDONTWRITEBYTECODE (or
    site-packages is read-only), every fresh process would compile torch
    from source again, and torch._dynamo too, which torch.utils.checkpoint
    imports at its first call: seconds at each trainer, stage or pod start."""
    prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None,
                   help="also write all of the run's numbers to this JSON file")
    # phase 20a's ranks: this script, run by the phase itself
    p.add_argument("--context-rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--context-port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--context-out", default=None, help=argparse.SUPPRESS)
    # phase 24's ranks
    p.add_argument("--moe-pair-rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--moe-pair-port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--moe-pair-out", default=None, help=argparse.SUPPRESS)
    # phase 21a's and 21c's ranks
    p.add_argument("--reshard-rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--reshard-port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--reshard-out", default=None, help=argparse.SUPPRESS)
    p.add_argument("--reshard-dir", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.context_rank is not None:
        return _context_rank(args.context_rank, args.context_port, args.context_out)
    if args.moe_pair_rank is not None:
        return _moe_pair_rank(args.moe_pair_rank, args.moe_pair_port, args.moe_pair_out)
    if args.reshard_rank is not None:
        return _reshard_rank(args.reshard_rank, args.reshard_port, args.reshard_out,
                             args.reshard_dir)
    _keep_bytecode()
    t_start = time.perf_counter()
    name, smi, build = _phase("1 device and build", phase_device)
    contracts = _phase("7, 11c and 19c: the preemption contracts side by side",
                       phase_preemption_contracts, smi)
    kernels = _phase("2 flash forward kernel", phase_kernels)
    bwd = _phase("2b flash backward kernels", phase_bwd_kernels)
    gmm = _phase("2c grouped matmul kernels", phase_gmm_kernels)
    model = _phase("3 7B prefill", phase_model)
    serving, launches = _phase("4 7B serving over HTTP", phase_serve)
    _free("serving")
    grads = _phase("5 7B-width gradients", phase_grads)
    _free("gradients")
    train = _phase("6 7B trainer", phase_train, model["n_params"])
    options = _phase("7 trainer options", phase_options)
    options.update(contracts["7"])  # run after phase 1
    _free("training")
    moe_grads = _phase("8 MoE gradients", phase_moe_grads)
    _free("MoE gradients")
    moe_train = _phase("9 MoE training", phase_moe_train)
    _free("MoE training")
    moe_serve = _phase("10 MoE int8 serving", phase_moe_serve)
    _free("MoE serving")
    sharded = _phase("11a sharded 7B step", phase_sharded_step, train)
    _free("the sharded step")
    ep = _phase("11b expert-parallel body", phase_ep_body)
    _free("the expert-parallel body")
    gang = contracts["11c"]  # run after phase 1, beside phase 7's contract
    pair = _24_start()  # phase 24's pair runs beside phase 12
    tp = _phase("12 tensor-parallel serving, the int8 KV cache, MoE int8 and the serving "
                "features under a mesh (and 24's check)", phase_tp_serving, smi, pair)
    _free("tensor-parallel serving")
    import torch.distributed as dist

    dist.destroy_process_group()
    features = _phase("13 serving features", phase_serving_features, smi)
    _free("the serving features")
    lora = _phase("14 LoRA, adapter serving, SSE and /metrics", phase_lora, train, smi)
    _free("LoRA")
    gemma = _phase("15 Gemma-2-2B from a local Hugging Face directory (and 16, RL)",
                   phase_gemma2, smi)
    _free("Gemma-2")
    rl = gemma.pop("rl")
    disagg = _phase("17 the disaggregated serving plane and the socket plane (a, c, d)",
                    phase_disagg, smi, gemma.pop("rollout"), rl.pop("d_socket_pods", None))
    _free("the serving plane")
    workloads = _phase("18 the workload programs: ViT-B/16, the sparse CTR model, MNIST",
                       phase_workloads, smi)
    _free("the workload programs")
    pipe = _phase("19 pipeline parallelism: the MPMD stage programs", phase_pipeline, smi)
    pipe["c_socket"] = contracts["19c"]  # run after phase 1, beside phase 7's contract
    _free("the pipeline")
    ctx = _phase("20 context parallelism: ring and Ulysses, a gloo pair on one card",
                 phase_context, smi)
    _free("context parallelism")
    reshard = _phase("21 live reshard: a bench-1b gang resharded 2 -> 1 -> 2 through the "
                     "staging", phase_reshard, smi)
    _free("live reshard")
    async_ = _phase("22 asynchronous checkpoints at bench-1b, the MNIST gang and the "
                    "rendezvous smoke", phase_async, smi)
    _free("asynchronous checkpoints")
    ck_l = async_["a_saves"]["launches"]  # 22a's bench-1b steps around its saves
    ctx_l = ctx["a_pair"]["launches"]  # Ulysses' K1/K2/K3 over both ranks
    rs_l = reshard["launches"]  # every hop's steps: 21a's and 21c's ranks, 21b's trainer
    pp_a, pp_b = pipe["a_mpmd"]["launches"], pipe["b_trainers"]["launches"]
    main_k, main_b = kernels[MAIN_SHAPE], bwd[MAIN_BWD_SHAPE]
    bwd_rows = []
    for part, gname, line in (("dq", ("dq",), 291), ("dkv", ("dk", "dv"), 336)):
        bwd_rows.append({
            "name": f"flash_bwd_{part}",
            "route": "cuda",
            "source": f"kubedl_tpu_torch/ops/csrc/{main_b['sources'][part]}",
            "replaces": f"kubedl_tpu/ops/flash_attention.py:{line}",
            "launches": train["launches"][1 if part == "dq" else 2],
            "launches_by_path": {"7b_train": train["launches"][1 if part == "dq" else 2],
                                 "7b_lora_train": lora["a_train"]["launches"][
                                     1 if part == "dq" else 2],
                                 "7b_mpmd_4l": pp_a[1 if part == "dq" else 2],
                                 "7b_stage_trainers": pp_b[1 if part == "dq" else 2],
                                 "7b_context_ulysses": ctx_l[1 if part == "dq" else 2],
                                 "bench1b_reshard_hops": rs_l[1 if part == "dq" else 2],
                                 "bench1b_async_ckpt": ck_l[1 if part == "dq" else 2]},
            "max_abs_err": max(r["errors"][g + "_abs"] for r in bwd.values()
                               if r["sources"][part] == main_b["sources"][part]
                               and r["shape"][4] <= 128 for g in gname),
            "ms": main_b[f"{part}_ms"],
            "plain_ms": main_b["plain_ms"],
            "bound_ms": main_b[f"{part}_bound_ms"],
            "bound_by": main_b[f"{part}_bound_by"],
            "library_ms": main_b["library_ms"],
        })
    # K5, K6, K7 from the MoE training run; K8 from int8 serving
    gmm_launches = {"gmm_swiglu": moe_train["launches"][0], "gmm": moe_train["launches"][1],
                    "tgmm": moe_train["launches"][2], "gmm_scaled": moe_serve["launches"][3]}
    gmm_rows = []
    for kname, line in (("gmm", 130), ("gmm_scaled", 147), ("gmm_swiglu", 170),
                        ("tgmm", 276)):
        main_g = gmm[MAIN_GMM[kname]][MAIN_CASE[kname]]
        gmm_rows.append({
            "name": kname,
            "launches_by_path": {"moe_train": moe_train["launches"][MAIN_INDEX[kname]],
                                 "ep_dropless_body": ep["launches"][MAIN_INDEX[kname]],
                                 "moe_int8_serving": moe_serve["launches"][MAIN_INDEX[kname]],
                                 "moe_int8_mesh_serving": tp["c_moe"]["gmm"][MAIN_INDEX[kname]],
                                 "moe_bf16_mesh_serving":
                                     tp["c_moe"]["bf16_gmm"][MAIN_INDEX[kname]],
                                 "moe_int8_pair": tp["moe_pair"]["launches"][MAIN_INDEX[kname]]},
            "route": "cuda",
            "source": "kubedl_tpu_torch/ops/csrc/gmm_sm90.cu",
            "replaces": f"kubedl_tpu/ops/gmm.py:{line}",
            "launches": gmm_launches[kname],
            "max_abs_err": max(v["max_abs_err"] for sh in gmm.values()
                               for k, v in sh.items() if k.startswith(kname)
                               and (kname != "gmm" or k in ("gmm", "gmm_T"))),
            "ms": main_g["kernel_ms"],
            "plain_ms": main_g["plain_ms"],
            "bound_ms": main_g["bound_ms"],
            "bound_by": main_g["bound_by"],
            "library_ms": main_g["library_ms"],
        })
    # the d 256 kernels on phase 15's paths: flash_fwd_sm90.cu's Fwd<256>,
    # flash_bwd_sm90.cu's Dq256 and Dkv256; the mma.sync kernel's time at
    # the same shape beside each
    k256, b256 = kernels[MAIN_D256], bwd[MAIN_BWD_D256]
    d256_rows = [{
        "name": "flash_fwd_d256",
        "route": "cuda",
        "source": f"kubedl_tpu_torch/ops/csrc/{k256['source']}",
        "replaces": "kubedl_tpu/ops/flash_attention.py:107",
        "launches": sum(gemma["launches"]["fwd"].values()),
        "launches_by_path": gemma["launches"]["fwd"],
        "max_abs_err": max(r["out_max_abs_err"] for r in kernels.values()
                           if r["shape"][4] == 256),
        "ms": k256["kernel_ms"],
        "plain_ms": k256["plain_ms"],
        "bound_ms": k256["bound_ms"],
        "bound_by": k256["bound_by"],
        "library_ms": k256["library_ms"],
        "library": k256["library"],
        # scaled_dot_product_attention on the same shape without the softcap
        "sdpa_twin_ms": kernels["d256_gqa_s1024"]["library_ms"],
        "mma_sync_ms": k256["mma_sync_ms"],
    }]
    for part, gname, line in (("dq", ("dq",), 291), ("dkv", ("dk", "dv"), 336)):
        d256_rows.append({
            "name": f"flash_bwd_{part}_d256",
            "route": "cuda",
            "source": f"kubedl_tpu_torch/ops/csrc/{b256['sources'][part]}",
            "replaces": f"kubedl_tpu/ops/flash_attention.py:{line}",
            "launches": sum(gemma["launches"][part].values()),
            "launches_by_path": gemma["launches"][part],
            "max_abs_err": max(r["errors"][g + "_abs"] for r in bwd.values()
                               if r["shape"][4] == 256 for g in gname),
            "ms": b256[f"{part}_ms"],
            "plain_ms": b256["plain_ms"],
            "bound_ms": b256[f"{part}_bound_ms"],
            "bound_by": b256[f"{part}_bound_by"],
            "library_ms": b256["library_ms"],
            "library": b256["library"],
            "sdpa_twin_ms": bwd["d256_gqa_s1023"]["library_ms"],
            "mma_sync_ms": b256["mma_sync"][f"{part}_ms"],
        })
    # the non-causal kernels on phase 18a's ViT-B/16 path, at its shape
    kv, bv = kernels[MAIN_VIT], bwd[MAIN_VIT]
    vit_launches = workloads["a_vit"]["launches"]
    vit_rows = [{
        "name": "flash_fwd_noncausal",
        "route": "cuda",
        "source": f"kubedl_tpu_torch/ops/csrc/{kv['source']}",
        "replaces": "kubedl_tpu/ops/flash_attention.py:107",
        "launches": vit_launches[0],
        "launches_by_path": {"vit_b16_train": vit_launches[0]},
        "max_abs_err": max(r["out_max_abs_err"] for r in kernels.values() if not r["causal"]),
        "ms": kv["kernel_ms"],
        "plain_ms": kv["plain_ms"],
        "bound_ms": kv["bound_ms"],
        "bound_by": kv["bound_by"],
        "library_ms": kv["library_ms"],
        "mma_sync_ms": kv["mma_sync_ms"],
    }]
    for i, (part, gname, line) in enumerate((("dq", ("dq",), 291),
                                             ("dkv", ("dk", "dv"), 336)), start=1):
        vit_rows.append({
            "name": f"flash_bwd_{part}_noncausal",
            "route": "cuda",
            "source": f"kubedl_tpu_torch/ops/csrc/{bv['sources'][part]}",
            "replaces": f"kubedl_tpu/ops/flash_attention.py:{line}",
            "launches": vit_launches[i],
            "launches_by_path": {"vit_b16_train": vit_launches[i]},
            "max_abs_err": max(r["errors"][g + "_abs"] for r in bwd.values()
                               if not r["causal"] for g in gname),
            "ms": bv[f"{part}_ms"],
            "plain_ms": bv["plain_ms"],
            "bound_ms": bv[f"{part}_bound_ms"],
            "bound_by": bv[f"{part}_bound_by"],
            "library_ms": bv["library_ms"],
            "mma_sync_ms": bv["mma_sync"][f"{part}_ms"],
        })
    report = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": f"kubedl_tpu_torch/ops/csrc/{main_k['source']}",
        "replaces": "kubedl_tpu/ops/flash_attention.py:107",
        "launches": launches,
        # the same kernel on every path that runs attention at d = 128
        "launches_by_path": {"7b_serving": launches, "7b_train": train["launches"][0],
                             "moe_train": moe_train["flash_launches"][0],
                             "7b_sharded_step": sharded["launches"][0],
                             "moe_int8_serving": moe_serve["flash_launches"],
                             "7b_tp_serving": tp["launches_mesh"],
                             "7b_int8_kv_serving": tp["launches_int8"],
                             "moe_int8_mesh_serving": tp["c_moe"]["launches"],
                             "moe_bf16_mesh_serving": tp["c_moe"]["bf16_launches"],
                             "7b_features_mesh": tp["d_features"]["launches"],
                             "moe_int8_pair": sum(rk["flash"][0] for m in MOE_PAIR_MESHES
                                                  for rk in tp["moe_pair"][",".join(
                                                      f"{a}={k}" for a, k in m.items())]["ranks"]),
                             **features["launches"], **lora["launches"],
                             "7b_disagg_serving": disagg["a_facade"]["launches"],
                             "7b_router_cross_pod": disagg["c_router"]["launches"],
                             "7b_mpmd_4l": pp_a[0], "7b_stage_trainers": pp_b[0],
                             "7b_context_ulysses": ctx_l[0],
                             "bench1b_reshard_hops": rs_l[0],
                             "bench1b_async_ckpt": ck_l[0]},
        "max_abs_err": max(r["out_max_abs_err"] for r in kernels.values()
                           if r["source"] == main_k["source"] and r["shape"][4] <= 128),
        "ms": main_k["kernel_ms"],
        "plain_ms": main_k["plain_ms"],
        "bound_ms": main_k["bound_ms"],
        "bound_by": main_k["bound_by"],
        "library_ms": main_k["library_ms"],
    }] + bwd_rows + d256_rows + vit_rows + gmm_rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=name, nvidia_smi=smi, build=build, kernels=kernels,
                           bwd_kernels=bwd, gmm_kernels=gmm, model=model, serving=serving,
                           grads=grads, train=train, options=options, moe_grads=moe_grads,
                           moe_train=moe_train, moe_serve=moe_serve, sharded_step=sharded,
                           ep_body=ep, gang_preemption=gang, tp_serving=tp,
                           serving_features=features, lora=lora, gemma2=gemma, rl=rl,
                           disagg=disagg, workloads=workloads, pipeline=pipe, context=ctx,
                           reshard=reshard, async_checkpoints=async_,
                           seconds=time.perf_counter() - t_start),
                      f, indent=1)
    a, b, c = rl["a_grpo"], rl["b_fleet"], rl["c_pods"]
    print(json.dumps({"rl": {
        "gemma2_grpo": {k: a[k] for k in ("losses", "kl", "off_ratio", "rollout_s",
                                          "rollout_tok_s", "learner_s", "peak_gb", "launches")},
        "gemma2_rl_fleet": {k: b[k] for k in ("loss_max_rel", "param_max_abs", "payload_gb",
                                              "publish_s", "publish_gb_s", "peak_gb",
                                              "launches")},
        "bench1b_rl_pods": {k: c[k] for k in ("wall_s", "consumed", "learn_s")}}}), flush=True)
    fa, ro, rc_, pd = (disagg[k] for k in ("a_facade", "b_rollout", "c_router", "d_pods"))
    print(json.dumps({"disagg": {
        "llama7b_facade": {k: fa[k] for k in ("rows_equal", "launches", "tick_ms", "peak_gb",
                                              "transient_gb", "probe_most",
                                              "concurrency_ratio")},
        "gemma2_rollout": {k: ro[k] for k in ("serving_s", "generate_s", "lp_max_diff",
                                              "blocks_cold", "blocks_warm", "launches")},
        "llama7b_router": {k: rc_[k] for k in ("rows_equal", "migrated", "migrated_equal",
                                               "mb_per_handoff", "hop_mb_s", "launches")},
        "bench1b_rl_pods_socket": {k: pd[k] for k in ("wall_s", "consumed", "learn_s")}}}),
        flush=True)
    va, sb, mc = (workloads[k] for k in ("a_vit", "b_sparse", "c_mnist"))
    print(json.dumps({"workloads": {
        "vit_b16_train": {**{k: va[k] for k in ("step_ms", "img_s", "peak_gb", "launches",
                                                "logit_rel")},
                          "idle_share": va["profile"]["idle_share"]},
        "sparse_full_vocab": {**{k: sb[k] for k in ("step_ms", "lookups_s", "peak_gb",
                                                    "loss_rel")},
                              "idle_share": sb["profile"]["idle_share"]},
        "mnist": {**{k: mc[k] for k in ("step_s", "loss", "loss_rel")},
                  "idle_share": mc["profile"]["idle_share"]}}}), flush=True)
    pa, pb = pipe["a_mpmd"], pipe["b_trainers"]
    print(json.dumps({"pipeline": {
        "llama7b_mpmd_4l": {k: pa[k] for k in ("loss_rel", "launches", "step_ms", "ref_ms",
                                               "fault_over_tol")},
        "llama7b_stage_trainers": {k: pb[k] for k in ("step_ms", "wait_ms", "boundary",
                                                      "peak_gb", "launches", "tok_s",
                                                      "one_process_step_ms", "ratio")}}}),
        flush=True)
    ca = ctx["a_pair"]
    print(json.dumps({"context": {
        f"llama7b_2l_{st}": {"loss_rel": ca[st]["loss_rel"],
                             "position_err": ca[st]["position_err"],
                             "grad_rel": ca[st]["grad_rel"],
                             "step_ms": [rk["ms"] for rk in ca[st]["ranks"]],
                             "peak_gb": [rk["peak_gb"] for rk in ca[st]["ranks"]],
                             "staged_bytes": [rk["staged"] for rk in ca[st]["ranks"]],
                             "launches": [rk["counts"] for rk in ca[st]["ranks"]]}
        for st in CTX_STRATEGIES} | {"fault": ca["fault"], "reference": ca["reference"],
                                     "backend": ca["backend"]}}), flush=True)
    ra, rb, rc2 = (reshard[k] for k in ("a_pair", "b_trainer", "c_pair"))
    print(json.dumps({"reshard": {
        "bench1b_fsdp2_to_1": {"losses": ra["ranks"][0]["losses"],
                               "moved_mb": ra["ranks"][0]["plan"]["moved_mb"],
                               "local_mb": ra["ranks"][0]["plan"]["local_mb"],
                               "move_s": [r["move_s"] for r in ra["ranks"]],
                               "stage_s": [r["stage_s"] for r in ra["ranks"]],
                               "manifest_s": ra["ranks"][0]["manifest_s"],
                               "digest_s": ra["ranks"][0]["digest_s"],
                               "peak_gb": [r["peak_gb"] for r in ra["ranks"]],
                               "launches": [r["counts"] for r in ra["ranks"]],
                               "s": reshard["a_s"]},
        "bench1b_trainer_1_to_2": {k: rb[k] for k in ("losses", "read_mb", "restore_s",
                                                       "moved_mb", "local_mb", "stage_s",
                                                       "manifest_s", "peak_gb", "counts",
                                                       "restored_at_s", "wall_s")},
        "bench1b_restore_2": {"restore_s": [r["restore_s"] for r in rc2["ranks"]],
                              "read_mb_s": [r["read_mb"] / r["restore_s"]
                                            for r in rc2["ranks"]],
                              "digest_s": rc2["ranks"][0]["digest_s"],
                              "loss_rel": reshard["loss_rel"],
                              "peak_gb": [r["peak_gb"] for r in rc2["ranks"]],
                              "launches": [r["counts"] for r in rc2["ranks"]]}}}),
        flush=True)
    pt = gemma["post"]
    print(json.dumps({"post_training": {
        "gemma2_2l_pairs": {k: pt[k] for k in ("wall_s", "pair_s", "dpo_losses", "dpo_step_s",
                                                "grpo_loss1", "grpo_grad_norm1", "grpo_splits",
                                                "grpo_update_s", "grpo_rollout_s", "eval",
                                                "staged", "peak_gb", "launches")},
        "gemma2_2l_one_process": {"dpo_losses": gemma["d_dpo_eval"]["dpo_losses"],
                                  "dpo_step_s": gemma["d_dpo_eval"]["dpo_step_s"],
                                  "eval": gemma["d_dpo_eval"]["eval"],
                                  "grpo_loss1": rl["a_grpo"]["loss1"],
                                  "grpo_update_s": rl["a_grpo"]["update_s"]}},
        "device": smi}), flush=True)
    sa, gc_ = async_["a_saves"], async_["c_gangs"]
    print(json.dumps({"async_checkpoints": {
        "bench1b_saves": {k: sa[k] for k in ("state_gb", "pin_s", "stall_ms", "overlap_step_ms",
                                             "plain_step_ms", "write_s", "write_gb_s",
                                             "sync_stall_s", "sync_write_s", "sync_write_gb_s",
                                             "planted_bad_leaves", "host_mem_gb", "launches")},
        "gemma2_grpo_saves": rl["a_grpo"]["saves"],
        "mnist_gang": {k: gc_[k] for k in ("step_s", "loss_rel", "backend")},
        "mnist_one_process_step_s": workloads["c_mnist"]["step_s"]},
        "device": smi}), flush=True)
    cm, fd, mp = tp["c_moe"], tp["d_features"], tp["moe_pair"]
    print(json.dumps({"mesh_serving": {
        "moe_int8_mesh_12c": {"gmm": cm["gmm"], "tick_ratio": cm["tick_ratio"],
                              "tick_ms": {k: [r["tick_ms_median"] for r in v]
                                          for k, v in cm["turns"].items()}},
        "moe_bf16_mesh_12c": {"gmm": cm["bf16_gmm"],
                              "tick_ms": {k: [r["tick_ms_median"] for r in v]
                                          for k, v in cm["bf16_turns"].items()}},
        "llama7b_features_mesh_12d": {k: {f: v[f] for f in ("gap_ms", "ttft_s", "prefix_s",
                                                             "round_ms", "acceptance")}
                                      for k, v in fd["features"].items()}
        | {"ring_decode_ms": {k: v["decode_ms"] for k, v in fd["ring"].items()}},
        "moe_int8_pair_24": {k: {f: v[f] for f in ("logits_rel", "agree", "gen_s")}
                             for k, v in mp.items() if isinstance(v, dict)}
        | {"wall_s": mp["wall_s"], "launches": mp["launches"]}},
        "device": smi}), flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
