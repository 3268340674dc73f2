#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with the card and the CUDA
toolkit::

    python3 chip_smoke.py              # all phases
    python3 chip_smoke.py --phases 1,2,3 --json out/smoke.json

It drives the port only (no jax, nothing of ``repro``), in phases that each
raise on failure.  Thirteen main paths (and the port's train and serve
command lines) are driven, each at full width, all but deepseek-v3-671b at
full depth: serving gemma3-1b (flash attention),
mamba2-370m (the SSD scan),
recurrentgemma-9b (the RG-LRU recurrence and flash attention on its local
layers), granite-moe-1b-a400m (flash attention at 16 heads, 8 KV heads of
64, and the MoE layer), gemma2-2b (flash attention at 8 heads, 4 KV heads
of 256 with softcap 50), stablelm-1.6b (flash attention at 32 heads and 32
KV heads of 64, layernorm, partial rotary) and starcoder2-15b (flash
attention at 48 heads, 4 KV heads of 128, window 4096 in every layer;
biases, the plain GELU MLP), deepseek-v3-671b cut to its first 4 layers
(3 dense, 1 MoE) and no MTP head (MLA: flash attention at 128 heads of
q/k head dim 192 and v head dim 128; 256 experts top-8, a sigmoid router
and a shared expert), and training gemma3-1b (flash attention in every
forward and in every remat recompute), at 512 tokens a sequence and at
8,192, where training attention is chunked, serving and training
whisper-tiny (the encoder-decoder model: flash attention not causal in
every encoder layer, causal in every decoder self-attention layer), and
training mamba2-370m at 4,096 tokens a sequence (the SSD scan in every
forward and every remat recompute); besides, the paper's MONC in-situ
analytics, event-driven, every raw field's arithmetic on the card, and
the paper's Graph500 BFS at Kronecker scale 25, the generator's draws made
by a kernel on the card and every level's expansion there:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for float32 products;
2. build: every CUDA kernel from the sources in the checkout, all ``nvcc``
   at once, with each kernel's registers and spills and the tensor-core
   kernels' shared memory; the tensor-core SSD and flash kernels and the
   RG-LRU kernels must not spill;
3. the flash kernels against their plain PyTorch version on the card, on
   the reference's test cases, ragged tails and the serving paths' shapes
   (gemma3-1b's, recurrentgemma-9b's, the training forward's,
   the 8,192-token training forward's, granite-moe-1b-a400m's,
   gemma2-2b's, stablelm-1.6b's,
   starcoder2-15b's, also at 4,608 tokens, where its window of 4096 masks
   keys, deepseek-v3-671b's, where v has its own head dim, and
   whisper-tiny's encoder, not causal, at 100, 1,500 and 4,096 frames in
   both dtypes, gated at TOL x max|plain| because its outputs are
   averages over S keys, where a causal mask and the last key dropped,
   planted in the plain version, must each fail on every row), each row
   with the variant it
   launched (the bf16 tensor-core kernel for bf16, the SIMT kernel for
   float32), with CUDA-event and device times of the kernel, of the SIMT
   kernel on the same inputs (held to the same gate), the plain version
   and one PyTorch library call computing the same function (a yardstick
   only, held to the plain version too: SDPA, or for gemma2-2b's
   softcapped rows a compiled ``flex_attention`` with the tanh cap as its
   score_mod; SDPA without the cap is timed apart, as another function);
4. gemma3-1b with seeded random weights: prefill through the kernel
   against prefill through plain attention, float32 (gated) and bfloat16
   (reported);
5. gemma3-1b's main path: event-driven serving in bf16 through
   ``run_serve`` on the port's EDAT runtime, with every kernel's launch
   count set to 0 just before it and read just after, every flash launch
   the tensor-core variant (every float32 flash launch of any phase must
   be the SIMT one);
6. float32 serving of gemma3-1b against the sequential baseline, token for
   token;
7. where gemma3-1b's serving time goes: one bf16 prefill and one 4-slot
   decode step, the device's kernel time (``torch.profiler``) against the
   host clock;
8. the SSD kernels against their plain version on the card: the
   reference's test cases, ragged tails, a nonzero initial state (final
   state compared too) and the serving path's shapes, each row with the
   variant it launched (the bf16 tensor-core kernel on the serving path's
   shapes, the SIMT kernel for float32), timed as in phase 3 beside the
   SIMT kernel on the same inputs (no single PyTorch call computes this
   function, so it has no library time); the same check must reject
   faults planted in the plain scan; then the training path's shapes
   (B=2, T = 512 and 4,096, bf16 and float32), each with a gradient
   check: the grads through ``ops.ssd`` (the kernel forward, the plain
   scan recomputed in the backward) against the plain scan's autograd,
   which must reject the term between chunks dropped;
9. mamba2-370m: prefill through the SSD kernel against prefill through the
   plain scan, float32 (gated, with the reference's init and again with
   Mamba-2's init of a_log and dt_bias) and bfloat16 (reported); the
   float32 gate must reject faults planted in the plain scan;
10. mamba2-370m's main path: event-driven serving in bf16, counted as in
    phase 5, every SSD launch the tensor-core variant;
11. float32 serving of mamba2-370m against the sequential baseline;
12. where mamba2-370m's serving time goes, as in phase 7, with its SSD
    launches by variant;
13. the RG-LRU kernel against its plain version on the card: the
    reference's test cases, ragged T, a nonzero initial state (final state
    compared too), the serving path's shapes and T = 1100 (five spans of
    the segmented scan) timed as in phase 3 (no single PyTorch call
    computes it), each row with the launch shape and segment length it
    ran, and long-memory cases (Griffin's init of lam); the same check must
    reject faults planted in the plain scan, one dropped carry included;
14. recurrentgemma-9b: prefill through the kernels against prefill through
    the plain versions, bfloat16 at the port's init (reported) and float32
    (gated, with stacked leaves at one layer's fan-in and again with
    Griffin's init of lam on top, with faults planted in the plain scan),
    one parameter tree shared by both models;
15. recurrentgemma-9b's main path: event-driven serving in bf16, counted as
    in phase 5;
16. float32 serving of recurrentgemma-9b against the sequential baseline;
17. where recurrentgemma-9b's serving time goes, as in phase 7, with the
    cost of casting its float32 gate matrices at every decode step;
18. gemma3-1b served over the socket transport, one spawned OS process a
    rank (``run_serve(transport="socket", procs=3)``): the checks of phase
    5 on the kernel counts that the server's own process returns, with the
    session's wall time split and the wire's counters; float32 tokens
    against phase 6's in-proc tokens; client processes that never open
    the card; and a client process SIGKILLed mid-load, after which
    the server drains cleanly;
19. gemma3-1b trained by the event-driven trainer
    (``EventDrivenTrainer.run``, in-proc, 2 ranks, AdamW, bf16, 4 steps of
    2 sequences of 512 a rank, the config's remat "full"): the flash
    kernel's launches (52 a rank-step: 26 in the forward, 26 again in the
    remat recompute), no plain call, the backward's dense plain recomputes
    (26 a backward), finite losses, bit-equal replicas; one step split
    into forward and backward,
    the grads' copy to the host, the quorum reduce, the copy back and the
    update (host clock), the forward and backward under the profiler,
    peak device memory and peak RSS; then float32 runs at 6 layers (one
    unit of the pattern), the kernel path against the plain path (loss
    history and weights), with a fault planted in the plain path and one
    that skips the grad average, each of which the gate must reject;
20. granite-moe-1b-a400m: prefill through the kernel against prefill
    through plain attention, the plain path's routers held to the kernel
    path's expert choices (the tokens whose own top-8 differs counted),
    bf16 and float32 at the port's init (reported: there float32
    rounding alone decides the routers' top-8, as the plain path's own
    float32 floor shows) and float32 with every matrix at the fan-in of
    the dims it contracts (gated), then one 4-slot decode step from four
    such prefills' caches, the same check; each call's dropped router
    assignments printed;
21. granite-moe-1b-a400m's main path: event-driven serving in bf16,
    counted as in phase 5;
22. float32 serving of granite-moe-1b-a400m (phase 20's gated weights),
    gated by replay: the served run records its engine calls (prefill,
    attach, step) with the tokens each returned, and a plain-attention
    engine with the same weights replays them fed the served tokens, so
    every step sees the served batch (a capacity-limited MoE's output
    depends on the batch, so served tokens need not equal the sequential
    baseline's); every token must equal the replay's or differ at a top-2
    gap under NEAR_TIE, and the gate must reject faults planted in the
    replay's MoE (top-k weights not renormalised, capacity ignored); the
    sequential baseline's differences and the decode steps that dropped
    an assignment are reported;
23. where granite-moe-1b-a400m's serving time goes, as in phase 7, with
    the MoE steps' (route, dispatch, experts, combine) share of device
    time;
24. gemma2-2b: prefill through the kernel against prefill through plain
    attention, one parameter tree shared by both, bf16 at the port's init
    (reported) and float32 at the port's init and at one layer's fan-in
    (each gated unless the plain path's own float32 floor is above the
    gate), with the pre-cap
    attention logits of the first and last layer, and faults planted in
    the plain path (the attention or final softcap dropped, the wrong KV
    head), each of which some gated weight set must reject;
25. gemma2-2b's main path: event-driven serving in bf16, counted as in
    phase 5;
26. float32 serving of gemma2-2b against the sequential baseline;
27. where gemma2-2b's serving time goes, as in phase 7;
28. stablelm-1.6b: prefill through the kernel against prefill through
    plain attention, one parameter tree shared by both, bf16 at the
    port's init (reported) and float32 at the port's init (gated unless
    the plain path's own float32 floor is above the gate) and at one
    layer's fan-in (gated), with the pre-softmax attention logits of the
    first and last layer, and faults planted in the plain path (the
    wrong KV head, one key past the causal bound, every dim rotated),
    each of which the one-layer fan-in set must reject at every length;
29. stablelm-1.6b's main path: event-driven serving in bf16, counted as in
    phase 5;
30. float32 serving of stablelm-1.6b against the sequential baseline;
31. where stablelm-1.6b's serving time goes, as in phase 7;
32. starcoder2-15b: the peak memory of a float32 init of the full model
    beside its tree's bytes; prefill through the kernel against prefill
    through plain attention as in phase 28 (the faults: the wrong KV head
    by h % KH, the next KV head, one key past the causal bound); then a
    cache-free forward of 4,608 tokens at full width and 4 layers, past
    the window, whose float32 gate must reject the window dropped from the
    plain attention;
33. starcoder2-15b's main path: event-driven serving in bf16, counted as
    in phase 5;
34. float32 serving of starcoder2-15b against the sequential baseline;
35. where starcoder2-15b's serving time goes, as in phase 7;
36. deepseek-v3-671b (4 layers, no MTP): prefill through the kernel (K and
    V materialised from MLA's latent, flash at D=192, Dv=128) against
    prefill through the plain path (the reference's absorbed form), the
    plain path's routers held to the kernel path's expert choices, bf16
    at the port's init (reported) and float32 at the port's init and at
    contraction fan-in (each gated unless the plain path's own float32
    floor, its absorbed attention in float64, is above the gate), with the
    pre-softmax logits of the first and last layer, the routing flips and
    each call's dropped assignments, and faults planted in the plain path
    (the scale taken from v's head dim, k_rope left unrotated, one key
    past the causal bound), each of which every gated set must reject at
    every length, beside a control (the plain path un-absorbed);
37. deepseek-v3-671b's main path: event-driven serving in bf16, counted
    as in phase 5;
38. float32 serving of deepseek-v3-671b gated by replay, as phase 22:
    every token must equal the replay's, and the gate must reject phase
    22's two MoE faults;
39. where deepseek-v3-671b's serving time goes, as in phase 7;
40. gemma3-1b trained at full width and depth on one sequence of 8,192
    tokens a step (``EventDrivenTrainer.run``, in-proc, 1 rank, AdamW,
    bf16, remat "full", 2 steps): 52 flash launches a rank-step, all
    ``mma_bf16``, 26 backward recomputes a rank-step, all through the
    chunked vjp, no plain forward, finite losses, the peak; remat's effect
    on one bf16 ``value_and_grad`` ("none" twice, "dots", "full": each
    peak, equal losses, grads within the control's spread); the chunked
    backward against the dense one at S = 8,192 and 16,384, window 512 and
    none, float32, with each peak; and float32 sgdm runs of the kernel
    path against the chunked plain path at 6 layers (``PARITY_CUTS``, as
    phase 19's), phase 19's gate, which must reject the window mask moved
    one key inside the chunked path;
41. whisper-tiny at full width and depth (4 + 4 layers), bf16: for each
    of three prompts (100, 256, 384 tokens) over 1,500 seeded stub frames
    a prefill through ``make_prefill_step`` into a cache of 512 and 32
    greedy steps through ``make_serve_step`` (the serving engine serves
    decoder-only models alone), counted as in phase 5: 4 non-causal and 4
    causal ``mma_bf16`` launches a prefill, none a decode step, no plain
    call; the bf16 kernel path against the plain path (reported); then
    float32 prefills, kernel path against plain path, at the port's init
    and at one layer's fan-in (each gated unless the plain path's float64
    floor is above the gate), which must reject the encoder run causal
    and the cross K/V taken from the wrong layer, and the decode steps
    against one teacher-forced decode within the reference's 2e-4;
42. whisper-tiny trained through ``make_train_step`` (bf16, AdamW, remat
    "full", 4 steps of 4 sequences of 1,500 frames and 448 tokens): 16
    flash launches a step (8 not causal), all ``mma_bf16``, 8 dense
    backward recomputes, no plain call, finite losses near ln(vocab), each
    step's wall and the peak; then float32 sgdm runs of 3 steps, kernel
    path against plain path at phase 19's gate, which must reject a
    1.01 x plain attention scale;
43. mamba2-370m trained at full size (``EventDrivenTrainer.run``,
    in-proc, 2 ranks, AdamW, bf16, remat "full", 4 steps of 2 sequences
    of 4,096 tokens a rank): 96 SSD launches a rank-step (48 in the
    forward, 48 again in the remat recompute), all ``mma_bf16``, 48 plain
    recomputes a backward (``ops.backward_recomputes``), no other kernel
    and no plain call, finite losses near ln(vocab), bit-equal replicas;
    the step split as in phase 19; then float32 sgdm runs of 3 steps at
    512 tokens and 12 layers from Mamba-2's init of a_log and dt_bias,
    with stacked leaves at one layer's fan-in (at Mamba-2's init alone the
    plain path's float64 floor is above the gate), the plain path's float64
    floor first, then the kernel path (every SSD
    launch SIMT) against the plain path at phase 19's gate, which must
    reject the term between chunks dropped and the grads left unaveraged,
    and pass the chunk-by-chunk control;
44. the paper's MONC in-situ analytics (§VI) at its per-item sizes
    (``INSITU["paper"]`` of ``configs/edat_paper.py``: 1,024 items of
    4,096 float64 values a producer, 2 fields), every item's arithmetic
    on the card: for n_analytics 1, 2 and 4 (the paper's 1,024-16,384
    analytics cores cut to what one host holds as ranks, and n = 8 left
    out to make room for phase 45), the EDAT
    program and then the bespoke baseline in-proc, each with 1,024
    results, every ``_analyse`` call on cuda, and its totals held to a
    numpy recompute on the host from the same seeds (sums within 1e-12 x
    sum|x|, sums of squares within 1e-12 x sum x^2, min and max
    bit-equal; the bespoke baseline sums in arrival order, so its min and
    max within 1e-12 x the ranks' sum of |min| (|max|)), which must
    reject a rank's partial left out and an item's last value dropped
    beside its passing control; bandwidth, mean latency and, for EDAT,
    ``insights.analyze``'s findings; one socket session (4 ranks on 2
    spawned processes) with its wall split, the children's count of
    ``_analyse`` calls (all on cuda) and totals (the same gate) from the
    summary, the parent's count unmoved; and one profiled window of 64
    items on one analytics rank: device time and kernels an item against
    the host wall;
45. the paper's Graph500 BFS (§V): the Kronecker generator's kernel
    against its plain version (numpy's draws) over the whole array at
    scale 18 and against numpy's draws reached by ``advance`` on 1,000
    sampled edges at scale 25, a run one draw late failing both, timed
    (CUDA events, and profiler device ms, read in a fresh process where
    this one's profiler keeps no launch) beside its bound (its bytes, and
    its SASS instructions at the issue rate); at scale 20 the card's CSR
    and a 4-rank EDAT BFS against the CPU path on the same edges,
    ``default_root`` against the first vertex of nonzero degree, then one
    socket session (4 ranks on 2 processes, every expansion on cuda); then
    the paper's run at scale 25, edgefactor 16, seed 20, rooted by
    ``default_root``'s rule on the generated edges: generated and built on
    the card, ``EdatBFS`` and ``ReferenceBFS`` (BSP) at 1, 2, 4 and 8
    ranks (the paper's 384-30,720 cores cut to what one process holds as
    threads; one cold EDAT run first, at 1 rank, pins the host pool that
    every later run reuses), parents bit-equal, ``validate_bfs_tree``
    holding and rejecting a non-neighbour parent and a dropped parent
    beside its control, totals equal across rank counts, TEPS of both,
    one 1-rank run stepped level by level under the profiler (device ms
    against host wall), host bytes and peaks;
46. the port's own command lines (``repro_torch.launch``), in process
    through their ``main(argv)``: the serve CLI at gemma3-1b's full width
    and depth (4 prompts of 384 seeded tokens, 16 new tokens each: 26
    ``mma_bf16`` flash launches for the prefill, none in decode, the
    parameters on cuda, the tokens (4, 16) inside the vocabulary), the
    train CLI's 3 AdamW steps of 2 x 512 tokens (52 ``mma_bf16`` launches
    a step, forward and remat recompute; finite losses), then the
    dry-run's cell of the train CLI's own shape on a (1, 1) mesh, whose
    parameter and optimizer-state bytes must equal the growth of the
    card's requested bytes across the CLI's parameter and state creation
    within 512 bytes a tensor, and ``memory_allocated``'s growth within
    the caching allocator's block rounding (512 bytes a tensor, and up to
    1 MiB more a tensor over 1 MiB, whose block it may leave unsplit), and
    the step's achieved FLOP/s from the dry-run's plain-path FLOPs (masked
    tiles included) over the measured step wall (printed, not gated).

Every phase starts with the card's memory freed and prints its peak
(``torch.cuda.max_memory_allocated``).

It prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as
its last line; ``--json PATH`` also writes every number to PATH.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

FA_SOURCE = "src/repro_torch/csrc/flash_attention_fwd.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:86"
# (S, H, KH, D, window, softcap, dtype): the reference's FA_CASES
# (tests/test_kernels.py), then ragged tails the TPU kernel does not take
FA_CASES = [
    (256, 4, 4, 64, None, None, "float32"),
    (256, 4, 1, 64, None, None, "float32"),
    (512, 8, 2, 64, None, None, "bfloat16"),
    (512, 4, 4, 128, 128, None, "float32"),
    (256, 4, 2, 128, None, 50.0, "float32"),
    (384, 6, 6, 64, None, None, "float32"),
    (512, 2, 1, 256, 256, None, "bfloat16"),
    (100, 4, 2, 32, None, None, "float32"),
    (300, 4, 2, 32, None, None, "float32"),
]
# the serving path's shapes: gemma3-1b prefill, B=1, 4 heads, 1 KV head,
# head dim 256, bf16; local layers window 512, global layers none; given in
# the model's (B, S, H, D) layout as the path gives them
PATH_S = (100, 256, 384, 511)
PATH_WINDOWS = (512, None)
TIMED = (511, 512)        # the shape whose times stand in the kernels line
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the device function of each flash kernel variant, as the profiler names
# it (neither name holds the other)
FA_ENTRY = {"mma_bf16": "fa_mma_bf16_kernel", "simt": "fa_fwd_kernel"}
# the variant each dtype takes on every path, flash attention's and the SSD
# scan's alike (the paths' tensors are 16-byte aligned)
PATH_VARIANT = {"bfloat16": "mma_bf16", "float32": "simt"}

SSD_SOURCE = "src/repro_torch/csrc/ssd_fwd.cu"
SSD_REPLACES = "src/repro/kernels/ssd/kernel.py:68"
# (B, T, H, G, N, P, chunk, dtype, init_state): the reference's SSD_CASES
# (tests/test_kernels.py), ragged tails and nonzero initial states the TPU
# kernel does not take
SSD_CASES = [
    (2, 256, 4, 1, 32, 32, 64, "float32", False),
    (2, 256, 8, 2, 64, 64, 128, "float32", False),
    (2, 128, 2, 2, 16, 64, 32, "float32", False),
    (2, 256, 4, 1, 128, 64, 128, "bfloat16", False),
    (2, 100, 4, 2, 32, 32, 128, "float32", True),
    (2, 300, 4, 2, 32, 32, 128, "float32", True),
    (2, 300, 8, 1, 128, 64, 128, "bfloat16", True),
]
# the serving path's shapes: mamba2-370m prefill, B=1, 32 heads of 64, one
# group, state 128, chunk 128, bf16 x/b/c as views of the conv output, and
# an initial state (prefill passes the cache's, zeros on a fresh cache;
# here a random one)
SSD_PATH_T = (100, 256, 384, 511)
SSD_TIMED_T = 511
# |kernel - plain| <= SSD_TOL * max|plain| in every case, bf16 inputs too:
# both read the same values (bf16 widens to float32 exactly) and both
# compute in float32, so no bf16 rounding separates them; float32 sums of a
# chunk of products cancel in places, so their rounding scales with the
# output's largest magnitude
SSD_TOL = 1e-4
# the device function of each SSD kernel variant, as the profiler names it
# (neither name holds the other)
SSD_ENTRY = {"mma_bf16": "ssd_mma_bf16_kernel", "simt": "ssd_fwd_kernel"}

GEMMA, MAMBA, RGEMMA = "gemma3-1b", "mamba2-370m", "recurrentgemma-9b"
# the training path's shapes (phase 43): mamba2-370m, B=2 sequences a rank,
# no initial state, T = 512 (the float32 parity runs) and 4,096 (the bf16
# run, the reference's train_4k), bf16 through the tensor cores and float32
# through SIMT
SSD_TRAIN_PATH = f"{MAMBA}-train"
SSD_TRAIN_T = (512, 4096)
# the SSD gradient check: the grads of L = sum(w * y), w seeded, through
# the kernel path (``ops.ssd``: the kernel forward, the plain scan
# recomputed under autograd in the backward) against the plain scan's own
# autograd, on the same inputs.  L is linear in y, so both backwards get
# the same upstream w and run the same plain scan on the same inputs: the
# grads never see the kernel's output, and each must equal its plain grad
# bit for bit, in its input's dtype.  The check covers the backward's
# wiring (the saved inputs, the grads' dtypes, the recompute counted), not
# the kernel, which the forward rows hold to SSD_TOL
# the kernel each kind of layer launches once a prefill
KIND_KERNEL = {"attn": "flash_attention_fwd", "local": "flash_attention_fwd",
               "mla": "flash_attention_fwd", "ssd": "ssd_fwd",
               "rglru": "rglru_fwd"}
MAX_LEN = 512             # = gemma3-1b's window: no prompt outgrows a cache
PREFILL_S = (100, 256, 511)
LOGIT_TOL = 1e-3          # float32 kernel path vs plain path, last logits
FLOOR_FACTOR = 4          # ... or this many plain-path noise floors (SSD)
# faults planted in the plain SSD scan, run chunk by chunk: the c.S_prev
# term between chunks dropped, the state carried between chunks in bf16,
# x/b/c read as bf16; and the control, the same chunk-by-chunk run with no
# fault.  Each check must pass the control and reject the faults named
# here: phase 8's kernel check (bf16 inputs already) the first two; phase
# 9's float32 logit gate bf16 inputs, and with Mamba-2's init (below) the
# dropped term too.  The reference's init forgets within a few steps, so
# no logit gate sees a fault between chunks there; a bf16 state moves the
# logits too little for one at either init.  Phase 9 reports the rest.
SSD_CONTROL = "chunkwise"
SSD_FAULTS = ("no_inter_chunk", "bf16_state", "bf16_inputs")
KERNEL_FAULTS = ("no_inter_chunk", "bf16_state")
LOGIT_FAULTS = {"seeded": ("bf16_inputs",),
                "mamba2_init": ("no_inter_chunk", "bf16_inputs")}
# phase 8's long-memory case: dt = softplus(randn + DT_SHIFT), ~0.02, so
# the state carries across chunks; phase 9's second float32 weight set
# draws a_log and dt_bias as Mamba-2's published init does (A uniform in
# [1, 16], dt log-uniform in [1e-3, 1e-1]) for the same reason
DT_SHIFT = -4.0
NEAR_TIE = 1e-3           # a differing token is a near-tie below this gap

# the serving path's flash shapes on recurrentgemma-9b's 12 local layers:
# B=1, 16 heads, 1 KV head, head dim 256, window 2048, bf16
RG_FA_SHAPE = dict(H=16, KH=1, D=256, window=2048)

GEMMA2 = "gemma2-2b"
# the serving path's flash shapes on gemma2-2b's 26 layers: B=1, 8 heads, 4
# KV heads (GQA group 2), head dim 256, softcap 50, bf16; window 4096 on its
# 13 local layers (past MAX_LEN, so here it masks no key), none on the 13
# global ones
GEMMA2_FA_SHAPE = dict(H=8, KH=4, D=256, softcap=50.0)
GEMMA2_WINDOWS = (4096, None)
# a softcapped row's library call: SDPA takes no softcap, so it is timed
# beside the row as library_nocap_ms, another function
CAP_LIBRARY = "torch.compile(flex_attention), tanh softcap as score_mod"
# faults planted in phase 24's plain path (gemma2-2b): the attention softcap
# dropped, the final softcap dropped, and query head h reading KV head
# h % KH in place of h // (H / KH); the control expands K/V to the H query
# heads by the right map (h // (H / KH)) through the same wrapper.  The
# control must pass every gated float32 run, and each fault must fail the
# gate in at least one gated weight set.  Phase 24's float32 weight sets
# are the port's init and "layer_fan_in" (see _layer_fan_in), whose pre-cap
# attention logits lie deep in the cap's flat tail and in its linear part
# (phase 24 prints their share past SOFTCAP_BEND, where tanh(x / 50)
# bends); a float32 run is gated unless the plain path's own float32 floor
# (plain_f64_floor: its attention in float64) is above LOGIT_TOL at some S,
# and then it is reported
GEMMA2_CONTROL = "kv_expanded"
GEMMA2_FAULTS = ("no_attn_softcap", "no_final_softcap", "gqa_mod")
SOFTCAP_BEND = GEMMA2_FA_SHAPE["softcap"] / 2

GRANITE = "granite-moe-1b-a400m"
# the serving path's flash shapes on granite-moe-1b-a400m's 24 global
# layers: B=1, 16 heads, 8 KV heads (GQA group 2), head dim 64, bf16
GRANITE_FA_SHAPE = dict(H=16, KH=8, D=64, window=None)
# phase 20's 4-slot decode step runs from the caches of prefills of these
# lengths (the last reaches position 511 of MAX_LEN)
DECODE_S = (100, 256, 384, 511)
# faults planted in phase 22's replay engine (its MoE layers): the top-k
# weights left unnormalised, and the capacity ignored (C = T: nothing
# dropped); the gate must reject both and pass the fault-free control
MOE_FAULTS = ("unnormalised_weights", "no_capacity")

STABLELM = "stablelm-1.6b"
# the serving path's flash shapes on stablelm-1.6b's 24 global layers: B=1,
# 32 heads, 32 KV heads (MHA: GQA group 1), head dim 64, no window, no
# softcap, bf16
STABLELM_FA_SHAPE = dict(H=32, KH=32, D=64, window=None)
# faults planted in phase 28's plain path (stablelm-1.6b), chosen for MHA,
# where gqa_mod's h % KH is the right head: query head h reading KV head
# (h + 1) % KH, each query also seeing the key one position after it, and
# the rotary turning all 64 dims of a head, not the leading 16
# (rope_fraction 0.25).  The control is gemma2-2b's, K/V expanded to the
# query heads by the right map (the identity at group 1).  The control must
# pass every gated float32 run; each fault must fail the gate at every
# length of the "layer_fan_in" set, and is reported at the port's init
STABLELM_CONTROL = GEMMA2_CONTROL
STABLELM_FAULTS = ("kv_head_shift", "causal_shift", "full_rotary")

STARCODER2 = "starcoder2-15b"
# the serving path's flash shapes on starcoder2-15b's 40 local layers: B=1,
# 48 heads, 4 KV heads (GQA group 12), head dim 128, window 4096, no
# softcap, bf16.  No served prompt reaches the window (MAX_LEN is 512), so
# phase 3 adds one row at WINDOW_S tokens, where the window masks keys for
# the last WINDOW_S - 4096 queries and the kernel skips their dead tiles
STARCODER2_FA_SHAPE = dict(H=48, KH=4, D=128, window=4096)
WINDOW_S = 4608
# faults planted in phase 32's plain path (starcoder2-15b): query head h
# reading KV head h % KH in place of h // 12, the next KV head, and each
# query also seeing the key one position after it.  The control is
# gemma2-2b's.  The control must pass every gated float32 run; each fault
# must fail the gate at every length of the "layer_fan_in" set, and is
# reported at the port's init
STARCODER2_CONTROL = GEMMA2_CONTROL
STARCODER2_FAULTS = ("gqa_mod", "kv_head_shift", "causal_shift")
# phase 32's window check (``_window_check``): the model at full width and
# WINDOW_LAYERS layers, one cache-free forward of WINDOW_S tokens through
# the kernel against the same through plain attention, compared over the
# logits of the last WINDOW_TAIL positions (those whose window masks keys).
# The float32 gate must pass the control and reject the window dropped from
# the plain attention (WINDOW_FAULT)
WINDOW_LAYERS = 4
WINDOW_TAIL = WINDOW_S - STARCODER2_FA_SHAPE["window"]
WINDOW_FAULT = "no_window"

DEEPSEEK = "deepseek-v3-671b"
# the card holds deepseek-v3-671b cut in depth: its first 4 layers (the 3
# dense ones and 1 MoE layer, so first_dense = 3 stands) and no MTP head,
# which serving never reads: 15.11e9 parameters, 30.2 GB in bf16 and 60.4
# GB in float32 (with MTP's layer, 106.9 GB).  Every width is the config's
CUTS = {DEEPSEEK: dict(n_layers=4, mtp_depth=0)}
# the serving path's flash shapes on deepseek-v3-671b's MLA layers: B=1,
# 128 heads, K and V materialised per head from the latent (KH = H), q/k
# head dim 192 (128 nope + 64 rope), v head dim 128, no window, no softcap
DEEPSEEK_FA_SHAPE = dict(H=128, KH=128, D=192, Dv=128, window=None)
# faults planted in phase 36's plain path (deepseek-v3-671b's absorbed MLA,
# ``attention.mla_absorbed``): the logits scaled by v's head dim (128^-0.5)
# in place of q/k's (192^-0.5), k_rope cached unrotated, and each query
# also seeing the key one position after it.  The control attends over the
# same cache un-absorbed: per-head K and V materialised from the latent
# through the plain GQA attention, the same function rounded elsewhere.
# The control must pass every gated float32 run; each fault must fail the
# gate at every length of every gated weight set
DEEPSEEK_CONTROL = "mla_expanded"
DEEPSEEK_FAULTS = ("v_dim_scale", "k_rope_unrotated", "causal_shift")

WHISPER = "whisper-tiny"
# the encoder's flash shape (B=1, 6 heads, 6 KV heads of 64, no window, not
# causal) at whisper's 1,500 frames, one length below it and the 4,096
# frames of the reference's train_4k cell, in both dtypes (phase 3); the
# decoder's self-attention is causal at the same heads
WHISPER_FA_SHAPE = dict(H=6, KH=6, D=64, window=None, softcap=None)
WHISPER_ENC_S = (100, 1500, 4096)
# faults planted in phase 3's non-causal rows, in the plain version the
# kernel is held to: the causal mask on a non-causal call, and the last
# key (of the ragged tail, where S is not a multiple of 64) dropped; each
# must fail the gate on every non-causal row (``_fa_limit``)
NONCAUSAL_FAULTS = ("causal_mask", "last_key_dropped")
# faults planted in phases 41's plain path (``encdec_fault``): the encoder
# run causal, and each decoder layer's cross K/V taken from the layer
# before; each must fail the float32 gate at every prompt length of every
# gated weight set
ENCDEC_FAULTS = ("encoder_causal", "cross_kv_layer_shift")

RG_SOURCE = "src/repro_torch/csrc/rglru_fwd.cu"
RG_REPLACES = "src/repro/kernels/rglru/kernel.py:59"
# (B, T, W, h0, lam): the reference's RG_CASES (tests/test_kernels.py, drawn
# at B=2: x normal, r and i sigmoids of normals, lam = |normal| + 0.2), then
# ragged T with an initial state, which the TPU kernel does not take
RG_CASES = [(2, 128, 128, False, "test"), (2, 256, 256, False, "test"),
            (2, 128, 512, False, "test"), (2, 512, 128, False, "test"),
            (2, 1, 256, True, "test"), (2, 39, 256, True, "test"),
            (2, 100, 256, True, "test")]
# the serving path's shapes: recurrentgemma-9b prefill, B=1, width 4096,
# float32 x/r/i, an initial state (prefill passes the cache's); and
# RG_LONG_T, past max_len, where the kernel's blocks walk five spans
RG_PATH_T = (100, 256, 384, 511)
RG_TIMED_T = 511
RG_LONG_T = 1100
# |kernel - plain| <= RG_TOL * (1 + |plain|): the reference's rtol = atol
RG_TOL = 2e-4
# faults planted in the plain RG-LRU scan: h rounded to bf16 at every step,
# h0 ignored, the carry reset every RG_PIECE steps, the carry dropped once
# at the kernel's first span boundary (reset_once, where T is past it); the
# control runs the scan in pieces of RG_PIECE steps carrying h, with no
# fault.  Phase 13's check must pass the control and reject every fault at
# T = RG_TIMED_T and RG_LONG_T; phase 14's float32 logit gate must pass the
# control and reject the faults named in RG_LOGIT_FAULTS (prefill starts
# from h0 = 0, so no_h0 does not apply there, and no prefill is past a span)
RG_PIECE = 128
RG_CONTROL = "pieces"
RG_FAULTS = ("bf16_carry", "no_h0", "reset_128", "reset_once")
RG_LOGIT_FAULTS = ("bf16_carry", "reset_128")
# phase 14 runs recurrentgemma-9b at the port's init in bf16 only,
# reported: that init (the reference's rule: a stacked leaf's fan-in is its
# layers axis) saturates the gates, and where r ~ 0 the scan's
# 1 - exp(2 log_a) is a few ulps, so float32 rounding alone moves the
# logits by O(1) through 38 layers.  Its float32 sets are "layer_fan_in"
# (the same draw with every stacked leaf scaled to one layer's fan-in) and
# Griffin's lam on top of it, each gated at LOGIT_TOL
# phase 13's long-memory case and phase 14's second float32 weight set draw
# lam as Griffin's init does (arXiv:2402.19427): a = exp(-8 softplus(lam))
# uniform in [0.9, 0.999], so the state carries across pieces
GRIFFIN_A = (0.9, 0.999)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def kernel_device_ms(fn, entry, event_ms=None, iters=20, warmup=3,
                     lead=10, tries=5):
    """Mean device milliseconds of one launch of the kernel whose name
    holds ``entry`` (``fn`` launches it once a call), how many of the
    window's launches the profiler recorded, and for every window profiled
    [launches of ``entry``, device events] it recorded, from
    ``torch.profiler``'s device events: the kernel's own time, without the
    host's time between launches (which CUDA events around back-to-back
    calls include when a call's host work outlasts its kernel).  The
    profiler can miss the first launches of a window, so each window
    opens with ``lead`` launches that are not counted, and the mean is over
    the last ``iters`` launches it recorded; a window that recorded fewer
    than ``iters`` is profiled again, up to ``tries`` times (a window may
    come back with no device event at all: the profiler dropped it).  With
    ``event_ms`` (``cuda_ms`` of the same calls) a window whose device time
    is under half of it is flagged in a printed line: there the host's work
    between launches, not the kernel, set the event time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    counts, device_events = [], []
    for _ in range(tries):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead + iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in events if entry in e.name)
        counts.append(len(spans))
        device_events.append(len(events))
        if iters <= len(spans) <= lead + iters:
            windows = [list(w) for w in zip(counts, device_events)]
            ms = sum(t1 - t0 for t0, t1 in spans[-iters:]) / 1e3 / iters
            if event_ms is not None and ms < event_ms / 2:
                log(f"kernel_device_ms FLAG {entry}: device {ms:.5f} ms is "
                    f"under half the event time {event_ms:.5f} ms (the "
                    f"host's work between launches set the event time)")
            return ms, len(spans), windows
    raise AssertionError(f"profiled {counts} launches of {entry} in "
                         f"windows of {lead + iters} calls, not {iters} or "
                         f"more ({device_events} device events a window)")


def fa_bound(B, H, KH, S, D, window, dtype, Dv=None, causal=True):
    """Least time for one attention call: each input read once and the
    output written once over the memory rate, against the products over
    the live (q, k) pairs (causal: each query's keys up to its own, inside
    the window; not causal: all S x S) over the peak rate of the dtype.  q
    and k have head dim D, v and the output Dv (D where None)."""
    Dv = D if Dv is None else Dv
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = (B * H * S * (D + Dv) + B * KH * S * (D + Dv)) * elem
    w = window or S
    pairs = (sum(min(i + 1, w) for i in range(S)) if causal
             else S * S if window is None
             else sum(S - max(i - w + 1, 0) for i in range(S)))
    flops = 2 * B * H * pairs * (D + Dv)   # q.k and p.v, 2 flops a MAC
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ------------------------------------------------------------------ phases
def phase_env(out):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out["card"] = card
    out["torch"] = torch.__version__
    out["cuda"] = torch.version.cuda


def _ptxas_summary(text):
    """(kernel, registers, spill bytes) per compiled entry of a build log."""
    import re
    rows, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append({"entry": name, "registers": int(m.group(1)),
                         "spill_store_bytes": spills})
            name = None
    return rows


def phase_build(out):
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    secs = _build.build_all()
    for name, text in _build.build_log.items():
        log(f"-- nvcc {name}.cu\n{text.strip()}")
    log(f"build: {secs:.1f} s for {list(_build.SOURCES)}")
    ptxas = {n: _ptxas_summary(t) for n, t in _build.build_log.items()}
    smem = {v: ssd_ops.smem_bytes(128, 64, 128, kernel=v)
            for v in ssd_ops.VARIANTS}
    log("ssd_fwd ptxas " + json.dumps({
        "kernels": ptxas.get("ssd_fwd"),
        "dynamic_smem_bytes_at_N128_P64_chunk128": smem}))
    log("rglru_fwd ptxas " + json.dumps({"kernels": ptxas.get("rglru_fwd")}))
    log("kronecker_gen ptxas " + json.dumps(
        {"kernels": ptxas.get("kronecker_gen")}))
    fa_smem = {f"{D},{Dv}": fa_ops.mma_smem_bytes(D, Dv)
               for D, Dv in fa_ops.HEAD_DIM_PAIRS}
    log("flash_attention_fwd ptxas " + json.dumps({
        "kernels": ptxas.get("flash_attention_fwd"),
        "mma_bf16_dynamic_smem_bytes_by_D_Dv": fa_smem}))
    out["build_s"] = secs
    out["ptxas"] = ptxas
    out["ssd_smem_bytes"] = smem
    out["fa_mma_smem_bytes"] = fa_smem
    mma = [r for r in ptxas.get("ssd_fwd") or []
           if SSD_ENTRY["mma_bf16"] in r["entry"]]
    if ptxas.get("ssd_fwd") is not None and (
            len(mma) != 1 or mma[0]["spill_store_bytes"]):
        raise AssertionError(f"the tensor-core SSD kernel is missing from "
                             f"the build log or spills: {mma}")
    kg = ptxas.get("kronecker_gen")
    if kg is not None and (not kg or any(r["spill_store_bytes"]
                                         for r in kg)):
        raise AssertionError(f"the Kronecker kernel is missing from the "
                             f"build log or spills: {kg}")
    rg = ptxas.get("rglru_fwd")
    if rg is not None and (not rg or any(r["spill_store_bytes"]
                                         for r in rg)):
        raise AssertionError(f"an RG-LRU kernel is missing from the build "
                             f"log or spills: {rg}")
    # one tensor-core flash kernel a (D, Dv) pair, none spilling
    fa = [r for r in ptxas.get("flash_attention_fwd") or []
          if FA_ENTRY["mma_bf16"] in r["entry"]]
    if ptxas.get("flash_attention_fwd") is not None and (
            len(fa) != len(fa_ops.HEAD_DIM_PAIRS)
            or any(r["spill_store_bytes"] for r in fa)):
        raise AssertionError(f"a tensor-core flash kernel is missing from "
                             f"the build log or spills: {fa}")


def _fa_inputs(S, H, KH, D, Dv, dtype, B, seed, model_layout):
    """q, k as (B, H|KH, S, D) and v as (B, KH, S, Dv): contiguous, or
    (``model_layout``) as the serving path hands them over, transposed
    views of (B, S, H, D)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    shapes = ((H, D), (KH, D), (KH, Dv))
    if model_layout:
        return [torch.randn((B, S, h, d), generator=g, device="cuda").to(dt)
                .transpose(1, 2) for h, d in shapes]
    return [torch.randn((B, h, S, d), generator=g, device="cuda").to(dt)
            for h, d in shapes]


def _sdpa(q, k, v, *, scale, window, causal=True):
    """``scaled_dot_product_attention`` with an explicit causal/window
    mask (not causal and no window: no mask at all): the library
    yardstick, timed here and used nowhere in the port."""
    import torch
    import torch.nn.functional as F
    S = q.shape[2]
    if not causal and window is None:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale, enable_gqa=True)
    i = torch.arange(S, device=q.device)
    mask = (i[None, :] <= i[:, None] if causal
            else torch.ones((S, S), dtype=torch.bool, device=q.device))
    if window is not None:
        mask &= (i[:, None] - i[None, :]) < window
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


def _fa_limit(plain, tol, causal):
    """The flash gate's limit on |kernel - plain|, elementwise: tol x (1 +
    |plain|) for a causal row; tol x max|plain| for a non-causal one,
    whose outputs average over all S keys and so are ~sqrt(e / S) in size
    on N(0, 1) inputs (0.026 at 4,096 keys), where tol x (1 + |plain|)
    would be as large as a typical output and pass a dropped key."""
    plain = plain.float().abs()
    return tol + tol * plain if causal else tol * plain.max()


def _last_key_dropped(q, k, v, *, scale, **_):
    """The plain version of a non-causal call with the last key dropped
    (NONCAUSAL_FAULTS): every query's softmax over keys 0 .. S-2, as
    ``ref.attention_ref`` rounds it (float32 logits, p in v's dtype)."""
    import torch
    B, H, S, D = q.shape
    KH = k.shape[1]
    qr = q.reshape(B, KH, H // KH, S, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qr.float(),
                     k[:, :, :-1].float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype), v[:, :, :-1])
    return out.reshape(B, H, S, v.shape[-1])


_flex_compiled = {}     # the last compile of ``_flex``, by its key


def _flex(q, k, v, *, scale, window, softcap):
    """One call of ``flex_attention``, compiled for these inputs, with the
    tanh softcap as its score_mod (on the scaled scores, before the mask,
    as the plain version caps them) and the causal/window mask as its
    block mask: the library yardstick of a softcapped row, timed here and
    used nowhere in the port.  A window of S keys or more masks nothing,
    so such a row is the same function as the unwindowed row of its shape
    and takes that row's compile: each shape compiles once (since PR 38;
    before, each of gemma2-2b's 8 rows compiled its own)."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    S = q.shape[2]
    if window is not None and window >= S:
        window = None
    key = (tuple(q.shape), tuple(k.shape), q.dtype, window, softcap, scale)
    if key not in _flex_compiled:
        def score_mod(s, b, h, qi, ki):
            return softcap * torch.tanh(s / softcap)

        def mask_mod(b, h, qi, ki):
            keep = ki <= qi
            if window is not None:
                keep = keep & (qi - ki < window)
            return keep
        mask = create_block_mask(mask_mod, None, None, S, S,
                                 device=q.device)
        _flex_compiled.clear()
        torch._dynamo.reset()       # each shape compiles its own
        _flex_compiled[key] = (torch.compile(flex_attention, dynamic=False),
                               mask, score_mod)
    call, mask, score_mod = _flex_compiled[key]
    # the attention kernel at every S (below 128 query rows, flex would
    # pick its decoding kernel, which builds no config at D=256 with GQA)
    return lambda: call(q, k, v, score_mod=score_mod, block_mask=mask,
                        scale=scale, enable_gqa=True,
                        kernel_options={"FORCE_USE_FLEX_ATTENTION": True})


def phase_kernels(out):
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    cases = [dict(S=S, H=H, KH=KH, D=D, window=w, softcap=c, dtype=dt, B=2)
             for (S, H, KH, D, w, c, dt) in FA_CASES]
    cases += [dict(S=S, H=4, KH=1, D=256, window=w, softcap=None,
                   dtype="bfloat16", B=1, path=GEMMA)
              for S in PATH_S for w in PATH_WINDOWS]
    cases += [dict(S=S, softcap=None, dtype="bfloat16", B=1, path=RGEMMA,
                   **RG_FA_SHAPE) for S in PATH_S]
    cases += [dict(S=S, softcap=None, dtype="bfloat16", B=1, path=GRANITE,
                   **GRANITE_FA_SHAPE) for S in PATH_S]
    cases += [dict(S=S, window=w, dtype="bfloat16", B=1, path=GEMMA2,
                   **GEMMA2_FA_SHAPE) for S in PATH_S for w in GEMMA2_WINDOWS]
    cases += [dict(S=S, softcap=None, dtype="bfloat16", B=1, path=STABLELM,
                   **STABLELM_FA_SHAPE) for S in PATH_S]
    cases += [dict(S=S, softcap=None, dtype="bfloat16", B=1,
                   path=STARCODER2, **STARCODER2_FA_SHAPE)
              for S in PATH_S + (WINDOW_S,)]
    cases += [dict(S=S, softcap=None, dtype="bfloat16", B=1, path=DEEPSEEK,
                   **DEEPSEEK_FA_SHAPE) for S in PATH_S]
    # the same shape in float32 (the SIMT kernel, phase 36's float32
    # prefills), and reduced MLA's head dims (48, 32) in both dtypes
    cases += [dict(S=S, softcap=None, dtype="float32", B=1,
                   **DEEPSEEK_FA_SHAPE) for S in (PATH_S[0], PATH_S[-1])]
    cases += [dict(S=S, H=4, KH=4, D=48, Dv=32, window=None, softcap=None,
                   dtype=dt, B=2) for S in (100, 300)
              for dt in ("float32", "bfloat16")]
    # the training forward's calls (phase 19): each rank's 2 x 512 tokens
    cases += [dict(S=TRAIN_DATA["seq"], H=4, KH=1, D=256, window=w,
                   softcap=None, dtype="bfloat16",
                   B=TRAIN_DATA["global_batch"] // TRAIN_RANKS,
                   path=f"{GEMMA}-train") for w in PATH_WINDOWS]
    # ... and phase 40's: one sequence of 8,192 tokens
    cases += [dict(S=LONG_TRAIN_DATA["seq"], H=4, KH=1, D=256, window=w,
                   softcap=None, dtype="bfloat16", B=1, path=LONG_TRAIN_PATH)
              for w in PATH_WINDOWS]
    # whisper-tiny's encoder (phases 41, 42): not causal, in bf16 (the
    # served and trained paths) and float32 (the gates), each with the
    # faults NONCAUSAL_FAULTS planted in the plain version; its decoder's
    # causal prefill at the served prompts; and the training step's
    # calls, 4 sequences of 1,500 frames and of 448 tokens
    cases += [dict(S=S, dtype=dt, B=1, path=WHISPER, causal=False,
                   **WHISPER_FA_SHAPE)
              for dt in ("bfloat16", "float32") for S in WHISPER_ENC_S]
    cases += [dict(S=S, dtype="bfloat16", B=1, path=WHISPER,
                   **WHISPER_FA_SHAPE) for S in WHISPER_PROMPTS]
    cases += [dict(S=S, dtype="bfloat16", path=f"{WHISPER}-train",
                   causal=causal, B=WHISPER_TRAIN_DATA["global_batch"],
                   **WHISPER_FA_SHAPE)
              for S, causal in ((WHISPER_FRAMES, False),
                                (WHISPER_TRAIN_DATA["seq"], True))]
    rows = []
    for n, c in enumerate(cases):
        c.setdefault("Dv", c["D"])
        q, k, v = _fa_inputs(c["S"], c["H"], c["KH"], c["D"], c["Dv"],
                             c["dtype"], c["B"], seed=n,
                             model_layout=c.get("path", False))
        causal = c.get("causal", True)
        kw = dict(scale=c["D"] ** -0.5, causal=causal, window=c["window"],
                  softcap=c["softcap"])
        before = dict(ops.launches_by_variant)
        got = ops.flash_attention_fwd(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        ran = [v2 for v2, n2 in ops.launches_by_variant.items()
               if n2 != before[v2]]
        tol = TOL[c["dtype"]]

        limit = _fa_limit(want, tol, causal)

        def within(t):
            err = (t.float() - want.float()).abs()
            return float(err.max()), bool((err <= limit).all())

        err, ok = within(got)
        row = {k2: c[k2] for k2 in ("B", "S", "H", "KH", "D", "Dv",
                                    "window", "softcap", "dtype")}
        row["causal"] = causal
        if not causal:
            # the gate must reject the kernel held to a faulty plain version
            faulty = {"causal_mask": lambda: ref.attention_ref(
                          q, k, v, **dict(kw, causal=True)),
                      "last_key_dropped": lambda: _last_key_dropped(
                          q, k, v, **kw)}
            planted = {}
            for f in NONCAUSAL_FAULTS:
                wf = faulty[f]()
                e = (got.float() - wf.float()).abs()
                planted[f] = {"max_abs_err": float(e.max()),
                              "rejected": not bool(
                                  (e <= _fa_limit(wf, tol, False)).all())}
            row["planted_faults"] = planted
            row["limit"] = float(limit)
        # every case here is aligned: bf16 takes the tensor cores
        row.update(variant=ran[0] if len(ran) == 1 else ran,
                   max_abs_err=err, tol=tol,
                   ok=ok and ran == [PATH_VARIANT[c["dtype"]]],
                   path=c.get("path", False))   # False, or the path's arch
        if row["path"]:
            # the SIMT kernel on the same inputs, held to the same gate
            simt = ops._launch("simt", q, k, v, out=None, **kw)
            row["simt_max_abs_err"], simt_ok = within(simt)
            row["ok"] = row["ok"] and simt_ok
            for key, v2 in (("", PATH_VARIANT[c["dtype"]]),
                            ("simt_", "simt")):
                row[key + "ms"] = cuda_ms(lambda: ops._launch(
                    v2, q, k, v, out=None, **kw))
                (row[key + "device_ms"],
                 row[key + "device_launches_recorded"],
                 row[key + "device_windows"]) = kernel_device_ms(
                    lambda: ops._launch(v2, q, k, v, out=None, **kw),
                    FA_ENTRY[v2], event_ms=row[key + "ms"])
            row["plain_ms"] = cuda_ms(lambda: ref.attention_ref(q, k, v,
                                                                **kw))
            sdpa = _sdpa(q, k, v, scale=kw["scale"], window=c["window"],
                         causal=causal)
            library = sdpa
            if c["softcap"] is not None:
                library = _flex(q, k, v, scale=kw["scale"],
                                window=c["window"], softcap=c["softcap"])
                row.update(library=CAP_LIBRARY,
                           library_nocap_ms=cuda_ms(sdpa))
                # the path's kernel on the same inputs without the cap: what
                # the softcap costs it
                nocap = dict(kw, softcap=None)
                row["nocap_device_ms"], *_ = kernel_device_ms(
                    lambda: ops._launch(PATH_VARIANT[c["dtype"]], q, k, v,
                                        out=None, **nocap),
                    FA_ENTRY[PATH_VARIANT[c["dtype"]]])
            # the yardstick is held to the plain version at the same gate
            row["library_max_abs_err"], library_ok = within(library())
            row["ok"] = row["ok"] and library_ok
            row["library_ms"] = cuda_ms(library)
            row.update(fa_bound(c["B"], c["H"], c["KH"], c["S"], c["D"],
                                c["window"], c["dtype"], c["Dv"], causal))
        log("flash_attention_fwd " + json.dumps(row))
        rows.append(row)
    _flex_compiled.clear()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with plain version: {bad}")
    # each planted fault fails the gate on every non-causal row
    missed = [(f, r["dtype"], r["B"], r["S"]) for f in NONCAUSAL_FAULTS
              for r in rows if not r["causal"]
              and not r["planted_faults"][f]["rejected"]]
    log("flash_attention_fwd noncausal_faults " + json.dumps({
        f: {dt: [(r["B"], r["S"]) for r in rows if not r["causal"]
                 and r["dtype"] == dt and r["planted_faults"][f]["rejected"]]
            for dt in TOL} for f in NONCAUSAL_FAULTS}))
    if missed:
        raise AssertionError(f"the non-causal gate does not reject the "
                             f"planted faults (fault, dtype, B, S): "
                             f"{missed}")
    out["flash_attention_cases"] = rows


def _all_ops():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru import ops as rglru
    from repro_torch.kernels.ssd import ops as ssd
    return {"flash_attention_fwd": fa, "ssd_fwd": ssd, "rglru_fwd": rglru}


def path_kernels(cfg):
    """{kernel: the model's layers that launch it once a prefill}."""
    counts = {}
    for kind in cfg.layer_kinds():
        counts[KIND_KERNEL[kind]] = counts.get(KIND_KERNEL[kind], 0) + 1
    return counts


def _counts():
    """(kernel launches, plain calls) of every wrapper, now."""
    from repro_torch.kernels import launch_counts
    return launch_counts()


def _since(before):
    """Kernel launches and plain calls of each wrapper since ``before``,
    leaving out the wrappers with none."""
    now = _counts()
    launched = {k: now[k][0] - before[k][0] for k in now}
    plain = {k: now[k][1] - before[k][1] for k in now}
    return ({k: n for k, n in launched.items() if n},
            {k: n for k, n in plain.items() if n})


def _fa_variants():
    """The flash kernel's launches in this process by variant, now."""
    from repro_torch.kernels import variant_counts
    return variant_counts()["flash_attention_fwd"]


def _fa_variants_since(before):
    now = _fa_variants()
    return {v: now[v] - before[v] for v in now}


def _check_float32_simt(by_variant, what):
    """Every float32 flash launch of ``what`` took the SIMT kernel."""
    log(f"{what} flash_launches_by_variant " + json.dumps(by_variant))
    if by_variant["mma_bf16"]:
        raise AssertionError(f"{what}: float32 launched the tensor-core "
                             f"flash kernel: {by_variant}")


def _free():
    """Collect dropped engines and models (the serving runtime holds them
    in reference cycles) and return their memory to the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _cfg(arch):
    """``arch``'s config as the card holds it: full width, cut in depth
    where CUTS says so."""
    from repro_torch.configs import ARCHS
    return ARCHS[arch].cfg.replace(**CUTS.get(arch, {}))


def _full_model(arch, dtype, attn_impl, params=None, chunk=None,
                n_layers=None):
    import dataclasses
    import torch
    from repro_torch.models import build_model
    cfg = _cfg(arch).replace(dtype=dtype, attn_impl=attn_impl)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    if chunk is not None:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
    model = build_model(cfg)
    if params is None:
        model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    else:
        model.set_params(params)
    return model


def _prefill(model, tokens):
    import torch
    with torch.inference_mode():
        cache = model.init_cache(1, MAX_LEN)
        logits, _ = model.prefill(tokens, cache)
    return logits[0, -1].float()


def _scan_fault(module, faulty):
    """A planter (see MODEL_CHECKS): while open, the plain path's scan,
    ``repro_torch.models.<module>._scan``, is ``faulty(fault)``."""
    @contextlib.contextmanager
    def plant(fault):
        import importlib
        mod = importlib.import_module(f"repro_torch.models.{module}")
        sound = mod._scan
        mod._scan = faulty(fault)
        try:
            yield
        finally:
            mod._scan = sound
    return plant


# phase_model's checks, one entry an arch.  "runs": (dtype, weight set,
# prompt lengths) in order; a weight set (``_weight_set``) rescales the
# kernel model's seeded parameters in place, and the plain model shares
# them ("seeded": the port's init).  A float32 run is gated at LOGIT_TOL (the
# SSD path: at FLOOR_FACTOR of its "chunk_floor" if that is larger) unless,
# with "f64_floor", the plain path's own float32 floor (its attention in
# float64) is above LOGIT_TOL at one of its lengths: then it is reported.
# "plant" plants the "control", or one of "faults", in the plain path of
# every float32 run, at the lengths "planted_at" allows; the control must
# pass every gated run.  "rule" says what a gated fault must do: "every_s",
# fail at every length of a gated run (only the faults that "gates" names
# for that weight set, where it names some), or "some_set", fail in at
# least one gated run.  "decode": a run over every PREFILL_S also runs one
# 4-slot decode step (``_decode_check``).  "precap": a float32 run reads
# the attention logits of the first and the last layer at the longest
# length, before the cap (or before the softmax, where there is none).
# "parity": the weight set that phase_parity serves ("seeded" if absent).
# "init_peak": first measure a float32 init's peak memory (``_init_peak``).
# "window": last run the cache-free check past the window (``_window_check``).
MODEL_CHECKS = {
    GEMMA: dict(runs=(("float32", "seeded", PREFILL_S),
                      ("bfloat16", "seeded", PREFILL_S))),
    MAMBA: dict(runs=(("float32", "seeded", PREFILL_S),
                      ("bfloat16", "seeded", PREFILL_S),
                      ("float32", "mamba2_init", PREFILL_S)),
                chunk_floor=True,
                plant=_scan_fault("mamba2", lambda f: _faulty_scan(f)),
                control=SSD_CONTROL, faults=SSD_FAULTS,
                planted_at=lambda f, S, cfg: (f == "bf16_inputs"
                                              or S > cfg.ssm.chunk),
                rule="every_s", gates=LOGIT_FAULTS),
    RGEMMA: dict(runs=(("bfloat16", "seeded", PREFILL_S),
                       ("float32", "layer_fan_in", PREFILL_S),
                       ("float32", "griffin_init", PREFILL_S)),
                 plant=_scan_fault("rglru", lambda f: _faulty_rglru_scan(f)),
                 control=RG_CONTROL, faults=RG_LOGIT_FAULTS,
                 planted_at=lambda f, S, cfg: (f != "reset_128"
                                               or S > RG_PIECE),
                 rule="every_s", parity="layer_fan_in"),
    # float32 at granite's init runs at the longest S only: float32
    # rounding alone decides its tokens (see _contraction_fan_in), so its
    # floor is far above the gate and the run is reported
    GRANITE: dict(runs=(("float32", "seeded", PREFILL_S[-1:]),
                        ("bfloat16", "seeded", PREFILL_S),
                        ("float32", "contraction_fan_in", PREFILL_S)),
                  f64_floor=True, decode=True),
    GEMMA2: dict(runs=(("bfloat16", "seeded", PREFILL_S),
                       ("float32", "seeded", PREFILL_S),
                       ("float32", "layer_fan_in", PREFILL_S)),
                 f64_floor=True, precap=True,
                 plant=lambda f: attention_fault(f),
                 control=GEMMA2_CONTROL, faults=GEMMA2_FAULTS,
                 rule="some_set"),
    STABLELM: dict(runs=(("bfloat16", "seeded", PREFILL_S),
                         ("float32", "seeded", PREFILL_S),
                         ("float32", "layer_fan_in", PREFILL_S)),
                   f64_floor=True, precap=True,
                   plant=lambda f: attention_fault(f),
                   control=STABLELM_CONTROL, faults=STABLELM_FAULTS,
                   rule="every_s",
                   gates={"seeded": (), "layer_fan_in": STABLELM_FAULTS}),
    STARCODER2: dict(runs=(("bfloat16", "seeded", PREFILL_S),
                           ("float32", "seeded", PREFILL_S),
                           ("float32", "layer_fan_in", PREFILL_S)),
                     f64_floor=True, precap=True, init_peak=True,
                     window=True, plant=lambda f: attention_fault(f),
                     control=STARCODER2_CONTROL, faults=STARCODER2_FAULTS,
                     rule="every_s",
                     gates={"seeded": (),
                            "layer_fan_in": STARCODER2_FAULTS},
                     parity="layer_fan_in"),
    # the reference's init draws wo at its heads axis' fan-in (128, not H x
    # v = 16384) and each expert stack at its expert axis' (256, not d_model
    # 7168 or d_expert 2048); "contraction_fan_in" draws them at the dims
    # they contract.  The plain path is routed as the kernel path
    # (``_routed_as``): top-8 of 256 sigmoid affinities has near-ties
    DEEPSEEK: dict(runs=(("bfloat16", "seeded", PREFILL_S),
                         ("float32", "seeded", PREFILL_S),
                         ("float32", "contraction_fan_in", PREFILL_S)),
                   f64_floor=True, precap=True,
                   plant=lambda f: attention_fault(f),
                   control=DEEPSEEK_CONTROL, faults=DEEPSEEK_FAULTS,
                   rule="every_s"),
}


def _weight_set(name, model):
    """Rescale ``model``'s seeded parameters in place as the weight set
    ``name`` draws them ("seeded": the port's init, left as it is)."""
    if name == "contraction_fan_in":
        _contraction_fan_in(model)
    if name == "mamba2_init":
        _mamba2_init(model.params.to_dict())
    if name in ("layer_fan_in", "griffin_init"):
        _layer_fan_in(model)
    if name == "griffin_init":
        _griffin_init(model.params.to_dict())


def phase_model(out, arch):
    """Full-width, full-depth prefill through the kernels against prefill
    through the plain versions, same weights (one parameter tree shared by
    both models): float32 gated, bf16 shown, the runs and checks of each
    arch as MODEL_CHECKS gives them.  Every prefill of the kernel path
    must launch each kernel once per layer of its kind and call no plain
    version.

    For the SSD path the plain version also runs at half the chunk size,
    an exact reformulation of the same scan: the two plain runs differ by
    float32 rounding alone, amplified through 48 layers, and that
    difference (``plain_floor``) is this model's noise floor.  For
    granite-moe-1b-a400m the plain path routes every token as the kernel
    path did (``_routed_as``; the tokens whose own top-k differs are
    counted as ``routing_flips``), and so does its float64-attention
    floor (``plain_f64_floor``)."""
    import torch
    checks = MODEL_CHECKS[arch]
    control, gates = checks.get("control"), checks.get("gates")
    res = {}
    init = _init_peak(arch) if checks.get("init_peak") else None
    for dtype, weights, lengths in checks["runs"]:
        f32 = dtype == "float32"
        kmodel = _full_model(arch, dtype, "kernel")
        _weight_set(weights, kmodel)
        expected = path_kernels(kmodel.cfg)
        rmodel = _full_model(arch, dtype, "ref",
                             params=kmodel.params.to_dict())
        cmodel = (_full_model(arch, dtype, "ref",
                              params=kmodel.params.to_dict(),
                              chunk=kmodel.cfg.ssm.chunk // 2)
                  if checks.get("chunk_floor") and f32 else None)
        g = torch.Generator(device="cuda").manual_seed(1)
        rows = []
        for S in lengths:
            toks = torch.randint(0, kmodel.cfg.vocab, (1, S), generator=g,
                                 device="cuda")
            before, fa_before = _counts(), _fa_variants()
            with moe_drops() as drops, _moe_choices() as choices:
                lk = _prefill(kmodel, toks)
            launched, plain = _since(before)
            fa_by_variant = _fa_variants_since(fa_before)
            with _routed_as(choices) as flips:
                lr = _prefill(rmodel, toks)
            diff = float((lk - lr).abs().max())
            same = int(lk.argmax()) == int(lr.argmax())
            floor = None
            if cmodel is not None:
                floor = float((_prefill(cmodel, toks) - lr).abs().max())
            gate = max(LOGIT_TOL, FLOOR_FACTOR * (floor or 0.0))
            faults = {}
            if f32 and "plant" in checks:
                planted_at = checks.get("planted_at", lambda f, S, cfg: True)
                faults = {f: _planted_fault(checks["plant"], rmodel, toks, lr,
                                            f, gate, choices)
                          for f in (control,) + checks["faults"]
                          if planted_at(f, S, rmodel.cfg)}
            t_k = _host_ms(lambda: _prefill(kmodel, toks))
            t_r = _host_ms(lambda: _prefill(rmodel, toks))
            row = {"arch": arch, "dtype": dtype,
                   "weights": weights, "S": S,
                   "max_logit_diff": diff, "same_first_token": same,
                   "max_abs_logit": float(lr.abs().max()),
                   "plain_floor": floor, "gate": gate,
                   "planted_faults": faults,
                   "kernel_launches": launched, "plain_calls": plain,
                   "flash_launches_by_variant": fa_by_variant,
                   "prefill_ms_kernel_path": t_k,
                   "prefill_ms_plain_path": t_r}
            if kmodel.cfg.moe is not None:
                row.update(moe_dropped=sum(drops),
                           moe_assignments=_assignments(kmodel.cfg, S),
                           routing_flips=sum(flips))
            if f32 and checks.get("f64_floor"):
                row["plain_f64_floor"] = _f64_floor(rmodel, toks, lr,
                                                    choices)
            if f32 and checks.get("precap") and S == lengths[-1]:
                last = len(rmodel.cfg.layer_kinds()) - 1
                with _precap_logits((0, last)) as precap:
                    _prefill(rmodel, toks)
                key = ("precap" if rmodel.cfg.attn_softcap is not None
                       else "presoftmax")
                row[f"{key}_attention_logits"] = {
                    f"layer {n}": st for n, st in precap.items()}
            rows.append(row)
            if not torch.isfinite(lk).all():
                raise AssertionError(f"non-finite logits: {row}")
            if launched != expected or plain:
                raise AssertionError(f"prefill launched {launched} and "
                                     f"called plain versions {plain}, not "
                                     f"{expected} launches and none")
            # bf16 flash takes the tensor cores, float32 the SIMT kernel
            if fa_by_variant[PATH_VARIANT[dtype]] != launched.get(
                    "flash_attention_fwd", 0):
                raise AssertionError(f"{dtype} prefill launched flash "
                                     f"variants {fa_by_variant}")
        # gated unless the plain path's own floor is above the gate
        gated = f32 and all(r.get("plain_f64_floor", 0.0) <= LOGIT_TOL
                            for r in rows)
        for row in rows:
            row["gated"] = gated
            for f, r in row["planted_faults"].items():
                r["gated"] = gated and (f == control or gates is None
                                        or f in gates[row["weights"]])
            log("model " + json.dumps(row))
            res[f"{dtype}_S{row['S']}_{row['weights']}"] = row
            if gated and (row["max_logit_diff"] > row["gate"]
                          or not row["same_first_token"]):
                raise AssertionError(f"float32 kernel path disagrees: {row}")
            missed = [f for f, r in row["planted_faults"].items()
                      if r["gated"] and r["rejected"] == (f == control)
                      and (f == control or checks["rule"] == "every_s")]
            if missed:
                raise AssertionError(f"the float32 gate does not tell the "
                                     f"control from planted faults: "
                                     f"{missed}: {row}")
        if checks.get("decode") and lengths == PREFILL_S:
            res[f"{dtype}_decode_b4_{weights}"] = _decode_check(
                kmodel, rmodel, weights, g, gated)
        del kmodel, rmodel, cmodel
        _free()
    if "faults" in checks:
        # the float32 weight sets that were gated, and of them those whose
        # gate rejects each planted fault
        gated_sets = sorted({r["weights"] for r in res.values()
                             if r["gated"] and r["dtype"] == "float32"})
        by_fault = {f: sorted({r["weights"] for r in res.values()
                               if r["gated"] and f in r["planted_faults"]
                               and r["planted_faults"][f]["rejected"]})
                    for f in checks["faults"]}
        log("model " + json.dumps({"arch": arch, "gated_sets": gated_sets,
                                   "faults_rejected_by": by_fault}))
        res["gated_sets"] = gated_sets
        res["faults_rejected_by"] = by_fault
        if not gated_sets:
            raise AssertionError(f"no float32 weight set of {arch} was "
                                 f"gated, so no planted fault was checked")
        missed = [f for f, sets in by_fault.items() if not sets]
        if checks["rule"] == "some_set" and missed:
            raise AssertionError(f"no gated float32 weight set rejects the "
                                 f"planted faults {missed}")
    if init is not None:
        res["float32_init_memory"] = init
    if checks.get("window"):
        res["window"] = _window_check(arch, control)
    out[f"model_{arch}"] = res


def _init_peak(arch):
    """The peak memory that a float32 init of the full ``arch`` allocates
    on the card, beside its tree's bytes and its largest leaf's: the init
    draws each leaf in float32 and scales it in place, so the peak may not
    pass the tree plus its largest leaf.  Run first in a phase, on a card
    whose peak was reset and memory freed."""
    import torch
    from repro_torch.tree import tree_leaves
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = _full_model(arch, "float32", "kernel")
    torch.cuda.synchronize()
    leaves = [t.numel() * t.element_size()
              for t in tree_leaves(model.params.to_dict())]
    row = {"arch": arch, "peak_bytes": torch.cuda.max_memory_allocated()
           - base, "tree_bytes": sum(leaves), "largest_leaf_bytes":
           max(leaves), "leaves": len(leaves)}
    row["limit_bytes"] = row["tree_bytes"] + row["largest_leaf_bytes"]
    log("model init " + json.dumps(row))
    del model
    _free()
    if row["peak_bytes"] > row["limit_bytes"]:
        raise AssertionError(f"a float32 init peaks past its tree plus its "
                             f"largest leaf: {row}")
    return row


def tail_logits(model, tokens, tail):
    """One cache-free, teacher-forced forward of ``tokens`` (the training
    path's attention: causal, windowed, no cache) and the float32 logits of
    its last ``tail`` positions."""
    import torch
    with torch.inference_mode():
        h, _, _ = model.forward(model.embed(tokens),
                                positions=model._positions(tokens))
        return model.logits(h[:, -tail:]).float()


def _window_check(arch, control):
    """The only model-level check that applies a window on the card: no
    served prefill reaches one (MAX_LEN is under every window), so the
    model at full width and WINDOW_LAYERS layers (``layer_fan_in`` weights,
    one tree shared by both paths) runs one cache-free forward of WINDOW_S
    tokens through the kernel and through plain attention (``tail_logits``),
    and the logits of the last WINDOW_TAIL positions, whose window masks
    keys, are compared: float32 gated at LOGIT_TOL with the same argmax at
    every position, bf16 reported.  Each layer launches the kernel once
    (the float32 forward the SIMT kernel, the bf16 one the tensor-core
    kernel) and calls no plain version.  The float32 gate must pass the
    control and reject WINDOW_FAULT, the window dropped from the plain
    attention."""
    import torch
    res = {}
    for dtype in ("float32", "bfloat16"):
        kmodel = _full_model(arch, dtype, "kernel", n_layers=WINDOW_LAYERS)
        _weight_set("layer_fan_in", kmodel)
        rmodel = _full_model(arch, dtype, "ref", n_layers=WINDOW_LAYERS,
                             params=kmodel.params.to_dict())
        g = torch.Generator(device="cuda").manual_seed(1)
        toks = torch.randint(0, kmodel.cfg.vocab, (1, WINDOW_S), generator=g,
                             device="cuda")
        before, fa_before = _counts(), _fa_variants()
        lk = tail_logits(kmodel, toks, WINDOW_TAIL)
        launched, plain = _since(before)
        fa_by_variant = _fa_variants_since(fa_before)
        lr = tail_logits(rmodel, toks, WINDOW_TAIL)
        top2 = torch.topk(lr[0], 2, dim=-1).values
        row = {"arch": arch, "dtype": dtype, "weights": "layer_fan_in",
               "layers": WINDOW_LAYERS, "S": WINDOW_S,
               "window": kmodel.cfg.window, "positions": WINDOW_TAIL,
               "max_logit_diff": float((lk - lr).abs().max()),
               "argmax_differs_at": int((lk.argmax(-1)
                                         != lr.argmax(-1)).sum()),
               "min_top2_gap": float((top2[:, 0] - top2[:, 1]).min()),
               "max_abs_logit": float(lr.abs().max()), "gate": LOGIT_TOL,
               "kernel_launches": launched, "plain_calls": plain,
               "flash_launches_by_variant": fa_by_variant,
               "gated": dtype == "float32", "planted_faults": {}}
        if row["gated"]:
            for f in (control, WINDOW_FAULT):
                with attention_fault(f):
                    lf = tail_logits(rmodel, toks, WINDOW_TAIL)
                diff = float((lf - lr).abs().max())
                differs = int((lf.argmax(-1) != lr.argmax(-1)).sum())
                row["planted_faults"][f] = {
                    "max_logit_diff": diff, "argmax_differs_at": differs,
                    "gates": diff / LOGIT_TOL,
                    "rejected": diff > LOGIT_TOL or differs > 0}
        log("model window " + json.dumps(row))
        res[dtype] = row
        if not torch.isfinite(lk).all():
            raise AssertionError(f"non-finite logits: {row}")
        if (launched != {"flash_attention_fwd": WINDOW_LAYERS} or plain
                or fa_by_variant[PATH_VARIANT[dtype]] != WINDOW_LAYERS):
            raise AssertionError(f"the forward launched {launched} (by "
                                 f"variant {fa_by_variant}) and called plain "
                                 f"versions {plain}, not {WINDOW_LAYERS} "
                                 f"{PATH_VARIANT[dtype]} launches")
        if row["gated"] and (row["max_logit_diff"] > LOGIT_TOL
                             or row["argmax_differs_at"]):
            raise AssertionError(f"float32 kernel path disagrees past the "
                                 f"window: {row}")
        faults = row["planted_faults"]
        if faults and (faults[control]["rejected"]
                       or not faults[WINDOW_FAULT]["rejected"]):
            raise AssertionError(f"the float32 gate does not tell the "
                                 f"control from {WINDOW_FAULT}: {row}")
        del kmodel, rmodel, lk, lr
        _free()
    return res


def _assignments(cfg, T):
    """Router assignments of one call over T tokens: T x top-k x the MoE
    layers."""
    layers = len(cfg.layer_kinds()) - cfg.moe.first_dense
    return T * cfg.moe.top_k * layers


@contextlib.contextmanager
def moe_drops():
    """Count, while open, the router assignments each MoE dispatch drops:
    one int a layer call, appended to the list it yields.  It syncs the
    card once a layer: never open around a timed call."""
    from repro_torch.models import moe
    counts, dispatch = [], moe.dispatch

    def counted(*a, **kw):
        xg, disp = dispatch(*a, **kw)
        counts.append(int((~disp.keep).sum()))
        return xg, disp
    moe.dispatch = counted
    try:
        yield counts
    finally:
        moe.dispatch = dispatch


@contextlib.contextmanager
def _f64_attention():
    """While open, the plain attention (GQA's ``ref_attention`` and MLA's
    absorbed ``mla_absorbed``, its einsums with W_uk and W_uv included)
    computes in float64 and rounds back: the same function, rounded
    elsewhere, so a plain-path result under it differs from the float32
    plain path's by that path's own float32 floor.  The plain attention
    widens its operands with ``.float()``, which would round them back to
    float32: for the call, ``.float()`` widens to float64, so the logits
    and the softmax are float64 too."""
    import torch
    from repro_torch.models import attention
    saved = attention.ref_attention, attention.mla_absorbed

    def wide(t):
        return (t.double() if torch.is_tensor(t) and t.is_floating_point()
                else t)

    def f64(plain):
        def call(*a, **kw):
            widen, torch.Tensor.float = (torch.Tensor.float,
                                         torch.Tensor.double)
            try:
                return plain(*map(wide, a), **{k: wide(v) for k, v in
                                               kw.items()}).to(a[0].dtype)
            finally:
                torch.Tensor.float = widen
        return call
    attention.ref_attention, attention.mla_absorbed = map(f64, saved)
    try:
        yield
    finally:
        attention.ref_attention, attention.mla_absorbed = saved


def _f64_floor(rmodel, toks, lr, choices):
    """The plain path's own float32 floor on ``toks``: the distance of its
    last logits ``lr`` from the same prefill with its attention in float64,
    routed (``_routed_as``) as ``choices`` holds."""
    with _routed_as(choices), _f64_attention():
        lf = _prefill(rmodel, toks)
    return float((lf - lr).abs().max())


@contextlib.contextmanager
def plain_scale_fault():
    """While open, the plain attention (``ref_attention``) scales its
    logits by 1.01 x the call's scale: TRAIN_FAULTS["plain"]."""
    from repro_torch.models import attention
    plain = attention.ref_attention
    attention.ref_attention = (
        lambda *a, scale, **kw: plain(*a, scale=scale * 1.01, **kw))
    try:
        yield
    finally:
        attention.ref_attention = plain


@contextlib.contextmanager
def chunked_fault():
    """While open, the chunked attention path (``_q_block`` of the plain
    versions' module, which its forward and its q-chunk vjp both run)
    masks its window one key late: a query sees the key ``window``
    positions back too."""
    from repro_torch.kernels.flash_attention import ref
    block = ref._q_block

    def late(*a, window, **kw):
        return block(*a, window=None if window is None else window + 1, **kw)
    ref._q_block = late
    try:
        yield
    finally:
        ref._q_block = block


@contextlib.contextmanager
def encdec_fault(fault):
    """Plant one of ENCDEC_FAULTS in an encoder-decoder model's plain path
    while open: ``encoder_causal`` gives every plain attention call the
    causal mask (only the encoder's calls are not causal; cross-attention
    passes its causal test for every key), ``cross_kv_layer_shift`` gives
    each decoder layer the cross K/V of the layer before it (layer 0 the
    last one's)."""
    from repro_torch.models import attention, encdec
    plain, kv = attention.ref_attention, encdec.enc_kv
    if fault == "encoder_causal":
        attention.ref_attention = lambda *a, causal=True, **kw: plain(
            *a, causal=True, **kw)
    elif fault == "cross_kv_layer_shift":
        encdec.enc_kv = lambda p, enc_out: tuple(
            t.roll(1, dims=0) for t in kv(p, enc_out))
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        attention.ref_attention, encdec.enc_kv = plain, kv


@contextlib.contextmanager
def attention_fault(fault):
    """Plant one of GEMMA2_FAULTS, STABLELM_FAULTS, STARCODER2_FAULTS,
    DEEPSEEK_FAULTS or WINDOW_FAULT, or a control, in the plain attention
    path while open (None: nothing): ``no_attn_softcap`` calls the plain
    attention without its cap, ``no_window`` without its window,
    ``no_final_softcap`` leaves the logits uncapped, ``gqa_mod`` gives
    query head h KV head h % KH, ``kv_head_shift`` the KV head after its
    own, ``causal_shift`` lets each query see the key one position after
    it (in GQA's and MLA's plain attention), ``full_rotary`` rotates every
    dim of a head whatever the config's ``rope_fraction``, and
    ``kv_expanded`` gives query head h KV head h // (H / KH), the right
    one, by the same expansion of K and V to H heads.  MLA's:
    ``v_dim_scale`` scales the absorbed logits by v's head dim, not q/k's,
    ``k_rope_unrotated`` skips the rotary of the one shared rope key (the
    only rotary call on a single head in an MLA layer), and the control
    ``mla_expanded`` attends over the cache un-absorbed, per-head K and V
    materialised from the latent through the plain GQA attention."""
    import torch
    from repro_torch.models import attention, lm
    plain, capped = attention.ref_attention, lm.softcap
    rotary, absorbed = attention.rotary, attention.mla_absorbed

    def expanded(head_map):
        def call(q, k, v, **kw):
            H, KH = q.shape[2], k.shape[2]
            idx = head_map(torch.arange(H, device=k.device), H, KH)
            return plain(q, k[:, :, idx], v[:, :, idx], **kw)
        return call
    if fault == "no_attn_softcap":
        attention.ref_attention = lambda *a, **kw: plain(*a, **dict(kw,
                                                                    cap=None))
    elif fault == WINDOW_FAULT:
        attention.ref_attention = lambda *a, **kw: plain(
            *a, **dict(kw, window=None))
    elif fault == "no_final_softcap":
        lm.softcap = lambda x, cap: x
    elif fault == "gqa_mod":
        attention.ref_attention = expanded(lambda h, H, KH: h % KH)
    elif fault == "kv_head_shift":
        attention.ref_attention = expanded(
            lambda h, H, KH: (h // (H // KH) + 1) % KH)
    elif fault == "causal_shift":
        attention.ref_attention = lambda q, k, v, *, q_pos, **kw: plain(
            q, k, v, q_pos=q_pos + 1, **kw)
        attention.mla_absorbed = lambda *a, q_pos, **kw: absorbed(
            *a, q_pos=q_pos + 1, **kw)
    elif fault == "full_rotary":
        attention.rotary = lambda x, positions, *, theta, fraction: rotary(
            x, positions, theta=theta, fraction=1.0)
    elif fault == GEMMA2_CONTROL:
        attention.ref_attention = expanded(lambda h, H, KH: h // (H // KH))
    elif fault == "v_dim_scale":
        attention.mla_absorbed = lambda *a, wv_b, scale, **kw: absorbed(
            *a, wv_b=wv_b, scale=wv_b.shape[-1] ** -0.5, **kw)
    elif fault == "k_rope_unrotated":
        attention.rotary = lambda x, positions, **kw: (
            x if x.shape[-2] == 1 else rotary(x, positions, **kw))
    elif fault == DEEPSEEK_CONTROL:
        def unabsorbed(q_nope, q_rope, c_kv, k_rope, *, wk_b, wv_b, scale,
                       q_pos, k_pos):
            q, k, v = attention.mla_expanded(q_nope, q_rope, c_kv, k_rope,
                                             wk_b=wk_b, wv_b=wv_b)
            return plain(q, k, v, scale=scale, q_pos=q_pos, k_pos=k_pos,
                         window=None, cap=None)
        attention.mla_absorbed = unabsorbed
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        attention.ref_attention, lm.softcap = plain, capped
        attention.rotary, attention.mla_absorbed = rotary, absorbed


@contextlib.contextmanager
def _precap_logits(calls):
    """Record, while open, the scaled attention logits of the plain
    attention calls (GQA's ``ref_attention`` and MLA's ``mla_absorbed``)
    numbered in ``calls`` (0 is the first; a prefill makes one a layer, in
    layer order), before the softcap where the call has one, else before
    the softmax, over the (query, key) pairs its masks keep: their rms,
    largest magnitude and, for a capped call only, the share past
    SOFTCAP_BEND, into the dict it yields, keyed by call number."""
    import torch
    from repro_torch.models import attention
    plain, stats, seen = attention.ref_attention, {}, [0]
    absorbed = attention.mla_absorbed

    def kept(x, keep):
        return x[keep.expand_as(x)]

    def keep_stats(n, x):
        stats[n] = {"rms": float(x.square().mean().sqrt()),
                    "max_abs": float(x.abs().max())}

    def recorded(q, k, v, *, scale, q_pos, k_pos, window, cap, causal=True):
        n, seen[0] = seen[0], seen[0] + 1
        if n in calls:
            B, Sq, H, D = q.shape
            KH = k.shape[2]
            x = torch.einsum("bqkgd,bskd->bkgqs",
                             q.reshape(B, Sq, KH, H // KH, D).float(),
                             k.float()) * scale
            keep = k_pos[:, None, :] >= 0
            if causal:
                keep = keep & (k_pos[:, None, :] <= q_pos[:, :, None])
            if window is not None:
                keep = keep & ((q_pos[:, :, None] - k_pos[:, None, :])
                               < window)
            x = kept(x, keep[:, None, None])
            keep_stats(n, x)
            if cap is not None:
                stats[n]["share_past_bend"] = float(
                    (x.abs() > SOFTCAP_BEND).float().mean())
        return plain(q, k, v, scale=scale, q_pos=q_pos, k_pos=k_pos,
                     window=window, cap=cap, causal=causal)

    def recorded_mla(q_nope, q_rope, c_kv, k_rope, *, wk_b, scale, q_pos,
                     k_pos, **kw):
        n, seen[0] = seen[0], seen[0] + 1
        if n in calls:
            q_abs = torch.einsum("bshk,lhk->bshl", q_nope, wk_b)
            x = (torch.einsum("bshl,btl->bhst", q_abs.float(),
                              c_kv.float())
                 + torch.einsum("bshr,btr->bhst", q_rope.float(),
                                k_rope.float())) * scale
            keep = ((k_pos[:, None, :] <= q_pos[:, :, None])
                    & (k_pos[:, None, :] >= 0))
            keep_stats(n, kept(x, keep[:, None]))
        return absorbed(q_nope, q_rope, c_kv, k_rope, wk_b=wk_b,
                        scale=scale, q_pos=q_pos, k_pos=k_pos, **kw)
    attention.ref_attention, attention.mla_absorbed = recorded, recorded_mla
    try:
        yield stats
    finally:
        attention.ref_attention, attention.mla_absorbed = plain, absorbed


@contextlib.contextmanager
def _moe_choices():
    """Record, while open, each MoE layer call's expert choices (T, k),
    in call order, into the list it yields."""
    from repro_torch.models import moe
    choices, route = [], moe.route

    def recorded(*a, **kw):
        weights, gidx, probs = route(*a, **kw)
        choices.append(gidx)
        return weights, gidx, probs
    moe.route = recorded
    try:
        yield choices
    finally:
        moe.route = route


@contextlib.contextmanager
def _routed_as(choices):
    """While open, each MoE layer call sends every token to the experts
    that ``choices`` (``_moe_choices`` of the same calls on another path)
    holds for it, weighted by this call's own router probabilities as
    the router weights its own choice.  A token whose own top-k differs
    (a routing flip: a near-tie that the two paths' rounding decides
    apart) is counted, one int a layer call into the list it yields.  Two
    paths compared under it then differ by what feeds the routers, not by
    a discrete choice that one ulp can turn.  Either router: the sigmoid
    router's ``probs`` are its affinities over their sum, so normalising
    their gather gives its own weights."""
    import torch
    from repro_torch.models import moe
    route, want, flips = moe.route, iter(choices), []

    def routed(p, xf, cfg):
        weights, gidx, probs = route(p, xf, cfg)
        forced = next(want)
        flip = (torch.sort(gidx, dim=-1).values
                != torch.sort(forced, dim=-1).values).any(-1)
        flips.append(int(flip.sum()))
        if flips[-1]:
            w = torch.gather(probs, 1, forced)
            w = w / (torch.sum(w, dim=1, keepdim=True) + 1e-20)
            gidx = torch.where(flip[:, None], forced, gidx)
            weights = torch.where(flip[:, None], w, weights)
        return weights, gidx, probs
    moe.route = routed
    try:
        yield flips
    finally:
        moe.route = route


def _contraction_fan_in(model):
    """Scale, in place, every leaf that the init draws at its fan-in
    (``normal``, no scale) to the fan-in of the dims its product contracts,
    as a model's own init would draw it: the init's rule (the
    reference's) takes the fan-in from a leaf's first axis, which is the
    layers axis of a stacked leaf and the expert axis of an expert stack.
    Batch axes (``layers``, ``expert``) are left out; a leaf whose last
    axis is ``embed`` writes the residual stream and contracts all its
    other axes (``wo``: heads x head dim; an MLP's ``wd``), any other
    contracts its first (``wq``/``wk``/``wv``, ``wg``/``wu``: d_model).
    At granite-moe-1b-a400m's init (24 layers, 32 experts) the attention
    products come out 6.5x too large, so its softmax and its routers'
    top-8 turn on float32 rounding alone (phase 20's ``plain_f64_floor``);
    here no routing decision turns on it."""
    import math
    import torch
    from repro_torch.tree import tree_map

    def scale(spec, leaf):
        if spec.init != "normal" or spec.scale is not None:
            return
        dims = [(n, a) for n, a in zip(spec.shape, spec.axes)
                if a not in ("layers", "expert")]
        fan_in = (math.prod(n for n, _ in dims[:-1])
                  if dims[-1][1] == "embed" else dims[0][0])
        with torch.no_grad():
            leaf.mul_(math.sqrt(spec.shape[0] / fan_in))
    tree_map(scale, model.param_specs(), model.params.to_dict())


def _decode_check(kmodel, rmodel, weights, g, gated):
    """One 4-slot decode step from the caches of four prefills (DECODE_S),
    through the kernel path's prefills and through the plain path's, the
    same tokens fed to both (the kernel path's first tokens) and the
    plain path routed as the kernel path (``_routed_as``): the step's
    last logits, gated (``gated``) as a prefill's are.  In float32 the
    plain path also runs under ``_f64_attention``: its floor."""
    import torch
    from repro_torch.serve.engine import _make_splice
    prompts = [torch.randint(0, kmodel.cfg.vocab, (1, S), generator=g,
                             device="cuda") for S in DECODE_S]
    pos = torch.tensor([[S] for S in DECODE_S], dtype=torch.int32,
                       device="cuda")
    logits, flips, first, dropped = {}, {}, None, None
    runs = [("kernel", kmodel, None), ("plain", rmodel, None)]
    if kmodel.cfg.dtype == "float32" and gated:
        runs.append(("plain_f64", rmodel, _f64_attention))
    for name, model, attention_ctx in runs:
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.inference_mode())
            if attention_ctx is not None:
                stack.enter_context(attention_ctx())
            if name == "kernel":
                choices = stack.enter_context(_moe_choices())
            else:
                flips[name] = stack.enter_context(_routed_as(choices))
            caches = model.init_cache(len(prompts), MAX_LEN)
            splice = _make_splice(model, len(prompts))
            lasts = []
            for slot, toks in enumerate(prompts):
                lg, pc = model.prefill(toks, model.init_cache(1, MAX_LEN))
                lasts.append(lg[0, -1])
                splice(caches, pc, slot)
            if first is None:
                first = torch.stack(lasts).argmax(-1)[:, None]
            with moe_drops() as drops:
                lg, _ = model.decode_step(caches, first, pos)
            if dropped is None:
                dropped = sum(drops)
            logits[name] = lg[:, -1].float()
            del caches
    lk, lr = logits["kernel"], logits["plain"]
    dtype = kmodel.cfg.dtype
    layers = len(kmodel.cfg.layer_kinds()) - kmodel.cfg.moe.first_dense
    row = {"arch": kmodel.cfg.name, "dtype": dtype, "weights": weights,
           "call": "decode_step_b4", "positions": list(DECODE_S),
           "max_logit_diff": float((lk - lr).abs().max()),
           "same_tokens": bool((lk.argmax(-1) == lr.argmax(-1)).all()),
           "max_abs_logit": float(lr.abs().max()), "gate": LOGIT_TOL,
           "plain_f64_floor": (float((logits["plain_f64"] - lr).abs().max())
                               if "plain_f64" in logits else None),
           # tokens of the four prefills and the step whose own routing
           # differs from the kernel path's, and the step's alone
           "routing_flips": {n: sum(f) for n, f in flips.items()},
           "routing_flips_in_step": {n: sum(f[-layers:])
                                     for n, f in flips.items()},
           "gated": gated, "moe_dropped": dropped,
           "moe_assignments": _assignments(kmodel.cfg, len(prompts))}
    log("model " + json.dumps(row))
    if not torch.isfinite(lk).all():
        raise AssertionError(f"non-finite decode logits: {row}")
    if gated and (row["max_logit_diff"] > LOGIT_TOL
                  or not row["same_tokens"]):
        raise AssertionError(f"float32 decode step disagrees: {row}")
    return row


def _layer_fan_in(model):
    """Scale, in place, every stacked leaf that the init draws at its
    fan-in (``normal``, no scale) to one layer's fan-in: by sqrt(layers /
    the layer's fan-in).  The init's rule (the reference's) takes a leaf's
    fan-in from its first axis, the layers axis on a stacked leaf (every
    leaf of an encoder-decoder model's ``enc`` and ``dec`` stacks)."""
    import math
    import torch
    specs = model.param_specs()

    def walk(spec, leaf, reps):
        if isinstance(spec, dict):
            for k in spec:
                walk(spec[k], leaf[k], reps)
        elif spec.init == "normal" and spec.scale is None:
            layer = spec.shape[1:]
            fan_in = layer[0] if len(layer) >= 2 else max(layer[-1], 1)
            with torch.no_grad():
                leaf.mul_(math.sqrt(reps / fan_in))

    params = model.params.to_dict()
    # a decoder-only model's repeating segments, or an encoder-decoder
    # model's two stacks
    stacks = ([(f"seg{si}", reps) for si, (_, reps)
               in enumerate(model.segments)] if hasattr(model, "segments")
              else [(name, model.cfg.n_layers) for name in ("enc", "dec")])
    for name, reps in stacks:
        if reps > 1:
            walk(specs[name], params[name], reps)


def _griffin_init(params):
    """Overwrite, in place, every RG-LRU layer's lam as Griffin's init
    draws it (seeded): a = exp(-8 softplus(lam)) uniform in GRIFFIN_A."""
    import torch
    g = torch.Generator().manual_seed(3)

    def walk(t):
        if not isinstance(t, dict):
            return
        if "lam" in t and "wa" in t:
            lo, hi = GRIFFIN_A
            u = lo + (hi - lo) * torch.rand(t["lam"].shape, generator=g,
                                            dtype=torch.float64)
            with torch.no_grad():
                t["lam"].copy_(torch.log(torch.expm1(-torch.log(u) / 8)))
        for v in t.values():
            walk(v)
    walk(params)


def _mamba2_init(params):
    """Overwrite, in place, every layer's a_log and dt_bias as Mamba-2's
    published init draws them (seeded): A uniform in [1, 16], dt
    log-uniform in [1e-3, 1e-1] and dt_bias its inverse softplus."""
    import math
    import torch
    g = torch.Generator().manual_seed(2)

    def walk(t):
        if not isinstance(t, dict):
            return
        if "a_log" in t and "dt_bias" in t:
            a, d = t["a_log"], t["dt_bias"]
            A = 1 + 15 * torch.rand(a.shape, generator=g)
            dt = torch.exp(math.log(1e-3) + math.log(100) * torch.rand(
                d.shape, generator=g))
            with torch.no_grad():
                a.copy_(torch.log(A))
                d.copy_(dt + torch.log(-torch.expm1(-dt)))
        for v in t.values():
            walk(v)
    walk(params)


def _faulty_ssd(fault, xs, dt, a_log, b, c, *, chunk, init_state=None):
    """The plain SSD scan, chunk by chunk, with one planted fault (see
    SSD_FAULTS), or none (SSD_CONTROL): (y float32, final state)."""
    import torch
    from repro_torch.kernels.ssd.ref import ssd_padded_reference
    if fault == "bf16_inputs":
        return ssd_padded_reference(xs.bfloat16(), dt, a_log, b.bfloat16(),
                                    c.bfloat16(), chunk=chunk,
                                    init_state=init_state)
    s, ys = init_state, []
    for t0 in range(0, xs.shape[1], chunk):
        args = [a[:, t0:t0 + chunk] for a in (xs, dt)] + [a_log] + \
            [a[:, t0:t0 + chunk] for a in (b, c)]
        if fault == "bf16_state" and s is not None:
            s = s.bfloat16().float()
        y, s_next = ssd_padded_reference(*args, chunk=chunk, init_state=s)
        if fault == "no_inter_chunk":
            y, _ = ssd_padded_reference(*args, chunk=chunk)
        ys.append(y)
        s = s_next
    return torch.cat(ys, dim=1), s


def _faulty_scan(fault):
    """``models.mamba2._scan`` on the plain path with ``fault`` planted."""
    def scan(cfg, xs, dt, a_log, b, c, init_state=None):
        return _faulty_ssd(fault, xs, dt, a_log, b, c, chunk=cfg.ssm.chunk,
                           init_state=init_state)
    return scan


def _planted_fault(plant, rmodel, toks, lr, fault, gate, choices):
    """The plain model's prefill with ``fault`` planted by ``plant`` (a
    MODEL_CHECKS planter), routed (``_routed_as``) as ``choices`` holds,
    as the sound plain path ``lr`` was: its last logits' distance from
    ``lr``, and whether the float32 gate rejects it."""
    with _routed_as(choices), plant(fault):
        lf = _prefill(rmodel, toks)
    diff = float((lf - lr).abs().max())
    same = int(lf.argmax()) == int(lr.argmax())
    return {"max_logit_diff": diff, "same_first_token": same,
            "gates": diff / gate, "rejected": diff > gate or not same}


def _host_ms(fn, iters=3):
    """Host-clock milliseconds of ``fn`` ending in a device sync."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _load():
    from repro_torch.serve import LoadSpec
    return LoadSpec(rps=8, requests=8, prompt_lens=(100, 256, 384),
                    max_new_lo=16, max_new_hi=32)


def _request_lags(records):
    """Per request, in arrival order: milliseconds from the scheduled
    arrival to the server's admission task holding the server lock
    (``t_recv``), and from its prefill's start to its first token, the
    lock taken again for the splice (``t_first - t_admit``)."""
    recs = sorted(records, key=lambda rec: rec["t_sched"])
    return {"sched_to_recv_ms": [(rec["t_recv"] - rec["t_sched"]) * 1e3
                                 for rec in recs],
            "admit_to_first_ms": [(rec["t_first"] - rec["t_admit"]) * 1e3
                                  for rec in recs]}


def phase_serve(out, arch):
    """The main path of ``arch``: every kernel's counts are set to 0 just
    before the serving run and read just after it."""
    import torch
    from repro_torch.serve import run_serve
    load = _load()
    cfg = _cfg(arch)
    expected = path_kernels(cfg)
    prefills = len(set(load.prompt_lens)) + load.requests
    all_ops = _all_ops()
    torch.cuda.synchronize()
    for ops in all_ops.values():
        ops.reset_counts()                 # the main path's counts only
    res = run_serve(arch=arch, reduced=False, clients=2, slots=4,
                    max_len=MAX_LEN, load=load, transport="inproc",
                    device="cuda", overrides=CUTS.get(arch))
    torch.cuda.synchronize()
    launches = {k: ops.kernel_launches for k, ops in all_ops.items()}
    plain = {k: ops.plain_calls for k, ops in all_ops.items()}
    ssd_by_variant = dict(all_ops["ssd_fwd"].launches_by_variant)
    fa_by_variant = dict(all_ops["flash_attention_fwd"].launches_by_variant)
    r, summary = res["result"], res["summary"]
    log("serve " + json.dumps({
        "arch": arch, "card": out.get("card"), "dtype": cfg.dtype,
        "reading": "smoke, 8 requests", **summary,
        "steps": r["steps"], "tick_execs": r["tick_execs"],
        "prefills": r["prefills"], "kernel_launches": launches,
        "ssd_launches_by_variant": ssd_by_variant,
        "flash_launches_by_variant": fa_by_variant,
        "plain_calls": plain, **_request_lags(r["records"])}))
    checks = {
        "served == 8": r["served"] == load.requests,
        "slots_leaked == 0": r["slots_leaked"] == 0,
        "queue_left == 0": r["queue_left"] == 0,
        "tick_execs == steps": r["tick_execs"] == r["steps"],
        **{f"{name} launches == {n} x {prefills}":
           launches[name] == n * prefills for name, n in expected.items()},
        "no other kernel launched": not any(
            n for k, n in launches.items() if k not in expected),
        "plain_calls == 0": not any(plain.values()),
        # the serving path's bf16 views take the tensor-core SSD kernel
        "every ssd_fwd launch mma_bf16":
            ssd_by_variant["mma_bf16"] == launches["ssd_fwd"],
        # ... and the tensor-core flash kernel
        "every flash_attention_fwd launch mma_bf16":
            fa_by_variant["mma_bf16"] == launches["flash_attention_fwd"],
        "tokens in vocab": all(0 <= t < cfg.vocab for rec in r["records"]
                               for t in rec["tokens"]),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve checks failed: {failed}")
    out[f"serve_{arch}"] = {"summary": summary, "steps": r["steps"],
                            "kernel_launches": launches,
                            "ssd_launches_by_variant": ssd_by_variant,
                            "flash_launches_by_variant": fa_by_variant,
                            "plain_calls": plain}
    if "ssd_fwd" in expected:
        out.setdefault("ssd_main_path_by_variant", {})[arch] = ssd_by_variant
    if "flash_attention_fwd" in expected:
        out.setdefault("flash_main_path_by_variant", {})[arch] = fa_by_variant
    out.setdefault("main_path_launches", {})[arch] = {
        name: launches[name] for name in expected}


def _top2_gap(cfg, prompt, tokens, step):
    """Top-2 logit gap of the sequential reference at ``step`` (0 = the
    prefill's token), replaying its own tokens."""
    import torch
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, slots=1, max_len=MAX_LEN, device="cuda")
    with torch.inference_mode():
        toks = torch.tensor([prompt], device="cuda")
        logits, caches = eng._prefill(toks)
        for i in range(step):
            pos = torch.tensor([[len(prompt) + i]], device="cuda")
            tok = torch.tensor([[tokens[i]]], device="cuda")
            logits, caches = eng.model.decode_step(caches, tok, pos)
        top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


@contextlib.contextmanager
def _engines_drawn_as(weights):
    """While open, every :class:`ServeEngine` built in this process from
    its seeded init (no ``params``) rescales its parameters in place on
    the card as the weight set ``weights`` draws them (``_weight_set``),
    so the served, sequential and replaying engines of a phase hold the
    same weights with no host copy (starcoder2-15b's float32 tree is 63.8
    GB)."""
    from repro_torch.serve.engine import ServeEngine
    init = ServeEngine.__init__

    def drawn(self, *a, params=None, **kw):
        init(self, *a, params=params, **kw)
        if params is None:
            _weight_set(weights, self.model)
    ServeEngine.__init__ = drawn
    try:
        yield
    finally:
        ServeEngine.__init__ = init


def phase_parity(out, arch):
    """float32 served tokens against the sequential baseline's, both
    serving the weight set that MODEL_CHECKS names as the arch's "parity"
    (each engine rescales its own seeded parameters, ``_engines_drawn_as``),
    else the port's init.  recurrentgemma-9b
    serves ``layer_fan_in``: at the port's init float32 rounding alone
    moves its logits by O(1), past their top-2 gaps (see RG_LOGIT_FAULTS),
    so batched and sequential serving, whose products round differently,
    part early; so does starcoder2-15b, whose plain path at the port's init
    differs from its own float64 attention by O(1) (phase 32).  gemma2-2b
    and stablelm-1.6b serve the port's init, where phases 24 and 28 gate
    float32."""
    import resource
    from repro_torch.serve import all_requests, run_sequential, run_serve
    load = _load()
    cfg = _cfg(arch).replace(dtype="float32")
    weights = MODEL_CHECKS[arch].get("parity", "seeded")
    reqs = all_requests(load, 2, cfg.vocab)
    prompts = {r["id"]: r["prompt"] for r in reqs}
    fa_before = _fa_variants()
    with _engines_drawn_as(weights):
        res = run_serve(arch=arch, reduced=False, clients=2, slots=4,
                        max_len=MAX_LEN, load=load, device="cuda",
                        dtype="float32", overrides=CUTS.get(arch))
        got = {r["id"]: r["tokens"] for r in res["result"]["records"]}
        _free()           # one float32 engine on the card at a time
        seq = run_sequential(cfg, reqs, max_len=MAX_LEN, realtime=False,
                             device="cuda")
        want = {r["id"]: r["tokens"] for r in seq}
        _free()
        _check_float32_simt(_fa_variants_since(fa_before), f"parity {arch}")
        if set(got) != set(want):
            raise AssertionError("served and sequential request ids differ")
        diffs = []
        for rid in sorted(want):
            a, b = got[rid], want[rid]
            if a == b:
                continue
            step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                        min(len(a), len(b)))
            gap = (_top2_gap(cfg, prompts[rid], b, step)
                   if step < min(len(a), len(b)) else float("inf"))
            diffs.append({"id": rid, "step": step, "top2_gap": gap})
            _free()
    log("parity " + json.dumps({"arch": arch, "requests": len(want),
                                "weights": weights,
                                "identical": len(want) - len(diffs),
                                "differing": diffs,
                                "peak_rss_gib": resource.getrusage(
                                    resource.RUSAGE_SELF).ru_maxrss / 2**20}))
    bad = [d for d in diffs if not d["top2_gap"] < NEAR_TIE]
    if bad:
        raise AssertionError(f"float32 served tokens differ from the "
                             f"sequential baseline beyond near-ties: {bad}")
    out[f"parity_{arch}"] = {"requests": len(want), "differing": diffs,
                             "served_tokens": got}


def _kernel_time(prof):
    """Device time of the kernels in a profile (ms), their number, and the
    top kernels.  Only device events count: a CPU op's device time is its
    kernels'."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        rows.append((float(t) / 1e3, e.key[:100], int(e.count)))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), sum(r[2] for r in rows), rows[:6]


def phase_profile(out, arch):
    """Where serving time goes on the card: one bf16 prefill (S=384) and
    decode steps of a full 4-slot batch.  The host clock (no profiler)
    gives each call's wall time; ``torch.profiler`` gives the device's
    kernel time for the same call; their ratio is the device's busy
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.serve import ServeEngine
    ssd_ops.reset_counts()
    eng = ServeEngine(_cfg(arch), slots=4, max_len=MAX_LEN, device="cuda")
    prompt = list(range(1, 385))
    eng.warmup([len(prompt)])
    first, pcache = eng.prefill(prompt)
    for slot in range(4):
        eng.attach(slot, len(prompt), first, pcache)
    calls = {"prefill_384": lambda: eng.prefill(prompt),
             "decode_step_b4": lambda: eng.step(range(4))}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    res = {}
    for name, fn in calls.items():
        wall = _host_ms(fn, iters=4)
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        device_ms, n_kernels, top = _kernel_time(prof)
        res[name] = {"wall_ms": wall, "device_ms": device_ms,
                     "device_busy_share": device_ms / wall,
                     "kernels": n_kernels, "top_kernels_ms_count": top}
        if _cfg(arch).moe is not None:
            res[name]["moe_steps"] = _moe_step_times(fn, device_ms)
        log(f"profile {arch} {name} " + json.dumps(res[name]))
    if not res["prefill_384"]["device_ms"] > 0:
        raise AssertionError("the profiler saw no device time")
    if "ssd" in _cfg(arch).layer_kinds():
        # the SSD launches of this phase (warm-up, timed and profiled
        # calls), by variant
        res["ssd_launches_by_variant"] = dict(ssd_ops.launches_by_variant)
        log(f"profile {arch} ssd_launches_by_variant "
            + json.dumps(res["ssd_launches_by_variant"]))
        if ssd_ops.launches_by_variant["simt"]:
            raise AssertionError("a bf16 prefill launched the SIMT SSD "
                                 "kernel")
    if arch == RGEMMA:
        res["float32_gates"] = _gate_cost(
            eng, res["decode_step_b4"]["device_ms"])
        log(f"profile {arch} float32_gates "
            + json.dumps(res["float32_gates"]))
    out[f"profile_{arch}"] = res


MOE_STEPS = ("route", "dispatch", "experts", "combine")


def _moe_step_times(fn, device_ms):
    """Device ms of each MoE step (``moe.route``, ``dispatch`` (the table
    and the gather of the expert inputs), ``experts``, ``combine``) summed
    over the layers of one call of ``fn``, and its share of ``device_ms``
    (the same call profiled without the ranges): a second profile with
    each step wrapped in a ``record_function`` range, whose device time
    is that of the kernels launched inside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import moe
    saved = {n: getattr(moe, n) for n in MOE_STEPS}

    def ranged(n, f):
        def call(*a, **kw):
            with record_function(f"moe.{n}"):
                return f(*a, **kw)
        return call
    for n, f in saved.items():
        setattr(moe, n, ranged(n, f))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for n, f in saved.items():
            setattr(moe, n, f)
    ms = {n: 0.0 for n in MOE_STEPS}
    calls = {n: 0 for n in MOE_STEPS}
    for e in prof.key_averages():
        n = e.key[len("moe."):] if e.key.startswith("moe.") else None
        if n in ms and e.device_type == DeviceType.CPU:
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            ms[n] += float(t) / 1e3
            calls[n] += int(e.count)
    return {"device_ms": ms, "calls": calls,
            "share_of_device_ms": {n: v / device_ms for n, v in ms.items()},
            "dispatch_and_combine_share":
                (ms["dispatch"] + ms["combine"]) / device_ms}


def _gate_cost(eng, decode_device_ms):
    """What the float32 gates cost a decode step: every RG-LRU layer casts
    its bf16 W x W ``wa`` and ``wi`` to float32 at each call, as the
    reference does, then multiplies the 4 slots' (4, 1, W) float32 input
    by each.  CUDA-event times of the casts alone and of casts and
    products, against the casts' bytes bound and the step's device time."""
    import torch
    with torch.inference_mode():
        gates = [lp["mix"][k] for _, _, _, lp in eng.model.layer_params()
                 if "wa" in lp["mix"] for k in ("wa", "wi")]
        xf = torch.randn((4, 1, gates[0].shape[-1]), device="cuda")
        cast_ms = cuda_ms(lambda: [w.float() for w in gates], iters=5)
        gate_ms = cuda_ms(lambda: [xf @ w.float() for w in gates], iters=5)
    n = sum(w.numel() for w in gates)
    return {"matrices": len(gates), "cast_ms": cast_ms,
            "cast_and_product_ms": gate_ms, "cast_bytes": 6 * n,
            "cast_bound_ms": 6 * n / PEAK_BYTES * 1e3,
            "share_of_decode_device_ms": gate_ms / decode_device_ms}


@contextlib.contextmanager
def moe_fault(fault):
    """Plant one of MOE_FAULTS in the MoE module while open (None: none):
    ``unnormalised_weights`` gives each token's top-k softmax
    probabilities as its weights, ``no_capacity`` a capacity of T slots
    an expert, so no assignment is dropped."""
    import torch
    from repro_torch.models import moe
    saved = moe.route, moe.capacity

    def unnormalised(p, xf, cfg):
        _, gidx, probs = saved[0](p, xf, cfg)
        return torch.gather(probs, 1, gidx), gidx, probs
    if fault == "unnormalised_weights":
        moe.route = unnormalised
    elif fault == "no_capacity":
        moe.capacity = lambda T, k, n_experts, factor: T
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        moe.route, moe.capacity = saved


@contextlib.contextmanager
def record_engine_calls():
    """Record, while open, the calls that an in-proc server makes on its
    :class:`ServeEngine`, with the tokens each returned, into the list it
    yields: ``("prefill", prompt, first)`` and ``("attach", slot,
    prompt_len, first)`` at each admission, ``("step", live, tokens)``
    at each decode step (``tokens``: the whole slot column).  Attach and
    step run under the server's lock, so the list is in the order that
    changed the batch; a prefill touches no shared state and is recorded
    beside the attach that consumes its cache.  The engine's warm-up is
    left out."""
    import threading
    from repro_torch.serve.engine import ServeEngine
    saved = {n: getattr(ServeEngine, n)
             for n in ("prefill", "attach", "step", "warmup")}
    calls, prompts, lock = [], {}, threading.Lock()

    def prefill(self, prompt):
        first, pcache = saved["prefill"](self, prompt)
        with lock:
            prompts[id(pcache)] = list(prompt)
        return first, pcache

    def attach(self, slot, prompt_len, first_token, pcache):
        saved["attach"](self, slot, prompt_len, first_token, pcache)
        with lock:
            prompt = prompts.pop(id(pcache))
        calls.extend([("prefill", prompt, int(first_token)),
                      ("attach", slot, prompt_len, int(first_token))])

    def step(self, live):
        out = saved["step"](self, live)
        calls.append(("step", list(live), [int(t) for t in out]))
        return out

    def warmup(self, *a, **kw):
        saved["warmup"](self, *a, **kw)
        calls.clear()
        prompts.clear()
    for n, f in (("prefill", prefill), ("attach", attach), ("step", step),
                 ("warmup", warmup)):
        setattr(ServeEngine, n, f)
    try:
        yield calls
    finally:
        for n, f in saved.items():
            setattr(ServeEngine, n, f)


def replay_engine_calls(engine, calls):
    """Drive ``engine`` (a fresh :class:`ServeEngine` with the served
    engine's slots and ``max_len``) through ``calls``
    (``record_engine_calls``) with its own prefill, attach and step, fed
    the served tokens: each attach gets the served first token, and after
    each step every live slot's next input is the served token, so a
    token that differs at one call does not carry into the next, and
    every step sees the served batch, dead rows included.  Yields
    ``(call, rows)`` after each call: one row for a prefill, one per live
    slot for a step, none for an attach; each row holds ``served``,
    ``replayed`` (the argmax of the engine's logits at that call) and
    ``top2_gap``."""
    import torch
    model, seen = engine.model, []

    def kept(fn):
        def call(*a, **kw):
            logits, caches = fn(*a, **kw)
            seen.append(logits[:, -1].float())
            return logits, caches
        return call
    model.prefill = kept(model.prefill)
    model.decode_step = kept(model.decode_step)

    def rows(slots, served):
        lg = seen.pop()
        top = torch.topk(lg, 2, dim=-1).values.cpu()
        arg = torch.argmax(lg, dim=-1).cpu()
        return [{"slot": s, "served": int(t), "replayed": int(arg[s]),
                 "top2_gap": float(top[s, 0] - top[s, 1])}
                for s, t in zip(slots, served)]
    pcache = None
    for call in calls:
        if call[0] == "prefill":
            _, pcache = engine.prefill(call[1])
            yield call, rows([0], [call[2]])
        elif call[0] == "attach":
            _, slot, prompt_len, first = call
            engine.attach(slot, prompt_len, first, pcache)
            pcache = None
            yield call, []
        else:
            _, live, served = call
            engine.step(live)
            out = rows(live, [served[s] for s in live])
            for s in live:
                engine.tokens[s, 0] = served[s]
            yield call, out


def _replay(cfg, calls, fault, near_tie):
    """Replay the recorded ``calls`` through a plain-attention engine with
    ``fault`` planted in its MoE layers (None: the control): the tokens
    that differ from the served ones, those beyond a near-tie (a top-2 gap
    under ``near_tie``; 0: every differing token), and the decode steps in
    which a layer dropped an assignment."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg.replace(attn_impl="ref"), slots=4,
                      max_len=MAX_LEN, device="cuda")
    compared, differing, steps, drop_steps = 0, [], 0, 0
    with moe_fault(fault), moe_drops() as drops:
        for i, (call, rows) in enumerate(replay_engine_calls(eng, calls)):
            compared += len(rows)
            differing += [dict(r, call=i, kind=call[0]) for r in rows
                          if r["served"] != r["replayed"]]
            if call[0] == "step":
                steps += 1
                drop_steps += sum(drops) > 0
            drops.clear()
    del eng
    _free()
    bad = [d for d in differing if not d["top2_gap"] < near_tie]
    return {"fault": fault, "compared": compared,
            "differing": len(differing), "beyond_near_tie": len(bad),
            "first_differing": differing[:4], "rejected": bool(bad),
            "decode_steps": steps, "decode_steps_with_drops": drop_steps}


# phase_replay's settings, one entry an arch: the weight set that both the
# served and the replaying engines hold (``_engines_drawn_as``), and the
# top-2 gap under which a token may differ from the replay's (0: none may).
# granite-moe-1b-a400m: at the port's init float32 rounding alone decides
# its tokens (phase 20), so it serves contraction fan-in and allows
# near-ties.  deepseek-v3-671b: phase 36 gates its float32 prefill at the
# port's init
REPLAYS = {
    GRANITE: dict(weights="contraction_fan_in", near_tie=NEAR_TIE),
    DEEPSEEK: dict(weights="seeded", near_tie=0.0),
}


def phase_replay(out, arch):
    """float32 serving of ``arch``, gated by replaying the served run's
    engine calls through a plain-attention engine with the same weights
    (REPLAYS), fed the served tokens: the control must pass (every token
    equal, or for granite-moe-1b-a400m a near-tie) and each of MOE_FAULTS
    fail.  A capacity-limited MoE's output depends on the batch, so served
    tokens need not equal the sequential baseline's, which decodes each
    request alone (T=1, where top-8 of 32 or 256 never collides): it is
    served and reported, not gated."""
    from repro_torch.serve import all_requests, run_sequential, run_serve
    setting = REPLAYS[arch]
    load = _load()
    cfg = _cfg(arch).replace(dtype="float32")
    fa_before = _fa_variants()
    with _engines_drawn_as(setting["weights"]):
        with record_engine_calls() as calls:
            res = run_serve(arch=arch, reduced=False, clients=2, slots=4,
                            max_len=MAX_LEN, load=load, device="cuda",
                            dtype="float32", overrides=CUTS.get(arch))
        r = res["result"]
        served = {rec["id"]: rec["tokens"] for rec in r["records"]}
        del res
        _free()
        runs = {str(f): _replay(cfg, calls, f, setting["near_tie"])
                for f in (None,) + MOE_FAULTS}
        seq = run_sequential(cfg, all_requests(load, 2, cfg.vocab),
                             max_len=MAX_LEN, realtime=False, device="cuda")
        _free()
    _check_float32_simt(_fa_variants_since(fa_before), f"replay {arch}")
    seq_diff = []
    for rec in seq:
        a, b = served[rec["id"]], rec["tokens"]
        if a != b:
            seq_diff.append({"id": rec["id"], "first_step": next(
                (i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b))), "tokens": len(b),
                "differing": sum(x != y for x, y in zip(a, b))})
    control = runs["None"]
    report = {"arch": arch, "dtype": "float32",
              "weights": setting["weights"], "requests": len(served),
              "calls": len(calls), "served_steps": r["steps"],
              "near_tie": setting["near_tie"], "replays": runs,
              "sequential_requests_differing": len(seq_diff),
              "sequential_differing": seq_diff}
    log("replay " + json.dumps(report))
    checks = {
        "served == 8": r["served"] == load.requests,
        "every token compared": control["compared"] == load.requests + sum(
            len(c[1]) for c in calls if c[0] == "step"),
        "control passes": not control["rejected"],
        **{f"{f} rejected": runs[f]["rejected"] for f in MOE_FAULTS},
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"replay checks failed: {failed}")
    out[f"replay_{arch}"] = report


# ------------------------------------------------------------- the SSD scan
def ssd_bound(B, T, H, G, N, P, chunk, dtype, init):
    """Least time for one SSD scan: each input read once and each output
    written once over the memory rate, against the operations this T needs
    over the peak rate of the inputs' dtype.  Operations: per chunk of v
    live steps with q = v (v + 1) / 2 causal pairs, c.b^T once per group
    (2 N q), and per head att.x (2 P q), c.S_prev and the state update
    (2 v N P each)."""
    elem = 2 if dtype == "bfloat16" else 4
    state = B * H * N * P * 4
    nbytes = (B * T * H * P * elem + B * T * H * 4 + H * 4
              + 2 * B * T * G * N * elem + B * T * H * P * 4
              + state * (2 if init else 1))
    flops = 0
    for t0 in range(0, T, chunk):
        v = min(chunk, T - t0)
        q = v * (v + 1) // 2
        flops += B * (G * 2 * N * q + H * (2 * P * q + 4 * v * N * P))
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _ssd_inputs(B, T, H, G, N, P, dtype, init, seed, dt_shift=0.0):
    """x, b, c as views of one (B, T, H*P + 2*G*N) buffer, as the model
    slices its conv output; dt a softplus; a_log float32."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    xbc = torch.randn((B, T, H * P + 2 * G * N), generator=g,
                      device="cuda").to(getattr(torch, dtype))
    x = xbc[..., :H * P].reshape(B, T, H, P)
    b = xbc[..., H * P:H * P + G * N].reshape(B, T, G, N)
    c = xbc[..., H * P + G * N:].reshape(B, T, G, N)
    dt = F.softplus(torch.randn((B, T, H), generator=g, device="cuda")
                    + dt_shift)
    a_log = torch.randn((H,), generator=g, device="cuda") * 0.5
    s0 = (torch.randn((B, H, N, P), generator=g, device="cuda")
          if init else None)
    return x, dt, a_log, b, c, s0


def _scaled_err(got, want):
    """Max abs error, the absolute limit SSD_TOL * max|want| applied to
    every element, and whether the error is within it."""
    err = float((got.float() - want.float()).abs().max())
    limit = SSD_TOL * max(1.0, float(want.float().abs().max()))
    return err, limit, err <= limit


def _ssd_grads(scan, x, dt, a_log, b, c, w):
    """The grads of sum(w * y) for x, dt, a_log, b, c, y = ``scan``'s."""
    import torch
    ins = [t.detach().requires_grad_() for t in (x, dt, a_log, b, c)]
    y = scan(*ins)
    return torch.autograd.grad((y * w).sum(), ins)


def _ssd_grad_check(x, dt, a_log, b, c, chunk, variant, seed):
    """The SSD gradient check (see SSD_TRAIN_T) on these inputs: whether
    each input's grad equals the plain one and its max abs error, the
    kernel variant the forward launched (it must be ``variant``), one
    backward recompute counted, and the plain side's scan with the term
    between chunks dropped (``_faulty_ssd``), which it must reject."""
    import torch
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_padded_reference
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(x.shape, generator=g, device="cuda")
    before = (dict(ops.launches_by_variant), ops.backward_recomputes)
    got = _ssd_grads(lambda *a: ops.ssd(*a, chunk=chunk), x, dt, a_log, b,
                     c, w)
    torch.cuda.synchronize()
    ran = [v for v, k in ops.launches_by_variant.items()
           if k != before[0][v]]
    recomputes = ops.backward_recomputes - before[1]

    def errors(plain):
        want = _ssd_grads(plain, x, dt, a_log, b, c, w)
        return {name: (float((a.float() - e.float()).abs().max()),
                       a.dtype == e.dtype and torch.equal(a, e))
                for name, a, e in zip(("x", "dt", "a_log", "b", "c"), got,
                                      want)}
    sound = errors(lambda *a: ssd_padded_reference(*a, chunk=chunk)[0])
    fault = errors(lambda *a: _faulty_ssd(SSD_TRAIN_FAULT, *a,
                                          chunk=chunk)[0])
    rejected = not all(e[1] for e in fault.values())
    ok = (all(e[1] for e in sound.values()) and recomputes == 1
          and ran == [variant] and rejected)
    return {"max_abs_err": {k: e[0] for k, e in sound.items()},
            "equal": {k: e[1] for k, e in sound.items()},
            "variant": ran, "backward_recomputes": recomputes,
            "planted_faults": {SSD_TRAIN_FAULT: {
                "max_abs_err": {k: e[0] for k, e in fault.items()},
                "rejected": rejected}},
            "ok": ok}


def phase_ssd(out):
    import torch
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_padded_reference
    cases = [dict(B=B, T=T, H=H, G=G, N=N, P=P, chunk=q, dtype=dt, init=i)
             for (B, T, H, G, N, P, q, dt, i) in SSD_CASES]
    cases += [dict(B=1, T=T, H=32, G=1, N=128, P=64, chunk=128,
                   dtype="bfloat16", init=True, path=MAMBA)
              for T in SSD_PATH_T]
    cases.append(dict(cases[-1], path=False, dt_shift=DT_SHIFT))
    cases += [dict(B=2, T=T, H=32, G=1, N=128, P=64, chunk=128, dtype=dt,
                   init=False, path=SSD_TRAIN_PATH)
              for T in SSD_TRAIN_T for dt in ("bfloat16", "float32")]
    rows = []
    for n, c in enumerate(cases):
        x, dt, a_log, b, cc, s0 = _ssd_inputs(
            c["B"], c["T"], c["H"], c["G"], c["N"], c["P"], c["dtype"],
            c["init"], seed=100 + n, dt_shift=c.get("dt_shift", 0.0))
        before = dict(ops.launches_by_variant)
        y, fin = ops.ssd_fwd(x, dt, a_log, b, cc, chunk=c["chunk"],
                             init_state=s0)
        yr, fr = ssd_padded_reference(x, dt, a_log, b, cc, chunk=c["chunk"],
                                      init_state=s0)
        torch.cuda.synchronize()
        ran = [v for v, k in ops.launches_by_variant.items()
               if k != before[v]]
        err_y, lim_y, ok_y = _scaled_err(y, yr)
        err_s, lim_s, ok_s = _scaled_err(fin, fr)
        row = {k: c[k] for k in ("B", "T", "H", "G", "N", "P", "chunk",
                                 "dtype", "init")}
        row["dt_shift"] = c.get("dt_shift", 0.0)
        chosen = ops.variant(x.dtype, c["N"], c["P"], c["chunk"],
                             ops.aligned(x, b, cc))
        row.update(variant=ran[0] if len(ran) == 1 else ran,
                   max_abs_err=err_y, max_abs_err_state=err_s,
                   max_abs_y=float(yr.abs().max()), tol=lim_y,
                   tol_state=lim_s,
                   ok=ok_y and ok_s and ran == [chosen],
                   path=c.get("path", False))
        if row["path"] and row["variant"] != PATH_VARIANT[c["dtype"]]:
            row["ok"] = False              # a path's case
        if row["path"]:
            kw = dict(chunk=c["chunk"], init_state=s0)
            # the chosen kernel, then the SIMT kernel on the same inputs
            for key, v in (("", chosen), ("simt_", "simt"))[
                    :1 if chosen == "simt" else 2]:
                row[key + "ms"] = cuda_ms(lambda: ops.ssd_fwd(
                    x, dt, a_log, b, cc, kernel=v, **kw))
                (row[key + "device_ms"],
                 row[key + "device_launches_recorded"],
                 row[key + "device_windows"]) = kernel_device_ms(
                    lambda: ops.ssd_fwd(x, dt, a_log, b, cc, kernel=v,
                                        **kw),
                    SSD_ENTRY[v], event_ms=row[key + "ms"])
            row["plain_ms"] = cuda_ms(lambda: ssd_padded_reference(
                x, dt, a_log, b, cc, **kw))
            row["library_ms"] = None
            row.update(ssd_bound(c["B"], c["T"], c["H"], c["G"], c["N"],
                                 c["P"], c["chunk"], c["dtype"],
                                 c["init"]))
        if row["path"] == SSD_TRAIN_PATH:
            row["grad_check"] = _ssd_grad_check(
                x, dt, a_log, b, cc, c["chunk"], PATH_VARIANT[c["dtype"]],
                seed=200 + n)
            if not row["grad_check"]["ok"]:
                row["ok"] = False
        if c["T"] == SSD_TIMED_T:
            # this check must pass the control and reject each fault
            row["planted_faults"] = {}
            for f in (SSD_CONTROL,) + KERNEL_FAULTS:
                yf, ff = _faulty_ssd(f, x, dt, a_log, b, cc,
                                     chunk=c["chunk"], init_state=s0)
                ey, _, oy = _scaled_err(yf, yr)
                es, _, os_ = _scaled_err(ff, fr)
                row["planted_faults"][f] = {
                    "max_abs_err": ey, "max_abs_err_state": es,
                    "rejected": not (oy and os_)}
                if row["planted_faults"][f]["rejected"] == (f == SSD_CONTROL):
                    row["ok"] = False
        log("ssd_fwd " + json.dumps(row))
        rows.append(row)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"SSD kernel disagrees with plain version, "
                             f"or its check misjudges a planted fault: "
                             f"{bad}")
    out["ssd_cases"] = rows


# ----------------------------------------------------------- the RG-LRU scan
def rglru_bound(B, T, W, h0):
    """Least time for one RG-LRU scan: x, r, i read and h written once
    (float32), lam, h0 and the final state, over the memory rate, against
    11 float32 operations a (b, t, w) element (log_a, 2 log_a, two exp,
    1 - e, max, sqrt, i x, the product, and the multiply-add of the
    carry) over the float32 rate."""
    nbytes = 4 * (4 * B * T * W + W + B * W * (2 if h0 else 1))
    flops = 11 * B * T * W
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS["float32"]
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _rglru_inputs(B, T, W, h0, lam, seed):
    """x normal, r and i sigmoids of normals, float32; lam as the
    reference's kernel test draws it (``"test"``: |normal| + 0.2) or as
    Griffin's init does (``"griffin"``); h0 normal or None."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, r, i = (torch.randn((B, T, W), generator=g, device="cuda")
               for _ in range(3))
    r, i = torch.sigmoid(r), torch.sigmoid(i)
    if lam == "griffin":
        lo, hi = GRIFFIN_A
        u = lo + (hi - lo) * torch.rand((W,), generator=g, device="cuda",
                                        dtype=torch.float64)
        lv = torch.log(torch.expm1(-torch.log(u) / 8)).float()
    else:
        lv = torch.randn((W,), generator=g, device="cuda").abs() + 0.2
    s0 = torch.randn((B, W), generator=g, device="cuda") if h0 else None
    return x, r, i, lv, s0


def _rg_err(got, want):
    """Max abs error, max of |got - want| / (1 + |want|), and whether every
    element is within RG_TOL * (1 + |want|)."""
    err = (got - want).abs()
    ratio = float((err / (1 + want.abs())).max())
    return float(err.max()), ratio, ratio <= RG_TOL


def _faulty_rglru(fault, x, r, i, lam, h0=None, at=None):
    """The plain RG-LRU scan with one planted fault (RG_FAULTS; reset_once
    drops the carry at step ``at``), or none: in pieces (RG_CONTROL).
    Returns (h float32, final state)."""
    import torch
    from repro_torch.kernels.rglru.ref import rglru_coeffs, rglru_reference
    if fault == "bf16_carry":
        a, b = rglru_coeffs(x, r, i, lam)
        h = (torch.zeros_like(a[:, 0]) if h0 is None else h0.float())
        hs = []
        for t in range(a.shape[1]):
            h = a[:, t] * h + b[:, t]
            h = h.bfloat16().float()
            hs.append(h)
        return torch.stack(hs, dim=1), h
    s = None if fault == "no_h0" else h0
    T = x.shape[1]
    cuts = ([0, at, T] if fault == "reset_once"
            else list(range(0, T, RG_PIECE)) + [T])
    hs = []
    for t0, t1 in zip(cuts, cuts[1:]):
        piece = slice(t0, t1)
        h, fin = rglru_reference(x[:, piece], r[:, piece], i[:, piece], lam,
                                 h0=s)
        hs.append(h)
        s = None if fault in ("reset_128", "reset_once") else fin
    return torch.cat(hs, dim=1), fin


def _faulty_rglru_scan(fault):
    """``models.rglru._scan`` on the plain path with ``fault`` planted."""
    def scan(cfg, xf, r, i, lam, h0=None):
        return _faulty_rglru(fault, xf, r, i, lam, h0)
    return scan


def phase_rglru(out):
    import torch
    from repro_torch.kernels.rglru import ops
    from repro_torch.kernels.rglru.ref import rglru_reference
    cases = [dict(B=B, T=T, W=W, h0=h0, lam=lam)
             for (B, T, W, h0, lam) in RG_CASES]
    cases += [dict(B=1, T=T, W=4096, h0=True, lam="test", path=True)
              for T in RG_PATH_T]
    cases.append(dict(cases[-1], path=False, lam="griffin"))
    cases += [dict(cases[-2], T=RG_LONG_T), dict(cases[-1], T=RG_LONG_T)]
    rows = []
    for n, c in enumerate(cases):
        x, r, i, lv, s0 = _rglru_inputs(c["B"], c["T"], c["W"], c["h0"],
                                        c["lam"], seed=200 + n)
        h, fin = ops.rglru_fwd(x, r, i, lv, h0=s0)
        hr, fr = rglru_reference(x, r, i, lv, h0=s0)
        torch.cuda.synchronize()
        err_h, ratio_h, ok_h = _rg_err(h, hr)
        err_s, ratio_s, ok_s = _rg_err(fin, fr)
        row = {k: c[k] for k in ("B", "T", "W", "h0", "lam")}
        launch = ops.launch_shape(c["B"], c["T"], c["W"])
        row.update(launch=launch, max_abs_err=err_h, max_abs_err_state=err_s,
                   max_err_over_1_plus_abs=max(ratio_h, ratio_s),
                   max_abs_h=float(hr.abs().max()), tol=RG_TOL,
                   ok=ok_h and ok_s, path=c.get("path", False))
        if row["path"]:
            row["ms"] = cuda_ms(lambda: ops.rglru_fwd(x, r, i, lv, h0=s0))
            (row["device_ms"], row["device_launches_recorded"],
             row["device_windows"]) = kernel_device_ms(
                lambda: ops.rglru_fwd(x, r, i, lv, h0=s0), "rglru_fwd_kernel",
                event_ms=row["ms"])
            row["plain_ms"] = cuda_ms(lambda: rglru_reference(x, r, i, lv,
                                                              h0=s0))
            row["library_ms"] = None
            row.update(rglru_bound(c["B"], c["T"], c["W"], c["h0"]))
        if c["T"] in (RG_TIMED_T, RG_LONG_T):
            # this check must pass the control and reject each fault
            row["planted_faults"] = {}
            span = launch["segments"] * launch["segment_steps"]
            for f in (RG_CONTROL,) + RG_FAULTS:
                if f == "reset_once" and c["T"] <= span:
                    continue
                hf, ff = _faulty_rglru(f, x, r, i, lv, s0, at=span)
                eh, qh, oh = _rg_err(hf, hr)
                es, qs, os_ = _rg_err(ff, fr)
                row["planted_faults"][f] = {
                    "max_abs_err": eh, "max_abs_err_state": es,
                    "max_err_over_1_plus_abs": max(qh, qs),
                    "rejected": not (oh and os_)}
                if row["planted_faults"][f]["rejected"] == (f == RG_CONTROL):
                    row["ok"] = False
        log("rglru_fwd " + json.dumps(row))
        rows.append(row)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"RG-LRU kernel disagrees with plain version, "
                             f"or its check misjudges a planted fault: "
                             f"{bad}")
    out["rglru_cases"] = rows


def _opened_the_card(pid):
    """Whether process ``pid`` has opened an NVIDIA device file: the CUDA
    driver does on its first call (``torch.cuda.is_available()`` too),
    while importing torch only maps the libraries, ``libcuda.so``
    included."""
    fd_dir = f"/proc/{pid}/fd"
    paths = []
    for fd in os.listdir(fd_dir):
        try:
            paths.append(os.readlink(os.path.join(fd_dir, fd)))
        except OSError:
            pass                          # closed while listed
    with open(f"/proc/{pid}/maps") as f:
        paths += [line.split()[-1] for line in f if line.strip()]
    return any(p.startswith("/dev/nvidia") for p in paths)


def _socket_kill_client(load):
    """Serve ``load`` over sockets, one process a rank, and SIGKILL client
    rank 2's process once the server has admitted a request; before the
    kill, record which processes have opened the card."""
    import tempfile
    import torch
    from repro_torch import edat
    from repro_torch.serve import serve_program
    with tempfile.TemporaryDirectory(prefix="smoke_kill_") as tmp:
        ready = os.path.join(tmp, "ready")
        with edat.Session(3, procs=3, transport="socket", timeout=300,
                          workers_per_rank=2, unconsumed="ignore") as s:
            s.start(edat.deferred(serve_program, arch=GEMMA, reduced=False,
                                  slots=4, max_len=MAX_LEN, load=load,
                                  # resolved here, as run_serve does, so
                                  # the clients never ask the driver
                                  device=torch.device("cuda"),
                                  ready_file=ready, ready_after=1))
            deadline = time.monotonic() + 180
            while not os.path.exists(ready):
                if time.monotonic() > deadline:
                    raise TimeoutError("the server admitted no request")
                time.sleep(0.05)
            opened = {rank: _opened_the_card(p.pid)
                      for rank, p in s._pg._procs.items()}
            time.sleep(0.2)
            s.kill(2)
            s.wait(240, check=False)
            return s.exitcodes(), s.gather(), opened


def phase_serve_socket(out):
    """gemma3-1b served over the socket transport at full width, with
    the server rank in its own spawned process: its kernel counts are
    read in that process (since its warm-up), the parent's must not
    move."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.serve import client_schedule, run_serve
    load = _load()
    cfg = ARCHS[GEMMA].cfg
    expected = path_kernels(cfg)
    parent0 = _counts()
    t0 = time.monotonic()
    res = run_serve(arch=GEMMA, reduced=False, clients=2, slots=4,
                    max_len=MAX_LEN, load=load, transport="socket",
                    procs=3, device="cuda")
    session_s = time.monotonic() - t0
    r, summary, wire = res["result"], res["summary"], res["stats"]["transport"]
    launches, plain = r["kernel_launches"], r["plain_calls"]
    fa_by_variant = r["launches_by_variant"]["flash_attention_fwd"]
    recs = r["records"]
    # the clients' release (READY) from their schedules: t_sched is the
    # client's start plus the request's offset
    offset = {q["id"]: q["t"] for c in range(2)
              for q in client_schedule(load, c, 2, cfg.vocab)}
    released = min(rec["t_sched"] - offset[rec["id"]] for rec in recs)
    split = {"session_s": session_s,
             "spawn_build_warmup_s": released - t0,
             "serving_window_s": summary["wall_s"],
             "rest_s": session_s - (released - t0) - summary["wall_s"]}
    log("serve_socket " + json.dumps({
        "arch": GEMMA, "card": out.get("card"), "dtype": cfg.dtype,
        "reading": "smoke, 8 requests", "transport": "socket",
        "procs": 3, **summary, "steps": r["steps"],
        "tick_execs": r["tick_execs"], "prefills": r["prefills"],
        "kernel_launches": launches, "plain_calls": plain,
        "flash_launches_by_variant": fa_by_variant, **split,
        **_request_lags(recs),
        "wire": {k: wire.get(k) for k in ("wire_events_sent", "writes",
                                          "wire_bytes", "loopback_events",
                                          "dropped")}}))
    checks = {
        "served == 8": r["served"] == load.requests,
        "prefills == 8": r["prefills"] == load.requests,
        "slots_leaked == 0": r["slots_leaked"] == 0,
        "queue_left == 0": r["queue_left"] == 0,
        "tick_execs == steps": r["tick_execs"] == r["steps"],
        **{f"{name} launches == {n} x prefills":
           launches[name] == n * r["prefills"]
           for name, n in expected.items()},
        "no other kernel launched": not any(
            n for k, n in launches.items() if k not in expected),
        "plain_calls == 0": not any(plain.values()),
        "every flash_attention_fwd launch mma_bf16":
            fa_by_variant["mma_bf16"] == launches["flash_attention_fwd"],
        "the parent launched nothing": _counts() == parent0,
        "tokens in vocab": all(0 <= t < cfg.vocab for rec in recs
                               for t in rec["tokens"]),
        "events crossed the wire": wire.get("wire_events_sent", 0) > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"socket serve checks failed: {failed}")
    out.setdefault("flash_main_path_by_variant", {})[
        f"{GEMMA} socket"] = fa_by_variant
    out["serve_socket"] = {"summary": summary, "steps": r["steps"],
                           "kernel_launches": launches,
                           "flash_launches_by_variant": fa_by_variant,
                           "plain_calls": plain, "split": split,
                           "wire": wire}
    out.setdefault("main_path_launches", {})[f"{GEMMA} socket"] = {
        name: launches[name] for name in expected}

    # float32: the socket-served tokens against phase 6's in-proc ones
    f32 = cfg.replace(dtype="float32")
    sock = run_serve(arch=GEMMA, reduced=False, clients=2, slots=4,
                     max_len=MAX_LEN, load=load, transport="socket",
                     procs=3, device="cuda", dtype="float32")
    got = {rec["id"]: rec["tokens"] for rec in sock["result"]["records"]}
    _check_float32_simt(sock["result"]["launches_by_variant"][
        "flash_attention_fwd"], "serve_socket float32 server")
    want = out.get(f"parity_{GEMMA}", {}).get("served_tokens")
    if want is None:                     # phase 6 did not run: serve here
        inproc = run_serve(arch=GEMMA, reduced=False, clients=2, slots=4,
                           max_len=MAX_LEN, load=load, device="cuda",
                           dtype="float32")
        want = {rec["id"]: rec["tokens"]
                for rec in inproc["result"]["records"]}
        del inproc
        _free()
    prompts = {q["id"]: q["prompt"] for c in range(2)
               for q in client_schedule(load, c, 2, cfg.vocab)}
    if set(got) != set(want):
        raise AssertionError("socket and in-proc request ids differ")
    diffs = []
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        if a == b:
            continue
        step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        gap = (_top2_gap(f32, prompts[rid], b, step)
               if step < min(len(a), len(b)) else float("inf"))
        diffs.append({"id": rid, "step": step, "top2_gap": gap})
        _free()
    log("parity_socket " + json.dumps({
        "arch": GEMMA, "requests": len(want), "against": "in-proc float32",
        "identical": len(want) - len(diffs), "differing": diffs}))
    bad = [d for d in diffs if not d["top2_gap"] < NEAR_TIE]
    if bad:
        raise AssertionError(f"float32 socket-served tokens differ from "
                             f"the in-proc ones beyond near-ties: {bad}")
    out["parity_socket"] = {"requests": len(want), "differing": diffs}

    # SIGKILL a client process mid-load: the server drains cleanly
    codes, kres, opened = _socket_kill_client(load)
    survivor = {q["id"] for q in client_schedule(load, 0, 2, cfg.vocab)}
    served = {rec["id"] for rec in kres["records"]} if kres else set()
    log("serve_socket_kill " + json.dumps({
        "exitcodes": codes, "dead": kres and kres["dead"],
        "served": kres and kres["served"], "survivor_requests":
        len(survivor), "opened_the_card": opened}))
    checks = {
        "server and survivor exit 0": codes[0] == 0 and codes[1] == 0,
        "victim exit non-zero": codes[2] not in (None, 0),
        "a result was gathered": kres is not None,
        "dead == [2]": bool(kres) and kres["dead"] == [2],
        "slots_leaked == 0": bool(kres) and kres["slots_leaked"] == 0,
        "queue_left == 0": bool(kres) and kres["queue_left"] == 0,
        "every survivor request served": survivor <= served,
        "plain_calls == 0": bool(kres) and not any(
            kres["plain_calls"].values()),
        "the server opened the card": opened[0],
        "no client opened the card": not opened[1] and not opened[2],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"socket kill checks failed: {failed}")
    out["serve_socket_kill"] = {"exitcodes": codes, "dead": kres["dead"],
                                "served": kres["served"],
                                "opened_the_card": opened}
    torch.cuda.synchronize()


# ---------------------------------------------------- the event-driven trainer
# phase 19: full-width gemma3-1b trained by EventDrivenTrainer.run, in-proc,
# 2 ranks on the one card; every rank's batch is 2 sequences of 512 (S % 128
# == 0: a shape where the reference's ops.supported also takes its kernel)
TRAIN_DATA = dict(vocab=262144, seq=512, global_batch=4, seed=7)
TRAIN_RANKS, TRAIN_STEPS, PARITY_STEPS = 2, 4, 3
# the float32 kernel-vs-plain gate of the trainer.  sgdm (updates linear in
# the grads) at lr 1 with clipping at norm 1: each step moves the weights by
# a unit-norm update, large against the weights' own float32 rounding, so a
# fault that changes the grads shows in the weights.  The kernel and the
# plain forward agree to ~1e-6 relative (phase 3's float32 cases), and the
# backward is the same plain recompute on both paths, so every loss must
# agree within TRAIN_LOSS_RTOL of its size and every weight w within
# TRAIN_PARAM_RTOL * |w| + TRAIN_PARAM_ATOL: the grads' ~1e-6 relative
# difference, carried through three steps into the weights, and ~80 float32
# ulps of each weight; 1e-6 for weights near 0.  The replicas
# of one run must be equal bit for bit (sync DP: both ranks average the
# same grads in the same order and apply the same update).  Planted:
# TRAIN_FAULTS["plain"] in the plain path must fail the parity gate,
# TRAIN_FAULTS["replicas"] must fail the replica gate; the fault-free runs
# pass both
TRAIN_PARITY_OPT = dict(name="sgdm", peak_lr=1.0, warmup=1, total_steps=100,
                        clip_norm=1.0)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL = 1e-5, 1e-6
# the float32 runs' depth, cut to keep the whole smoke run in its time
# limit (the bf16 main-path runs keep their full depth): gemma3-1b to one
# unit of its pattern (5 local layers and 1 global), mamba2-370m to 12
# of its 48 SSD layers; at full width both, and each cut config draws its
# own init (the stacked leaves at the cut layers axis' fan-in)
PARITY_CUTS = {GEMMA: dict(n_layers=6), MAMBA: dict(n_layers=12)}
TRAIN_FAULTS = {"plain": "attention_scale_x1.01",
                "replicas": "own_grads_only",
                "chunked": "chunked_window_plus_1"}


def _train_fault(fault):
    """A context that plants ``fault`` for one trainer run: TRAIN_FAULTS'
    attention faults, or one of SSD_FAULTS (or the control SSD_CONTROL) in
    the plain SSD scan; None plants nothing."""
    if fault == TRAIN_FAULTS["chunked"]:
        return chunked_fault()
    if fault == TRAIN_FAULTS["plain"]:
        return plain_scale_fault()
    if fault in (SSD_CONTROL,) + SSD_FAULTS:
        return _scan_fault("mamba2", _faulty_scan)(fault)
    return contextlib.nullcontext()


@contextlib.contextmanager
def _float_as_double():
    """While open, ``Tensor.float()`` widens to float64: a float64 model's
    float32 cast points (the softplus of dt, the SSD scan, the norms, the
    logits) stay float64, so its plain path computes in float64 throughout,
    and so do its grads on the way to the host (``_host32``)."""
    import torch
    widen, torch.Tensor.float = torch.Tensor.float, torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = widen


def _train_run(arch, dtype, attn_impl, opt, steps, fault=None,
               data=TRAIN_DATA, ranks=TRAIN_RANKS, params=None,
               overrides=None):
    """One in-proc EventDrivenTrainer.run of full-width ``arch`` (its
    config's remat, "full") on the card, ``ranks`` ranks on ``data`` (a
    DataCfg's fields), from ``params`` (host numpy, the model's tree) or
    the trainer's own seeded init; ``fault`` plants one of TRAIN_FAULTS
    (or, through ``_train_fault``, an SSD fault) for this run only;
    ``overrides`` replace config fields (a depth cut).  A ``dtype`` of
    "float64" (plain path only) runs under ``_float_as_double``.  Returns
    (trainer, result, host-clock arrival time of each metric)."""
    import torch
    from repro_torch.data import DataCfg
    from repro_torch.models import build_model
    from repro_torch.optim import OptCfg
    from repro_torch.runtime_dist import trainer as rt
    cfg = _cfg(arch).replace(dtype=dtype, attn_impl=attn_impl,
                             **(overrides or {}))
    # a full-width step takes seconds: the straggler bound must not cut a
    # rank out of a synchronous step
    tcfg = rt.TrainerCfg(steps=steps, n_ranks=ranks, collect_timeout=600.0)
    tr = rt.EventDrivenTrainer(build_model(cfg), DataCfg(**data),
                               OptCfg(**opt), tcfg,
                               device=torch.device("cuda"), params=params)
    arrivals = []
    tr.on_metric = lambda m: arrivals.append(
        (time.monotonic(), m["rank"], m["step"]))
    ensure_own = rt.QuorumCollector.ensure_own
    if fault == TRAIN_FAULTS["replicas"]:
        def own_only(self, rank, grads):
            self.got = {rank: grads}
        rt.QuorumCollector.ensure_own = own_only
    wide = (_float_as_double() if dtype == "float64"
            else contextlib.nullcontext())
    try:
        t0 = time.monotonic()
        with _train_fault(fault), wide:
            res = tr.run(timeout=900)
        torch.cuda.synchronize()
    finally:
        rt.QuorumCollector.ensure_own = ensure_own
    res["wall_s"] = time.monotonic() - t0
    res["metric_arrivals_s"] = [(t - t0, r, s) for t, r, s in arrivals]
    return tr, res


def _train_params(arch, weights, n_layers=None):
    """Full-width ``arch``'s float32 init on the card (seed 0), at
    ``n_layers`` if given, rescaled in place by each weight set of
    ``weights`` (``_weight_set``) in turn, as host numpy: a trainer's
    ``params``."""
    from repro_torch import bridge
    model = _full_model(arch, "float32", "ref", n_layers=n_layers)
    for name in weights:
        _weight_set(name, model)
    tree = bridge.params_to_numpy(model)
    del model
    _free()
    return tree


def _losses(res):
    return {(m["rank"], m["step"]): m["loss"] for m in res["history"]}


def _replicas_equal(res):
    """Whether rank 0's and rank 1's final trees are equal bit for bit."""
    import torch
    from repro_torch.tree import tree_leaves
    a, b = res["final_params"][:2]
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _parity(kres, rres):
    """The float32 gate of two runs: its ratios (<= 1 passes)."""
    from repro_torch.tree import tree_leaves
    kl, rl = _losses(kres), _losses(rres)
    if sorted(kl) != sorted(rl):
        raise AssertionError(f"loss histories differ in shape: {sorted(kl)} "
                             f"against {sorted(rl)}")
    loss = max(abs(kl[k] - rl[k]) / (TRAIN_LOSS_RTOL * abs(rl[k]))
               for k in rl)
    param, diff = 0.0, 0.0
    for x, y in zip(tree_leaves(kres["final_params"][0]),
                    tree_leaves(rres["final_params"][0])):
        d = (x.float() - y.float()).abs()
        diff = max(diff, float(d.max()))
        param = max(param, float((d / (TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL
                                       * y.float().abs())).max()))
    return {"loss_ratio": loss, "param_ratio": param,
            "max_abs_param_diff": diff,
            "max_abs_loss_diff": max(abs(kl[k] - rl[k]) for k in rl),
            "rejected": not (loss <= 1.0 and param <= 1.0)}


def _step_split(tr, data_step):
    """One bf16 step of rank 0, piece by piece, each piece ending in a
    device sync, host clock (ms): the forward and backward (its first,
    cold call is timed apart and left out of the step), the grads'
    device-to-host copy, the quorum reduce of 2 ranks' grads on the host,
    the mean's host-to-device copy and the optimizer update; then the
    forward and backward again under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime_dist.trainer import QuorumCollector, _host32
    from repro_torch.train import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map
    st, ranks = tr.states[0], tr.cfg.n_ranks
    batch = {k: torch.from_numpy(v).to("cuda", torch.long)
             for k, v in tr.data.batch(data_step, 0, ranks).items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        return val, (time.perf_counter() - t0) * 1e3

    split = {}
    fwd_bwd = lambda: value_and_grad(tr.model, st.params, batch)  # noqa
    # the first call after _free() takes its activations' memory from the
    # CUDA driver (the caching allocator was emptied): timed apart, as cold
    _, split_cold_ms = timed(fwd_bwd)
    (_, grads), split["forward_backward_ms"] = timed(fwd_bwd)
    host, split["grads_to_host_ms"] = timed(
        lambda: tree_map(_host32, grads))
    del grads
    coll = QuorumCollector(step=0, epoch=0, need=ranks, stale_discount=0.5)
    for r in range(ranks):          # rank 0's grads stand in for each rank's
        coll.offer({"rank": r, "step": 0, "epoch": 0, "grads": host})
    (gavg, _, _), split["quorum_reduce_ms"] = timed(coll.reduce)
    del host, coll
    gdev, split["mean_to_device_ms"] = timed(lambda: tree_map(
        lambda a: torch.from_numpy(a).to("cuda"), gavg))
    del gavg

    def update():
        with torch.no_grad():
            return tr.opt.update(gdev, st.opt_state, st.params, st.step)
    _, split["optimizer_update_ms"] = timed(update)
    del gdev
    split["step_ms"] = sum(split.values())
    split["forward_backward_cold_ms"] = split_cold_ms
    grad_bytes = sum(p.numel() for p in tree_leaves(st.params)) * 4
    split["grad_bytes_float32"] = grad_bytes
    # the busy share is the profiled call's device time over that same
    # call's host wall (the profiler's own cost included)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_ms = timed(fwd_bwd)
    device_ms, n_kernels, top = _kernel_time(prof)
    split["forward_backward_profile"] = {
        "device_ms": device_ms, "wall_ms": wall_ms, "kernels": n_kernels,
        "device_busy_share": device_ms / wall_ms,
        "top_kernels_ms_count": top}
    return split


def _parity_run(arch, impl, fault, dtype, data, params):
    """One PARITY_STEPS-step sgdm trainer run of ``arch`` at
    TRAIN_PARITY_OPT, cut in depth by PARITY_CUTS: (its result with rank
    0's tree only, whether the ranks' trees ended equal)."""
    tr, res = _train_run(arch, dtype, impl, TRAIN_PARITY_OPT, PARITY_STEPS,
                         fault, data=data, params=params,
                         overrides=PARITY_CUTS.get(arch))
    del tr
    equal = _replicas_equal(res)
    del res["final_params"][1:]           # rank 0's tree is compared
    _free()
    return res, equal


def _parity_floor(arch, data, params):
    """The plain path's float64 floor: its float32 run held to its float64
    run by the float32 gate (``_parity``)."""
    r32, _ = _parity_run(arch, "ref", None, "float32", data, params)
    r64, _ = _parity_run(arch, "ref", None, "float64", data, params)
    floor = _parity(r32, r64)
    del r32, r64
    _free()
    return floor


def _parity_runs(arch, runs, data=TRAIN_DATA, params=None):
    """The kernel path's float32 run ("kernel"), then ``runs``: (name,
    attn_impl, fault) in order, each float32 and held to the kernel run by
    the float32 gate (``_parity``, its "gate"), but the replica fault's,
    which the replica gate judges.  Returns {name: {"replicas_equal",
    "wall_s", "gate"}}, the kernel run's losses beside its entry."""
    kres, equal = _parity_run(arch, "kernel", None, "float32", data, params)
    report = {"kernel": {
        "replicas_equal": equal, "wall_s": kres["wall_s"],
        "losses": {f"{r}/{s}": v for (r, s), v in _losses(kres).items()}}}
    for name, impl, fault in runs:
        res, equal = _parity_run(arch, impl, fault, "float32", data, params)
        report[name] = {"replicas_equal": equal, "wall_s": res["wall_s"]}
        if fault != TRAIN_FAULTS["replicas"]:
            report[name]["gate"] = _parity(kres, res)
        del res
        _free()
    del kres
    _free()
    return report


def phase_train(out):
    """gemma3-1b trained by the event-driven trainer at full width (the
    training main path), then the float32 parity of its kernel path
    against its plain path, with planted faults."""
    import math
    import resource
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import ops as fa
    cfg = ARCHS[GEMMA].cfg
    # each rank-step runs every attention layer's backward once, and its
    # forward once more under remat (the config's "full"): the recompute
    recomputes_want = path_kernels(cfg)["flash_attention_fwd"] \
        * TRAIN_RANKS * TRAIN_STEPS
    expected = recomputes_want * (1 if cfg.remat == "none" else 2)
    all_ops = _all_ops()
    torch.cuda.synchronize()
    for ops in all_ops.values():
        ops.reset_counts()                 # the main path's counts only
    tr, res = _train_run(GEMMA, "bfloat16", "kernel", {"name": "adamw"},
                         TRAIN_STEPS)
    launches = {k: ops.kernel_launches for k, ops in all_ops.items()}
    plain = {k: ops.plain_calls for k, ops in all_ops.items()}
    by_path = dict(fa.backward_by_path)
    fa_by_variant = dict(fa.launches_by_variant)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = _losses(res)
    row = {"arch": GEMMA, "card": out.get("card"), "dtype": cfg.dtype,
           "remat": cfg.remat,
           "ranks": TRAIN_RANKS, "steps": TRAIN_STEPS, "optimizer": "adamw",
           "data": TRAIN_DATA, "wall_s": res["wall_s"],
           "metric_arrivals_s": res["metric_arrivals_s"],
           "losses": {f"{r}/{s}": v for (r, s), v in losses.items()},
           "kernel_launches": launches, "plain_calls": plain,
           "flash_launches_by_variant": fa_by_variant,
           "backward_by_path": by_path,
           "timeouts": res["timeouts"],
           "max_memory_allocated_gib": peak_gib}
    checks = {
        f"{len(losses)} losses == ranks x steps":
            len(losses) == TRAIN_RANKS * TRAIN_STEPS,
        "every loss finite": all(math.isfinite(v) for v in losses.values()),
        "replicas equal": _replicas_equal(res),
        f"flash_attention_fwd launches == {expected}":
            launches["flash_attention_fwd"] == expected,
        "every flash_attention_fwd launch mma_bf16":
            fa_by_variant["mma_bf16"] == expected,
        "no other kernel launched": not any(
            n for k, n in launches.items() if k != "flash_attention_fwd"),
        "plain_calls == 0": not any(plain.values()),
        f"backward recomputes == {recomputes_want}, all dense":
            by_path == {"dense": recomputes_want, "chunked": 0},
        "no straggler timeout": res["timeouts"] == 0,
    }
    del res
    _free()
    split = _step_split(tr, TRAIN_STEPS)
    del tr
    _free()
    row["step_split"] = split
    row["peak_rss_gib"] = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                           / 2 ** 20)
    log("train " + json.dumps(row))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train checks failed: {failed}")
    out[f"train_{GEMMA}"] = row
    out.setdefault("main_path_launches", {})[f"{GEMMA}-train"] = {
        "flash_attention_fwd": launches["flash_attention_fwd"]}
    out.setdefault("flash_main_path_by_variant", {})[
        f"{GEMMA}-train"] = fa_by_variant

    # float32: the kernel path against the plain path, planted faults
    fa_before = _fa_variants()
    report = _parity_runs(GEMMA, (
        ("plain", "ref", None),
        (TRAIN_FAULTS["plain"], "ref", TRAIN_FAULTS["plain"]),
        (TRAIN_FAULTS["replicas"], "kernel", TRAIN_FAULTS["replicas"])))
    _check_float32_simt(_fa_variants_since(fa_before), "train float32")
    log("train_parity " + json.dumps({
        "arch": GEMMA, "dtype": "float32", "optimizer": TRAIN_PARITY_OPT,
        "steps": PARITY_STEPS, "loss_rtol": TRAIN_LOSS_RTOL,
        "param_rtol": TRAIN_PARAM_RTOL, "param_atol": TRAIN_PARAM_ATOL,
        **report}))
    checks = {
        "float32 kernel path == plain path": not report["plain"]["gate"][
            "rejected"],
        "the plain fault fails the gate": report[TRAIN_FAULTS["plain"]][
            "gate"]["rejected"],
        "kernel run replicas equal": report["kernel"]["replicas_equal"],
        "plain run replicas equal": report["plain"]["replicas_equal"],
        "the own-grads fault fails the replica gate":
            not report[TRAIN_FAULTS["replicas"]]["replicas_equal"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train parity checks failed: {failed}")
    out[f"train_parity_{GEMMA}"] = report


# ------------------------------------ training at the chunked length
# phase 40: full-width gemma3-1b trained at 8,192 tokens, the length from
# which the reference's training attention is chunked (S >= 8192, a
# multiple of 2048): its plain path runs chunked_attention forward and
# backward, the flash kernel's backward recomputes through the chunked vjp.
# One rank, one sequence a step: two in-proc ranks step at once on the one
# card and would not fit (PERF.md §5 reckons the peak).
LONG_TRAIN_DATA = dict(vocab=262144, seq=8192, global_batch=1, seed=7)
LONG_TRAIN_RANKS, LONG_TRAIN_STEPS = 1, 2
LONG_TRAIN_PATH = f"{GEMMA}-train-8k"
# remat's effect, one value_and_grad a setting ("none" twice: the control).
# The losses must be equal bit for bit (remat reruns the same forward).
# Each grad leaf's distance from the first "none" run's, relative to the
# leaf's largest magnitude, must be within 2 x the control's distance on
# that leaf: bit-equal where the two "none" runs are bit-equal.  The
# embedding's backward adds its rows with atomics, so two identical runs
# need not repeat it bit for bit; the control measures how far they part
REMAT_RUNS = ("none", "none_again", "dots", "full")
# the chunked backward against the dense one, float32, one attention call
# at gemma3-1b's shape: every grad within CHUNKED_GRAD_TOL of the dense
# backward's largest magnitude (the two sum over keys in another order)
CHUNKED_S = (8192, 16384)
CHUNKED_GRAD_TOL = 1e-4


def _remat_effect(cfg):
    """One value_and_grad of full-width gemma3-1b on one seeded sequence
    of 8,192 tokens (bf16, seeded weights) at each of REMAT_RUNS: its peak
    device memory above what it started from, its wall, its loss, and each
    grad leaf's largest distance from the first "none" run's, relative to
    the leaf's largest magnitude."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.train import value_and_grad
    from repro_torch.tree import tree_leaves
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = build_model(cfg).init(gen).params.to_dict()
    toks = torch.randint(0, cfg.vocab, (1, LONG_TRAIN_DATA["seq"]),
                         generator=gen, device="cuda")
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    runs, ref = {}, None
    for name in REMAT_RUNS:
        remat = name.split("_")[0]
        _free()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (loss, _), grads = value_and_grad(
            build_model(cfg.replace(remat=remat)), params, batch)
        torch.cuda.synchronize()
        row = {"remat": remat, "wall_ms": (time.perf_counter() - t0) * 1e3,
               "loss": float(loss),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "peak_above_start_gib": (torch.cuda.max_memory_allocated()
                                        - base) / 2 ** 30}
        leaves = tree_leaves(grads)
        if ref is None:
            ref = leaves
        else:
            row["grad_rel_diff"] = [
                float((a.float() - b.float()).abs().max()
                      / b.float().abs().max().clamp_min(1e-30))
                for a, b in zip(leaves, ref)]
        del grads, leaves
        runs[name] = row
    control = runs["none_again"]["grad_rel_diff"]
    tol = [2 * c for c in control]
    for name in ("dots", "full"):
        runs[name]["grads_ok"] = all(
            d <= t for d, t in zip(runs[name]["grad_rel_diff"], tol))
    return runs, tol


def _chunked_vs_dense():
    """One flash attention call at gemma3-1b's shape (B=1, H=4, KH=1,
    D=256), float32, at each of CHUNKED_S and PATH_WINDOWS: its grads
    through the wrapper (the kernel's forward, the backward recomputed by
    the chunked vjp at these lengths) against the dense plain version's
    autograd, with each one's peak device memory and host wall."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    rows = []
    for S in CHUNKED_S:
        for window in PATH_WINDOWS:
            gen = torch.Generator(device="cuda").manual_seed(S)
            q, k, v, go = (torch.randn((1, S, h, 256), generator=gen,
                                       device="cuda") for h in (4, 1, 1, 4))
            kw = dict(scale=256 ** -0.5, causal=True, window=window,
                      softcap=None)
            row = dict(B=1, S=S, H=4, KH=1, D=256, window=window,
                       dtype="float32")
            grads = {}
            for path, fn in (("dense", fa.attention_ref),
                             ("chunked", fa.flash_attention)):
                _free()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                before = dict(fa.backward_by_path)
                t0 = time.perf_counter()
                qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
                grads[path] = torch.autograd.grad(fn(qq, kk, vv, **kw),
                                                  (qq, kk, vv), go)
                torch.cuda.synchronize()
                row[f"{path}_ms"] = (time.perf_counter() - t0) * 1e3
                row[f"{path}_peak_above_start_gib"] = (
                    torch.cuda.max_memory_allocated() - base) / 2 ** 30
                row[f"{path}_backward_by_path"] = {
                    p: fa.backward_by_path[p] - before[p]
                    for p in fa.BACKWARD_PATHS}
            row["rel_err"] = max(
                float((c - d).abs().max() / d.abs().max())
                for c, d in zip(grads["chunked"], grads["dense"]))
            del grads
            row["ok"] = (row["rel_err"] <= CHUNKED_GRAD_TOL
                         and row["chunked_backward_by_path"]
                         == {"dense": 0, "chunked": 1})
            log("chunked_vs_dense " + json.dumps(row))
            rows.append(row)
    return rows


@contextlib.contextmanager
def _chunked_calls():
    """Count the plain path's calls of ``attention.chunked_attention``
    (a list that grows by one a call) while open."""
    from repro_torch.models import attention
    chunked, calls = attention.chunked_attention, []

    def counted(*a, **kw):
        calls.append(1)
        return chunked(*a, **kw)
    attention.chunked_attention = counted
    try:
        yield calls
    finally:
        attention.chunked_attention = chunked


def phase_train_long(out):
    """gemma3-1b trained at full width and depth on 8,192 tokens a step
    (the trainer's main path at the reference's chunked length, remat
    "full"), remat's effect on one step's memory, the chunked backward
    against the dense one, and the float32 parity of the kernel path
    against the chunked plain path with a fault planted in the latter."""
    import math
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import ops as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[GEMMA].cfg
    per_step = path_kernels(cfg)["flash_attention_fwd"]
    rank_steps = LONG_TRAIN_RANKS * LONG_TRAIN_STEPS
    expected = 2 * per_step * rank_steps      # forward + remat recompute
    all_ops = _all_ops()
    torch.cuda.synchronize()
    for ops in all_ops.values():
        ops.reset_counts()                 # the main path's counts only
    tr, res = _train_run(GEMMA, "bfloat16", "kernel", {"name": "adamw"},
                         LONG_TRAIN_STEPS, data=LONG_TRAIN_DATA,
                         ranks=LONG_TRAIN_RANKS)
    launches = {k: ops.kernel_launches for k, ops in all_ops.items()}
    plain = {k: ops.plain_calls for k, ops in all_ops.items()}
    by_path = dict(fa.backward_by_path)
    fa_by_variant = dict(fa.launches_by_variant)
    losses = _losses(res)
    row = {"arch": GEMMA, "card": out.get("card"), "dtype": cfg.dtype,
           "remat": cfg.remat, "ranks": LONG_TRAIN_RANKS,
           "steps": LONG_TRAIN_STEPS, "optimizer": "adamw",
           "data": LONG_TRAIN_DATA, "wall_s": res["wall_s"],
           "metric_arrivals_s": res["metric_arrivals_s"],
           "losses": {f"{r}/{s}": v for (r, s), v in losses.items()},
           "kernel_launches": launches, "plain_calls": plain,
           "flash_launches_by_variant": fa_by_variant,
           "backward_by_path": by_path, "timeouts": res["timeouts"],
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30}
    checks = {
        f"{len(losses)} losses == ranks x steps": len(losses) == rank_steps,
        "every loss finite": all(math.isfinite(v) for v in losses.values()),
        f"flash_attention_fwd launches == {expected}":
            launches["flash_attention_fwd"] == expected,
        "every flash_attention_fwd launch mma_bf16":
            fa_by_variant["mma_bf16"] == expected,
        "no other kernel launched": not any(
            n for k, n in launches.items() if k != "flash_attention_fwd"),
        "plain_calls == 0": not any(plain.values()),
        f"backward recomputes == {per_step * rank_steps}, all chunked":
            by_path == {"dense": 0, "chunked": per_step * rank_steps},
        "no straggler timeout": res["timeouts"] == 0,
    }
    del tr, res
    _free()
    log("train_8k " + json.dumps(row))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train_8k checks failed: {failed}")
    out[f"train_8k_{GEMMA}"] = row
    out.setdefault("main_path_launches", {})[LONG_TRAIN_PATH] = {
        "flash_attention_fwd": launches["flash_attention_fwd"]}
    out.setdefault("flash_main_path_by_variant", {})[
        LONG_TRAIN_PATH] = fa_by_variant

    # remat's effect on one step
    runs, tol = _remat_effect(cfg)
    _free()
    log("remat_8k " + json.dumps({"runs": runs, "grad_tol": tol}))
    out[f"remat_8k_{GEMMA}"] = runs
    checks = {f"{n} loss == none": runs[n]["loss"] == runs["none"]["loss"]
              for n in REMAT_RUNS[1:]}
    checks.update({f"{n} grads within the control": runs[n]["grads_ok"]
                   for n in ("dots", "full")})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"remat_8k checks failed: {failed}")

    # the chunked backward against the dense one
    rows = _chunked_vs_dense()
    _free()
    out["chunked_vs_dense"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"chunked backward disagrees: {bad}")

    # float32: the kernel path against the chunked plain path, a fault
    # planted in the plain path's chunked attention; cut in depth as phase
    # 19's parity (PARITY_CUTS, since PR 38: one unit, local and global)
    cut = PARITY_CUTS[GEMMA]
    cut_step = path_kernels(cfg.replace(**cut))["flash_attention_fwd"]
    fa_before = _fa_variants()
    runs = {}
    for name, impl, fault in (("kernel", "kernel", None),
                              ("plain", "ref", None),
                              (TRAIN_FAULTS["chunked"], "ref",
                               TRAIN_FAULTS["chunked"])):
        recomputed = dict(fa.backward_by_path)
        with _chunked_calls() as calls:
            tr, res = _train_run(GEMMA, "float32", impl, TRAIN_PARITY_OPT,
                                 LONG_TRAIN_STEPS, fault,
                                 data=LONG_TRAIN_DATA,
                                 ranks=LONG_TRAIN_RANKS, overrides=cut)
        del tr
        runs[name] = {"res": res, "wall_s": res["wall_s"],
                      "chunked_attention_calls": len(calls),
                      "flash_backward_by_path": {
                          p: fa.backward_by_path[p] - recomputed[p]
                          for p in fa.BACKWARD_PATHS}}
        if name == "kernel":
            continue
        runs[name]["gate"] = _parity(runs["kernel"]["res"], res)
        del res["final_params"]           # free the card for the next run
        _free()
    _check_float32_simt(_fa_variants_since(fa_before), "train_8k float32")
    report = {n: {k: v for k, v in r.items() if k != "res"}
              for n, r in runs.items()}
    report["kernel"]["losses"] = {f"{r}/{s}": v for (r, s), v in
                                  _losses(runs["kernel"]["res"]).items()}
    del runs
    _free()
    log("train_8k_parity " + json.dumps({
        "arch": GEMMA, "dtype": "float32", "optimizer": TRAIN_PARITY_OPT,
        "overrides": cut, "steps": LONG_TRAIN_STEPS, "loss_rtol": TRAIN_LOSS_RTOL,
        "param_rtol": TRAIN_PARAM_RTOL, "param_atol": TRAIN_PARAM_ATOL,
        **report}))
    layer_calls = 2 * cut_step * rank_steps   # forward + remat recompute
    checks = {
        "float32 kernel path == chunked plain path":
            not report["plain"]["gate"]["rejected"],
        "the chunked fault fails the gate":
            report[TRAIN_FAULTS["chunked"]]["gate"]["rejected"],
        "kernel run's backwards all chunked":
            report["kernel"]["flash_backward_by_path"]
            == {"dense": 0, "chunked": cut_step * rank_steps},
        f"plain run's chunked_attention calls == {layer_calls}":
            report["plain"]["chunked_attention_calls"] == layer_calls,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train_8k parity checks failed: {failed}")
    out[f"train_8k_parity_{GEMMA}"] = report


# ------------------------------------------- the encoder-decoder model
# phases 41 and 42: full-width, full-depth whisper-tiny (4 encoder and 4
# decoder layers, d 384, 6 heads of 64, vocab 51,865).  The serving engine
# serves decoder-only models alone (as the reference's), so whisper is
# served through make_prefill_step and make_serve_step, as the reference's
# dry-run cells drive it, and trained through make_train_step.  The stub
# frontend's frame embeddings are drawn by numpy from a seed: 1,500 frames
# (30 s of audio at Whisper's 50 frames a second)
WHISPER_FRAMES = 1500
WHISPER_PROMPTS = (100, 256, 384)
WHISPER_STEPS = 32                 # greedy decode steps a request
# decode-step logits against a teacher-forced decode: the reference's own
# limit (tests/test_arch_smoke.py), rtol = atol
DECODE_TOL = 2e-4
# phase 41's float32 weight sets: the port's init (the reference's rule:
# std 0.5 on every stacked leaf, a layers axis of 4) and "layer_fan_in";
# each gated at LOGIT_TOL unless the plain path's own float32 floor (its
# attention in float64) is above it at some length, and then reported
WHISPER_WEIGHTS = ("seeded", "layer_fan_in")
# phase 42: B=4 of 1,500 frames and 448 tokens (Whisper's text context,
# arXiv:2212.04356), AdamW, the config's remat "full"
WHISPER_TRAIN_DATA = dict(seq=448, global_batch=4, seed=7)
WHISPER_TRAIN_STEPS = 4


def _frames(B, seed, d, S=WHISPER_FRAMES):
    """Stub frame embeddings (B, S, d), float32 on the card, numpy-seeded."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (B, S, d), dtype=np.float32)).to("cuda")


def _whisper_prefill(model, tokens, frames):
    """One prefill through ``make_prefill_step`` into a cache of MAX_LEN:
    (last logits of row 0 in float32, the state (caches, cross_kv))."""
    import torch
    from repro_torch.train import make_prefill_step
    with torch.inference_mode():
        lg, state = make_prefill_step(model, max_len=MAX_LEN)(
            tokens, frame_embeds=frames)
    return lg[0, -1].float(), state


def _fa_masks():
    from repro_torch.kernels.flash_attention import ops as fa
    return dict(fa.launches_by_mask)


def _whisper_decode_parity(model, tokens, frames):
    """A prefill and WHISPER_STEPS greedy decode steps against one
    teacher-forced ``decode`` of the prompt and the tokens it chose, on
    the same encoder output: the largest distance over the step logits
    (the prefill's last included) and its ratio to DECODE_TOL's limit."""
    import torch
    from repro_torch.train import make_prefill_step
    S = tokens.shape[1]
    with torch.inference_mode():
        lg, state = make_prefill_step(model, max_len=MAX_LEN)(
            tokens, frame_embeds=frames)
        steps, toks = [lg[:, -1]], [tokens]
        for i in range(WHISPER_STEPS):
            nxt = steps[-1].argmax(-1)[:, None]
            toks.append(nxt)
            pos = torch.full((1, 1), S + i, dtype=torch.int32, device="cuda")
            lg, state = model.decode_step(state, nxt, pos)
            steps.append(lg[:, -1])
        seq = torch.cat(toks, dim=1)
        enc = model.encode(frames)
        pos = torch.arange(seq.shape[1], dtype=torch.int32,
                           device="cuda")[None]
        full, _, _ = model.decode(seq, enc, positions=pos)
    got = torch.stack(steps, dim=1).float()
    want = full[:, S - 1:].float()
    err = (got - want).abs()
    return {"steps": WHISPER_STEPS, "max_abs_diff": float(err.max()),
            "max_abs_logit": float(want.abs().max()),
            "ratio": float((err / (DECODE_TOL + DECODE_TOL
                                   * want.abs())).max())}


def _whisper_gate(weights, g):
    """Phase 41's float32 runs at one weight set: at each prompt length a
    prefill through the kernels against one through plain attention (the
    same parameter tree), the plain path's float64-attention floor, the
    ENCDEC_FAULTS planted in the plain path, each prefill's launches by
    mask, and the decode steps against a teacher-forced decode."""
    import torch
    kmodel = _full_model(WHISPER, "float32", "kernel")
    _weight_set(weights, kmodel)
    rmodel = _full_model(WHISPER, "float32", "ref",
                         params=kmodel.params.to_dict())
    n = kmodel.cfg.n_layers
    rows = []
    for i, S in enumerate(WHISPER_PROMPTS):
        toks = torch.randint(0, kmodel.cfg.vocab, (1, S), generator=g,
                             device="cuda")
        frames = _frames(1, 100 + i, kmodel.cfg.d_model)
        before, masks, variants = _counts(), _fa_masks(), _fa_variants()
        lk, _ = _whisper_prefill(kmodel, toks, frames)
        launched, plain = _since(before)
        by_mask = {m: c - masks[m] for m, c in _fa_masks().items()}
        by_variant = _fa_variants_since(variants)
        lr, _ = _whisper_prefill(rmodel, toks, frames)
        with _f64_attention():
            lf, _ = _whisper_prefill(rmodel, toks, frames)
        faults = {}
        for f in ENCDEC_FAULTS:
            with encdec_fault(f):
                lp, _ = _whisper_prefill(rmodel, toks, frames)
            d = float((lp - lr).abs().max())
            faults[f] = {"max_logit_diff": d,
                         "same_first_token": int(lp.argmax())
                         == int(lr.argmax()),
                         "gates": d / LOGIT_TOL}
            faults[f]["rejected"] = (d > LOGIT_TOL
                                     or not faults[f]["same_first_token"])
        row = {"arch": WHISPER, "dtype": "float32", "weights": weights,
               "S": S, "frames": WHISPER_FRAMES,
               "max_logit_diff": float((lk - lr).abs().max()),
               "same_first_token": int(lk.argmax()) == int(lr.argmax()),
               "max_abs_logit": float(lr.abs().max()),
               "plain_f64_floor": float((lf - lr).abs().max()),
               "gate": LOGIT_TOL, "planted_faults": faults,
               "kernel_launches": launched, "plain_calls": plain,
               "flash_launches_by_mask": by_mask,
               "flash_launches_by_variant": by_variant,
               "prefill_ms_kernel_path": _host_ms(
                   lambda: _whisper_prefill(kmodel, toks, frames)),
               "prefill_ms_plain_path": _host_ms(
                   lambda: _whisper_prefill(rmodel, toks, frames))}
        if not torch.isfinite(lk).all():
            raise AssertionError(f"non-finite logits: {row}")
        if (launched != {"flash_attention_fwd": 2 * n} or plain
                or by_mask != {"causal": n, "noncausal": n}
                or by_variant["simt"] != 2 * n):
            raise AssertionError(f"float32 prefill launched {launched} "
                                 f"({by_mask}, {by_variant}) and called "
                                 f"plain versions {plain}")
        rows.append(row)
    gated = all(r["plain_f64_floor"] <= LOGIT_TOL for r in rows)
    decode = _whisper_decode_parity(kmodel, toks, frames)
    decode["gated"] = gated
    for r in rows:
        r["gated"] = gated
        log("model " + json.dumps(r))
    log("model " + json.dumps({"arch": WHISPER, "weights": weights,
                               "decode_vs_teacher_forced": decode}))
    if gated:
        bad = [r["S"] for r in rows if r["max_logit_diff"] > LOGIT_TOL
               or not r["same_first_token"]]
        missed = [(r["S"], f) for r in rows
                  for f, v in r["planted_faults"].items()
                  if not v["rejected"]]
        if bad or missed or decode["ratio"] > 1:
            raise AssertionError(
                f"whisper float32 gate at {weights}: kernel path disagrees "
                f"at S {bad}, faults not rejected {missed}, decode "
                f"{decode}")
    del kmodel, rmodel
    _free()
    return {"prefill": rows, "decode_vs_teacher_forced": decode,
            "gated": gated}


def phase_whisper(out):
    """whisper-tiny's served path at full width and depth in bf16: for each
    of WHISPER_PROMPTS a prefill over 1,500 seeded frames through
    ``make_prefill_step`` into a cache of MAX_LEN, then WHISPER_STEPS
    greedy steps through ``make_serve_step``, every kernel's counts set to
    0 just before and read just after (4 non-causal and 4 causal
    tensor-core flash launches a prefill, none a decode step, no plain
    call); bf16 kernel path against plain path (reported); then the
    float32 gates (``_whisper_gate``) at each of WHISPER_WEIGHTS."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.train import make_serve_step
    kmodel = _full_model(WHISPER, "bfloat16", "kernel")
    rmodel = _full_model(WHISPER, "bfloat16", "ref",
                         params=kmodel.params.to_dict())
    cfg, n = kmodel.cfg, kmodel.cfg.n_layers
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab, (1, S), generator=g,
                             device="cuda") for S in WHISPER_PROMPTS]
    frames = [_frames(1, i, cfg.d_model) for i in range(len(prompts))]
    serve_step = make_serve_step(kmodel)
    for i in range(2):          # warm-up: the build and the first launches
        _whisper_prefill(kmodel, prompts[i][:, :16], frames[i])
    all_ops = _all_ops()
    torch.cuda.synchronize()
    for ops in all_ops.values():
        ops.reset_counts()                 # the main path's counts only
    requests, decode_launches = [], 0
    for toks, fr in zip(prompts, frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, state = _whisper_prefill(kmodel, toks, fr)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        nxt, out_toks = last.argmax()[None, None], []
        before = _counts()
        S = toks.shape[1]
        with torch.inference_mode():
            for i in range(WHISPER_STEPS):
                out_toks.append(nxt)
                pos = torch.full((1, 1), S + i, dtype=torch.int32,
                                 device="cuda")
                nxt, state = serve_step(state, nxt, pos)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launched, plain = _since(before)
        decode_launches += sum(launched.values()) + sum(plain.values())
        generated = torch.cat(out_toks, dim=1)[0].tolist()
        requests.append({"S": S, "prefill_ms": (t1 - t0) * 1e3,
                         "decode_ms_per_step": (t2 - t1) * 1e3
                         / WHISPER_STEPS,
                         "first_logits_finite":
                             bool(torch.isfinite(last).all()),
                         "tokens": generated})
    torch.cuda.synchronize()
    launches = {k: ops.kernel_launches for k, ops in all_ops.items()}
    plain = {k: ops.plain_calls for k, ops in all_ops.items()}
    by_variant = dict(fa.launches_by_variant)
    by_mask = dict(fa.launches_by_mask)
    k = len(prompts)
    checks = {
        f"flash_attention_fwd launches == {2 * n} x {k}":
            launches["flash_attention_fwd"] == 2 * n * k,
        f"non-causal launches == {n} x {k}": by_mask["noncausal"] == n * k,
        f"causal launches == {n} x {k}": by_mask["causal"] == n * k,
        "every flash_attention_fwd launch mma_bf16":
            by_variant["mma_bf16"] == launches["flash_attention_fwd"],
        "no launch or plain call in a decode step": decode_launches == 0,
        "no other kernel launched": not any(
            c for name, c in launches.items()
            if name != "flash_attention_fwd"),
        "plain_calls == 0": not any(plain.values()),
        "finite logits": all(r["first_logits_finite"] for r in requests),
        "tokens in vocab": all(0 <= t < cfg.vocab for r in requests
                               for t in r["tokens"]),
    }
    log("serve " + json.dumps({
        "arch": WHISPER, "card": out.get("card"), "dtype": cfg.dtype,
        "frames": WHISPER_FRAMES, "max_len": MAX_LEN,
        "requests": [{k2: v for k2, v in r.items() if k2 != "tokens"}
                     for r in requests],
        "kernel_launches": launches, "plain_calls": plain,
        "flash_launches_by_variant": by_variant,
        "flash_launches_by_mask": by_mask, "checks": checks}))
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"whisper serve checks failed: {failed}")
    out.setdefault("main_path_launches", {})[WHISPER] = {
        "flash_attention_fwd": launches["flash_attention_fwd"]}
    out.setdefault("flash_main_path_by_variant", {})[WHISPER] = by_variant
    res = {"serve": {"requests": requests, "kernel_launches": launches,
                     "flash_launches_by_mask": by_mask,
                     "flash_launches_by_variant": by_variant}}
    # bf16: kernel path against plain path, reported
    bf16 = []
    for toks, fr in zip(prompts, frames):
        lk, _ = _whisper_prefill(kmodel, toks, fr)
        lr, _ = _whisper_prefill(rmodel, toks, fr)
        bf16.append({"S": toks.shape[1],
                     "max_logit_diff": float((lk - lr).abs().max()),
                     "same_first_token": int(lk.argmax())
                     == int(lr.argmax()),
                     "max_abs_logit": float(lr.abs().max())})
    log("model " + json.dumps({"arch": WHISPER, "dtype": "bfloat16",
                               "weights": "seeded", "reported": bf16}))
    res["bfloat16_seeded"] = bf16
    del kmodel, rmodel, serve_step
    _free()
    for weights in WHISPER_WEIGHTS:
        res[f"float32_{weights}"] = _whisper_gate(weights, g)
    if not any(res[f"float32_{w}"]["gated"] for w in WHISPER_WEIGHTS):
        raise AssertionError("no float32 weight set of whisper-tiny was "
                             "gated, so no planted fault was checked")
    out[f"model_{WHISPER}"] = res


def _whisper_batches(cfg, steps):
    """The seeded training batches: SyntheticLM tokens and labels with
    1,500 stub frames a sequence, on the card."""
    import torch
    from repro_torch.data import DataCfg, SyntheticLM
    data = SyntheticLM(DataCfg(vocab=cfg.vocab, **WHISPER_TRAIN_DATA))
    d = cfg.d_model
    out = []
    for step in range(steps):
        b = data.frontend_batch(step, 0, 1, d, WHISPER_FRAMES,
                                "frame_embeds")
        out.append({"tokens": torch.from_numpy(b["tokens"]).to(
                        "cuda", torch.long),
                     "labels": torch.from_numpy(b["labels"]).to(
                        "cuda", torch.long),
                     "frame_embeds": torch.from_numpy(
                        b["frame_embeds"]).to("cuda")})
    return out


def _whisper_train(model, opt_cfg, batches, fault=None):
    """``make_train_step`` over ``batches`` from ``model``'s parameters:
    ``{"steps": each step's loss, host wall and kernel counts (set to 0
    before it), "history", "final_params"}``, the last two as
    ``_parity`` reads a trainer's result.  ``fault`` plants
    TRAIN_FAULTS["plain"] (``plain_scale_fault``) for this run."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.optim import OptCfg, make_optimizer
    from repro_torch.train import make_train_step
    from repro_torch.tree import tree_map
    opt = make_optimizer(OptCfg(**opt_cfg))
    step_fn = make_train_step(model, opt)
    params = tree_map(lambda p: p.detach(), model.params.to_dict())
    state = opt.init(params)
    steps = []
    all_ops = _all_ops()
    planted = (plain_scale_fault() if fault == TRAIN_FAULTS["plain"]
               else contextlib.nullcontext())
    with planted:
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            for ops in all_ops.values():
                ops.reset_counts()
            t0 = time.perf_counter()
            params, state, metrics = step_fn(params, state, batch, i)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            steps.append({
                "step": i, "loss": loss,
                "wall_ms": (time.perf_counter() - t0) * 1e3,
                "kernel_launches": {k: o.kernel_launches
                                    for k, o in all_ops.items()},
                "plain_calls": {k: o.plain_calls for k, o in all_ops.items()},
                "flash_launches_by_mask": dict(fa.launches_by_mask),
                "flash_launches_by_variant": dict(fa.launches_by_variant),
                "backward_by_path": dict(fa.backward_by_path)})
    return {"steps": steps, "final_params": [params],
            "history": [{"rank": 0, "step": st["step"], "loss": st["loss"]}
                        for st in steps]}


def phase_whisper_train(out):
    """whisper-tiny trained at full width and depth through
    ``make_train_step`` (bf16, AdamW, remat "full", WHISPER_TRAIN_STEPS
    steps of B=4 x 1,500 frames and 448 tokens): 16 flash launches a step
    (the 4 encoder and 4 decoder self-attention layers, forward and remat
    recompute; half of them not causal), all tensor-core, 8 dense
    backward recomputes, no plain call, finite losses near ln(vocab); the
    step's wall and the peak.  Then float32 sgdm runs of 3 steps, kernel
    path against plain path at phase 19's gate (weights at one layer's
    fan-in), which must reject the plain attention's scale moved by 1%."""
    import math
    import torch
    model = _full_model(WHISPER, "bfloat16", "kernel")
    batches = _whisper_batches(model.cfg, WHISPER_TRAIN_STEPS)
    n, vocab = model.cfg.n_layers, model.cfg.vocab
    torch.cuda.reset_peak_memory_stats()
    steps = _whisper_train(
        model, {"name": "adamw", "peak_lr": 3e-4, "warmup": 2,
                "total_steps": 100}, batches)["steps"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model
    _free()
    launches = sum(s["kernel_launches"]["flash_attention_fwd"]
                   for s in steps)
    out.setdefault("main_path_launches", {})[f"{WHISPER}-train"] = {
        "flash_attention_fwd": launches}
    out.setdefault("flash_main_path_by_variant", {})[f"{WHISPER}-train"] = {
        v: sum(s["flash_launches_by_variant"][v] for s in steps)
        for v in FA_ENTRY}
    row = {"arch": WHISPER, "card": out.get("card"), "dtype": "bfloat16",
           "remat": "full", "optimizer": "adamw", "data": WHISPER_TRAIN_DATA,
           "frames": WHISPER_FRAMES, "steps": steps,
           "max_memory_allocated_gib": peak,
           "ln_vocab": math.log(vocab)}
    log("train " + json.dumps(row))
    checks = {
        f"{4 * n} flash launches a step": all(
            s["kernel_launches"]["flash_attention_fwd"] == 4 * n
            for s in steps),
        f"{2 * n} non-causal and {2 * n} causal a step": all(
            s["flash_launches_by_mask"] == {"causal": 2 * n,
                                            "noncausal": 2 * n}
            for s in steps),
        "every launch mma_bf16": all(
            s["flash_launches_by_variant"]["mma_bf16"] == 4 * n
            for s in steps),
        f"{2 * n} dense backward recomputes a step": all(
            s["backward_by_path"] == {"dense": 2 * n, "chunked": 0}
            for s in steps),
        "no other kernel launched": all(
            not any(c for k, c in s["kernel_launches"].items()
                    if k != "flash_attention_fwd") for s in steps),
        "plain_calls == 0": all(not any(s["plain_calls"].values())
                                for s in steps),
        "losses finite and within 2 of ln(vocab)": all(
            math.isfinite(s["loss"])
            and abs(s["loss"] - math.log(vocab)) < 2 for s in steps),
    }
    # float32 parity: kernel path against plain path, then the fault
    kmodel = _full_model(WHISPER, "float32", "kernel")
    _weight_set("layer_fan_in", kmodel)
    tree = kmodel.params.to_dict()
    batches = batches[:PARITY_STEPS]
    runs = {"kernel": _whisper_train(kmodel, TRAIN_PARITY_OPT, batches)}
    rmodel = _full_model(WHISPER, "float32", "ref", params=tree)
    runs["plain"] = _whisper_train(rmodel, TRAIN_PARITY_OPT, batches)
    fault = TRAIN_FAULTS["plain"]
    runs[fault] = _whisper_train(rmodel, TRAIN_PARITY_OPT, batches,
                                 fault=fault)
    kernel = runs.pop("kernel")
    report = {name: {"losses": [s["loss"] for s in r["steps"]],
                     "gate": _parity(kernel, r)}
              for name, r in runs.items()}
    report["kernel"] = {"losses": [s["loss"] for s in kernel["steps"]],
                        "flash_launches_by_variant": [
                            s["flash_launches_by_variant"]
                            for s in kernel["steps"]]}
    log("train_parity " + json.dumps({
        "arch": WHISPER, "dtype": "float32", "weights": "layer_fan_in",
        "optimizer": TRAIN_PARITY_OPT, "steps": PARITY_STEPS, **report}))
    checks.update({
        "float32 kernel path == plain path":
            not report["plain"]["gate"]["rejected"],
        "the plain fault fails the gate": report[fault]["gate"]["rejected"],
        "float32 launches all simt": all(
            v["mma_bf16"] == 0
            for v in report["kernel"]["flash_launches_by_variant"]),
    })
    del kmodel, rmodel, runs, kernel, tree
    _free()
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"whisper train checks failed: {failed}")
    out[f"train_{WHISPER}"] = {"bf16": row, "parity": report}


# ------------------------------------------------ training the SSD family
# phase 43: full-size mamba2-370m trained by EventDrivenTrainer.run,
# in-proc, 2 ranks on the one card, each rank 2 sequences of 4,096 tokens
# a step (the reference's train_4k, 32 chunks of 128): the SSD kernel in
# every forward and again in every remat recompute, the plain scan
# recomputed in every backward (the reference's custom_vjp)
SSD_TRAIN_DATA = dict(vocab=50280, seq=4096, global_batch=4, seed=7)
SSD_TRAIN_STEPS = 4
# its float32 parity (at PARITY_CUTS' depth): the kernel path (every SSD
# launch SIMT) against the plain path at phase 19's gate, 4 chunks a
# sequence, from Mamba-2's init of a_log and dt_bias (at the reference's
# init the state barely crosses a chunk, so no gate would see the term
# between chunks).  First the plain path's own floor, its float32 run held
# to its float64 run by the same gate: if that is above the gate, the next
# weight set is tried instead.  Mamba-2's init alone is left out: its floor
# was above the gate at 48, 12 and 6 layers (375x, 13x, 4.2x), so the
# sets start with stacked leaves at one layer's fan-in.
# Planted: the term between chunks dropped in the plain scan must fail the
# gate, each rank applying its own grads the replica gate; the
# chunk-by-chunk control must pass both
SSD_PARITY_DATA = dict(SSD_TRAIN_DATA, seq=512)
SSD_PARITY_WEIGHTS = (("layer_fan_in", "mamba2_init"),)
SSD_TRAIN_FAULT = "no_inter_chunk"


def phase_train_ssd(out):
    """mamba2-370m trained by the event-driven trainer at full size and
    4,096 tokens a sequence (the SSD family's training main path), then
    the float32 parity of its kernel path against its plain path, with
    planted faults and the plain path's float64 floor."""
    import math
    import resource
    import torch
    from repro_torch.kernels.ssd import ops as ssd
    cfg = _cfg(MAMBA)
    rank_steps = TRAIN_RANKS * SSD_TRAIN_STEPS
    # each rank-step runs every SSD layer's backward once, and its forward
    # once more under remat (the config's "full"): the recompute
    recomputes_want = path_kernels(cfg)["ssd_fwd"] * rank_steps
    expected = recomputes_want * (1 if cfg.remat == "none" else 2)
    all_ops = _all_ops()
    torch.cuda.synchronize()
    for ops in all_ops.values():
        ops.reset_counts()                 # the main path's counts only
    tr, res = _train_run(MAMBA, "bfloat16", "kernel", {"name": "adamw"},
                         SSD_TRAIN_STEPS, data=SSD_TRAIN_DATA)
    launches = {k: ops.kernel_launches for k, ops in all_ops.items()}
    plain = {k: ops.plain_calls for k, ops in all_ops.items()}
    by_variant = dict(ssd.launches_by_variant)
    recomputes = ssd.backward_recomputes
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = _losses(res)
    ln_vocab = math.log(cfg.vocab)
    row = {"arch": MAMBA, "card": out.get("card"), "dtype": cfg.dtype,
           "remat": cfg.remat, "ranks": TRAIN_RANKS,
           "steps": SSD_TRAIN_STEPS, "optimizer": "adamw",
           "data": SSD_TRAIN_DATA, "wall_s": res["wall_s"],
           "metric_arrivals_s": res["metric_arrivals_s"],
           "losses": {f"{r}/{s}": v for (r, s), v in losses.items()},
           "ln_vocab": ln_vocab,
           "kernel_launches": launches, "plain_calls": plain,
           "ssd_launches_by_variant": by_variant,
           "ssd_backward_recomputes": recomputes,
           "timeouts": res["timeouts"],
           "max_memory_allocated_gib": peak_gib}
    checks = {
        f"{len(losses)} losses == ranks x steps": len(losses) == rank_steps,
        "losses finite and within 2 of ln(vocab)": all(
            math.isfinite(v) and abs(v - ln_vocab) < 2
            for v in losses.values()),
        "replicas equal": _replicas_equal(res),
        f"ssd_fwd launches == {expected}": launches["ssd_fwd"] == expected,
        "every ssd_fwd launch mma_bf16": by_variant["mma_bf16"] == expected,
        "no other kernel launched": not any(
            n for k, n in launches.items() if k != "ssd_fwd"),
        "plain_calls == 0": not any(plain.values()),
        f"ssd backward recomputes == {recomputes_want}":
            recomputes == recomputes_want,
        "no straggler timeout": res["timeouts"] == 0,
    }
    del res
    _free()
    row["step_split"] = _step_split(tr, SSD_TRAIN_STEPS)
    del tr
    _free()
    row["peak_rss_gib"] = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                           / 2 ** 20)
    log("train " + json.dumps(row))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train checks failed: {failed}")
    out[f"train_{MAMBA}"] = row
    out.setdefault("main_path_launches", {})[SSD_TRAIN_PATH] = {
        "ssd_fwd": launches["ssd_fwd"]}
    out.setdefault("ssd_main_path_by_variant", {})[
        SSD_TRAIN_PATH] = by_variant

    # float32: the plain path's float64 floor at each weight set in turn,
    # until one is under the gate; there the kernel path against the
    # plain path, planted faults
    cut = PARITY_CUTS[MAMBA]
    floors = {}
    for weights in SSD_PARITY_WEIGHTS:
        params = _train_params(MAMBA, weights, cut["n_layers"])
        floor = _parity_floor(MAMBA, SSD_PARITY_DATA, params)
        floors["+".join(weights)] = floor
        log("train_parity_floor " + json.dumps({
            "arch": MAMBA, "weights": weights, **cut,
            "data": SSD_PARITY_DATA, "floor": floor}))
        if not floor["rejected"]:
            break
        del params
        _free()
    else:
        out[f"train_parity_{MAMBA}"] = {"floors": floors}
        raise AssertionError("train parity: the plain path's float64 floor "
                             "is above the gate at every weight set")
    # the kernel run and the own-grads run: a forward and a remat
    # recompute a layer, a rank-step
    want_simt = 2 * (2 * path_kernels(cfg.replace(**cut))["ssd_fwd"]
                     * TRAIN_RANKS * PARITY_STEPS)
    before = dict(ssd.launches_by_variant)
    report = _parity_runs(MAMBA, (
        ("plain", "ref", None),
        (SSD_CONTROL, "ref", SSD_CONTROL),
        (SSD_TRAIN_FAULT, "ref", SSD_TRAIN_FAULT),
        (TRAIN_FAULTS["replicas"], "kernel", TRAIN_FAULTS["replicas"])),
        data=SSD_PARITY_DATA, params=params)
    del params
    report["ssd_launches_by_variant"] = {
        v: ssd.launches_by_variant[v] - before[v] for v in before}
    report.update(weights=weights, floors=floors)
    log("train_parity " + json.dumps({
        "arch": MAMBA, "dtype": "float32", **cut, "data": SSD_PARITY_DATA,
        "optimizer": TRAIN_PARITY_OPT, "steps": PARITY_STEPS,
        "loss_rtol": TRAIN_LOSS_RTOL, "param_rtol": TRAIN_PARAM_RTOL,
        "param_atol": TRAIN_PARAM_ATOL, **report}))
    out[f"train_parity_{MAMBA}"] = report
    checks = {
        "float32 kernel path == plain path":
            not report["plain"]["gate"]["rejected"],
        "the chunkwise control passes the gate":
            not report[SSD_CONTROL]["gate"]["rejected"],
        f"{SSD_TRAIN_FAULT} fails the gate":
            report[SSD_TRAIN_FAULT]["gate"]["rejected"],
        "kernel run replicas equal": report["kernel"]["replicas_equal"],
        "plain run replicas equal": report["plain"]["replicas_equal"],
        "the own-grads fault fails the replica gate":
            not report[TRAIN_FAULTS["replicas"]]["replicas_equal"],
        f"{want_simt} float32 SSD launches, all simt":
            report["ssd_launches_by_variant"] == {"mma_bf16": 0,
                                                  "simt": want_simt},
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train parity checks failed: {failed}")


# ----------------------------------------------------- MONC in-situ analytics
# phase 44: the paper's per-item stream (INSITU["paper"] of the port's
# configs/edat_paper.py: 1,024 items of 4,096 float64 values a producer),
# 2 fields, 1:1 computational to analytics ranks; the paper's 1,024-16,384
# analytics cores cut to the counts of the "big" preset that fit one host;
# n = 8 (27.9 s of a run) left out to make room for phase 45
INSITU_N = (1, 2, 4)
INSITU_FIELDS = 2
INSITU_WORKERS = 4
# |port - host| <= RTOL x sum|x| for sums, RTOL x sum x^2 for sums of
# squares (float64 sums in another order differ by rounding); min and max
# bit-equal
INSITU_RTOL = 1e-12
INSITU_FAULTS = ("partial_dropped", "last_value_dropped")
INSITU_PROFILE_ITEMS = 64


def _host_partials(x):
    """The reference's per-item arithmetic on rows of ``x`` (numpy)."""
    import numpy as np
    return np.stack([x.sum(-1), (x * x).sum(-1), x.min(-1), x.max(-1)], -1)


def insitu_host_totals(cfg, bespoke=False):
    """Every producer's item partials, recomputed on the host with numpy
    from the producers' seeds (the EDAT program's producer ranks n..2n-1
    seed ``default_rng(rank)``, the bespoke baseline's ``rank + 1000``),
    with sum |x| of each item.  Returns ``{name: (partials, abs_sums)}``,
    arrays of (analytics rank, item, ...), for the control and each
    planted fault: ``partial_dropped`` leaves the last analytics rank's
    partial out of the first (field, timestep)'s total,
    ``last_value_dropped`` drops the last value of the first producer's
    first item."""
    import numpy as np
    n = cfg.n_analytics
    seeds = [r + 1000 if bespoke else n + r for r in range(n)]
    parts, absx = [], []
    for seed in seeds:
        x = np.random.default_rng(seed).standard_normal(
            (cfg.items_per_producer, cfg.field_elems))
        parts.append(_host_partials(x))
        absx.append(np.abs(x).sum(-1))
        if seed == seeds[0]:
            short = x[0, :-1]
    parts, absx = np.stack(parts), np.stack(absx)
    dropped, dropped_abs = parts.copy(), absx.copy()
    dropped[-1, 0], dropped_abs[-1, 0] = 0.0, 0.0
    cut, cut_abs = parts.copy(), absx.copy()
    cut[0, 0], cut_abs[0, 0] = _host_partials(short), np.abs(short).sum()
    return {"control": (parts, absx),
            "partial_dropped": (dropped, dropped_abs),
            "last_value_dropped": (cut, cut_abs)}


def insitu_gate(got, want, any_order=False, rtol=INSITU_RTOL):
    """The port's totals (a list of four-value arrays, no key) against the
    host's ``(partials, abs_sums)`` folded over ranks in rank order, as
    multisets: both sorted by the sum term, then compared one to one.
    ``ok`` holds when the counts are equal, every sum is within ``rtol``
    x sum|x|, every sum of squares within ``rtol`` x sum x^2, and every
    min and max term is bit-equal to the ranks' min (max) summed in rank
    order, or, with ``any_order`` (the bespoke baseline sums the ranks'
    partials in their order of arrival, and three or more float terms
    round by their order), within ``rtol`` x the sum of the ranks' |min|
    (|max|).  The ratios are the largest |port - host| over its limit."""
    import numpy as np
    parts, absx = want
    totals, a, q = parts.sum(0), absx.sum(0), parts[..., 1].sum(0)
    if len(got) != len(totals):
        return {"ok": False, "results": len(got), "expected": len(totals)}
    g = np.array(sorted(got, key=lambda t: t[0]))
    order = np.argsort(totals[:, 0], kind="stable")
    w, a, q = totals[order], a[order], q[order]
    m = np.abs(parts[..., 2:]).sum(0)[order]
    with np.errstate(divide="ignore", invalid="ignore"):
        sum_ratio = float(np.nanmax(np.abs(g[:, 0] - w[:, 0]) / (rtol * a)))
        sq_ratio = float(np.nanmax(np.abs(g[:, 1] - w[:, 1]) / (rtol * q)))
        mm_ratio = float(np.nanmax(np.abs(g[:, 2:] - w[:, 2:]) / (rtol * m)))
    bits = bool((g[:, 2:] == w[:, 2:]).all())
    minmax = mm_ratio <= 1 if any_order else bits
    return {"ok": sum_ratio <= 1 and sq_ratio <= 1 and minmax,
            "results": len(got), "sum_ratio": sum_ratio,
            "sumsq_ratio": sq_ratio, "minmax_ratio": mm_ratio,
            "minmax_bit_equal": bits}


def _monotonic_stamp(ctx, events):
    """A task's host clock, for ``Session.call`` (the run's start on rank
    0's process; ``time.monotonic`` is one clock across processes)."""
    return time.monotonic()


def _insitu_cfg(n, items=None):
    from repro_torch.analytics import InsituCfg
    from repro_torch.configs.edat_paper import INSITU
    paper = INSITU["paper"]
    return InsituCfg(n_analytics=n,
                     items_per_producer=items or paper.items_per_producer,
                     field_elems=paper.field_elems, n_fields=INSITU_FIELDS)


def _insitu_socket():
    """One socket session of the EDAT program (n_analytics 2, 4 ranks on
    2 spawned processes, each item's arithmetic on the card in the
    analytics ranks' process): its wall split, wire counters and result
    count.  The children's summary must show every ``_analyse`` call on
    cuda and totals that pass the host gate (which rejects both planted
    faults), and the parent's own ``_analyse`` count must not move."""
    import dataclasses
    from repro_torch import edat
    from repro_torch.analytics import insitu, insitu_program
    from repro_torch.insights import analyze
    cfg = _insitu_cfg(2)
    parent0 = dict(insitu.calls_by_device)
    t0 = time.monotonic()
    with edat.Session(2 * cfg.n_analytics, transport="socket", procs=2,
                      timeout=300, workers_per_rank=INSITU_WORKERS) as s:
        stamp = s.call(0, _monotonic_stamp)
        s.run(edat.deferred(insitu_program, dataclasses.asdict(cfg),
                            INSITU_WORKERS, "cuda"))
        summary, stats = s.gather(), s.stats
        started = stamp.result(timeout=60)
    session_s = time.monotonic() - t0
    wire = stats.get("transport", {})
    run_s = float(stats["run_seconds"])
    raw = cfg.n_analytics * cfg.items_per_producer
    gates = {k: insitu_gate(summary["totals"], want)
             for k, want in insitu_host_totals(cfg).items()}
    res = {"n_analytics": cfg.n_analytics, "ranks": 2 * cfg.n_analytics,
           "procs": 2, "results": summary["results"],
           "mean_latency_s": summary["mean_latency_s"],
           "bandwidth_items_s": raw / run_s, "session_s": session_s,
           "spawn_build_s": started - t0, "run_seconds": run_s,
           "rest_s": session_s - (started - t0) - run_s,
           "wire": {k: wire.get(k) for k in (
               "wire_events_sent", "writes", "wire_bytes",
               "loopback_events", "dropped")},
           "calls_by_device": summary["calls_by_device"], "gates": gates,
           "insights": [str(f) for f in analyze(stats)]}
    checks = {
        f"results == {cfg.items_per_producer}":
            summary["results"] == cfg.items_per_producer,
        "events crossed the wire": (wire.get("wire_events_sent") or 0) > 0,
        f"the children's calls_by_device == cuda: {raw}":
            summary["calls_by_device"] == {"cuda": raw},
        "the control passes the totals gate": gates["control"]["ok"],
        **{f"{f} fails the totals gate": not gates[f]["ok"]
           for f in INSITU_FAULTS},
        "the parent's calls_by_device unmoved":
            dict(insitu.calls_by_device) == parent0,
    }
    return res, checks


def _insitu_profile():
    """One window of INSITU_PROFILE_ITEMS items on one analytics rank:
    the device time of the arithmetic an item (kernels, and the copies in
    and out) under ``torch.profiler`` against the host wall an item of
    the same run unprofiled, and the host time of one item's arithmetic
    called alone in a loop (one thread, no runtime around it).  The
    profiler keeps only some of the workers' device events, so each
    event name's time an item is its mean over the events kept times its
    launches an item (every item launches the same sequence, so that
    count is the kept count over the items, rounded)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analytics import EdatAnalytics, insitu
    cfg = _insitu_cfg(1, INSITU_PROFILE_ITEMS)
    items = cfg.items_per_producer
    EdatAnalytics(cfg, INSITU_WORKERS, device="cuda").run()  # warm
    wall = EdatAnalytics(cfg, INSITU_WORKERS, device="cuda").run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        EdatAnalytics(cfg, INSITU_WORKERS, device="cuda").run()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += (e.time_range.end - e.time_range.start) / 1e3
            acc[1] += 1
    # kind: [ms an item, launches an item, events kept]
    kinds = {"kernel": [0.0, 0, 0], "copy": [0.0, 0, 0]}
    for name, (ms, kept) in by_name.items():
        per_item = round(kept / items)
        acc = kinds["copy" if "memcpy" in name.lower() else "kernel"]
        acc[0] += ms / kept * per_item
        acc[1] += per_item
        acc[2] += kept
    fields = np.random.default_rng(cfg.n_analytics).standard_normal(
        (items, cfg.field_elems))
    dev = torch.device("cuda")
    insitu._partial(fields[0], dev)
    t0 = time.monotonic()
    for x in fields:
        insitu._partial(x, dev)
    alone_ms = (time.monotonic() - t0) * 1e3 / items
    wall_ms = wall["seconds"] * 1e3 / items
    kern, copy = kinds["kernel"], kinds["copy"]
    device_ms = kern[0] + copy[0]
    return {"items": items, "kernel_ms_per_item": kern[0],
            "kernels_per_item": kern[1], "copy_ms_per_item": copy[0],
            "copies_per_item": copy[1],
            "events_kept_share": (kern[2] + copy[2])
            / max(items * (kern[1] + copy[1]), 1),
            "device_ms_per_item": device_ms,
            "host_wall_ms_per_item": wall_ms,
            "device_busy_share": device_ms / wall_ms,
            "arithmetic_alone_host_ms_per_item": alone_ms,
            "events_kept_by_name": sorted(
                [v[1], k[:80]] for k, v in by_name.items()),
            "top_device_ms_count": _kernel_time(prof)[2]}


def phase_insitu(out):
    """The paper's MONC in-situ analytics (§VI) at its per-item sizes: for
    each n_analytics of INSITU_N, the EDAT program and then the bespoke
    baseline in-proc (2n ranks as threads), every item's arithmetic on the
    card; the result count, the ``_analyse`` calls by device, and the
    totals against the host's numpy recompute (which must reject two
    planted faults beside its control); then one socket session and one
    profiled window."""
    from repro_torch.analytics import BespokeAnalytics, EdatAnalytics, insitu
    from repro_torch.insights import analyze
    runs, failed = [], []
    for n in INSITU_N:
        cfg = _insitu_cfg(n)
        for name, cls in (("edat", EdatAnalytics),
                          ("bespoke", BespokeAnalytics)):
            prog = cls(cfg, INSITU_WORKERS, device="cuda")
            insitu.reset_counts()
            res = prog.run()
            calls = dict(insitu.calls_by_device)
            got = [total for total, _ in prog.results]
            gates = {k: insitu_gate(got, want, any_order=name == "bespoke")
                     for k, want in
                     insitu_host_totals(cfg, name == "bespoke").items()}
            row = {"program": name, "n_analytics": n, "ranks": 2 * n,
                   **res, "calls_by_device": calls, "gates": gates}
            if name == "edat":
                row["insights"] = [str(f) for f in analyze(prog.stats)]
            log(f"insitu_run {json.dumps(row)}")
            runs.append(row)
            checks = {
                f"results == {cfg.items_per_producer}":
                    res["results"] == cfg.items_per_producer,
                f"calls_by_device == cuda: {n * cfg.items_per_producer}":
                    calls == {"cuda": n * cfg.items_per_producer},
                "the control passes the totals gate":
                    gates["control"]["ok"],
                **{f"{f} fails the totals gate": not gates[f]["ok"]
                   for f in INSITU_FAULTS}}
            if name == "edat":
                checks[f"summary calls_by_device == cuda: "
                       f"{n * cfg.items_per_producer}"] = (
                    prog.summary["calls_by_device"]
                    == {"cuda": n * cfg.items_per_producer})
            failed += [f"{name} n={n}: {k}" for k, ok in checks.items()
                       if not ok]
    socket_run, checks = _insitu_socket()
    failed += [f"socket: {k}" for k, ok in checks.items() if not ok]
    prof = _insitu_profile()
    line = {"card": out.get("card"), "items_per_producer":
            _insitu_cfg(1).items_per_producer,
            "field_elems": _insitu_cfg(1).field_elems,
            "n_fields": INSITU_FIELDS, "workers_per_rank": INSITU_WORKERS,
            "rtol": INSITU_RTOL,
            "runs": [{k: r[k] for k in (
                "program", "n_analytics", "seconds", "bandwidth_items_s",
                "mean_latency_s", "results", "calls_by_device")}
                | {"insights": r.get("insights"),
                   "control": r["gates"]["control"]} for r in runs],
            "socket": socket_run, "profile": prof}
    log(f"insitu {json.dumps(line)}")
    out["insitu"] = dict(line, runs=runs)
    if failed:
        raise AssertionError(f"insitu checks failed: {failed}")


# ---------------------------------------------------- Graph500 BFS (paper §V)
# phase 45: BFS["paper"] of configs/edat_paper.py (scale 29, edgefactor 16,
# 384-30,720 cores) cut to the largest graph one card builds whole (scale
# 25: 2^25 vertices, 2^29 generated edges, ~1e9 CSR neighbours) and to the
# "big" preset's rank counts that fit one process as threads
GRAPH_SOURCE = "src/repro_torch/csrc/kronecker_gen.cu"
GRAPH_REPLACES = ("src/repro/graph/kronecker.py:28 (no TPU kernel: the "
                  "reference's numpy draws on the host)")
GRAPH_SCALE = 25
GRAPH_EDGEFACTOR = 16
GRAPH_SEED = 20
GRAPH_RANKS = (1, 2, 4, 8)
GRAPH_KERNEL_SCALE = 18      # kernel against plain over the whole array
GRAPH_SAMPLES = 1000         # sampled edges checked at GRAPH_SCALE
GRAPH_PARITY_SCALE = 20      # card against CPU; the socket session's size
GRAPH_PARITY_RANKS = 4
GRAPH_SOCKET_PROCS = 2
GRAPH_TIME_ITERS = 5
# at each rank count BSP, then EDAT, whose walls give the TEPS compared;
# before them, at the first rank count only, one EDAT run whose wall
# includes pinning the host blocks the level batches come back through
# (the BFS's host pool keeps them for every later run, whatever its rank
# count), and whose parents must equal the later run's
GRAPH_COLD_RUN = "edat_cold"
GRAPH_RUN_ORDER = ("bsp", "edat")
GRAPH_DEVICE = "cuda"        # tests/test_torch_graph.py sets "cpu"
BFS_FAULTS = ("non_neighbour_parent", "parent_dropped")
# the SMs issue at most 4 warp instructions a clock (one a scheduler)
INSTRUCTIONS_PER_SM_CLOCK = 4 * 32


def bfs_parent_faults(parent, root, deg):
    """``{fault: a copy of parent with it planted}`` for phase 45's gate:
    ``non_neighbour_parent`` re-parents the first reached non-root vertex
    to the first vertex of degree 0 (a neighbour of none);
    ``parent_dropped`` unsets the parent of the first reached vertex whose
    parent is not the root, so that vertex's child is left without a
    level."""
    import numpy as np
    parent = np.asarray(parent)
    idx = np.arange(len(parent))
    v = int(np.flatnonzero((parent >= 0) & (idx != root))[0])
    a = parent.copy()
    a[v] = int(np.flatnonzero(np.asarray(deg) == 0)[0])
    w = int(np.flatnonzero((parent >= 0) & (parent != root)
                           & (idx != root))[0])
    b = parent.copy()
    b[parent[w]] = -1
    return {"non_neighbour_parent": a, "parent_dropped": b}


def bfs_cpu_faults(parent, root, edges):
    """The CPU tests' planted faults (host numpy, small graphs):
    ``root_not_own_parent``, ``parent_edge_missing`` (the first reached
    non-root vertex re-parented to a reached vertex it has no edge with)
    and ``unreachable_cycle`` (the two ends of a non-loop edge, both
    reached and neither the root, made each other's parent)."""
    import numpy as np
    parent = np.asarray(parent)
    pairs = {(int(s), int(d)) for s, d in np.asarray(edges).T if s != d}
    adj = pairs | {(d, s) for s, d in pairs}
    reached = [int(x) for x in np.flatnonzero(parent >= 0) if x != root]
    v = reached[0]
    root_fault = parent.copy()
    root_fault[root] = v
    missing = parent.copy()
    missing[v] = next(u for u in reached if u != v and (v, u) not in adj)
    a, b = next((s, d) for s, d in sorted(pairs)
                if root not in (s, d) and parent[s] >= 0 and parent[d] >= 0)
    cycle = parent.copy()
    cycle[a], cycle[b] = b, a
    return {"root_not_own_parent": root_fault,
            "parent_edge_missing": missing, "unreachable_cycle": cycle}


def _empty_host_cache():
    """Hand the pinned host blocks that PyTorch's caching host allocator
    keeps back to the system (the BFS's host pool takes its blocks from
    it)."""
    import torch
    fn = (getattr(getattr(torch, "accelerator", None), "empty_host_cache",
                  None) or getattr(torch._C, "_host_emptyCache", None))
    if fn is None:
        raise RuntimeError("this torch has no way to empty its host cache")
    fn()


def _rss_gib():
    """This process's resident memory now (VmRSS), GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2 ** 20
    return None


def _sampled_draws_check(raw, seed, scale, m, picks, advance=0):
    """Bit pairs of the sampled edges ``picks`` of ``raw`` (the kernel's
    (2, m) output) against numpy's own draws at their indices, reached
    through ``bit_generator.advance`` from ``default_rng(seed)`` (moved
    ``advance`` draws on first, for the planted fault's run).  Returns
    (bit pairs checked, bit pairs that differ, the largest |kernel -
    numpy| of a sampled edge's src or dst)."""
    import numpy as np
    from repro_torch.kernels.kronecker import ref as kref
    from repro_torch.graph.kronecker import thresholds
    ab, c_norm, a_norm = thresholds()
    got = raw[:, picks].cpu().numpy()
    rng = np.random.default_rng(seed)
    st0 = rng.bit_generator.state
    bad = err = 0
    for j, e in enumerate(int(x) for x in picks):
        src = dst = 0
        for bit in range(scale):
            want = []
            for half in (0, 1):
                rng.bit_generator.state = st0
                rng.bit_generator.advance(
                    advance + kref.draw_index(bit, half, e, m))
                want.append(rng.random())
            ii = want[0] > ab
            jj = want[1] > (c_norm if ii else a_norm)
            bad += (((got[0, j] >> bit) & 1) != ii) + (
                ((got[1, j] >> bit) & 1) != jj)
            src |= int(ii) << bit
            dst |= int(jj) << bit
        err = max(err, abs(int(got[0, j]) - src), abs(int(got[1, j]) - dst))
    return len(picks) * scale, int(bad), err


def _sass_loop(lib_path, entry):
    """Instructions of the innermost nested loop of ``entry`` in the
    library's SASS (``cuobjdump -sass``): the ranges [target, backward
    branch] that sit inside another such range, the smallest of them (in
    the Kronecker kernel, the loop over bits inside the loop over edges).
    None when the toolkit's cuobjdump is missing or nothing parses."""
    import re
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True,
                          timeout=120).stdout
    body = None
    for chunk in text.split("Function : ")[1:]:
        if entry in chunk.splitlines()[0]:
            body = chunk
    if body is None:
        return None
    labels, insts, pending = {}, [], []
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insts.append((addr, m.group(2)))
    loops = []
    for addr, text_ in insts:
        # a branch names its target as a label or as an address
        m = re.search(r"\bBRA\b\s+`?\(?(\.L_x_\d+|0x[0-9a-f]+)", text_)
        if not m:
            continue
        target = (labels.get(m.group(1)) if m.group(1).startswith(".L")
                  else int(m.group(1), 16))
        if target is not None and target < addr:
            loops.append((target, addr))
    nested = [(a, b) for a, b in loops
              if any(a2 <= a and b <= b2 and (a2, b2) != (a, b)
                     for a2, b2 in loops)]
    if not nested:
        return None
    a, b = min(nested, key=lambda r: r[1] - r[0])
    return {"instructions": sum(1 for x, _ in insts if a <= x <= b),
            "loops": len(loops), "nested_loops": len(nested)}


def graph_kernel_bound(scale, m, per_iteration, sms, clock_hz):
    """Least time of one generator call over m edges: its output (src and
    dst, 16 bytes an edge) over the memory rate, against the instructions
    of its draws (``per_iteration`` SASS instructions a bit, DRAWS_PER_BIT
    draws) issued at 4 warp instructions a clock an SM."""
    nbytes = 16 * m
    instr = per_iteration * scale * m
    rate = sms * INSTRUCTIONS_PER_SM_CLOCK * clock_hz
    t_bytes, t_ops = nbytes / PEAK_BYTES, instr / rate
    return {"bytes": nbytes, "instructions": instr,
            "issue_rate_per_s": rate,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _max_sm_clock_hz():
    """The card's maximum SM clock from nvidia-smi, else the H100 SXM's
    1,980 MHz boost."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(smi.stdout.split()[0]) * 1e6
    except (IndexError, ValueError):
        return 1.98e9


def _graph_launch(scale, advance=0):
    """One generator launch on GRAPH_DEVICE at ``scale``: seed GRAPH_SEED,
    moved ``advance`` draws on first."""
    import numpy as np
    import torch
    from repro_torch.graph.kronecker import thresholds
    from repro_torch.kernels.kronecker import ops as kops
    rng = np.random.default_rng(GRAPH_SEED)
    rng.bit_generator.advance(advance)
    return kops.kronecker_gen(rng, scale, (1 << scale) * GRAPH_EDGEFACTOR,
                              *thresholds(), torch.device(GRAPH_DEVICE))


def _graph_kernel_device_ms(scale, event_ms):
    """The generator kernel's profiler device ms at ``scale`` and where
    it was read: in this process, or, where the profiler keeps no launch
    of it here in 3 windows, in a fresh process (``_graph_fresh_device_ms``).
    In a fresh process the profiler kept every window of the kernel at
    scales 18-25 in every mode tried; in two runs of every phase and one
    of phases 43 and 45 it kept no device event at all at GRAPH_SCALE
    here, both with the host traced and without.  Raises where neither
    keeps one."""
    import torch
    try:
        return kernel_device_ms(lambda: _graph_launch(scale),
                                "kronecker_gen", event_ms,
                                iters=GRAPH_TIME_ITERS, warmup=1, lead=2,
                                tries=3)[0], "this process"
    except AssertionError as exc:
        free, total = torch.cuda.mem_get_info()
        log(f"graph_kernel: {exc} (device memory free {free / 2 ** 30:.2f} "
            f"of {total / 2 ** 30:.2f} GiB); profiling in a fresh process")
    return _graph_fresh_device_ms(scale, event_ms), "a fresh process"


def _graph_fresh_device_ms(scale, event_ms):
    """``_graph_profile_child`` run in a new interpreter (the kernel's
    library is already built): its device ms, or AssertionError with its
    output."""
    code = (f"import sys; sys.path[:0] = [{HERE!r}, {SRC!r}]; "
            f"import chip_smoke; chip_smoke._graph_profile_child({scale}, "
            f"{event_ms!r})")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"the fresh process's profile failed "
                             f"(rc {proc.returncode}): "
                             f"{(proc.stdout + proc.stderr)[-2000:]}")
    return json.loads(lines[-1])["device_ms"]


def _graph_profile_child(scale, event_ms):
    """In a fresh process: the generator's profiler device ms at
    ``scale``, printed as the last line's JSON."""
    ms, kept, windows = kernel_device_ms(
        lambda: _graph_launch(scale), "kronecker_gen", event_ms,
        iters=GRAPH_TIME_ITERS, warmup=1, lead=2)
    print(json.dumps({"device_ms": ms, "kept": kept, "windows": windows}))


def _graph_kernel(out):
    """The generator's kernel against its plain version and numpy: the
    whole array at GRAPH_KERNEL_SCALE, GRAPH_SAMPLES sampled edges at
    GRAPH_SCALE, each beside the kernel run one draw late, which must fail
    both; its times (CUDA events, profiler device ms) at both scales, the
    plain version's at GRAPH_KERNEL_SCALE, and its bound from its SASS."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.kronecker import ops as kops
    from repro_torch.graph.kronecker import thresholds
    from repro_torch.kernels.kronecker import ref as kref
    thr = thresholds()
    launch = _graph_launch
    rows = {}
    scale = GRAPH_KERNEL_SCALE
    m = (1 << scale) * GRAPH_EDGEFACTOR
    t0 = time.monotonic()
    plain = kref.kronecker_draws_reference(np.random.default_rng(GRAPH_SEED),
                                           scale, m, *thr)
    plain_s = time.monotonic() - t0
    kern = launch(scale).cpu()
    late = launch(scale, advance=1).cpu()
    whole = {"control_bit_equal": bool(torch.equal(kern, plain)),
             "max_abs_err": int((kern - plain).abs().max()),
             "one_draw_late_bit_equal": bool(torch.equal(late, plain)),
             "one_draw_late_edges_differing": int(
                 (late != plain).any(0).sum())}
    del kern, late
    ms = cuda_ms(lambda: launch(scale), iters=GRAPH_TIME_ITERS, warmup=1)
    dms, dms_in = _graph_kernel_device_ms(scale, ms)
    rows[scale] = {"scale": scale, "edgefactor": GRAPH_EDGEFACTOR, "m": m,
                   "path": None, "ms": ms, "device_ms": dms,
                   "device_ms_in": dms_in,
                   "plain_ms": plain_s * 1e3, **whole}
    scale = GRAPH_SCALE
    m = (1 << scale) * GRAPH_EDGEFACTOR
    picks = np.sort(np.random.default_rng(GRAPH_SEED + 1).choice(
        m, GRAPH_SAMPLES, replace=False))
    raw = launch(scale)
    torch.cuda.synchronize()
    checked, bad, err = _sampled_draws_check(raw, GRAPH_SEED, scale, m,
                                             picks)
    del raw
    raw = launch(scale, advance=1)
    _, bad_late, _ = _sampled_draws_check(raw, GRAPH_SEED, scale, m, picks)
    del raw
    _free()
    ms = cuda_ms(lambda: launch(scale), iters=GRAPH_TIME_ITERS, warmup=1)
    _free()
    dms, dms_in = _graph_kernel_device_ms(scale, ms)
    sass = _sass_loop(_build.library_path("kronecker_gen"),
                      "kronecker_gen_kernel")
    if sass is None:
        raise AssertionError("the generator's loop over bits could not be "
                             "read from its SASS (cuobjdump), so its bound "
                             "is not known")
    per_it = sass["instructions"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = _max_sm_clock_hz()
    bound = graph_kernel_bound(scale, m, per_it, sms, clock)
    rows[scale] = {"scale": scale, "edgefactor": GRAPH_EDGEFACTOR, "m": m,
                   "path": "graph500-bfs", "ms": ms, "device_ms": dms,
                   "device_ms_in": dms_in,
                   "max_abs_err": err, "library_ms": None,
                   # numpy's draws on the host take minutes here: the
                   # plain version's time is the whole array's at
                   # GRAPH_KERNEL_SCALE
                   "plain_ms": rows[GRAPH_KERNEL_SCALE]["plain_ms"],
                   "plain_scale": GRAPH_KERNEL_SCALE,
                   "bit_pairs_checked": checked, "control_bad": bad,
                   "one_draw_late_bad": bad_late,
                   "launch": kops.launch_shape(m), "sass_loop": sass,
                   "sass_instructions_per_bit": per_it,
                   "draws_per_bit": kref.DRAWS_PER_BIT,
                   "sm_clock_hz": clock, "sms": sms, **bound}
    for k in ("bound_ms", "bound_by"):
        rows[GRAPH_KERNEL_SCALE][k] = graph_kernel_bound(
            GRAPH_KERNEL_SCALE, rows[GRAPH_KERNEL_SCALE]["m"], per_it, sms,
            clock)[k]
    for r in rows.values():
        log(f"graph_kernel {json.dumps(r)}")
    checks = {
        f"scale {GRAPH_KERNEL_SCALE}: kernel bit-equal to plain":
            whole["control_bit_equal"],
        f"scale {GRAPH_KERNEL_SCALE}: one draw late differs":
            not whole["one_draw_late_bit_equal"],
        f"scale {GRAPH_SCALE}: {checked} sampled bit pairs equal numpy's":
            bad == 0 and err == 0,
        f"scale {GRAPH_SCALE}: one draw late fails the sample":
            bad_late > 0,
    }
    out["graph_kernel_rows"] = list(rows.values())
    return checks


def _bfs_level_profile(csr, root):
    """One 1-rank BFS stepped level by level on this thread through the
    port's own level functions (``_upload``, ``_settle``, ``_expand``),
    each level in its own profiler window: its device ms (kernels and
    copies, from the profiler's device events) against its host wall."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.graph import bfs as gbfs
    dev = csr.device
    lo, hi = csr.local_range(0)
    parent = torch.full((hi - lo,), -1, dtype=torch.int64, device=dev)
    batches = [np.array([[root, root]], np.int64)]
    levels = []
    while True:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            frontier = gbfs._settle(parent, gbfs._upload(batches, dev), lo)
            out, traversed = gbfs._expand(csr, 0, frontier)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        device_ms = copy_ms = 0.0
        n_events = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                d = (e.time_range.end - e.time_range.start) / 1e3
                device_ms += d
                copy_ms += d if "memcpy" in e.name.lower() else 0.0
                n_events += 1
        levels.append({"level": len(levels), "frontier": int(len(frontier)),
                       "expanded": traversed,
                       "batch_bytes_in": sum(b.nbytes for b in batches),
                       "batch_bytes_out": sum(b.nbytes for b in out),
                       "host_wall_ms": wall * 1e3, "device_ms": device_ms,
                       "copy_ms": copy_ms, "device_events": n_events,
                       "busy_share": device_ms / (wall * 1e3)})
        batches = out
        if not len(frontier):
            break
    full = np.full(csr.n_vertices, -1, np.int64)
    full[lo:hi] = parent.cpu().numpy()
    return levels, full


def _bfs_socket(root, want_parent):
    """One socket session: ``bfs_program`` at GRAPH_PARITY_SCALE over
    GRAPH_PARITY_RANKS ranks on GRAPH_SOCKET_PROCS spawned processes, each
    building the graph on the card; its parents against the in-process
    card run's, the children's expansions by device, the parent's own
    count unmoved."""
    import numpy as np
    from repro_torch import edat
    from repro_torch.graph import bfs as gbfs
    parent0 = dict(gbfs.calls_by_device)
    t0 = time.monotonic()
    with edat.Session(GRAPH_PARITY_RANKS, transport="socket",
                      procs=GRAPH_SOCKET_PROCS, timeout=300) as s:
        stamp = s.call(0, _monotonic_stamp)
        s.run(edat.deferred(gbfs.bfs_program, GRAPH_PARITY_RANKS,
                            GRAPH_PARITY_SCALE, GRAPH_EDGEFACTOR,
                            GRAPH_SEED, root, device=GRAPH_DEVICE))
        res, stats = s.gather(), s.stats
        started = stamp.result(timeout=60)
    session_s = time.monotonic() - t0
    run_s = float(stats["run_seconds"])
    wire = stats.get("transport", {})
    traversed = int(np.sum(res["traversed"]))
    row = {"scale": GRAPH_PARITY_SCALE, "ranks": GRAPH_PARITY_RANKS,
           "procs": GRAPH_SOCKET_PROCS, "session_s": session_s,
           "spawn_build_s": started - t0, "run_seconds": run_s,
           "traversed": traversed, "teps": traversed / run_s,
           "calls_by_device": res["calls_by_device"],
           "host_bytes": res["host_bytes"],
           "wire": {k: wire.get(k) for k in (
               "wire_events_sent", "writes", "wire_bytes", "dropped")}}
    checks = {
        "socket parents equal the in-process card run's":
            np.array_equal(res["parent"], want_parent),
        "the children expanded on cuda only":
            set(res["calls_by_device"] or {}) == {GRAPH_DEVICE},
        "events crossed the wire": (wire.get("wire_events_sent") or 0) > 0,
        "the parent's calls_by_device unmoved":
            dict(gbfs.calls_by_device) == parent0,
    }
    return row, checks


def phase_graph(out):
    """The paper's Graph500 BFS (§V) on the card: the generator's kernel
    (``_graph_kernel``); the CSR and a 4-rank EDAT BFS at
    GRAPH_PARITY_SCALE against the CPU path on the same edges; then the
    paper's run at GRAPH_SCALE (edgefactor 16, seed 20, ``default_root``'s
    rule, checked against ``default_root`` at GRAPH_PARITY_SCALE, on the
    edges the run generated): the generator and the CSR on the card,
    ``EdatBFS`` and ``ReferenceBFS`` (BSP) at each of GRAPH_RANKS, parents
    bit-equal, ``validate_bfs_tree`` holding and rejecting two planted
    faults beside its control, totals equal across rank counts; TEPS,
    levels, a level-by-level profile, host bytes, peaks; one socket
    session."""
    import resource
    import numpy as np
    import torch
    from repro_torch.graph import (EdatBFS, ReferenceBFS, build_csr,
                                   default_root, kronecker_edges,
                                   validate_bfs_tree)
    from repro_torch.graph import bfs as gbfs
    from repro_torch.graph import kronecker as gkron
    from repro_torch.kernels.kronecker import ops as kops
    t_phase = time.monotonic()
    dev = torch.device(GRAPH_DEVICE)
    checks = _graph_kernel(out)
    sections = {"kernel": time.monotonic() - t_phase}

    # the CSR and a 4-rank BFS: the card against the CPU path, same edges
    scale, R = GRAPH_PARITY_SCALE, GRAPH_PARITY_RANKS
    n = 1 << scale
    edges = kronecker_edges(scale, GRAPH_EDGEFACTOR, GRAPH_SEED, device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    csr = build_csr(edges, n, R)
    torch.cuda.synchronize()
    csr_s = time.monotonic() - t0
    t0 = time.monotonic()
    host_csr = build_csr(edges.cpu(), n, R)
    host_csr_s = time.monotonic() - t0
    checks["parity: the card's CSR equals the CPU's rank for rank"] = all(
        torch.equal(a.cpu(), b) for r in range(R)
        for a, b in ((csr.indptr[r], host_csr.indptr[r]),
                     (csr.indices[r], host_csr.indices[r]))) and (
        csr.n_edges == host_csr.n_edges)
    root20 = default_root(scale, GRAPH_EDGEFACTOR, GRAPH_SEED, device=dev)
    deg = torch.bincount(edges.reshape(-1), minlength=n)
    checks["default_root is the first vertex of nonzero degree"] = \
        root20 == int(torch.nonzero(deg)[0, 0])
    card = EdatBFS(csr, device=dev)
    t0 = time.monotonic()
    card_parent = card.run(root20)
    card_s = time.monotonic() - t0
    cpu = EdatBFS(host_csr, device="cpu")
    t0 = time.monotonic()
    cpu_parent = cpu.run(root20)
    cpu_s = time.monotonic() - t0
    checks["parity: the card's parents equal the CPU path's"] = \
        np.array_equal(card_parent, cpu_parent)
    checks["parity: traversed equal"] = card.traversed == cpu.traversed
    parity = {"scale": scale, "ranks": R, "root": root20,
              "csr_card_s": csr_s, "csr_cpu_s": host_csr_s,
              "n_edges": csr.n_edges, "bfs_card_s": card_s,
              "bfs_cpu_s": cpu_s, "traversed": sum(card.traversed)}
    log(f"graph_parity {json.dumps(parity)}")
    del edges, deg, csr, host_csr, card, cpu
    _free()
    sections["parity"] = time.monotonic() - t_phase - sum(sections.values())
    socket_row, socket_checks = _bfs_socket(root20, card_parent)
    sections["socket"] = time.monotonic() - t_phase - sum(sections.values())
    log(f"graph_socket {json.dumps(socket_row)}")
    checks.update({f"socket: {k}": v for k, v in socket_checks.items()})

    # the paper's run: the main path, counted from 0
    scale = GRAPH_SCALE
    n = 1 << scale
    kops.reset_counts()
    gbfs.reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    edges = kronecker_edges(scale, GRAPH_EDGEFACTOR, GRAPH_SEED, device=dev)
    torch.cuda.synchronize()
    gen_s = time.monotonic() - t0
    perm_s = gkron.permutation_seconds
    # default_root's rule on the edges at hand (it would generate them
    # again)
    deg = torch.bincount(edges.reshape(-1), minlength=n)
    root = int(torch.nonzero(deg)[0, 0])
    deg = deg.cpu().numpy()
    runs, parents, level_rows = [], {}, None
    for R in GRAPH_RANKS:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        csr = build_csr(edges, n, R)
        torch.cuda.synchronize()
        csr_s = time.monotonic() - t0
        row = {"ranks": R, "csr_s": csr_s, "n_edges": csr.n_edges}
        cold = (GRAPH_COLD_RUN,) if R == GRAPH_RANKS[0] else ()
        for name in cold + GRAPH_RUN_ORDER:
            prog = (ReferenceBFS(csr, device=dev) if name == "bsp"
                    else EdatBFS(csr, device=dev))
            t0 = time.monotonic()
            parent = prog.run(root)
            wall = time.monotonic() - t0
            traversed = sum(prog.traversed)
            row[name] = {"wall_s": wall, "traversed": traversed,
                         "teps": traversed / wall,
                         "host_bytes": sum(prog.host_bytes),
                         "reached": int((parent >= 0).sum())}
            if name != "bsp":
                row[name]["levels"] = prog.levels[0]
            row[name]["host_pool_gib"] = gbfs.host_pool.pinned_bytes / 2 ** 30
            parents[(R, name)] = parent
        if cold:
            row["edat_cold_parents_equal"] = bool(np.array_equal(
                parents.pop((R, GRAPH_COLD_RUN)), parents[(R, "edat")]))
            checks[f"{R} ranks: the cold EDAT run's parents equal the "
                   f"warm's"] = row["edat_cold_parents_equal"]
        t0 = time.monotonic()
        row["valid"] = validate_bfs_tree(edges, parents[(R, "edat")], root)
        row["validate_s"] = time.monotonic() - t0
        row["edat_parents_equal_bsp"] = bool(np.array_equal(
            parents[(R, "edat")], parents[(R, "bsp")]))
        if R == GRAPH_RANKS[0]:
            level_rows, stepped = _bfs_level_profile(csr, root)
            row["stepped_parents_equal_edat"] = bool(
                np.array_equal(stepped, parents[(R, "edat")]))
            checks["1 rank: the stepped run's parents equal EDAT's"] = \
                row["stepped_parents_equal_edat"]
        parents.pop((R, "bsp"))
        del prog
        row["rss_gib_after"] = _rss_gib()
        log(f"graph_run {json.dumps(row)}")
        runs.append(row)
        checks[f"{R} ranks: EDAT parents bit-equal to BSP's"] = \
            row["edat_parents_equal_bsp"]
        checks[f"{R} ranks: validate_bfs_tree holds"] = row["valid"]
        del csr
        _free()
    sections["scale_25"] = time.monotonic() - t_phase - sum(sections.values())
    first = runs[0]
    for row in runs[1:]:
        for name in ("edat", "bsp"):
            for k in ("reached", "traversed"):
                checks[f"{row['ranks']} ranks {name}: {k} equal to 1 "
                       f"rank's"] = row[name][k] == first["edat"][k]
    faults = bfs_parent_faults(parents[(GRAPH_RANKS[0], "edat")], root, deg)
    verdicts = {f: validate_bfs_tree(edges, p, root)
                for f, p in faults.items()}
    for f, ok in verdicts.items():
        checks[f"{f} fails validate_bfs_tree"] = not ok
    main_path = {"kernel_launches": kops.kernel_launches,
                 "plain_calls": kops.plain_calls,
                 "calls_by_device": dict(gbfs.calls_by_device)}
    checks["the main path launched the generator's kernel"] = \
        kops.kernel_launches > 0
    checks["the main path never called the plain generator"] = \
        kops.plain_calls == 0
    checks["every expansion of the main path ran on cuda"] = \
        set(gbfs.calls_by_device) == {dev.type}
    out.setdefault("main_path_launches", {})["graph500-bfs"] = {
        "kronecker_gen": kops.kernel_launches}
    pool_gib = gbfs.host_pool.pinned_bytes / 2 ** 30
    gbfs.host_pool.release()
    _empty_host_cache()
    device_ms = sum(r["device_ms"] for r in level_rows)
    wall_ms = sum(r["host_wall_ms"] for r in level_rows)
    biggest = max(level_rows, key=lambda r: r["expanded"])
    line = {
        "card": out.get("card"), "scale": scale,
        "edgefactor": GRAPH_EDGEFACTOR, "seed": GRAPH_SEED, "root": root,
        "generate_s": gen_s, "permutation_host_s": perm_s, "runs": runs,
        "teps": {r["ranks"]: {"edat": r["edat"]["teps"],
                              "bsp": r["bsp"]["teps"]} for r in runs},
        "levels": level_rows, "stepped_device_ms": device_ms,
        "stepped_host_wall_ms": wall_ms, "busy_share": device_ms / wall_ms,
        "largest_level": biggest, "fault_verdicts": verdicts,
        "main_path": main_path, "parity": parity, "socket": socket_row,
        "host_pool_gib": pool_gib, "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2 ** 30,
        "peak_rss_gib": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
        "rss_gib": _rss_gib(), "sections_s": sections,
        "phase_s": time.monotonic() - t_phase}
    log(f"graph {json.dumps(line)}")
    out["graph"] = line
    failed = [k for k, ok in checks.items() if not ok]
    log("graph checks " + json.dumps(checks))
    if failed:
        raise AssertionError(f"graph checks failed: {failed}")


# ------------------------------------------------------------ the launchers
# phase 46: the port's own command lines (repro_torch.launch), in process
# through main(argv), at gemma3-1b's full width and depth; then the
# dry-run's cell of the train CLI's own shape held to the card's
# allocation.  Each CLI's loop (serve.generate, train.train) is wrapped
# while it runs (``_spy``) to read what it got and gave.
LAUNCH_SERVE = dict(batch=4, prompt_len=384, max_new=16)
LAUNCH_TRAIN = dict(steps=3, batch=2, seq=512)
# the caching allocator rounds each request up to 512 bytes, and leaves a
# block of its large pool (requests over 1 MiB) unsplit where less than
# 1 MiB would remain: memory_allocated then counts the whole block
ALLOC_ROUNDING = 512
ALLOC_UNSPLIT = 2 ** 20


def _card_bytes():
    """(memory_allocated, the requested bytes behind it), now."""
    import torch
    return (torch.cuda.memory_allocated(),
            torch.cuda.memory_stats()["requested_bytes.all.current"])


def _argv(arch, **kw):
    return ["--arch", arch] + [x for k, v in kw.items()
                               for x in (f"--{k.replace('_', '-')}", str(v))]


@contextlib.contextmanager
def _spy(module, name, before=None):
    """Wrap ``module.name`` while open: each call appends {"args",
    "kwargs", "result", "before"} to the yielded list, "before" being
    ``before(args, kwargs)`` (which may replace kwargs) at entry."""
    orig, calls = getattr(module, name), []

    def wrapper(*args, **kwargs):
        seen = before(args, kwargs) if before else None
        result = orig(*args, **kwargs)
        calls.append({"args": args, "kwargs": kwargs, "result": result,
                      "before": seen})
        return result
    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def phase_launch(out):
    """The serve and train CLIs on the card, then the dry-run's bytes of
    the train CLI's shape against the card's allocation and its FLOPs
    over the measured step wall."""
    import math
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import cells, cost, dryrun
    from repro_torch.launch import serve, train
    from repro_torch.sharding import MeshShape
    from repro_torch.tree import tree_leaves
    cfg = ARCHS[GEMMA].cfg
    per_forward = path_kernels(cfg)["flash_attention_fwd"]
    all_ops = _all_ops()

    def counted(run):
        """``run()`` with every kernel's counts from 0: (its result,
        launches, plain calls, flash launches by variant, wall s)."""
        torch.cuda.synchronize()
        for ops in all_ops.values():
            ops.reset_counts()             # this CLI run's counts only
        t0 = time.monotonic()
        result = run()
        torch.cuda.synchronize()
        return (result, {k: o.kernel_launches for k, o in all_ops.items()},
                {k: o.plain_calls for k, o in all_ops.items()},
                dict(fa.launches_by_variant), time.monotonic() - t0)

    # the serve CLI: one prefill through the kernel, decode in plain ops
    argv = _argv(GEMMA, **LAUNCH_SERVE)
    with _spy(serve, "generate") as calls:
        rc, launches, plain, by_variant, wall = counted(
            lambda: serve.main(argv))
    model, toks = calls[0]["args"][0], calls[0]["result"]
    leaves = list(model.params.parameters())
    want = per_forward
    srow = {"argv": argv, "rc": rc, "wall_s": wall,
            "kernel_launches": launches, "plain_calls": plain,
            "flash_launches_by_variant": by_variant,
            "tokens_shape": list(toks.shape), "tokens_dtype": str(toks.dtype),
            "params_devices": sorted({str(p.device) for p in leaves})}
    checks = {
        "exit code 0": rc == 0,
        "one generate call": len(calls) == 1,
        f"flash_attention_fwd launches == {want} (the prefill)":
            launches["flash_attention_fwd"] == want,
        "every flash launch mma_bf16": by_variant == {"mma_bf16": want,
                                                      "simt": 0},
        "no other kernel, no plain call": not any(
            n for k, n in launches.items() if k != "flash_attention_fwd")
            and not any(plain.values()),
        "parameters on cuda": all(p.is_cuda for p in leaves),
        "tokens (batch, max_new)": tuple(toks.shape) == (
            LAUNCH_SERVE["batch"], LAUNCH_SERVE["max_new"]),
        "tokens inside the vocabulary": bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()),
    }
    del model, toks, leaves, calls
    _free()
    log("launch_serve " + json.dumps(srow))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve CLI checks failed: {failed}")

    # the train CLI: the kernel in every forward and remat recompute
    walls = []

    def at_train(args, kwargs):
        printed = kwargs.get("on_step")

        def on_step(i, loss, dt):
            walls.append(dt)
            if printed is not None:
                printed(i, loss, dt)
        kwargs["on_step"] = on_step
        return _card_bytes()                   # parameters and state made

    argv = _argv(GEMMA, **LAUNCH_TRAIN)
    _free()
    base = _card_bytes()
    with _spy(train, "train", before=at_train) as calls:
        rc, launches, plain, by_variant, wall = counted(
            lambda: train.main(argv))
    model, state = calls[0]["args"][0], calls[0]["kwargs"]["state"]
    losses = calls[0]["result"]
    n_tensors = len(list(model.params.parameters())) + len(
        tree_leaves(state))
    grown, requested = (a - b for a, b in zip(calls[0]["before"], base))
    want = 2 * per_forward * LAUNCH_TRAIN["steps"]
    trow = {"argv": argv, "rc": rc, "wall_s": wall, "losses": losses,
            "step_walls_s": walls, "kernel_launches": launches,
            "plain_calls": plain, "flash_launches_by_variant": by_variant,
            "backward_by_path": dict(fa.backward_by_path),
            "allocated_growth_bytes": grown,
            "requested_growth_bytes": requested, "tensors": n_tensors}
    checks = {
        "exit code 0": rc == 0,
        f"{LAUNCH_TRAIN['steps']} finite losses":
            len(losses) == LAUNCH_TRAIN["steps"]
            and all(math.isfinite(x) for x in losses),
        f"flash_attention_fwd launches == {want} "
        f"({2 * per_forward} a step)": launches["flash_attention_fwd"] == want,
        "every flash launch mma_bf16": by_variant == {"mma_bf16": want,
                                                      "simt": 0},
        "no other kernel, no plain call": not any(
            n for k, n in launches.items() if k != "flash_attention_fwd")
            and not any(plain.values()),
        "parameters on cuda": all(p.is_cuda
                                  for p in model.params.parameters()),
    }
    del model, state, calls
    _free()

    # the dry-run's cell of the same shape, on one device
    mesh = MeshShape((1, 1), ("data", "model"))
    shape = ShapeCfg("launch-train", LAUNCH_TRAIN["seq"],
                     LAUNCH_TRAIN["batch"], "train")
    t0 = time.monotonic()
    cell = cells.build_cell(GEMMA, shape, mesh, optimizer="adamw")
    dry_bytes, dry_tensors = dryrun.argument_bytes(
        cell.args[:2], cell.in_shardings[:2], mesh)   # parameters, state
    sizes = [t.numel() * t.element_size()
             for t in tree_leaves(list(cell.args[:2]))]
    # memory_allocated's most over the tensors' bytes: 512 B a tensor, and
    # an unsplit remainder of up to 1 MiB a large one
    block_slack = sum(ALLOC_ROUNDING + (ALLOC_UNSPLIT if b > ALLOC_UNSPLIT
                                        else 0) for b in sizes)
    analysis = cost.analyze(cell.fn, *cell.args)
    step_s = min(walls[1:] or walls)      # past the first step's warm-up
    trow.update(
        dryrun_s=time.monotonic() - t0, dryrun_meta=cell.meta,
        dryrun_bytes=dry_bytes, dryrun_tensors=dry_tensors,
        allocated_minus_dryrun=grown - dry_bytes,
        requested_minus_dryrun=requested - dry_bytes,
        large_tensors=sum(b > ALLOC_UNSPLIT for b in sizes),
        block_slack_bytes=block_slack, analysis=analysis,
        step_s=step_s, card=out.get("card"),
        achieved_flops_per_s=analysis["flops"] / step_s,
        flops_note="plain-path FLOPs, masked tiles included, over the "
                   "fastest measured step wall")
    checks.update({
        "dry-run tensors == the card's": dry_tensors == n_tensors,
        "dry-run bytes == requested-bytes growth within 512 B a tensor":
            abs(requested - dry_bytes) <= ALLOC_ROUNDING * dry_tensors,
        "memory_allocated growth within the allocator's block rounding":
            0 <= grown - dry_bytes <= block_slack,
    })
    del cell
    log("launch_train " + json.dumps(trow))
    log(f"launch_train achieved {trow['achieved_flops_per_s']:.4e} FLOP/s "
        f"(plain-path FLOPs, masked tiles included: {analysis['flops']:.4e} "
        f"over {step_s:.4f} s) on {out.get('card')}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train CLI checks failed: {failed}")
    out["launch_serve"], out["launch_train"] = srow, trow
    paths = out.setdefault("main_path_launches", {})
    variants = out.setdefault("flash_main_path_by_variant", {})
    for path, row in (("launch-serve", srow), ("launch-train", trow)):
        paths[path] = {"flash_attention_fwd":
                       row["kernel_launches"]["flash_attention_fwd"]}
        variants[path] = row["flash_launches_by_variant"]


PHASES = {
    1: ("env", phase_env),
    2: ("build", phase_build),
    3: ("flash_attention kernel", phase_kernels),
    4: ("gemma3-1b model", lambda out: phase_model(out, GEMMA)),
    5: ("gemma3-1b serve (main path)", lambda out: phase_serve(out, GEMMA)),
    6: ("gemma3-1b parity", lambda out: phase_parity(out, GEMMA)),
    7: ("gemma3-1b profile", lambda out: phase_profile(out, GEMMA)),
    8: ("ssd kernel", phase_ssd),
    9: ("mamba2-370m model", lambda out: phase_model(out, MAMBA)),
    10: ("mamba2-370m serve (main path)",
         lambda out: phase_serve(out, MAMBA)),
    11: ("mamba2-370m parity", lambda out: phase_parity(out, MAMBA)),
    12: ("mamba2-370m profile", lambda out: phase_profile(out, MAMBA)),
    13: ("rglru kernel", phase_rglru),
    14: ("recurrentgemma-9b model", lambda out: phase_model(out, RGEMMA)),
    15: ("recurrentgemma-9b serve (main path)",
         lambda out: phase_serve(out, RGEMMA)),
    16: ("recurrentgemma-9b parity", lambda out: phase_parity(out, RGEMMA)),
    17: ("recurrentgemma-9b profile",
         lambda out: phase_profile(out, RGEMMA)),
    18: ("gemma3-1b serve over sockets", phase_serve_socket),
    19: ("gemma3-1b train (event-driven trainer)", phase_train),
    20: ("granite-moe-1b-a400m model", lambda out: phase_model(out, GRANITE)),
    21: ("granite-moe-1b-a400m serve (main path)",
         lambda out: phase_serve(out, GRANITE)),
    22: ("granite-moe-1b-a400m float32 serving",
         lambda out: phase_replay(out, GRANITE)),
    23: ("granite-moe-1b-a400m profile",
         lambda out: phase_profile(out, GRANITE)),
    24: ("gemma2-2b model", lambda out: phase_model(out, GEMMA2)),
    25: ("gemma2-2b serve (main path)", lambda out: phase_serve(out, GEMMA2)),
    26: ("gemma2-2b parity", lambda out: phase_parity(out, GEMMA2)),
    27: ("gemma2-2b profile", lambda out: phase_profile(out, GEMMA2)),
    28: ("stablelm-1.6b model", lambda out: phase_model(out, STABLELM)),
    29: ("stablelm-1.6b serve (main path)",
         lambda out: phase_serve(out, STABLELM)),
    30: ("stablelm-1.6b parity", lambda out: phase_parity(out, STABLELM)),
    31: ("stablelm-1.6b profile", lambda out: phase_profile(out, STABLELM)),
    32: ("starcoder2-15b model", lambda out: phase_model(out, STARCODER2)),
    33: ("starcoder2-15b serve (main path)",
         lambda out: phase_serve(out, STARCODER2)),
    34: ("starcoder2-15b parity", lambda out: phase_parity(out, STARCODER2)),
    35: ("starcoder2-15b profile",
         lambda out: phase_profile(out, STARCODER2)),
    36: ("deepseek-v3-671b model", lambda out: phase_model(out, DEEPSEEK)),
    37: ("deepseek-v3-671b serve (main path)",
         lambda out: phase_serve(out, DEEPSEEK)),
    38: ("deepseek-v3-671b float32 serving",
         lambda out: phase_replay(out, DEEPSEEK)),
    39: ("deepseek-v3-671b profile",
         lambda out: phase_profile(out, DEEPSEEK)),
    40: ("gemma3-1b train at 8,192 tokens (remat, chunked attention)",
         phase_train_long),
    41: ("whisper-tiny model and serve (main path)", phase_whisper),
    42: ("whisper-tiny train", phase_whisper_train),
    43: ("mamba2-370m train at 4,096 tokens (event-driven trainer)",
         phase_train_ssd),
    44: ("MONC in-situ analytics (paper §VI)", phase_insitu),
    45: ("Graph500 BFS (paper §V)", phase_graph),
    46: ("launch: the train and serve CLIs and the dry-run", phase_launch),
}


def kernels_line(out):
    """One entry per kernel.  ``launches`` sums the kernel's launches over
    the main paths this run drove (each counted from 0 just before its
    serving or training run), ``launches_by_path`` splits them by path;
    the numbers of one timed shape stand in the entry, every shape is in
    ``--json``.
    ``ms`` (and ``kernel_ms``) is CUDA events around back-to-back calls
    (``cuda_ms``), the wrapper's host work included where it outlasts the
    kernel; ``device_ms`` beside it is the kernel's own device time
    (``kernel_device_ms``)."""
    fa_rows = out.get("flash_attention_cases", [])
    ssd_rows = out.get("ssd_cases", [])
    rg_rows = out.get("rglru_cases", [])
    by_path = out.get("main_path_launches", {})
    fa_timed = next((r for r in fa_rows if r["path"]
                     and (r["S"], r["window"]) == TIMED), None)
    ssd_timed = next((r for r in ssd_rows if r["path"]
                      and r["T"] == SSD_TIMED_T), None)
    rg_timed = next((r for r in rg_rows if r["path"]
                     and r["T"] == RG_TIMED_T), None)
    graph_rows = out.get("graph_kernel_rows", [])
    graph_timed = next((r for r in graph_rows if r["path"]), None)
    entries = []
    for name, source, replaces, rows, timed, tol, rule, keys in (
            ("flash_attention_fwd", FA_SOURCE, FA_REPLACES, fa_rows,
             fa_timed, TOL["bfloat16"],
             f"|kernel - plain| <= {TOL['bfloat16']} * (1 + |plain|); "
             f"not causal: <= {TOL['bfloat16']} * max|plain|",
             ("B", "S", "H", "KH", "D", "Dv", "window", "dtype")),
            ("ssd_fwd", SSD_SOURCE, SSD_REPLACES, ssd_rows, ssd_timed,
             ssd_timed["tol"] if ssd_timed else None,
             f"|kernel - plain| <= {SSD_TOL} * max|plain| (tol is that "
             f"limit at the timed shape)",
             ("B", "T", "H", "G", "N", "P", "chunk", "dtype")),
            ("rglru_fwd", RG_SOURCE, RG_REPLACES, rg_rows, rg_timed, RG_TOL,
             f"|kernel - plain| <= {RG_TOL} * (1 + |plain|)",
             ("B", "T", "W", "h0", "lam")),
            ("kronecker_gen", GRAPH_SOURCE, GRAPH_REPLACES, graph_rows,
             graph_timed, 0,
             f"bit-equal: src and dst of every edge at scale "
             f"{GRAPH_KERNEL_SCALE} against the plain version, and of "
             f"{GRAPH_SAMPLES} sampled edges at scale {GRAPH_SCALE} against "
             f"numpy's draws reached by advance",
             ("scale", "edgefactor", "m"))):
        path_err = max((r["max_abs_err"] for r in rows if r["path"]),
                       default=None)
        paths = {arch: n[name] for arch, n in by_path.items() if name in n}
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(paths.values()) if paths else None,
            "launches_by_path": paths,
            "max_abs_err": path_err, "max_err": path_err, "tol": tol,
            "tol_rule": rule,
            "shape": None, "ms": None, "kernel_ms": None, "device_ms": None,
            "plain_ms": None,
            "bound_ms": None, "bound_by": None, "library_ms": None,
        }
        if timed is not None:
            entry.update(shape={k: timed[k] for k in keys},
                         ms=timed["ms"], kernel_ms=timed["ms"],
                         device_ms=timed["device_ms"],
                         plain_ms=timed["plain_ms"],
                         bound_ms=timed["bound_ms"],
                         bound_by=timed["bound_by"],
                         library_ms=timed["library_ms"])
        if name == "flash_attention_fwd":
            # the main paths' launches by variant
            by_variant = out.get("flash_main_path_by_variant", {})
            # granite-moe-1b-a400m's shape (H=16, KH=8, D=64), gemma2-2b's
            # (H=8, KH=4, D=256, softcap 50), stablelm-1.6b's (H=KH=32,
            # D=64) and deepseek-v3-671b's (H=KH=128, D=192, Dv=128), no
            # window, at S=511, starcoder2-15b's (H=48, KH=4, D=128,
            # window 4096) at S=511 and WINDOW_S, and whisper-tiny's
            # encoder (H=KH=6, D=64, not causal) at its 1,500 frames, bf16,
            # timed as the entry's; whisper's launches are its served
            # path's, and its trained path's under "whisper_train"
            window = STARCODER2_FA_SHAPE["window"]
            for key, row_path, S, w in (
                    ("granite", GRANITE, TIMED[0], None),
                    ("gemma2", GEMMA2, TIMED[0], None),
                    ("stablelm", STABLELM, TIMED[0], None),
                    ("starcoder2", STARCODER2, TIMED[0], window),
                    ("starcoder2_long", STARCODER2, WINDOW_S, window),
                    ("deepseek", DEEPSEEK, TIMED[0], None),
                    ("whisper", WHISPER, WHISPER_FRAMES, None),
                    ("whisper_train", f"{WHISPER}-train", WHISPER_FRAMES,
                     None)):
                g = next((r for r in rows if r["path"] == row_path
                          and r["S"] == S and r["window"] == w
                          and r["dtype"] == "bfloat16"), None)
                entry[key] = g and {
                    k: g.get(k) for k in (
                        "B", "S", "H", "KH", "D", "Dv", "window", "softcap",
                        "causal", "dtype", "variant", "max_abs_err", "ms",
                        "device_ms", "simt_ms", "simt_device_ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms", "library",
                        "library_max_abs_err", "library_nocap_ms",
                        "nocap_device_ms")}
                if entry[key]:
                    entry[key]["launches_by_variant"] = by_variant.get(
                        row_path)
                    entry[key]["launches"] = by_path.get(row_path, {}).get(
                        name)
            # the variant the timed shape launched, the main paths' launches
            # by variant summed, and the SIMT kernel on the same inputs
            entry["variant"] = timed["variant"] if timed else None
            entry["launches_by_variant"] = {
                v: sum(n[v] for n in by_variant.values())
                for v in FA_ENTRY} if by_variant else None
            entry["launches_by_variant_by_path"] = by_variant
            entry["simt_ms"] = timed.get("simt_ms") if timed else None
            entry["simt_device_ms"] = (timed.get("simt_device_ms")
                                       if timed else None)
        if name == "ssd_fwd":
            entry["library"] = "no single PyTorch call computes the SSD scan"
            # the variant the timed shape launched, the main paths'
            # launches by variant, summed and by path, and the SIMT kernel
            # on the same inputs
            entry["variant"] = timed["variant"] if timed else None
            by_variant = out.get("ssd_main_path_by_variant", {})
            entry["launches_by_variant"] = {
                v: sum(n[v] for n in by_variant.values())
                for v in SSD_ENTRY} if by_variant else None
            entry["launches_by_variant_by_path"] = by_variant
            # the training path's bf16 shape at its 4,096 tokens
            g = next((r for r in rows if r["path"] == SSD_TRAIN_PATH
                      and r["T"] == SSD_TRAIN_T[-1]
                      and r["dtype"] == "bfloat16"), None)
            entry["train"] = g and {
                k: g.get(k) for k in (
                    "B", "T", "H", "G", "N", "P", "chunk", "dtype",
                    "variant", "max_abs_err", "ms", "device_ms", "simt_ms",
                    "simt_device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "grad_check")}
            if entry["train"]:
                entry["train"]["launches"] = paths.get(SSD_TRAIN_PATH)
            entry["simt_ms"] = timed.get("simt_ms") if timed else None
            entry["simt_device_ms"] = (timed.get("simt_device_ms")
                                       if timed else None)
        if name == "rglru_fwd":
            entry["library"] = ("no single PyTorch call computes the RG-LRU "
                                "recurrence")
            # the timed shape's launch: the segmented scan's grid and L
            launch = timed["launch"] if timed else {}
            for k in ("blocks", "threads_per_block", "segment_steps"):
                entry[k] = launch.get(k)
        if name == "kronecker_gen":
            entry["library"] = ("none: no PyTorch call draws numpy's PCG64 "
                                "stream")
            # the plain version (numpy's draws on the host) timed over the
            # whole array at GRAPH_KERNEL_SCALE, the kernel beside it there
            small = next((r for r in rows if not r["path"]), None)
            entry["plain_scale"] = timed["plain_scale"] if timed else None
            entry["at_kernel_scale"] = small and {k: small[k] for k in (
                "scale", "m", "ms", "device_ms", "plain_ms", "max_abs_err",
                "bound_ms", "bound_by")}
            for k, key in (("launch", "launch"),
                           ("sass_instructions_per_bit",
                            "sass_instructions_per_bit"),
                           ("sampled_bit_pairs", "bit_pairs_checked"),
                           ("sampled_bad_bit_pairs", "control_bad")):
                entry[k] = timed[key] if timed else None
        entries.append(entry)
    return {"kernels": entries}


def main(argv=None) -> int:
    started = time.monotonic()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma-separated phase numbers to run")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write every number of the run to PATH")
    args = ap.parse_args(argv)
    phases = [int(p) for p in args.phases.split(",")]
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    out = {}
    for p in phases:
        _free()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        title, fn = PHASES[p]
        log(f"== phase {p}: {title}")
        try:
            fn(out)
        except Exception:
            traceback.print_exc()
            log(f"== phase {p} FAILED")
            return 1
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out.setdefault("peak_memory_gib", {})[p] = peak
        out.setdefault("phase_seconds", {})[p] = time.monotonic() - t0
        log(f"== phase {p} ok ({out['phase_seconds'][p]:.1f} s, peak "
            f"{peak:.2f} GiB allocated)")
    out["run_seconds"] = time.monotonic() - started
    phase_s = sum(out["phase_seconds"].values())
    log(f"== {len(phases)} phases ok in {phase_s:.1f} s of phases, "
        f"{out['run_seconds']:.1f} s in all")
    line = kernels_line(out)
    out.update(line)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    log(out.get("card", ""))
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
