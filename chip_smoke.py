#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path — ``compile_fn``/``compile_module`` ->
``get_plan`` -> ``SearchPlan.execute`` with the default device (the GPU)
and backend (``"cuda"``) — on the paper's two workloads at full size:

* ``knn_eucl``       — KNN, Euclidean top-5, 180,000 x 1024 gallery
                       (float32, 737 MB on the card), 624 queries:
                       kernel ``fused_topk`` on its "wgmma" route (3xTF32
                       tensor cores; each eucl index swap against the
                       plain version is replayed in the kernel's
                       arithmetic), timed at the 624 rows the path gives
                       it and at the 1024-row padded shape of earlier
                       runs;
* ``hamming_packed`` — hamming top-10 on the same gallery binarised
                       ``> 0``: kernel ``fused_topk_packed``;
* ``tcam_ternary``   — the same with a 10 % wildcard care mask:
                       kernel ``fused_topk_packed`` (ternary);
* ``hdc_quickstart`` — HDC associative-memory recall, dot top-1 over
                       10 x 8192 class hypervectors, 64 queries
                       (auto-packed): kernel ``fused_topk_packed``;
* ``forest_acam``    — decision-forest inference through
                       ``CamForestClassifier.predict``: 512 random trees
                       of depth 8 over 64 features (131,072 aCAM interval
                       rows), 1024 queries: kernel ``acam_match`` (no
                       compares: sign bits of FP32 differences), bound on
                       its issue slots (``acam_issue_slots``);
* ``range_threshold`` — TH-mode range search (``RangePlan``) on the KNN
                       gallery: eucl with tau the median 5th-nearest
                       squared distance, and hamming on float cells
                       (``pack=None`` on the cuda backend) with tau the
                       median 10th-nearest distance: kernel
                       ``range_match`` (3xTF32 tensor cores; each eucl
                       disagreement with the plain version is also
                       replayed in the kernel's arithmetic), on the 624
                       rows the path gives it and on the 1024-row padded
                       shape of earlier runs;
* ``hdc_mnist``      — the paper's HDC/MNIST-8k through ``HdcClassifier``:
                       60,000 training and 10,000 test samples of 784
                       features encoded to 8192 dims (kernel
                       ``hdc_encode``, bit-sliced, on the item memory's
                       bit planes), one-shot fit, packed
                       classification (``fused_topk_packed``) and three
                       retraining epochs whose touched class rows go
                       through ``SearchPlan.update_rows``;
* ``gallery_update`` — ``update_rows`` on the KNN gallery: 1 % of its rows
                       (18 runs of 100) replaced, ``donate=False`` and
                       ``donate=True``, on the eucl plan (``fused_topk``)
                       and the packed hamming plan (``fused_topk_packed``),
                       each result bit-identical to a fresh plan's;
* ``distance_ops``   — the public distance API (``ops.cam_distances`` /
                       ``cam_exact`` / ``cam_range``) on the KNN data:
                       kernel ``distance`` (3xTF32 tensor cores); eucl
                       held to the tolerance over the whole matrix, and
                       one query row plus the ``REPLAY_FURTHEST`` entries
                       furthest from the plain version equal bit for bit
                       to the replay of the kernel's own arithmetic
                       (``cam_search.tf32x3_kernel_eucl``);
* ``tune``           — the plan autotuner (``repro_torch.tune``) on the
                       ``"cuda"`` backend with its default trials and
                       reps, against a fresh temporary plan store:
                       ``knn_eucl``'s and ``hamming_packed``'s programs and
                       ``forest_acam``'s interval range plan, each winner
                       held to its baseline (bit-identical for hamming and
                       the interval match, eucl within the tolerance), and
                       no candidate (each micro-batch, each packing)
                       rejected or refused; a
                       torch-only child process rebuilds the data from the
                       same seeds and warm-starts from the store (no trial,
                       three config hits, no kernel built, bit-identical
                       results); a ``CamSearchServer`` and a gateway tenant
                       built over the heuristic hamming plan serve the
                       stored winner, ``tuned=False`` keeps the heuristic
                       plan;
* ``hier_search``    — the hierarchical two-stage search
                       (``get_hierarchical_plan``, the ``"torch"`` backend:
                       no hand-written kernel on its path): (a) the
                       reference's ``benchmarks/bench_hier.py`` geometry
                       (packed hamming top-10 over a clustered 131,072 x
                       256 gallery, 64 queries, 128 clusters, k-means 4
                       iterations) at nprobe 4, 8, 16 and 128, the last
                       bit-identical to flat B1 and to the flat ``"torch"``
                       plan, recall monotone in nprobe; a 1 % row update
                       with reassignment and an overflow re-layout, each
                       equal to a fresh layout with the same centroids;
                       (c) the nprobe-8 plan served to 8 client threads,
                       equal to the direct call; (b) eucl top-5 at the KNN
                       shape (default clusters, nprobe clusters // 8 and
                       clusters), the latter within the eucl tolerance of
                       flat B2, and two prepares giving bit-identical
                       centroids.  B1 and B2 launch only as the flat
                       oracles;
* ``lm_serve``       — LM serving through ``launch.serve.Server``:
                       qwen2.5-14b at full width and depth in bf16 (random
                       weights from a seed), 4 prompts of 2048 tokens, 32
                       new tokens each, decode batch 2, every attention
                       call on kernel ``flash_attention``; the Server
                       prefills through one captured CUDA graph a prompt
                       length and decodes through one a slot (the
                       wrappers count at each graph's warm-up and capture:
                       exactly 2 x 48 x (1 + 2) launches; a replay's
                       device kernels from the profiler), every request's
                       tokens equal to the eager steps' and the first
                       prefill's and four decode steps' logits
                       bit-identical to them, ms a prefill and a decode
                       token (median, p90) graphed and eager, capture
                       seconds and the graphs' pool bytes printed (every
                       serve phase does the same), B7 reading its start
                       from the device held at kv_len 1, 63, 64, 65, a
                       split boundary and the capacity to the host call
                       and the recurrence (here, ``hybrid_serve`` and
                       ``vlm_serve``), a second Server giving the same
                       tokens; then the
                       reference's prefill-then-decode contract in float32
                       at full width and depth 4, and B7 against its plain
                       version on the operands of layers 0 and 47 (from
                       an untimed prefill and decode step of the first
                       prompt) and at the ``decode_32k`` cache length
                       (bf16 within 0.05, float32 within 2e-3), each bf16
                       output also held to the Pallas kernel's own
                       recurrence at the route's kv tiles and splits
                       (``flash_attention_recurrence``; scaled to the
                       case: at most 0.1 % of the outputs beyond one bf16
                       step), timed beside
                       ``scaled_dot_product_attention``;
* ``moe_serve``      — the moe family: deepseek-moe-16b uncut (28 layers,
                       16.4e9 parameters, the routed experts float32 as
                       the reference's init leaves them: 62.6 GB) served
                       as ``lm_serve`` serves qwen, once with
                       ``router_offload="cam"`` (every MoE layer's top-k on
                       kernel ``fused_topk``, dot, ``largest=True``) and
                       once with ``"dense"``, launches exact, the two
                       runs' expert choices and tokens compared; B2 on
                       layer 1's router input at prefill and decode held
                       to its plain version (every index difference, and
                       every difference from the ``"dense"`` route, a
                       float64 near-tie in the order the kernel's own
                       arithmetic gives, ``tf32x3_kernel_dot``), timed
                       beside ``x @ W`` + ``topk``; float32 at depth 2
                       (capacity factor 64: no token drops) on the card
                       against the same model through the plain versions;
                       phi3.5-moe at full width, depth cut to 4 of 32
                       layers (top-2 of 16 experts, LayerNorm, GQA 32/8);
* ``audio_serve``    — whisper-medium uncut (24 encoder + 24 decoder
                       layers) served over zero frames (the Server's
                       stub): 4 prompts of 4 tokens, 64 new tokens each;
                       B7 non-causal at the encoder (1,500 x 1,500) and
                       cross-attention (4 and 1 rows over 1,500) shapes
                       against its plain version and the recurrence;
                       float32 at depth 2 over seeded random frames
                       against the plain versions;
* ``ssm_serve``      — xlstm-125m uncut (6 mLSTM/sLSTM pairs), 4 prompts of
                       2048 tokens, 32 new tokens each: kernel
                       ``slstm_scan`` (X1, the sLSTM recurrence in one
                       cooperative launch) exactly once a sLSTM layer,
                       prefill and decode step, held to its plain loop on
                       the first and last layer's operands of a prefill
                       and timed beside its bound and its serial bound
                       (S grid barriers); float32 at depth 2, prefill +
                       decode against forward and the card against the
                       CPU;
* ``hybrid_serve``   — zamba2-2.7b uncut (54 Mamba2 blocks in 9 groups,
                       each after the one shared attention block: 32
                       heads of dh 80) served as ``lm_serve`` serves
                       qwen: B7 exactly 9 x (4 prefills + 124 decode
                       steps) times, at dh 80 on its ``wgmma`` (prefill)
                       and split-KV (decode) routes, held to its plain
                       version and the recurrence and timed beside SDPA;
                       float32 at depth 12 (two groups) against the
                       plain versions; one full-width Mamba2 block on the
                       card against the CPU; kernel ``ssd_scan`` (M1, the
                       Mamba2 chunked scan) exactly 54 times a prefill,
                       held to its plain version on block 0's operands;
* ``long_500k``      — launch/specs.py's long_500k shape (524,288 rows of
                       cache, batch 1) for zamba2-2.7b and xlstm-125m,
                       uncut: a 524,288-token prompt (zamba2 by
                       ``prefill`` of 32,768 and 15 ``decode_step`` pieces
                       of 32,768: 48.3 GB of cache; xlstm by one
                       ``prefill``), 16 greedy decode steps through one
                       captured CUDA graph and eagerly (tokens equal,
                       logits bit-identical), launches exact (M1 54 and B7
                       9 a piece, X1 6 a call); M1 on the last block of
                       the last piece, X1 over the last 512 positions of
                       each sLSTM layer from the state the kernel carried,
                       B7 at the last piece (its last 64 query rows) and
                       at decode over 524,289 keys (host ints and a device
                       start), each against its plain version; M1 alone at
                       524,288 rows; prefill seconds, decode ms a token,
                       peak GB (under 80) and each kernel's ms beside its
                       bound printed;
* ``vlm_serve``      — paligemma-3b uncut (18 layers, 8 heads over 1 kv
                       head of dh 256) over the Server's 256 zero vision
                       rows: every prefill a 2,304-row prefix-LM
                       (``prefix_len`` 256), B7 exactly 18 x 128 times at
                       dh 256; float32 at depth 2 over random vision rows
                       against the plain versions;
* ``dense_configs_serve`` — the dense configurations no other phase
                       serves, one at a time at full width: chatglm3-6b
                       (28 layers; half-rotary RoPE, QKV bias, 32 heads
                       over 2: 16 folded rows a kv head at decode),
                       qwen1.5-32b (64 layers, MHA 40 over 40, 70.4 GB)
                       and mistral-large-123b (96 over 8, depth cut to 24
                       of 88 layers, ``reduced``), each through the
                       graphed Server over four prompts (one at B7's
                       split-KV limit, one a token past it, 700 and 500
                       tokens; 16 new each, batch 2) held to the eager
                       steps, B7 at both prefill routes and at decode
                       held to its plain version and timed, B7 reading
                       its start from the device over the decode cache,
                       float32 at depth 2 against the plain versions; and
                       chatglm3-6b over two prompts of 32,704 tokens, 64
                       new each (``decode_32k``'s length at batch 2,
                       ``reduced``), B7 held at that prefill and decode;
* ``lm_train``       — the train path: qwen2.5-14b at full width, depth
                       cut to 6 of 48 layers (``reduced``: AdamW's state
                       is 16 bytes a parameter, 51 GB at 6 layers),
                       ``launch.train.TrainLoop`` for 18 steps of 4 x 2048
                       ``TokenStream`` tokens (lr 3e-4, warmup 2, remat
                       ``"full"``, no checkpoint: ``examples`` checkpoints
                       and restores): the last three losses'
                       mean must fall 0.2 below the first three's and
                       below their lowest (the loss spikes after warmup
                       at this lr and width), the peak stay under 75 GB,
                       B7 launch twice a layer and
                       step (the forward and remat's recompute) and its
                       backward (``flash_attention_bwd``) once; one more
                       step profiled as forward, backward and optimizer;
                       float32 ``loss_fn`` gradients at depth 2 against the
                       plain versions; two steps from one state bit for
                       bit (the second under deterministic algorithms);
                       then, with qwen's state released, paligemma-3b at
                       full width and depth (18 layers, 1.90e9
                       parameters) through ``make_train_step``: 3 steps
                       of 2 x (256 seeded random vision + 2048
                       ``TokenStream`` text) rows, the first untimed, the
                       last profiled:
                       finite losses, B7 twice a layer and step and B7b
                       once on its dh-256 ``wgmma`` route, B7b's device ms
                       a step, the step's ms and the peak GB;
                       B7's forward (output and log-sum-exp) and backward
                       against their plain versions at qwen's, whisper's
                       (encoder and cross),
                       zamba2's and paligemma's (1 and 4 rows) shapes and
                       at dh 96 (bf16 and float32), timed beside SDPA's
                       backward;
* ``examples``       — the twins of the reference's examples
                       (``examples/port_*.py``) in process at the
                       reference's defaults, each failing the phase on
                       its own asserts and on a kernel of its path not
                       launched (or one outside it launched);
                       ``port_train_lm.py`` at 30 steps with a failure at
                       20 and a checkpoint every 10, plain (xlstm-125m:
                       its train steps on X1's plain route, no launch)
                       and ``--moe`` (B7, B7b and B2 as the router);
                       ``port_serve_lm.py`` (zamba2's smoke config) on B7
                       and M1.

For each phase it sets the kernels' launch counts to 0, runs the path,
reads the counts (a kernel of the path with no launch fails the run),
checks the results, then calls the kernel wrapper and its plain PyTorch
version on the operands of the path's first micro-batch and compares
them (bit-identical for the integer metrics and the interval match;
eucl: every candidate value within ``EUCL_RTOL``/``EUCL_ATOL``, and every
candidate and result index swap, or every range-match disagreement,
confirmed as a float64 near-tie), and times kernel, plain version and
one PyTorch library call with CUDA events (medians).  After each phase
it logs ``phase_memory`` (the GB allocated at its start, its peak, what
it leaves and the largest CUDA tensors left) and clears the engine's
plan cache, whose memos of prepared galleries would otherwise carry
into later phases (``release_phase_state``).  B1's record also
holds its two main-path shapes under ``shapes`` (``knn`` and
``hdc_predict``: route, event and device times, launches, the bound of
the route's basis and the earlier popcount basis).  The last two lines
of standard output are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": ...}``.

It exits non-zero, printing no result, when no CUDA device is present,
when ``src/repro_torch`` is not beside it, or when any phase fails.
Phase names as arguments run only those phases (the kernels line then
holds only the records they made):

    python3 chip_smoke.py [phase ...]
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

#: eucl tolerance on squared distances of magnitude 2e3..1e4: float32
#: sums of 1024 products in another order differ by ~0.05 at most here
EUCL_RTOL, EUCL_ATOL = 1e-5, 0.1
#: H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA cores,
#: TF32 and int8 on the tensor cores, HBM3
FP32_PEAK_FLOPS = 67e12
TF32_PEAK_FLOPS = 495e12
INT8_PEAK_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12
#: 32-bit population counts and compares per clock per SM, compute
#: capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
#: throughput table)
POPC_PER_CLOCK_PER_SM = 16
COMPARES_PER_CLOCK_PER_SM = 64
#: warp instructions issued per clock per SM (four schedulers, one each),
#: and threads per warp
ISSUE_PER_CLOCK_PER_SM, WARP = 4, 32
#: the forest_acam workload: random_forest(default_rng(7), **FOREST),
#: FOREST_QUERIES N(0, 1) queries from default_rng(8)
FOREST = dict(n_trees=512, depth=8, dim=64, n_classes=8, feature_frac=0.5)
FOREST_QUERIES = 1024
#: keyword arguments of knn_dataset() (its defaults: 180,000 x 1024)
KNN_DATA = {}
#: rows of each result checked against a plain oracle on the host
FOREST_CHECKED_ROWS = 256
#: distance_ops: eucl entries furthest from the plain version that are
#: replayed in the kernel's arithmetic (beside one query row's all)
REPLAY_FURTHEST = 4096
#: the hdc_mnist workload: hdc_mnist_dataset(**HDC_MNIST), classes, dims,
#: levels and retraining epochs (the paper's HDC/MNIST-8k).  At 28 x 28
#: the dataset's default class overlap (0.55) separates every class (a
#: one-shot test accuracy of 1.0, so retraining pushes no row); 0.8 puts
#: one-shot training mid-range, where retraining moves class rows
HDC_MNIST = dict(n_train=60000, n_test=10000, side=28, overlap=0.8)
HDC_CLASSES, HDC_DIM, HDC_LEVELS, HDC_EPOCHS = 10, 8192, 16, 3
#: test rows checked against the dense (M, F, H) oracle, and its chunk
HDC_DENSE_ROWS, HDC_DENSE_CHUNK = 256, 16
#: rows checked against the IR interpreter (one micro-batch)
HDC_INTERPRETED_ROWS = 1024
#: device memory the phase may add at its peak (2 GB of training
#: encodings plus temporaries)
HDC_PEAK_GB = 6.0
#: gallery_update: UPDATE_RUNS runs of UPDATE_RUN consecutive rows, drawn
#: from default_rng(UPDATE_SEED)
UPDATE_RUNS, UPDATE_RUN, UPDATE_SEED = 18, 100, 13
#: integer multiply-add class instructions per clock per SM (IMAD, and
#: IDP4A: four int8 products summed into an int32), compute capability 9.0
#: (CUDA C++ Programming Guide, arithmetic instruction throughput table)
IMAD_PER_CLOCK_PER_SM = 64
#: int8 products per IDP4A
DP4A_PRODUCTS = 4
#: 32-bit logical operations (LOP3) per clock per SM, compute capability
#: 9.0 (CUDA C++ Programming Guide: 32-bit bitwise AND, OR, XOR)
LOP_PER_CLOCK_PER_SM = 64
#: lm_serve: LM_ARCH (with LM_OVERRIDES, none on the card) served to
#: SERVE_REQUESTS prompts of SERVE_PROMPT tokens, SERVE_NEW new tokens
#: each, decode batch SERVE_BATCH; DECODE_TIMED_STEPS decode steps timed
#: one by one; the float32 prefill-then-decode check at depth CHECK_LAYERS
#: (CHECK_PREFILL prompt tokens, CHECK_DECODE steps); B7's decode against
#: DECODE_32K_ROWS cache rows (launch/specs.py decode_32k), and in float32
#: against at most F32_CUT_ROWS rows
LM_ARCH, LM_OVERRIDES = "qwen2.5-14b", {}
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2, 2048, 32
#: a graphed Server's second run: prompts of several lengths well below
#: its max_len (live kv tile counts 2 to 29 of the 33 a 2,081-row cache
#: holds), SERVE_MIXED_NEW tokens each, held to the eager steps
SERVE_MIXED_PROMPTS, SERVE_MIXED_NEW = (100, 460, 950, 1400, 1800), 16
DECODE_TIMED_STEPS = 16
CHECK_LAYERS, CHECK_PREFILL, CHECK_DECODE = 4, 512, 16
DECODE_32K_ROWS, F32_CUT_ROWS = 32768, 4096
#: B7 against its plain version: the reference's flash-test bounds
B7_BF16_ATOL, B7_F32_ATOL = 0.05, 2e-3
#: B7 in bf16 against the Pallas recurrence: the share of outputs more than
#: one bf16 step (2**-7 of |want|) away, and the largest miss in units of
#: max|v| (one bf16 step of a probability; tests/test_torch_cuda.py)
B7_REC_BEYOND, B7_REC_MAX_OF_V = 1e-3, 2.0 ** -8
#: H100 SXM bf16 tensor-core peak, dense (NVIDIA data sheet)
BF16_PEAK_FLOPS = 989e12
#: moe_serve: MOE_ARCH (with MOE_OVERRIDES, none on the card) served as
#: lm_serve serves its model, once with each router; its float32 check at
#: depth MOE_CHECK_LAYERS with capacity factor MOE_CHECK_CAPACITY (no
#: token drops); PHI_ARCH at its full width, depth cut by PHI_OVERRIDES,
#: PHI_REQUESTS prompts of SERVE_PROMPT tokens, PHI_NEW new tokens each
MOE_ARCH, MOE_OVERRIDES = "deepseek-moe-16b", {}
MOE_CHECK_LAYERS, MOE_CHECK_CAPACITY = 2, 64.0
PHI_ARCH, PHI_OVERRIDES = "phi3.5-moe-42b-a6.6b", dict(n_layers=4)
PHI_REQUESTS, PHI_NEW = 2, 16
#: B2's dot values (the router) against the float32 plain version, as a
#: share of sum |q_i p_i|: 3xTF32 truncates the accumulator toward zero at
#: each of its 3 D / 8 k-steps, which drifts all-positive sums of 4,096
#: products by up to 1.5e-5 of the sum (tests/test_torch_cuda.py on the
#: H100); two dot scores within it are a float64 near-tie
DOT_RTOL = 1e-4
#: audio_serve: AUDIO_ARCH (with AUDIO_OVERRIDES) served to
#: AUDIO_REQUESTS prompts of AUDIO_PROMPT tokens, AUDIO_NEW new tokens
#: each, over zero frames (the Server's stub); the float32 check at depth
#: AUDIO_CHECK_LAYERS (encoder and decoder), AUDIO_CHECK_BATCH rows of
#: seeded random frames, AUDIO_CHECK_DECODE decode steps
AUDIO_ARCH, AUDIO_OVERRIDES = "whisper-medium", {}
AUDIO_REQUESTS, AUDIO_PROMPT, AUDIO_NEW = 4, 4, 64
AUDIO_CHECK_LAYERS, AUDIO_CHECK_BATCH, AUDIO_CHECK_DECODE = 2, 2, 16
#: ssm_serve: SSM_ARCH (with SSM_OVERRIDES) served as lm_serve serves its
#: model; the float32 check at depth SSM_CHECK_LAYERS over SSM_CHECK_PREFILL
#: prompt tokens, within SSM_F32_ATOL (the chunked and the recurrent
#: mLSTM sum in other orders; the card's and the CPU's BLAS too)
SSM_ARCH, SSM_OVERRIDES = "xlstm-125m", {}
SSM_CHECK_LAYERS, SSM_CHECK_PREFILL, SSM_F32_ATOL = 2, 512, 2e-3
#: hybrid_serve: HYBRID_ARCH (with HYBRID_OVERRIDES) and vlm_serve:
#: VLM_ARCH (with VLM_OVERRIDES) served as lm_serve serves its model (the
#: vlm over the Server's zero vision rows); their float32 checks at depth
#: HYBRID_CHECK_LAYERS (two groups of six Mamba2 blocks) and
#: VLM_CHECK_LAYERS (random vision rows) against the plain versions; one
#: Mamba2 block at full width, float32, on the card against the CPU over
#: MAMBA_CHECK_ROWS prefill rows (a whole 256-row chunk and a padded one)
#: within MAMBA_F32_ATOL (the card's and the CPU's sums in other orders)
HYBRID_ARCH, HYBRID_OVERRIDES = "zamba2-2.7b", {}
HYBRID_CHECK_LAYERS = 12
MAMBA_CHECK_ROWS, MAMBA_F32_ATOL = 300, 2e-3
VLM_ARCH, VLM_OVERRIDES = "paligemma-3b", {}
VLM_CHECK_LAYERS = 2
#: M1 (the Mamba2 chunked scan) and X1 (the sLSTM recurrence): each held to
#: its plain version on the path's own operands.  M1's y within one step
#: of its dtype (2**-7 |y| in bf16: the float32 sums before the cast agree
#: to about 1e-6, so a rounding flips at most one bf16 step) plus
#: M1_OF_MAX of max|y|, its state likewise in float32; X1's hs within
#: X1_TOL (|h| <= 1; c and n relative to max(|n|, 1), m to max(|m|, 1)):
#: float32 sums of D products in other orders, carried through the
#: recurrence (1e-7 to 5e-7 at 256 to 16,384 positions,
#: tests/test_torch_cuda.py on an H100 80GB HBM3 at 700 W)
M1_OF_MAX, X1_TOL = 1e-5, 1e-4
#: ssm_serve holds X1's batched kernel at the served decode's shape: a
#: prefill of X1_BATCH_PROMPT tokens of SERVE_BATCH prompts, one eager
#: decode step and X1_REPLAYS replays of its captured graph
X1_BATCH_PROMPT, X1_REPLAYS = 64, 3
#: each scan kernel's source and the reference code it replaces (no TPU
#: kernel: the reference's lax.scan), and why no library call stands beside
#: them
SCAN_KERNELS = {
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/models/mamba2.py:151 (no TPU kernel: the "
                 "reference's lax.scan of chunk_body, :115)"),
    "slstm_scan": ("src/repro_torch/kernels/csrc/slstm_scan.cu",
                   "src/repro/models/xlstm.py:213 (no TPU kernel: the "
                   "reference's lax.scan of step, :197)")}
SCAN_LIBRARY = ("none: no PyTorch call computes an SSD scan, and cuDNN's "
                "LSTM is a different cell")
#: long_500k: launch/specs.py's long_500k shape (524,288 rows of cache,
#: batch 1, decode) for the two families it is emitted for, each uncut
#: (full width, depth and bf16): a LONG_PROMPT-token prompt from
#: default_rng(0), then LONG_NEW greedy decode steps through one captured
#: CUDA graph and eagerly.  zamba2-2.7b prefills its first LONG_PIECE
#: tokens with ``prefill`` and the rest in pieces of LONG_PIECE with
#: ``decode_step`` (the reference's S > 1 decode; one prefill would need
#: tens of GB of float32 temporaries a Mamba2 block beside the 48.3 GB
#: cache); xlstm-125m in one ``prefill``.  X1 held over the last
#: LONG_X1_ROWS positions of each sLSTM layer from the state the kernel
#: carried there; B7 at the last piece on its last LONG_B7_ROWS query rows
#: (the plain scores of 32,768 x 524,288 do not fit); the peak under
#: LONG_PEAK_GB
LONG_ARCHS = ("zamba2-2.7b", "xlstm-125m")
LONG_PROMPT, LONG_NEW, LONG_PIECE = 524_288, 16, 32_768
LONG_X1_ROWS, LONG_B7_ROWS, LONG_PEAK_GB = 512, 64, 80.0
#: dense_configs_serve: each of DENSE_ARCHS (with its overrides) served
#: through the graphed Server, one at a time: SERVE_BATCH slots, greedy,
#: DENSE_NEW new tokens for each of four prompts: one at B7's split-KV
#: limit (FLASH_SPLITKV_ROWS rows a kv head over the GQA group: its
#: prefill takes split-KV with causal rows), one a token past it (the
#: wgmma kernel) and two of DENSE_PROMPT tokens (the second replays the
#: first's captured graph, so the graphed prefill is timed at that
#: length); the float32 check at depth
#: DENSE_CHECK_LAYERS over CHECK_PREFILL + CHECK_DECODE tokens.
#: mistral-large-123b's depth is cut (reduced: 88 layers are 244 GB in
#: bf16, 24 are 68 GB); the others are whole.  DENSE_LONG_ARCH also
#: serves DENSE_LONG_REQUESTS prompts of DENSE_LONG_PROMPT tokens,
#: DENSE_LONG_NEW new tokens each: launch/specs.py decode_32k's 32,768
#: rows, its batch cut from 128 to 2 (reduced: 128 slots of chatglm3-6b's
#: cache are 120 GB)
DENSE_ARCHS = {"chatglm3-6b": {}, "qwen1.5-32b": {},
               "mistral-large-123b": dict(n_layers=24)}
DENSE_PROMPT, DENSE_NEW, DENSE_CHECK_LAYERS = 700, 16, 2
DENSE_LONG_ARCH = "chatglm3-6b"
DENSE_LONG_REQUESTS, DENSE_LONG_PROMPT, DENSE_LONG_NEW = 2, 32704, 64
#: examples: the twins of the reference's examples (examples/port_*.py)
#: run in process at the reference's defaults, each with the kernels it
#: must launch; each kernel's first call in the run (B7's first prefill
#: and first decode) is kept and held to its plain version after it
#: (``example_checks``), and each twin checks its own results.
#: port_train_lm at EXAMPLE_TRAIN_ARGS, the CPU test's cut: 14 steps
#: (xlstm-125m's eager sLSTM loop takes about 6 s a step), the failure at
#: 8, a checkpoint every 4 (with the reference's 50 no checkpoint precedes
#: the failure, and the restore finds none)
EXAMPLE_TRAIN_ARGS = ["--steps", "14", "--fail-at", "8", "--ckpt-every",
                      "4"]
EXAMPLES = (("dse_sweep", [], ()),
            ("forest_inference", [], ("acam_match",)),
            ("hdc_mnist", [], ("hdc_encode", "fused_topk_packed")),
            ("moe_router_offload", [], ("fused_topk",)),
            ("serve_lm", [], ("flash_attention", "ssd_scan")),
            ("tcam_wildcard", [], ("fused_topk_packed_ternary",)),
            ("train_lm", EXAMPLE_TRAIN_ARGS, ()),
            ("train_lm", ["--moe"] + EXAMPLE_TRAIN_ARGS,
             ("flash_attention", "flash_attention_bwd", "fused_topk")))
#: each kernel a twin launches: its source under kernels/csrc/ and the
#: reference kernel it replaces under src/repro/kernels/ (the scans': the
#: reference code they replace, SCAN_KERNELS)
EXAMPLE_KERNELS = {
    name: (f"src/repro_torch/kernels/csrc/{src}", f"src/repro/kernels/{ref}")
    for name, (src, ref) in {
        "acam_match": ("acam_match.cu", "acam.py:121"),
        "hdc_encode": ("hdc_encode.cu", "hdc_encode.py:87"),
        "fused_topk_packed": ("fused_topk_packed.cu", "cam_search.py:304"),
        "fused_topk_packed_ternary": ("fused_topk_packed.cu",
                                      "cam_search.py:304"),
        "fused_topk": ("fused_topk.cu", "cam_search.py:200"),
        "flash_attention": ("flash_attention.cu", "flash_attention.py:124"),
        "flash_attention_bwd": ("flash_attention_bwd.cu",
                                "flash_attention.py:124 (its backward: the "
                                "reference differentiates "
                                "src/repro/models/layers.py:167)")}.items()}
EXAMPLE_KERNELS.update(SCAN_KERNELS)
#: lm_train: TRAIN_ARCH at its full width, depth cut by TRAIN_OVERRIDES
#: (AdamW's float32 master and moments, the bf16 parameters and their
#: gradients are about 16 bytes a parameter: 51 GB at 6 of 48 layers),
#: trained by ``launch.train.TrainLoop`` for TRAIN_STEPS steps of
#: TRAIN_BATCH x TRAIN_SEQ tokens (lr TRAIN_LR, TRAIN_WARMUP warmup steps,
#: a checkpoint every TRAIN_CKPT_EVERY, one kept on disk: past the last
#: step, so none is written; the 45 GB checkpoints, two and then one,
#: were cut to keep the smoke within its time limit beside the graphed
#: serve phases, the dense configurations and the examples, whose
#: port_train_lm run checkpoints and restores); the mean loss
#: of the last three steps must sit TRAIN_LOSS_DROP below the first
#: three's (tests/test_integration.py) and below the lowest of them, and
#: the peak under TRAIN_PEAK_GB; float32 gradients at depth
#: GRAD_CHECK_LAYERS over GRAD_CHECK_TOKENS tokens against the plain
#: versions (the loss within GRAD_LOSS_ATOL, each leaf's |g - g_plain|
#: within GRAD_RTOL of its |g_plain|); two steps at depth DET_LAYERS from
#: one state bit for bit
TRAIN_ARCH, TRAIN_OVERRIDES = "qwen2.5-14b", dict(n_layers=6)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 18
TRAIN_LR, TRAIN_WARMUP, TRAIN_CKPT_EVERY = 3e-4, 2, TRAIN_STEPS + 1
TRAIN_LOSS_DROP, TRAIN_PEAK_GB = 0.2, 75.0
GRAD_CHECK_LAYERS, GRAD_CHECK_TOKENS = 2, 512
GRAD_LOSS_ATOL, GRAD_RTOL = 1e-5, 1e-4
DET_LAYERS = 2
#: B7's backward against its plain version, as a share of the plain
#: gradient's largest magnitude (bf16 operands and outputs; float32), and
#: the forward's log-sum-exp against the plain one (float32 scores of
#: bf16 or float32 products, summed in other orders)
B7B_BF16_OF_MAX, B7B_F32_OF_MAX, B7_LSE_ATOL = 2e-2, 2e-4, 1e-3
#: B7's backward alone: (B, S, T, H, KV, dh) and masks of the families'
#: attention: qwen2.5-14b's prefill, whisper-medium's encoder and
#: cross-attention, zamba2-2.7b's shared block, paligemma-3b's prefix-LM
#: prefill, a head dim the kernels reach by padding (96 -> 128),
#: qwen2.5-14b and paligemma-3b at a train step's batch of 4, and
#: qwen2.5-14b at lm_sharded's batch of SHARD_BATCH (2)
B7B_SHAPES = {
    "qwen_causal": ((1, 2048, 2048, 40, 8, 128), dict(causal=True)),
    "qwen_train": ((4, 2048, 2048, 40, 8, 128), dict(causal=True)),
    "whisper_encoder": ((1, 1500, 1500, 16, 16, 64), dict(causal=False)),
    "whisper_cross": ((1, 4, 1500, 16, 16, 64), dict(causal=False)),
    "zamba2_causal": ((1, 2048, 2048, 32, 32, 80), dict(causal=True)),
    "paligemma_prefix": ((1, 2304, 2304, 8, 1, 256),
                         dict(causal=True, prefix_len=256)),
    "c4_dh96": ((1, 1024, 1024, 16, 4, 96), dict(causal=True)),
    "paligemma_train": ((4, 2304, 2304, 8, 1, 256),
                        dict(causal=True, prefix_len=256)),
    "qwen_sharded": ((2, 2048, 2048, 40, 8, 128), dict(causal=True)),
}
#: lm_train's paligemma-3b train step at full width and depth: batch rows
#: of the model's 256 vision rows (seeded normal: zero rows stay zero
#: through every layer, and RMSNorm's gradient at a zero row is
#: 1 / sqrt(1e-6), so the backward overflows within a few layers) and
#: VLM_TRAIN_SEQ text tokens, VLM_TRAIN_STEPS steps (the first untimed,
#: the last profiled)
VLM_TRAIN_BATCH, VLM_TRAIN_SEQ, VLM_TRAIN_STEPS = 2, 2048, 3
#: lm_sharded (a): qwen2.5-14b at full width, depth SHARD_LAYERS
#: (reduced), SHARD_STEPS checked steps (and two timed ones) of
#: SHARD_BATCH x SHARD_SEQ TokenStream tokens through make_train_step,
#: unsharded and then with ShardingRules
#: over a (data 1, model 1) DeviceMesh of one NCCL rank (the DTensor
#: path); each sharded step's loss within SHARD_LOSS_RTOL (relative) of
#: the unsharded step's, each gradient leaf within SHARD_GRAD_OF_MAX of
#: the unsharded leaf's largest magnitude (B7b's bf16 rule)
SHARD_ARCH, SHARD_LAYERS = "qwen2.5-14b", 2
SHARD_BATCH, SHARD_SEQ, SHARD_STEPS = 2, 2048, 3
SHARD_LOSS_RTOL, SHARD_GRAD_OF_MAX = 1e-3, 2e-2
#: cam_serve: CAM_CLIENTS client threads, each submitting CAM_REQUESTS
#: requests of CAM_ROWS consecutive query rows one after another
#: (8 x 6 x 13 = the 624 KNN queries); the faulted packed server's model;
#: the hardened search's replicas, fault seeds and probabilities, and the
#: gallery rows it stores: cut from 180,000 to a quarter, because each
#: faulted execute corrupts every stored cell on the host (553 M at full
#: size: 12-14 s a seed on the H100's host, 80 s for the part, against a
#: 30 s budget); the forest update's share
#: of rows and its racing clients (CAM_RACE_ROWS queries each); the
#: healed interval plan's replicas,
#: spares and model; the bound of every wait
CAM_CLIENTS, CAM_REQUESTS, CAM_ROWS = 8, 6, 13
CAM_SERVE_FAULTS = dict(seed=3, p_stuck=1e-3, p_flip=1e-3)
CAM_HARDEN_REPLICAS, CAM_HARDEN_SEEDS = 3, range(4)
CAM_HARDEN_FAULTS = dict(p_stuck=0.02, p_flip=0.01)
CAM_HARDEN_ROWS = 45000
CAM_UPDATE_FRAC, CAM_RACERS, CAM_RACE_ROWS = 0.01, 4, 64
CAM_HEAL_REPLICAS, CAM_HEAL_SPARES = 2, 512
CAM_HEAL_FAULTS = dict(seed=11, p_stuck=1e-5)
CAM_WAIT_S = 600
#: the hier_search phase, (a): benchmarks/bench_hier.py's geometry
#: (_clustered_gallery(default_rng(0), 131072, 256, 128), 64 perturbed
#: gallery rows as queries, ArchSpec(rows=128, cols=128), packed hamming)
HIER_N, HIER_DIM, HIER_CENTERS, HIER_FLIP = 131072, 256, 128, 0.05
HIER_QUERIES, HIER_K, HIER_CLUSTERS, HIER_ITERS = 64, 10, 128, 4
HIER_NPROBES = (4, 8, 16)
HIER_TIMED_CALLS = 5
#: (a)'s row update: 1 % of the rows with reassignment, then rows copied
#: from one row, enough to overflow its cluster's tiles
HIER_UPDATE_FRAC, HIER_OVERFLOW_ROWS = 0.01, 8192
#: (c): the nprobe-8 plan served, 8 client threads x 2 requests x 4 rows
#: = (a)'s 64 queries
HIER_SERVE_NPROBE, HIER_SERVE_REQUESTS, HIER_SERVE_ROWS = 8, 2, 4
#: (b): a call past this many seconds on the KNN data is timed again on
#: the first HIER_EUCL_CUT_ROWS queries (the cut listed under "reduced")
HIER_EUCL_LIMIT_S, HIER_EUCL_CUT_ROWS = 30.0, 64
#: queue_c: C1's top-k on the default backend past the kernels' window
#: (MAX_K = 384): eucl and packed hamming at the KNN shape; C3's B5 cases
#: through ItemMemory.encode, (rows, features, dims, levels, route): a
#: 256 x 256 image (65,536 features, the 32 count planes), 512 levels
#: (the level planes from global memory), 2,100,000 rows (past one grid
#: dimension's 65,535 blocks of 32 rows: 2.15 GB of output) and
#: HDC/MNIST-8k's test set, which keeps the bit-sliced route
QUEUE_C_EUCL_K, QUEUE_C_PACKED_K = 500, 400
#: the served micro-batch (a gateway request's rows) on the matrix route
QUEUE_C_SMALL_ROWS = 13
QUEUE_C_HDC = {"wide_features": (256, 65536, 8192, 16, "wide"),
               "many_levels": (2000, 784, 8192, 512, "global"),
               "many_rows": (2_100_000, 16, 256, 16, "bitsliced"),
               "mnist_shape": (10000, 784, 8192, 16, "bitsliced")}
#: sharded: shards on cuda:0 stand-ins (launch.mesh.forced_devices)
SHARDS = 4
#: gateway_serve: client threads per tenant, requests per client and rows
#: per request (4 x 12 x 13 = the 624 KNN queries); hamming_gold's token
#: bucket (rows a second, burst) and priority; the isolation victim's
#: requests; failover requests per client and the kill's delay; the
#: maintenance sweep; a rejected submit's back-off
GW_CLIENTS, GW_REQUESTS, GW_ROWS = 4, 12, 13
GW_GOLD_RATE, GW_GOLD_BURST, GW_GOLD_PRIORITY = 2000.0, 104, 5
GW_VICTIM_REPS = 60
GW_FAILOVER_REPS, GW_KILL_AFTER_S = 30, 0.05
GW_MAINT_MS, GW_BACKOFF_S = 10.0, 0.002


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def host_ms_per_call(fn, n: int) -> float:
    """Mean host time of ``fn`` over ``n`` calls enqueued back to back
    (no synchronise between them): what a call costs the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * took / n


def device_ms_per_call(fn, n: int) -> float:
    """Device time of one call of ``fn``: ``torch.profiler`` over ``n``
    calls, the device time of every kernel they launched over ``n`` (the
    wrapper's host work, which CUDA events around one call include, is
    left out)."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in device_rows(prof)) / n


def device_rows(prof):
    """(device ms, name, count) of each device-side event of a
    ``torch.profiler`` run (kernels, copies, sets) that took time."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.key, e.count))
    return rows


def eucl_index_swaps(q, p, got_i, want_i, what: str) -> int:
    """Count the positions where two eucl top-k index tensors differ,
    after confirming each as a float64 near-tie: the squared distances
    of query row ``r`` to both chosen gallery rows agree within
    ``EUCL_ATOL + EUCL_RTOL * |d|``.  Raises on any other swap."""
    rows, cols = (got_i != want_i).nonzero(as_tuple=True)
    for s in range(0, rows.numel(), 1 << 14):
        r, c = rows[s:s + (1 << 14)], cols[s:s + (1 << 14)]
        qr = q[r].double()
        da = ((qr - p[got_i[r, c].long()].double()) ** 2).sum(1)
        db = ((qr - p[want_i[r, c].long()].double()) ** 2).sum(1)
        bad = ((da - db).abs() > EUCL_ATOL + EUCL_RTOL * db.abs()).nonzero()
        if bad.numel():
            j = int(bad[0, 0])
            raise RuntimeError(
                f"{what}: index swap at ({int(r[j])}, {int(c[j])}) is not a "
                f"float64 near-tie: {float(da[j])} vs {float(db[j])}")
    return int(rows.numel())


def hamming_module(T, cd, m, n, dim, k, care):
    """cim program for hamming (optionally TCAM ternary) top-k: the
    traced front end has no hamming pattern, so it enters the pipeline
    at compile_module, the function compile_fn calls after tracing."""
    types = [T.TensorType((m, dim)), T.TensorType((n, dim))]
    if care:
        types.append(T.TensorType((n, dim), "i8"))
    mod = T.Module("hamming_search", types)
    a = mod.arguments
    b = T.Builder(mod.body)
    dev = cd.make_acquire(b)
    exe = cd.make_execute(b, dev.result, list(a),
                          [T.TensorType((m, k)), T.TensorType((m, k), "i32")])
    blk = exe.region().block()
    sim = cd.make_similarity(blk, a[0], a[1], metric="hamming", k=k,
                             largest=False, care=a[2] if care else None,
                             extra_attrs={"value_bits": 1})
    cd.make_yield(blk, sim.results)
    cd.make_release(b, dev.result)
    b.ret(exe.results)
    return mod


def knn_kernel(q, gallery):                      # benchmarks/table2_knn.py
    diff = q.unsqueeze(1).sub(gallery)
    d = diff.norm(p=2, dim=-1)
    return d.topk(5, largest=False)


def hdc_similarity(queries, class_hvs):          # examples/quickstart.py
    others = class_hvs.transpose(-2, -1)
    scores = queries.matmul(others)
    values, indices = scores.topk(1, largest=True)
    return values, indices


class Smoke:
    def __init__(self, torch, props, max_clock_mhz: float):
        self.torch = torch
        self.props = props
        self.popc_per_s = (POPC_PER_CLOCK_PER_SM * props.multi_processor_count
                           * max_clock_mhz * 1e6)
        self.compare_per_s = (COMPARES_PER_CLOCK_PER_SM
                              * props.multi_processor_count
                              * max_clock_mhz * 1e6)
        self.imad_per_s = (IMAD_PER_CLOCK_PER_SM * props.multi_processor_count
                           * max_clock_mhz * 1e6)
        self.lop_per_s = (LOP_PER_CLOCK_PER_SM * props.multi_processor_count
                          * max_clock_mhz * 1e6)
        self.lane_slots_per_s = (ISSUE_PER_CLOCK_PER_SM * WARP
                                 * props.multi_processor_count
                                 * max_clock_mhz * 1e6)
        self.kernels = {}        # name -> record for the final line
        self.failed = []
        self.topk = {}           # phase -> (values, indices) of its result
        self.phase_peak = 0      # bytes: the phase's peak before its resets

    def reset_peak(self):
        """Start a new peak-memory reading inside a phase (a model's own
        peak); the phase's peak keeps the larger of the readings."""
        torch = self.torch
        self.phase_peak = max(self.phase_peak,
                              torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    # -- the main path, counted ---------------------------------------------

    def drive(self, name, prog, inputs, expect):
        """Run the compiled program with the launch counts at 0; return
        its result and the counts it left.  Fails if a kernel of the
        path was not launched."""
        from repro_torch.kernels import cam_search
        torch = self.torch
        cam_search.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prog(*inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = dict(cam_search.LAUNCHES)
        out2 = prog(*inputs)                 # the gallery memo now hits
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if counts[expect] < 1:
            raise RuntimeError(f"{name}: kernel {expect} was not launched "
                               f"on the main path: {counts}")
        pairs = zip(out, out2) if isinstance(out, tuple) else [(out, out2)]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise RuntimeError(f"{name}: a repeated call changed the result")
        return out, counts, t1 - t0, t2 - t1

    def only(self, name, counts, expect, launches):
        """Fail unless the path launched ``expect`` exactly ``launches``
        times and no other kernel at all."""
        self.exactly(name, counts, {expect: launches})

    def exactly(self, name, counts, launches):
        """Fail unless the path launched each kernel of ``launches`` (a
        name -> count dict) that many times and no other kernel at all."""
        want = {k: launches.get(k, 0) for k in counts}
        if counts != want:
            raise RuntimeError(f"{name}: launches {counts}, expected {want}")

    def profile(self, prog, inputs, top: int = 6, classify=None):
        """Where one warm call's time goes: ``torch.profiler`` over a
        call that ends in a synchronise; device time by kernel (and by
        ``classify(kernel name)`` where given), and the share of the wall
        window in which the device ran nothing."""
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            prog(*inputs)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        try:
            rows = device_rows(prof)
        except (AttributeError, RuntimeError) as e:  # the profiler's API only
            return {"not_measured": repr(e)}
        rows.sort(reverse=True)
        device_ms = sum(r[0] for r in rows)
        # negative when the summed device time exceeds the wall window
        out = {"wall_ms": wall_ms, "device_ms": device_ms,
               "device_idle_share": 1 - device_ms / wall_ms,
               "device_ops": sum(r[2] for r in rows),
               "top": [{"ms": ms, "op": key[:80], "count": n}
                       for ms, key, n in rows[:top]]}
        if classify is not None:
            split = {}
            for ms, key, _ in rows:
                c = classify(key)
                split[c] = split.get(c, 0.0) + ms
            out["by_class_ms"] = split
            # the host side: operators by their own CPU time
            host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                           for e in prof.key_averages()
                           if e.self_cpu_time_total > 0), reverse=True)
            out["host_ms"] = sum(h[0] for h in host)
            out["host_top"] = [{"ms": ms, "op": key[:60], "count": n}
                               for ms, key, n in host[:top]]
        return out

    def kernel_operands(self, prog, inputs):
        """The (args, kwargs) the path's first micro-batch hands its
        kernel wrapper, rebuilt from the plan's own prepared gallery (a
        ragged micro-batch at its own row count, as the engine runs it)."""
        from repro_torch.core.engine.executables import _cuda_operands
        plan = prog.engine_plan
        spec = plan.spec
        chunk = inputs[spec.query_arg][:plan.batch]
        srcs = plan._stored_sources(inputs)
        return _cuda_operands(spec, plan.packed, chunk,
                              plan._prepared_patterns(*srcs))

    def record(self, name, source, replaces, launches, err, ms, plain_ms,
               bound_ms, bound_by, library_ms):
        rec = self.kernels.setdefault(name, {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": None, "plain_ms": None, "bound_ms": None,
            "bound_by": bound_by, "library_ms": None})
        rec["launches"] += launches
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if ms is not None:       # the KNN-scale phase times the kernel
            rec.update(ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=library_ms)

    # -- bounds ---------------------------------------------------------------

    def float_bound_ms(self, q, p, out_cols, route="wgmma"):
        """B2 on ``route``: ``"wgmma"``, three products of 2 M N D FLOP at
        the TF32 tensor-core peak (3xTF32); ``"fma"``, one at the float32
        CUDA-core peak (the earlier basis).  The norms are 2 (M + N) D
        FLOP on the CUDA cores.  Against the bytes of its operands and its
        candidates."""
        m, d = q.shape
        n = p.shape[0]
        bytes_ = 4.0 * (m * d + n * d) + 8.0 * m * out_cols
        if route == "wgmma":
            t_ops = 3 * 2.0 * m * n * d / TF32_PEAK_FLOPS
        else:
            t_ops = (2.0 * m * n * d + 2.0 * (m + n) * d) / FP32_PEAK_FLOPS
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def range_bound_ms(self, q, p, fp32_cuda_cores=False):
        """B4: the product of its route, 3xTF32 on the tensor cores (three
        products of 2 M N D FLOP at the TF32 peak; with
        ``fp32_cuda_cores``, the earlier route's basis: one at the float32
        CUDA-core peak), against the bytes of its operands and its (M, N)
        bool output."""
        m, d = q.shape
        n = p.shape[0]
        bytes_ = 4.0 * (m * d + n * d) + 1.0 * m * n
        t_ops = 2.0 * m * n * d / FP32_PEAK_FLOPS if fp32_cuda_cores \
            else 3 * 2.0 * m * n * d / TF32_PEAK_FLOPS
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def acam_bound_ms(self, q, lo, basis="issue"):
        """B3 on ``basis``: ``"issue"``, its route's issue slots per
        (query, row, dim) cell as the kernel's loop counts them
        (``acam_issue_slots``) at four warp instructions per clock per SM;
        ``"compares"``, the earlier kernel's basis (two compares per cell
        at the compare rate).  Against the bytes of q, lo, hi and the
        (M, N) bool output."""
        m, d = q.shape
        n = lo.shape[0]
        cells = float(m) * n * d
        if basis == "issue":
            t_ops = cells * acam_issue_slots() / self.lane_slots_per_s
        else:
            t_ops = 2.0 * cells / self.compare_per_s
        bytes_ = 4.0 * (m * d + 2 * n * d) + 1.0 * m * n
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def distance_bound_ms(self, q, p, fp32_cuda_cores=False):
        """B6: the product of its route, 3xTF32 on the tensor cores (three
        products of 2 M N D FLOP at the TF32 peak; with
        ``fp32_cuda_cores``, the earlier route's basis: one at the float32
        CUDA-core peak, with the norms), against the bytes of its operands
        and its (M, N) float32 output."""
        m, d = q.shape
        n = p.shape[0]
        if fp32_cuda_cores:
            t_ops = (2.0 * m * n * d + 2.0 * (m + n) * d) / FP32_PEAK_FLOPS
        else:
            t_ops = 3 * 2.0 * m * n * d / TF32_PEAK_FLOPS
        bytes_ = 4.0 * (m * d + n * d) + 4.0 * m * n
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def distance_topk_bound_ms(self, q, p, k):
        """B6's top-k route (``k > MAX_K``): the product on the tensor
        cores as 3xTF32 (three products of 2 M N D FLOP at the TF32
        peak), against the bytes of its operands and its (M, k) values
        and indices; the (M, N) matrix between the two steps is not part
        of the function's input or output."""
        m, d = q.shape
        n = p.shape[0]
        t_ops = 3 * 2.0 * m * n * d / TF32_PEAK_FLOPS
        bytes_ = 4.0 * (m * d + n * d) + 8.0 * m * k
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def select_bound_ms(self, m, n_valid, k):
        """K1s: the n_valid live columns of the (M, N) float32 matrix read
        once and the (M, k) values and indices written, at the HBM rate
        (it does no arithmetic beyond a few integer operations a key)."""
        bytes_ = 4.0 * m * n_valid + 8.0 * m * k
        return 1e3 * bytes_ / HBM_BYTES_PER_S, "bytes"

    def packed_distance_bound_ms(self, q, p, care):
        """K1p: one int8 product of 2 M N 32L operations at the int8
        tensor-core peak, against the bytes of its lanes and its (M, N)
        float32 output."""
        m, lanes = q.shape
        n = p.shape[0]
        t_ops = 2.0 * m * n * 32 * lanes / INT8_PEAK_OPS
        bytes_ = 4.0 * (m * lanes + n * lanes * (2 if care is not None
                                                 else 1)) + 4.0 * m * n
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def hdc_bound_ms(self, q, planes, basis="bitsliced"):
        """B5 on ``basis``: ``"bitsliced"``, its route's logical operations
        per (query, feature, 32-dim word) as the kernel's loop counts them
        (``hdc_logical_ops``) with the fewest count planes the features
        need (``hdc_count_bits``) at the LOP3 rate; ``"idp4a"``, the earlier
        gather form's basis (one int8 product per (query, feature, dim),
        four to an IDP4A at the integer multiply-add rate).  Against the
        bytes of the int32 ids, the bit planes and the float32 output."""
        from repro_torch.kernels.packing import lanes
        m, f = q.shape
        h = planes.dim
        if basis == "bitsliced":
            steps = float(m) * (-(-f // 16) * 16) * lanes(h)
            t_ops = steps * hdc_logical_ops(hdc_count_bits(f),
                                            planes.has_zero) / self.lop_per_s
        else:
            t_ops = float(m) * f * h / DP4A_PRODUCTS / self.imad_per_s
        bytes_ = (4.0 * m * f + 4.0 * planes.key_planes.numel()
                  + 4.0 * planes.level_planes.numel() + 4.0 * m * h)
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def packed_bound_ms(self, q, p, care, out_cols, n_valid, basis):
        """B1's bound on ``basis``: ``"int8"``, its "mma" route (one int8
        product of 2 M N 32L operations, binary or ternary, at the int8
        tensor-core peak); ``"popc_live"``, its "rows" route (one popc
        per (query, row, lane) of the rows below ``n_valid``, the only
        rows it computes and reads); ``"popc"``, the earlier kernel's basis
        (every row).  Against the bytes of the operands it reads and its
        candidates."""
        m, lanes = q.shape
        n = p.shape[0]
        rows = min(n, n_valid) if basis == "popc_live" else n
        bytes_ = 4.0 * (m * lanes + rows * lanes * (2 if care is not None
                                                     else 1)) \
            + 8.0 * m * out_cols
        if basis == "int8":
            t_ops = 2.0 * m * n * 32 * lanes / INT8_PEAK_OPS
        else:
            t_ops = float(m) * rows * lanes / self.popc_per_s
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def packed_shape(self, args, kw, launches):
        """B1 at one main-path shape: its route, time, bound on the
        route's basis and on the earlier popcount basis, plain and library
        times."""
        from repro_torch.kernels import cam_search
        torch = self.torch
        qp, pp, cp = args
        k, n_valid = kw["k"], kw["n_valid"]
        route = cam_search.packed_route(qp.shape[0], pp.shape[0], k,
                                        self.props.multi_processor_count)
        cols = (pp.shape[0] // cam_search.window_rows(k)) * k
        bound, by = self.packed_bound_ms(
            qp, pp, cp, cols, n_valid,
            "int8" if route == "mma" else "popc_live")
        old, old_by = self.packed_bound_ms(qp, pp, cp, cols, n_valid, "popc")
        call = lambda: cam_search.fused_topk_packed(*args, **kw)  # noqa: E731
        ms = cuda_ms(call, 20)
        return {"route": route, "ms": ms, "launches": launches,
                "device_ms": device_ms_per_call(call, 20),
                "host_ms": host_ms_per_call(call, 20),
                "bound_ms": bound, "bound_by": by,
                "basis": "int8 tensor cores, 1,979 TOPS" if route == "mma"
                else "popc of the rows below n_valid",
                "bound_ms_popc_all_rows": old, "bound_by_popc_all_rows":
                old_by,
                "shape": {"q": list(qp.shape), "p": list(pp.shape), "k": k,
                          "n_valid": n_valid,
                          "largest": bool(kw["largest"])}}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_knn_eucl(s: Smoke, data):
    import torch
    from repro_torch.core import ArchSpec, compile_fn
    from repro_torch.kernels import cam_search, ops
    g, g_labels, q, q_labels = data
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    prog = compile_fn(knn_kernel, [q, g], ArchSpec(rows=64, cols=64),
                      value_bits=8)
    (v, i), counts, first_s, second_s = s.drive("knn_eucl", prog, [qt, gt],
                                                "fused_topk")
    prof = s.profile(prog, [qt, gt])
    if v.shape != (q.shape[0], 5) or i.dtype != torch.int32 or \
            not bool(torch.isfinite(v).all()):
        raise RuntimeError(f"knn_eucl: bad result {v.shape} {i.dtype}")
    s.topk["knn_eucl"] = (v, i)

    args, kw = s.kernel_operands(prog, [qt, gt])
    qp, pp = args
    got = cam_search.fused_topk(*args, **kw)
    want = cam_search.fused_topk_reference(*args, **kw)
    torch.cuda.synchronize()
    # every candidate of every window, not only those the merge keeps
    off = (got[0] - want[0]).abs()
    if not bool((off <= EUCL_ATOL + EUCL_RTOL * want[0].abs()).all()):
        raise RuntimeError(f"knn_eucl: candidates off the plain version by "
                           f"{float(off.max())}")
    err = float(off.max())
    cand_swaps = eucl_index_swaps(qp, pp, got[1], want[1],
                                  "knn_eucl candidates")
    # end to end: the plain version's candidates through the same merge
    pv, pi = ops._merge(want[0], want[1], kw["k"], kw["largest"])
    pv, pi = pv[:q.shape[0]], pi[:q.shape[0]]
    tol = EUCL_ATOL + EUCL_RTOL * pv.abs()
    if not bool(((v - pv).abs() <= tol).all()):
        raise RuntimeError(f"knn_eucl: values off the plain version by "
                           f"{float((v - pv).abs().max())}")
    swaps = eucl_index_swaps(qp, pp, i, pi, "knn_eucl result")
    # ... and each of them is what the kernel's own arithmetic gives
    _, cand_exact = b2_order_reproduced(qp, pp, got[0], got[1], want[1],
                                        kw["k"], kw["largest"],
                                        "knn_eucl candidates")
    b2_order_reproduced(qp, pp, v, i, pi, kw["k"], kw["largest"],
                        "knn_eucl result")
    gl = torch.from_numpy(g_labels).cuda().long()
    votes = gl[i.long()].sum(1)                  # two classes: 0 / 1
    acc5 = float(((votes >= 3).long().cpu().numpy() == q_labels).mean())

    route = cam_search.float_route(kw["k"])
    out_cols = got[0].shape[1]
    batch = prog.engine_plan.batch
    shapes = {}
    # the rows the path gives the kernel, and the padded micro-batch that
    # earlier runs gave it (the same queries, zero rows after them)
    for name, qx in (("path", qp), (f"padded_{batch}",
                                    torch.nn.functional.pad(
                                        qp, (0, 0, 0, batch - qp.shape[0])))):
        bound, by = s.float_bound_ms(qx, pp, out_cols)
        fma_bound, _ = s.float_bound_ms(qx, pp, out_cols, "fma")
        shapes[name] = {
            "rows": qx.shape[0],
            "ms": cuda_ms(lambda qx=qx: cam_search.fused_topk(qx, pp, **kw),
                          10),
            "bound_ms": bound, "bound_by": by,
            "bound_ms_fp32_cuda_cores": fma_bound,
            "library_ms": cuda_ms(lambda qx=qx: torch.cdist(qx, pp).topk(
                5, largest=False), 5)}
    path = shapes["path"]
    ms, bound, by = path["ms"], path["bound_ms"], path["bound_by"]
    library_ms = path["library_ms"]
    plain_ms = cuda_ms(lambda: cam_search.fused_topk_reference(*args, **kw),
                       5)
    s.record("fused_topk", "src/repro_torch/kernels/csrc/fused_topk.cu",
             "src/repro/kernels/cam_search.py:200", counts["fused_topk"], err,
             ms, plain_ms, bound, by, library_ms)
    rec = s.kernels["fused_topk"]
    rec["kernel_route"] = route
    rec["bound_basis"] = "3xTF32 tensor cores, 495 TFLOP/s"
    rec["bound_ms_fp32_cuda_cores"] = path["bound_ms_fp32_cuda_cores"]
    rec["shapes"] = shapes
    log({"phase": "knn_eucl", "ok": True, "launches": counts,
         "first_call_s": first_s, "second_call_s": second_s,
         "kernel_shape": {"q": list(qp.shape), "p": list(pp.shape),
                          "k": kw["k"]}, "kernel_route": route,
         "candidate_max_abs_err": err,
         "candidate_index_swaps_float64_near_ties": cand_swaps,
         "result_index_swaps_float64_near_ties": swaps,
         "index_swaps_reproduced_in_kernel_order": True,
         "swapped_candidates_equal_to_replay": cand_exact,
         "shapes": shapes,
         "knn5_label_accuracy": acc5,
         "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": bound, "bound_by": by, "profile": prof})


def _packed_phase(s: Smoke, name, data, care):
    import numpy as np
    import torch
    from repro_torch.core import ArchSpec, compile_module
    from repro_torch.core import cim_dialect as cd
    import repro_torch.core as T
    from repro_torch.kernels import cam_search
    g, _, q, _ = data
    gb = (torch.from_numpy(g).cuda() > 0).float()
    qb = (torch.from_numpy(q).cuda() > 0).float()
    inputs = [qb, gb]
    if care:
        rng = np.random.default_rng(5)            # 10 % wildcards
        inputs.append(torch.from_numpy(
            (rng.random(g.shape, dtype=np.float32) >= 0.1).astype(np.int8)
        ).cuda())
    k = 10
    mod = hamming_module(T, cd, q.shape[0], g.shape[0], g.shape[1], k, care)
    prog = compile_module(mod, ArchSpec(rows=64, cols=64), value_bits=1)
    expect = "fused_topk_packed_ternary" if care else "fused_topk_packed"
    (v, i), counts, first_s, second_s = s.drive(name, prog, inputs, expect)
    prof = s.profile(prog, inputs)
    if v.shape != (q.shape[0], k) or not bool(torch.isfinite(v).all()):
        raise RuntimeError(f"{name}: bad result {v.shape}")
    s.topk[name] = (v, i)

    args, kw = s.kernel_operands(prog, inputs)
    got = cam_search.fused_topk_packed(*args, **kw)
    want = cam_search.fused_topk_packed_reference(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError(f"{name}: kernel and plain version differ")
    err = float((got[0] - want[0]).abs().max())
    # end to end against a dense float64 oracle on the unpacked cells
    q64 = qb[:64].double()
    mism = q64 @ (1 - gb.double()).T + (1 - q64) @ gb.double().T
    if care:
        c64 = inputs[2].double()
        mism = (q64 @ ((1 - gb.double()) * c64).T
                + (1 - q64) @ (gb.double() * c64).T)
    ov = torch.sort(mism, dim=1, stable=True)
    if not (torch.equal(ov.values[:, :k].float(), v[:64])
            and torch.equal(ov.indices[:, :k].int(), i[:64])):
        raise RuntimeError(f"{name}: result differs from the float64 oracle")

    qp, pp, cp = args
    shape = s.packed_shape(args, kw, counts[expect])
    # the padded micro-batch of earlier runs (zero rows after the queries)
    batch = prog.engine_plan.batch
    padded = s.packed_shape((torch.nn.functional.pad(
        qp, (0, 0, 0, batch - qp.shape[0])), pp, cp), kw, 0)
    ms, bound, by = shape["ms"], shape["bound_ms"], shape["bound_by"]
    plain_ms = cuda_ms(
        lambda: cam_search.fused_topk_packed_reference(*args, **kw), 3)
    qpm = 2 * qb - 1
    gpm = 2 * gb - 1
    if care:
        gpm = gpm * inputs[2]
    qpm = torch.nn.functional.pad(qpm, (0, 0, 0, qp.shape[0] - qpm.shape[0]))
    library_ms = cuda_ms(lambda: torch.matmul(qpm, gpm.T).topk(k), 5)
    del gpm
    s.record(expect, "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304", counts[expect], err, ms,
             plain_ms, bound, by, library_ms)
    rec = s.kernels[expect]
    rec.setdefault("shapes", {})["knn"] = dict(shape, plain_ms=plain_ms,
                                               library_ms=library_ms)
    rec["shapes"][f"knn_padded_{batch}"] = padded
    rec["bound_basis"] = shape["basis"]
    rec["bound_ms_popc_all_rows"] = shape["bound_ms_popc_all_rows"]
    log({"phase": name, "ok": True, "launches": counts, "b1_knn": shape,
         "b1_knn_padded": padded,
         "first_call_s": first_s, "second_call_s": second_s,
         "kernel_shape": {"q": list(qp.shape), "p": list(pp.shape),
                          "k": kw["k"]},
         "candidates_bit_identical": True, "float64_oracle_rows": 64,
         "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": bound, "bound_by": by, "profile": prof})


def phase_hdc_quickstart(s: Smoke):
    import torch
    from repro_torch.core import CamType, PAPER_BASE_ARCH, compile_fn
    from repro_torch.data import hdc_dataset
    from repro_torch.kernels import cam_search
    classes, queries, labels = hdc_dataset(n_classes=10, dim=8192,
                                           n_queries=64)
    ct, qt = torch.from_numpy(classes).cuda(), torch.from_numpy(queries).cuda()
    prog = compile_fn(hdc_similarity, [queries, classes], PAPER_BASE_ARCH,
                      cam_type=CamType.TCAM, value_bits=1)
    (v, i), counts, first_s, second_s = s.drive(
        "hdc_quickstart", prog, [qt, ct], "fused_topk_packed")
    prof = s.profile(prog, [qt, ct])
    args, kw = s.kernel_operands(prog, [qt, ct])
    got = cam_search.fused_topk_packed(*args, **kw)
    want = cam_search.fused_topk_packed_reference(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("hdc_quickstart: kernel and plain version differ")
    # dense bipolar oracle: argmax of the +-1 dot, lowest index on ties
    qpm = 2 * qt.double() - 1
    cpm = 2 * ct.double() - 1
    dots = qpm @ cpm.T
    best = torch.sort(-dots, dim=1, stable=True).indices[:, 0]
    if not (torch.equal(best.int(), i[:, 0])
            and torch.equal(dots.max(1).values.float(), v[:, 0])):
        raise RuntimeError("hdc_quickstart: result differs from the oracle")
    acc = float((i[:, 0].cpu().numpy() == labels).mean())
    rep = prog.cost_report()
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts["fused_topk_packed"], 0.0, None, None, None, "operations",
             None)
    log({"phase": "hdc_quickstart", "ok": True, "launches": counts,
         "first_call_s": first_s, "second_call_s": second_s,
         "kernel_shape": {"q": list(args[0].shape),
                          "p": list(args[1].shape), "k": kw["k"]},
         "candidates_bit_identical": True, "recall_accuracy": acc,
         "cost_report": {"latency_us": rep.latency_us,
                         "energy_uj": rep.energy_uj, "power_w": rep.power_w},
         "profile": prof})


def phase_forest_acam(s: Smoke):
    import numpy as np
    import torch
    from repro_torch.core import ArchSpec, CamType
    from repro_torch.forest import CamForestClassifier, random_forest
    from repro_torch.kernels import acam, ops
    t0 = time.perf_counter()
    trees = random_forest(np.random.default_rng(7), **FOREST)
    clf = CamForestClassifier(trees, dim=FOREST["dim"]).compile(
        ArchSpec(rows=64, cols=64, cam_type=CamType.ACAM),
        batch_hint=FOREST_QUERIES)
    compile_s = time.perf_counter() - t0
    plan = clf.plan
    n = clf.intervals.n_rows
    x = np.random.default_rng(8).standard_normal(
        (FOREST_QUERIES, FOREST["dim"])).astype(np.float32)
    xt = torch.from_numpy(x).cuda()
    pred, counts, first_s, second_s = s.drive("forest_acam", clf.predict,
                                              [xt], "acam_match")
    s.only("forest_acam", counts, "acam_match",
           -(-FOREST_QUERIES // plan.batch))
    prof = s.profile(clf.predict, [xt])
    match = clf.matches(xt)

    # the first micro-batch's operands, as the plan hands them to the kernel
    qp = ops.pad_to_blocks(xt[:plan.batch], 1, acam.ACAM_BLOCK_D)
    lo, hi = plan._prepared_patterns(clf._lo, clf._hi)
    got = acam.acam_match(qp, lo, hi, n_valid=n)
    want = acam.acam_match_reference(qp, lo, hi, n_valid=n)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError("forest_acam: kernel and plain version differ in "
                           f"{int((got != want).sum())} places")
    rows = min(len(xt), plan.batch)
    if not torch.equal(match[:rows], want[:rows]):
        raise RuntimeError("forest_acam: the plan's match matrix differs "
                           "from the plain version")
    per_query = match.sum(1)
    if not bool((per_query == FOREST["n_trees"]).all()):
        raise RuntimeError(f"forest_acam: queries match "
                           f"{int(per_query.min())}..{int(per_query.max())} "
                           f"rows, not one leaf per tree")
    checked = FOREST_CHECKED_ROWS
    ref_pred = clf.predict_reference(x[:checked])
    if not np.array_equal(pred[:checked].cpu().numpy(), ref_pred):
        raise RuntimeError("forest_acam: predictions differ from the tree "
                           "traversal")

    bound, by = s.acam_bound_ms(qp, lo)
    bound_compares, _ = s.acam_bound_ms(qp, lo, basis="compares")
    ms = cuda_ms(lambda: acam.acam_match(qp, lo, hi, n_valid=n), 10)
    plain_ms = cuda_ms(
        lambda: acam.acam_match_reference(qp, lo, hi, n_valid=n), 3)
    s.record("acam_match", "src/repro_torch/kernels/csrc/acam_match.cu",
             "src/repro/kernels/acam.py:121", counts["acam_match"], 0.0, ms,
             plain_ms, bound, by, None)
    rec = s.kernels["acam_match"]
    rec["library_note"] = "no single PyTorch call computes an interval match"
    rec["bound_basis"] = (f"{acam_issue_slots()} issue slots a cell (FADD, "
                          f"LOP3), 4 warp instructions per clock per SM")
    rec["bound_ms_compares"] = bound_compares
    rep = clf.cost_report()
    log({"phase": "forest_acam", "ok": True, "launches": counts,
         "compile_s": compile_s, "first_call_s": first_s,
         "second_call_s": second_s,
         "kernel_shape": {"q": list(qp.shape), "lo": list(lo.shape)},
         "rows": n, "wildcard_frac": clf.intervals.wildcard_frac,
         "match_bit_identical": True, "matches_per_query": FOREST["n_trees"],
         "predictions_equal_traversal_rows": checked,
         "ms": ms, "plain_ms": plain_ms, "library_ms": None,
         "bound_ms": bound, "bound_by": by,
         "bound_ms_compares": bound_compares,
         "cost_report": {"latency_us": rep.latency_us,
                         "energy_uj": rep.energy_uj, "power_w": rep.power_w},
         "profile": prof})


def b2_order_reproduced(qp, pp, got_v, got_i, want_i, k, largest, what,
                        replay=None):
    """Replay each eucl index swap of B2's "wgmma" route against its plain
    version in the kernel's arithmetic (the pipeline it shares with B4 and
    B6, so ``cam_search.tf32x3_kernel_eucl``; ``replay``, another metric's
    replay, such as ``tf32x3_kernel_dot``): where the kernel put row
    ``a`` at a position and the plain version row ``b``, the replayed
    distances must order ``a`` and ``b`` (lower row first on equal
    distances) as the kernel's list does (``b`` later in the same list of
    ``k``, or absent).  Raises on a swap the replay does not give.
    Returns (swaps, candidates whose value equals the replayed distance
    exactly)."""
    import torch
    from repro_torch.kernels.cam_search import tf32x3_kernel_eucl
    replay = replay or tf32x3_kernel_eucl
    rows, cols = (got_i != want_i).nonzero(as_tuple=True)
    if rows.numel() == 0:
        return 0, 0
    a, b = got_i[rows, cols].long(), want_i[rows, cols].long()
    da = replay(qp[rows], pp[a])
    db = replay(qp[rows], pp[b])
    seg = (cols // k)[:, None] * k + torch.arange(k, device=cols.device)
    in_list = got_i[rows[:, None], seg] == b[:, None].int()
    pos_b = torch.where(in_list.any(1), in_list.int().argmax(1),
                        torch.full_like(cols, k))
    kernel_a_first = (cols % k) < pos_b
    key_a, key_b = (da, db) if largest else (-da, -db)
    replay_a_first = (key_a > key_b) | ((key_a == key_b) & (a < b))
    bad = (kernel_a_first != replay_a_first).nonzero()
    if bad.numel():
        j = int(bad[0, 0])
        raise RuntimeError(
            f"{what}: swap at ({int(rows[j])}, {int(cols[j])}) is not what "
            f"the kernel's own arithmetic gives ({replay.__name__}): rows "
            f"{int(a[j])} {float(da[j])}, {int(b[j])} {float(db[j])}")
    return int(rows.numel()), int((got_v[rows, cols] == da).sum())


def acam_issue_slots() -> float:
    """B3's issue slots per (query, row, dim) cell, as the kernel's loop
    counts them (``csrc/acam_match.cu``): per 4 dims of a (query, row)
    pair, eight FADDs (``q - lo``, ``hi - q``) and four 3-input LOP3s that
    fold their bits into the flag word.  The shared-memory loads (16 per
    384 slots) and the staging are left out."""
    fadd, lop3, dims = 8, 4, 4
    return (fadd + lop3) / dims


def hdc_count_bits(n_features: int) -> int:
    """The fewest bit planes a count of ``n_features`` needs (at least
    the 4 a 16-feature adder tree writes below its carry): the bound's
    basis, whatever wider plane count the kernel's route keeps."""
    return max(4, int(n_features).bit_length())


def hdc_logical_ops(planes: int, has_zero: bool) -> float:
    """B5's logical operations per (query, feature, 32-dim word), as the
    kernel's loop counts them (``csrc/hdc_encode.cu``): per 16 features a
    LOP3 for each ``neg`` word (and an AND for each ``care`` word where
    zero cells exist), 15 full adders of two LOP3 each, and two operations
    per half adder of the ripple into planes 4 .. ``planes`` - 1; the care
    counts, where counted, take a second tree."""
    tree = 2 * 15 + 2 * (planes - 4)
    if has_zero:
        return (2 * 16 + 2 * tree) / 16
    return (16 + tree) / 16


def range_module(T, cd, m, n, dim, metric, tau, value_bits):
    """cim program for a TH-mode range search (``dist <= tau``): the
    traced front end has no range pattern, so it enters the pipeline at
    compile_module, like hamming_module."""
    mod = T.Module("range_search", [T.TensorType((m, dim)),
                                    T.TensorType((n, dim))])
    a = mod.arguments
    b = T.Builder(mod.body)
    dev = cd.make_acquire(b)
    exe = cd.make_execute(b, dev.result, list(a),
                          [T.TensorType((m, n), "i1")])
    blk = exe.region().block()
    rs = cd.make_range_search(blk, a[0], patterns=a[1], metric=metric,
                              threshold=tau, below=True,
                              extra_attrs={"value_bits": value_bits})
    cd.make_yield(blk, rs.results)
    cd.make_release(b, dev.result)
    b.ret(exe.results)
    return mod


def _range_part(s: Smoke, name, metric, tau, inputs, value_bits):
    """Drive one range program on the main path and hold its kernel
    against the plain version on the first micro-batch's operands.
    Returns (main-path match, kernel match, plain match, the kernel's
    (q, p, kwargs), the path's launches, the phase record)."""
    import torch
    import repro_torch.core as T
    from repro_torch.core import ArchSpec, compile_module
    from repro_torch.core import cim_dialect as cd
    from repro_torch.kernels import acam, ops
    qt, gt = inputs
    mod = range_module(T, cd, qt.shape[0], gt.shape[0], gt.shape[1], metric,
                       tau, value_bits)
    prog = compile_module(mod, ArchSpec(rows=64, cols=64))
    plan = prog.engine_plan
    if plan.packed or plan.backend != "cuda":
        raise RuntimeError(f"{name}: expected a float-cell cuda plan")
    hit, counts, first_s, second_s = s.drive(name, prog, inputs,
                                             "range_match")
    s.only(name, counts, "range_match", -(-qt.shape[0] // plan.batch))
    prof = s.profile(prog, inputs)
    (pp,) = plan._prepared_patterns(gt)
    qp = ops.pad_to_blocks(qt[:plan.batch], 1, 8)   # the first micro-batch
    kw = dict(metric=metric, threshold=tau, below=True,
              to_logical="identity", dim=gt.shape[1], n_valid=gt.shape[0])
    got = acam.range_match(qp, pp, **kw)
    want = acam.range_match_reference(qp, pp, **kw)
    torch.cuda.synchronize()
    rows = min(qt.shape[0], plan.batch)
    if not torch.equal(hit[:rows], got[:rows]):
        raise RuntimeError(f"{name}: the main path and the kernel differ")
    info = {"launches": counts, "first_call_s": first_s,
            "second_call_s": second_s, "tau": tau, "batch": plan.batch,
            "kernel_shape": {"q": list(qp.shape), "p": list(pp.shape)},
            "matches_per_query_mean": float(hit.sum(1).float().mean()),
            "profile": prof}
    return hit, got, want, (qp, pp, kw), counts["range_match"], info


def phase_range_threshold(s: Smoke, data):
    import torch
    from repro_torch.kernels import acam, cam_search
    g, _, q, _ = data
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()

    # (a) eucl: tau = median 5th-nearest squared distance of knn_eucl
    kv, ki = s.topk["knn_eucl"]
    tau = float(kv[:, 4].median())
    hit, got, want, (qp, pp, kw), launches, info_a = _range_part(
        s, "range_eucl", "eucl", tau, [qt, gt], 8)
    tol = EUCL_ATOL + EUCL_RTOL * abs(tau)

    def disagreements(qx, got, want):
        """The kernel's disagreements with the plain version: each a
        float64 near-tie of tau, and each what the kernel's own arithmetic
        gives in its order (``tf32x3_kernel_eucl``); also how many the 3xTF32
        split as a float32 matrix product reproduces."""
        rows, cols = (got != want).nonzero(as_tuple=True)
        d64 = ((qx[rows].double() - pp[cols].double()) ** 2).sum(1)
        if not bool(((d64 - tau).abs() <= tol).all()):
            j = int(((d64 - tau).abs() > tol).nonzero()[0, 0])
            raise RuntimeError(
                f"range_eucl: kernel and plain version differ at "
                f"({int(rows[j])}, {int(cols[j])}), not a float64 near-tie: "
                f"{float(d64[j])} vs tau {tau}")
        emulated = acam.range_match_reference(qx, pp, tf32x3=True, **kw)
        explained = int((emulated[rows, cols] == got[rows, cols]).sum())
        del emulated
        in_order = cam_search.tf32x3_kernel_eucl(qx[rows], pp[cols]) <= tau
        explained_in_order = int((in_order == got[rows, cols]).sum())
        if explained_in_order != int(rows.numel()):
            raise RuntimeError(
                f"range_eucl: {int(rows.numel()) - explained_in_order} of "
                f"{int(rows.numel())} disagreements are not what the "
                f"kernel's own arithmetic gives (tf32x3_kernel_eucl): a wrong "
                f"operand, not rounding")
        return int(rows.numel()), explained, explained_in_order

    n_dis, explained, explained_in_order = disagreements(qp, got, want)
    # the padded micro-batch of earlier runs (zero rows after the queries)
    batch = info_a["batch"]
    qpad = torch.nn.functional.pad(qp, (0, 0, 0, batch - qp.shape[0]))
    got_pad = acam.range_match(qpad, pp, **kw)
    padded = disagreements(qpad, got_pad,
                           acam.range_match_reference(qpad, pp, **kw))
    if not torch.equal(got_pad[:qp.shape[0]], got):
        raise RuntimeError("range_eucl: the padded rows changed the real "
                           "rows' matches")
    del got_pad
    top = ki[:, :5].long()                     # knn top-5 below tau - tol
    dtop = ((qt[:, None, :].double() - gt[top].double()) ** 2).sum(-1)
    sure = dtop < tau - tol
    if not bool(hit.gather(1, top)[sure].all()):
        raise RuntimeError("range_eucl: a knn top-5 row well inside tau "
                           "was not matched")
    shapes = {}
    for name, qx in (("path", qp), (f"padded_{batch}", qpad)):
        bound, by = s.range_bound_ms(qx, pp)
        bound_fp32, _ = s.range_bound_ms(qx, pp, fp32_cuda_cores=True)
        shapes[name] = {
            "rows": qx.shape[0],
            "ms": cuda_ms(lambda qx=qx: acam.range_match(qx, pp, **kw), 10),
            "bound_ms": bound, "bound_by": by,
            "bound_ms_fp32_cuda_cores": bound_fp32,
            "library_ms": cuda_ms(
                lambda qx=qx: torch.cdist(qx, pp).square_() <= tau, 5)}
    shapes["path"]["disagreements"] = n_dis
    shapes[f"padded_{batch}"]["disagreements"] = padded[0]
    path = shapes["path"]
    ms, bound, by = path["ms"], path["bound_ms"], path["bound_by"]
    bound_fp32, library_ms = path["bound_ms_fp32_cuda_cores"], \
        path["library_ms"]
    plain_ms = cuda_ms(lambda: acam.range_match_reference(qp, pp, **kw), 5)
    s.record("range_match", "src/repro_torch/kernels/csrc/range_match.cu",
             "src/repro/kernels/acam.py:193", launches,
             float((got != want).any()), ms, plain_ms, bound, by, library_ms)
    rec = s.kernels["range_match"]
    rec["mismatches_float64_near_ties"] = n_dis
    rec["mismatches_reproduced_by_tf32x3_emulation"] = explained
    rec["mismatches_reproduced_in_kernel_order"] = explained_in_order
    rec["mismatches_padded_shape"] = list(padded)
    rec["bound_basis"] = "3xTF32 tensor cores, 495 TFLOP/s"
    rec["bound_ms_fp32_cuda_cores"] = bound_fp32
    rec["shapes"] = shapes
    log(dict(info_a, phase="range_threshold", part="eucl", ok=True,
             disagreements_float64_near_ties=n_dis,
             disagreements_reproduced_by_tf32x3_emulation=explained,
             disagreements_reproduced_in_kernel_order=explained_in_order,
             padded_disagreements_near_ties_emulated_in_order=list(padded),
             bound_ms_fp32_cuda_cores=bound_fp32, shapes=shapes,
             knn_top5_inside_tau=int(sure.sum()), ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=bound, bound_by=by))
    del hit, got, want, qp, qpad, pp

    # (b) hamming on float cells: pack=None demotes on the cuda backend
    hv, hi_ = s.topk["hamming_packed"]
    tau = float(hv[:, 9].median())
    gb, qb = (gt > 0).float(), (qt > 0).float()
    del gt, qt
    hit, got, want, (qp, pp, kw), launches, info_b = _range_part(
        s, "range_hamming", "hamming", tau, [qb, gb], 1)
    if not torch.equal(got, want):
        raise RuntimeError("range_hamming: kernel and plain version differ")
    inside = hv <= tau
    if not bool(hit.gather(1, hi_.long())[inside].all()):
        raise RuntimeError("range_hamming: a packed top-10 row within tau "
                           "was not matched")
    ms = cuda_ms(lambda: acam.range_match(qp, pp, **kw), 10)
    s.record("range_match", "src/repro_torch/kernels/csrc/range_match.cu",
             "src/repro/kernels/acam.py:193", launches, 0.0, None, None,
             None, "operations", None)
    log(dict(info_b, phase="range_threshold", part="hamming", ok=True,
             bit_identical=True, packed_top10_inside_tau=int(inside.sum()),
             ms=ms))


def host_ms(fn):
    """Host-clock milliseconds of ``fn()`` to a synchronise, and its
    result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def phase_hdc_mnist(s: Smoke):
    import numpy as np
    import torch
    from repro_torch.data import hdc_mnist_dataset
    from repro_torch.hdc import HdcClassifier
    from repro_torch.kernels import cam_search
    from repro_torch.kernels import hdc_encode as khdc
    from repro_torch.kernels import ref as kref
    t0 = time.perf_counter()
    xtr_np, ytr, xte_np, yte = hdc_mnist_dataset(**HDC_MNIST)
    xtr = torch.from_numpy(xtr_np).cuda()     # features held on the card
    xte = torch.from_numpy(xte_np).cuda()
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    mem0 = torch.cuda.memory_allocated()
    s.reset_peak()
    clf = HdcClassifier(xtr.shape[1], HDC_CLASSES, dim=HDC_DIM,
                        n_levels=HDC_LEVELS, seed=0)
    item = clf.item
    yte_t = torch.from_numpy(yte).cuda().long()

    # -- the main path, counted: encode, fit, compile, predict, retrain --
    cam_search.reset_launch_counts()
    encode_train_ms, enc_tr = host_ms(lambda: clf.encode(xtr))
    encode_test_ms, enc_te = host_ms(lambda: clf.encode(xte))
    fit_ms, _ = host_ms(lambda: clf.fit(y=ytr, encoded=enc_tr))
    clf.compile(batch_hint=1024)
    plan = clf.plan
    if not plan.packed or plan.backend != "cuda" or \
            plan.device.type != "cuda":
        raise RuntimeError(f"hdc_mnist: expected a packed cuda plan, got "
                           f"{clf.summary()}")
    predict_first_ms, pred = host_ms(lambda: clf.predict(encoded=enc_te))
    predict_ms, pred2 = host_ms(lambda: clf.predict(encoded=enc_te))
    if not torch.equal(pred, pred2):
        raise RuntimeError("hdc_mnist: a repeated predict changed the result")
    want = clf.predict_reference(encoded=enc_te)
    if not torch.equal(pred, want):
        raise RuntimeError(f"hdc_mnist: predictions differ from the dense "
                           f"oracle in {int((pred != want).sum())} rows")
    rows = HDC_INTERPRETED_ROWS
    if not torch.equal(pred[:rows],
                       clf.predict_interpreted(encoded=enc_te[:rows])):
        raise RuntimeError("hdc_mnist: predictions differ from the IR "
                           "interpreter")
    acc0 = float((pred.long() == yte_t).float().mean())

    epochs = []
    update_ms = []
    update = plan.update_rows

    def timed_update(*args, **kw):        # host clock of each row update
        ms, out = host_ms(lambda: update(*args, **kw))
        update_ms.append(ms)
        return out

    plan.update_rows = timed_update
    try:
        for _ in range(HDC_EPOCHS):
            fb0 = plan.row_update_fallbacks
            n_upd = len(update_ms)
            ep_ms, (train_acc, pushed) = host_ms(
                lambda: clf.retrain_epoch(encoded=enc_tr, y=ytr))
            if plan.row_update_fallbacks != fb0:
                raise RuntimeError("hdc_mnist: a row update fell back")
            hits0, miss0 = plan.pattern_hits, plan.pattern_misses
            pred = clf.predict(encoded=enc_te)
            if plan.pattern_hits != hits0 + 1 or \
                    plan.pattern_misses != miss0:
                raise RuntimeError("hdc_mnist: predict after an update was "
                                   "not a pattern-memo hit")
            if not torch.equal(pred, clf.predict_reference(encoded=enc_te)):
                raise RuntimeError("hdc_mnist: predictions after an update "
                                   "differ from the dense oracle")
            epochs.append({
                "train_accuracy_before": train_acc, "rows_pushed": pushed,
                "test_accuracy_after": float(
                    (pred.long() == yte_t).float().mean()),
                "epoch_ms": ep_ms,
                "update_rows_ms": update_ms[n_upd:]})
    finally:
        del plan.update_rows
    if not update_ms or sum(e["rows_pushed"] for e in epochs) == 0:
        raise RuntimeError("hdc_mnist: retraining pushed no row, so "
                           "update_rows went unexercised")
    counts = dict(cam_search.LAUNCHES)
    for name in ("hdc_encode", "fused_topk_packed"):
        if counts[name] < 1:
            raise RuntimeError(f"hdc_mnist: kernel {name} was not launched "
                               f"on the main path: {counts}")
    if counts["hdc_encode"] != 2:
        raise RuntimeError(f"hdc_mnist: expected two encode launches, got "
                           f"{counts}")
    prof = s.profile(lambda e: clf.predict(encoded=e), [enc_te])
    encode_prof = s.profile(clf.encode, [xte])
    encode_second_ms, enc_again = host_ms(lambda: clf.encode(xte))
    if not torch.equal(enc_again, enc_te):
        raise RuntimeError("hdc_mnist: a repeated encode changed the result")
    del enc_again

    # -- B5 against its plain version and the dense oracle -----------------
    planes = item._planes                  # the kernel's bit planes
    if planes.has_zero:
        raise RuntimeError("hdc_mnist: the item memory holds zero cells")
    q_te = torch.from_numpy(item.quantize(xte_np)).cuda()
    chunk = 8192
    for x, enc in ((xtr_np, enc_tr), (xte_np, enc_te)):
        for s0 in range(0, x.shape[0], chunk):
            q = torch.from_numpy(item.quantize(x[s0:s0 + chunk])).cuda()
            if not torch.equal(item.level_ids(x[s0:s0 + chunk]), q):
                raise RuntimeError(
                    f"hdc_mnist: the device quantisation differs from "
                    f"numpy's in rows {s0}..{s0 + chunk}")
            plain = khdc.hdc_encode_reference(q, item._keys_t,
                                              item._levels_t)
            if not torch.equal(enc[s0:s0 + chunk], plain):
                raise RuntimeError(
                    f"hdc_mnist: the encode kernel differs from its plain "
                    f"version in {int((enc[s0:s0 + chunk] != plain).sum())} "
                    f"cells of rows {s0}..{s0 + chunk}")
    for s0 in range(0, HDC_DENSE_ROWS, HDC_DENSE_CHUNK):
        dense = kref.hdc_encode(q_te[s0:s0 + HDC_DENSE_CHUNK], item._keys_t,
                                item._levels_t)
        if not torch.equal(enc_te[s0:s0 + HDC_DENSE_CHUNK], dense):
            raise RuntimeError("hdc_mnist: the encoding differs from the "
                               "dense oracle")
    ties = int((khdc.hdc_sums_reference(q_te, item._keys_t, item._levels_t)
                == 0).sum())
    if ties == 0:
        raise RuntimeError("hdc_mnist: no exact-zero sum in the test set; "
                           "the tie contract went unexercised")

    # -- B1 at the predict shape (one micro-batch of the test set) --------
    import types
    args, kw = s.kernel_operands(types.SimpleNamespace(engine_plan=plan),
                                 [enc_te, clf._gallery])
    got = cam_search.fused_topk_packed(*args, **kw)
    want = cam_search.fused_topk_packed_reference(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("hdc_mnist: the packed kernel and its plain "
                           "version differ at the predict shape")
    b1_hdc = s.packed_shape(args, kw, counts["fused_topk_packed"])
    b1_hdc["plain_ms"] = cuda_ms(
        lambda: cam_search.fused_topk_packed_reference(*args, **kw), 5)
    qpm = 2.0 * enc_te[:args[0].shape[0]].float() - 1
    gpm = 2.0 * clf._gallery.float() - 1
    b1_hdc["library_ms"] = cuda_ms(lambda: torch.matmul(qpm, gpm.T).topk(1),
                                   20)
    b1_hdc["bit_identical"] = True
    del qpm, gpm, got, want

    bound, by = s.hdc_bound_ms(q_te, planes)
    bound_idp4a, _ = s.hdc_bound_ms(q_te, planes, "idp4a")
    ms = cuda_ms(lambda: khdc.hdc_encode_planes(q_te, planes), 10)
    plain_ms = cuda_ms(lambda: khdc.hdc_encode_reference(
        q_te, item._keys_t, item._levels_t), 3)
    s.record("hdc_encode", "src/repro_torch/kernels/csrc/hdc_encode.cu",
             "src/repro/kernels/hdc_encode.py:87", counts["hdc_encode"], 0.0,
             ms, plain_ms, bound, by, None)
    rec = s.kernels["hdc_encode"]
    rec["library_note"] = (
        "no single PyTorch call computes a signed gathered bundle")
    rec["kernel_route"] = "bitsliced, no zero cell"
    per_step = hdc_logical_ops(hdc_count_bits(q_te.shape[1]), False)
    rec["bound_basis"] = (f"{per_step} LOP3 per (row, feature, word) at "
                          f"64 a clock per SM")
    rec["bound_ms_idp4a_basis"] = bound_idp4a
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts["fused_topk_packed"], 0.0, None, None, None,
             "operations", None)
    s.kernels["fused_topk_packed"].setdefault("shapes", {})[
        "hdc_predict"] = b1_hdc
    del enc_tr, enc_te
    peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    if peak_gb > HDC_PEAK_GB:
        raise RuntimeError(f"hdc_mnist: the phase held {peak_gb:.2f} GB "
                           f"at its peak, over {HDC_PEAK_GB} GB")
    log({"phase": "hdc_mnist", "ok": True, "launches": counts,
         "data_s": data_s, "train": list(xtr.shape), "test": list(xte.shape),
         "dim": HDC_DIM, "levels": HDC_LEVELS, "plan": clf.summary(),
         "encode_bit_identical_rows": xtr.shape[0] + xte.shape[0],
         "dense_oracle_rows": HDC_DENSE_ROWS,
         "interpreted_rows": HDC_INTERPRETED_ROWS,
         "exact_zero_sums_test": ties,
         "encode_train_ms": encode_train_ms,
         "encode_ms_per_10k_rows": encode_test_ms * 1e4 / xte.shape[0],
         "encode_second_call_ms_per_10k_rows":
             encode_second_ms * 1e4 / xte.shape[0],
         "fit_ms": fit_ms, "predict_first_ms": predict_first_ms,
         "predict_ms_per_10k_rows": predict_ms * 1e4 / xte.shape[0],
         "one_shot_test_accuracy": acc0, "epochs": epochs,
         "phase_peak_gb": peak_gb, "predict_profile": prof,
         "b1_hdc_predict": b1_hdc,
         "encode_profile": encode_prof,
         "kernel_shape": {"q": list(q_te.shape),
                          "key_planes": list(planes.key_planes.shape),
                          "level_planes": list(planes.level_planes.shape)},
         "kernel_route": "bitsliced, no zero cell",
         "ms": ms, "plain_ms": plain_ms, "library_ms": None,
         "bound_ms": bound, "bound_by": by,
         "bound_ms_idp4a_basis": bound_idp4a})


def _update_part(s: Smoke, name, build, qt, gt, rows, new):
    """``update_rows`` on one plan, both ``donate`` settings: each update
    must leave the next execute a memo hit with no fallback, bit-identical
    to a fresh plan on the mutated gallery; the old gallery keeps its old
    result.  Returns (launches, record)."""
    import torch
    from repro_torch.core import clear_plan_cache
    from repro_torch.kernels import cam_search
    prog = build()
    plan = prog.engine_plan
    cam_search.reset_launch_counts()
    before = prog(qt, gt)
    fb0 = plan.row_update_fallbacks
    upd_ms, g1 = host_ms(lambda: plan.update_rows(gt, rows, new))
    hits0, miss0 = plan.pattern_hits, plan.pattern_misses
    out1 = prog(qt, g1)
    hit1 = (plan.pattern_hits, plan.pattern_misses) == (hits0 + 1, miss0)
    old = prog(qt, gt)
    g2 = gt.clone()
    prog(qt, g2)                                  # prepares the copy
    don_ms, g2r = host_ms(lambda: plan.update_rows(g2, rows, new,
                                                   donate=True))
    hits0, miss0 = plan.pattern_hits, plan.pattern_misses
    out2 = prog(qt, g2)
    hit2 = (plan.pattern_hits, plan.pattern_misses) == (hits0 + 1, miss0)
    # second calls: the same rows again, from the updated galleries
    upd2_ms, g1b = host_ms(lambda: plan.update_rows(g1, rows, new))
    don2_ms, _ = host_ms(lambda: plan.update_rows(g2, rows, new,
                                                  donate=True))
    counts = dict(cam_search.LAUNCHES)
    if not (hit1 and hit2) or plan.row_update_fallbacks != fb0:
        raise RuntimeError(f"{name}: an update was not memo-seeded (hits "
                           f"{hit1}, {hit2}; fallbacks "
                           f"{plan.row_update_fallbacks - fb0})")
    if g2r is not g2 or not torch.equal(g1, g2):
        raise RuntimeError(f"{name}: the donated update differs")
    if not all(torch.equal(a, b) for a, b in zip(old, before)):
        raise RuntimeError(f"{name}: the old gallery lost its old result")
    clear_plan_cache()
    fresh_prog = build()
    fresh_plan = fresh_prog.engine_plan
    fresh = fresh_prog(qt, g1.clone())
    for got, what in ((out1, "donate=False"), (out2, "donate=True")):
        if not all(torch.equal(a, b) for a, b in zip(got, fresh)):
            raise RuntimeError(f"{name}: after the {what} update the result "
                               f"differs from a fresh plan's")
    fresh_plan._prepare(g1b)
    prep_ms, _ = host_ms(lambda: fresh_plan._prepare(g1b))
    del g1, g1b, g2, fresh
    return counts, {"update_ms_donate_false": [upd_ms, upd2_ms],
                    "update_ms_donate_true": [don_ms, don2_ms],
                    "full_prepare_ms": prep_ms,
                    "bit_identical_to_fresh_plan": True,
                    "memo_hit_after_update": True,
                    "old_gallery_keeps_old_result": True}


def phase_gallery_update(s: Smoke, data):
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.core import ArchSpec, compile_fn, compile_module
    from repro_torch.core import cim_dialect as cd
    g, g_labels, q, _ = data
    n, dim = g.shape
    rng = np.random.default_rng(UPDATE_SEED)
    starts = np.sort(rng.choice(n // UPDATE_RUN, UPDATE_RUNS,
                                replace=False)) * UPDATE_RUN
    rows = (starts[:, None] + np.arange(UPDATE_RUN)).reshape(-1)
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    # new rows from the gallery's distribution: their class mean + N(0, 1)
    labels = torch.from_numpy(g_labels).cuda().long()
    means = torch.stack([gt[labels == c].mean(0)
                         for c in range(int(labels.max()) + 1)])
    noise = torch.from_numpy(
        rng.standard_normal((rows.size, dim)).astype(np.float32)).cuda()
    new = means[labels[torch.from_numpy(rows).cuda()]] + noise
    arch = ArchSpec(rows=64, cols=64)

    counts_a, rec_a = _update_part(
        s, "gallery_update_eucl",
        lambda: compile_fn(knn_kernel, [q, g], arch, value_bits=8), qt, gt,
        rows, new)
    gb, qb = (gt > 0).float(), (qt > 0).float()
    del gt, qt
    counts_b, rec_b = _update_part(
        s, "gallery_update_packed",
        lambda: compile_module(hamming_module(T, cd, q.shape[0], n, dim, 10,
                                              False), arch, value_bits=1),
        qb, gb, rows, (new > 0).float())
    if counts_a["fused_topk"] < 1 or counts_b["fused_topk_packed"] < 1:
        raise RuntimeError(f"gallery_update: a kernel of the path was not "
                           f"launched: {counts_a} {counts_b}")
    s.record("fused_topk", "src/repro_torch/kernels/csrc/fused_topk.cu",
             "src/repro/kernels/cam_search.py:200", counts_a["fused_topk"],
             0.0, None, None, None, "operations", None)
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts_b["fused_topk_packed"], 0.0, None, None, None,
             "operations", None)
    knn = s.kernels["fused_topk_packed"].get("shapes", {}).get("knn")
    if knn is not None:
        knn["launches"] += counts_b["fused_topk_packed"]
    log({"phase": "gallery_update", "ok": True,
         "rows_updated": int(rows.size), "runs": UPDATE_RUNS,
         "eucl": dict(rec_a, launches=counts_a),
         "packed": dict(rec_b, launches=counts_b)})


def phase_distance_ops(s: Smoke, data):
    import torch
    from repro_torch.kernels import cam_search, ops
    g, _, q, _ = data
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    gb, qb = (gt > 0).float(), (qt > 0).float()
    launches = 0

    def counted(fn):
        nonlocal launches
        cam_search.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        if cam_search.LAUNCHES["distance"] != 1 or \
                sum(cam_search.LAUNCHES.values()) != 1:
            raise RuntimeError(f"distance_ops: expected one distance "
                               f"launch, got {cam_search.LAUNCHES}")
        launches += 1
        return out

    d = counted(lambda: ops.cam_distances(qt, gt, metric="eucl"))
    prof = s.profile(lambda a, b: ops.cam_distances(a, b, metric="eucl"),
                     [qt, gt])
    dh = counted(lambda: ops.cam_distances(qb, gb, metric="hamming"))
    exact = counted(lambda: ops.cam_exact(qb, gb))
    tau = float(dh.median())
    within = counted(lambda: ops.cam_range(qb, gb, tau))
    if tuple(d.shape) != (q.shape[0], g.shape[0]) or \
            not bool(torch.isfinite(d).all()):
        raise RuntimeError(f"distance_ops: bad result {tuple(d.shape)}")
    plain = cam_search.distance_reference(qt, gt, metric="eucl")
    off = (d - plain).abs()
    if not bool((off <= EUCL_ATOL + EUCL_RTOL * plain.abs()).all()):
        raise RuntimeError(f"distance_ops: eucl off the plain version by "
                           f"{float(off.max())}")
    err = float(off.max())
    worst_share = float((off / (EUCL_ATOL + EUCL_RTOL * plain.abs())).max())
    mean_err = float((d.double() - plain.double()).mean())
    # the kernel's own arithmetic, replayed: the query row holding the
    # largest error (all its rows) and the REPLAY_FURTHEST entries
    # furthest from the plain version
    n = gt.shape[0]
    flat = off.flatten()
    far = flat.topk(REPLAY_FURTHEST).indices
    row = int(far[0]) // n
    rows = torch.cat([torch.full((n,), row, device=far.device), far // n])
    cols = torch.cat([torch.arange(n, device=far.device), far % n])
    del plain, off, flat
    replay = cam_search.tf32x3_kernel_eucl(qt[rows], gt[cols])
    replay_equal = int((replay == d[rows, cols]).sum())
    if replay_equal != rows.numel():
        raise RuntimeError(
            f"distance_ops: {rows.numel() - replay_equal} of "
            f"{rows.numel()} replayed eucl entries differ from the kernel's "
            f"(tf32x3_kernel_eucl)")
    del replay, rows, cols
    plain_h = cam_search.distance_reference(qb, gb, metric="hamming")
    if not torch.equal(dh, plain_h):
        raise RuntimeError("distance_ops: hamming differs from the plain "
                           "version")
    if not (torch.equal(exact, plain_h == 0)
            and torch.equal(within, plain_h <= tau)):
        raise RuntimeError("distance_ops: cam_exact / cam_range differ from "
                           "the plain version's comparisons")
    exact_pairs, within_pairs = int(exact.sum()), int(within.sum())
    del plain_h, exact, within, dh

    bound, by = s.distance_bound_ms(qt, gt)
    bound_fp32, _ = s.distance_bound_ms(qt, gt, fp32_cuda_cores=True)
    ms = cuda_ms(lambda: cam_search.distance(qt, gt, metric="eucl"), 10)
    plain_ms = cuda_ms(lambda: cam_search.distance_reference(
        qt, gt, metric="eucl"), 5)
    library_ms = cuda_ms(lambda: torch.cdist(qt, gt) ** 2, 5)
    ham_ms = cuda_ms(lambda: cam_search.distance(qb, gb, metric="hamming"),
                     10)
    ham_library_ms = cuda_ms(lambda: torch.cdist(qb, gb, p=0), 3)
    s.record("distance", "src/repro_torch/kernels/csrc/distance.cu",
             "src/repro/kernels/cam_search.py:351", launches, err, ms,
             plain_ms, bound, by, library_ms)
    rec = s.kernels["distance"]
    rec["bound_basis"] = "3xTF32 tensor cores, 495 TFLOP/s"
    rec["bound_ms_fp32_cuda_cores"] = bound_fp32
    rec["eucl_worst_share_of_tolerance"] = worst_share
    rec["replayed_bit_identical"] = [replay_equal, row]
    log({"phase": "distance_ops", "ok": True, "launches": launches,
         "shape": [q.shape[0], g.shape[0], g.shape[1]],
         "output_mb": 4e-6 * q.shape[0] * g.shape[0],
         "eucl_max_abs_err": err, "eucl_mean_err": mean_err,
         "eucl_worst_share_of_tolerance": worst_share,
         "replayed_bit_identical": replay_equal, "replayed_row": row,
         "hamming_bit_identical": True,
         "hamming_tau": tau, "exact_pairs": exact_pairs,
         "within_tau_pairs": within_pairs,
         "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "hamming_ms": ham_ms, "hamming_library_ms_cdist_p0": ham_library_ms,
         "bound_ms": bound, "bound_by": by,
         "bound_ms_fp32_cuda_cores": bound_fp32, "profile": prof})


# ---------------------------------------------------------------------------
# queue_c: the repaired refusals (k > MAX_K on the card, B5's size limits)
# ---------------------------------------------------------------------------


def _knn_k(k):
    """``benchmarks/table2_knn.py``'s KNN program at top-``k``."""
    def knn(q, gallery):
        diff = q.unsqueeze(1).sub(gallery)
        return diff.norm(p=2, dim=-1).topk(k, largest=False)
    return knn


def _select_part(s: Smoke, what, dist, k, largest, n_valid):
    """K1s on one matrix of the route: bit for bit against its plain
    version, then its time, the plain version's and ``torch.topk``'s on
    the same matrix, and its bound."""
    import torch
    from repro_torch.kernels import cam_search
    kw = dict(k=k, largest=largest, n_valid=n_valid)
    got = cam_search.topk_select(dist, **kw)
    want = cam_search.topk_select_reference(dist, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1])):
        raise RuntimeError(f"queue_c {what}: topk_select differs from its "
                           f"plain version")
    m = dist.shape[0]
    bound, by = s.select_bound_ms(m, n_valid, k)
    live = dist[:, :n_valid]
    call = lambda: cam_search.topk_select(dist, **kw)  # noqa: E731
    return {"rows": m, "cols": dist.shape[1], "n_valid": n_valid, "k": k,
            "grid": cam_search.select_grid(
                m, k, n_valid, s.props.multi_processor_count),
            "bit_identical_to_plain": True,
            "ms": cuda_ms(call, 20),
            "device_ms": device_ms_per_call(call, 20),
            "plain_ms": cuda_ms(lambda: cam_search.topk_select_reference(
                dist, **kw), 5),
            "library_ms": cuda_ms(lambda: torch.topk(live, k, largest=largest),
                                  5),
            "bound_ms": bound, "bound_by": by}


def _queue_c_eucl(s: Smoke, data):
    """C1, eucl: top-500 at the KNN shape on the default ("cuda") backend,
    B6's matrix and K1s, against the "torch" backend on the card; the
    route against its plain version, K1s on B6's matrix against its own
    bit for bit, each at the 624 queries and at a 13-row micro-batch."""
    import torch
    from repro_torch.core import ArchSpec, compile_fn
    from repro_torch.kernels import cam_search
    g, _, q, _ = data
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    k = QUEUE_C_EUCL_K
    prog = compile_fn(_knn_k(k), [q, g], ArchSpec(rows=64, cols=64),
                      value_bits=8)
    (v, i), counts, first_s, second_s = s.drive(
        "queue_c eucl", prog, [qt, gt], "distance_topk")
    s.exactly("queue_c eucl", counts, {"distance_topk": 1, "topk_select": 1})
    route = cam_search.float_route(k)
    if route != "matrix" or v.shape != (q.shape[0], k) or \
            not bool(torch.isfinite(v).all()):
        raise RuntimeError(f"queue_c eucl: route {route}, result "
                           f"{tuple(v.shape)}")
    torch_ms, (tv, ti) = host_ms(lambda: compile_fn(
        _knn_k(k), [q, g], ArchSpec(rows=64, cols=64), value_bits=8,
        backend="torch")(qt, gt))
    tol = EUCL_ATOL + EUCL_RTOL * tv.abs()
    if not bool(((v - tv).abs() <= tol).all()):
        raise RuntimeError(f"queue_c eucl: values off the torch backend by "
                           f"{float((v - tv).abs().max())}")
    swaps = eucl_index_swaps(qt, gt, i, ti, "queue_c eucl vs torch")
    (qp, pp), kw = s.kernel_operands(prog, [qt, gt])
    got = cam_search.topk_by_distance(qp, pp, **kw)
    want = cam_search.topk_by_distance_reference(qp, pp, **kw)
    torch.cuda.synchronize()
    off = (got[0] - want[0]).abs()
    if not bool((off <= EUCL_ATOL + EUCL_RTOL * want[0].abs()).all()):
        raise RuntimeError(f"queue_c eucl: wrapper off its plain version "
                           f"by {float(off.max())}")
    err = float(off.max())
    plain_swaps = eucl_index_swaps(qp, pp, got[1], want[1],
                                   "queue_c eucl vs plain")
    del got, want, off
    n_valid = kw["n_valid"]
    parts = {}
    for rows in (qp.shape[0], QUEUE_C_SMALL_ROWS):
        qr = qp[:rows].contiguous()
        bound, by = s.distance_topk_bound_ms(qr, pp, k)
        d = cam_search.distance(qr, pp, metric="eucl")
        sel = _select_part(s, f"eucl {rows} rows", d, k, kw["largest"],
                           n_valid)
        del d
        parts[rows] = {
            "ms": cuda_ms(lambda: cam_search.topk_by_distance(qr, pp, **kw),
                          10),
            "distance_ms": cuda_ms(
                lambda: cam_search.distance(qr, pp, metric="eucl"), 10),
            "plain_ms": cuda_ms(lambda: cam_search.topk_by_distance_reference(
                qr, pp, **kw), 3),
            "library_ms": cuda_ms(
                lambda: torch.cdist(qr, pp).topk(k, largest=False), 3),
            "bound_ms": bound, "bound_by": by, "topk_select": sel}
        torch.cuda.empty_cache()
    big, small = parts[qp.shape[0]], parts[QUEUE_C_SMALL_ROWS]
    s.record("distance_topk", "src/repro_torch/kernels/csrc/distance.cu",
             "src/repro/kernels/cam_search.py:200", counts["distance_topk"],
             err, big["ms"], big["plain_ms"], big["bound_ms"],
             big["bound_by"], big["library_ms"])
    rec = s.kernels["distance_topk"]
    rec.update(kernel_route="matrix: B6 (distance.cu, 3xTF32) writes the "
                            "(M, N) matrix, K1s (topk_select.cu) selects",
               bound_basis="3xTF32 tensor cores, 495 TFLOP/s; the output "
                           "(M, k) values and indices",
               distance_ms=big["distance_ms"], rows_13=small,
               shape={"q": list(qp.shape), "p": list(pp.shape), "k": k})
    sel = big["topk_select"]
    s.record("topk_select", "src/repro_torch/kernels/csrc/topk_select.cu",
             "src/repro/kernels/cam_search.py:200", counts["topk_select"],
             0.0, sel["ms"], sel["plain_ms"], sel["bound_ms"],
             sel["bound_by"], sel["library_ms"])
    s.kernels["topk_select"].update(
        kernel_route="one launch on select_grid blocks (the card's block "
                     "slots), equal stretches of the live columns: a sampled "
                     "bound a piece, one filtering read into per-row "
                     "candidate lists, the last block of a row selects "
                     "(8-bit radix) and sorts (bitonic up to 512); radix "
                     "select over the row where the list overflows",
        bound_basis="the (M, n_valid) float32 read once, the (M, k) output "
                    "written, 3.35 TB/s",
        library_note="torch.topk on the same matrix (its tie order is not "
                     "the reference's)",
        eucl=sel, eucl_13_rows=small["topk_select"])
    return {"k": k, "route": route, "launches": counts,
            "first_call_s": first_s, "second_call_s": second_s,
            "torch_backend_ms": torch_ms,
            "index_swaps_vs_torch_float64_near_ties": swaps,
            "wrapper_max_abs_err": err,
            "wrapper_index_swaps_float64_near_ties": plain_swaps,
            "rows_624": big, "rows_13": small}


def _queue_c_packed(s: Smoke, data):
    """C1, packed hamming: top-400 at the KNN shape on the default
    backend (K1p on the packed lanes, then K1s), bit-identical to the
    "torch" backend (packed popcount tournament) and, with K1p and K1s
    each, to the plain versions; a 13-row micro-batch through the same
    program; the prepared gallery's bytes."""
    import torch
    import repro_torch.core as T
    from repro_torch.core import ArchSpec, compile_module
    from repro_torch.core import cim_dialect as cd
    from repro_torch.kernels import cam_search
    g, _, q, _ = data
    gb = (torch.from_numpy(g).cuda() > 0).float()
    qb = (torch.from_numpy(q).cuda() > 0).float()
    k = QUEUE_C_PACKED_K
    mod = hamming_module(T, cd, q.shape[0], g.shape[0], g.shape[1], k, False)
    prog = compile_module(mod, ArchSpec(rows=64, cols=64), value_bits=1)
    if not prog.engine_plan.packed:
        raise RuntimeError("queue_c packed: the plan is not packed")
    (v, i), counts, _, _ = s.drive("queue_c packed", prog, [qb, gb],
                                   "packed_distance")
    s.exactly("queue_c packed", counts, {"packed_distance": 1,
                                         "topk_select": 1})
    route = cam_search.packed_route(q.shape[0], g.shape[0], k,
                                    s.props.multi_processor_count)
    torch_ms, (tv, ti) = host_ms(lambda: compile_module(
        mod, ArchSpec(rows=64, cols=64), value_bits=1,
        backend="torch")(qb, gb))
    if route != "matrix" or not (torch.equal(v, tv) and torch.equal(i, ti)):
        raise RuntimeError(f"queue_c packed: route {route}; bit-identical "
                           f"to the torch backend: values "
                           f"{torch.equal(v, tv)}, indices "
                           f"{torch.equal(i, ti)}")
    small = QUEUE_C_SMALL_ROWS
    (sv, si), small_counts, _, _ = s.drive(
        "queue_c packed 13 rows", prog, [qb[:small], gb], "packed_distance")
    s.exactly("queue_c packed 13 rows", small_counts,
              {"packed_distance": 1, "topk_select": 1})
    if not (torch.equal(sv, tv[:small]) and torch.equal(si, ti[:small])):
        raise RuntimeError("queue_c packed: the 13-row call differs from "
                           "the torch backend")
    (qp, pp, cp), kw = s.kernel_operands(prog, [qb, gb])
    prepared = prog.engine_plan._prepared_patterns(gb)
    if any(x.dtype != torch.int32 for x in prepared):
        raise RuntimeError("queue_c packed: the prepared gallery is not "
                           "packed lanes")
    prepared_mb = 1e-6 * sum(x.numel() * x.element_size() for x in prepared)
    got = cam_search.topk_by_packed_distance(qp, pp, cp, **kw)
    want = cam_search.topk_by_packed_distance_reference(qp, pp, cp, **kw)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("queue_c packed: wrapper and plain version "
                           "differ")
    del got, want
    n_valid = kw["n_valid"]
    parts = {}
    for rows in (qp.shape[0], small):
        qr = qp[:rows].contiguous()
        d = cam_search.packed_distance(qr, pp, cp)
        if not torch.equal(d, cam_search.packed_distance_reference(qr, pp,
                                                                   cp)):
            raise RuntimeError(f"queue_c packed: packed_distance differs "
                               f"from its plain version at {rows} rows")
        sel = _select_part(s, f"packed {rows} rows", d, k, kw["largest"],
                           n_valid)
        del d
        bound, by = s.packed_bound_ms(qr, pp, cp, k, n_valid, "int8")
        dbound, dby = s.packed_distance_bound_ms(qr, pp, cp)
        ones = torch.ones(qr.shape[1] * 32, device=qr.device)
        qpm = 2 * ops_unpack(qr) - 1
        gpm = 2 * ops_unpack(pp) - 1
        dim = float(qpm.shape[1])
        pd_route = cam_search.packed_distance_route(
            rows, pp.shape[0], pp.shape[1], s.props.multi_processor_count,
            cp is not None)
        pd_call = lambda: cam_search.packed_distance(qr, pp, cp)  # noqa: E731
        parts[rows] = {
            "ms": cuda_ms(lambda: cam_search.topk_by_packed_distance(
                qr, pp, cp, **kw), 10),
            "plain_ms": cuda_ms(
                lambda: cam_search.topk_by_packed_distance_reference(
                    qr, pp, cp, **kw), 3),
            "library_ms": cuda_ms(lambda: torch.matmul(qpm, gpm.T).topk(k),
                                  3),
            "bound_ms": bound, "bound_by": by,
            "packed_distance": {
                "route": pd_route.name, "query_rows": pd_route.rows,
                "grid": pd_route.grid,
                "ms": cuda_ms(pd_call, 20),
                "device_ms": device_ms_per_call(pd_call, 20),
                "plain_ms": cuda_ms(
                    lambda: cam_search.packed_distance_reference(qr, pp, cp),
                    3),
                "library_ms": cuda_ms(lambda: torch.addmm(
                    ones[:1] * (dim / 2), qpm, gpm.T, alpha=-0.5), 5),
                "bound_ms": dbound, "bound_by": dby,
                "bit_identical_to_plain": True},
            "topk_select": sel}
        del qpm, gpm, ones
        torch.cuda.empty_cache()
    big, sm = parts[qp.shape[0]], parts[small]
    s.record("distance_topk_packed",
             "src/repro_torch/kernels/csrc/packed_distance.cu",
             "src/repro/kernels/cam_search.py:304", counts["packed_distance"],
             0.0, big["ms"], big["plain_ms"], big["bound_ms"],
             big["bound_by"], big["library_ms"])
    s.kernels["distance_topk_packed"].update(
        kernel_route="matrix: K1p (packed_distance.cu, int8 wgmma on the "
                     "packed lanes) writes the (M, N) matrix, K1s "
                     "(topk_select.cu) selects",
        bound_basis="int8 tensor cores, 1,979 TOPS, on the packed lanes; "
                    "the output (M, k) values and indices",
        library_note="+-1 float matmul + topk",
        prepared_mb=prepared_mb, rows_13=sm,
        shape={"q": list(qp.shape), "p": list(pp.shape), "k": k})
    pd = big["packed_distance"]
    s.record("packed_distance",
             "src/repro_torch/kernels/csrc/packed_distance.cu",
             "src/repro/kernels/cam_search.py:304",
             counts["packed_distance"] + small_counts["packed_distance"],
             0.0, pd["ms"], pd["plain_ms"], pd["bound_ms"], pd["bound_by"],
             pd["library_ms"])
    s.kernels["packed_distance"].update(
        kernel_route="int8 wgmma on lanes unpacked in shared memory, "
                     "packed_distance_route: 'swapped' (queries as wgmma's N) "
                     "up to 64 queries, else persistent 128 x 128 tiles, the "
                     "query tile resident up to 32 lanes, warp-specialised "
                     "unpacking, the stores overlapping the next tile",
        bound_basis="the larger of the int8 products at 1,979 TOPS and the "
                    "lanes read and (M, N) float32 written at 3.35 TB/s",
        library_note="addmm of the unpacked +-1 cells: (D - q.p) / 2",
        rows_13=sm["packed_distance"])
    s.kernels["topk_select"]["launches"] += counts["topk_select"] + \
        small_counts["topk_select"]
    s.kernels["topk_select"].update(packed=big["topk_select"],
                                    packed_13_rows=sm["topk_select"])
    return {"k": k, "route": route, "launches": counts,
            "launches_13_rows": small_counts,
            "bit_identical_to_torch_backend": True,
            "wrapper_bit_identical_to_plain": True,
            "prepared_mb": prepared_mb, "torch_backend_ms": torch_ms,
            "rows_624": big, "rows_13": sm}


def ops_unpack(lanes):
    """{0, 1} float32 cells of int32 lanes (LSB first)."""
    from repro_torch.kernels.packing import LANE_BITS, unpack_bits
    return unpack_bits(lanes, lanes.shape[1] * LANE_BITS).float()


def _queue_c_hdc(s: Smoke):
    """C3: B5 where it refused before — 65,536 features (a 256 x 256
    image) to 8192 dims, 512 levels, and 2,100,000 rows in one call —
    each through ``ItemMemory.encode`` on the card, bit-identical to the
    plain version; and HDC/MNIST-8k's test set on the bit-sliced route."""
    import numpy as np
    import torch
    from repro_torch.hdc import ItemMemory
    from repro_torch.kernels import cam_search
    from repro_torch.kernels import hdc_encode as khdc
    out = {}
    rng = np.random.default_rng(21)
    for name, (m, f, h, levels, expect) in QUEUE_C_HDC.items():
        item = ItemMemory(f, dim=h, n_levels=levels, seed=5)
        x = rng.random((m, f), dtype=np.float32)
        cam_search.reset_launch_counts()
        enc_ms, enc = host_ms(lambda: item.encode(x))
        counts = dict(cam_search.LAUNCHES)
        route = khdc.hdc_route(f, levels)
        want_key = "hdc_encode" if route == "bitsliced" else \
            "hdc_encode_wide"
        s.only(f"queue_c {name}", counts, want_key, 1)
        if route != expect:
            raise RuntimeError(f"queue_c {name}: route {route}, expected "
                               f"{expect}")
        q = item.level_ids(x)
        want = khdc.hdc_encode_reference(q, item._keys_t, item._levels_t)
        if not torch.equal(enc, want) or enc.shape != (m, h):
            raise RuntimeError(f"queue_c {name}: the encoding differs from "
                               f"the plain version")
        del want
        ms = cuda_ms(lambda: khdc.hdc_encode_planes(q, item._planes), 5)
        bound, by = s.hdc_bound_ms(q, item._planes)
        entry = {"rows": m, "features": f, "dim": h, "levels": levels,
                 "route": route, "launches": counts[want_key],
                 "encode_host_ms": enc_ms, "ms": ms, "bound_ms": bound,
                 "bound_by": by, "bit_identical_to_plain": True,
                 "output_gb": 4e-9 * m * h}
        if name == "wide_features":
            plain_ms = cuda_ms(lambda: khdc.hdc_encode_reference(
                q, item._keys_t, item._levels_t), 3)
            entry["plain_ms"] = plain_ms
            s.record("hdc_encode_wide",
                     "src/repro_torch/kernels/csrc/hdc_encode.cu",
                     "src/repro/kernels/hdc_encode.py:87", 0, 0.0, ms,
                     plain_ms, bound, by, None)
            rec = s.kernels["hdc_encode_wide"]
            per_step = hdc_logical_ops(hdc_count_bits(f), False)
            rec.update(kernel_route="32 count planes (F >= 2**16); level "
                                    "planes from global memory past 476 "
                                    "levels",
                       library_note="no single PyTorch call computes a "
                                    "signed gathered bundle",
                       shape={"q": [m, f], "dim": h, "levels": levels},
                       bound_basis=f"{per_step} LOP3 per (row, feature, "
                                   f"word) at 64 a clock per SM, "
                                   f"{hdc_count_bits(f)} count planes")
        if route != "bitsliced":
            s.kernels["hdc_encode_wide"]["launches"] += counts[want_key]
        else:
            s.record("hdc_encode", "src/repro_torch/kernels/csrc/hdc_encode.cu",
                     "src/repro/kernels/hdc_encode.py:87", counts[want_key],
                     0.0, None, None, None, "operations", None)
        out[name] = entry
        del item, x, enc, q
        torch.cuda.empty_cache()
    return out


def phase_queue_c(s: Smoke, data):
    """The repaired refusals on the card: C1 (k > MAX_K on the default
    backend: B6 or K1p, then K1s; eucl k = 500 and packed hamming k = 400
    at the KNN shape, and a 13-row micro-batch) and C3 (B5 at 65,536
    features, 512 levels and 2,100,000 rows), each part's launch counts
    set to 0 before it and read after it."""
    import torch
    parts = {}
    for name, run in (("eucl_k500", lambda: _queue_c_eucl(s, data)),
                      ("hamming_k400", lambda: _queue_c_packed(s, data)),
                      ("hdc", lambda: _queue_c_hdc(s))):
        t0 = time.perf_counter()
        parts[name] = run()
        parts[name]["part_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    log({"phase": "queue_c", "ok": True, **parts})


# ---------------------------------------------------------------------------
# lm_serve: LM serving of qwen2.5-14b through the port's Server (B7)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# cam_serve: the single-device CAM search server, faults and hardening
# ---------------------------------------------------------------------------


def _serve_blocks(srv, q, requests=CAM_REQUESTS, rows=CAM_ROWS):
    """CAM_CLIENTS threads, each submitting ``requests`` blocks of
    ``rows`` consecutive rows of host queries ``q`` one after another.
    Returns the stacked (values, indices) in query order, each request's
    latency, and the wall seconds of the whole run."""
    import threading
    import numpy as np
    per = requests * rows
    if CAM_CLIENTS * per != q.shape[0]:
        raise RuntimeError(f"serve: {CAM_CLIENTS} x {per} rows do not "
                           f"cover the {q.shape[0]} queries")
    out, lat, errs = {}, [], []

    def client(c):
        try:
            for j in range(requests):
                s0 = c * per + j * rows
                res = srv.submit(q[s0:s0 + rows]).wait(CAM_WAIT_S)
                if res.error is not None:
                    raise res.error
                out[s0] = (res.values, res.indices)
                lat.append(res.latency_s)
        except Exception as e:      # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CAM_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(CAM_WAIT_S)
    wall = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serve: a client failed or hung: {errs[:1]}")
    keys = sorted(out)
    return (np.concatenate([out[k][0] for k in keys]),
            np.concatenate([out[k][1] for k in keys]), lat, wall)


def _server_health(name, srv):
    """The server's snapshot; fails unless every batch was served by the
    primary (the degraded chain must never hide a failing kernel)."""
    h, snap = srv.health(), srv.snapshot()
    if h["degraded_batches"] or h["backend_errors"] or \
            h["breaker"]["state"] != "closed":
        raise RuntimeError(f"{name}: served degraded: {h}")
    return snap


def _latency_ms(lat):
    import numpy as np
    return {"p50": 1e3 * float(np.percentile(lat, 50)),
            "p99": 1e3 * float(np.percentile(lat, 99)),
            "max": 1e3 * max(lat), "requests": len(lat)}


def _snapshot_log(snap):
    keep = ("requests", "queries", "batches", "avg_batch_fill", "p50_ms",
            "p95_ms", "p99_ms", "queue_wait_p50_ms", "service_p50_ms",
            "dispatch_p50_ms", "dispatch_p95_ms", "dispatch_p99_ms",
            "gallery_updates", "rows_updated", "degraded_batches",
            "backend_errors")
    return {k: snap[k] for k in keep if k in snap}


def _cam_serve_knn(s: Smoke, data):
    """(a) the KNN eucl program served: B2."""
    import numpy as np
    import torch
    from repro_torch.core import ArchSpec, compile_fn
    from repro_torch.kernels import cam_search
    from repro_torch.serving import CamSearchServer
    g, _, q, _ = data
    gt = torch.from_numpy(g).cuda()
    prog = compile_fn(knn_kernel, [q, g], ArchSpec(rows=64, cols=64),
                      value_bits=8)
    plan = prog.engine_plan
    warm_ms, _ = host_ms(lambda: plan.warm(gt))
    cam_search.reset_launch_counts()
    with CamSearchServer(prog, gt, max_wait_ms=2.0) as srv:
        v, i, lat, wall = _serve_blocks(srv, q)
        snap = _server_health("cam_serve knn", srv)
    counts = dict(cam_search.LAUNCHES)
    if counts["fused_topk"] != snap["batches"]:
        raise RuntimeError(f"cam_serve knn: {snap['batches']} batches but "
                           f"launches {counts}")
    direct_ms, (dv, di) = host_ms(lambda: plan.execute(q, gt))
    if not (np.array_equal(v, dv.cpu().numpy())
            and np.array_equal(i, di.cpu().numpy())):
        raise RuntimeError("cam_serve knn: served results differ from the "
                           "plan's direct call")
    prev = s.topk.get("knn_eucl")
    if prev is not None and not (torch.equal(dv, prev[0])
                                 and torch.equal(di, prev[1])):
        raise RuntimeError("cam_serve knn: the direct call differs from "
                           "knn_eucl's")
    # a batch of the served size: the host's dispatch (no wait for the
    # device, so a hidden synchronise would show as host time near the
    # device time) against the device time of the batch's work
    rows = CAM_CLIENTS * CAM_ROWS
    dispatch_host_ms = host_ms_per_call(lambda: plan.dispatch(q[:rows], gt),
                                        20)
    batch_device_ms = cuda_ms(lambda: plan.finalize(plan.dispatch(
        q[:rows], gt)), 20)
    s.record("fused_topk", "src/repro_torch/kernels/csrc/fused_topk.cu",
             "src/repro/kernels/cam_search.py:200", counts["fused_topk"],
             0.0, None, None, None, "operations", None)
    return counts, {"launches": counts, "served_wall_ms": 1e3 * wall,
                    "batch_rows": rows,
                    "dispatch_host_ms": dispatch_host_ms,
                    "batch_device_ms": batch_device_ms,
                    "direct_wall_ms": direct_ms, "warm_ms": warm_ms,
                    "batches": snap["batches"],
                    "rows_per_batch": snap["avg_batch_fill"],
                    "latency_ms": _latency_ms(lat),
                    "snapshot": _snapshot_log(snap),
                    "bit_identical_to_direct": True}


def _packed_plan(data):
    """The hamming top-10 program of ``hamming_packed`` (packed) and the
    binarised KNN data on the card."""
    import torch
    import repro_torch.core as T
    from repro_torch.core import ArchSpec, compile_module
    from repro_torch.core import cim_dialect as cd
    g, _, q, _ = data
    gb = (torch.from_numpy(g).cuda() > 0).float()
    qb = (q > 0).astype("float32")
    prog = compile_module(hamming_module(T, cd, q.shape[0], g.shape[0],
                                         g.shape[1], 10, False),
                          ArchSpec(rows=64, cols=64), value_bits=1)
    if not prog.engine_plan.packed:
        raise RuntimeError("cam_serve: the hamming plan is not packed")
    return prog.engine_plan, qb, gb


def _cam_serve_faulted(s: Smoke, plan, qb, gb):
    """(b) a faulted packed hamming server: B1 on the corrupted gallery."""
    import numpy as np
    import torch
    from repro_torch.core.engine.executables import _cuda_operands
    from repro_torch.faults import FaultModel
    from repro_torch.kernels import cam_search, ops
    from repro_torch.serving import CamSearchServer
    fm = FaultModel(**CAM_SERVE_FAULTS)
    warm_ms, _ = host_ms(lambda: plan.warm(gb, faults=fm))
    cam_search.reset_launch_counts()
    qu = qb[:CAM_ROWS]
    with CamSearchServer(plan, gb, max_wait_ms=2.0, fault_model=fm) as srv:
        v, i, lat, wall = _serve_blocks(srv, qb)
        cells = srv.health()["fault_model"]["cells"]
        update = _faulted_update(srv, plan, qu)
        snap = _server_health("cam_serve faulted", srv)
        updated = srv.gallery
    counts = dict(cam_search.LAUNCHES)
    if counts["fused_topk_packed"] != snap["batches"]:
        raise RuntimeError(f"cam_serve faulted: {snap['batches']} batches "
                           f"but launches {counts}")
    want = tuple(x.cpu().numpy() for x in plan.execute(qu, updated,
                                                        faults=fm))
    for got in update.pop("results"):
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError("cam_serve faulted: a search after the live "
                               "update differs from plan.execute(faults=) "
                               "on the updated gallery")
    del updated
    dv, di = (x.cpu().numpy() for x in plan.execute(qb, gb, faults=fm))
    if not (np.array_equal(v, dv) and np.array_equal(i, di)):
        raise RuntimeError("cam_serve faulted: served results differ from "
                           "plan.execute(faults=)")
    # B1's plain version on the host-corrupted gallery, merged as the
    # engine merges
    corrupt_ms, (bad,) = host_ms(lambda: fm.corrupt_stored(
        (gb.cpu().numpy(),), plan.spec))
    pp = plan._prepare(torch.from_numpy(bad).cuda())
    args, kw = _cuda_operands(plan.spec, True, torch.from_numpy(qb).cuda(),
                              pp)
    pv, pi = ops._merge(*cam_search.fused_topk_packed_reference(*args, **kw),
                        kw["k"], kw["largest"])
    if not (np.array_equal(v, pv.cpu().numpy())
            and np.array_equal(i, pi.cpu().numpy())):
        raise RuntimeError("cam_serve faulted: served results differ from "
                           "B1's plain version on the corrupted gallery")
    clean = plan.execute(qb, gb)
    null = plan.execute(qb, gb, faults=FaultModel(p_stuck=0))
    if not (torch.equal(clean[0], null[0]) and torch.equal(clean[1], null[1])):
        raise RuntimeError("cam_serve faulted: FaultModel(p_stuck=0) differs "
                           "from faults=None")
    changed = int((clean[1].cpu().numpy() != i).any(axis=1).sum())
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts["fused_topk_packed"], 0.0, None, None, None,
             "operations", None)
    return counts, {"launches": counts, "model": CAM_SERVE_FAULTS,
                    "cells": cells, "warm_ms": warm_ms,
                    "host_corruption_ms": corrupt_ms,
                    "served_wall_ms": 1e3 * wall,
                    "batches": snap["batches"],
                    "latency_ms": _latency_ms(lat),
                    "rows_changed_by_faults": changed,
                    "live_update": update,
                    "equal_to_plan_execute_faults": True,
                    "bit_identical_to_b1_plain_on_corrupted": True,
                    "null_model_bit_identical": True}


def _faulted_update(srv, plan, qu):
    """One live ``update_gallery`` of 1 % of the rows on the faulted
    server, then two searches of ``qu``.  The engine's row update
    rewrites only the clean layout, so the first batch after it corrupts
    and prepares the whole gallery again, inside its dispatch and under
    the gallery's read lock: its latency is the stall every client sees.
    The second batch hits the memo."""
    import numpy as np
    n, dim = plan.spec.n, plan.spec.dim
    rng = np.random.default_rng(CAM_SERVE_FAULTS["seed"])
    rows = np.sort(rng.choice(n, int(CAM_UPDATE_FRAC * n), replace=False))
    new = (rng.random((rows.size, dim)) > 0.5).astype(np.float32)
    fb0 = plan.row_update_fallbacks
    update_ms, _ = host_ms(lambda: srv.update_gallery(rows, new))
    first_ms, first = host_ms(lambda: srv.search(qu, timeout=CAM_WAIT_S))
    next_ms, nxt = host_ms(lambda: srv.search(qu, timeout=CAM_WAIT_S))
    return {"rows": int(rows.size), "update_ms": update_ms,
            "first_search_ms": first_ms, "next_search_ms": next_ms,
            "row_update_fallbacks": plan.row_update_fallbacks - fb0,
            "results": [first, nxt]}


def _cam_serve_hardened(s: Smoke, plan, qb, gb):
    """(c) ``HardenedPlan`` search: 3 replicas of the binarised gallery
    (B1 on its int8 "mma" route at k' = 30), top-k agreement with the
    clean result against the raw faulted plan."""
    import dataclasses
    import numpy as np
    from repro_torch.core.engine import get_plan, module_for_spec
    from repro_torch.faults import FaultModel, HardenedPlan
    from repro_torch.kernels import cam_search
    t_part = time.perf_counter()
    reduced = None
    if CAM_HARDEN_ROWS is not None:        # the cut, where one was needed
        reduced = {"gallery_rows": [CAM_HARDEN_ROWS, int(plan.spec.n)]}
        plan = get_plan(module_for_spec(dataclasses.replace(
            plan.spec, n=CAM_HARDEN_ROWS)), backend=plan.backend,
            pack=plan.packed)
        gb = gb[:CAM_HARDEN_ROWS].contiguous()
    k = plan.spec.k
    hp = HardenedPlan(plan, replicas=CAM_HARDEN_REPLICAS, spares=0)
    route = cam_search.packed_route(
        qb.shape[0], -(-hp.n_phys // 128) * 128, hp.plan.spec.k,
        s.props.multi_processor_count)
    if route != "mma" or hp.plan.spec.k != CAM_HARDEN_REPLICAS * k:
        raise RuntimeError(f"cam_serve hardened: k'={hp.plan.spec.k} takes "
                           f"B1's {route!r} route")
    prep_ms, _ = host_ms(lambda: hp.prepare(gb))
    corrupt_ms, _ = host_ms(lambda: FaultModel(
        seed=0, **CAM_HARDEN_FAULTS).corrupt_stored(hp._clean, hp.phys_spec))
    one = HardenedPlan(plan, replicas=1, spares=0)
    one.prepare(gb)
    cam_search.reset_launch_counts()
    clean = tuple(x.cpu().numpy() for x in plan.execute(qb, gb))
    got1 = one.execute(qb)
    raw_scores, rep_scores, seed_ms = [], [], []

    def agree(a):
        return float(np.mean([len(set(a[r]) & set(clean[1][r])) / k
                              for r in range(a.shape[0])]))

    for seed in CAM_HARDEN_SEEDS:
        fm = FaultModel(seed=seed, **CAM_HARDEN_FAULTS)
        t0 = time.perf_counter()
        raw = plan.execute(qb, gb, faults=fm)[1].cpu().numpy()
        t1 = time.perf_counter()
        _, rep_i = hp.execute(qb, faults=fm)
        seed_ms.append({"raw_execute_ms": 1e3 * (t1 - t0),
                        "hardened_execute_ms":
                            1e3 * (time.perf_counter() - t1)})
        raw_scores.append(agree(raw))
        rep_scores.append(agree(rep_i))
    counts = dict(cam_search.LAUNCHES)
    if counts["fused_topk_packed"] < 1:
        raise RuntimeError(f"cam_serve hardened: B1 not launched: {counts}")
    if not (np.array_equal(got1[0], clean[0])
            and np.array_equal(got1[1], clean[1])):
        raise RuntimeError("cam_serve hardened: one replica differs from "
                           "the raw plan")
    if not np.mean(rep_scores) > np.mean(raw_scores):
        raise RuntimeError(f"cam_serve hardened: agreement {rep_scores} not "
                           f"above the raw plan's {raw_scores}")
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts["fused_topk_packed"], 0.0, None, None, None,
             "operations", None)
    out = {"launches": counts, "replicas": CAM_HARDEN_REPLICAS,
           "n_phys": hp.n_phys, "k_phys": hp.plan.spec.k, "b1_route": route,
           "prepare_ms": prep_ms, "host_corruption_ms": corrupt_ms,
           "per_seed_ms": seed_ms,
           "agreement_raw": raw_scores, "agreement_hardened": rep_scores,
           "replicas_1_bit_identical": True,
           "part_s": time.perf_counter() - t_part}
    if reduced is not None:
        out["reduced"] = reduced
    del hp, one
    return counts, out


def _cam_serve_forest(s: Smoke):
    """(d) the forest's interval rows served (B3), a live update of 1 % of
    them racing 4 clients, and ``HardenedPlan.heal`` on the intervals."""
    import threading
    import numpy as np
    import torch
    from repro_torch.core import ArchSpec, CamType, clear_plan_cache
    from repro_torch.core.engine import get_plan, module_for_spec
    from repro_torch.faults import FaultModel, HardenedPlan
    from repro_torch.forest import CamForestClassifier, random_forest
    from repro_torch.kernels import cam_search
    from repro_torch.serving import CamSearchServer
    trees = random_forest(np.random.default_rng(7), **FOREST)
    clf = CamForestClassifier(trees, dim=FOREST["dim"]).compile(
        ArchSpec(rows=64, cols=64, cam_type=CamType.ACAM),
        batch_hint=FOREST_QUERIES)
    plan = clf.plan
    n, dim = clf._lo.shape
    x = np.random.default_rng(8).standard_normal(
        (FOREST_QUERIES, FOREST["dim"])).astype(np.float32)
    rng = np.random.default_rng(9)
    rows = np.sort(rng.choice(n, int(CAM_UPDATE_FRAC * n), replace=False))
    new_lo = np.full((rows.size, dim), -np.inf, np.float32)   # wildcards:
    new_hi = np.full((rows.size, dim), np.inf, np.float32)    # match all
    # the comparisons' match matrices: the clean intervals, and the new
    # ones through a fresh plan (a full prepare), before the counted run
    old = plan.execute(x, clf._lo, clf._hi).cpu().numpy()
    lo2, hi2 = clf._lo.clone(), clf._hi.clone()
    ridx = torch.from_numpy(rows).cuda()
    lo2[ridx] = torch.from_numpy(new_lo).cuda()
    hi2[ridx] = torch.from_numpy(new_hi).cuda()
    clear_plan_cache()
    fresh = get_plan(module_for_spec(plan.spec), backend=plan.backend)
    if fresh is plan:
        raise RuntimeError("cam_serve forest: no fresh plan")
    new = fresh.execute(x, lo2, hi2).cpu().numpy()
    del fresh, lo2, hi2
    old_r, new_r = old[:CAM_RACE_ROWS], new[:CAM_RACE_ROWS]
    if np.array_equal(old_r, new_r):
        raise RuntimeError("cam_serve forest: the update is invisible")
    xr = x[:CAM_RACE_ROWS]
    seen, errs = [], []
    stop = threading.Event()

    def racer():
        try:
            while not stop.is_set():
                got = srv.match(xr, timeout=CAM_WAIT_S)
                seen.append("old" if np.array_equal(got, old_r) else
                            "new" if np.array_equal(got, new_r) else "torn")
        except Exception as e:          # noqa: BLE001 — reported below
            errs.append(e)

    cam_search.reset_launch_counts()
    with CamSearchServer(plan, (clf._lo.clone(), clf._hi.clone()),
                         max_wait_ms=2.0) as srv:
        match_ms, before = host_ms(lambda: srv.match(x, timeout=CAM_WAIT_S))
        threads = [threading.Thread(target=racer) for _ in range(CAM_RACERS)]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + CAM_WAIT_S
        while len(seen) < CAM_RACERS and not errs and \
                time.perf_counter() < deadline:
            time.sleep(0.001)
        update_ms, _ = host_ms(lambda: srv.update_gallery(
            rows, (new_lo, new_hi)))
        n_before = len(seen)
        while "new" not in seen[n_before:] and not errs and \
                time.perf_counter() < deadline:
            time.sleep(0.001)
        stop.set()
        for t in threads:
            t.join(CAM_WAIT_S)
        after = srv.match(x, timeout=CAM_WAIT_S)
        snap = _server_health("cam_serve forest", srv)
    if errs or any(t.is_alive() for t in threads):
        raise RuntimeError(f"cam_serve forest: a racer failed: {errs[:1]}")
    served_counts = dict(cam_search.LAUNCHES)
    # heal the clean intervals onto spares, then run under the model
    cam_search.reset_launch_counts()
    hp = HardenedPlan(plan, replicas=CAM_HEAL_REPLICAS,
                      spares=CAM_HEAL_SPARES)
    prep_ms, _ = host_ms(lambda: hp.prepare(clf._lo, clf._hi))
    fm = FaultModel(**CAM_HEAL_FAULTS)
    heal_ms, report = host_ms(lambda: hp.heal(fm))
    healed_ms, healed = host_ms(lambda: hp.execute(x, faults=fm))
    heal_counts = dict(cam_search.LAUNCHES)
    counts = {k: served_counts[k] + heal_counts[k] for k in served_counts}
    if served_counts["acam_match"] != snap["batches"] or \
            heal_counts["acam_match"] < 1:
        raise RuntimeError(f"cam_serve forest: launches {served_counts} "
                           f"{heal_counts}, batches {snap['batches']}")
    if not np.array_equal(before, old):
        raise RuntimeError("cam_serve forest: served matches differ from "
                           "the plan's direct call")
    if not np.array_equal(after, new):
        raise RuntimeError("cam_serve forest: matches after the update "
                           "differ from a fresh plan's on the new intervals")
    n_old, n_new = seen.count("old"), seen.count("new")
    if n_old + n_new != len(seen) or not n_old or not n_new:
        raise RuntimeError(f"cam_serve forest: {len(seen)} racing matches, "
                           f"{n_old} old, {n_new} new: a torn update or an "
                           f"unraced one")
    if not (report.detected > 0 and report.remapped > 0):
        raise RuntimeError(f"cam_serve forest: heal found nothing: {report}")
    healed_equal = None
    if report.unrepairable == 0:
        healed_equal = bool(np.array_equal(healed, old))
        if not healed_equal:
            raise RuntimeError("cam_serve forest: the healed plan under the "
                               "model differs from the clean match matrix")
    s.record("acam_match", "src/repro_torch/kernels/csrc/acam_match.cu",
             "src/repro/kernels/acam.py:121", counts["acam_match"], 0.0,
             None, None, None, "operations", None)
    return counts, {
        "launches": counts, "rows": int(n), "queries": FOREST_QUERIES,
        "match_ms": match_ms, "update_rows": int(rows.size),
        "update_ms": update_ms, "racing_matches": len(seen),
        "racing_old": n_old, "racing_new": n_new,
        "after_update_bit_identical_to_fresh_plan": True,
        "snapshot": _snapshot_log(snap),
        "heal": {"replicas": CAM_HEAL_REPLICAS, "spares": CAM_HEAL_SPARES,
                 "model": CAM_HEAL_FAULTS, "n_phys": hp.n_phys,
                 "report": dict(vars(report)), "prepare_ms": prep_ms,
                 "heal_ms": heal_ms, "execute_ms": healed_ms,
                 "healed_equal_to_clean": healed_equal,
                 "b3_launches": heal_counts["acam_match"]}}


def _cam_serve_hdc(s: Smoke):
    """(e) HDC/MNIST-8k retrained through a live server: B5 encodes, B1
    searches, ``update_gallery`` pushes the rows; equal to offline."""
    import numpy as np
    import torch
    from repro_torch.data import hdc_mnist_dataset
    from repro_torch.hdc import HdcClassifier
    from repro_torch.kernels import cam_search
    from repro_torch.serving import CamSearchServer
    xtr_np, ytr, xte_np, yte = hdc_mnist_dataset(**HDC_MNIST)
    xtr, xte = torch.from_numpy(xtr_np).cuda(), torch.from_numpy(xte_np).cuda()

    def classifier():
        return HdcClassifier(xtr.shape[1], HDC_CLASSES, dim=HDC_DIM,
                             n_levels=HDC_LEVELS, seed=0)

    served = classifier()
    cam_search.reset_launch_counts()
    enc_tr, enc_te = served.encode(xtr), served.encode(xte)
    served.fit(y=ytr, encoded=enc_tr).compile(batch_hint=1024)
    epochs = []
    with CamSearchServer(served.plan, served.gallery,
                         max_wait_ms=1.0) as srv:
        for _ in range(HDC_EPOCHS):
            ms, (acc, pushed) = host_ms(lambda: served.retrain_epoch(
                encoded=enc_tr, y=ytr, server=srv))
            epochs.append({"train_accuracy_before": acc,
                           "rows_pushed": pushed, "epoch_ms": ms})
        _, idx = srv.search(enc_te, timeout=CAM_WAIT_S)
        snap = _server_health("cam_serve hdc", srv)
    counts = dict(cam_search.LAUNCHES)
    if counts["hdc_encode"] != 2 or counts["fused_topk_packed"] < 1:
        raise RuntimeError(f"cam_serve hdc: launches {counts}")
    offline = classifier()
    offline.fit(y=ytr, encoded=enc_tr).compile(batch_hint=1024)
    want = [offline.retrain_epoch(encoded=enc_tr, y=ytr)
            for _ in range(HDC_EPOCHS)]
    pred = offline.predict(encoded=enc_te).cpu().numpy()
    if [(e["train_accuracy_before"], e["rows_pushed"]) for e in epochs] \
            != want:
        raise RuntimeError(f"cam_serve hdc: served epochs {epochs} differ "
                           f"from offline {want}")
    if not torch.equal(served.class_sums, offline.class_sums):
        raise RuntimeError("cam_serve hdc: class sums differ from offline")
    if not np.array_equal(idx[:, 0].astype(np.int32), pred):
        raise RuntimeError("cam_serve hdc: test predictions differ from "
                           "offline")
    if snap["plan"]["row_update_fallbacks"] or \
            sum(e["rows_pushed"] for e in epochs) == 0:
        raise RuntimeError(f"cam_serve hdc: updates {snap['plan']}, "
                           f"epochs {epochs}")
    s.record("hdc_encode", "src/repro_torch/kernels/csrc/hdc_encode.cu",
             "src/repro/kernels/hdc_encode.py:87", counts["hdc_encode"], 0.0,
             None, None, None, "operations", None)
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts["fused_topk_packed"], 0.0, None, None, None,
             "operations", None)
    return counts, {"launches": counts, "epochs": epochs,
                    "test_accuracy": float((pred == yte).mean()),
                    "snapshot": _snapshot_log(snap),
                    "row_update_fallbacks": 0,
                    "class_sums_equal_offline": True,
                    "predictions_equal_offline": True}


def phase_cam_serve(s: Smoke, data):
    """The serving slice: the KNN eucl program served to concurrent
    clients (B2), a faulted packed hamming server (B1), hardened search
    (B1), the forest's intervals served with a live update and healed
    (B3), and HDC retrained against the server (B5, B1).  Each part sets
    the launch counts to 0 before its path and reads them after it."""
    import torch
    parts = {}
    t0 = time.perf_counter()
    _, parts["knn"] = _cam_serve_knn(s, data)
    parts["knn"]["part_s"] = time.perf_counter() - t0
    plan, qb, gb = _packed_plan(data)
    t0 = time.perf_counter()
    _, parts["faulted"] = _cam_serve_faulted(s, plan, qb, gb)
    parts["faulted"]["part_s"] = time.perf_counter() - t0
    _, parts["hardened"] = _cam_serve_hardened(s, plan, qb, gb)
    del gb
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, parts["forest"] = _cam_serve_forest(s)
    parts["forest"]["part_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, parts["hdc"] = _cam_serve_hdc(s)
    parts["hdc"]["part_s"] = time.perf_counter() - t0
    log({"phase": "cam_serve", "ok": True, **parts})


def clustered_gallery(rng, n, dim, centers, flip=HIER_FLIP):
    """Binary rows drawn around ``centers`` prototypes, as
    ``benchmarks/bench_hier.py::_clustered_gallery`` draws them (that
    module imports JAX, so the smoke keeps its own copy)."""
    protos = (rng.random((centers, dim)) > 0.5)
    owner = rng.integers(centers, size=n)
    rows = protos[owner] ^ (rng.random((n, dim)) < flip)
    return rows.astype("float32")


def _hier_fresh(plan, hs, gallery, assign):
    """Results source for "a fresh plan with the same centroids": the
    state a full layout builds for ``assign`` with ``hs``'s centroids."""
    from repro_torch.core.engine import hier
    return hier._hier_state(plan.spec, plan.packed, gallery, hs.centroid_src,
                            hs.coarse_prepared, assign)


def _recall(got_i, want_i, k):
    got, want = got_i.cpu().numpy(), want_i.cpu().numpy()
    return float(sum(len(set(map(int, a)) & set(map(int, b)))
                     for a, b in zip(got, want)) / (k * want.shape[0]))


def _wall_ms(call):
    """Median host ms of ``call`` to a synchronise, after one warm call."""
    import torch
    call()
    times = []
    for _ in range(HIER_TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _stage_ms(plan, q, g):
    """The ``hier.coarse`` / ``hier.probe`` spans of one traced call (each
    stage waits for its device work while tracing)."""
    import torch
    from repro_torch.obs import trace
    trace.tracer.clear()
    trace.enable()
    try:
        plan.execute(q, g)
        torch.cuda.synchronize()
    finally:
        trace.stop()
    st = trace.span_stats()
    trace.tracer.clear()
    return {k: st[span]["total_ms"] for k, span in
            (("coarse_ms", "hier.coarse"), ("probe_ms", "hier.probe"))
            if span in st}


def _probe_bound(plan, q, hs):
    """The probe's least time: the bytes of the tiles this run's queries
    probe (each query's occupied tiles of its nprobe clusters, read once)
    over the card's memory rate."""
    _, ci = plan.coarse._chunk_fn(q, hs.coarse_prepared)
    tiles = int(hs.cnt[ci.long()].sum())
    leaf = hs.leaves[0]
    tile_bytes = leaf[0].numel() * leaf.element_size()
    return {"probed_tiles": tiles, "tile_bytes": tile_bytes,
            "bound_ms": 1e3 * tiles * tile_bytes / HBM_BYTES_PER_S,
            "bound_by": "bytes"}


def _hier_kernels_idle(name):
    """Fail if the hierarchical plan launched a hand-written kernel: it
    runs the "torch" backend (its twin of the reference's "jnp")."""
    from repro_torch.kernels import cam_search
    if any(cam_search.LAUNCHES.values()):
        raise RuntimeError(f"{name}: the hierarchical path launched "
                           f"kernels: {dict(cam_search.LAUNCHES)}")


def _hier_bench(s: Smoke):
    """(a) the reference's hierarchical benchmark geometry: packed hamming
    over a clustered 131,072 x 256 gallery, flat B1 as the oracle."""
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.core import ArchSpec, compile_module
    from repro_torch.core import cim_dialect as cd
    from repro_torch.core.engine import get_hierarchical_plan, hier
    from repro_torch.kernels import cam_search
    rng = np.random.default_rng(0)
    g = clustered_gallery(rng, HIER_N, HIER_DIM, HIER_CENTERS)
    qi = rng.choice(HIER_N, size=HIER_QUERIES, replace=False)
    q = (g[qi].astype(bool)
         ^ (rng.random((HIER_QUERIES, HIER_DIM)) < HIER_FLIP)) \
        .astype(np.float32)
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    prog = compile_module(hamming_module(T, cd, HIER_QUERIES, HIER_N,
                                         HIER_DIM, HIER_K, False),
                          ArchSpec(rows=128, cols=128), value_bits=1)
    flat, mod = prog.engine_plan, prog.stages["cim_partitioned"]
    if not flat.packed or flat.backend != "cuda":
        raise RuntimeError("hier_search: the flat plan is not packed B1")
    cam_search.reset_launch_counts()
    fv, fi = flat.execute(qt, gt)                     # the flat oracle
    oracle = cam_search.LAUNCHES["fused_topk_packed"]
    tv, ti = T.get_plan(mod, backend="torch").execute(qt, gt)
    if not (torch.equal(fv, tv) and torch.equal(fi, ti)):
        raise RuntimeError("hier_search: flat B1 != flat torch")
    flat_ms = _wall_ms(lambda: flat.execute(qt, gt))
    out = {"oracle_launches": {"fused_topk_packed": oracle},
           "flat_b1_wall_ms": flat_ms,
           "flat_profile": s.profile(flat.execute, [qt, gt]), "nprobe": {}}
    plans = {}
    for nprobe in HIER_NPROBES + (HIER_CLUSTERS,):
        plan = get_hierarchical_plan(mod, clusters=HIER_CLUSTERS,
                                     nprobe=nprobe, kmeans_iters=HIER_ITERS)
        plans[nprobe] = plan
        cam_search.reset_launch_counts()
        prep_ms, _ = host_ms(lambda: plan.warm(gt))
        hs = plan._prepared_patterns(gt)
        v, i = plan.execute(qt, gt)
        torch.cuda.synchronize()
        _hier_kernels_idle(f"hier_search nprobe={nprobe}")
        rec = {"prepare_s": prep_ms / 1e3, "budget": hs.budget,
               "tpc": hs.tpc, "recall": _recall(i, fi, HIER_K)}
        if nprobe == HIER_CLUSTERS:
            if not (torch.equal(v, fv) and torch.equal(i, fi)):
                raise RuntimeError("hier_search: nprobe = clusters is not "
                                   "bit-identical to flat B1")
            rec["bit_identical_to_flat_b1_and_torch"] = True
        rec["wall_ms"] = _wall_ms(lambda: plan.execute(qt, gt))
        rec["stages"] = _stage_ms(plan, qt, gt)
        rec["profile"] = s.profile(plan.execute, [qt, gt])
        rec["probe_bound"] = _probe_bound(plan, qt, hs)
        out["nprobe"][nprobe] = rec
    recalls = [out["nprobe"][n]["recall"] for n in HIER_NPROBES] + [1.0]
    if any(a > b for a, b in zip(recalls, recalls[1:])) or \
            out["nprobe"][HIER_CLUSTERS]["recall"] != 1.0:
        raise RuntimeError(f"hier_search: recall not monotone: {recalls}")
    cents = [plans[n]._prepared_patterns(gt).centroid_src for n in plans]
    if not all(torch.equal(c, cents[0]) for c in cents):
        raise RuntimeError("hier_search: one seed gave different centroids")

    # (c) served: the nprobe-8 plan behind a CamSearchServer, 8 clients
    plan = plans[HIER_SERVE_NPROBE]
    from repro_torch.serving import CamSearchServer
    cam_search.reset_launch_counts()
    dv, di = plan.execute(qt, gt)
    with CamSearchServer(plan, gt, max_wait_ms=2.0) as srv:
        sv, si, lat, wall = _serve_blocks(srv, q, HIER_SERVE_REQUESTS,
                                          HIER_SERVE_ROWS)
        snap = _server_health("hier_search served", srv)
        if [name for name, _ in srv._levels()] != ["primary"]:
            raise RuntimeError("hier_search: a server on the card has a "
                               "degraded level below its primary")
    if not (np.array_equal(sv, dv.cpu().numpy())
            and np.array_equal(si, di.cpu().numpy())):
        raise RuntimeError("hier_search: served results differ from the "
                           "plan's direct call")
    out["served"] = {"nprobe": HIER_SERVE_NPROBE,
                     "served_wall_ms": 1e3 * wall,
                     "batches": snap["batches"],
                     "rows_per_batch": snap["avg_batch_fill"],
                     "latency_ms": _latency_ms(lat),
                     "snapshot": _snapshot_log(snap),
                     "bit_identical_to_direct": True}

    # the row update: 1 % of the rows, reassigned to the stored centroids
    rs = np.random.default_rng(21)
    n_upd = int(round(HIER_UPDATE_FRAC * HIER_N))
    idx = np.sort(rs.choice(HIER_N, size=n_upd, replace=False))
    src = rs.choice(HIER_N, size=n_upd, replace=False)
    new = (g[src].astype(bool)
           ^ (rs.random((n_upd, HIER_DIM)) < HIER_FLIP)).astype(np.float32)
    hs0 = plan._prepared_patterns(gt)
    fb = plan.row_update_fallbacks
    upd_ms, g2 = host_ms(lambda: plan.update_rows(gt, idx, new))
    hs1 = plan._prepared_patterns(g2)
    want_a = hs0.assign.copy()
    want_a[idx] = hier._assign_rows(torch.from_numpy(new).cuda(),
                                    hs0.centroid_src, "hamming")
    fresh = _hier_fresh(plan, hs0, g2, want_a)
    got = plan.execute(qt, g2)
    want = plan._chunk_fn(qt, fresh)
    if plan.row_update_fallbacks != fb or \
            not np.array_equal(hs1.assign, want_a) or \
            not (torch.equal(got[0], want[0])
                 and torch.equal(got[1], want[1])):
        raise RuntimeError("hier_search: the row update differs from a "
                           "fresh layout with the same centroids")
    moved = int((hs1.assign != hs0.assign).sum())
    # ... then rows copied from one row, past its cluster's capacity
    idx2 = np.arange(HIER_OVERFLOW_ROWS)
    new2 = np.tile(g[HIER_N - 1], (HIER_OVERFLOW_ROWS, 1))
    ovf_ms, g3 = host_ms(lambda: plan.update_rows(g2, idx2, new2))
    hs2 = plan._prepared_patterns(g3)
    want_a[idx2] = hier._assign_rows(torch.from_numpy(new2).cuda(),
                                     hs0.centroid_src, "hamming")
    got = plan.execute(qt, g3)
    want = plan._chunk_fn(qt, _hier_fresh(plan, hs0, g3, want_a))
    if hs2.tpc <= hs1.tpc or hs2.centroid_src is not hs0.centroid_src or \
            plan.row_update_fallbacks != fb or \
            not (torch.equal(got[0], want[0])
                 and torch.equal(got[1], want[1])):
        raise RuntimeError("hier_search: the overflow re-layout differs "
                           "from a fresh layout with the same centroids")
    _hier_kernels_idle("hier_search served and updated")
    out["update"] = {"rows": n_upd, "moved_rows": moved,
                     "update_ms": upd_ms, "budget_after": hs1.budget,
                     "equal_to_fresh_layout": True,
                     "overflow_rows": HIER_OVERFLOW_ROWS,
                     "overflow_ms": ovf_ms, "tpc": [hs1.tpc, hs2.tpc],
                     "overflow_equal_to_fresh_layout": True,
                     "row_update_fallbacks": plan.row_update_fallbacks - fb}
    return out


def _hier_eucl(s: Smoke, data):
    """(b) eucl at the KNN shape against flat B2: default clusters,
    nprobe = clusters // 8 and nprobe = clusters."""
    import torch
    from repro_torch.core import ArchSpec, compile_fn
    from repro_torch.core.engine import get_hierarchical_plan
    from repro_torch.kernels import cam_search
    g, _, q, _ = data
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    prog = compile_fn(knn_kernel, [q, g], ArchSpec(rows=64, cols=64),
                      value_bits=8)
    flat, mod = prog.engine_plan, prog.stages["cim_partitioned"]
    cam_search.reset_launch_counts()
    fv, fi = flat.execute(qt, gt)                     # the flat oracle
    out = {"oracle_launches": {"fused_topk": cam_search.LAUNCHES[
        "fused_topk"]},
           "flat_b2_wall_ms": _wall_ms(lambda: flat.execute(qt, gt))}
    full = get_hierarchical_plan(mod, nprobe=10 ** 9)
    clusters = full.spec.clusters
    part = get_hierarchical_plan(mod, nprobe=clusters // 8)
    out.update(clusters=clusters, reduced=[])
    cam_search.reset_launch_counts()
    prep_ms, _ = host_ms(lambda: part.warm(gt))
    hs = part._prepared_patterns(gt)
    again = part._prepare(gt)             # a second prepare of one gallery
    if not (torch.equal(again.centroid_src, hs.centroid_src)
            and (again.assign == hs.assign).all()):
        raise RuntimeError("hier_search: two prepares of the KNN gallery "
                           "gave different centroids")
    del again
    sizes = torch.bincount(torch.from_numpy(hs.assign).long(),
                           minlength=clusters)
    for name, plan in (("partial", part), ("all", full)):
        if plan is full:
            plan.warm(gt)
        t_ms, (v, i) = host_ms(lambda: plan.execute(qt, gt))
        _hier_kernels_idle(f"hier_search eucl {name}")
        st = plan._prepared_patterns(gt)
        qw = qt
        if t_ms > 1e3 * HIER_EUCL_LIMIT_S:        # time the cut queries
            qw = qt[:HIER_EUCL_CUT_ROWS]
            out["reduced"].append(f"{name}: timed on {HIER_EUCL_CUT_ROWS} "
                                  f"of {qt.shape[0]} queries (one call of "
                                  f"all took {t_ms / 1e3:.1f} s)")
        rec = {"nprobe": plan.spec.nprobe, "first_call_ms": t_ms,
               "budget": st.budget, "tpc": st.tpc,
               "recall": _recall(i, fi, 5), "timed_rows": qw.shape[0],
               "wall_ms": _wall_ms(lambda: plan.execute(qw, gt)),
               "stages": _stage_ms(plan, qw, gt),
               "probe_bound": _probe_bound(plan, qw, st)}
        if plan is full:
            off = (v - fv).abs()
            if not bool((off <= EUCL_ATOL + EUCL_RTOL * fv.abs()).all()):
                raise RuntimeError(f"hier_search: eucl off flat B2 by "
                                   f"{float(off.max())}")
            rec["max_abs_err_vs_flat_b2"] = float(off.max())
            rec["eucl_index_swaps"] = eucl_index_swaps(
                qt, gt, i, fi, "hier_search eucl nprobe = clusters")
        out[name] = rec
    out.update(prepare_s=prep_ms / 1e3, centroids_repeat=True,
               cluster_rows={"max": int(sizes.max()),
                             "mean": float(sizes.float().mean()),
                             "empty": int((sizes == 0).sum())})
    return out


def phase_hier_search(s: Smoke, data):
    """The hierarchical two-stage search on the "torch" backend (no
    hand-written kernel on its path): (a) the reference's benchmark
    geometry against flat B1, with (c) the served nprobe-8 plan and the
    row updates; (b) eucl at the KNN shape against flat B2.  B1 and B2
    launch only as the flat oracles (counted from 0 around each oracle
    call), and every hierarchical call is checked to launch no kernel."""
    import torch
    parts = {}
    t0 = time.perf_counter()
    parts["bench"] = _hier_bench(s)
    parts["bench"]["part_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parts["eucl"] = _hier_eucl(s, data)
    parts["eucl"]["part_s"] = time.perf_counter() - t0
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             parts["bench"]["oracle_launches"]["fused_topk_packed"], 0.0,
             None, None, None, "operations", None)
    s.record("fused_topk", "src/repro_torch/kernels/csrc/fused_topk.cu",
             "src/repro/kernels/cam_search.py:200",
             parts["eucl"]["oracle_launches"]["fused_topk"], 0.0, None,
             None, None, "operations", None)
    log({"phase": "hier_search", "ok": True, **parts})


# ---------------------------------------------------------------------------
# sharded: shard counts clamp; 4 shards on cuda:0 stand-ins
# ---------------------------------------------------------------------------


def _sharded_pair(name, one, sh, qt, gt, integer):
    """One unsharded and one sharded ``"torch"`` plan on the same inputs:
    no hand-written kernel may launch, and the results must agree
    (bit for bit on an integer metric; eucl within the tolerance with
    index swaps only at float64 near-ties, reported).  Returns the
    sharded result and its timings."""
    import torch
    from repro_torch.kernels import cam_search
    cam_search.reset_launch_counts()
    one_ms, a = host_ms(lambda: one.execute(qt, gt))
    sh_ms, b = host_ms(lambda: sh.execute(qt, gt))
    if any(cam_search.LAUNCHES.values()):
        raise RuntimeError(f"sharded {name}: the torch backend launched "
                           f"kernels: {dict(cam_search.LAUNCHES)}")
    out = {"unsharded_ms": one_ms, "sharded_ms": sh_ms}
    if integer:
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise RuntimeError(f"sharded {name}: 4 shards differ from the "
                               f"unsharded plan")
        out["bit_identical_to_unsharded"] = True
    else:
        tol = EUCL_ATOL + EUCL_RTOL * a[0].abs()
        if not bool(((a[0] - b[0]).abs() <= tol).all()):
            raise RuntimeError(f"sharded {name}: values off the unsharded "
                               f"plan by {float((a[0] - b[0]).abs().max())}")
        out["index_swaps_float64_near_ties"] = eucl_index_swaps(
            qt, gt, b[1], a[1], f"sharded {name}")
        out["values_bit_identical"] = bool(torch.equal(a[0], b[0]))
    return b, out


def phase_sharded(s: Smoke, data):
    """Sharded plans on the card: ``shards=8`` clamps to this host's
    device count; the ``"cuda"`` backend refuses sharding; through the
    mesh test hook (``launch.mesh.forced_devices(4, "cuda:0")``) 4-shard
    ``"torch"`` plans at the KNN shape (packed hamming, also held to flat
    B1, with a sharded 1 % ``update_rows``; eucl) and a 4-shard
    hierarchical plan at ``bench_hier``'s geometry, each against its
    unsharded plan.  No hand-written kernel is on these paths: B1 runs
    only as the flat oracle."""
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.core import ArchSpec, compile_fn, compile_module
    from repro_torch.core import cim_dialect as cd
    from repro_torch.core.engine import get_hierarchical_plan, get_plan
    from repro_torch.launch.mesh import forced_devices
    g, _, q, _ = data
    out = {"device_count": torch.cuda.device_count()}
    gb = (torch.from_numpy(g).cuda() > 0).float()
    qb = (torch.from_numpy(q).cuda() > 0).float()
    mod = hamming_module(T, cd, q.shape[0], g.shape[0], g.shape[1], 10,
                         False)
    prog = compile_module(mod, ArchSpec(rows=64, cols=64), value_bits=1)
    mod = prog.stages["cim_partitioned"]
    clamped = get_plan(mod, backend="torch", shards=8)
    if clamped.shards != torch.cuda.device_count() or (
            clamped.shards == 1 and clamped is not get_plan(
                mod, backend="torch")):
        raise RuntimeError(f"sharded: shards=8 gave {clamped.shards} on a "
                           f"{torch.cuda.device_count()}-card host")
    try:
        get_plan(mod, backend="cuda", shards=8)
    except ValueError as e:
        if "'torch'" not in str(e):
            raise
    else:
        raise RuntimeError("sharded: the cuda backend took shards=8")
    out["clamp"] = {"requested": 8, "plan_shards": clamped.shards,
                    "cuda_backend_refused": True}

    # packed hamming, 4 shards on cuda:0 stand-ins
    t0 = time.perf_counter()
    one = get_plan(mod, backend="torch")
    with forced_devices(SHARDS, "cuda:0"):
        sh = get_plan(mod, backend="torch", shards=SHARDS)
    if sh.shards != SHARDS or not sh.packed:
        raise RuntimeError(f"sharded: plan shards {sh.shards}")
    (v, i), rec = _sharded_pair("hamming", one, sh, qb, gb, True)
    fv, fi = prog.engine_plan.execute(qb, gb)                  # flat B1
    if not (torch.equal(v, fv) and torch.equal(i, fi)):
        raise RuntimeError("sharded hamming: 4 shards differ from flat B1")
    rec["bit_identical_to_flat_b1"] = True
    rng = np.random.default_rng(17)
    rows = np.sort(rng.choice(g.shape[0], int(0.01 * g.shape[0]),
                              replace=False))
    new = torch.from_numpy((rng.random((rows.size, g.shape[1])) > 0.5)
                           .astype(np.float32)).cuda()
    upd_ms, g2 = host_ms(lambda: sh.update_rows(gb, rows, new))
    if sh.row_update_fallbacks:
        raise RuntimeError("sharded hamming: update_rows fell back")
    (v2, i2), after = _sharded_pair("hamming after update", one, sh, qb, g2,
                                    True)
    fv2, fi2 = prog.engine_plan.execute(qb, g2.clone())
    if not (torch.equal(v2, fv2) and torch.equal(i2, fi2)):
        raise RuntimeError("sharded hamming: after update_rows, 4 shards "
                           "differ from flat B1 on a fresh gallery")
    rec.update(update_rows=int(rows.size), update_ms=upd_ms,
               after_update=after, part_s=time.perf_counter() - t0)
    out["hamming_k10"] = rec
    del gb, g2, new
    torch.cuda.empty_cache()

    # eucl at the KNN shape
    t0 = time.perf_counter()
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    eprog = compile_fn(knn_kernel, [q, g], ArchSpec(rows=64, cols=64),
                       value_bits=8, backend="torch")
    emod = eprog.stages["cim_partitioned"]
    with forced_devices(SHARDS, "cuda:0"):
        esh = get_plan(emod, backend="torch", shards=SHARDS)
    _, rec = _sharded_pair("eucl", eprog.engine_plan, esh, qt, gt, False)
    rec.update(rows=g.shape[0], part_s=time.perf_counter() - t0)
    out["eucl_k5"] = rec
    del gt
    torch.cuda.empty_cache()

    # the hierarchical plan at bench_hier's geometry
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    hg = clustered_gallery(rng, HIER_N, HIER_DIM, HIER_CENTERS)
    qi = rng.choice(HIER_N, size=HIER_QUERIES, replace=False)
    hq = (hg[qi].astype(bool)
          ^ (rng.random((HIER_QUERIES, HIER_DIM)) < HIER_FLIP)) \
        .astype(np.float32)
    hgt, hqt = torch.from_numpy(hg).cuda(), torch.from_numpy(hq).cuda()
    hmod = hamming_module(T, cd, HIER_QUERIES, HIER_N, HIER_DIM, HIER_K,
                          False)
    hprog = compile_module(hmod, ArchSpec(rows=128, cols=128),
                           value_bits=1)
    hmod = hprog.stages["cim_partitioned"]
    out["hier"] = {}
    for nprobe in (HIER_SERVE_NPROBE, HIER_CLUSTERS):
        kw = dict(clusters=HIER_CLUSTERS, nprobe=nprobe,
                  kmeans_iters=HIER_ITERS)
        h1 = get_hierarchical_plan(hmod, **kw)
        with forced_devices(SHARDS, "cuda:0"):
            h4 = get_hierarchical_plan(hmod, shards=SHARDS, **kw)
        if h4.shards != SHARDS:
            raise RuntimeError(f"sharded hier: plan shards {h4.shards}")
        (v, i), rec = _sharded_pair(f"hier nprobe={nprobe}", h1, h4, hqt,
                                    hgt, True)
        if nprobe == HIER_CLUSTERS:
            fv, fi = hprog.engine_plan.execute(hqt, hgt)
            if not (torch.equal(v, fv) and torch.equal(i, fi)):
                raise RuntimeError("sharded hier: nprobe = clusters is not "
                                   "bit-identical to flat B1")
            rec["bit_identical_to_flat_b1"] = True
        rec["wall_ms"] = _wall_ms(lambda: h4.execute(hqt, hgt))
        rec["unsharded_wall_ms"] = _wall_ms(lambda: h1.execute(hqt, hgt))
        out["hier"][nprobe] = rec
    out["hier"]["part_s"] = time.perf_counter() - t0
    log({"phase": "sharded", "ok": True, "shards": SHARDS, **out})


# ---------------------------------------------------------------------------
# gateway_serve: the multi-tenant gateway over replica sets (B1, B2, B3)
# ---------------------------------------------------------------------------


def _gw_search(gw, tenant, q, priority=0):
    """One request through the gateway, retried while admission rejects
    it (a rate-limited tenant backs off); returns the settled result."""
    from repro_torch.serving import AdmissionError
    deadline = time.perf_counter() + CAM_WAIT_S
    while True:
        try:
            return gw.submit(tenant, q, priority=priority).wait(CAM_WAIT_S)
        except AdmissionError:
            if time.perf_counter() > deadline:
                raise
            time.sleep(GW_BACKOFF_S)


def _gw_clients(gw, work, clients=GW_CLIENTS):
    """``clients`` threads per tenant in ``work`` (tenant -> (queries,
    oracle, priority)), each sending its share of the queries as
    GW_ROWS-row requests.  Every result must equal the tenant's oracle
    rows; returns the per-tenant latencies and the wall seconds."""
    import threading
    import numpy as np
    lat = {t: [] for t in work}
    errs = []

    def client(tenant, c):
        q, oracle, prio = work[tenant]
        per = q.shape[0] // clients
        try:
            for s0 in range(c * per, (c + 1) * per, GW_ROWS):
                res = _gw_search(gw, tenant, q[s0:s0 + GW_ROWS], prio)
                if res.error is not None:
                    raise res.error
                got = res.matches if res.matches is not None \
                    else res.indices
                want = oracle[s0:s0 + GW_ROWS]
                if not np.array_equal(got, want) or (
                        res.values is not None and not np.array_equal(
                            res.values, oracle.values[s0:s0 + GW_ROWS])):
                    raise RuntimeError(f"gateway {tenant}: rows {s0}.. "
                                       f"differ from the direct call")
                lat[tenant].append(res.latency_s)
        except Exception as e:          # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(t, c))
               for t in work for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(CAM_WAIT_S)
    wall = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in threads):
        raise RuntimeError(f"gateway: a client failed or hung: {errs[:1]}")
    return lat, wall


class _Oracle(object):
    """Direct-call results as host numpy: ``[rows]`` gives the indices
    (or the match rows), ``.values`` the values."""

    def __init__(self, out):
        if isinstance(out, tuple):
            self.values, self.main = (x.cpu().numpy() for x in out)
        else:
            self.values, self.main = None, out.cpu().numpy()

    def __getitem__(self, rows):
        return self.main[rows]


def _p95_ms(lat):
    import numpy as np
    return 1e3 * float(np.percentile(lat, 95))


def _drive_victim(search, q, reps):
    """``reps`` sequential GW_ROWS-row requests; their latencies."""
    out = []
    for r in range(reps):
        s0 = (r * GW_ROWS) % (q.shape[0] - GW_ROWS)
        t0 = time.perf_counter()
        search(q[s0:s0 + GW_ROWS])
        out.append(time.perf_counter() - t0)
    return out


def _flood(submit, stop_evt, counters, inflight=32):
    """The hot tenant's flood, bounded in flight (bench_multitenant's)."""
    from repro_torch.serving import AdmissionError, TenantUnavailable
    pending = []
    while not stop_evt.is_set():
        try:
            pending.append(submit())
            counters["accepted"] += 1
        except (AdmissionError, TenantUnavailable):
            counters["rejected"] += 1
            time.sleep(1e-3)
        while len(pending) >= inflight:
            res = pending.pop(0).wait(CAM_WAIT_S)
            if getattr(res, "error", None) is not None and \
                    not isinstance(res.error, AdmissionError):
                counters["errors"] += 1
    for h in pending:
        res = h.wait(CAM_WAIT_S)
        if getattr(res, "error", None) is not None and \
                not isinstance(res.error, AdmissionError):
            counters["errors"] += 1


def _gw_isolation(gw, q, qb, knn_plan, ham_plan, gt, gb):
    """bench_multitenant's isolation: the ``knn`` victim's p95 alone and
    while ``hamming_gold`` floods past its token bucket; then the same
    victim on a bare ``CamSearchServer`` while a bare hamming server on
    the same card takes the flood with no admission layer."""
    import threading
    from repro_torch.serving import CamSearchServer

    def victim(x):
        res = gw.submit("knn", x).wait(CAM_WAIT_S)
        if res.error is not None:
            raise res.error

    solo = _drive_victim(victim, q, GW_VICTIM_REPS)
    stop, counters = threading.Event(), {"accepted": 0, "rejected": 0,
                                         "errors": 0}
    hot_q = qb[:2 * GW_ROWS]
    flooders = [threading.Thread(target=_flood, args=(
        lambda: gw.submit("hamming_gold", hot_q, priority=GW_GOLD_PRIORITY),
        stop, counters)) for _ in range(2)]
    for f in flooders:
        f.start()
    flooded = _drive_victim(victim, q, GW_VICTIM_REPS)
    stop.set()
    for f in flooders:
        f.join(CAM_WAIT_S)
    with CamSearchServer(knn_plan, gt, max_wait_ms=2.0) as vs, \
            CamSearchServer(ham_plan, gb, max_wait_ms=2.0) as hs:
        bare_solo = _drive_victim(lambda x: vs.search(x, CAM_WAIT_S), q,
                                  GW_VICTIM_REPS)
        stop2, naive = threading.Event(), {"accepted": 0, "rejected": 0,
                                           "errors": 0}
        flooders = [threading.Thread(target=_flood, args=(
            lambda: hs.submit(hot_q), stop2, naive)) for _ in range(2)]
        for f in flooders:
            f.start()
        bare_flooded = _drive_victim(lambda x: vs.search(x, CAM_WAIT_S), q,
                                     GW_VICTIM_REPS)
        stop2.set()
        for f in flooders:
            f.join(CAM_WAIT_S)
        for srv in (vs, hs):
            _server_health("gateway_serve bare", srv)
    if counters["errors"] or naive["errors"]:
        raise RuntimeError(f"gateway isolation: flood errors "
                           f"{counters} {naive}")
    rec = {"victim_solo_p95_ms": _p95_ms(solo),
           "victim_flooded_p95_ms": _p95_ms(flooded),
           "bare_solo_p95_ms": _p95_ms(bare_solo),
           "bare_flooded_p95_ms": _p95_ms(bare_flooded),
           "hot_accepted": counters["accepted"],
           "hot_rejected": counters["rejected"],
           "bare_hot_accepted": naive["accepted"]}
    rec["gateway_factor"] = rec["victim_flooded_p95_ms"] / \
        rec["victim_solo_p95_ms"]
    rec["bare_factor"] = rec["bare_flooded_p95_ms"] / rec["bare_solo_p95_ms"]
    return rec


def _gw_failover(gw, q, oracle):
    """bench_multitenant's failover: GW_CLIENTS bit-checking clients on
    ``knn``; replica 0 killed mid-traffic; zero failed requests,
    failovers, and the maintenance loop drains, rebuilds and readmits
    the replica before the part ends."""
    import threading
    import numpy as np
    errors, lat = [], {"before": [], "after": []}
    killed = threading.Event()
    per = q.shape[0] // GW_CLIENTS
    barrier = threading.Barrier(GW_CLIENTS + 1)
    before = gw.health()["tenants"]["knn"]["stats"]["failovers"]

    def client(c):
        barrier.wait()
        for r in range(GW_FAILOVER_REPS):
            s0 = c * per + (r * GW_ROWS) % (per - GW_ROWS)
            t0 = time.perf_counter()
            res = gw.submit("knn", q[s0:s0 + GW_ROWS]).wait(CAM_WAIT_S)
            if res.error is not None:
                errors.append(repr(res.error))
                continue
            lat["after" if killed.is_set() else "before"].append(
                time.perf_counter() - t0)
            if not (np.array_equal(res.indices, oracle[s0:s0 + GW_ROWS])
                    and np.array_equal(res.values,
                                       oracle.values[s0:s0 + GW_ROWS])):
                errors.append(f"mismatch at {s0}")

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(GW_CLIENTS)]
    for t in threads:
        t.start()
    barrier.wait()
    time.sleep(GW_KILL_AFTER_S)
    gw.kill_replica("knn", 0)
    killed.set()
    for t in threads:
        t.join(CAM_WAIT_S)
    t0 = time.perf_counter()
    healed = False
    while time.perf_counter() - t0 < CAM_WAIT_S:
        reps = gw.health()["tenants"]["knn"]["replicas"]["replicas"]
        if all(r["state"] == "serving" for r in reps) and \
                any(r["rebuilds"] > 0 for r in reps):
            healed = True
            break
        time.sleep(0.01)
    heal_s = time.perf_counter() - t0
    h = gw.health()["tenants"]["knn"]
    failovers = h["stats"]["failovers"] - before
    post = gw.submit("knn", q[:GW_ROWS]).wait(CAM_WAIT_S)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"gateway failover: {len(errors)} failed or "
                           f"mismatched requests: {errors[:3]}")
    if failovers <= 0:
        raise RuntimeError("gateway failover: the kill landed between "
                           "requests: no failover")
    if not healed:
        raise RuntimeError("gateway failover: the killed replica was not "
                           "rebuilt and readmitted")
    if post.error is not None or not np.array_equal(post.indices,
                                                    oracle[:GW_ROWS]):
        raise RuntimeError("gateway failover: after the heal the result "
                           "differs from the direct call")
    return {"clients": GW_CLIENTS, "requests": GW_CLIENTS * GW_FAILOVER_REPS,
            "failed": 0, "failovers": failovers,
            "healed": healed, "heal_wait_s": heal_s,
            "p50_before_kill_ms": _latency_ms(lat["before"])["p50"]
            if lat["before"] else None,
            "p99_after_kill_ms": _latency_ms(lat["after"])["p99"]
            if lat["after"] else None,
            "replicas": [{k: r[k] for k in ("state", "generation",
                                            "rebuilds", "heals", "drains",
                                            "device_group")}
                         for r in h["replicas"]["replicas"]]}


def _gw_update(gw, plan, qb, gb):
    """A live ``update_gallery`` of 1 % of ``hamming``'s rows racing its
    clients: every result equals the version-A or the version-B oracle,
    and every request submitted after the update returns sees B (on the
    shared ``hamming_gold`` tenant too)."""
    import threading
    import numpy as np
    import torch
    rng = np.random.default_rng(23)
    n, dim = gb.shape
    rows = np.sort(rng.choice(n, int(0.01 * n), replace=False))
    new = (rng.random((rows.size, dim)) > 0.5).astype(np.float32)
    qr = qb[:GW_ROWS]
    want_a = plan.execute(qr, gb)[1].cpu().numpy()
    gb2 = gb.clone()
    gb2[torch.from_numpy(rows).cuda()] = torch.from_numpy(new).cuda()
    want_b = plan.execute(qr, gb2)[1].cpu().numpy()
    del gb2
    if np.array_equal(want_a, want_b):
        raise RuntimeError("gateway update: the update is invisible")
    seen, errs = [], []
    stop = threading.Event()

    def racer():
        try:
            while not stop.is_set():
                res = _gw_search(gw, "hamming", qr)
                if res.error is not None:
                    raise res.error
                seen.append("a" if np.array_equal(res.indices, want_a) else
                            "b" if np.array_equal(res.indices, want_b) else
                            "torn")
        except Exception as e:          # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=racer) for _ in range(GW_CLIENTS)]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + CAM_WAIT_S
    while len(seen) < GW_CLIENTS and not errs and \
            time.perf_counter() < deadline:
        time.sleep(0.001)
    update_ms, count = host_ms(lambda: gw.update_gallery("hamming", rows,
                                                         new))
    after = [_gw_search(gw, t, qr) for t in ("hamming", "hamming_gold")]
    n_before = len(seen)
    while "b" not in seen[n_before:] and not errs and \
            time.perf_counter() < deadline:
        time.sleep(0.001)
    stop.set()
    for t in threads:
        t.join(CAM_WAIT_S)
    if errs or any(t.is_alive() for t in threads):
        raise RuntimeError(f"gateway update: a racer failed: {errs[:1]}")
    if any(r.error is not None or not np.array_equal(r.indices, want_b)
           for r in after):
        raise RuntimeError("gateway update: a request after the update "
                           "did not read its write")
    if "torn" in seen or "a" not in seen or "b" not in seen:
        raise RuntimeError(f"gateway update: {seen.count('a')} A, "
                           f"{seen.count('b')} B, {seen.count('torn')} "
                           f"mixed results")
    return {"rows": int(count), "update_ms": update_ms,
            "racing_results": len(seen), "version_a": seen.count("a"),
            "version_b": seen.count("b"), "read_your_writes": True}


def phase_gateway_serve(s: Smoke, data):
    """One ``CamServingGateway`` with four tenants at the smoke's widths:
    ``knn`` (``knn_eucl``'s program and gallery, B2, 2 replicas),
    ``hamming`` (``hamming_packed``'s, B1, 2 replicas), ``hamming_gold``
    (``share_with="hamming"``, its own rate and priority) and ``forest``
    (``forest_acam``'s interval rows, ``match``, B3, 2 replicas);
    ``benchmarks/bench_multitenant.py``'s three experiments (aggregate,
    isolation, failover) and a live 1 % update racing its clients.  Fails
    on any mismatch against the direct plan calls, any unexpected error,
    or any degraded batch."""
    import numpy as np
    import torch
    from repro_torch.core import ArchSpec, CamType, compile_fn
    from repro_torch.forest import CamForestClassifier, random_forest
    from repro_torch.kernels import cam_search
    from repro_torch.serving import CamServingGateway
    g, _, q, _ = data
    gt = torch.from_numpy(g).cuda()
    knn = compile_fn(knn_kernel, [q, g], ArchSpec(rows=64, cols=64),
                     value_bits=8).engine_plan
    ham, qb, gb = _packed_plan(data)
    trees = random_forest(np.random.default_rng(7), **FOREST)
    clf = CamForestClassifier(trees, dim=FOREST["dim"]).compile(
        ArchSpec(rows=64, cols=64, cam_type=CamType.ACAM),
        batch_hint=FOREST_QUERIES)
    x = np.random.default_rng(8).standard_normal(
        (FOREST_QUERIES, FOREST["dim"])).astype(np.float32)
    rows = GW_CLIENTS * GW_REQUESTS * GW_ROWS
    qk, qh, xf = q[:rows], qb[:rows], x[:rows]
    oracles = {"knn": _Oracle(knn.execute(qk, gt)),
               "hamming": _Oracle(ham.execute(qh, gb)),
               "forest": _Oracle(clf.plan.execute(xf, clf._lo, clf._hi))}
    oracles["hamming_gold"] = oracles["hamming"]
    cam_search.reset_launch_counts()
    out = {}
    gw = CamServingGateway(maint_ms=GW_MAINT_MS)
    try:
        t0 = time.perf_counter()
        gw.register_tenant("knn", knn, gt, replicas=2, unhealthy_k=2,
                           server_kwargs={"max_wait_ms": 2.0})
        gw.register_tenant("hamming", ham, gb, replicas=2,
                           server_kwargs={"max_wait_ms": 2.0})
        gw.register_tenant("hamming_gold", share_with="hamming",
                           rate=GW_GOLD_RATE, burst=GW_GOLD_BURST,
                           queue_limit=4, max_outstanding=2)
        gw.register_tenant("forest", clf.plan, (clf._lo, clf._hi),
                           replicas=2, server_kwargs={"max_wait_ms": 2.0})
        out["register_s"] = time.perf_counter() - t0

        # (1) aggregate: 4 tenants x GW_CLIENTS clients, 13-row requests
        work = {"knn": (qk, oracles["knn"], 0),
                "hamming": (qh, oracles["hamming"], 0),
                "hamming_gold": (qh, oracles["hamming"], GW_GOLD_PRIORITY),
                "forest": (xf, oracles["forest"], 0)}
        lat, wall = _gw_clients(gw, work)
        out["aggregate"] = {
            "wall_s": wall, "rows": 4 * rows,
            "rows_per_s": 4 * rows / wall,
            "latency_ms": {t: _latency_ms(v) for t, v in lat.items()},
            "bit_identical_to_direct": True}
        # (2) isolation, (3) failover, then the live update
        t0 = time.perf_counter()
        out["isolation"] = _gw_isolation(gw, q, qb, knn, ham, gt, gb)
        out["isolation"]["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["failover"] = _gw_failover(gw, qk, oracles["knn"])
        out["failover"]["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["update"] = _gw_update(gw, ham, qb, gb)
        out["update"]["part_s"] = time.perf_counter() - t0
        snap = gw.snapshot()
    finally:
        gw.stop()
    counts = dict(cam_search.LAUNCHES)
    for name in ("fused_topk", "fused_topk_packed", "acam_match"):
        if counts[name] < 1:
            raise RuntimeError(f"gateway_serve: kernel {name} was not "
                               f"launched: {counts}")
    tenants = {}
    for t, e in snap["tenants"].items():
        servers = [sv for sv in e["servers"] if sv is not None]
        degraded = sum(sv["degraded_batches"] for sv in servers)
        # the only failures allowed: hamming_gold's flood shed by its own
        # admission budget
        if degraded or e["stats"]["failed"] != e["stats"]["shed"]:
            raise RuntimeError(f"gateway_serve {t}: {degraded} degraded "
                               f"batches, {e['stats']['failed']} failed "
                               f"requests ({e['stats']['shed']} shed)")
        batches = sum(sv["batches"] for sv in servers)
        tenants[t] = {"stats": e["stats"], "latency": e["latency"],
                      "batches": batches,
                      "rows_per_batch": sum(sv["batched_rows"]
                                            for sv in servers)
                      / max(1, batches),
                      "replicas": [{k: r[k] for k in
                                    ("state", "generation", "rebuilds",
                                     "heals", "failures")}
                                   for r in e["replicas"]["replicas"]]}
    for name, src, ref in (
            ("fused_topk", "fused_topk.cu", "cam_search.py:200"),
            ("fused_topk_packed", "fused_topk_packed.cu",
             "cam_search.py:304"),
            ("acam_match", "acam_match.cu", "acam.py:121")):
        s.record(name, f"src/repro_torch/kernels/csrc/{src}",
                 f"src/repro/kernels/{ref}", counts[name], 0.0, None, None,
                 None, "operations", None)
    log({"phase": "gateway_serve", "ok": True, "launches": counts,
         "tenants": tenants, **out})


# ---------------------------------------------------------------------------
# tune: the plan autotuner, the plan store and the served warm start
# ---------------------------------------------------------------------------

#: the child process's time limit, and the served warm start's request
#: rows (a gateway request) and requests
TUNE_CHILD_S = 600
TUNE_SERVE_ROWS, TUNE_SERVE_REQUESTS = 13, 8


def tune_workloads(data):
    """The tune phase's programs, name -> (partitioned module, inputs on
    the card): ``knn_eucl``'s (B2, k = 5), ``hamming_packed``'s (B1,
    k = 10) and ``forest_acam``'s interval range program (B3), from the
    smoke's seeds, so that a second process rebuilds the same data."""
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.core import (ArchSpec, CamType, compile_fn,
                                  compile_module)
    from repro_torch.core import cim_dialect as cd
    from repro_torch.forest import CamForestClassifier, random_forest
    g, _, q, _ = data
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    knn = compile_fn(knn_kernel, [q, g], ArchSpec(rows=64, cols=64),
                     value_bits=8)
    ham = compile_module(hamming_module(T, cd, q.shape[0], g.shape[0],
                                        g.shape[1], 10, False),
                         ArchSpec(rows=64, cols=64), value_bits=1)
    trees = random_forest(np.random.default_rng(7), **FOREST)
    clf = CamForestClassifier(trees, dim=FOREST["dim"]).compile(
        ArchSpec(rows=64, cols=64, cam_type=CamType.ACAM),
        batch_hint=FOREST_QUERIES)
    x = np.random.default_rng(8).standard_normal(
        (FOREST_QUERIES, FOREST["dim"])).astype(np.float32)
    return {"knn_eucl": (knn.stages["cim_partitioned"], (qt, gt)),
            "hamming_packed": (ham.stages["cim_partitioned"],
                               ((qt > 0).float(), (gt > 0).float())),
            "forest_acam": (clf.stages["cim_partitioned"],
                            (torch.from_numpy(x).cuda(), clf._lo, clf._hi))}


def _host_out(out):
    """A plan's result as a tuple of host numpy arrays."""
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(o.cpu().numpy() for o in outs)


def _timed_tune(mod, ins):
    """``tune_plan`` and the winner's first result, timed together on
    the host clock (the start-to-first-result a server pays)."""
    import torch
    from repro_torch.tune import tune_plan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tune_plan(mod, *ins)
    out = res.plan.execute(*ins)
    torch.cuda.synchronize()
    return res, out, time.perf_counter() - t0


def tune_child(out_dir: str) -> None:
    """The cold start in a fresh process: the same data from the same
    seeds, ``tune_plan`` against the parent's store (``REPRO_PLAN_STORE``
    inherited), each result held bit for bit to the parent's winner in
    ``out_dir``.  Prints one JSON line."""
    import numpy as np
    import repro_torch.kernels.build as kbuild
    from repro_torch.data import knn_dataset
    from repro_torch.tune import plan_store_stats, tune_stats
    t0 = time.perf_counter()
    built = kbuild.build()
    work = tune_workloads(knn_dataset(**KNN_DATA))
    setup_s = time.perf_counter() - t0
    programs = {}
    for name, (mod, ins) in work.items():
        res, out, took = _timed_tune(mod, ins)
        want = np.load(os.path.join(out_dir, f"{name}.npz"))
        got = _host_out(out)
        programs[name] = {
            "from_store": res.from_store, "trials": res.trials,
            "config": {k: res.config[k] for k in
                       ("tile_rows", "dims_per_tile", "batch", "pack")},
            "start_to_first_result_s": took,
            "bit_identical": len(got) == len(want.files) and all(
                np.array_equal(a, want[f"o{j}"])
                for j, a in enumerate(got))}
    print(json.dumps({"built": built, "setup_s": setup_s,
                      "store": plan_store_stats(), "tune": tune_stats(),
                      "imported": sorted(m for m in sys.modules
                                         if m.split(".")[0] in
                                         ("jax", "repro")),
                      "programs": programs}), flush=True)


def _tune_verify(name, ins, base, win):
    """The winner's result against its baseline's: bit-identical for
    hamming and the interval match; eucl values within the tolerance and
    index swaps only at float64 near-ties.  Returns the swaps."""
    import torch
    if name != "knn_eucl":
        if not all(torch.equal(a, b) for a, b in zip(
                base if isinstance(base, tuple) else (base,),
                win if isinstance(win, tuple) else (win,))):
            raise RuntimeError(f"tune {name}: the winner differs from its "
                               f"baseline")
        return 0
    (bv, bi), (wv, wi) = base, win
    if not bool(((wv - bv).abs() <= EUCL_ATOL + EUCL_RTOL * bv.abs()).all()):
        raise RuntimeError(f"tune {name}: winner values off the baseline by "
                           f"{float((wv - bv).abs().max())}")
    return eucl_index_swaps(ins[0], ins[1], wi, bi, f"tune {name}")


def _tune_serve(plan, heuristic, q, g):
    """(d) a server over the heuristic plan, and a gateway tenant
    registered with the default ``tuned``: both must serve the stored
    winner ``plan``, every request bit-identical to its direct call;
    ``tuned=False`` keeps the heuristic plan."""
    import numpy as np
    from repro_torch.serving import CamSearchServer, CamServingGateway
    rows = TUNE_SERVE_ROWS
    blocks = [q[j * rows:(j + 1) * rows] for j in range(TUNE_SERVE_REQUESTS)]
    want = [_host_out(plan.execute(b, g)) for b in blocks]

    def check(what, results):
        for j, (v, i) in enumerate(results):
            if not (np.array_equal(v, want[j][0])
                    and np.array_equal(i, want[j][1])):
                raise RuntimeError(f"tune {what}: request {j} differs from "
                                   f"the winner's direct call")

    with CamSearchServer(heuristic, g) as srv:
        if srv.plan is not plan:
            raise RuntimeError("tune: the server did not warm-start to the "
                               "stored winner")
        check("server", [srv.search(b, timeout=CAM_WAIT_S) for b in blocks])
        served = {"tile_rows": srv.plan.spec.tile_rows,
                  "batch": srv.plan.batch}
        _server_health("tune server", srv)
    with CamSearchServer(heuristic, g, tuned=False) as srv:
        if srv.plan is not heuristic:
            raise RuntimeError("tune: tuned=False did not keep the plan")
    with CamServingGateway(maint_ms=GW_MAINT_MS) as gw:
        gw.register_tenant("hamming", heuristic, g, replicas=2)
        tenant_plan = gw._tenant("hamming").rset.plan
        if tenant_plan is not plan:
            raise RuntimeError("tune: the gateway tenant did not "
                               "warm-start to the stored winner")
        check("gateway", [gw.search("hamming", b, timeout=CAM_WAIT_S)
                          for b in blocks])
    return {"server_plan": served, "requests": len(blocks), "rows": rows,
            "server_bit_identical": True, "gateway_bit_identical": True,
            "tuned_false_keeps_heuristic": True}


def phase_tune(s: Smoke, data):
    """The plan autotuner on the ``"cuda"`` backend with its default
    trials and reps, against a fresh temporary ``REPRO_PLAN_STORE``:
    (a) ``knn_eucl``'s and ``hamming_packed``'s programs at 624 x 180,000
    x 1024 and (b) ``forest_acam``'s interval range plan, each winner
    held to its baseline; (c) a second process warm-starts from the
    store (no trial, three config hits, nothing built, bit-identical
    results); (d) a server and a gateway tenant built over the heuristic
    hamming plan serve the stored winner."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.kernels import cam_search
    from repro_torch.tune import (plan_for_config, plan_store_stats,
                                  reset_plan_store_stats, reset_tune_stats)
    T.clear_plan_cache()
    scratch = tempfile.mkdtemp(prefix="chip-smoke-tune-")
    store = os.path.join(scratch, "store")
    old = os.environ.get("REPRO_PLAN_STORE")
    os.environ["REPRO_PLAN_STORE"] = store
    try:
        work = tune_workloads(data)
        reset_tune_stats()
        reset_plan_store_stats()
        cam_search.reset_launch_counts()
        tuned = {name: _timed_tune(mod, ins)
                 for name, (mod, ins) in work.items()}
        counts = dict(cam_search.LAUNCHES)
        for name in ("fused_topk", "fused_topk_packed", "acam_match"):
            if counts[name] < 1:
                raise RuntimeError(f"tune: kernel {name} was not launched: "
                                   f"{counts}")
        programs = {}
        for name, (res, out, took) in tuned.items():
            mod, ins = work[name]
            if res.from_store or res.trials < 1:
                raise RuntimeError(f"tune {name}: no search ran")
            base = plan_for_config(res.plan.spec, res.history[0])
            swaps = _tune_verify(name, ins, base.execute(*ins), out)
            np.savez(os.path.join(scratch, f"{name}.npz"),
                     **{f"o{j}": a for j, a in enumerate(_host_out(out))})
            programs[name] = {
                "baseline": {k: res.history[0][k] for k in
                             ("tile_rows", "dims_per_tile", "batch",
                              "pack")},
                "baseline_ms": 1e3 * res.base_s,
                "winner": {k: res.config[k] for k in
                           ("tile_rows", "dims_per_tile", "batch", "pack")},
                "winner_ms": 1e3 * res.best_s, "speedup": res.speedup,
                "trials": res.trials,
                "rejected": sum(h.get("verified") is False
                                for h in res.history),
                "refused": sum(bool(h.get("error")) for h in res.history),
                "index_swaps_float64_near_ties": swaps,
                "cold_start_to_first_result_s": took,
                "history": [dict({k: v for k, v in h.items()
                                  if k not in ("backend", "wall_s")},
                                 ms=None if h["wall_s"] is None
                                 else 1e3 * h["wall_s"])
                            for h in res.history]}
            if programs[name]["rejected"] or programs[name]["refused"]:
                # every candidate (each batch value: a ragged last
                # micro-batch at m = 624) must run on the kernels and
                # give the baseline's answers
                raise RuntimeError(f"tune {name}: candidates rejected or "
                                   f"refused: {programs[name]['history']}")
        parent_store = plan_store_stats()

        # (c) the cold start in a fresh, torch-only process
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c",
             f"import sys; sys.path[:0] = [{ROOT!r}, "
             f"{os.path.join(ROOT, 'src')!r}]; import chip_smoke; "
             f"chip_smoke.tune_child({scratch!r})"],
            capture_output=True, text=True, timeout=TUNE_CHILD_S)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise RuntimeError(f"tune: the child failed: "
                               f"{child.stderr[-3000:]}")
        warm = json.loads(child.stdout.strip().splitlines()[-1])
        if warm["built"] or warm["imported"] or \
                warm["store"]["config_hits"] != 3 or \
                warm["store"]["exec_hits"] != 0 or \
                warm["tune"]["trials"] != 0 or not all(
                    p["from_store"] and p["trials"] == 0 and p["bit_identical"]
                    and p["config"] == programs[n]["winner"]
                    for n, p in warm["programs"].items()):
            raise RuntimeError(f"tune: the second process did not "
                               f"warm-start: {warm}")

        # (d) the served warm start, over the heuristic hamming plan
        cam_search.reset_launch_counts()
        mod, (qb, gb) = work["hamming_packed"]
        winner = tuned["hamming_packed"][0].plan
        serve = _tune_serve(winner, T.get_plan(mod), qb, gb)
        serve["launches"] = dict(cam_search.LAUNCHES)
        kernel = "fused_topk_packed" if winner.packed else "fused_topk"
        if serve["launches"][kernel] < 1:
            raise RuntimeError(f"tune: the served warm start did not launch "
                               f"the winner's {kernel}: {serve['launches']}")
    finally:
        if old is None:
            os.environ.pop("REPRO_PLAN_STORE", None)
        else:
            os.environ["REPRO_PLAN_STORE"] = old
        shutil.rmtree(scratch, ignore_errors=True)
        T.clear_plan_cache()
        torch.cuda.empty_cache()
    for name, src, ref in (
            ("fused_topk", "fused_topk.cu", "cam_search.py:200"),
            ("fused_topk_packed", "fused_topk_packed.cu",
             "cam_search.py:304"),
            ("acam_match", "acam_match.cu", "acam.py:121")):
        s.record(name, f"src/repro_torch/kernels/csrc/{src}",
                 f"src/repro/kernels/{ref}", counts[name], 0.0, None, None,
                 None, "operations", None)
    log({"phase": "tune", "ok": True, "launches": counts,
         "programs": programs, "parent_store": parent_store,
         "child": dict(warm, wall_s=child_s), "served": serve})


def _lm_kernel_class(key: str) -> str:
    """Kernel class of a profiler row: B7, B2, a matrix product, or
    other."""
    low = key.lower()
    if "flash_fwd" in low:
        return "b7_flash_attention"
    if "fused_topk" in low:
        return "b2_fused_topk"
    if any(w in low for w in ("gemm", "gemv", "cublas", "cutlass", "xmma",
                              "nvjet", "matmul", "splitk")):
        return "gemm"
    return "other"


def b7_bound_ms(q, k, kw):
    """B7's bound: 4 * H * dh FLOP per visible (row, column) pair at the
    bf16 tensor-core peak, against the bytes of q, o and the visible K/V
    rows; both counted from this call's masks."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    kv_len = kw.get("kv_len") or k.shape[1]
    q_start, prefix = kw.get("q_start", 0), kw.get("prefix_len", 0)
    if kw.get("causal", True):
        rows = [min(kv_len, max(q_start + r + 1, prefix)) for r in range(s)]
    else:
        rows = [kv_len] * s
    flops = 4.0 * b * h * dh * sum(rows)
    bytes_ = (2.0 * q.element_size() * b * s * h * dh
              + 2.0 * k.element_size() * b * max(rows) * kvh * dh)
    t_ops, t_mem = flops / BF16_PEAK_FLOPS, bytes_ / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
        else "bytes"


def sdpa_call(q, k, v, kw):
    """The library yardstick for one B7 call: PyTorch's
    ``scaled_dot_product_attention`` over the visible cache rows (timed
    only; the port never calls it)."""
    import torch
    s = q.shape[1]
    kv_len = kw.get("kv_len") or k.shape[1]
    qt = q.transpose(1, 2)
    kt, vt = k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2)
    # one decode row sees every cached row; a prefill is causal from 0,
    # a prefix-LM's with its prefix visible to every row (a boolean mask)
    causal = s > 1 and kw.get("causal", True)
    if causal and (kw.get("q_start", 0) or kv_len != s):
        raise ValueError(f"sdpa_call: no yardstick for {kw}")
    prefix = kw.get("prefix_len", 0) if causal else 0
    if prefix:
        ki = torch.arange(kv_len, device=q.device)
        mask = (ki[None, :] <= ki[:s, None]) | (ki[None, :] < prefix)
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def b7_check(what, q, k, v, kw):
    """B7 on one captured call's operands against its plain version (bf16
    within ``B7_BF16_ATOL``) and against the Pallas recurrence at its
    route's kv tiles and splits (the 0.05 ceiling is as large as a long
    decode's outputs, so each case is also held in steps of its own
    outputs' size), then in float32 on the same shapes, the cache cut to
    ``F32_CUT_ROWS`` (and a longer causal prefill's query rows with it: its
    first rows see no column past the cut), within ``B7_F32_ATOL``.
    Returns the record."""
    from repro_torch.kernels import flash_attention as fa
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_reference(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    if not err <= B7_BF16_ATOL:
        raise RuntimeError(f"{what}: B7 off its plain version by {err} "
                           f"(bf16 bound {B7_BF16_ATOL})")
    route = fa.flash_route(q.shape, k.shape, q.dtype, **kw)
    rec = fa.flash_attention_recurrence(
        q, k, v, block_k=route.block_k, splits=route.splits, **kw).float()
    off = (got.float() - rec).abs()
    beyond = float((off > 1e-6 + 2.0 ** -7 * rec.abs()).float().mean())
    rec_max, v_max = float(off.max()), float(v.float().abs().max())
    if not (beyond <= B7_REC_BEYOND and rec_max <= B7_REC_MAX_OF_V * v_max):
        raise RuntimeError(
            f"{what}: B7 off the Pallas recurrence: {beyond:.2e} of outputs "
            f"beyond one bf16 step (bound {B7_REC_BEYOND}), max {rec_max} "
            f"(bound {B7_REC_MAX_OF_V * v_max})")
    del rec, off
    cut = min(k.shape[1], F32_CUT_ROWS)
    rows = min(q.shape[1], cut)
    kw32 = dict(kw)
    kw32["kv_len"] = min(kw.get("kv_len") or k.shape[1], cut)
    kw32["q_start"] = min(kw.get("q_start", 0), kw32["kv_len"] - rows)
    q32, k32, v32 = (x.float() for x in (q[:, :rows], k[:, :cut],
                                         v[:, :cut]))
    got32 = fa.flash_attention(q32, k32, v32, **kw32)
    want32 = fa.flash_attention_reference(q32, k32, v32, **kw32)
    err32 = float((got32 - want32).abs().max())
    if not err32 <= B7_F32_ATOL:
        raise RuntimeError(f"{what}: B7 in float32 off its plain version by "
                           f"{err32} (bound {B7_F32_ATOL})")
    return {"q": list(q.shape), "kv": list(k.shape), "kw": kw,
            "route": route.name, "splits": route.splits,
            "block_k": route.block_k, "max_abs_err": err,
            "max_abs_want": float(want.float().abs().max()),
            "recurrence_max_abs_err": rec_max,
            "recurrence_beyond_one_step": beyond, "f32_kv_rows": cut,
            "f32_q_rows": rows, "f32_max_abs_err": err32}


def b7_timing(q, k, v, kw):
    """B7 on one captured call's operands: CUDA-event and host ms, its
    plain version, its bound and SDPA (with SDPA's distance from the
    plain version)."""
    from repro_torch.kernels import flash_attention as fa
    bound, by = b7_bound_ms(q, k, kw)
    lib = sdpa_call(q, k, v, kw)
    lib_err = float((lib().transpose(1, 2).float()
                     - fa.flash_attention_reference(q, k, v, **kw)
                     .float()).abs().max())
    reps = 5 if q.shape[1] > 1 else 20
    route = fa.flash_route(q.shape, k.shape, q.dtype, **kw)
    return {"route": route.name, "splits": route.splits,
            "block_k": route.block_k,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps),
            "host_ms": host_ms_per_call(
                lambda: fa.flash_attention(q, k, v, **kw), reps),
            "plain_ms": cuda_ms(
                lambda: fa.flash_attention_reference(q, k, v, **kw), 3),
            "bound_ms": bound, "bound_by": by,
            "library_ms": cuda_ms(lib, reps), "library_max_abs_err": lib_err}


@contextlib.contextmanager
def intercept(mod, attr, keep):
    """Within the block every call of ``mod.attr`` goes through, and
    ``keep(i, args, kwargs, result)`` (``i`` the call's index) is
    appended to the yielded list unless it returns None.  The calls
    ``keep`` itself makes pass straight through, unnumbered."""
    real = getattr(mod, attr)
    kept, calls, busy = [], [0], [False]

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        if busy[0]:
            return out
        busy[0] = True
        try:
            item = keep(calls[0], args, kw, out)
        finally:
            busy[0] = False
        if item is not None:
            kept.append(item)
        calls[0] += 1
        return out

    setattr(mod, attr, wrapper)
    try:
        yield kept
    finally:
        setattr(mod, attr, real)


def host_masks(kw):
    """B7's keyword arguments with a device ``start`` folded into host
    ``q_start`` and ``kv_len`` (the same call with ints)."""
    kw = dict(kw)
    start = kw.pop("start", None)
    if start is not None:
        n = int(start)
        kw["q_start"] = kw.get("q_start", 0) + n
        kw["kv_len"] = kw["kv_len"] + n
    return kw


def operands(wanted):
    """An ``intercept`` keep function: (name, (*args, kwargs)) for the
    calls whose index ``wanted`` names, (None, None) for the others; a
    device start is folded into the kwargs' ints."""
    return lambda i, a, kw, out: (wanted[i], (*a, host_masks(kw))) \
        if i in wanted else (None, None)


@contextlib.contextmanager
def plain_kernels():
    """Within the block the LM's kernels run their plain versions on the
    card: B7's ``flash_attention_reference``, for the ``"cam"`` router
    ``ref.cam_topk_tiled`` exactly as the CPU path calls it, M1's
    ``ssd_scan_reference`` and X1's ``slstm_scan_reference``."""
    from repro_torch.kernels import flash_attention as fa, ops, ref
    from repro_torch.kernels import slstm_scan as ksl, ssd_scan as kss

    def cam_plain(q, p, *, metric, k, largest):
        return ref.cam_topk_tiled(q, p, metric=metric, k=k, largest=largest,
                                  tile_rows=min(32, p.shape[0]),
                                  dims_per_tile=min(128, q.shape[1]))

    real = fa.flash_attention, ops.cam_topk, kss.ssd_scan, ksl.slstm_scan
    fa.flash_attention, ops.cam_topk = fa.flash_attention_reference, \
        cam_plain
    kss.ssd_scan, ksl.slstm_scan = kss.ssd_scan_reference, \
        ksl.slstm_scan_reference
    try:
        yield
    finally:
        fa.flash_attention, ops.cam_topk, kss.ssd_scan, ksl.slstm_scan = \
            real


def lm_params(cfg):
    """Random parameters on the card from seed 0: (params, init host ms,
    parameter count, GB)."""
    from repro_torch.models import model as tm
    init_ms, params = host_ms(lambda: tm.init_params(cfg, seed=0))
    leaves = []
    tm._tree_map(leaves.append, params)
    return (params, init_ms, sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves) / 1e9)


def _ms_stats(ms):
    """Median and p90 of a list of milliseconds (None for none)."""
    if not ms:
        return {"n": 0, "median": None, "p90": None}
    xs = sorted(ms)
    return {"n": len(xs), "median": statistics.median(xs),
            "p90": xs[min(len(xs) - 1, int(round(0.9 * (len(xs) - 1))))]}


def eager_request(cfg, params, prompt, max_new, max_len, device):
    """One request through the step functions (``steps.make_prefill_step``
    / ``make_decode_step``), eagerly, from a fresh cache, greedy: (tokens,
    the first five steps' last-position logits, prefill ms, decode ms a
    token), each step timed on the host to a synchronise."""
    import numpy as np
    import torch
    from repro_torch.models import model as tm
    from repro_torch.models import steps as ts
    batch = {"tokens": torch.as_tensor(np.asarray(prompt, np.int64),
                                       device=device)[None]}
    if cfg.family == "vlm":
        batch["vision"] = torch.zeros((1, cfg.n_vision_tokens, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((1, cfg.encoder_seq, cfg.d_model),
                                      dtype=torch.bfloat16, device=device)
    cache = tm.init_decode_cache(cfg, 1, max_len, device=device)
    prefill_ms, (logits, cache) = host_ms(
        lambda: ts.make_prefill_step(cfg)(params, batch, cache))
    seen = [logits[:, -1].clone()]
    out = [int(torch.argmax(logits[0, -1]))]
    decode, decode_ms = ts.make_decode_step(cfg), []
    while len(out) < max_new:
        tok = torch.tensor([[out[-1]]], device=device)
        ms, (logits, cache) = host_ms(lambda: decode(params, tok, cache))
        decode_ms.append(ms)
        if len(seen) < 5:
            seen.append(logits[:, -1].clone())
        out.append(int(torch.argmax(logits[0, -1])))
    return out, seen, prefill_ms, decode_ms


def serve_requests(cfg, params, prompts, max_new, batch, max_len,
                   eager_ctx=contextlib.nullcontext, profile=None,
                   profile_prefill=True, eager=True):
    """Serve ``prompts`` through ``launch.serve.Server`` (greedy): each
    prefill the replay of its prompt length's captured CUDA graph, each
    decode step the replay of its slot's, the launch counts at 0 just
    before.  Those counts are the wrappers' calls at each graph's warm-up
    and capture: a replay launches the captured kernels without a call
    (``graphed_launches``).  Then every request again through the eager
    steps from a fresh cache (within ``eager_ctx()``; skipped with
    ``eager=False``): the greedy tokens must be equal and request 0's
    prefill and first four decode steps' logits bit-identical.  Returns
    (token lists, stats, counts); stats gains ``graphs``
    (``Server.graph_stats`` and ``pool_bytes``), ``graphed`` and
    ``eager`` ms a prefill and a decode token (median, p90; the graphed
    ones without the steps that captured), the same for a prefill by
    prompt length (``prefill_by_len``: a length's graphed time needs a
    second prompt of that length, the first captures), and, with
    ``profile`` (a
    ``Smoke``), the device kernels of one replay of each graph.  Fails
    on a missing or out-of-range token or any mismatch."""
    import gc
    import torch
    from repro_torch.kernels import cam_search
    from repro_torch.launch.serve import Request, Server
    srv = Server(cfg, params, batch=batch, max_len=max_len, temperature=0)
    reqs = [Request(rid=r, prompt=p, max_new=max_new)
            for r, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    seen, times, by_len = {}, {"prefill": [], "decode": []}, {}
    real = {"prefill": srv._prefill_slot, "decode": srv._decode_slot}

    def timed(kind):
        def step(i, arg):
            n = srv.graph_stats()
            t0 = time.perf_counter()
            lg = real[kind](i, arg)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            rid = arg.rid if kind == "prefill" else srv.slots[i].rid
            if rid == 0 and len(seen.setdefault(0, [])) < 5:
                seen[0].append(lg[:, -1].clone())
            if srv.graph_stats() == n:        # a replay, not a capture
                times[kind].append(ms)
                if kind == "prefill":
                    by_len.setdefault(len(arg.prompt), []).append(ms)
            return lg
        return step
    srv._prefill_slot, srv._decode_slot = timed("prefill"), timed("decode")
    cam_search.reset_launch_counts()
    torch.cuda.synchronize()
    stats = srv.run()
    torch.cuda.synchronize()
    counts = dict(cam_search.LAUNCHES)
    if stats["completed"] != len(prompts) or any(
            len(r.out) != max_new or not all(0 <= x < cfg.vocab
                                             for x in r.out) for r in reqs):
        raise RuntimeError(f"{cfg.name}: bad completions {stats}")
    graphs = dict(srv.graph_stats(), pool_bytes=srv.pool_bytes())
    if graphs["prefill_graphs"] < 1 or graphs["decode_graphs"] < 1:
        raise RuntimeError(f"{cfg.name}: the Server captured no graph "
                           f"{graphs}")
    dev = params["embed"]["tok"].device
    replay = {}
    if profile is not None:
        # kernels a replay: one decode step of slot 0 (its cache has room
        # for it) and, unless skipped, one prefill
        replay["decode"] = profile.profile(srv._decode_steps[0], [])
        if profile_prefill:
            replay["prefill"] = profile.profile(
                next(iter(srv._prefill_steps.values()))[1], [])
    # the timed wrappers close over the Server's own methods: collect the
    # cycle, so its caches and graph pool go back before the eager run
    del srv, real
    gc.collect()
    eager_ms, eager_by_len = {"prefill": [], "decode": []}, {}
    with eager_ctx():
        for r in (reqs if eager else []):
            toks, logits, pre, dec = eager_request(cfg, params, r.prompt,
                                                   max_new, max_len, dev)
            if toks != r.out:
                raise RuntimeError(f"{cfg.name}: request {r.rid}'s graphed "
                                   f"tokens differ from the eager steps'")
            if r.rid == 0:
                same = [bool(torch.equal(a, b))
                        for a, b in zip(seen[0], logits)]
                if len(same) != min(5, max_new) or not all(same):
                    raise RuntimeError(f"{cfg.name}: graphed logits not "
                                       f"bit-identical to eager: {same}")
            eager_ms["prefill"].append(pre)
            eager_by_len.setdefault(len(r.prompt), []).append(pre)
            eager_ms["decode"] += dec
    stats.update(
        graphs=graphs, bit_identical_steps=len(seen[0]) if eager else 0,
        graphed={k: _ms_stats(v) for k, v in times.items()},
        eager={k: _ms_stats(v) for k, v in eager_ms.items()},
        prefill_by_len={n: {"graphed": _ms_stats(by_len.get(n, [])),
                            "eager": _ms_stats(eager_by_len.get(n, []))}
                        for n in sorted({len(r.prompt) for r in reqs})},
        replay_kernels={k: v.get("device_ops") for k, v in replay.items()},
        replay_profile=replay)
    return [r.out for r in reqs], stats, counts


def print_graphed(phase, stats):
    """One line: a graphed serve run's ms a prefill and a decode token
    (median, p90) beside the eager steps', the device kernels of one
    replay (the profiler's count: the wrappers count at capture), the
    capture seconds and the graphs' pool bytes; then the median prefill
    ms by prompt length, graphed (None: that length only captured) and
    eager."""
    g, gr, ea = stats["graphs"], stats["graphed"], stats["eager"]
    by_len = {n: (t["graphed"]["median"], t["eager"]["median"])
              for n, t in stats["prefill_by_len"].items()}
    print(f"serve graphed {phase}: prefill ms median {gr['prefill']['median']}"
          f" p90 {gr['prefill']['p90']} (eager {ea['prefill']['median']} / "
          f"{ea['prefill']['p90']}); by prompt length (graphed, eager): "
          f"{by_len}; decode ms a token median "
          f"{gr['decode']['median']} p90 {gr['decode']['p90']} (eager "
          f"{ea['decode']['median']} / {ea['decode']['p90']}); device "
          f"kernels a replay {stats['replay_kernels']} (profiler); "
          f"{g['prefill_graphs']} prefill and {g['decode_graphs']} decode "
          f"graphs, capture {g['capture_s']:.3f} s (prefill, per prompt "
          f"length: {g['prefill_capture_s']}), pool {g['pool_bytes']} "
          f"bytes; logits bit-identical over {stats['bit_identical_steps']} "
          f"steps", flush=True)


def graphed_record(stats):
    """The graphed run's numbers for a phase's log."""
    return {k: stats[k] for k in ("graphs", "graphed", "eager",
                                  "prefill_by_len", "replay_kernels",
                                  "bit_identical_steps")}


def graphed_launches(stats, per_prefill, per_decode):
    """The launch counts a graphed ``serve_requests`` run leaves: each
    captured graph's body is called twice (its warm-up and its capture),
    a prefill's with ``per_prefill`` launches, a decode step's with
    ``per_decode``."""
    g = stats["graphs"]
    return 2 * (per_prefill * g["prefill_graphs"]
                + per_decode * g["decode_graphs"])


def b7_device_len_check(what, q, k, v, kw, whole_tiles=True):
    """B7 reading its start from the device (``start``: the cache's rows
    before the call, kv_len = start + S): captured once in a CUDA graph
    over the decode operands ``q`` (B, S, H, dh) and the cache views ``k``
    / ``v`` (B, T, KV, dh), then replayed with the start rewritten so
    that kv_len is 1 (or S), one tile less one, one tile, one tile plus
    one, the first split boundary at the capacity's cut, T, and, with
    ``whole_tiles``, every whole tile count between (every split count
    the grid must hold: the kernel's cut is not monotone in the tiles;
    the CPU test ``test_device_start_grid_holds_every_live_length``
    covers them at any capacity).  Each replay is
    bit-identical to the host-int call and within one bf16 step of a
    probability times max|v| of the Pallas recurrence at the live
    length's tiles and splits.  At most ``B7_REC_BEYOND`` of the outputs
    lie beyond one bf16 step of it: of each call at the edge lengths, and
    of the whole-tile lengths' outputs together (a rate: one decode row
    of zamba2's has 2,560 outputs, and three flipped roundings there are
    0.12 %)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    s, t = q.shape[1], k.shape[1]
    prefix = kw.get("prefix_len", 0)
    cap = fa.flash_route(q.shape, k.shape, q.dtype, causal=True,
                         prefix_len=prefix, kv_len=t, q_start=t - s)
    bk = cap.block_k
    n_tiles = -(-t // bk)
    boundary = -(-n_tiles // (cap.splits or 1)) * bk
    edges = {max(s, n) for n in (1, bk - 1, bk, bk + 1, boundary, t)
             if max(s, n) <= t}
    tiles = {n for n in range(2 * bk, t, bk) if n >= s and whole_tiles} \
        - edges
    start = torch.zeros((), dtype=torch.int32, device=q.device)
    call = dict(causal=True, prefix_len=prefix, kv_len=s, start=start)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_attention(q, k, v, **call)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_attention(q, k, v, **call)
    worst, beyond, pooled = 0.0, 0.0, [0, 0]
    for n in sorted(edges | tiles):
        host = dict(causal=True, prefix_len=prefix, kv_len=n, q_start=n - s)
        start.fill_(n - s)
        graph.replay()
        want = fa.flash_attention(q, k, v, **host)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise RuntimeError(f"{what}: B7 at device kv_len {n} is not the "
                               f"host call's output")
        route = fa.flash_route(q.shape, k.shape, q.dtype, **host)
        rec = fa.flash_attention_recurrence(
            q, k, v, block_k=route.block_k, splits=route.splits,
            **host).float()
        off = (out.float() - rec).abs()
        n_beyond = int((off > 1e-6 + 2.0 ** -7 * rec.abs()).sum())
        share = n_beyond / off.numel()
        top, v_max = float(off.max()), float(v[:, :n].float().abs().max())
        if n in tiles:
            pooled[0] += n_beyond
            pooled[1] += off.numel()
        if not ((n in tiles or share <= B7_REC_BEYOND)
                and top <= B7_REC_MAX_OF_V * v_max):
            raise RuntimeError(f"{what}: B7 at device kv_len {n} off the "
                               f"recurrence: {share:.2e} beyond one bf16 "
                               f"step, max {top}")
        worst, beyond = max(worst, top), max(beyond, share)
    tiles_share = pooled[0] / max(pooled[1], 1)
    if tiles_share > B7_REC_BEYOND:
        raise RuntimeError(f"{what}: B7 over the whole-tile lengths off the "
                           f"recurrence: {tiles_share:.2e} beyond one bf16 "
                           f"step")
    del graph
    return {"lengths": sorted(edges | tiles), "capacity": t, "block_k": bk,
            "capacity_splits": cap.splits,
            "grid_splits": fa.device_start_splits(
                q.shape, k.shape, q.dtype, causal=True, prefix_len=prefix),
            "bit_identical_to_host": True,
            "recurrence_max_abs_err": worst,
            "recurrence_beyond_one_step_worst_call": beyond,
            "recurrence_beyond_one_step_whole_tiles": tiles_share}


#: B7 at a device start over decode shapes no serve phase's captured
#: operands give (B, S, T, H, KV, dh): deepseek-moe-16b's 16 kv heads
#: (the split-KV route aims for 16 splits) and a decode batch of 2
B7_DEVICE_LEN_SHAPES = {"deepseek_decode": (1, 1, 2081, 16, 16, 128),
                        "batch2_decode": (2, 1, 2100, 40, 8, 128)}


def b7_device_len_shapes(dev):
    """``b7_device_len_check`` at each of ``B7_DEVICE_LEN_SHAPES``, on
    operands from a seeded generator."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    out = {}
    for name, (b, s, t, h, kvh, dh) in B7_DEVICE_LEN_SHAPES.items():
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((b, s, h, dh), (b, t, kvh, dh),
                                          (b, t, kvh, dh)))
        out[name] = b7_device_len_check(f"lm_serve {name}", q, k, v,
                                        {"causal": True})
    return out


def lm_step_times(s: Smoke, cfg, params, batch, max_len,
                  profile_prefill=True):
    """Host ms of three prefills of ``batch`` (each into a fresh cache)
    and of ``DECODE_TIMED_STEPS`` greedy decode steps after the last, and
    a profile of one more of each (of the prefill only with
    ``profile_prefill``).  Fails unless the last position's logits are
    finite and of the vocabulary's width."""
    import torch
    from repro_torch.models import model as tm
    b = batch["tokens"].shape[0]
    prefill_ms = []
    for _ in range(3):
        cache = tm.init_decode_cache(cfg, b, max_len)
        ms, (logits, cache) = host_ms(
            lambda: tm.prefill(params, cfg, batch, cache))
        prefill_ms.append(ms)
    if tuple(logits.shape) != (b, 1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{cfg.name}: prefill logits "
                           f"{tuple(logits.shape)} not finite")
    nxt = torch.argmax(logits[:, -1], -1)[:, None]
    decode_ms = []
    for _ in range(DECODE_TIMED_STEPS):
        ms, (lg, cache) = host_ms(
            lambda: tm.decode_step(params, cfg, nxt, cache))
        decode_ms.append(ms)
        nxt = torch.argmax(lg[:, -1], -1)[:, None]
    fresh = tm.init_decode_cache(cfg, b, max_len)
    prof_prefill = s.profile(
        lambda: tm.prefill(params, cfg, batch, fresh), [],
        classify=_lm_kernel_class) if profile_prefill else None
    prof_decode = s.profile(
        lambda: tm.decode_step(params, cfg, nxt, cache), [],
        classify=_lm_kernel_class)
    return {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "decode_ms_median": statistics.median(decode_ms),
            "profile_prefill": prof_prefill, "profile_decode": prof_decode}


def phase_lm_serve(s: Smoke):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cam_search
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as tm

    # (a) serve, full model, bf16 ------------------------------------------
    cfg = dataclasses.replace(get_config(LM_ARCH), **LM_OVERRIDES)
    s.reset_peak()
    params, init_ms, n_params, params_gb = lm_params(cfg)
    dev = params["embed"]["tok"].device
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, SERVE_PROMPT)
               for _ in range(SERVE_REQUESTS)]
    max_len = SERVE_PROMPT + SERVE_NEW + 1

    n_layers = cfg.n_layers
    tokens, stats, counts = serve_requests(cfg, params, prompts, SERVE_NEW,
                                           SERVE_BATCH, max_len, profile=s)
    s.only("lm_serve", counts, "flash_attention",
           graphed_launches(stats, n_layers, n_layers))
    print_graphed("lm_serve", stats)
    mixed = [rng.integers(1, cfg.vocab, n) for n in SERVE_MIXED_PROMPTS]
    _, stats2, counts2 = serve_requests(cfg, params, mixed, SERVE_MIXED_NEW,
                                        SERVE_BATCH, max_len)
    s.only("lm_serve (mixed lengths)", counts2, "flash_attention",
           graphed_launches(stats2, n_layers, n_layers))
    print_graphed("lm_serve mixed lengths", stats2)

    # B7's operands at the model's shapes: layers 0 and L-1 of an untimed
    # prefill of request 0's prompt (calls 0 and L-1) and of its first
    # decode step (calls L and 2L-1), on a cache of the Server's shape
    toks = torch.as_tensor(prompts[0], device=dev)[None]
    wanted = {0: "prefill_layer0", n_layers - 1: "prefill_last_layer",
              n_layers: "decode_layer0", 2 * n_layers - 1: "decode_last_layer"}
    with intercept(fa, "flash_attention", operands(wanted)) as kept:
        lg, cache_c = tm.prefill(params, cfg, {"tokens": toks},
                                 tm.init_decode_cache(cfg, 1, max_len))
        tm.decode_step(params, cfg, torch.argmax(lg[:, -1], -1)[:, None],
                       cache_c)
    captured = {name: ops for name, ops in kept if name}
    if len(kept) != 2 * n_layers or len(captured) != len(wanted):
        raise RuntimeError(f"lm_serve: captured {sorted(captured)} of "
                           f"{len(kept)} B7 calls")
    if int(torch.argmax(lg[0, -1])) != tokens[0][0]:
        raise RuntimeError("lm_serve: the capture run's first token is not "
                           "the served one")
    del cache_c

    # per-step times, the prefill logits, and where the time goes
    steps = lm_step_times(s, cfg, params, {"tokens": toks}, max_len)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    serve_log = {
        "model": LM_ARCH, "layers": n_layers, "d_model": cfg.d_model,
        "param_count_config": cfg.param_count(), "params": n_params,
        "params_gb": params_gb, "init_ms": init_ms,
        "requests": SERVE_REQUESTS, "batch": SERVE_BATCH,
        "prompt": SERVE_PROMPT, "max_new": SERVE_NEW,
        "b7_launches": counts["flash_attention"],
        **graphed_record(stats),
        "mixed_lengths": {"prompts": list(SERVE_MIXED_PROMPTS),
                          "max_new": SERVE_MIXED_NEW,
                          **graphed_record(stats2)},
        "device_len_b7": b7_device_len_check(
            "lm_serve decode", *captured["decode_layer0"]),
        "device_len_b7_shapes": b7_device_len_shapes(dev),
        "run_wall_s": [stats["wall_s"], stats2["wall_s"]],
        "tokens_per_s": [stats["tokens_per_s"], stats2["tokens_per_s"]],
        "stats": {k: stats[k] for k in ("prefills", "decode_steps",
                                        "tokens")},
        **steps, "peak_gb": peak_gb, "tokens_first_request": tokens[0][:8]}
    del params
    torch.cuda.empty_cache()

    # (c) B7 against its plain version at the model's shapes -------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    kvh, dh = cfg.n_kv_heads, cfg.head_dim

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    rows = DECODE_32K_ROWS
    captured["decode_32k"] = (rand(1, 1, cfg.n_heads, dh),
                              rand(1, rows, kvh, dh), rand(1, rows, kvh, dh),
                              dict(causal=True, q_start=rows - 1,
                                   kv_len=rows))
    checks = {name: b7_check(f"lm_serve {name}", *ops)
              for name, ops in captured.items()}
    err_bf16 = max(c["max_abs_err"] for c in checks.values())
    torch.cuda.synchronize()
    shapes = {name: b7_timing(*captured[name])
              for name in ("prefill_layer0", "decode_layer0", "decode_32k")}
    pre = shapes["prefill_layer0"]
    s.record("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:124",
             counts["flash_attention"], err_bf16, pre["ms"],
             pre["plain_ms"], pre["bound_ms"], pre["bound_by"],
             pre["library_ms"])
    s.kernels["flash_attention"]["shapes"] = shapes
    del captured
    torch.cuda.empty_cache()

    # (b) cache consistency, full width, float32, reduced depth ----------
    cfg32 = dataclasses.replace(cfg, n_layers=CHECK_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    p32 = tm.init_params(cfg32, seed=0)
    t = torch.as_tensor(prompts[0][:CHECK_PREFILL + CHECK_DECODE],
                        device=dev)[None]
    cam_search.reset_launch_counts()
    full = tm.forward(p32, cfg32, {"tokens": t})
    cache = tm.init_decode_cache(cfg32, 1, CHECK_PREFILL + CHECK_DECODE + 1)
    lg, cache = tm.prefill(p32, cfg32, {"tokens": t[:, :CHECK_PREFILL]},
                           cache)
    outs = [lg]
    for i in range(CHECK_PREFILL, CHECK_PREFILL + CHECK_DECODE):
        lg, cache = tm.decode_step(p32, cfg32, t[:, i:i + 1], cache)
        outs.append(lg)
    torch.cuda.synchronize()
    check_launches = cam_search.LAUNCHES["flash_attention"]
    if check_launches != CHECK_LAYERS * (2 + CHECK_DECODE):
        raise RuntimeError(f"lm_serve: float32 check launched B7 "
                           f"{check_launches} times")
    got = torch.cat(outs, dim=1)[0]
    want = full[0, CHECK_PREFILL - 1:]
    diff = (got - want).abs()
    if not bool((diff <= 0.75 + 0.2 * want.abs()).all()):
        raise RuntimeError(f"lm_serve: prefill+decode off forward by "
                           f"{float(diff.max())}")
    pick = got.argmax(-1)
    at_pick = want.gather(-1, pick[:, None])[:, 0]
    gap = want.max(-1).values - at_pick
    flips = int((pick != want.argmax(-1)).sum())
    if bool(((pick != want.argmax(-1)) & (gap >= 5e-3)).any()):
        raise RuntimeError(f"lm_serve: argmax flips beyond near-ties: gaps "
                           f"{gap.tolist()}")
    del p32, cache, full
    torch.cuda.empty_cache()
    log({"phase": "lm_serve", "ok": True, **serve_log,
         "b7_checks": checks, "b7_shapes": shapes,
         "f32_check": {"layers": CHECK_LAYERS, "prefill": CHECK_PREFILL,
                       "decode_steps": CHECK_DECODE,
                       "b7_launches": check_launches,
                       "max_abs_diff": float(diff.max()),
                       "argmax_flips_near_ties": flips}})


# ---------------------------------------------------------------------------
# the moe, audio and ssm families
# ---------------------------------------------------------------------------


def dot_index_swaps(q, p, got_i, want_i, what: str) -> int:
    """Count the positions where two dot top-k index tensors differ,
    after confirming each as a float64 near-tie: query row ``r``'s exact
    products with both chosen rows agree within ``DOT_RTOL`` of the
    larger ``sum |q_i p_i|``.  Raises on any other difference."""
    import torch
    rows, cols = (got_i != want_i).nonzero(as_tuple=True)
    if rows.numel():
        qr = q[rows].double()
        pa = qr * p[got_i[rows, cols].long()].double()
        pb = qr * p[want_i[rows, cols].long()].double()
        scale = DOT_RTOL * torch.maximum(pa.abs().sum(1),
                                             pb.abs().sum(1))
        bad = ((pa.sum(1) - pb.sum(1)).abs() > scale).nonzero()
        if bad.numel():
            j = int(bad[0, 0])
            raise RuntimeError(
                f"{what}: index difference at ({int(rows[j])}, "
                f"{int(cols[j])}) is not a float64 near-tie: "
                f"{float(pa[j].sum())} vs {float(pb[j].sum())}")
    return int(rows.numel())


def router_check(s: Smoke, what, xt, router_w, k):
    """B2 on one MoE layer's router input (``xt`` (T, D) tokens, the (D,
    E) router): its candidates against its plain version on the same
    padded operands (values within ``DOT_RTOL`` of ``sum |q p|``,
    every index difference a float64 near-tie whose order the kernel's
    own arithmetic gives, ``tf32x3_kernel_dot``); the ``"cam"`` route's
    choices against the ``"dense"`` route's, held to the same; the model's
    call equal to the kernel's.  Times the kernel, its plain version and
    ``x @ W`` + ``topk``, and bounds it on the E real rows."""
    import torch
    from repro_torch.kernels import cam_search as tcs, ops
    from repro_torch.models import moe as tmoe
    e = router_w.shape[1]
    q = xt.float().contiguous()
    pats = router_w.T.float().contiguous()
    qp = ops.pad_to_blocks(q, 1, tcs.BLOCK_K)
    pp = ops.pad_to_blocks(pats, tcs.window_rows(k), tcs.BLOCK_K)
    kw = dict(metric="dot", k=k, largest=True, n_valid=e)
    got_v, got_i = tcs.fused_topk(qp, pp, **kw)
    want_v, want_i = tcs.fused_topk_reference(qp, pp, **kw)
    torch.cuda.synchronize()
    err = (got_v - want_v).abs()
    scale = (q.double().abs() @ pats.double().abs().T).amax(1)
    if not bool((err.double() <= DOT_RTOL * scale[:, None]).all()):
        raise RuntimeError(f"{what}: B2 values off the plain version by "
                           f"{float(err.max())}")
    # the first token's candidates: the kernel's own arithmetic, bit for bit
    replayed = tcs.tf32x3_kernel_dot(qp[[0] * k], pp[got_i[0].long()])
    if not torch.equal(replayed, got_v[0]):
        raise RuntimeError(f"{what}: B2's values {got_v[0].tolist()} are not "
                           f"its arithmetic's {replayed.tolist()}")
    swaps = dot_index_swaps(qp, pp, got_i, want_i, f"{what} B2")
    _, swaps_exact = b2_order_reproduced(
        qp, pp, got_v, got_i, want_i, k, True, f"{what} B2",
        replay=tcs.tf32x3_kernel_dot)
    _, dense_i = tmoe.router_topk(xt, router_w, k, "dense")
    route_diff = dot_index_swaps(qp, pp, got_i, dense_i.int(),
                                 f"{what} cam vs dense")
    b2_order_reproduced(qp, pp, got_v, got_i, dense_i.int(), k, True,
                        f"{what} cam vs dense", replay=tcs.tf32x3_kernel_dot)
    _, cam_i = tmoe.router_topk(xt, router_w, k, "cam")
    if not torch.equal(cam_i.int(), got_i):
        raise RuntimeError(f"{what}: the router's B2 call differs from the "
                           f"kernel's")
    bound, by = s.float_bound_ms(q, pats, k)
    xf, wf = xt.float(), router_w.float()
    reps = 20
    return {"tokens": q.shape[0], "d": q.shape[1], "experts": e, "k": k,
            "padded_patterns": list(pp.shape),
            "max_abs_err": float(err.max()),
            "index_swaps_float64_near_ties": swaps,
            "swaps_equal_to_replay": swaps_exact,
            "cam_vs_dense_index_differences": route_diff,
            "ms": cuda_ms(lambda: tcs.fused_topk(qp, pp, **kw), reps),
            "route_ms": cuda_ms(
                lambda: tmoe.router_topk(xt, router_w, k, "cam"), reps),
            "dense_route_ms": cuda_ms(
                lambda: tmoe.router_topk(xt, router_w, k, "dense"), reps),
            "plain_ms": cuda_ms(
                lambda: tcs.fused_topk_reference(qp, pp, **kw), 5),
            "bound_ms": bound, "bound_by": by,
            "library_ms": cuda_ms(lambda: torch.topk(xf @ wf, k), reps)}


def _record_router(s: Smoke, counts, checks):
    """Add the phase's B2 launches and router shapes to B2's record; a
    run without ``knn_eucl`` takes the first shape's numbers."""
    s.record("fused_topk", "src/repro_torch/kernels/csrc/fused_topk.cu",
             "src/repro/kernels/cam_search.py:200", counts,
             max(c["max_abs_err"] for c in checks.values()), None, None,
             None, "operations", None)
    rec = s.kernels["fused_topk"]
    rec.setdefault("shapes", {}).update(
        {f"router_{n}": c for n, c in checks.items()})
    if rec["ms"] is None:
        first = next(iter(checks.values()))
        rec.update({key: first[key] for key in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")})


def _record_b7(s: Smoke, counts, checks, shapes):
    """Add a phase's B7 launches and timed shapes to B7's record; a run
    without ``lm_serve`` takes the first shape's numbers."""
    s.record("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:124", counts,
             max(c["max_abs_err"] for c in checks.values()), None, None,
             None, "operations", None)
    rec = s.kernels["flash_attention"]
    rec.setdefault("shapes", {}).update(shapes)
    if rec["ms"] is None and shapes:
        first = next(iter(shapes.values()))
        rec.update({key: first[key] for key in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")})


def _logits_close(what, got, want, atol):
    """Fail unless float32 logits agree within ``atol``; the largest
    difference."""
    import torch
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{what}: logits {tuple(got.shape)} against "
                           f"{tuple(want.shape)}, or not finite")
    diff = float((got - want).abs().max())
    if not diff <= atol:
        raise RuntimeError(f"{what}: logits off the plain versions by {diff} "
                           f"(bound {atol})")
    return diff


def lm_f32_against_plain(what, cfg, params, batch, n_prefill, n_decode):
    """``forward`` over ``batch``'s tokens, then ``prefill`` of the first
    ``n_prefill`` and ``n_decode`` teacher-forced decode steps, on the card
    with its kernels and again through their plain versions
    (``plain_kernels``), in float32: each within ``B7_F32_ATOL``.  The
    decode cache is float32 too: over the default bfloat16 cache B7 rounds
    the unnormalised probabilities to bf16 where its plain version rounds
    the normalised ones (up to one bf16 step; the bf16 B7 checks hold
    that).  Returns the kernels' launches in the card's run and the
    largest differences."""
    import torch
    from repro_torch.kernels import cam_search
    from repro_torch.models import model as tm
    toks = batch["tokens"]

    def run():
        full = tm.forward(params, cfg, batch)
        cache = tm._tree_map(
            lambda t: t.float() if isinstance(t, torch.Tensor)
            and t.is_floating_point() else t,
            tm.init_decode_cache(cfg, toks.shape[0],
                                 n_prefill + n_decode + 1))
        lg, cache = tm.prefill(params, cfg,
                               dict(batch, tokens=toks[:, :n_prefill]), cache)
        outs = [lg]
        for i in range(n_prefill, n_prefill + n_decode):
            lg, cache = tm.decode_step(params, cfg, toks[:, i:i + 1], cache)
            outs.append(lg)
        torch.cuda.synchronize()
        return full, torch.cat(outs, dim=1)

    cam_search.reset_launch_counts()
    full, served = run()
    counts = dict(cam_search.LAUNCHES)
    with plain_kernels():
        full_p, served_p = run()
    return counts, {
        "forward": _logits_close(f"{what} forward", full, full_p,
                                 B7_F32_ATOL),
        "prefill_decode": _logits_close(f"{what} prefill+decode", served,
                                        served_p, B7_F32_ATOL),
        "max_abs_logit": float(full_p.abs().max())}


def _moe_serve_uncut(s: Smoke, cfg, prompts):
    """(a) and (b): the model served with each router, the choices of
    both compared; B2 at the router's prefill and decode shapes."""
    import dataclasses
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as tm
    from repro_torch.models import moe as tmoe
    params, init_ms, n_params, params_gb = lm_params(cfg)
    dev = params["embed"]["tok"].device
    max_len = SERVE_PROMPT + SERVE_NEW + 1
    n_moe = cfg.n_layers - cfg.first_dense_layers
    k = cfg.moe_top_k
    runs, routes = {}, {}
    for offload in ("cam", "dense"):
        c = dataclasses.replace(cfg, router_offload=offload)
        chosen = []

        @contextlib.contextmanager
        def routed():
            """The eager steps' router choices, call by call."""
            with intercept(tmoe, "router_topk",
                           lambda i, a, kw, out: out[1]) as kept:
                yield
            chosen.extend(kept)
        tokens, stats, counts = serve_requests(
            c, params, prompts, SERVE_NEW, SERVE_BATCH, max_len,
            eager_ctx=routed, profile=s)
        s.exactly(f"moe_serve {cfg.name} ({offload})", counts, {
            "flash_attention": graphed_launches(stats, cfg.n_layers,
                                                cfg.n_layers),
            "fused_topk": graphed_launches(stats, n_moe, n_moe)
            if offload == "cam" else 0})
        print_graphed(f"moe_serve {cfg.name} ({offload})", stats)
        routes[offload] = chosen
        toks = torch.as_tensor(prompts[0], device=dev)[None]
        runs[offload] = {
            "tokens": tokens, "wall_s": stats["wall_s"],
            "tokens_per_s": stats["tokens_per_s"], "launches": counts,
            **graphed_record(stats),
            "stats": {key: stats[key] for key in ("prefills", "decode_steps",
                                                  "tokens")},
            **lm_step_times(s, c, params, {"tokens": toks}, max_len)}
    if len(routes["cam"]) != len(routes["dense"]):
        raise RuntimeError("moe_serve: the two runs routed different calls")
    same = sum(int((a == b).sum()) for a, b in zip(routes["cam"],
                                                   routes["dense"]))
    total = sum(a.numel() for a in routes["cam"])
    # the first router call whose choices differ (a near-tie): later calls
    # see hidden states, and after a differing token contexts, that differ
    first_diff = next((i for i, (a, b) in enumerate(
        zip(routes["cam"], routes["dense"])) if not torch.equal(a, b)), None)
    equal_tokens = sum(x == y for a, b in zip(runs["cam"]["tokens"],
                                              runs["dense"]["tokens"])
                       for x, y in zip(a, b))
    n_calls = len(routes["cam"])
    del routes

    # (b) B2 at the router: the first MoE layer's input in request 0's
    # prefill (call 0) and first decode step (call n_moe)
    # and B7 at the model's attention shapes: layer 0 of the same
    # prefill (call 0) and decode step (call n_layers)
    toks = torch.as_tensor(prompts[0], device=dev)[None]
    c = dataclasses.replace(cfg, router_offload="cam")
    at = {0: "prefill", n_moe: "decode"}
    with intercept(tmoe, "router_topk", lambda i, a, kw, out: (
            at[i], a[:2]) if i in at else None) as routed, \
            intercept(fa, "flash_attention", operands(
                {0: "prefill", cfg.n_layers: "decode"})) as attended:
        lg, cache = tm.prefill(params, c, {"tokens": toks},
                               tm.init_decode_cache(c, 1, max_len))
        tm.decode_step(params, c, torch.argmax(lg[:, -1], -1)[:, None],
                       cache)
    del cache
    checks = {f"{cfg.name}_{name}": router_check(
        s, f"moe_serve {cfg.name} router {name}", xt, w, k)
        for name, (xt, w) in routed}
    captured = {name: ops for name, ops in attended if name}
    b7 = {f"{cfg.name}_{name}": b7_check(f"moe_serve {cfg.name} {name}",
                                         *ops)
          for name, ops in captured.items()}
    b7_shapes = {f"{cfg.name}_{name}": b7_timing(*ops)
                 for name, ops in captured.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params, routed, attended, captured
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": cfg.n_layers,
            "moe_layers": n_moe, "experts": cfg.n_experts, "top_k": k,
            "param_count_config": cfg.param_count(), "params": n_params,
            "params_gb": params_gb, "init_ms": init_ms,
            "requests": len(prompts), "prompt": SERVE_PROMPT,
            "max_new": SERVE_NEW, "batch": SERVE_BATCH, "runs": runs,
            "choices_agreeing": same / total, "choices": total,
            "first_differing_router_call": first_diff,
            "router_calls": n_calls,
            "equal_tokens": equal_tokens,
            "tokens": sum(len(t) for t in runs["cam"]["tokens"]),
            "peak_gb": peak_gb, "b7_checks": b7}, checks, b7, b7_shapes


def phase_moe_serve(s: Smoke):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm

    # (a), (b): deepseek-moe-16b uncut, both routers
    cfg = dataclasses.replace(get_config(MOE_ARCH), **MOE_OVERRIDES)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, SERVE_PROMPT)
               for _ in range(SERVE_REQUESTS)]
    s.reset_peak()
    deepseek, checks, b7, b7_shapes = _moe_serve_uncut(s, cfg, prompts)
    b2_launches = deepseek["runs"]["cam"]["launches"]["fused_topk"]
    b7_launches = sum(r["launches"]["flash_attention"]
                      for r in deepseek["runs"].values())

    # (c) float32 at depth MOE_CHECK_LAYERS, no token dropped: the card's
    # kernels against their plain versions
    cfg32 = dataclasses.replace(
        cfg, n_layers=MOE_CHECK_LAYERS, param_dtype="float32",
        compute_dtype="float32", capacity_factor=MOE_CHECK_CAPACITY,
        router_offload="cam")
    p32 = tm.init_params(cfg32, seed=0)
    t = torch.as_tensor(prompts[0][:CHECK_PREFILL + CHECK_DECODE],
                        device=p32["embed"]["tok"].device)[None]
    counts32, diffs32 = lm_f32_against_plain(
        "moe_serve float32", cfg32, p32, {"tokens": t}, CHECK_PREFILL,
        CHECK_DECODE)
    calls = 2 + CHECK_DECODE
    s.exactly("moe_serve float32", counts32, {
        "flash_attention": MOE_CHECK_LAYERS * calls,
        "fused_topk": (MOE_CHECK_LAYERS - cfg.first_dense_layers) * calls})
    del p32
    torch.cuda.empty_cache()

    # (d) phi3.5-moe at full width, depth cut, the "cam" router
    pcfg = dataclasses.replace(get_config(PHI_ARCH), router_offload="cam",
                               **PHI_OVERRIDES)
    params, init_ms, n_params, params_gb = lm_params(pcfg)
    dev = params["embed"]["tok"].device
    s.reset_peak()
    rng = np.random.default_rng(1)
    pprompts = [rng.integers(1, pcfg.vocab, SERVE_PROMPT)
                for _ in range(PHI_REQUESTS)]
    max_len = SERVE_PROMPT + PHI_NEW + 1
    ptokens, pstats, pcounts = serve_requests(
        pcfg, params, pprompts, PHI_NEW, SERVE_BATCH, max_len, profile=s)
    calls = graphed_launches(pstats, pcfg.n_layers, pcfg.n_layers)
    s.exactly("moe_serve phi3.5", pcounts, {"flash_attention": calls,
                                            "fused_topk": calls})
    print_graphed("moe_serve phi3.5", pstats)
    toks = torch.as_tensor(pprompts[0], device=dev)[None]
    from repro_torch.models import moe as tmoe
    with intercept(tmoe, "router_topk",
                   lambda i, a, kw, out: a[:2] if i == 0 else None) as kept:
        phi_steps = lm_step_times(s, pcfg, params, {"tokens": toks}, max_len)
    checks[f"{pcfg.name}_prefill"] = router_check(
        s, f"moe_serve {pcfg.name} router prefill", *kept[0], pcfg.moe_top_k)
    phi = {"model": pcfg.name, "layers": pcfg.n_layers,
           "reduced": {"n_layers": [get_config(PHI_ARCH).n_layers,
                                    pcfg.n_layers]},
           "param_count_config": pcfg.param_count(), "params": n_params,
           "params_gb": params_gb, "init_ms": init_ms,
           "requests": PHI_REQUESTS, "prompt": SERVE_PROMPT,
           "max_new": PHI_NEW, "wall_s": pstats["wall_s"],
           "tokens_per_s": pstats["tokens_per_s"], "launches": pcounts,
           **graphed_record(pstats),
           "tokens_first_request": ptokens[0][:8], **phi_steps,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, kept
    torch.cuda.empty_cache()
    b2_launches += pcounts["fused_topk"]
    b7_launches += pcounts["flash_attention"]
    _record_router(s, b2_launches, checks)
    _record_b7(s, b7_launches, b7, b7_shapes)
    log({"phase": "moe_serve", "ok": True, "deepseek": deepseek,
         "router_checks": checks,
         "f32_check": {"layers": MOE_CHECK_LAYERS,
                       "capacity_factor": MOE_CHECK_CAPACITY,
                       "prefill": CHECK_PREFILL, "decode_steps": CHECK_DECODE,
                       "launches": counts32, "max_abs_diff": diffs32},
         "phi": phi, "b2_launches": b2_launches, "b7_launches": b7_launches})


def phase_audio_serve(s: Smoke):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as tm

    cfg = dataclasses.replace(get_config(AUDIO_ARCH), **AUDIO_OVERRIDES)
    s.reset_peak()
    params, init_ms, n_params, params_gb = lm_params(cfg)
    dev = params["embed"]["tok"].device
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, AUDIO_PROMPT)
               for _ in range(AUDIO_REQUESTS)]
    max_len = AUDIO_PROMPT + AUDIO_NEW + 1
    tokens, stats, counts = serve_requests(cfg, params, prompts, AUDIO_NEW,
                                           SERVE_BATCH, max_len, profile=s)
    # a prefill: the encoder's layers, then each decoder layer's self- and
    # cross-attention; a decode step: the decoder's two
    per_prefill = cfg.n_encoder_layers + 2 * cfg.n_layers
    s.exactly("audio_serve", counts, {
        "flash_attention": graphed_launches(stats, per_prefill,
                                            2 * cfg.n_layers)})
    print_graphed("audio_serve", stats)

    # B7's operands at whisper's non-causal shapes, from an untimed
    # prefill and decode step of request 0 over the served zero frames:
    # encoder layer 0 (call 0), the first decoder layer's cross-attention
    # (call n_enc + 1) and its first decode step's (call per_prefill + 1)
    toks = torch.as_tensor(prompts[0], device=dev)[None]
    frames = torch.zeros((1, cfg.encoder_seq, cfg.d_model),
                         dtype=torch.bfloat16, device=dev)
    batch = {"tokens": toks, "frames": frames}
    wanted = {0: "encoder", cfg.n_encoder_layers + 1: "cross_prefill",
              per_prefill + 1: "cross_decode"}
    with intercept(fa, "flash_attention", operands(wanted)) as kept:
        lg, cache = tm.prefill(params, cfg, batch,
                               tm.init_decode_cache(cfg, 1, max_len))
        tm.decode_step(params, cfg, torch.argmax(lg[:, -1], -1)[:, None],
                       cache)
    captured = {name: ops for name, ops in kept if name}
    if int(torch.argmax(lg[0, -1])) != tokens[0][0]:
        raise RuntimeError("audio_serve: the capture run's first token is "
                           "not the served one")
    del cache
    shapes_seen = {n: (list(c[0].shape), list(c[1].shape), c[3])
                   for n, c in captured.items()}
    if len(kept) != per_prefill + 2 * cfg.n_layers or any(
            c[3].get("causal", True) for c in captured.values()) or \
            captured["cross_decode"][0].shape[1] != 1:
        raise RuntimeError(f"audio_serve: {len(kept)} B7 calls, captured "
                           f"{shapes_seen}")
    steps = lm_step_times(s, cfg, params, batch, max_len)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    checks = {name: b7_check(f"audio_serve {name}", *ops)
              for name, ops in captured.items()}
    shapes = {f"whisper_{name}": b7_timing(*ops)
              for name, ops in captured.items()}
    del params, captured
    torch.cuda.empty_cache()

    # float32 at depth AUDIO_CHECK_LAYERS over seeded random frames
    cfg32 = dataclasses.replace(cfg, n_layers=AUDIO_CHECK_LAYERS,
                                n_encoder_layers=AUDIO_CHECK_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    p32 = tm.init_params(cfg32, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    b = AUDIO_CHECK_BATCH
    t = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab, (b, AUDIO_PROMPT + AUDIO_CHECK_DECODE)), device=dev)
    fr = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                     device=dev)
    counts32, diffs32 = lm_f32_against_plain(
        "audio_serve float32", cfg32, p32, {"tokens": t, "frames": fr},
        AUDIO_PROMPT, AUDIO_CHECK_DECODE)
    s.exactly("audio_serve float32", counts32, {"flash_attention": 2 * (
        AUDIO_CHECK_LAYERS + 2 * AUDIO_CHECK_LAYERS)
        + 2 * AUDIO_CHECK_LAYERS * AUDIO_CHECK_DECODE})
    del p32
    torch.cuda.empty_cache()
    _record_b7(s, counts["flash_attention"], checks, shapes)
    log({"phase": "audio_serve", "ok": True, "model": cfg.name,
         "encoder_layers": cfg.n_encoder_layers, "layers": cfg.n_layers,
         "encoder_seq": cfg.encoder_seq,
         "param_count_config": cfg.param_count(), "params": n_params,
         "params_gb": params_gb, "init_ms": init_ms,
         "requests": AUDIO_REQUESTS, "prompt": AUDIO_PROMPT,
         "max_new": AUDIO_NEW, "batch": SERVE_BATCH,
         "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
         **graphed_record(stats),
         "stats": {k: stats[k] for k in ("prefills", "decode_steps",
                                         "tokens")},
         "b7_launches": counts["flash_attention"],
         "tokens_first_request": tokens[0][:8], **steps, "peak_gb": peak_gb,
         "b7_checks": checks, "b7_shapes": shapes,
         "f32_check": {"layers": AUDIO_CHECK_LAYERS, "batch": b,
                       "prompt": AUDIO_PROMPT,
                       "decode_steps": AUDIO_CHECK_DECODE,
                       "launches": counts32, "max_abs_diff": diffs32}})


# ---------------------------------------------------------------------------
# M1 (the Mamba2 chunked scan) and X1 (the sLSTM recurrence): checks,
# bounds, records
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def uncounted():
    """Within the block kernel launches leave the launch counts as they
    were: the calls a check makes inside a counted run."""
    from repro_torch.kernels import cam_search
    saved = dict(cam_search.LAUNCHES)
    try:
        yield
    finally:
        cam_search.LAUNCHES.update(saved)


def m1_bound_ms(xh, B_, chunk):
    """M1's bound: the multiply-adds its function needs, counted over the
    rows this call holds (each chunk's causal C.B^T, once for its heads,
    and per head its causal intra-chunk product, the entering state's term,
    its own state contribution and the state update), on the tensor cores
    (C.B^T in bf16 at 989 TFLOP/s for bf16 operands, 3xTF32 at 495
    TFLOP/s for float32 ones; W x, C h^T and (w x)^T B as the TF32
    passes the design runs, two in bf16, three in float32; the state
    update a float32 FMA), against the bytes of xh, B_, C_, dt and y and
    the two states.  The design forms C.B^T again for every head, on
    TF32 (``m1_slices.py`` times what that costs); the bound counts it
    once a chunk.  Returns (ms, what bounds it, the float32-FMA figure of
    the same multiply-adds at 67 TFLOP/s: the bound of the earlier FMA
    design)."""
    import torch
    b, s, nh, dh = xh.shape
    ds = B_.shape[-1]
    cb = prod = upd = 0.0
    for c0 in range(0, s, chunk):
        r = min(chunk, s - c0)
        tri = r * (r + 1) / 2.0
        cb += tri * ds
        prod += nh * (tri * dh + 2.0 * r * dh * ds)
        upd += nh * dh * ds
    bf16 = xh.dtype == torch.bfloat16
    t_cb = 2.0 * b * cb / BF16_PEAK_FLOPS if bf16 \
        else 3 * 2.0 * b * cb / TF32_PEAK_FLOPS
    t_tc = t_cb + (2 if bf16 else 3) * 2.0 * b * prod / TF32_PEAK_FLOPS \
        + 2.0 * b * upd / FP32_PEAK_FLOPS
    t_fp32 = 2.0 * b * (cb + prod + upd) / FP32_PEAK_FLOPS
    el = xh.element_size()
    bytes_ = (el * b * s * (2 * nh * dh + 2 * ds) + 4.0 * b * s * nh
              + 8.0 * b * nh * dh * ds)
    t_mem = bytes_ / HBM_BYTES_PER_S
    return 1e3 * max(t_tc, t_mem), "operations" if t_tc >= t_mem \
        else "bytes", 1e3 * max(t_fp32, t_mem)


def event_ms(fn):
    """Device milliseconds of one call of ``fn`` (CUDA events, no warm-up)
    and its result: a long call timed once."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1), out


def within_rows(got, want, rtol, of_max, rows=16384):
    """(largest |got - want|, whether each lies within rtol |want| +
    of_max max|want|, max|want|), compared in float32 blocks of ``rows``
    along dim 1 (a 524,288-row y in float32 is 10.7 GB a copy)."""
    spans = range(0, want.shape[1], rows)
    top = max(float(want[:, i:i + rows].float().abs().max()) for i in spans)
    worst, ok = 0.0, True
    for i in spans:
        g, w = got[:, i:i + rows].float(), want[:, i:i + rows].float()
        diff = (g - w).abs()
        worst = max(worst, float(diff.max()))
        ok = ok and bool((diff <= rtol * w.abs() + of_max * top).all())
    return worst, ok, top


def m1_check(what, args, kw, out=None, timed=True):
    """M1 (``kss.ssd_scan``) on one call's operands against its plain
    version (``ssd_scan_reference``): y within one step of its dtype
    (2**-7 |y| in bf16, 1e-4 |y| in float32) plus ``M1_OF_MAX`` of max|y|,
    the final state within 1e-4 |h| plus ``M1_OF_MAX`` of max|h| (float32
    sums in other orders); the kernel again bit-identical to ``out`` (the
    path's own result) where given.  With ``timed``, the kernel's device
    ms (median of 3), the plain version's (its checking call, timed once)
    and the bound.  Returns the record."""
    import torch
    from repro_torch.kernels import ssd_scan as kss
    got = kss.ssd_scan(*args, **kw)
    plain_ms, want = event_ms(lambda: kss.ssd_scan_reference(*args, **kw))
    rtol = 2.0 ** -7 if args[0].dtype == torch.bfloat16 else 1e-4
    errs, tops = {}, {}
    for name, g, w, rt in (("y", got[0], want[0], rtol),
                           ("state", got[1], want[1], 1e-4)):
        errs[name], ok, tops[name] = within_rows(g, w, rt, M1_OF_MAX)
        if not ok:
            raise RuntimeError(f"{what}: M1's {name} off its plain version by "
                               f"{errs[name]}")
    if out is not None and not (torch.equal(got[0], out[0])
                                and torch.equal(got[1], out[1])):
        raise RuntimeError(f"{what}: M1 again is not the path's own result")
    xh = args[0]
    chunk = kw.get("chunk", args[7] if len(args) > 7 else 256)
    rec = {"xh": list(xh.shape), "ds": args[1].shape[-1], "chunk": chunk,
           "dtype": str(xh.dtype).replace("torch.", ""),
           "max_abs_err": errs["y"], "state_max_abs_err": errs["state"],
           "max_abs_want": tops["y"], "same_as_path": out is not None}
    if timed:
        bound, by, fp32 = m1_bound_ms(xh, args[1], chunk)
        rec.update(ms=cuda_ms(lambda: kss.ssd_scan(*args, **kw), 3),
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   fp32_bound_ms=fp32, library_ms=None,
                   bound_basis="tensor cores: "
                               + ("C.B^T once a chunk in bf16 at 989 "
                                  "TFLOP/s, the other products two TF32 "
                                  "passes at 495 (bf16 operands)"
                                  if xh.dtype == torch.bfloat16
                                  else "3xTF32 at 495 TFLOP/s")
                               + "; fp32_bound_ms: float32 FMAs, 67 TFLOP/s")
    return rec


def x1_bound_ms(pre):
    """X1's bound: its float32 FMAs (the recurrent product, 8 B D^2 S
    FLOP, and about 20 operations a unit and step) at the float32 peak,
    against the bytes of pre, wh, hs and the states."""
    b, s, d4 = pre.shape
    d = d4 // 4
    flops = 2.0 * b * s * d * d4 + 20.0 * b * s * d
    bytes_ = 4.0 * (b * s * d4 + d * d4 + b * s * d + 8 * b * d)
    t_ops, t_mem = flops / FP32_PEAK_FLOPS, bytes_ / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
        else "bytes"


def x1_errors(got, want):
    """X1 against its plain version: hs and h absolutely (|h| <= 1), c
    and n relative to max(|n|, 1), m to max(|m|, 1); each within
    ``X1_TOL``."""
    import torch
    (hs, st), (w_hs, w_st) = got, want
    n_scale = torch.clamp(w_st[2].abs(), min=1.0)
    m_scale = torch.clamp(w_st[3].abs(), min=1.0)
    return {"hs": float((hs - w_hs).abs().max()),
            "h": float((st[0] - w_st[0]).abs().max()),
            "c": float(((st[1] - w_st[1]).abs() / n_scale).max()),
            "n": float(((st[2] - w_st[2]).abs() / n_scale).max()),
            "m": float(((st[3] - w_st[3]).abs() / m_scale).max())}


def x1_check(what, args, out=None, timed=True):
    """X1 (``ksl.slstm_scan``) on one call's operands (pre, wh, h, c, n,
    m) against its plain loop, within ``X1_TOL`` (``x1_errors``); the
    kernel again bit-identical to ``out`` (the path's own result) where
    given.  With ``timed``: the kernel's device ms (median of 3), the
    plain loop's (its checking call, timed once), the bound, the serial
    bound of the earlier barrier design (S grid barriers, each timed alone by
    ``barrier_step_ms``) and the hand-off design's own serial floor (S
    flagged hand-offs, each timed alone by ``handoff_step_ms``).  Returns
    the record."""
    import torch
    from repro_torch.kernels import slstm_scan as ksl
    got = ksl.slstm_scan(*args)
    plain_ms, want = event_ms(lambda: ksl.slstm_scan_reference(*args))
    errs = x1_errors(got, want)
    if not max(errs.values()) <= X1_TOL:
        raise RuntimeError(f"{what}: X1 off its plain loop: {errs}")
    if out is not None and not (torch.equal(got[0], out[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1], out[1]))):
        raise RuntimeError(f"{what}: X1 again is not the path's own result")
    pre = args[0]
    rec = {"pre": list(pre.shape), "max_abs_err": errs["hs"],
           "errors": errs, "same_as_path": out is not None}
    if timed:
        b, s, d4 = pre.shape
        step = ksl.barrier_step_ms(b, d4 // 4, 4096, pre.device)
        hand = ksl.handoff_step_ms(b, d4 // 4, 4096, pre.device)
        bound, by = x1_bound_ms(pre)
        rec.update(ms=cuda_ms(lambda: ksl.slstm_scan(*args), 3),
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   library_ms=None,
                   barrier_step_ms=step, serial_bound_ms=s * step,
                   handoff_step_ms=hand, handoff_serial_bound_ms=s * hand)
    return rec


def _record_scan(s: Smoke, name, launches, checks):
    """Add a phase's M1 or X1 launches and checks to the kernel's record;
    the first timed check gives its ms, plain ms and bounds."""
    source, replaces = SCAN_KERNELS[name]
    s.record(name, source, replaces, launches,
             max(c["max_abs_err"] for c in checks.values()), None, None,
             None, "operations", None)
    rec = s.kernels[name]
    rec["library"] = SCAN_LIBRARY
    rec.setdefault("shapes", {}).update(checks)
    if rec["ms"] is None:
        first = next((c for c in checks.values() if "ms" in c), None)
        if first is not None:
            rec.update({key: first[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
            for key in ("serial_bound_ms", "handoff_serial_bound_ms",
                        "fp32_bound_ms", "bound_basis"):
                if key in first:
                    rec[key] = first[key]


def keep_call(index):
    """An ``intercept`` keep function: the call numbered ``index`` (or each
    of a set of them) as ((args cloned), kwargs, result cloned)."""
    wanted = {index} if isinstance(index, int) else set(index)
    return lambda i, a, kw, out: (_clone(a), dict(kw), _clone(out)) \
        if i in wanted else None


def x1_batched_checks(cfg, params, prompts, max_len):
    """X1 at the batch the Server decodes (``SERVE_BATCH``; batch 1 runs
    another kernel body), its launches uncounted: a prefill of the first
    ``X1_BATCH_PROMPT`` tokens of ``SERVE_BATCH`` prompts, one step of
    the Server's decode body (one position) run eagerly, then
    ``X1_REPLAYS`` replays of one captured graph of that body, each from
    new tokens and the state the one before left.  X1 on the first and
    the last sLSTM layer of each is held to its plain loop by
    ``x1_check`` and bit-identical to the path's own result; for a replay
    that is the operands and result the replay itself rewrote (the clones
    ``keep_call`` makes inside the capture are part of the graph).
    Returns the records."""
    import numpy as np
    import torch
    from repro_torch.kernels import slstm_scan as ksl
    from repro_torch.launch.serve import _Graphed, _copy_into
    from repro_torch.models import model as tm, steps as ts
    pairs = tm._pairs(cfg)
    layers = (0, pairs - 1)
    dev = params["embed"]["tok"].device
    rng = np.random.default_rng(1)
    decode = ts.make_decode_step(cfg)
    tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int64, device=dev)
    cache = tm.init_decode_cache(cfg, SERVE_BATCH, max_len)
    records = {}

    def body():
        lg, out = decode(params, tok, cache)
        _copy_into(cache, out)
        return lg

    def hold(what, kept, rows):
        if len(kept) != len(layers):
            raise RuntimeError(f"ssm_serve X1 {what}: kept {len(kept)} "
                               f"calls, wanted {len(layers)}")
        for i, (args, _, out) in zip(layers, kept):
            if tuple(args[0].shape[:2]) != (SERVE_BATCH, rows):
                raise RuntimeError(f"ssm_serve X1 {what}: pre "
                                   f"{tuple(args[0].shape)}")
            records[f"xlstm_{what}_layer{i}"] = x1_check(
                f"ssm_serve X1 {what} layer {i}", args, out, timed=False)

    with uncounted():
        toks = torch.as_tensor(np.stack(
            [p[:X1_BATCH_PROMPT] for p in prompts[:SERVE_BATCH]]), device=dev)
        with intercept(ksl, "slstm_scan", keep_call(set(layers))) as kept:
            lg, cache = tm.prefill(params, cfg, {"tokens": toks}, cache)
        hold(f"batch{SERVE_BATCH}_prefill", kept, X1_BATCH_PROMPT)
        tok.copy_(torch.argmax(lg[:, -1], dim=-1, keepdim=True))
        with intercept(ksl, "slstm_scan", keep_call(set(layers))) as kept:
            body()
        hold("decode", kept, 1)
        state = _recurrent_state(cache)
        saved = [t.clone() for t in state]

        def warm():
            body()
            for t, v in zip(state, saved):
                t.copy_(v)
        # the warm-up's calls are 0 .. pairs - 1, the capture's follow
        with intercept(ksl, "slstm_scan",
                       keep_call({pairs + i for i in layers})) as kept:
            graph = _Graphed(body, warm, torch.cuda.graph_pool_handle(), dev)
        for r in range(X1_REPLAYS):
            tok.copy_(torch.as_tensor(
                rng.integers(1, cfg.vocab, (SERVE_BATCH, 1)), device=dev))
            graph()
            torch.cuda.synchronize()
            hold(f"decode_replay{r}", kept, 1)
        del graph
    return records


def phase_ssm_serve(s: Smoke):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cam_search
    from repro_torch.kernels import slstm_scan as ksl
    from repro_torch.models import model as tm

    cfg = dataclasses.replace(get_config(SSM_ARCH), **SSM_OVERRIDES)
    s.reset_peak()
    params, init_ms, n_params, params_gb = lm_params(cfg)
    dev = params["embed"]["tok"].device
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, SERVE_PROMPT)
               for _ in range(SERVE_REQUESTS)]
    max_len = SERVE_PROMPT + SERVE_NEW + 1
    pairs = tm._pairs(cfg)
    tokens, stats, counts = serve_requests(cfg, params, prompts, SERVE_NEW,
                                           SERVE_BATCH, max_len, profile=s)
    # X1 once per sLSTM layer and call, prefill and decode step alike
    s.exactly("ssm_serve", counts,
              {"slstm_scan": graphed_launches(stats, pairs, pairs)})
    print_graphed("ssm_serve", stats)
    toks = torch.as_tensor(prompts[0], device=dev)[None]
    # X1 on the first and the last sLSTM layer's operands of an untimed
    # prefill of request 0's prompt, against its plain loop
    with intercept(ksl, "slstm_scan", keep_call({0, pairs - 1})) as kept:
        tm.prefill(params, cfg, {"tokens": toks},
                   tm.init_decode_cache(cfg, 1, max_len))
    x1 = {f"xlstm_prefill_layer{i}": x1_check(
        f"ssm_serve X1 layer {i}", args, out, timed=i == 0)
        for i, (args, _, out) in zip((0, pairs - 1), kept)}
    x1.update(x1_batched_checks(cfg, params, prompts, max_len))
    steps = lm_step_times(s, cfg, params, {"tokens": toks}, max_len)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()

    # float32 at depth SSM_CHECK_LAYERS: the card against the same model
    # on the CPU, and prefill + decode against forward (the chunked and
    # recurrent forms)
    cfg32 = dataclasses.replace(cfg, n_layers=SSM_CHECK_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    p32 = tm.init_params(cfg32, seed=0)
    n = SSM_CHECK_PREFILL + CHECK_DECODE
    t = torch.as_tensor(prompts[0][:n], device=dev)[None]
    cam_search.reset_launch_counts()
    full = tm.forward(p32, cfg32, {"tokens": t})
    cache = tm.init_decode_cache(cfg32, 1, n + 1)
    lg, cache = tm.prefill(p32, cfg32, {"tokens": t[:, :SSM_CHECK_PREFILL]},
                           cache)
    outs = [lg]
    for i in range(SSM_CHECK_PREFILL, n):
        lg, cache = tm.decode_step(p32, cfg32, t[:, i:i + 1], cache)
        outs.append(lg)
    torch.cuda.synchronize()
    s.exactly("ssm_serve float32", dict(cam_search.LAUNCHES), {
        "slstm_scan": (2 + CHECK_DECODE) * tm._pairs(cfg32)})
    served = torch.cat(outs, dim=1)
    decode_vs_forward = _logits_close(
        "ssm_serve prefill+decode vs forward", served,
        full[:, SSM_CHECK_PREFILL - 1:], SSM_F32_ATOL)
    p_cpu = tm._tree_map(lambda x: x.cpu(), p32)
    cpu_full = tm.forward(p_cpu, cfg32, {"tokens": t.cpu()})
    card_vs_cpu = _logits_close("ssm_serve card vs CPU", full.cpu(),
                                cpu_full, SSM_F32_ATOL)
    del p32, p_cpu, cache
    torch.cuda.empty_cache()
    _record_scan(s, "slstm_scan", counts["slstm_scan"], x1)
    log({"phase": "ssm_serve", "ok": True, "model": cfg.name,
         "layers": cfg.n_layers, "pairs": cfg.n_layers // 2,
         "param_count_config": cfg.param_count(), "params": n_params,
         "params_gb": params_gb, "init_ms": init_ms,
         "requests": SERVE_REQUESTS, "prompt": SERVE_PROMPT,
         "max_new": SERVE_NEW, "batch": SERVE_BATCH,
         "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
         **graphed_record(stats),
         "stats": {k: stats[k] for k in ("prefills", "decode_steps",
                                         "tokens")},
         "launches": counts, "tokens_first_request": tokens[0][:8], **steps,
         "peak_gb": peak_gb, "x1_checks": x1,
         "f32_check": {"layers": SSM_CHECK_LAYERS,
                       "prefill": SSM_CHECK_PREFILL,
                       "decode_steps": CHECK_DECODE,
                       "decode_vs_forward_max_abs_diff": decode_vs_forward,
                       "card_vs_cpu_max_abs_diff": card_vs_cpu}})


# ---------------------------------------------------------------------------
# the hybrid and vlm families: B7 at head dims 80 and 256
# ---------------------------------------------------------------------------


def _serve_and_capture(s: Smoke, phase, cfg, prompts, extra, attn_layers,
                       scans=None):
    """Serve ``prompts`` (SERVE_NEW new tokens each, decode batch
    SERVE_BATCH) with launches exact: ``attn_layers`` B7 calls a prefill
    or decode step, and for each kernel of ``scans`` (name -> launches a
    prefill and a decode step) as many; then, on a second Server, prompts
    of ``SERVE_MIXED_PROMPTS`` lengths, held to the eager steps.  Then
    B7's operands of attention layer 0 in an untimed prefill of request
    0's prompt (``extra(device)`` beside its tokens) and in its first
    decode step, each held to its plain version and the recurrence and
    timed beside SDPA; with ``"ssd_scan"`` among ``scans``, M1 on the first
    Mamba2 block's operands of that prefill held to its plain version and
    timed (the log's ``m1_checks``); the step times and profiles; the peak
    memory of the phase so far.  Returns (log, launches, checks, timed
    shapes); frees the parameters."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as kss
    from repro_torch.models import model as tm
    scans = scans or {}

    def expected(stats):
        per = dict(scans, flash_attention=(attn_layers, attn_layers))
        return {k: graphed_launches(stats, *n) for k, n in per.items()}

    params, init_ms, n_params, params_gb = lm_params(cfg)
    dev = params["embed"]["tok"].device
    max_len = SERVE_PROMPT + SERVE_NEW + 1
    tokens, stats, counts = serve_requests(cfg, params, prompts, SERVE_NEW,
                                           SERVE_BATCH, max_len, profile=s)
    s.exactly(phase, counts, expected(stats))
    print_graphed(phase, stats)
    rng = np.random.default_rng(1)
    _, mixed, counts2 = serve_requests(
        cfg, params, [rng.integers(1, cfg.vocab, n)
                      for n in SERVE_MIXED_PROMPTS],
        SERVE_MIXED_NEW, SERVE_BATCH, max_len)
    s.exactly(f"{phase} (mixed lengths)", counts2, expected(mixed))
    print_graphed(f"{phase} mixed lengths", mixed)
    toks = torch.as_tensor(prompts[0], device=dev)[None]
    batch = {"tokens": toks, **extra(dev)}
    with intercept(fa, "flash_attention", operands(
            {0: "prefill", attn_layers: "decode"})) as kept, \
            intercept(kss, "ssd_scan", keep_call(0)) as kept_m1:
        lg, cache = tm.prefill(params, cfg, batch,
                               tm.init_decode_cache(cfg, 1, max_len))
        tm.decode_step(params, cfg, torch.argmax(lg[:, -1], -1)[:, None],
                       cache)
    m1 = {f"{cfg.name.split('-')[0]}_prefill_block0": m1_check(
        f"{phase} M1 block 0", *call) for call in kept_m1}
    if ("ssd_scan" in scans) != bool(m1):
        raise RuntimeError(f"{phase}: M1 calls {len(kept_m1)} in the "
                           f"capture prefill")
    del kept_m1
    captured = {name: ops for name, ops in kept if name}
    if len(kept) != 2 * attn_layers or len(captured) != 2:
        raise RuntimeError(f"{phase}: captured {sorted(captured)} of "
                           f"{len(kept)} B7 calls")
    if int(torch.argmax(lg[0, -1])) != tokens[0][0]:
        raise RuntimeError(f"{phase}: the capture run's first token is not "
                           f"the served one")
    del cache
    steps = lm_step_times(s, cfg, params, batch, max_len)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    short = cfg.name.split("-")[0]
    checks = {f"{short}_{n}": b7_check(f"{phase} {n}", *ops)
              for n, ops in captured.items()}
    device_len = b7_device_len_check(f"{phase} decode", *captured["decode"])
    shapes = {f"{short}_{n}": b7_timing(*ops) for n, ops in captured.items()}
    del params, captured, kept
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "attention_layers": attn_layers,
            "param_count_config": cfg.param_count(), "params": n_params,
            "params_gb": params_gb, "init_ms": init_ms,
            "requests": len(prompts), "prompt": SERVE_PROMPT,
            "max_new": SERVE_NEW, "batch": SERVE_BATCH,
            "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
            "stats": {k: stats[k] for k in ("prefills", "decode_steps",
                                            "tokens")},
            "b7_launches": counts["flash_attention"],
            **graphed_record(stats), "device_len_b7": device_len,
            "mixed_lengths": {"prompts": list(SERVE_MIXED_PROMPTS),
                              "max_new": SERVE_MIXED_NEW,
                              **graphed_record(mixed)},
            "tokens_first_request": tokens[0][:8], **steps,
            "peak_gb": peak_gb, "b7_checks": checks,
            "b7_shapes": shapes, "m1_checks": m1}, counts, checks, shapes


def mamba_block_card_vs_cpu(cfg, seed, card):
    """One Mamba2 block of ``cfg`` (float32, full width) on the card
    against the same block on the CPU: a ``MAMBA_CHECK_ROWS``-row prefill
    (whole chunks and a padded one) from a zero state, then two decode
    steps; the largest difference of outputs and states, each within
    ``MAMBA_F32_ATOL``."""
    import torch
    from repro_torch.models import blocks as tb
    from repro_torch.models import mamba2 as tmb
    from repro_torch.models import model as tm
    gen = torch.Generator()
    gen.manual_seed(seed)
    p_cpu = tb.init_mamba_block(gen, cfg)
    p_cpu["mamba"]["A_log"].uniform_(-1.0, 1.0, generator=gen)
    p_cpu["mamba"]["dt_bias"].uniform_(-1.0, 1.0, generator=gen)
    xs = [torch.randn((1, n, cfg.d_model), generator=gen)
          for n in (MAMBA_CHECK_ROWS, 1, 1)]

    def run(dev):
        p = tm._tree_map(lambda t: t.to(dev), p_cpu)
        st = tmb.init_mamba_state(cfg, 1, device=dev)
        outs = []
        for x in xs:
            y, st = tb.apply_mamba_block(p, x.to(dev), cfg, state=st)
            outs.append(y.cpu())
        return outs + [st["ssm"].cpu(), st["conv"].cpu()]

    diffs = [float((a - b).abs().max())
             for a, b in zip(run(card), run(torch.device("cpu")))]
    if not max(diffs) <= MAMBA_F32_ATOL:
        raise RuntimeError(f"hybrid_serve: a Mamba2 block on the card is off "
                           f"the CPU by {diffs} (bound {MAMBA_F32_ATOL})")
    return max(diffs)


def phase_hybrid_serve(s: Smoke):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm

    cfg = dataclasses.replace(get_config(HYBRID_ARCH), **HYBRID_OVERRIDES)
    ng, per = tm._groups(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, SERVE_PROMPT)
               for _ in range(SERVE_REQUESTS)]
    served, counts, checks, shapes = _serve_and_capture(
        s, "hybrid_serve", cfg, prompts, lambda dev: {}, ng,
        scans={"ssd_scan": (ng * per, 0)})     # decode: the O(1) step

    # float32 at depth HYBRID_CHECK_LAYERS (two groups): the card's B7
    # against its plain version, then one Mamba2 block against the CPU
    cfg32 = dataclasses.replace(cfg, n_layers=HYBRID_CHECK_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    p32 = tm.init_params(cfg32, seed=0)
    dev = p32["embed"]["tok"].device
    t = torch.as_tensor(prompts[0][:CHECK_PREFILL + CHECK_DECODE],
                        device=dev)[None]
    counts32, diffs32 = lm_f32_against_plain(
        "hybrid_serve float32", cfg32, p32, {"tokens": t}, CHECK_PREFILL,
        CHECK_DECODE)
    ng32, per32 = tm._groups(cfg32)
    s.exactly("hybrid_serve float32", counts32,
              {"flash_attention": ng32 * (2 + CHECK_DECODE),
               "ssd_scan": 2 * ng32 * per32})   # forward and prefill
    del p32
    torch.cuda.empty_cache()
    block_diff = mamba_block_card_vs_cpu(cfg32, 5, dev)
    _record_b7(s, counts["flash_attention"], checks, shapes)
    _record_scan(s, "ssd_scan", counts["ssd_scan"], served["m1_checks"])
    log({"phase": "hybrid_serve", "ok": True, **served,
         "groups": ng, "mamba_blocks_per_group": per,
         "f32_check": {"layers": HYBRID_CHECK_LAYERS, "groups": ng32,
                       "prefill": CHECK_PREFILL, "decode_steps": CHECK_DECODE,
                       "launches": counts32, "max_abs_diff": diffs32,
                       "mamba_block_card_vs_cpu": block_diff,
                       "mamba_block_rows": MAMBA_CHECK_ROWS}})


# ---------------------------------------------------------------------------
# long_500k: the reference's 524,288-row decode shape on the sub-quadratic
# families, on M1, X1 and B7
# ---------------------------------------------------------------------------


def _recurrent_state(cache):
    """Every tensor of a decode cache but its attention rows (``k``,
    ``v``): the length and the recurrent states a decode step rewrites."""
    import torch
    out = []

    def walk(t):
        if isinstance(t, dict):
            for key in sorted(t):
                if key not in ("k", "v"):
                    walk(t[key])
        elif isinstance(t, torch.Tensor):
            out.append(t)
    walk(cache)
    return out


def long_decode(cfg, params, cache, first):
    """``LONG_NEW`` greedy decode steps after token ``first`` from the
    prefilled ``cache``: eagerly (the Server's decode body: the step, its
    output copied into the cache's buffers), then from the same state
    (the length and recurrent states restored; the rows the steps write
    are written again alike) through one captured CUDA graph of the same
    body (``launch.serve._Graphed``, its warm-up undone), replayed a step.
    Fails unless the tokens are equal and every step's logits
    bit-identical.  Returns (tokens, eager ms a step, graphed ms a step,
    capture s)."""
    import torch
    from repro_torch.launch.serve import _Graphed, _copy_into
    from repro_torch.models import steps as ts
    decode = ts.make_decode_step(cfg)
    state = _recurrent_state(cache)
    dev = state[0].device
    saved = [t.clone() for t in state]
    tok = torch.zeros((1, 1), dtype=torch.int64, device=dev)

    def restore():
        for t, v in zip(state, saved):
            t.copy_(v)

    def body():
        lg, out = decode(params, tok, cache)
        _copy_into(cache, out)
        return lg

    def run(step):
        toks, seen, ms = [first], [], []
        for _ in range(LONG_NEW):
            tok.fill_(toks[-1])
            t, lg = host_ms(step)
            ms.append(t)
            seen.append(lg[:, -1].clone())
            toks.append(int(torch.argmax(lg[0, -1])))
        return toks, seen, ms

    eager = run(body)
    restore()
    graph = _Graphed(body, lambda: (body(), restore()),
                     torch.cuda.graph_pool_handle(), dev)
    graphed = run(graph)
    same = [bool(torch.equal(a, b)) for a, b in zip(eager[1], graphed[1])]
    if graphed[0] != eager[0] or not all(same):
        raise RuntimeError(f"{cfg.name}: long_500k graphed decode differs "
                           f"from eager: tokens {graphed[0]} vs {eager[0]}, "
                           f"logits equal {same}")
    capture_s = graph.capture_s
    del graph
    return eager[0], eager[2], graphed[2], capture_s


def b7_long_prefill_check(what, q, k, v, kw, out):
    """B7 at a long prefill piece: the path's own output on its last
    ``LONG_B7_ROWS`` query rows (the rows that see the most keys) against
    the plain version and the recurrence at the route's kv tiles on those
    rows (``b7_check``'s bounds); the kernel's device ms on the whole
    piece beside its bound.  Returns (check, timed shape)."""
    from repro_torch.kernels import flash_attention as fa
    rows = min(LONG_B7_ROWS, q.shape[1])
    kwc = dict(kw, q_start=kw.get("q_start", 0) + q.shape[1] - rows)
    qc, got = q[:, -rows:], out[:, -rows:].float()
    want = fa.flash_attention_reference(qc, k, v, **kwc).float()
    err = float((got - want).abs().max())
    if not err <= B7_BF16_ATOL:
        raise RuntimeError(f"{what}: B7 off its plain version by {err}")
    del want
    route = fa.flash_route(q.shape, k.shape, q.dtype, **kw)
    rec = fa.flash_attention_recurrence(
        qc, k, v, block_k=route.block_k, splits=route.splits, **kwc).float()
    off = (got - rec).abs()
    beyond = float((off > 1e-6 + 2.0 ** -7 * rec.abs()).float().mean())
    rec_max, v_max = float(off.max()), float(v.float().abs().max())
    if not (beyond <= B7_REC_BEYOND and rec_max <= B7_REC_MAX_OF_V * v_max):
        raise RuntimeError(f"{what}: B7 off the recurrence: {beyond:.2e} "
                           f"beyond one bf16 step, max {rec_max}")
    bound, by = b7_bound_ms(q, k, kw)
    check = {"q": list(q.shape), "kv": list(k.shape), "kw": kw,
             "route": route.name, "block_k": route.block_k,
             "checked_rows": rows, "max_abs_err": err,
             "recurrence_max_abs_err": rec_max,
             "recurrence_beyond_one_step": beyond}
    shape = {"route": route.name, "splits": route.splits,
             "block_k": route.block_k,
             "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), 2),
             "plain_ms": None, "bound_ms": bound, "bound_by": by,
             "library_ms": None,
             "not_measured": "plain_ms and library_ms: the plain scores "
                             "and SDPA's mask of 32,768 x 524,288 do not "
                             "fit beside the cache"}
    return check, shape


def m1_long_operands(dev, rows):
    """M1's operands at zamba2-2.7b's widths over ``rows`` rows, bf16 views
    of one convolution output as ``mamba2_forward`` hands them over, from
    a seeded generator on the card: (args, kwargs)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    nh, dh, ds = 80, 64, 64
    conv = torch.randn((1, rows, nh * dh + 2 * ds), generator=gen,
                       device=dev).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(
        torch.randn((1, rows, nh), generator=gen, device=dev) - 1.0)
    a = -torch.exp(torch.rand((nh,), generator=gen, device=dev) * 2 - 1)
    d = torch.rand((nh,), generator=gen, device=dev) * 2
    h0 = torch.randn((1, nh, dh, ds), generator=gen, device=dev)
    return (conv[..., :nh * dh].reshape(1, rows, nh, dh),
            conv[..., nh * dh:nh * dh + ds], conv[..., nh * dh + ds:], dt,
            a, d, h0, 256), {}


def _long_zamba2(s: Smoke, cfg, params, toks):
    """zamba2-2.7b at long_500k: ``prefill`` of the first ``LONG_PIECE``
    tokens, ``decode_step`` over the other pieces (exactly one B7 launch a
    group and one M1 launch a Mamba2 block each), then ``long_decode``;
    M1 held on the last block of the last piece, B7 at that piece and at
    decode (host ints and a device start), M1 alone at 524,288 rows."""
    import torch
    from repro_torch.kernels import cam_search
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as kss
    from repro_torch.models import model as tm
    ng, per = tm._groups(cfg)
    n = toks.shape[1]
    cache = tm.init_decode_cache(cfg, 1, n + LONG_NEW + 1)
    cache_gb = sum(t.numel() * t.element_size()
                   for t in (cache["attn"]["k"], cache["attn"]["v"])) / 1e9
    pieces = [(a, min(n, a + LONG_PIECE)) for a in range(0, n, LONG_PIECE)]
    launches = {"flash_attention": 0, "ssd_scan": 0}
    piece_ms = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j, (a, b) in enumerate(pieces):
        last = j == len(pieces) - 1
        cam_search.reset_launch_counts()
        with (intercept(fa, "flash_attention",
                        lambda i, args, kw, out: (args, host_masks(kw), out)
                        if i == ng - 1 else None) if last
              else contextlib.nullcontext([])) as kept_b7, \
                (intercept(kss, "ssd_scan", keep_call(ng * per - 1)) if last
                 else contextlib.nullcontext([])) as kept_m1:
            if j == 0:
                ms, (lg, cache) = host_ms(lambda: tm.prefill(
                    params, cfg, {"tokens": toks[:, a:b]}, cache))
            else:
                ms, (lg, cache) = host_ms(lambda: tm.decode_step(
                    params, cfg, toks[:, a:b], cache))
            lg = lg[:, -1:]
        piece_ms.append(ms)
        counts = dict(cam_search.LAUNCHES)
        s.exactly(f"long_500k zamba2 piece {j}", counts,
                  {"flash_attention": ng, "ssd_scan": ng * per})
        for key in launches:
            launches[key] += counts[key]
    prefill_s = time.perf_counter() - t0
    if tuple(lg.shape) != (1, 1, cfg.vocab) or \
            not bool(torch.isfinite(lg).all()):
        raise RuntimeError(f"long_500k zamba2: last logits "
                           f"{tuple(lg.shape)} not finite")
    first = int(torch.argmax(lg[0, -1]))
    del lg
    # M1 on the last block's operands of the last piece (from the state
    # its earlier pieces carried), against its plain version
    (m1_args, m1_kw, m1_out), = kept_m1
    m1 = {"zamba2_long_500k_last_piece": m1_check(
        "long_500k zamba2 M1", m1_args, m1_kw, m1_out)}
    del m1_args, m1_out, kept_m1
    # decode: B7's operands of the last group's first eager step kept
    cam_search.reset_launch_counts()
    with intercept(fa, "flash_attention", operands({ng - 1: "decode"})) \
            as kept_dec:
        tokens, eager_ms, graphed_ms, capture_s = long_decode(
            cfg, params, cache, first)
    dec_counts = dict(cam_search.LAUNCHES)
    s.exactly("long_500k zamba2 decode", dec_counts,
              {"flash_attention": ng * (LONG_NEW + 2)})
    # B7's checks need the plain scores beside the last group's cache
    # rows: keep those rows, free the rest of the cache
    (pq, pk, pv), pkw, pout = kept_b7[0][0][:3], kept_b7[0][1], \
        kept_b7[0][2]
    dq, dk, dv, dkw = next(ops for name, ops in kept_dec if name)
    k_rows, v_rows = pk.clone(), pv.clone()
    del kept_b7, kept_dec, cache, pk, pv, dk, dv
    torch.cuda.empty_cache()
    b7_prefill, b7_prefill_shape = b7_long_prefill_check(
        "long_500k zamba2 prefill", pq, k_rows, v_rows, pkw, pout)
    b7_decode = b7_check("long_500k zamba2 decode", dq, k_rows, v_rows, dkw)
    b7_decode_shape = b7_timing(dq, k_rows, v_rows, dkw)
    device_len = b7_device_len_check("long_500k zamba2 decode", dq, k_rows,
                                     v_rows, dkw, whole_tiles=False)
    del pq, pout, dq, k_rows, v_rows
    torch.cuda.empty_cache()
    return {"model": cfg.name, "how": f"prefill of {LONG_PIECE} tokens, "
            f"then {len(pieces) - 1} decode_step pieces of {LONG_PIECE}",
            "cache_gb": cache_gb, "prefill_s": prefill_s,
            "piece_ms": piece_ms, "launches_prefill": launches,
            "launches_decode": dec_counts, "tokens": tokens,
            "decode_ms_eager": _ms_stats(eager_ms),
            "decode_ms_graphed": _ms_stats(graphed_ms),
            "capture_s": capture_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "m1_checks": m1, "b7_checks": {"zamba2_long_prefill": b7_prefill,
                                           "zamba2_long_decode": b7_decode},
            "b7_shapes": {"zamba2_long_prefill": b7_prefill_shape,
                          "zamba2_long_decode": b7_decode_shape},
            "device_len_b7": device_len}


def _long_xlstm(s: Smoke, cfg, params, toks):
    """xlstm-125m at long_500k: one ``prefill`` of the whole prompt
    (exactly one X1 launch a sLSTM layer), each layer's launch also
    keeping the state it carried into the last ``LONG_X1_ROWS``
    positions (``snapshot_at``), from which X1 is held to its plain loop
    over those positions and bit-identical to the launch's own hs (the
    checks uncounted and timed apart from the prefill); layer 0's whole
    launch timed again; then ``long_decode``."""
    import torch
    from repro_torch.kernels import cam_search
    from repro_torch.kernels import slstm_scan as ksl
    from repro_torch.models import model as tm
    pairs = tm._pairs(cfg)
    n = toks.shape[1]
    cache = tm.init_decode_cache(cfg, 1, n + LONG_NEW + 1)
    x1, check_s, busy = {}, [0.0], [False]
    real = ksl.slstm_scan

    def scan(pre, wh, *st, **kw):
        if busy[0]:                  # a check's own call
            return real(pre, wh, *st, **kw)
        cut = pre.shape[1] - LONG_X1_ROWS
        hs, fin, mid = real(pre, wh, *st, snapshot_at=cut)
        torch.cuda.synchronize()
        t_check, i = time.perf_counter(), len(x1)
        busy[0] = True
        try:
            with uncounted():
                rec = x1_check(f"long_500k xlstm X1 layer {i}",
                               (pre[:, cut:], wh, *mid),
                               (hs[:, cut:], fin), timed=i == 0)
                if i == 0:
                    whole, _ = event_ms(lambda: real(pre, wh, *st))
                    step = ksl.barrier_step_ms(pre.shape[0], wh.shape[0],
                                               4096, pre.device)
                    hand = ksl.handoff_step_ms(pre.shape[0], wh.shape[0],
                                               4096, pre.device)
                    bound, by = x1_bound_ms(pre)
                    rec["long_500k"] = {
                        "positions": pre.shape[1], "ms": whole,
                        "ms_per_position": whole / pre.shape[1],
                        "bound_ms": bound, "bound_by": by,
                        "barrier_step_ms": step,
                        "serial_bound_ms": pre.shape[1] * step,
                        "handoff_step_ms": hand,
                        "handoff_serial_bound_ms": pre.shape[1] * hand}
        finally:
            busy[0] = False
        x1[f"xlstm_long_500k_layer{i}"] = rec
        torch.cuda.synchronize()
        check_s[0] += time.perf_counter() - t_check
        return hs, fin

    cam_search.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ksl.slstm_scan = scan
    try:
        lg, cache = tm.prefill(params, cfg, {"tokens": toks}, cache)
    finally:
        ksl.slstm_scan = real
    torch.cuda.synchronize()
    # the checks ran inside the prefill, each after a synchronise
    prefill_s = time.perf_counter() - t0 - check_s[0]
    counts = dict(cam_search.LAUNCHES)
    s.exactly("long_500k xlstm prefill", counts, {"slstm_scan": pairs})
    if tuple(lg.shape) != (1, 1, cfg.vocab) or \
            not bool(torch.isfinite(lg).all()):
        raise RuntimeError(f"long_500k xlstm: prefill logits "
                           f"{tuple(lg.shape)} not finite")
    cam_search.reset_launch_counts()
    tokens, eager_ms, graphed_ms, capture_s = long_decode(
        cfg, params, cache, int(torch.argmax(lg[0, -1])))
    dec_counts = dict(cam_search.LAUNCHES)
    s.exactly("long_500k xlstm decode", dec_counts,
              {"slstm_scan": pairs * (LONG_NEW + 2)})
    return {"model": cfg.name, "how": f"one prefill of {n} tokens",
            "prefill_s": prefill_s, "x1_checks_s": check_s[0],
            "launches_prefill": counts, "launches_decode": dec_counts,
            "tokens": tokens, "decode_ms_eager": _ms_stats(eager_ms),
            "decode_ms_graphed": _ms_stats(graphed_ms),
            "capture_s": capture_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "x1_checks": x1}


def phase_long_500k(s: Smoke):
    """launch/specs.py's long_500k shape (524,288 rows of cache, batch 1)
    for its two families, uncut: zamba2-2.7b (hybrid) and xlstm-125m
    (ssm), one after the other (``_long_zamba2``, ``_long_xlstm``); then
    M1 alone at 524,288 rows of zamba2's widths against its plain
    version.  Each model's peak must stay under ``LONG_PEAK_GB``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    runs, t_phase = {}, time.perf_counter()
    for arch, run in zip(LONG_ARCHS, (_long_zamba2, _long_xlstm)):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        s.reset_peak()
        params, init_ms, n_params, params_gb = lm_params(cfg)
        dev = params["embed"]["tok"].device
        prompt = np.random.default_rng(0).integers(1, cfg.vocab, LONG_PROMPT)
        toks = torch.as_tensor(prompt, device=dev)[None]
        rec = run(s, cfg, params, toks)
        del params, toks
        torch.cuda.empty_cache()
        rec.update(params=n_params, params_gb=params_gb, init_ms=init_ms,
                   seconds=time.perf_counter() - t0)
        if not rec["peak_gb"] < LONG_PEAK_GB:
            raise RuntimeError(f"long_500k {arch}: peak {rec['peak_gb']} GB")
        print(f"long_500k {arch}: {rec['how']}: prefill "
              f"{rec['prefill_s']:.3f} s, decode ms a token graphed "
              f"{rec['decode_ms_graphed']} eager {rec['decode_ms_eager']}, "
              f"peak {rec['peak_gb']:.2f} GB, {rec['seconds']:.1f} s",
              flush=True)
        runs[arch] = rec
    args, kw = m1_long_operands(torch.device("cuda"), LONG_PROMPT)
    m1_whole = m1_check("long_500k M1 at 524,288 rows", args, kw)
    del args
    torch.cuda.empty_cache()
    z, x = runs[LONG_ARCHS[0]], runs[LONG_ARCHS[1]]
    _record_scan(s, "ssd_scan", z["launches_prefill"]["ssd_scan"],
                 dict(z["m1_checks"], zamba2_524288_rows=m1_whole))
    _record_scan(s, "slstm_scan", x["launches_prefill"]["slstm_scan"]
                 + x["launches_decode"]["slstm_scan"], x["x1_checks"])
    _record_b7(s, z["launches_prefill"]["flash_attention"]
               + z["launches_decode"]["flash_attention"], z["b7_checks"],
               z["b7_shapes"])
    for name, rec in (("M1 at one 32,768-row piece",
                       z["m1_checks"]["zamba2_long_500k_last_piece"]),
                      ("M1 at 524,288 rows", m1_whole),
                      ("X1 at 524,288 positions", x["x1_checks"][
                          "xlstm_long_500k_layer0"]["long_500k"]),
                      ("B7 at the last piece",
                       z["b7_shapes"]["zamba2_long_prefill"]),
                      ("B7 at decode", z["b7_shapes"]["zamba2_long_decode"])):
        print(f"long_500k kernel {name}: ms {rec['ms']}, bound "
              f"{rec['bound_ms']} ({rec['bound_by']})"
              + (f", serial bound {rec['serial_bound_ms']} (barriers), "
                 f"{rec['handoff_serial_bound_ms']} (hand-offs)"
                 if "serial_bound_ms" in rec else "")
              + (f", float32-FMA bound {rec['fp32_bound_ms']}"
                 if "fp32_bound_ms" in rec else ""), flush=True)
    log({"phase": "long_500k", "ok": True, "shape": "long_500k",
         "prompt": LONG_PROMPT, "max_new": LONG_NEW, "batch": 1,
         "runs": runs, "m1_524288_rows": m1_whole,
         "phase_s": time.perf_counter() - t_phase})


def phase_vlm_serve(s: Smoke):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm

    cfg = dataclasses.replace(get_config(VLM_ARCH), **VLM_OVERRIDES)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, SERVE_PROMPT)
               for _ in range(SERVE_REQUESTS)]
    served, counts, checks, shapes = _serve_and_capture(
        s, "vlm_serve", cfg, prompts, lambda dev: {"vision": torch.zeros(
            # the Server's stub: zero patch embeddings
            (1, cfg.n_vision_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=dev)}, cfg.n_layers)
    if checks["paligemma_prefill"]["kw"].get("prefix_len") != \
            cfg.n_vision_tokens:
        raise RuntimeError(f"vlm_serve: the prefill's B7 call had "
                           f"{checks['paligemma_prefill']['kw']}")

    # float32 at depth VLM_CHECK_LAYERS over seeded random vision rows
    cfg32 = dataclasses.replace(cfg, n_layers=VLM_CHECK_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    p32 = tm.init_params(cfg32, seed=0)
    dev = p32["embed"]["tok"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    t = torch.as_tensor(prompts[0][:CHECK_PREFILL + CHECK_DECODE],
                        device=dev)[None]
    vis = torch.randn((1, cfg.n_vision_tokens, cfg.d_model), generator=gen,
                      device=dev)
    counts32, diffs32 = lm_f32_against_plain(
        "vlm_serve float32", cfg32, p32, {"tokens": t, "vision": vis},
        CHECK_PREFILL, CHECK_DECODE)
    s.exactly("vlm_serve float32", counts32,
              {"flash_attention": VLM_CHECK_LAYERS * (2 + CHECK_DECODE)})
    del p32
    torch.cuda.empty_cache()
    _record_b7(s, counts["flash_attention"], checks, shapes)
    log({"phase": "vlm_serve", "ok": True, **served,
         "vision_tokens": cfg.n_vision_tokens,
         "f32_check": {"layers": VLM_CHECK_LAYERS, "prefill": CHECK_PREFILL,
                       "decode_steps": CHECK_DECODE, "launches": counts32,
                       "max_abs_diff": diffs32}})


# ---------------------------------------------------------------------------
# the dense configurations no other phase serves
# ---------------------------------------------------------------------------


def _dense_b7_operands(cfg, params, named_prompts, max_len):
    """B7's operands of attention layer 0 in an untimed prefill of each
    ``(name, prompt, decode_name)`` of ``named_prompts`` into a fresh cache
    of ``max_len`` rows, and, where ``decode_name`` is given, in the first
    decode step after it; a device start folded into the kwargs' ints."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as tm
    dev = params["embed"]["tok"].device
    out = {}
    for name, prompt, decode in named_prompts:
        wanted = {0: name}
        if decode:
            wanted[cfg.n_layers] = decode
        toks = torch.as_tensor(prompt, device=dev)[None]
        with intercept(fa, "flash_attention", operands(wanted)) as kept:
            lg, cache = tm.prefill(params, cfg, {"tokens": toks},
                                   tm.init_decode_cache(cfg, 1, max_len))
            if decode:
                tm.decode_step(params, cfg,
                               torch.argmax(lg[:, -1], -1)[:, None], cache)
        got = {n: ops for n, ops in kept if n}
        if len(got) != len(wanted):
            raise RuntimeError(f"{cfg.name}: captured {sorted(got)} of "
                               f"{len(kept)} B7 calls")
        out.update(got)
        del cache, kept
    return out


def _dense_b7(what, cfg, captured, routes):
    """Each captured call held to its plain version and the recurrence
    (``b7_check``), timed beside SDPA (``b7_timing``), its route the one
    ``routes`` names.  Returns (checks, timed shapes), keyed
    ``<model>_<call>``."""
    short = cfg.name.split("-")[0]
    checks, shapes = {}, {}
    for name, ops in captured.items():
        rec = b7_check(f"{what} {name}", *ops)
        if rec["route"] != routes[name]:
            raise RuntimeError(f"{what} {name}: B7 took {rec['route']}, "
                               f"not {routes[name]}: {rec['q']} {rec['kw']}")
        checks[f"{short}_{name}"] = rec
        shapes[f"{short}_{name}"] = b7_timing(*ops)
    return checks, shapes


def _dense_config(s: Smoke, arch, overrides):
    """One configuration of ``DENSE_ARCHS`` at full width: served through
    the graphed Server against the eager steps (launches exact), B7 at
    both prefill routes and at decode held to its plain version and timed,
    B7 read at a device start over the decode cache, and, for
    ``DENSE_LONG_ARCH``, the long requests with B7 held at their prefill
    and decode; then float32 at depth ``DENSE_CHECK_LAYERS`` against the
    plain versions.  Returns (log, B7 launches, checks, timed shapes)."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as tm

    what = f"dense_configs_serve {arch}"
    cfg = dataclasses.replace(get_config(arch), **overrides)
    n_layers = cfg.n_layers
    s.reset_peak()
    params, init_ms, n_params, params_gb = lm_params(cfg)
    dev = params["embed"]["tok"].device
    limit = fa.FLASH_SPLITKV_ROWS // (cfg.n_heads // cfg.n_kv_heads)
    lengths = (limit, limit + 1, DENSE_PROMPT, DENSE_PROMPT)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, n) for n in lengths]
    max_len = max(lengths) + DENSE_NEW + 1
    tokens, stats, counts = serve_requests(cfg, params, prompts, DENSE_NEW,
                                           SERVE_BATCH, max_len, profile=s)
    s.exactly(what, counts, {"flash_attention": graphed_launches(
        stats, n_layers, n_layers)})
    print_graphed(what, stats)
    launches = counts["flash_attention"]

    captured = _dense_b7_operands(
        cfg, params, [("prefill_splitkv", prompts[0], "decode"),
                      ("prefill_wgmma", prompts[1], None),
                      (f"prefill_{DENSE_PROMPT}", prompts[2], None)],
        max_len)
    device_len = b7_device_len_check(f"{what} decode", *captured["decode"])
    checks, shapes = _dense_b7(what, cfg, captured,
                               {"prefill_splitkv": "splitkv",
                                "prefill_wgmma": "wgmma",
                                f"prefill_{DENSE_PROMPT}": "wgmma",
                                "decode": "splitkv"})
    del captured
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec = {"model": cfg.name, "layers": n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.head_dim, "rope": cfg.rope,
           "rope_theta": cfg.rope_theta, "qkv_bias": cfg.qkv_bias,
           "reduced": {k: [getattr(get_config(arch), k), v]
                       for k, v in overrides.items()},
           "param_count_config": cfg.param_count(), "params": n_params,
           "params_gb": params_gb, "init_s": init_ms / 1e3,
           "prompts": list(lengths), "max_new": DENSE_NEW,
           "batch": SERVE_BATCH, "max_len": max_len,
           "splitkv_prefill_limit": limit, "b7_launches": launches,
           **graphed_record(stats), "wall_s": stats["wall_s"],
           "tokens_per_s": stats["tokens_per_s"],
           "tokens_first_request": tokens[0][:8],
           "device_len_b7": device_len, "peak_gb": peak_gb}
    print(f"{what}: {n_layers} layers, {n_params} parameters "
          f"({params_gb:.2f} GB), init {init_ms / 1e3:.2f} s, B7 launches "
          f"{launches} (graphed: at warm-up and capture), peak "
          f"{peak_gb:.2f} GB", flush=True)

    if arch == DENSE_LONG_ARCH:
        s.reset_peak()
        long_prompts = [rng.integers(1, cfg.vocab, DENSE_LONG_PROMPT)
                        for _ in range(DENSE_LONG_REQUESTS)]
        long_len = DENSE_LONG_PROMPT + DENSE_LONG_NEW + 1
        _, lstats, lcounts = serve_requests(
            cfg, params, long_prompts, DENSE_LONG_NEW, SERVE_BATCH, long_len)
        s.exactly(f"{what} long", lcounts, {"flash_attention":
                  graphed_launches(lstats, n_layers, n_layers)})
        print_graphed(f"{what} long", lstats)
        launches += lcounts["flash_attention"]
        captured = _dense_b7_operands(
            cfg, params, [("prefill_32k", long_prompts[0], "decode_32k")],
            long_len)
        # the served decode reads its start from the device, on the grid
        # device_start_splits sizes: that grid at the long cache's edges
        long_device_len = b7_device_len_check(
            f"{what} long decode", *captured["decode_32k"],
            whole_tiles=False)
        lchecks, lshapes = _dense_b7(
            f"{what} long", cfg, captured,
            {"prefill_32k": "wgmma", "decode_32k": "splitkv"})
        checks.update(lchecks)
        shapes.update(lshapes)
        del captured
        torch.cuda.empty_cache()
        long_peak = torch.cuda.max_memory_allocated() / 1e9
        rec["long"] = {
            "requests": DENSE_LONG_REQUESTS, "prompt": DENSE_LONG_PROMPT,
            "max_new": DENSE_LONG_NEW, "max_len": long_len,
            "reduced": {"batch": [128, SERVE_BATCH]},
            "cache_bytes_per_token_slot": 2 * n_layers * cfg.n_kv_heads
            * cfg.head_dim * 2,
            "b7_launches": lcounts["flash_attention"],
            **graphed_record(lstats), "wall_s": lstats["wall_s"],
            "peak_gb": long_peak, "device_len_b7": long_device_len}
        print(f"{what} long: {DENSE_LONG_REQUESTS} x {DENSE_LONG_PROMPT} + "
              f"{DENSE_LONG_NEW} tokens, B7 launches "
              f"{lcounts['flash_attention']}, peak {long_peak:.2f} GB",
              flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, n_layers=DENSE_CHECK_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    p32 = tm.init_params(cfg32, seed=0)
    t = torch.as_tensor(prompts[2][:CHECK_PREFILL + CHECK_DECODE],
                        device=dev)[None]
    counts32, diffs32 = lm_f32_against_plain(
        f"{what} float32", cfg32, p32, {"tokens": t}, CHECK_PREFILL,
        CHECK_DECODE)
    s.exactly(f"{what} float32", counts32,
              {"flash_attention": DENSE_CHECK_LAYERS * (2 + CHECK_DECODE)})
    del p32
    torch.cuda.empty_cache()
    rec["f32_check"] = {"layers": DENSE_CHECK_LAYERS, "prefill": CHECK_PREFILL,
                        "decode_steps": CHECK_DECODE, "launches": counts32,
                        "max_abs_diff": diffs32}
    rec.update(b7_checks=checks, b7_shapes=shapes)
    return rec, launches, checks, shapes


def phase_dense_configs_serve(s: Smoke):
    import torch
    served, launches, checks, shapes = {}, 0, {}, {}
    for arch, overrides in DENSE_ARCHS.items():
        rec, n, c, sh = _dense_config(s, arch, overrides)
        rec["released"] = release_phase_state(torch)
        served[arch] = rec
        launches += n
        checks.update(c)
        shapes.update(sh)
    _record_b7(s, launches, checks, shapes)
    log({"phase": "dense_configs_serve", "ok": True, "configs": served})


# ---------------------------------------------------------------------------
# the train path
# ---------------------------------------------------------------------------


def _train_kernel_class(key: str) -> str:
    """Kernel class of a profiler row on the train path: B7's forward,
    its backward, a matrix product, or other."""
    if "flash_bwd" in key.lower():
        return "b7_backward"
    c = _lm_kernel_class(key)
    return "b7_forward" if c == "b7_flash_attention" else c


def _profiled(s: Smoke, fn):
    """``fn()`` under ``torch.profiler`` and ``s.profile``'s summary, by
    train kernel class; returns (result, summary)."""
    out = []
    summary = s.profile(lambda: out.append(fn()), [],
                        classify=_train_kernel_class)
    return out[0], summary


def train_step_profile(s: Smoke, cfg, state, batch, lr):
    """One train step of ``state`` on ``batch`` as ``make_train_step``
    runs it, its three parts profiled apart: the forward (``loss_fn``),
    the backward (``torch.autograd.grad``) and the optimizer
    (``adamw_update``), each with its device time by kernel class, its
    launches and its idle share, and B7's launches in each."""
    import torch
    from repro_torch.kernels import cam_search
    from repro_torch.models import steps as ts
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.tree import leaves, unflatten
    parts, b7 = {}, {}
    flat = leaves(state.params)
    cam_search.reset_launch_counts()
    (loss, _), parts["forward"] = _profiled(
        s, lambda: ts.loss_fn(state.params, cfg, batch))
    b7["forward"] = dict(cam_search.LAUNCHES)
    cam_search.reset_launch_counts()
    grads, parts["backward"] = _profiled(
        s, lambda: torch.autograd.grad(loss, flat, allow_unused=True))
    b7["backward"] = dict(cam_search.LAUNCHES)
    del loss
    cam_search.reset_launch_counts()
    _, parts["optimizer"] = _profiled(
        s, lambda: adamw_update(unflatten(state.params, list(grads)),
                                state.opt, state.params, lr, AdamWConfig()))
    b7["optimizer"] = dict(cam_search.LAUNCHES)
    del grads
    for name, part in parts.items():
        part["b7_launches"] = {k: v for k, v in b7[name].items()
                               if k.startswith("flash") and v}
    return parts


def b7b_bound_ms(q, k, kw):
    """B7's backward: five products of 2 dh FLOP per visible (row,
    column) pair and head (S, dP, dV, dK, dQ) at the bf16 tensor-core
    peak, against the bytes of q, k, v, o, dO, lse and dq, dk, dv read or
    written once."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    kv_len = kw.get("kv_len") or t
    q_start, prefix = kw.get("q_start", 0), kw.get("prefix_len", 0)
    if kw.get("causal", True):
        vis = sum(min(kv_len, max(q_start + r + 1, prefix))
                  for r in range(s))
    else:
        vis = s * kv_len
    flops = 5 * 2.0 * dh * b * h * vis
    bytes_ = q.element_size() * (4.0 * b * s * h * dh + 4.0 * b * t * kvh
                                 * dh) + 4.0 * b * h * s
    t_ops, t_mem = flops / BF16_PEAK_FLOPS, bytes_ / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
        else "bytes"


def b7b_kernel_ms(fn, n: int = 5, sliced: bool = False) -> dict:
    """Device ms a call of B7b's steps under ``torch.profiler`` over
    ``n`` calls of ``fn``: the pre-pass (``flash_bwd_rows_kernel`` or
    ``flash_bwd_dot_kernel``), the dK / dV kernel, the dQ kernel and,
    with ``sliced`` (the bf16 route at a padded dh of 256), the sum of
    the dK / dV slices (``flash_bwd_sum_kernel``, ``"sum"``), each the
    mean over the launches the profiler saw (a call launches each once;
    the profiler can lose device events, and ``seen`` counts what it
    kept), ``{"not_measured": ...}`` when it saw none of one of them."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    steps = ("prepass", "dkdv", "dq", "sum")
    total, seen = dict.fromkeys(steps, 0.0), dict.fromkeys(steps, 0)
    for ms, name, count in device_rows(prof):
        part = ("prepass" if "flash_bwd_rows" in name
                or "flash_bwd_dot" in name else
                "dkdv" if "flash_bwd_dkdv" in name else
                "dq" if "flash_bwd_dq" in name else
                "sum" if "flash_bwd_sum" in name else None)
        if part is not None:
            total[part] += ms
            seen[part] += count
    steps = steps if sliced else steps[:3]
    if not all(seen[p] for p in steps):
        return {"not_measured": f"the profiler saw {seen} launches of "
                                f"{n} calls"}
    return {**{p: total[p] / seen[p] for p in steps}, "seen": seen}


def sdpa_backward_call(q, k, v, d_out, kw):
    """The library yardstick for one backward: the gradient of PyTorch's
    ``scaled_dot_product_attention`` (``enable_gqa``) at the same
    operands, its graph built once (timed only; the port never calls
    it)."""
    import torch
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    s = q.shape[1]
    causal = kw.get("causal", True)
    prefix = kw.get("prefix_len", 0)
    if causal and (kw.get("q_start", 0) or kw.get("kv_len") or
                   k.shape[1] != s):
        raise ValueError(f"sdpa_backward_call: no yardstick for {kw}")
    if causal and prefix:
        ki = torch.arange(k.shape[1], device=q.device)
        mask = (ki[None, :] <= ki[:s, None]) | (ki[None, :] < prefix)
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    else:
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    g = d_out.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), g,
                                       retain_graph=True)


def b7b_check(what, shape, kw, dtype, seed, timed, dev):
    """B7's forward with its log-sum-exp, and its backward, on seeded
    operands of ``shape`` (B, S, T, H, KV, dh) against their plain
    versions: the output within ``B7_BF16_ATOL`` (bf16) or
    ``B7_F32_ATOL`` (float32), the log-sum-exp within ``B7_LSE_ATOL``,
    each gradient within
    ``B7B_BF16_OF_MAX`` (bf16) or ``B7B_F32_OF_MAX`` (float32) of its
    plain version's largest magnitude, two calls bit-identical; records
    the route (``flash_bwd_route``).  With ``timed``, the backward's
    median ms beside its plain version, its bound and SDPA's backward,
    and its three steps' device ms (``b7b_kernel_ms``)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    b, s_, t, h, kvh, dh = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rand(*sh):
        return torch.randn(sh, generator=gen, device=dev).to(dtype)

    q, k, v = rand(b, s_, h, dh), rand(b, t, kvh, dh), rand(b, t, kvh, dh)
    d_out = rand(b, s_, h, dh)
    out, lse = fa._forward_cuda(q, k, v, kw.get("causal", True),
                                kw.get("prefix_len", 0), kw.get("kv_len"),
                                kw.get("q_start", 0), want_lse=True)
    out_plain, lse_plain = fa.flash_attention_reference(
        q, k, v, return_lse=True, **kw)
    fwd_err = float((out.float() - out_plain.float()).abs().max())
    fwd_bound = B7_BF16_ATOL if dtype == torch.bfloat16 else B7_F32_ATOL
    if not fwd_err <= fwd_bound:
        raise RuntimeError(f"{what}: B7's output beside its log-sum-exp off "
                           f"its plain version by {fwd_err} (bound "
                           f"{fwd_bound})")
    lse_err = float((lse - lse_plain).abs().max())
    if not lse_err <= B7_LSE_ATOL:
        raise RuntimeError(f"{what}: B7's log-sum-exp off its plain "
                           f"version by {lse_err} (bound {B7_LSE_ATOL})")
    got = fa.flash_attention_backward(q, k, v, out, lse, d_out, **kw)
    again = fa.flash_attention_backward(q, k, v, out, lse, d_out, **kw)
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, d_out,
                                                 **kw)
    bound = B7B_BF16_OF_MAX if dtype == torch.bfloat16 else B7B_F32_OF_MAX
    errs = {}
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(a, a2):
            raise RuntimeError(f"{what}: {name} differs between two calls")
        scale = float(w.float().abs().max())
        err = float((a.float() - w.float()).abs().max())
        errs[name] = {"max_abs_err": err, "max_abs_want": scale}
        if not err <= bound * scale:
            raise RuntimeError(f"{what}: B7's backward {name} off its plain "
                               f"version by {err} (bound {bound} x {scale})")
    route = fa.flash_bwd_route(q.shape, k.shape, dtype, **kw).name
    rec = {"shape": list(shape), "kw": kw, "dtype": str(dtype),
           "route": route,
           "fwd_max_abs_err": fwd_err, "lse_max_abs_err": lse_err,
           "grads": errs,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values())}
    if timed:
        bound_ms, by = b7b_bound_ms(q, k, kw)
        lib = sdpa_backward_call(q, k, v, d_out, kw)
        rec.update(
            ms=cuda_ms(lambda: fa.flash_attention_backward(
                q, k, v, out, lse, d_out, **kw), 5),
            plain_ms=cuda_ms(lambda: fa.flash_attention_backward_reference(
                q, k, v, out, lse, d_out, **kw), 3),
            bound_ms=bound_ms, bound_by=by, library_ms=cuda_ms(lib, 5),
            kernel_ms=b7b_kernel_ms(
                lambda: fa.flash_attention_backward(q, k, v, out, lse, d_out,
                                                    **kw),
                sliced=route == "wgmma" and fa._padded_dim(dh) == 256),
            forward_ms=cuda_ms(lambda: fa._forward_cuda(
                q, k, v, kw.get("causal", True), kw.get("prefix_len", 0),
                kw.get("kv_len"), kw.get("q_start", 0), want_lse=True), 5))
    return rec


def _host_leaves(tree):
    from repro_torch.tree import leaves
    return [t.detach().cpu() for t in leaves(tree)]


def train_determinism(cfg, batch):
    """Two train steps from the same state (``init_train_state`` from one
    seed, twice) give bit-identical parameters and master weights; the
    second runs under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``, whose warnings name any operation on the path
    without a deterministic implementation."""
    import warnings
    import torch
    from repro_torch.models import steps as ts
    from repro_torch.optim import constant
    step = ts.make_train_step(cfg, constant(TRAIN_LR))
    results, caught = [], []
    for strict in (False, True):
        state = ts.init_train_state(cfg, seed=1)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(strict, warn_only=True)
            try:
                state, _ = step(state, batch)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        caught += sorted({str(x.message)[:200] for x in w})
        results.append(_host_leaves(state.params)
                       + _host_leaves(state.opt.master))
        del state
        torch.cuda.empty_cache()
    same = all(torch.equal(a, b) for a, b in zip(*results))
    if not same:
        raise RuntimeError("lm_train: two steps from the same state differ")
    return {"layers": cfg.n_layers, "tokens": list(batch["tokens"].shape),
            "bit_identical": same, "deterministic_mode_warnings": caught}


def grads_against_plain(cfg32, batch):
    """Float32 ``loss_fn`` gradients through the kernels and through the
    plain versions (``plain_kernels``), on the card: the loss within
    ``GRAD_LOSS_ATOL``, each leaf's ``|g - g_plain|`` within ``GRAD_RTOL``
    of ``|g_plain|``.  Returns the record and the kernel run's launch
    counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import cam_search
    from repro_torch.models import model as tm
    from repro_torch.models import steps as ts
    from repro_torch.tree import leaves_with_paths
    params = tm.init_params(cfg32, seed=0)
    named = leaves_with_paths(params)
    for _, p in named:
        p.requires_grad_(True)

    def run():
        loss, _ = ts.loss_fn(params, cfg32, batch)
        g = torch.autograd.grad(loss, [p for _, p in named])
        return float(loss.detach()), g

    cam_search.reset_launch_counts()
    loss_k, g_k = run()
    torch.cuda.synchronize()
    counts = dict(cam_search.LAUNCHES)
    cam_search.reset_launch_counts()
    with plain_kernels():
        loss_p, g_p = run()
    plain_counts = dict(cam_search.LAUNCHES)
    if any(plain_counts.values()):
        raise RuntimeError(f"lm_train: the plain run launched "
                           f"{plain_counts}")
    norms = {path: float(torch.linalg.vector_norm(w))
             for (path, _), w in zip(named, g_p)}
    total = float(np.sqrt(sum(n * n for n in norms.values())))
    rel = {}
    for (path, _), a, w in zip(named, g_k, g_p):
        diff = float(torch.linalg.vector_norm(a - w))
        rel[path] = diff / norms[path] if norms[path] else \
            (0.0 if diff == 0 else float("inf"))
    worst = max(rel, key=rel.get)
    if not abs(loss_k - loss_p) <= GRAD_LOSS_ATOL:
        raise RuntimeError(f"lm_train: float32 loss {loss_k} off the plain "
                           f"{loss_p}")
    if not rel[worst] <= GRAD_RTOL:
        raise RuntimeError(f"lm_train: float32 gradient {worst} off the "
                           f"plain version's by {rel[worst]} (relative)")
    del params, g_k, g_p
    torch.cuda.empty_cache()
    return {"layers": cfg32.n_layers, "tokens": list(batch["tokens"].shape),
            "loss": loss_k, "loss_plain": loss_p,
            "loss_abs_diff": abs(loss_k - loss_p),
            "worst_leaf": worst, "worst_rel_err": rel[worst],
            "grad_norm": total, "rel_err": rel}, counts


def phase_lm_train(s: Smoke):
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cam_search
    from repro_torch.launch.train import TrainLoop
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), **TRAIN_OVERRIDES)
    if cfg.remat != "full":
        raise RuntimeError(f"lm_train: remat {cfg.remat!r}, not 'full'")

    # (a) the training loop, checkpoints included -----------------------
    s.reset_peak()
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        loop = TrainLoop(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         steps=TRAIN_STEPS, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                         ckpt_dir=ckpt, ckpt_every=TRAIN_CKPT_EVERY, keep=1,
                         seed=0)
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in leaves(loop.state.params))
        cam_search.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loop.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = dict(cam_search.LAUNCHES)
        ckpts = sorted(os.listdir(ckpt))
        saves = loop.supervisor.ckpt.log
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps_done = len(loop.history)
    s.exactly("lm_train", counts, {
        "flash_attention": 2 * cfg.n_layers * steps_done,
        "flash_attention_bwd": cfg.n_layers * steps_done})
    losses = [h["loss"] for h in loop.history]
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not (np.all(np.isfinite(losses)) and last < first - TRAIN_LOSS_DROP
            and last < min(losses[:3])):
        raise RuntimeError(f"lm_train: loss {first:.4f} -> {last:.4f} (must "
                           f"fall by {TRAIN_LOSS_DROP}, and below the first "
                           f"three's lowest): {losses}")
    if not peak_gb < TRAIN_PEAK_GB:
        raise RuntimeError(f"lm_train: peak {peak_gb:.1f} GB (bound "
                           f"{TRAIN_PEAK_GB})")
    want_saves = list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS + 1,
                            TRAIN_CKPT_EVERY))
    if out["restarts"] or [x["step"] for x in saves] != want_saves or \
            ckpts != [f"step_{n:09d}" for n in want_saves[-1:]]:
        raise RuntimeError(f"lm_train: restarts {out['restarts']}, saves "
                           f"{saves}, checkpoints left {ckpts}")
    step_ms = [1e3 * h["step_time_s"] for h in loop.history]
    dev = loop.state.params["embed"]["tok"].device

    # where a step's time goes: forward, backward, optimizer
    batch = loop.loader.batch(TRAIN_STEPS)
    parts = train_step_profile(s, cfg, loop.state, batch, TRAIN_LR)
    profile_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_log = {
        "model": TRAIN_ARCH, "reduced": {"n_layers": [48, cfg.n_layers]},
        "d_model": cfg.d_model, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "lr": TRAIN_LR, "warmup": TRAIN_WARMUP, "remat": cfg.remat,
        "init_s": init_s, "run_s": run_s, "losses": losses,
        "loss_first3": first, "loss_last3": last,
        "grad_norms": [h["grad_norm"] for h in loop.history],
        "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * 1e3
        / statistics.median(step_ms),
        "checkpoint_saves": saves, "launches": counts,
        "b7_launches_per_step": {k: v / steps_done for k, v in counts.items()
                                 if v},
        "peak_gb": peak_gb, "profile_peak_gb": profile_peak_gb,
        "step_profile": parts}
    del loop, out, batch
    torch.cuda.empty_cache()
    vlm_train = vlm_train_steps(s)
    torch.cuda.empty_cache()

    # (b) float32 gradients through the kernels and the plain versions --
    cfg32 = dataclasses.replace(cfg, n_layers=GRAD_CHECK_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    rng = np.random.default_rng(5)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (1, GRAD_CHECK_TOKENS)),
                           device=dev)
    grad_check, grad_counts = grads_against_plain(cfg32, {"tokens": toks})
    s.exactly("lm_train float32 gradients", grad_counts, {
        "flash_attention": 2 * GRAD_CHECK_LAYERS,
        "flash_attention_bwd": GRAD_CHECK_LAYERS})

    # (c) determinism: two steps from one state -------------------------
    det = train_determinism(dataclasses.replace(cfg, n_layers=DET_LAYERS),
                            {"tokens": toks})

    # (d) B7's backward alone at the families' shapes -------------------
    shapes = {}
    for i, (name, (shape, kw)) in enumerate(B7B_SHAPES.items()):
        for dtype in (torch.bfloat16, torch.float32):
            rec = b7b_check(f"lm_train {name} {dtype}", shape, kw, dtype,
                            40 + i, dtype == torch.bfloat16, dev)
            shapes[name if dtype == torch.bfloat16 else f"{name}_f32"] = rec
            torch.cuda.empty_cache()
    qwen = shapes["qwen_causal"]
    s.record("flash_attention_bwd",
             "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:124 (its backward: the "
             "reference differentiates src/repro/models/layers.py:167)",
             counts["flash_attention_bwd"] + vlm_train["launches"][
                 "flash_attention_bwd"],
             max([r["max_abs_err"] for r in shapes.values()]
                 + [vlm_train["b7b_check"]["max_abs_err"]]), qwen["ms"],
             qwen["plain_ms"], qwen["bound_ms"], qwen["bound_by"],
             qwen["library_ms"])
    s.kernels["flash_attention_bwd"]["shapes"] = {
        k: {key: v[key] for key in ("route", "ms", "kernel_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "forward_ms")}
        for k, v in shapes.items() if "ms" in v}
    _record_b7(s, counts["flash_attention"]
               + vlm_train["launches"]["flash_attention"],
               {"train": {"max_abs_err": max(
                   r["fwd_max_abs_err"] for r in shapes.values())}}, {})
    log({"phase": "lm_train", "ok": True, **train_log,
         "vlm_train": vlm_train, "f32_grad_check": grad_check,
         "determinism": det, "b7b_checks": shapes})


class _GradTap:
    """A pass-through gradient "compressor" for ``make_train_step``: while
    ``on``, hands each step's gradients (DTensors gathered whole) to
    ``fn``."""

    def __init__(self, fn):
        self.fn, self.on = fn, True

    def init(self, params):
        return ()

    def __call__(self, grads, state):
        if self.on:
            self.fn(grads)
        return grads, state


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _sharded_run(s: Smoke, cfg, loader, rules, tap):
    """SHARD_STEPS steps from ``init_train_state(seed=0)`` (distributed by
    ``rules`` when given) whose gradients go to ``tap``, then two more
    without it, one timed and one profiled: each step's loss and ms, the
    launches of all of them, the profile (kernels launched a step)."""
    import torch
    from repro_torch.kernels import cam_search
    from repro_torch.launch.train import distribute_state
    from repro_torch.models import steps as ts
    from repro_torch.optim import AdamWConfig, warmup_cosine
    state = ts.init_train_state(cfg, seed=0)
    if rules is not None:
        state = distribute_state(state, rules, cfg)
    grads = _GradTap(tap)
    step = ts.make_train_step(cfg, warmup_cosine(TRAIN_LR, 1,
                                                 SHARD_STEPS + 2),
                              AdamWConfig(), rules=rules, compressor=grads)
    losses, ms, prof = [], [], None
    cam_search.reset_launch_counts()
    for i in range(SHARD_STEPS + 2):
        grads.on = i < SHARD_STEPS
        batch = loader.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == SHARD_STEPS + 1:
            out = {}
            prof = s.profile(lambda: out.update(r=step(state, batch)), ())
            state, m = out["r"]
        else:
            state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(_whole(m["loss"])))
    counts = dict(cam_search.LAUNCHES)
    del state
    torch.cuda.empty_cache()
    return losses, ms, counts, prof


def phase_lm_sharded(s: Smoke):
    """(a) The sharded train step on one NCCL rank: qwen2.5-14b at full
    width, depth SHARD_LAYERS, through ``make_train_step(rules=)`` over a
    (data 1, model 1) ``DeviceMesh``: the state as DTensors, the batch
    sharded by ``ShardingRules``, attention on B7 / B7b under
    ``local_map``; held step by step to the unsharded step from the same
    seed.  (b), four gloo ranks on this card, is left out: gloo's
    all-gather on CUDA tensors kills the rank
    (``src/repro_torch/distributed/gloo_cuda_probe.py``)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, TokenStream
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.tree import leaves_with_paths

    cfg = dataclasses.replace(get_config(SHARD_ARCH), n_layers=SHARD_LAYERS)
    stream = TokenStream(vocab=cfg.vocab, seq_len=SHARD_SEQ,
                         global_batch=SHARD_BATCH, seed=0)
    want = []                     # each step's unsharded gradients (host)

    def keep(grads):
        want.append([(p, g.detach().cpu())
                     for p, g in leaves_with_paths(grads)])

    s.reset_peak()
    base_loss, base_ms, base_counts, base_prof = _sharded_run(
        s, cfg, ShardedLoader(stream, device="cuda"), None, keep)
    base_peak = torch.cuda.max_memory_allocated() / 1e9
    worst, bitwise, step_i = {}, [], [0]

    def check(grads):
        i = step_i[0]
        same, w = True, 0.0
        for (path, g), (wpath, gw) in zip(leaves_with_paths(grads),
                                          want[i]):
            if path != wpath:
                raise RuntimeError(f"lm_sharded: leaf {path} vs {wpath}")
            got = _whole(g).detach()
            ref = gw.to(got.device)
            same = same and torch.equal(got, ref)
            top = float(ref.float().abs().max())
            err = float((got.float() - ref.float()).abs().max())
            rel = err / top if top else (0.0 if err == 0 else float("inf"))
            w = max(w, rel)
            if rel > SHARD_GRAD_OF_MAX:
                raise RuntimeError(f"lm_sharded: step {i} gradient {path} "
                                   f"off the unsharded one by {rel} of its "
                                   f"largest magnitude")
        worst[i], step_i[0] = w, i + 1
        bitwise.append(same)

    s.reset_peak()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = ShardingRules(mesh)
        loss, ms, counts, prof = _sharded_run(
            s, cfg, ShardedLoader(stream, device="cuda", sharding=rules),
            rules, check)
    finally:
        dist.destroy_process_group()
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_steps = SHARD_STEPS + 2
    s.exactly("lm_sharded", counts, {
        "flash_attention": 2 * cfg.n_layers * n_steps,
        "flash_attention_bwd": cfg.n_layers * n_steps})
    if base_counts != counts:
        raise RuntimeError(f"lm_sharded: launches {counts}, unsharded "
                           f"{base_counts}")
    for a, b in zip(loss[:SHARD_STEPS], base_loss[:SHARD_STEPS]):
        if not abs(a - b) <= SHARD_LOSS_RTOL * abs(b):
            raise RuntimeError(f"lm_sharded: loss {loss} vs unsharded "
                               f"{base_loss}")
    if len(worst) != SHARD_STEPS:
        raise RuntimeError(f"lm_sharded: {len(worst)} gradient checks")
    n_params = sum(g.numel() for _, g in want[0])
    # launches only: B7 and B7b are held to their plain versions at this
    # phase's shape in lm_train (B7B_SHAPES "qwen_sharded")
    shape = (SHARD_BATCH, SHARD_SEQ, SHARD_SEQ, cfg.n_heads, cfg.n_kv_heads,
             cfg.head_dim)
    if B7B_SHAPES["qwen_sharded"] != (shape, dict(causal=True)):
        raise RuntimeError(f"lm_sharded: B7b runs at {shape}, held at "
                           f"{B7B_SHAPES['qwen_sharded']}")
    s.record("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:124",
             counts["flash_attention"], 0.0, None, None, None, "operations",
             None)
    s.record("flash_attention_bwd",
             "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention.py:124 (its backward: the "
             "reference differentiates src/repro/models/layers.py:167)",
             counts["flash_attention_bwd"], 0.0, None, None, None,
             "operations", None)

    def launched(prof_):
        return prof_.get("device_ops") if isinstance(prof_, dict) else None
    log({"phase": "lm_sharded", "ok": True, "model": SHARD_ARCH,
         "reduced": {"n_layers": [48, cfg.n_layers]},
         "d_model": cfg.d_model, "params": n_params,
         "mesh": {"data": 1, "model": 1, "backend": "nccl"},
         "batch": SHARD_BATCH, "seq": SHARD_SEQ, "steps": SHARD_STEPS,
         "loss": loss, "loss_unsharded": base_loss,
         "grad_worst_of_max": worst, "bit_identical_grads": bitwise,
         "bit_identical_loss": loss == base_loss,
         # the checked steps copy every gradient to or from the host;
         # the last two do not (the second of them profiled)
         "step_ms": ms, "step_ms_unsharded": base_ms,
         "timed_step_ms": ms[SHARD_STEPS],
         "timed_step_ms_unsharded": base_ms[SHARD_STEPS],
         "kernels_per_step": launched(prof),
         "kernels_per_step_unsharded": launched(base_prof),
         "profile": prof, "profile_unsharded": base_prof,
         "launches": counts, "peak_gb": peak,
         "peak_gb_unsharded": base_peak,
         "gloo_stand_ins": "left out: gloo's all-gather on CUDA tensors "
                           "kills the rank (src/repro_torch/distributed/"
                           "gloo_cuda_probe.py)"})


def vlm_train_steps(s: Smoke) -> dict:
    """paligemma-3b at full width and depth through ``make_train_step``:
    VLM_TRAIN_STEPS steps of VLM_TRAIN_BATCH rows (seeded random vision
    rows, then ``TokenStream`` text), the first untimed, the
    second timed, the last under ``torch.profiler``.  Fails unless every
    loss is finite and every step launches B7 twice a layer (the forward
    and remat's recompute) and B7b once on its ``wgmma`` route, paired
    (the 2,304-row prefix-LM attention at dh 256), and unless the first
    step's first B7b call (the last layer's) holds its plain version on
    that call's own operands (``vlm_b7b_check``).  Returns the losses,
    the launches of all steps, that check, the timed step's ms, B7b's
    device ms in the profiled step and the peak GB."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import cam_search
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import steps as ts
    from repro_torch.optim import constant
    from repro_torch.tree import leaves
    cfg = get_config(VLM_ARCH)
    b, n_vis = VLM_TRAIN_BATCH, cfg.n_vision_tokens
    rows = n_vis + VLM_TRAIN_SEQ
    route = fa.flash_bwd_route((b, rows, cfg.n_heads, cfg.d_head),
                               (b, rows, cfg.n_kv_heads, cfg.d_head),
                               torch.bfloat16, causal=True,
                               prefix_len=n_vis)
    if tuple(route) != ("wgmma", True):
        raise RuntimeError(f"lm_train vlm: B7b's route {route}")
    s.reset_peak()
    t0 = time.perf_counter()
    state = ts.init_train_state(cfg, seed=2)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(state.params))
    dev = state.params["embed"]["tok"].device
    toks = TokenStream(cfg.vocab, VLM_TRAIN_SEQ, b, seed=3).batch(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    batch = {"tokens": torch.as_tensor(toks["tokens"], device=dev),
             "vision": torch.randn((b, n_vis, cfg.d_model), generator=gen,
                                   device=dev).to(torch.bfloat16)}
    step = ts.make_train_step(cfg, constant(TRAIN_LR))
    want = {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}
    losses, launches, step_ms, profile = [], dict.fromkeys(want, 0), None, None
    backward, seen = fa.flash_attention_backward, []

    def keep_first(*args, **kw):
        """The wrapper, keeping a copy of its first call's operands,
        masks and gradients (the step may reuse the gradients' memory);
        it stands in for the module global that ``FlashAttentionFn``
        calls, for the first step only."""
        got = backward(*args, **kw)
        if not seen:
            seen.append(([a.clone() for a in args], kw,
                         [g.clone() for g in got]))
        return got

    for i in range(VLM_TRAIN_STEPS):
        cam_search.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == VLM_TRAIN_STEPS - 1:
            out = []
            profile = s.profile(lambda: out.append(step(state, batch)), [],
                                classify=_train_kernel_class)
            state, metrics = out[0]
        elif i == 0:
            fa.flash_attention_backward = keep_first
            try:
                state, metrics = step(state, batch)
            finally:
                fa.flash_attention_backward = backward
        else:
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        if i == 1:
            step_ms = 1e3 * (time.perf_counter() - t0)
        counts = dict(cam_search.LAUNCHES)
        s.exactly(f"lm_train vlm step {i}", counts, want)
        for k in want:
            launches[k] += counts[k]
        losses.append(float(metrics["loss"]))
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f"lm_train vlm: losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    b7b_ms = profile.get("by_class_ms", {}).get("b7_backward") \
        if "not_measured" not in profile else None
    del state, batch, step, out
    if not seen:      # FlashAttentionFn no longer calls the module global
        raise RuntimeError("lm_train vlm: the step made no call of "
                           "flash_attention.flash_attention_backward")
    b7b = vlm_b7b_check(*seen.pop())
    if b7b["shape"] != [b, rows, rows, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_head] or b7b["kw"].get("prefix_len") != n_vis:
        raise RuntimeError(f"lm_train vlm: B7b checked at {b7b['shape']} "
                           f"{b7b['kw']}")
    return {"model": VLM_ARCH, "layers": cfg.n_layers, "params": n_params,
            "rows": [b, n_vis, VLM_TRAIN_SEQ], "steps": VLM_TRAIN_STEPS,
            "route": list(route), "init_s": init_s, "losses": losses,
            "launches": launches, "b7b_check": b7b, "step_ms": step_ms,
            "b7b_device_ms_per_step": b7b_ms
            if b7b_ms is not None else "not measured",
            "peak_gb": peak_gb, "profile": profile}


def vlm_b7b_check(args, kw, got, what="lm_train vlm") -> dict:
    """B7b as a train step called it, held to its plain version: the
    gradients ``got`` that ``flash_attention_backward(*args, **kw)``
    returned in the step, one more call on the same operands (bit for
    bit the same) and ``flash_attention_backward_reference`` (each
    gradient within ``B7B_BF16_OF_MAX`` of its largest magnitude).  The
    calls made here are not counted as the step's."""
    import torch
    from repro_torch.kernels import cam_search
    from repro_torch.kernels import flash_attention as fa
    q, k = args[0], args[1]
    route = fa.flash_bwd_route(q.shape, k.shape, q.dtype, **kw)
    before = dict(cam_search.LAUNCHES)
    again = fa.flash_attention_backward(*args, **kw)
    want = fa.flash_attention_backward_reference(*args, **kw)
    cam_search.LAUNCHES.clear()
    cam_search.LAUNCHES.update(before)
    errs = {}
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(a, a2):
            raise RuntimeError(f"{what}: B7b's {name} differs from "
                               f"the step's on its own operands")
        scale = float(w.float().abs().max())
        err = float((a.float() - w.float()).abs().max())
        errs[name] = {"max_abs_err": err, "max_abs_want": scale}
        if not err <= B7B_BF16_OF_MAX * scale:
            raise RuntimeError(f"{what}: B7b's {name} off its plain "
                               f"version by {err} (bound {B7B_BF16_OF_MAX}"
                               f" x {scale})")
    b, s_, h, dh = q.shape
    return {"shape": [b, s_, k.shape[1], h, k.shape[2], dh],
            "kw": kw, "dtype": str(q.dtype), "route": list(route),
            "slices": fa.flash_bwd_slices(
                q.shape, k.shape, sms=fa._sm_count(q.device.index), **kw),
            "grads": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values())}


# ---------------------------------------------------------------------------
# the reference's examples, through their twins
# ---------------------------------------------------------------------------


def _example_module(name):
    """``examples/port_<name>.py`` beside this script, imported afresh."""
    import importlib.util
    path = os.path.join(ROOT, "examples", f"port_{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _clone(x):
    """``x`` with its tensors cloned, out of autograd (tuples and lists
    walked)."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(a) for a in x)
    return x


#: where each kernel's launch goes through a module global the twins'
#: paths look up at call time: (module, attribute); B1's two counts share
#: one wrapper
EXAMPLE_WRAPPERS = {
    "acam_match": ("repro_torch.kernels.acam", "acam_match"),
    "hdc_encode": ("repro_torch.kernels.hdc_encode", "hdc_encode_planes"),
    "fused_topk_packed": ("repro_torch.kernels.ops", "fused_topk_packed"),
    "fused_topk_packed_ternary": ("repro_torch.kernels.ops",
                                  "fused_topk_packed"),
    "fused_topk": ("repro_torch.kernels.ops", "fused_topk"),
    "flash_attention": ("repro_torch.kernels.flash_attention",
                        "_forward_cuda"),
    "flash_attention_bwd": ("repro_torch.kernels.flash_attention",
                            "flash_attention_backward"),
    "ssd_scan": ("repro_torch.kernels.ssd_scan", "ssd_scan"),
    "slstm_scan": ("repro_torch.kernels.slstm_scan", "slstm_scan")}


def _example_key(kernel, args, kw):
    """Which of a kernel's first calls a call is: B1 binary or ternary by
    its care mask, B7 a decode (one query row) or a prefill."""
    if kernel.startswith("fused_topk_packed"):
        care = args[2] if len(args) > 2 else kw.get("care")
        return "fused_topk_packed" if care is None \
            else "fused_topk_packed_ternary"
    if kernel == "flash_attention":
        return "flash_attention decode" if args[0].shape[1] == 1 \
            else "flash_attention prefill"
    return kernel


@contextlib.contextmanager
def example_calls(kernels):
    """Within the block, the first call of each of ``kernels``' wrappers
    (``EXAMPLE_WRAPPERS``, through ``intercept``; B7's first prefill and
    first decode) outside a CUDA graph capture keeps a copy of its
    operands and of its result: the yielded dict, key -> (args, kwargs,
    result).  A graph's warm-up call is kept, its capture is not."""
    import importlib
    import threading
    import torch
    kept, lock = {}, threading.Lock()

    def keep(kernel):
        def first(i, args, kw, out):
            if not torch.cuda.is_current_stream_capturing():
                key = _example_key(kernel, args, kw)
                with lock:       # the serving twins call from their threads
                    if key not in kept:
                        kept[key] = (_clone(args), dict(kw), _clone(out))
        return first

    targets = {EXAMPLE_WRAPPERS[n]: n for n in kernels}
    with contextlib.ExitStack() as stack:
        for (mod, attr), kernel in targets.items():
            stack.enter_context(intercept(importlib.import_module(mod), attr,
                                          keep(kernel)))
        yield kept


def _example_b7_kw(args, kw):
    """B7's host masks from a ``_forward_cuda`` call's arguments."""
    names = ("q", "k", "v", "causal", "prefix_len", "kv_len", "q_start",
             "want_lse", "start")
    call = dict(zip(names, args), **kw)
    return host_masks({"causal": call["causal"],
                       "prefix_len": call["prefix_len"],
                       "kv_len": call["kv_len"], "q_start": call["q_start"],
                       "start": call.get("start")})


def b2_scale(q, p, metric):
    """Each query row's largest sum of magnitudes over B2's terms,
    ``|alpha| sum |q_i p_i| + |beta| sum |f(q)| + |gamma| sum |f(p)|``
    (float64): ``DOT_RTOL`` of it bounds B2's float32 error."""
    from repro_torch.kernels import cam_search as tcs
    alpha, beta, gamma, qk, pk = tcs.METRIC_COEFFS[metric]
    q64, p64 = q.double().abs(), p.double().abs()
    scale = abs(alpha) * (q64 @ p64.T)
    if beta:
        scale = scale + abs(beta) * (q64 if qk == "x" else q64 * q64).sum(
            1, keepdim=True)
    if gamma:
        scale = scale + abs(gamma) * (p64 if pk == "x" else p64 * p64).sum(
            1)[None, :]
    return scale.amax(1)


def b2_index_swaps(q, p, metric, scale, got_i, want_i, what) -> int:
    """``dot_index_swaps`` for any of B2's metrics: each position where the
    two index tensors differ must be a float64 near-tie, the exact
    distances of query row ``r`` to both chosen rows within
    ``DOT_RTOL`` of ``scale[r]`` (``b2_scale``).  Returns their count."""
    import torch
    from repro_torch.kernels import cam_search as tcs
    alpha, _, gamma, _, pk = tcs.METRIC_COEFFS[metric]
    rows, cols = (got_i != want_i).nonzero(as_tuple=True)
    if rows.numel():
        qr = q[rows].double()
        pa = p[got_i[rows, cols].long()].double()
        pb = p[want_i[rows, cols].long()].double()
        # the query's own term is the same for both rows
        gap = alpha * (qr * (pa - pb)).sum(1)
        if gamma:
            fa_, fb = (pa, pb) if pk == "x" else (pa * pa, pb * pb)
            gap = gap + gamma * (fa_.sum(1) - fb.sum(1))
        bad = (gap.abs() > DOT_RTOL * scale[rows]).nonzero()
        if bad.numel():
            j = int(bad[0, 0])
            raise RuntimeError(f"{what}: index difference at ({int(rows[j])}"
                               f", {int(cols[j])}) is not a float64 "
                               f"near-tie: gap {float(gap[j])}")
    return int(rows.numel())


def example_check(s: Smoke, what, key, args, kw, out):
    """One kept call of a twin's run held to its plain version on the same
    operands, as the phases above hold the kernel: B1, B3 and B5 bit for
    bit (and the call again equal to the run's own result), B2 as
    ``router_check`` holds its values (within ``DOT_RTOL`` of its terms'
    magnitudes, ``b2_scale``; index differences float64 near-ties), B7 by
    ``b7_check``, B7b by ``vlm_b7b_check``.  Returns the record (``max_abs_err``)."""
    import torch
    from repro_torch.kernels import acam as kacam
    from repro_torch.kernels import cam_search as tcs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hdc_encode as khdc
    if key.startswith("flash_attention "):
        q, k, v = args[:3]
        return b7_check(f"{what} B7 {key.split()[1]}", q, k, v,
                        _example_b7_kw(args, kw))
    if key == "flash_attention_bwd":
        return vlm_b7b_check(list(args), kw, list(out), what=what)
    if key == "ssd_scan":
        return m1_check(f"{what} M1", args, kw, out, timed=False)
    if key == "slstm_scan":
        return x1_check(f"{what} X1", args, out, timed=False)
    if key == "acam_match":
        got, want = kacam.acam_match(*args, **kw), \
            kacam.acam_match_reference(*args, **kw)
        same = torch.equal(got, want) and torch.equal(got, out)
        err = float((got.int() - want.int()).abs().max()) if got.numel() \
            else 0.0
        shape = {"q": list(args[0].shape), "rows": list(args[1].shape)}
    elif key == "hdc_encode":
        level_idx, planes = args
        got = khdc.hdc_encode_planes(level_idx, planes)
        want = khdc.hdc_encode_reference(level_idx, planes.keys,
                                         planes.levels)
        same = torch.equal(got, want) and torch.equal(got, out)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        shape = {"level_idx": list(level_idx.shape),
                 "keys": list(planes.keys.shape)}
    elif key.startswith("fused_topk_packed"):
        got = tcs.fused_topk_packed(*args, **kw)
        want = tcs.fused_topk_packed_reference(*args, **kw)
        same = all(torch.equal(a, b) for a, b in zip(got, want)) and \
            all(torch.equal(a, b) for a, b in zip(got, out))
        err = float((got[0] - want[0]).abs().max()) if got[0].numel() \
            else 0.0
        shape = {"q": list(args[0].shape), "p": list(args[1].shape),
                 "k": kw["k"]}
    elif key == "fused_topk":
        qp, pp = args
        got = tcs.fused_topk(qp, pp, **kw)
        want = tcs.fused_topk_reference(qp, pp, **kw)
        torch.cuda.synchronize()
        diff = (got[0] - want[0]).abs()
        scale = b2_scale(qp, pp, kw["metric"])
        if not bool((diff.double() <= DOT_RTOL * scale[:, None]).all()):
            raise RuntimeError(f"{what}: B2 values off the plain version by "
                               f"{float(diff.max())}")
        swaps = b2_index_swaps(qp, pp, kw["metric"], scale, got[1],
                               want[1], f"{what} B2")
        same = all(torch.equal(a, b) for a, b in zip(got, out))
        err = float(diff.max()) if diff.numel() else 0.0
        shape = {"q": list(qp.shape), "p": list(pp.shape), "k": kw["k"],
                 "n_valid": kw["n_valid"],
                 "index_swaps_float64_near_ties": swaps}
    else:
        raise RuntimeError(f"{what}: no check for {key}")
    torch.cuda.synchronize()
    if not same:
        raise RuntimeError(f"{what}: {key} differs from its plain version "
                           f"or from the run's own call")
    return dict(shape, max_abs_err=err)


def phase_examples(s: Smoke):
    """Each twin of ``EXAMPLES`` in process on the card (its own asserts
    fail the phase), its printed lines kept in the log, with the launch
    counts at 0 before it: each kernel it must reach launched at least
    once and no other kernel at all.  Each kernel's first call in the
    run (``example_calls``) is then held to its plain version
    (``example_check``); those calls are not counted as the run's."""
    import io
    import tempfile
    import torch
    from repro_torch.kernels import cam_search
    runs, total, checks = [], {}, {}
    with tempfile.TemporaryDirectory() as ckpt:
        for name, argv, kernels in EXAMPLES:
            if name == "train_lm":
                argv = argv + ["--ckpt-dir", os.path.join(
                    ckpt, str(len(runs)))]
            out = io.StringIO()
            cam_search.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with example_calls(kernels) as kept, \
                    contextlib.redirect_stdout(out):
                result = _example_module(name).main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = {k: v for k, v in cam_search.LAUNCHES.items() if v}
            missing = [k for k in kernels if not counts.get(k)]
            other = sorted(set(counts) - set(kernels))
            if missing or other:
                raise RuntimeError(f"examples {name} {argv}: launches "
                                   f"{counts}, expected {list(kernels)}")
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            tag = f"example_{name}" + ("_moe" if "--moe" in argv else "")
            held = {key: example_check(s, f"examples {tag}", key, *call)
                    for key, call in sorted(kept.items())}
            if {key.split()[0] for key in held} != set(kernels):
                raise RuntimeError(f"examples {name} {argv}: kept calls of "
                                   f"{sorted(held)}, expected "
                                   f"{list(kernels)}")
            for key, rec in held.items():
                checks.setdefault(key.split()[0], {})[
                    f"{tag}_{key.split()[-1]}"
                    if key.startswith("flash_attention ") else tag] = rec
            lines = out.getvalue().splitlines()
            print(f"examples: port_{name}.py {' '.join(argv)}: "
                  f"{seconds:.2f} s, launches {counts}, held to the plain "
                  f"versions: { {k: r['max_abs_err'] for k, r in held.items()} }",
                  flush=True)
            runs.append({"example": f"examples/port_{name}.py",
                         "argv": argv, "seconds": seconds,
                         "launches": counts, "checks": held,
                         "last_lines": lines[-4:],
                         "result": {k: v for k, v in (result or {}).items()
                                    if isinstance(v, (int, float, str))}})
    for name, n in total.items():
        src, ref = EXAMPLE_KERNELS[name]
        s.record(name, src, ref, n,
                 max(c["max_abs_err"] for c in checks[name].values()), None,
                 None, None, "operations", None)
        s.kernels[name].setdefault("shapes", {}).update(checks[name])
    log({"phase": "examples", "ok": True, "runs": runs, "launches": total})


def release_phase_state(torch, top: int = 6):
    """What a phase leaves allocated on the card, and its release: the
    engine's process-wide plan cache (each plan's memo of prepared
    galleries: 0.74 GB for a float KNN gallery) is cleared, so no phase
    inherits an earlier one's.  Reports the GB left before and after,
    the plans that were cached and the largest CUDA tensors still
    reachable before the release."""
    import gc
    import warnings
    from repro_torch.core import clear_plan_cache, plan_cache_stats
    gc.collect()
    left_gb = torch.cuda.memory_allocated() / 1e9
    sizes = {}
    with warnings.catch_warnings():      # deprecated names met on the way
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            try:
                if not (isinstance(obj, torch.Tensor) and obj.is_cuda):
                    continue
                key = (tuple(obj.shape),
                       str(obj.dtype).replace("torch.", ""))
                n, b = sizes.get(key, (0, 0))
                sizes[key] = (n + 1, b + obj.numel() * obj.element_size())
            except Exception:   # noqa: BLE001 — a half-built object
                continue
    largest = sorted(sizes.items(), key=lambda kv: -kv[1][1])[:top]
    plans = plan_cache_stats()["plans"]
    clear_plan_cache()
    gc.collect()
    torch.cuda.empty_cache()
    return {"left_gb": left_gb, "plans_cached": plans,
            "largest_left": [{"shape": list(k[0]), "dtype": k[1],
                              "count": n, "gb": b / 1e9}
                             for k, (n, b) in largest],
            "after_release_gb": torch.cuda.memory_allocated() / 1e9}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"the port's package is missing: {src}/repro_torch")
    sys.path.insert(0, src)
    import repro_torch.kernels.build as kbuild

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions and
    torch.backends.cudnn.allow_tf32 = False         # yardsticks in float32
    # bf16 products accumulate in float32, as the reference's
    # preferred_element_type asks
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    clock = nvidia_smi("clocks.max.sm")
    props = torch.cuda.get_device_properties(0)
    max_mhz = float(clock.split()[0]) if clock else props.clock_rate / 1e3 \
        if hasattr(props, "clock_rate") else 1980.0
    log({"device": {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
                    "sms": props.multi_processor_count,
                    "max_sm_clock_mhz": max_mhz, "torch": torch.__version__,
                    "cuda": torch.version.cuda}})

    s = Smoke(torch, props, max_mhz)
    t0 = time.perf_counter()
    try:
        built = kbuild.build()
    except Exception:       # noqa: BLE001 — report and stop: nothing runs
        traceback.print_exc()
        fail("the CUDA kernels did not build")
    regs = {n: [ln.split(":", 1)[1].strip()
                for ln in kbuild.build_log(n).splitlines()
                if "registers" in ln] for n in kbuild.SOURCES}
    spills = {n: [ln.strip() for ln in kbuild.build_log(n).splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
              for n in kbuild.SOURCES}
    log({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
         "built": built, "ptxas": regs,
         "spills": {n: v for n, v in spills.items() if v}})

    from repro_torch.data import knn_dataset
    t0 = time.perf_counter()
    data = knn_dataset(**KNN_DATA)             # 180,000 x 1024, 624 queries
    log({"phase": "data", "seconds": time.perf_counter() - t0,
         "gallery": list(data[0].shape), "queries": list(data[2].shape)})

    phases = [("knn_eucl", lambda: phase_knn_eucl(s, data)),
              ("hamming_packed",
               lambda: _packed_phase(s, "hamming_packed", data, False)),
              ("tcam_ternary",
               lambda: _packed_phase(s, "tcam_ternary", data, True)),
              ("hdc_quickstart", lambda: phase_hdc_quickstart(s)),
              ("forest_acam", lambda: phase_forest_acam(s)),
              ("range_threshold", lambda: phase_range_threshold(s, data)),
              ("hdc_mnist", lambda: phase_hdc_mnist(s)),
              ("gallery_update", lambda: phase_gallery_update(s, data)),
              ("distance_ops", lambda: phase_distance_ops(s, data)),
              ("queue_c", lambda: phase_queue_c(s, data)),
              ("cam_serve", lambda: phase_cam_serve(s, data)),
              ("gateway_serve", lambda: phase_gateway_serve(s, data)),
              ("tune", lambda: phase_tune(s, data)),
              ("hier_search", lambda: phase_hier_search(s, data)),
              ("sharded", lambda: phase_sharded(s, data)),
              ("lm_serve", lambda: phase_lm_serve(s)),
              ("moe_serve", lambda: phase_moe_serve(s)),
              ("audio_serve", lambda: phase_audio_serve(s)),
              ("ssm_serve", lambda: phase_ssm_serve(s)),
              ("hybrid_serve", lambda: phase_hybrid_serve(s)),
              ("long_500k", lambda: phase_long_500k(s)),
              ("vlm_serve", lambda: phase_vlm_serve(s)),
              ("dense_configs_serve", lambda: phase_dense_configs_serve(s)),
              ("lm_train", lambda: phase_lm_train(s)),
              ("lm_sharded", lambda: phase_lm_sharded(s)),
              ("examples", lambda: phase_examples(s))]
    wanted = sys.argv[1:]
    unknown = set(wanted) - {name for name, _ in phases}
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")
    phases = [(n, run) for n, run in phases if not wanted or n in wanted]
    for name, run in phases:
        torch.cuda.reset_peak_memory_stats()
        s.phase_peak = 0
        start_gb = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        try:
            run()
        except Exception as e:  # noqa: BLE001 — a failed phase fails the run
            traceback.print_exc()
            s.failed.append(name)
            log({"phase": name, "ok": False, "error": repr(e)})
        finally:
            peak_gb = max(s.phase_peak,
                          torch.cuda.max_memory_allocated()) / 1e9
            left = release_phase_state(torch)
        log({"phase_seconds": {name: time.perf_counter() - t0}})
        log({"phase_memory": {name: {"start_gb": start_gb, "peak_gb": peak_gb,
                                     **left}}})
    if s.failed:
        fail(f"failed phases: {s.failed}")
    order = ["fused_topk_packed", "fused_topk_packed_ternary", "fused_topk",
             "acam_match", "range_match", "hdc_encode", "hdc_encode_wide",
             "distance", "distance_topk", "distance_topk_packed",
             "topk_select", "packed_distance", "flash_attention",
             "flash_attention_bwd", "ssd_scan", "slstm_scan"]
    print(smi, flush=True)
    log({"kernels": [s.kernels[n] for n in order
                     if not wanted or n in s.kernels]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
