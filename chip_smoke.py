#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's main path -- the planned hash SpGEMM of the paper --
through the entry points a user calls, at the paper's own input sizes
(R-MAT, edge factor 16, squared: ER at scale 18 and G500 at scale 16,
seed 0), then the sorted-output (PB) and block-sparse (BCSR) routes, SpMM,
the paper's graph workloads, the batched fleet planner and BCSR, PB and
hash value fleets under ``torch.func.vmap``, then the LM serving path
(qwen3-0.6b at full width, prefill through the flash-attention kernel;
mamba2-780m at full width, prefill through the SSD chunk-scan kernel),
then product chains (R.A.P, A^3, A^T.A, batched powers, MCL), then the
measured recipe (the autotuner's race of algorithms and its DB), and holds
every hand-written kernel against its plain PyTorch version.
Phases; any failure exits non-zero:

  1. the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from the checkout's sources;
  3. the hash-table saturation fixtures (load factor exactly 1.0, and one
     past fill) through the scalar and vector kernels, bitwise against
     the plain versions after a per-row sort; the hash numeric kernel's
     launch shape per table class (``cudaOccupancyMaxActiveClusters`` for
     clusters of 2, 4 and 8 blocks) and the symbolic bitmap class's at
     65,536 columns;
  4. per input: ``plan_spgemm(a, a)`` under ``algorithm="auto"`` and
     ``plan.execute``; an explicit ``hash_vector`` plan; the planless
     ``spgemm(..., algorithm="hash")``; ``execute(sorted_output=True)``.
     The launch counters are zeroed just before each of these paths and
     read just after: each must have launched its kernels and never the
     plain versions.  Outputs: row pointers bitwise equal to the plan's, each
     row's columns bitwise equal to the plain version's, values bitwise
     on a dyadic-valued copy of A and within 1 ulp per accumulated
     product on the R-MAT values; the symbolic kernel's row counts equal
     the planner's ESC counts bitwise.  The numeric kernel's row classes:
     the classifying kernel equal to its plain version, rows, flop, nnz(C)
     and table slots per class, each class that holds rows launched once
     by ``plan.execute`` (G500: rows on clusters of 2, 4 and 8 blocks,
     none in device memory; ER: none on a cluster).  The symbolic
     kernel's, the single product as the fleet of one member with B's
     width: the classifying kernel against its plain version, rows, flop
     and table slots per class, one ``symbolic_call`` launching one
     classification and one launch per class its largest table allows
     (G500: rows past 4,096 slots on the bitmap class, none on a cluster
     or in device memory);
  5. median CUDA-event times of each kernel, its plain version and
     ``torch.sparse.mm`` (cuSPARSE; a yardstick only, never on the path),
     each beside its least possible time on the card (the symbolic kernel,
     each probe mode, also 20 back to back; the planless front door
     ``spgemm(algorithm="hash")`` beside ``torch.sparse.mm``); each probe mode's
     execute, and its numeric kernel through the wrapper that reads its
     own ``errors`` back and through the custom op the execute calls
     (``numeric_op``: the op's own cost);
  6. sorted output on ER s18: ``plan_spgemm(a, a, sorted_output=True)``
     under ``algorithm="auto"`` must choose propagation blocking (``pb``);
     ``plan.execute`` must launch the scatter and merge kernels once each,
     no plain version and no inspection, and a repeat plan must hit the
     cache.  The output is row-sorted, its structure bitwise equal to the
     sorted hash route's, its values bitwise equal to the plain versions on
     dyadic values and within 1 ulp per accumulated product otherwise;
     then the same timings as phase 5 (each kernel also back to back), and
     each kernel again through its custom op (``scatter_op``,
     ``merge_op``: the op's own cost);
  7. block-sparse products (BCSR, 8x8 tiles): an R-MAT pattern over the
     block grid with every occupied tile dense -- ER at scale 13 (n =
     65,536, 65,501 tiles) and G500 at scale 10 (2,048-slot tables, a hub
     row of 245 A blocks), edge factor 8, seed 0.
     ``plan_spgemm(a, a, algorithm="bcsr")`` must launch the hash symbolic
     kernel once (the block-pattern inspection); ``plan.execute`` and
     ``BCSRPlan.execute`` the block kernel once each, no plain version and
     no inspection; repeat plans hit the cache; an explicit
     ``plan_bcsr(vector=True)`` runs the chunked-probe modes.  Block rows
     and their block-column sets equal the plain version's and the plan's
     symbolic counts; tiles bitwise on dyadic values and within 1 ulp per
     product on uniform ones; two calls and the two probe modes give the
     same bits; the CSR output has the scalar hash plan's structure.  The
     block kernel's row classes: the classifying kernels against their
     plain version, each execute one classification and one launch per
     class that can hold rows (G500: its hub row first in the largest
     shared-memory class); rows, block pairs, outputs and each class's
     launch alone back to back.  Then the timings (the execute's
     re-blocking and flattening apart, the kernel alone -- a single call
     and 20 back to back, beside the host's time to issue one -- and
     through the custom op the execute calls, the class kernels' device
     time from a ``torch.profiler`` trace), beside the bound, the plain
     version and ``torch.sparse.mm``.  Last, a small
     block-clustered input (a 128 x 128 grid of 8x8 tiles) that
     ``plan_spgemm(a, a)`` must route to ``bcsr`` by itself;
  8. SpMM (``core.spmm``, the CSR x dense kernel) on ER s18 ef16 and on
     the graph of phase 9, X (n, 64) float32 from a seeded generator and
     dyadic values, plus (on ER) k = 100 and a bfloat16 X: the row lists
     (the classifying kernel) made once per CSR and memoized on it, then
     one SpMM launch per call and no plain version; the kernel bitwise
     equal to its plain version, and within 1 ulp per accumulated product
     of scipy's float64 ``A @ X`` (exactly equal on dyadic values); where
     rows pass 256 nonzeros, which copy path took their X rows.  The
     classifying kernel's lists equal to its plain version's; rows,
     nonzeros and the device time per length class (a launch with the
     other classes' counts zeroed, timed back to back: one CUDA event pair
     around 20 launches, divided by 20, beside the host's time to issue
     one; ``torch.profiler`` traces taken after phase 5's lose kernels,
     and more of them here left phase 21's trace without its classifying
     kernel), the launch shape, the longest row.  Then the median
     single-call times of the SpMM launch, of it with the classifying
     kernel, of the front door, beside the byte bound, the plain version
     and ``torch.sparse.mm(A, X)``, and the back-to-back times of the
     launch and of ``torch.sparse.mm``;
  9. the paper's graph workloads (sections 5.5-5.6) on R-MAT G500 s16
     ef16, seed 1, symmetrized: the triangle count (masked L.U) equal to
     scipy's; dense (SpMM, one launch per hop, one classifying launch for
     all hops) and masked-frontier BFS
     from 64 sources over 6 hops equal to each other and to scipy's
     ``shortest_path``; the repeat masked BFS plans nothing new.  One
     timing line;
 10. the square x tall-skinny product of section 5.5 (2^6 columns of the
     G500 s16 graph itself): ``plan_spgemm(a, b).execute`` launches the
     hash numeric kernel once; structure and values as in phase 4;
 11. BCSR at 64x64 tiles (4,096 output lanes a tile, the largest
     shared-memory class): ``plan_spgemm(algorithm="bcsr", block=(64,
     64)).execute`` against the plain version and the hash plan, its row
     classes against their plain version, the kernel's times;
 12. the batched fleet planner, ``plan_batch(pairs).execute``, on three
     fleets: MoE dispatch at qwen3-moe-30b-a3b's routing widths (128
     experts, top-8, d_model 2,048, 16,384 tokens, feature density 0.05,
     one F shared by every expert); ``benchmarks/common.py``'s mixed
     ``rmat_fleet(64, 10)`` (also pinned to ``hash_vector``); and two G500
     s16 ef16 squares, whose rows of up to 131,072-slot tables run on
     clusters.  Each execute must launch, per plan class, the classifying
     kernel once and one batched numeric launch per table class its
     largest table allows, and nothing else; every member against the
     batched plain version and the per-product planned loop (row pointers
     and columns bitwise, values within 1 ulp per product), the MoE
     outputs bitwise against the gathered feature rows.  Each phase's
     table classes on the plan's arguments: the classifying kernel
     against its plain version, rows, products and nnz(C) per class, each
     class launch's device ms.  Timings: the batched execute, the
     per-product loop, the kernels alone (numeric, and symbolic on the
     same arguments; single calls and back to back), the plain version
     and a loop of ``torch.sparse.mm`` per member; for the
     MoE fleet also a serving call (``plan_batch(pairs).execute`` under
     ``torch.inference_mode()``) on its tensors and on copies made under
     inference mode, which must hit the plan cache;
 13. BCSR value fleets: ``torch.func.vmap`` of ``BCSRPlan.execute`` over
     members' tile values on one frozen block structure (DBCSR's repeated
     products), on phase 7's inputs: the ER pattern with 8 members of A's
     tiles against a shared B (a dyadic and a uniform fleet), with 4
     members of both A's and B's tiles, and through ``plan_bcsr(vector=
     True)``; the G500 pattern (launches with a workspace: rows staged in
     the largest shared-memory block, direct past it) with 4 members; and
     4 members at 64x64 tiles.  Each vmapped call must run the custom op's
     vmap rule once -- the batched block kernel, once per bin index
     holding rows -- and nothing else; every member against the batched
     plain version and the per-member execute (tiles bitwise on dyadic
     values, within 1 ulp per product otherwise).  Timings: the vmapped
     execute, the batched kernel (CUDA events and its ``torch.profiler``
     device time), a per-member execute loop, the batched plain version
     and a loop of ``torch.sparse.mm`` over the members' flattened CSRs,
     beside the byte bound;
 14. PB value fleets (run right after phase 6, on its input): ``torch.func.
     vmap`` of the ER s18 sorted plan's ``PBPlan.execute`` over 8 members
     of A's values against a shared dyadic B, over 4 members with A's and
     B's values batched, and of ``plan_spgemm(a, a, sorted_output=True)
     .execute`` (which must choose ``pb`` by itself) over 8 members of A's;
     a dyadic and a uniform fleet each.  Each vmapped call must run the
     ops' vmap rules -- one batched scatter and one batched merge launch,
     and one slot-major copy a batched operand -- and nothing else; C's structure bitwise the plan's; every member
     bitwise equal to the single-product execute; the batched kernels
     against the batched plain versions (scatter bitwise, merge bitwise on
     dyadic values, else within 1 ulp per product), the merge's output in
     the layout ``kernel.batched_merge_call`` states (slot-major, rows of
     ``kernel.merge_width`` members) and its ``.contiguous()`` copy the values compared.
     Timings: the vmapped execute, each batched kernel (single call and
     back to back), the slot-major copy of each stacked operand apart
     (bitwise its plain version, beside ``x.t().contiguous()``), the
     single-product kernels once per member, the per-member execute loop,
     the batched plain versions and a loop of ``torch.sparse.mm`` per
     member, beside the byte bound (shared index arrays counted once);
 16. hash value fleets (ER right after phase 14, on phase 4's inputs):
     ``torch.func.vmap`` of the recipe's hash plan's ``execute`` over 8
     members of ER s18's values against a shared dyadic B, over 4 members
     with A's and B's values, of the other probe mode's plan over 8
     members, and of the planless ``spgemm_hash`` with the plan's schedule
     pinned over 8 members (the batched symbolic kernel too, with B's
     width: G500's bitmap class); G500 s16 over 2 members, planned and
     planless; a
     dyadic and a uniform fleet each.  Each vmapped call must run the ops'
     vmap rules -- per phase one classifying launch and one batched launch
     per table class the plan's largest table allows (the symbolic one
     with the bitmap class) -- and nothing else; row pointers the plan's;
     the batched
     symbolic counts bitwise the plan's ESC counts and the batched plain
     version's; the batched numeric kernel and every member against the
     batched plain version (columns bitwise, values bitwise on dyadic
     values, else within 1 ulp per product), each dyadic member bitwise
     equal to the single-product execute; each phase's table classes as
     in phase 12.  Timings: the vmapped call, each batched kernel (single
     calls and back to back), the single-product kernels once per member
     and one of them back to back, the
     per-member loop, the batched plain versions and a loop of
     ``torch.sparse.mm`` per member, beside the byte bound (shared index
     arrays counted once);
 17. the flash-attention kernels at qwen3-0.6b's widths (16 query heads, 8
     KV heads, head dim 128): ``ptxas`` registers and spills of the
     tensor-core kernel; against the plain version, float32 through the
     CUDA-core kernel (within 2e-5) and bfloat16 through the tensor-core
     kernel (within one bf16 ulp of the plain output plus 2e-5: each
     rounds its own float32 result, which may differ by the float32
     tolerance, so this matters only near zero), each launch on the
     kernel ``flash_fwd`` picks for (dtype, D), causal at (B 2, S 2,048)
     and (B 1, S 4,096) and not causal at Sq 1,000, Skv 3,000; at (B 1, S
     4,096) and (B 1, S 32,768) bf16 causal, median CUDA-event times
     beside the plain version (at 32,768 head by head, which is also the
     check there), ``scaled_dot_product_attention`` (a yardstick only,
     never on the path) and the operations bound; the float32 kernel
     timed at S 4,096;
 18. serving qwen3-0.6b at full width (28 layers, random float32 weights
     from seed 0, bf16 compute, TF32 off) through ``Engine(max_batch=4,
     max_len=4,096)``: 9 requests (six prompts as ``launch/serve.py``
     draws them, and long ones of 1,000, 1,024 and 2,048 tokens), 16 new
     tokens each.  Counters zeroed around the run and read per call: each
     admission launches the flash kernel 28 times, all on the tensor-core
     kernel, and its plain version never, a decode step neither, nothing
     else runs; every request finishes with its tokens.  Prefill logits
     of the short prompt and the long ones through "flash" against
     "full": at float32 (the CUDA-core kernel) within a
     relative L2 distance of 1e-4; at bf16 "flash" at most 1.5 times as
     far from the float32 logits as "full" is.  A float32 copy of the
     config passes ``tests/test_serve.py``'s greedy-equals-
     re-prefill check over 4 tokens (logits compared instead, within 1e-4
     of the largest |logit|, where the top-2 gap is under that).  Timing
     line: prefill ms per prompt length, decode-step ms at batch 4,
     tokens/s; the 2,048-token prefill's device time and the flash
     kernels' share of it;
 19. the SSD chunk-scan kernels at mamba2-780m's widths (48 heads of head
     dim 64, one group, state 128, chunks of up to 256; log_a = -softplus
     (N(0, 1)) A with A the config's span 1-16) against their plain
     version: float32 on the CUDA-core kernel (y and final state within
     1e-4 plus 8 float32 ulps of the chunk's largest |cumsum of log_a|,
     of the largest |value|) and bfloat16 on the tensor-core kernel (y
     within one bf16 ulp more), each case's variant counted, at (B 1, S
     4,096), (B 1, S 1,000: chunks of 250), (B 2, S 2,048) and two groups
     at S 2,048; the tensor-core kernel's three passes one by one against
     ``ref.py``'s plain passes at S 4,096 and 1,000; at S 4,096 and
     32,768 bf16, two calls bitwise equal, the median single-call
     CUDA-event time and the card's time a call back to back (20 calls in
     one event pair), each pass's device time (``torch.profiler``), the
     plain version and the bound (bytes at 3.35 TB/s or the least
     operations at 989 TFLOP/s, C B^T shared by a group's heads);
 20. serving mamba2-780m at full width (48 SSD layers, random float32
     weights from seed 0, bf16 compute) through ``Engine(max_batch=4,
     max_len=4,096)``: six prompts as ``launch/serve.py`` draws them, one
     of 1,000 and one of 2,048 tokens, 16 new tokens each; each admission
     launches the tensor-core SSD kernel 48 times and no plain version, a
     decode step nothing, every request finishes; the SSD kernels' share
     of the 2,048-token prefill's device time.  The gate that does not
     pass through the kernel: at float32 a 300-token prompt (two chunks
     of 150) through the CUDA-core kernel's prefill against the same
     tokens fed one at a time through ``decode_step`` (the recurrence)
     from empty caches, last logits and every layer's state and conv
     window within a relative L2 distance of 1e-3; then phase 18's
     float32 greedy-equals-re-prefill check.  Timing line as phase 18's;
 21. the hash kernels' device time per table class and the classifying
     launch's, numeric and symbolic, one call per probe mode on each
     phase-4 input: the one-member fleet call (the single product's
     launches, without its read-back of the bins) issued behind a
     sleeping kernel, so that CUDA events around each launch hold the
     card's work and none of the host's;
 22. the chain planner (``core/chain.py``) at the paper's sizes:
     ``plan_galerkin(r, a, p)`` with ``aggregation_csr(n, n // 8)`` on ER
     s18 and G500 s16 ef16, unsorted and sorted output (ER sorted: a
     ``pb`` last stage on a sorted hop, the slot-order rule; ten repeat
     executes agree; the hash stage's raw slot order and the unprotected
     composition into ``pb`` printed); ``plan_power(a, 3)`` on ER s16
     under ``auto``, ``hash`` and ``hash_vector``; ``plan_gram`` on ER s18
     and G500 s16 (a re-weighted A re-gathers values only: no miss, one
     product launch); ``plan_batch_power`` over ``block_diagonal_demo``'s
     12 blocks (k 2) and the A's of phase 12's ``rmat_fleet(64, 10)`` (k
     3); the MCL twin on 3 x 12 and 16 x 256 planted partitions.  Every
     execute launches each stage's kernel once (one classification per
     hash stage) and no plain version, and a repeat plan hits the cache;
     each stage within 1 ulp per product of the plain version on the
     kernel's own intermediate, row pointers the plan's; dyadic chains
     bitwise the plain composition; the Galerkin products and ER's Gram
     within 1e-5 relative of scipy's float64 chain; batched members equal
     their ``plan_power`` (dyadic: bitwise); both MCL runs recover their
     clusters.  A timing line per chain: the execute (single call and 20
     back to back), the same chain with ``sort_intermediates=True``, each
     stage's kernels, plain version and ``torch.sparse.mm``, the chain of
     ``torch.sparse.mm`` (a yardstick only), plan seconds and each stage's
     bound;
 23. the measured recipe (``plan_spgemm(autotune=True)``, ``repro_torch.
     autotune``) on a fresh DB in a temporary directory: A.A of ER s18
     ef16 and of G500 at AUTOTUNE_G500_SCALE ef16 (every lane timed: esc,
     heap, pb where the compression gate lets it, hash and hash_vector at
     table scales 1 and 2, hash_jnp); each lane's median time, the
     winner, the heuristic plan's choice and the winner's roofline.  The
     measured plan's execute launches the winner's kernels and no plain
     version, its output against the plain version (structure bitwise,
     values within 1 ulp per product); a repeat request is a DB hit that
     times nothing; the measured plan's execute no slower than 1.05 x the
     heuristic plan's, best of 5 each, in turns.  Then an entry naming
     ``hash`` at table scale 2 for G500 s16: a DB hit that times nothing,
     tables the clipped doubles of the scale-1 plan's, the output against
     the plain version, both plans' class launches and times.  Last the
     Table 2 proxies (``data/matrices.suite``, divisor 256, the first
     AUTOTUNE_SUITE_MATRICES in Table 2's order) raced as the R-MAT
     inputs, without the speed gate; one row each (n, nnz, compression,
     heap steps, Table 4's choice and its time, the winner and its) and
     the count on which Table 4's choice is within 5 % of the winner;
 15. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Usage: ``python3 chip_smoke.py`` (one card, no arguments).  A quick first
check of a changed kernel at small sizes is
``PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    # the card's rates (H100 SXM5 80GB HBM3, 700 W, NVIDIA data sheet) are
    # defined once, in the port
    from repro_torch.analysis.roofline import BF16_FLOPS, FP32_FLOPS, HBM_BW
except ImportError:     # a copy of this script alone: main() says so
    BF16_FLOPS = FP32_FLOPS = HBM_BW = None

#: the paper's inputs (section 5.1): R-MAT scale per preset, edge factor 16
ER_SCALE, G500_SCALE, EDGE_FACTOR = 18, 16, 16
#: timed repetitions per call (median taken)
REPS = 7

#: dyadic values: exact float32 products and sums
DYADIC = (0.5, 1.0, 1.5, 2.0)

#: block-sparse inputs: (preset, R-MAT scale of the block grid, edge
#: factor); tiles of BLOCK, every occupied tile dense
BCSR_INPUTS = (("ER", 13, 8), ("G500", 10, 8))
BLOCK = (8, 8)
#: the block kernel's (bm, bk, bn) for BLOCK tiles
BLOCK3 = BLOCK + BLOCK[1:]
#: the automatic route's input: a GRID x GRID block grid (2^20 cells)
AUTO_GRID, AUTO_DENSITY = 128, 0.03
#: tiles past 1,024 lanes: a GRID x GRID block grid of LARGE_BLOCK tiles
LARGE_BLOCK, LARGE_GRID = (64, 64), 6

#: SpMM: columns of X (the BFS sources), and the other width checked
SPMM_K, SPMM_K_ODD = 64, 100
#: the graph workloads (sections 5.5-5.6): R-MAT G500, the example's seed
GRAPH_SCALE, GRAPH_SEED, BFS_SOURCES, BFS_HOPS = 16, 1, 64, 6
#: the tall-skinny B: 2^TALL_K_SCALE columns of the graph (section 5.5)
TALL_K_SCALE = 6
#: batched MoE dispatch at qwen3-moe-30b-a3b's routing widths
#: (repro/configs/qwen3_moe_30b_a3b.py: 128 experts, top-8, d_model 2,048)
#: over the 16,384 tokens of benchmarks/bench_moe_dispatch.py
MOE_EXPERTS, MOE_TOP_K, MOE_D_MODEL, MOE_TOKENS = 128, 8, 2048, 16384
MOE_DENSITY = 0.05
#: the mixed G500/ER fleet of benchmarks/common.py's rmat_fleet
FLEET_PRODUCTS, FLEET_SCALE = 64, 10
#: BCSR value fleets (members of new tile values on one block structure):
#: A batched on the ER pattern, A and B batched, the G500 pattern, 64x64
FLEET_MEMBERS, FLEET_MEMBERS_BOTH, FLEET_MEMBERS_G500 = 8, 4, 4
FLEET_MEMBERS_LARGE = 4
#: PB value fleets on the ER s18 sorted plan: A batched, A and B batched
PB_FLEET_MEMBERS, PB_FLEET_MEMBERS_BOTH = 8, 4
#: hash value fleets: ER s18 with A batched (also through hash_vector and
#: the planless spgemm_hash), with A and B batched; G500 s16 (global tables)
HASH_FLEET_MEMBERS, HASH_FLEET_MEMBERS_BOTH, HASH_FLEET_MEMBERS_G500 = 8, 4, 2

#: the LM serving path at qwen3-0.6b's widths (src/repro_torch/configs/
#: qwen3_0_6b.py: 16 query heads, 8 KV heads, head dim 128)
LM_ARCH, LM_HEADS, LM_KV_HEADS, LM_HEAD_DIM = "qwen3-0.6b", 16, 8, 128
#: phase 17: (batch, Sq, Skv, causal) checked against the plain version,
#: and the causal lengths timed (prefill_32k's length the longest)
FLASH_CHECKS = ((2, 2048, 2048, True), (1, 4096, 4096, True),
                (1, 1000, 3000, False))
FLASH_TIMED = (4096, 32768)
#: phase 17 tolerance: float32 outputs against the plain version (sums in
#: another order); bf16 outputs get one bf16 ulp on top of it
FLASH_F32_TOL = 2e-5
#: phase 18: the engine's slots and cache, six prompts as the launcher
#: draws them and three long ones (1,000: no multiple of a 64-row tile),
#: new tokens per request
SERVE_BATCH, SERVE_MAX_LEN, SERVE_SHORT, SERVE_LONG, SERVE_NEW = \
    4, 4096, 6, (1000, 1024, 2048), 16
#: phase 18 tolerances.  SERVE_F32_FLASH_REL: float32 prefill logits at
#: full width, "flash" against "full", as a relative L2 distance (sums in
#: another order through 28 layers; a wrong stride or mask moves them by
#: far more).  SERVE_BF16_RATIO: at bf16 each path rounds every layer, so
#: "flash" may be at most this many times as far from the float32 logits
#: as "full" is.  SERVE_F32_REL: float32 greedy decode against
#: re-prefill, as a share of the largest |logit|
SERVE_F32_FLASH_REL, SERVE_BF16_RATIO, SERVE_F32_REL = 1e-4, 1.5, 1e-4
#: the SSD path at mamba2-780m's widths (src/repro_torch/configs/
#: mamba2_780m.py: 48 SSD heads of head dim 64, one group, state 128,
#: chunks of up to 256)
SSD_ARCH, SSD_HEADS, SSD_HEAD_DIM, SSD_STATE, SSD_CHUNK = \
    "mamba2-780m", 48, 64, 128, 256
#: phase 19: (batch, S, groups) checked against the plain version (S 1,000
#: takes chunks of 250), and the lengths timed (prefill_32k's the longest)
SSD_CHECKS = ((1, 4096, 1), (1, 1000, 1), (2, 2048, 1), (1, 2048, 2))
SSD_TIMED = (4096, 32768)
#: phase 19 tolerance: float32 y and final state within SSD_REL plus 8
#: float32 ulps of the largest |cumsum of log_a| over a chunk, of the
#: largest |value| (each cum_i - cum_j carries the rounding of two cumsums
#: taken in another order); bf16 y gets one bf16 ulp on top of it
SSD_REL = 1e-4
#: phase 20: the two long prompts, and the float32 gate: a prompt of
#: SSD_GATE_LEN tokens (two chunks of 150) through the kernel's prefill
#: against the recurrence token by token, as a relative L2 distance of the
#: last logits and of every layer's state and conv window (the kernel's
#: exp(cum_i - cum_j) carries a few float32 ulps of |cum|, about 1,000 over
#: 150 steps of mamba2's strongest heads: ~1e-4 relative per term; a wrong
#: chunk carry, transpose or mask moves them by order 1)
SSD_LONG, SSD_GATE_LEN, SSD_GATE_REL = (1000, 2048), 300, 1e-3

#: phase 22: the launch counters each chain-stage algorithm bumps once an
#: execute; the Galerkin coarsening (aggregation_csr(n, n // 8)); A^3's
#: input (ER, edge factor 16); the pb-ended chain's repeat executes; the
#: relative distance allowed from scipy's float64 chain; the MCL graphs
#: (clusters, vertices per cluster)
CHAIN_KERNELS = {"hash": ("numeric",), "hash_vector": ("numeric_vector",),
                 "pb": ("pb_scatter", "pb_merge")}
CHAIN_COARSEN, CHAIN_POWER_SCALE, CHAIN_REPEATS = 8, 16, 10
CHAIN_SCIPY_RTOL = 1e-5
MCL_GRAPHS = ((3, 12), (16, 256))

#: phase 23: the measured recipe.  The G500 input raced in full: the heap
#: lane (the plain loop, a host sync a step) walks the largest row flop,
#: 652,619 steps at s16, 41,432 at s12 (30.5 s an execute, 4 executes a
#: lane: past a minute) and 20,286 at s11 (14.3 s; PERF.md section 6).  The
#: Table 2 proxies' divisor, and how many of them, in Table 2's order, fit
#: the phase's 150 s with the inputs before them (cage15, the third, races
#: for 87 s).  The measured plan against the heuristic plan, by the
#: race's own timer over AUTOTUNE_GATE_REPS rounds; the launch counters
#: each raced algorithm bumps once an execute
AUTOTUNE_G500_SCALE = 11
AUTOTUNE_SUITE_DIVISOR, AUTOTUNE_SUITE_MATRICES = 256, 2
AUTOTUNE_SLACK, AUTOTUNE_GATE_REPS = 1.05, 15
AUTOTUNE_KERNELS = {**CHAIN_KERNELS, "bcsr": ("bcsr_numeric",)}

KERNEL_SOURCE = "src/repro_torch/kernels/spgemm_hash/csrc/spgemm_hash.cu"
PB_SOURCE = "src/repro_torch/kernels/spgemm_pb/csrc/spgemm_pb.cu"
BCSR_SOURCE = "src/repro_torch/kernels/spgemm_bcsr/csrc/spgemm_bcsr.cu"
SPMM_SOURCE = "src/repro_torch/kernels/spmm/csrc/spmm.cu"
FLASH_WGMMA_SOURCE = \
    "src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu"
SSD_SOURCE = "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk_wgmma.cu"
REPLACES = {
    "numeric": "src/repro/kernels/spgemm_hash/kernel.py:266",
    "numeric_vector": "src/repro/kernels/spgemm_hash/kernel.py:87",
    "symbolic": "src/repro/kernels/spgemm_hash/kernel.py:235",
    "scatter": "src/repro/kernels/spgemm_pb/kernel.py:84",
    "merge": "src/repro/kernels/spgemm_pb/kernel.py:128",
    "bcsr_numeric": "src/repro/kernels/spgemm_bcsr/kernel.py:131",
    "spmm": "src/repro/kernels/spmm/kernel.py:44",
    "batched": "src/repro/kernels/spgemm_hash/kernel.py:413",
    "batched_symbolic": "src/repro/kernels/spgemm_hash/kernel.py:381",
    "bcsr_batched": "src/repro/kernels/spgemm_bcsr/kernel.py:215",
    "batched_scatter": "src/repro/kernels/spgemm_pb/kernel.py:179",
    "batched_merge": "src/repro/kernels/spgemm_pb/kernel.py:220",
    "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:88",
    "ssd_chunk": "src/repro/kernels/ssd_chunk/kernel.py:74",
}
#: the vector rows replace the chunked probe the Pallas kernels share
REPLACES["bcsr_numeric_vector"] = REPLACES["numeric_vector"]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def hash_numeric_bytes(a, b, nnz_c: int) -> int:
    """Least bytes of one hash numeric call: A's row pointer, columns and
    values, B's columns and values (and B's row pointer where it is another
    tensor than A's), the plan's indptr_c read, C's columns and values
    written."""
    m = a.n_rows
    ptr_b = 0 if b.indptr is a.indptr else 4 * (b.n_rows + 1)
    return 4 * (m + 1) + 8 * int(a.nnz) + ptr_b + 8 * int(b.nnz) \
        + 8 * nnz_c + 4 * (m + 1)


def pb_bytes(p, nnz_a: int, nnz_b: int) -> dict:
    """Least bytes of the PB pair on plan ``p``: the scatter reads src_a and
    src_b (4 bytes a product each), A's and B's values and bucket_nnz and
    writes one float32 a bucket slot; the merge reads seg and the partial
    products (4 bytes a product each) and bucket_nnz and writes C's
    values."""
    flop, nb, cap = p.total_flop, p.n_buckets, p.bucket_cap
    return {"scatter": 8 * flop + 4 * nnz_a + 4 * nnz_b + 4 * nb * cap
            + 4 * nb,
            "merge": 8 * flop + 4 * p.nnz_c + 4 * nb}


def bound_ms(nbytes: int, ops: int):
    """(least ms, what bounds it): the larger of ``nbytes`` at
    HBM_BW and ``ops`` at FP32_FLOPS."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, torch, card: str):
        import repro_torch.core as core
        from repro_torch.core.formats import CSR
        from repro_torch.data import rmat
        from repro_torch.kernels.spgemm_hash import kernel as K
        from repro_torch.kernels.spgemm_hash import ops, ref
        from repro_torch.kernels.spgemm_pb import kernel as PK
        from repro_torch.kernels.spgemm_pb import ops as pb_ops
        from repro_torch.kernels.spgemm_pb import ref as pb_ref
        from repro_torch.kernels.spgemm_bcsr import kernel as BK
        from repro_torch.kernels.spgemm_bcsr import ops as bcsr_ops
        from repro_torch.kernels.spgemm_bcsr import ref as bcsr_ref
        from repro_torch.kernels.spmm import kernel as SK
        from repro_torch.kernels.spmm import ops as spmm_ops
        from repro_torch.kernels.spmm import ref as spmm_ref
        from repro_torch.examples import graph_analytics
        from repro_torch.kernels.flash_attention import kernel as FK
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.ssd_chunk import kernel as SSDK
        from repro_torch.kernels.ssd_chunk import ops as ssd_ops
        from repro_torch.kernels.ssd_chunk import ref as ssd_ref
        self.FK, self.fa_ops, self.fa_ref = FK, fa_ops, fa_ref
        self.SSDK, self.ssd_ops, self.ssd_ref = SSDK, ssd_ops, ssd_ref
        self.torch, self.core, self.CSR, self.rmat = torch, core, CSR, rmat
        self.SK, self.spmm_ops, self.spmm_ref = SK, spmm_ops, spmm_ref
        self.ga = graph_analytics
        self.K, self.ops, self.ref = K, ops, ref
        self.PK, self.pb_ops, self.pb_ref = PK, pb_ops, pb_ref
        self.BK, self.bcsr_ops, self.bcsr_ref = BK, bcsr_ops, bcsr_ref
        self.card = card
        self.dev = torch.device("cuda")
        self.rows = []          # the kernels line
        self.class_profiles = []  # phase 21's calls, per input
        self.library_ms = {}    # torch.sparse.mm time per input

    # ---- helpers ---------------------------------------------------------
    def counted(self, fn):
        """Run ``fn`` between a reset and a read of every launch counter
        (the PB, BCSR, SpMM, flash-attention and SSD counters under
        ``pb_``, ``bcsr_``, ``spmm_``, ``flash_`` and ``ssd_`` names; the
        hash numeric kernel's class launches, extra to its one count a
        call, in ``self.class_counts``, the BCSR kernel's in
        ``self.bcsr_class_counts``, the PB scatter's slot-major copies in
        ``self.pb_copy_counts``)."""
        others = {"pb": self.pb_ops, "bcsr": self.bcsr_ops,
                  "spmm": self.spmm_ops, "flash": self.fa_ops,
                  "ssd": self.ssd_ops}
        self.ops.reset_kernel_calls()
        for mod in others.values():
            mod.reset_kernel_calls()
        classes = self.K.CLASS_CALLS
        classes.update(dict.fromkeys(classes, 0))
        bcsr_classes = self.BK.CLASS_CALLS
        bcsr_classes.update(dict.fromkeys(bcsr_classes, 0))
        copies = self.PK.COPY_CALLS
        copies.update(dict.fromkeys(copies, 0))
        out = fn()
        self.torch.cuda.synchronize()
        self.class_counts = dict(classes)
        self.bcsr_class_counts = dict(bcsr_classes)
        self.pb_copy_counts = dict(copies)
        counts = self.ops.kernel_call_counts()
        for prefix, mod in others.items():
            counts.update({f"{prefix}_{k}": v for k, v in
                           mod.kernel_call_counts().items()})
        return out, counts

    def time_ms(self, fn, reps: int = REPS, warm: int = 2) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        times.sort()
        return times[len(times) // 2]

    def stream_ms(self, fn, launches: int = 20, reps: int = 3):
        """(ms a call on the card, ms a call on the host): one CUDA event
        pair around ``launches`` back-to-back calls of ``fn`` with no
        synchronise between them, divided by ``launches`` (the host issues
        the next call while the card runs the last, so this is the card's
        time a call wherever that exceeds the host's), and the host's time
        to issue one call; medians of ``reps``."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        dev, host = [], []
        for _ in range(reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            h0 = time.perf_counter()
            for _ in range(launches):
                fn()
            host.append((time.perf_counter() - h0) * 1e3 / launches)
            t1.record()
            t1.synchronize()
            dev.append(t0.elapsed_time(t1) / launches)
        return sorted(dev)[reps // 2], sorted(host)[reps // 2]

    def device_ms(self, fn, kernel: str):
        """Device time in ms of the CUDA kernels whose name holds
        ``kernel`` in one call of ``fn``, summed from a ``torch.profiler``
        trace; None when the trace holds no device time for them."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0)
                 for e in prof.key_averages() if kernel in e.key)
        return us / 1e3 if us else None

    def busy_ms(self, fn, kernel: str, reps: int = 3):
        """One call of ``fn``: (median host ms of ``reps`` calls ending in
        a synchronise, device busy ms -- the device events' summed time in
        a ``torch.profiler`` trace of one more call, None if the trace
        holds none --, the number of device events: kernels, copies and
        fills, and the ms of the kernels whose name holds ``kernel``)."""
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        host = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        host = sorted(host[1:])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        named = sum(e.time_range.elapsed_us() for e in kernels
                    if kernel in e.name) / 1e3
        return host[len(host) // 2], (busy or None), len(kernels), named

    def sorted_rows(self, cols, vals, indptr, shape):
        c = self.CSR(indptr, cols, vals,
                     self.torch.tensor(int(indptr[-1]), dtype=self.torch.int32,
                                       device=self.dev), shape, False)
        return c.sort_rows()

    def compare(self, what, cols, vals, indptr, shape, plain_cols,
                plain_vals, counts=None) -> float:
        """Kernel output (unsorted rows) against the plain version (sorted
        rows): columns bitwise; values bitwise when ``counts`` is None,
        else within ``counts`` ulp of the plain value.  Returns the
        largest absolute difference."""
        torch = self.torch
        s = self.sorted_rows(cols, vals, indptr, shape)
        nnz = int(indptr[-1])
        check(torch.equal(s.indices[:nnz], plain_cols[:nnz]),
              f"{what}: column sets differ from the plain version")
        check(bool((cols[nnz:] == 0).all()) and bool((vals[nnz:] == 0).all()),
              f"{what}: tail past nnz is not zero")
        kv, pv = s.data[:nnz].float(), plain_vals[:nnz]
        diff = (kv - pv).abs()
        err = float(diff.max()) if nnz else 0.0
        if counts is None:
            check(torch.equal(kv, pv), f"{what}: values not bitwise equal "
                  f"(max abs diff {err})")
        else:
            ulp = torch.nextafter(pv.abs(), torch.full_like(pv, float("inf"))) \
                - pv.abs()
            bad = diff > counts[:nnz].float() * ulp
            check(not bool(bad.any()), f"{what}: {int(bad.sum())} values "
                  f"past 1 ulp per product (max abs diff {err})")
        return err

    def expect(self, counts, want, what):
        """Launch counts of one path: ``want``'s kernels as many times as
        it says, every other counter (plain versions included) zero."""
        plain = counts["plain"] + counts["batched_plain"] \
            + counts["pb_plain"] + counts["bcsr_plain"] \
            + counts["bcsr_batched_plain"] + counts["pb_batched_plain"] \
            + counts["spmm_plain"] + counts["flash_plain"] \
            + counts["ssd_plain"]
        check(plain == 0, f"{what}: ran a plain version {plain} times")
        check(counts == {k: want.get(k, 0) for k in counts},
              f"{what}: launches {counts}, want {want}")

    def operands(self, a):
        return (a.indptr, a.indptr, a.indices, a.data.float(), a.indices,
                a.data.float())

    def kernel_times(self, calls: dict, plain_reps: int = REPS) -> dict:
        """For each ``name: (kernel call, plain call)``: the kernel's
        single-call ms, its ms a call over 20 back to back beside the
        host's ms to issue one (``name_b2b``, ``name_host``), and the plain
        version's ms (``plain_name``, median of ``plain_reps``)."""
        t = {}
        for name, (kernel, plain) in calls.items():
            t[name] = self.time_ms(kernel)
            t[f"{name}_b2b"], t[f"{name}_host"] = self.stream_ms(kernel)
            t[f"plain_{name}"] = self.time_ms(plain, reps=plain_reps,
                                              warm=1)
        return t

    def hash_numeric_pair(self, args, cap_c, table_size, vector, errors):
        """(kernel call, plain call) of the hash numeric kernel on
        ``args``; the kernel counts into the caller's ``errors``, so the
        wrapper's read-back of its own count is not in its time."""
        K, ref = self.K, self.ref
        kw = dict(cap_c=cap_c, table_size=table_size)
        return (lambda: K.numeric_call(*args, vector=vector, errors=errors,
                                       **kw),
                lambda: ref.numeric_plain(*args, vector=False, **kw))

    def pb_pair(self, p, a_vals, b_vals):
        """``({"scatter": (kernel, plain), "merge": (kernel, plain)}, pp)``
        of the PB pair on plan ``p``; both merges read ``pp``, the
        scatter's output on these values."""
        PK, pb_ref = self.PK, self.pb_ref
        scatter = (p.bucket_nnz, p.src_a, p.src_b, a_vals, b_vals)
        pp = PK.scatter_call(*scatter)
        merge = (p.bucket_nnz, p.seg, pp, p.cap_c)
        return {"scatter": (lambda: PK.scatter_call(*scatter),
                            lambda: pb_ref.scatter_plain(*scatter)),
                "merge": (lambda: PK.merge_call(*merge),
                          lambda: pb_ref.merge_plain(*merge))}, pp

    def pb_products_per_slot(self, p):
        """The partial products each output slot of PB plan ``p`` sums."""
        torch = self.torch
        live = torch.arange(p.bucket_cap, device=self.dev)[None, :] < \
            p.bucket_nnz[:, None]
        return torch.bincount(p.seg[live].long(), minlength=p.cap_c)

    # ---- phase 3 -----------------------------------------------------------
    def saturation(self):
        """Load factor 1.0 (forced table of d = CHUNK slots for d distinct
        columns) and one past fill (d = CHUNK + 1, natural sizing)."""
        torch, CSR, K, ref = self.torch, self.CSR, self.K, self.ref
        chunk = K.CHUNK
        for d, forced in ((chunk, True), (chunk + 1, False)):
            a = CSR.from_numpy_coo([0, 1, 1], [0, 0, 1],
                                   np.asarray([1.0, 1.0, 0.5], np.float32),
                                   (2, 2), device=self.dev)
            rows = np.concatenate([np.zeros(d, np.int64), np.ones(d, np.int64)])
            cols = np.concatenate([np.arange(d), np.arange(d)])
            vals = np.asarray(DYADIC, np.float32)[np.arange(2 * d) % 4]
            b = CSR.from_numpy_coo(rows, cols, vals, (2, d), device=self.dev)
            if forced:
                offsets = torch.tensor([0, 2], dtype=torch.int32,
                                       device=self.dev)
                bin_tsize = torch.tensor([d], dtype=torch.int32,
                                         device=self.dev)
                table_size = d
            else:
                offsets, bin_tsize, table_size = self.ops.hash_schedule(
                    a, b, n_bins=1)
                check(table_size == 2 * chunk, "one past fill must double "
                      f"the table, got {table_size}")
            ip_a, ip_b = a.indptr, b.indptr
            args = (ip_a, ip_b, a.indices, a.data, b.indices, b.data)
            row_p = ref.symbolic_plain(offsets, bin_tsize, *args,
                                       table_size=table_size, vector=False)
            indptr_c = self.core.formats.prefix_sum(row_p).to(torch.int32)
            pc, pv = ref.numeric_plain(offsets, bin_tsize, ip_a, ip_b,
                                       indptr_c, a.indices, a.data, b.indices,
                                       b.data, cap_c=2 * d,
                                       table_size=table_size, vector=False)
            for vector in (False, True):
                err = torch.zeros(1, dtype=torch.int32, device=self.dev)
                row_k = K.symbolic_call(offsets, bin_tsize, *args,
                                        table_size=table_size, vector=vector,
                                        errors=err, n_cols=b.n_cols)
                kc, kv = K.numeric_call(
                    offsets, bin_tsize, ip_a, ip_b, indptr_c, a.indices,
                    a.data, b.indices, b.data, cap_c=2 * d,
                    table_size=table_size, vector=vector, errors=err)
                torch.cuda.synchronize()
                what = f"saturation d={d} vector={vector}"
                check(torch.equal(row_k, row_p), f"{what}: symbolic counts")
                check(int(err) == 0, f"{what}: {int(err)} kernel errors")
                self.compare(what, kc, kv, indptr_c, (2, d), pc, pv)
        print("phase 3: saturation fixtures bitwise equal (load factor 1.0 "
              "and one past fill, scalar and vector)", flush=True)
        # the numeric kernel's launch shape per table class; a cluster of
        # 8 blocks must fit the card at 16,384-slot slices
        for vector in (False, True):
            shapes = {name: K.class_shape(c, vector)
                      for c, name in enumerate(K.CLASS_NAMES)}
            for name, sh in shapes.items():
                check(sh["resident_blocks"] >= sh["blocks"],
                      f"class {name}: no {sh['blocks']}-block launch is "
                      f"resident")
            print(json.dumps({"hash_class_shapes": "vector" if vector
                              else "scalar", "card": self.card,
                              "shapes": shapes}), flush=True)
        print(json.dumps({"hash_class_shapes": "symbolic bitmap, 65,536 "
                          "columns", "card": self.card,
                          "shape": K.class_shape(K.BITMAP_CLASS, False,
                                                 False, 1 << 16)}),
              flush=True)
        print("phase 3: cudaOccupancyMaxActiveClusters at 16,384-slot "
              "slices (1,024 threads): " + ", ".join(
                  f"{b} blocks {K.class_shape(c, False)['resident_clusters']}"
                  for c, b in enumerate(K.CLASS_BLOCKS) if b > 1),
              flush=True)

    # ---- phase 4 and 5 -----------------------------------------------------
    def one_input(self, preset: str, scale: int):
        torch, core, K, ref = self.torch, self.core, self.K, self.ref
        label = f"{preset} s{scale} ef{EDGE_FACTOR}"
        t0 = time.perf_counter()
        a = self.rmat.rmat_csr(scale, EDGE_FACTOR, preset, seed=0,
                               device=self.dev)
        nnz_a = int(a.nnz)
        a_d = self.dyadic_copy(a, 1)
        print(f"{label}: n={a.n_rows} nnz(A)={nnz_a} "
              f"(built in {time.perf_counter() - t0:.1f} s)", flush=True)

        # the main path: plan under the recipe, execute
        core.clear_plan_cache()
        t0 = time.perf_counter()
        plan = core.plan_spgemm(a, a, algorithm="auto", sorted_output=False)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        algo = plan.algorithm
        print(f"{label}: recipe chose {algo!r}; total flop {plan.total_flop}, "
              f"nnz(C) {plan.nnz_c}, table_size {plan.table_size}, "
              f"bin_tsize {plan.bin_tsize.tolist()}, offsets "
              f"{plan.offsets.tolist()} (planned in {plan_s:.2f} s)",
              flush=True)
        check(algo in ("hash", "hash_vector"),
              f"{label}: recipe chose {algo}, not the hash family")
        key = "numeric_vector" if algo == "hash_vector" else "numeric"
        # launches per kernel, per path (counters zeroed before each path)
        paths = {"numeric": {}, "numeric_vector": {}, "symbolic": {}}

        def expect(counts, want, path):
            self.expect(counts, want, f"{label} {path}")
            for k, v in want.items():
                paths[k][path] = v

        c, counts = self.counted(lambda: plan.execute(a, a))
        expect(counts, {key: 1}, "plan.execute")
        exec_classes = self.class_counts
        check(exec_classes["classify"] == 1 and exec_classes["plain"] == 0,
              f"{label}: plan.execute's class launches {exec_classes}")

        # the plain version on the same operands, and the per-entry
        # product counts for the ulp bound
        args = (plan.offsets, plan.bin_tsize, a.indptr, a.indptr,
                plan.indptr_c, a.indices, a.data, a.indices, a.data)
        kw = dict(cap_c=plan.cap_c, table_size=plan.table_size, vector=False)
        pc, pv = ref.numeric_plain(*args, **kw)
        counts_pp = ref.products_per_entry(a.indptr, a.indptr, plan.indptr_c,
                                           a.indices, a.indices, plan.cap_c)
        pc_d, pv_d = ref.numeric_plain(*args[:6], a_d.data, a.indices,
                                       a_d.data, **kw)
        check(torch.equal(c.indptr, plan.indptr_c), f"{label}: indptr")
        check(int(c.nnz) == plan.nnz_c, f"{label}: nnz")
        errs = {}
        errs[key] = self.compare(f"{label} {algo}", c.indices, c.data,
                                 c.indptr, c.shape, pc, pv, counts_pp)
        c_d, counts = self.counted(lambda: plan.execute(a_d, a_d))
        expect(counts, {key: 1}, "plan.execute dyadic")
        self.compare(f"{label} {algo} dyadic", c_d.indices, c_d.data,
                     c_d.indptr, c_d.shape, pc_d, pv_d)

        # the other probe mode, planned explicitly
        other = "hash" if algo == "hash_vector" else "hash_vector"
        okey = "numeric" if key == "numeric_vector" else "numeric_vector"
        plan_o = core.plan_spgemm(a, a, algorithm=other)
        for arr in ("offsets", "bin_tsize", "indptr_c"):
            check(torch.equal(getattr(plan_o, arr), getattr(plan, arr)),
                  f"{label}: {arr} differs between {algo} and {other} plans")
        c_o, counts = self.counted(lambda: plan_o.execute(a, a))
        expect(counts, {okey: 1}, f"plan({other}).execute")
        errs[okey] = self.compare(f"{label} {other}", c_o.indices, c_o.data,
                                  c_o.indptr, c_o.shape, pc, pv, counts_pp)
        c_o, counts = self.counted(lambda: plan_o.execute(a_d, a_d))
        expect(counts, {okey: 1}, f"plan({other}).execute dyadic")
        self.compare(f"{label} {other} dyadic", c_o.indices, c_o.data,
                     c_o.indptr, c_o.shape, pc_d, pv_d)

        # the planless front door: symbolic + numeric kernels
        c_p, counts = self.counted(lambda: core.spgemm(
            a, a, plan.cap_c, algorithm="hash"))
        expect(counts, {"symbolic": 1, "numeric": 1},
               "spgemm(algorithm=hash)")
        check(torch.equal(c_p.indptr, plan.indptr_c),
              f"{label}: planless indptr differs from the plan's")
        self.compare(f"{label} planless", c_p.indices, c_p.data, c_p.indptr,
                     c_p.shape, pc, pv, counts_pp)
        sym_err = torch.zeros(1, dtype=torch.int32, device=self.dev)
        ops_args = self.operands(a)
        sym_kw = dict(table_size=plan.table_size, errors=sym_err,
                      n_cols=a.n_cols)
        row_k = K.symbolic_call(plan.offsets, plan.bin_tsize, *ops_args,
                                vector=False, **sym_kw)
        check(torch.equal(row_k, plan.row_nnz_c),
              f"{label}: symbolic kernel row_nnz != ESC row_nnz_c")
        errs["symbolic"] = float((row_k - plan.row_nnz_c).abs().max())
        row_kv = K.symbolic_call(plan.offsets, plan.bin_tsize, *ops_args,
                                 vector=True, **sym_kw)
        check(torch.equal(row_kv, plan.row_nnz_c),
              f"{label}: vector symbolic kernel row_nnz != ESC row_nnz_c")
        check(int(sym_err) == 0, f"{label}: symbolic kernel errors")
        num_err = torch.zeros(1, dtype=torch.int32, device=self.dev)
        for vector in (False, True):
            K.numeric_call(*args, cap_c=plan.cap_c,
                           table_size=plan.table_size, vector=vector,
                           errors=num_err)
        torch.cuda.synchronize()
        check(int(num_err) == 0, f"{label}: {int(num_err)} rows whose flush "
              f"count disagrees with indptr_c, or full-table probes")

        # sorted on request: the finalize epilogue
        c_s, counts = self.counted(lambda: plan.execute(a, a,
                                                        sorted_output=True))
        expect(counts, {key: 1}, "plan.execute sorted")
        check(c_s.sorted_cols, f"{label}: sorted output not flagged sorted")
        check(torch.equal(c_s.indices, pc), f"{label}: sorted columns")
        self.compare(f"{label} sorted", c_s.indices, c_s.data, c_s.indptr,
                     c_s.shape, pc, pv, counts_pp)
        print(f"{label}: outputs match the plain versions; launches per "
              f"path {paths}", flush=True)
        classes = self.hash_classes(label, plan, a, exec_classes)
        sym_classes = self.hash_symbolic_classes(label, plan, a)

        # ---- timings (phase 5) ------------------------------------------
        m = a.n_rows
        nnz_c = plan.nnz_c
        flop = plan.total_flop
        bound_num, bound_num_by = bound_ms(
            hash_numeric_bytes(a, a, nnz_c), 2 * flop)
        bytes_sym = (4 * (m + 1) + 4 * nnz_a) + 4 * nnz_a + 4 * m
        bound_sym = bytes_sym / HBM_BW * 1e3
        pairs = {vector: self.hash_numeric_pair(args, plan.cap_c,
                                                plan.table_size, vector,
                                                num_err)
                 for vector in (False, True)}
        t = {name: self.time_ms(pairs[vector][0]) for vector, name in
             ((False, "numeric"), (True, "numeric_vector"))}
        # (phase 21 calls it again, after the plan is gone)
        sym_call = (plan.offsets, plan.bin_tsize, *ops_args)

        def symbolic(vector=False):
            return K.symbolic_call(*sym_call, vector=vector, **sym_kw)

        t["symbolic"] = self.time_ms(symbolic)
        t["symbolic_vector"] = self.time_ms(lambda: symbolic(True))
        # the card's time a call (20 back to back; the wrapper reads the
        # bins back each call, so the host's time to issue one is beside)
        b2b, host = {}, {}
        for name, fn in (("symbolic", symbolic),
                         ("symbolic_vector", lambda: symbolic(True))):
            b2b[name], host[name] = self.stream_ms(fn)
        # the planless front door (symbolic, then numeric, kernels) beside
        # one torch.sparse.mm of the same product
        t["planless"] = self.time_ms(lambda: core.spgemm(
            a, a, plan.cap_c, algorithm="hash"))
        # the op on the main path: each probe mode's numeric kernel
        # through the wrapper that reads its own errors back, and through
        # the custom op the execute calls (the op's own cost: the
        # difference), and each mode's execute
        for vector, name in ((False, "numeric"), (True, "numeric_vector")):
            t[f"{name}_readback"] = self.time_ms(lambda: K.numeric_call(
                *args, cap_c=plan.cap_c, table_size=plan.table_size,
                vector=vector))
            t[f"{name}_op"] = self.time_ms(lambda: self.ops.numeric_op(
                *args[:6], a.data.float(), args[7], a.data.float(),
                plan.cap_c, plan.table_size, vector))
        t[f"execute_{other}"] = self.time_ms(lambda: plan_o.execute(a, a))
        t["plain_numeric"] = self.time_ms(pairs[False][1])
        t["plain_symbolic"] = self.time_ms(lambda: ref.symbolic_plain(
            plan.offsets, plan.bin_tsize, *ops_args,
            table_size=plan.table_size, vector=False))
        t["execute"] = self.time_ms(lambda: plan.execute(a, a))
        sp = torch.sparse_csr_tensor(a.indptr.long(),
                                     a.indices[:nnz_a].long(),
                                     a.data[:nnz_a], size=a.shape)
        t["torch_sparse_mm"] = self.time_ms(lambda: torch.sparse.mm(sp, sp))
        t["plain_classify"] = self.time_ms(lambda: ref.row_classes_plain(
            plan.offsets, plan.bin_tsize, plan.indptr_c,
            table_size=plan.table_size))
        print(json.dumps({"timing": label, "card": self.card,
                          "n": m, "nnz_a": nnz_a, "flop": flop,
                          "nnz_c": nnz_c, "algorithm": algo,
                          "ms": t, "back_to_back_ms": b2b,
                          "host_ms_to_issue": host,
                          "bound_ms": {"numeric": bound_num,
                                       "symbolic": bound_sym},
                          "classes": classes["per_class"],
                          "symbolic_classes": sym_classes,
                          "plan_s": plan_s}), flush=True)
        print(f"{label}: planless spgemm(algorithm=hash) {t['planless']:.4f}"
              f" ms (symbolic kernel {t['symbolic']:.4f}, back to back "
              f"{b2b['symbolic']:.4f}; numeric kernel {t['numeric']:.4f}) "
              f"against torch.sparse.mm {t['torch_sparse_mm']:.4f} ms",
              flush=True)
        # `launches`: the count on the first path that runs the kernel --
        # plan.execute for the recipe's probe mode, the explicit plan's
        # execute for the other, the planless spgemm for symbolic
        for name in ("numeric", "numeric_vector", "symbolic"):
            num = name != "symbolic"
            self.rows.append({
                "name": f"spgemm_hash_{name}[{label}]", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": REPLACES[name],
                "launches": next(iter(paths[name].values())),
                "launches_by_path": paths[name],
                "max_abs_err": errs[name],
                "ms": t[name],
                "plain_ms": t["plain_numeric" if num else "plain_symbolic"],
                "bound_ms": bound_num if num else bound_sym,
                "bound_by": bound_num_by if num else "bytes",
                "library_ms": t["torch_sparse_mm"] if num else None,
                **({} if num else {"back_to_back_ms": b2b["symbolic"]})})
        # the classifying kernel (replaces no TPU kernel): its device time
        # from phase 21 (CUDA events behind a sleeping kernel), the bytes it
        # must move (indptr_c read, each row's table size and each listed
        # row id written)
        n_listed = sum(v["rows"] for v in classes["per_class"].values())
        classify_row = {
            "name": f"spgemm_hash_classify[{label}]", "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": "none: lists the rows of "
                        + REPLACES["numeric"] + "'s port by table class",
            "launches": exec_classes["classify"],
            "max_abs_err": classes["max_abs_err"],
            "ms": None,
            "plain_ms": t["plain_classify"],
            "bound_ms": (4 * (m + 1) + 4 * m + 4 * n_listed)
            / HBM_BW * 1e3,
            "bound_by": "bytes", "library_ms": None}
        self.rows.append(classify_row)
        self.class_profiles.append((label, args, plan.cap_c,
                                    plan.table_size, num_err, a.n_cols,
                                    classify_row))
        self.library_ms[label] = t["torch_sparse_mm"]
        del plan, plan_o, c, c_d, c_o, c_p, c_s, pc, pv, pc_d, pv_d
        core.clear_plan_cache()
        torch.cuda.empty_cache()
        return a, a_d, label

    def hash_classes(self, label, plan, a, exec_classes) -> dict:
        """Phase 4's table classes of the numeric rows: the classifying
        kernel against its plain version (counts, each class's rows as a
        set, each row's table), then rows, flop, nnz(C) and table slots
        per class, and the classes the execute launched.  G500 s16 must
        put rows on clusters of 2, 4 and 8 blocks and none on a
        device-memory table; ER s18 none on a cluster."""
        torch, K, ref = self.torch, self.K, self.ref
        err = torch.zeros(1, dtype=torch.int32, device=self.dev)
        counts, rows, row_tsz = K.row_classes(
            plan.offsets, plan.bin_tsize, a.indptr, a.indptr, plan.indptr_c,
            a.indices, table_size=plan.table_size, errors=err)
        p_counts, p_rows, p_tsz = ref.row_classes_plain(
            plan.offsets, plan.bin_tsize, plan.indptr_c,
            table_size=plan.table_size)
        torch.cuda.synchronize()
        check(int(err) == 0, f"{label}: classify errors {int(err)}")
        check(torch.equal(counts, p_counts), f"{label}: class counts "
              f"{counts.tolist()} != plain {p_counts.tolist()}")
        check(torch.equal(row_tsz, p_tsz), f"{label}: row tables differ "
              f"from the plain version's")
        for c, (got, want) in enumerate(zip(rows, p_rows)):
            check(torch.equal(torch.sort(got).values, want),
                  f"{label}: class {K.CLASS_NAMES[c]} rows differ")
        per = {}
        for c, r in enumerate(p_rows):
            rl = r.long()
            per[K.CLASS_NAMES[c]] = {
                "rows": int(r.shape[0]),
                "flop": int(plan.flop[rl].long().sum()),
                "nnz_c": int(plan.row_nnz_c[rl].long().sum()),
                "table_slots": int(p_tsz[rl].long().sum()),
                "launched": exec_classes[K.CLASS_NAMES[c]]}
        empty = int((plan.row_nnz_c == 0).sum())
        clusters = [per[n]["rows"] for n in ("cluster_2", "cluster_4",
                                            "cluster_8")]
        if label.startswith("G500"):
            check(all(clusters) and per["global"]["rows"] == 0,
                  f"{label}: want rows on clusters of 2, 4 and 8 and none "
                  f"in device memory, got {per}")
        if label.startswith("ER"):
            check(not any(clusters) and per["global"]["rows"] == 0,
                  f"{label}: a row on a cluster or in device memory: {per}")
        for name, v in per.items():
            if v["rows"]:
                check(v["launched"] == 1, f"{label}: class {name} holds "
                      f"rows but launched {v['launched']} times")
        print(f"{label}: numeric row classes (rows, flop, nnz(C), table "
              f"slots; {empty} rows empty, in none): " + "; ".join(
                  f"{n} {v['rows']}, {v['flop']}, {v['nnz_c']}, "
                  f"{v['table_slots']}" for n, v in per.items()),
              flush=True)
        return {"per_class": per, "max_abs_err": 0.0}

    def hash_symbolic_classes(self, label, plan, a) -> dict:
        """Phase 4's table classes of the symbolic rows, the single
        product as the fleet of one member with B's width: the classifying
        kernel against its plain version (counts, each class's rows as a
        set, each row's table), rows, flop and table slots per class, and
        one ``symbolic_call`` launching one count, one classification and
        one launch per class the plan's largest table allows, among them
        every class that holds rows.  G500 s16 must put no symbolic row in
        device memory nor on a cluster, and its rows past one block's
        table on the bitmap class."""
        torch, K, ref = self.torch, self.K, self.ref
        err = torch.zeros(1, dtype=torch.int32, device=self.dev)
        cls_args = (plan.offsets, plan.bin_tsize, a.indptr, a.indptr, None,
                    a.indices)
        kw = dict(n_members=1, table_size=plan.table_size, numeric=False,
                  n_cols=a.n_cols)
        counts, pairs, row_tsz = K.batched_row_classes(*cls_args, **kw,
                                                       errors=err)
        p_counts, p_pairs, p_tsz = ref.batched_row_classes_plain(*cls_args,
                                                                 **kw)
        torch.cuda.synchronize()
        check(int(err) == 0, f"{label}: symbolic classify errors {int(err)}")
        check(torch.equal(counts, p_counts) and torch.equal(row_tsz, p_tsz),
              f"{label}: symbolic classes {counts.tolist()} or tables differ "
              f"from the plain version's {p_counts.tolist()}")
        for c, (got, want) in enumerate(zip(pairs, p_pairs)):
            check(torch.equal(torch.sort(got[:, 1]).values, want[:, 1]),
                  f"{label}: symbolic class {K.SYMBOLIC_CLASS_NAMES[c]} rows "
                  f"differ")
        largest = K.fleet_table([plan.offsets.tolist()],
                                [plan.bin_tsize.tolist()], plan.table_size,
                                a.n_rows, False)
        launched = K.launch_classes(largest, ref.bitmap_above(a.n_cols))
        _, calls = self.counted(lambda: K.symbolic_call(
            plan.offsets, plan.bin_tsize, *self.operands(a),
            table_size=plan.table_size, vector=False, n_cols=a.n_cols))
        self.expect(calls, {"symbolic": 1}, f"{label} symbolic_call")
        want_calls = dict(dict.fromkeys(K.CLASS_CALLS, 0), classify=1,
                          **{K.SYMBOLIC_CLASS_NAMES[c]: 1 for c in launched})
        check(self.class_counts == want_calls, f"{label} symbolic_call: "
              f"class launches {self.class_counts}, want {want_calls}")
        per = {}
        for c, want in enumerate(p_pairs):
            r = want[:, 1]
            name = K.SYMBOLIC_CLASS_NAMES[c]
            per[name] = {"rows": int(r.shape[0]),
                         "flop": int(plan.flop[r].long().sum()),
                         "table_slots": int(p_tsz[0, r].long().sum()),
                         "launched": self.class_counts[name]}
            check(not per[name]["rows"] or c in launched,
                  f"{label}: symbolic class {name} holds rows but is not "
                  f"launched")
        if label.startswith("G500"):
            check(per["bitmap"]["rows"] > 0 and not any(
                per[n]["rows"] for n in K.CLASS_NAMES[3:]),
                f"{label}: want the symbolic rows past one block's table on "
                f"the bitmap class, none on a cluster or in device memory, "
                f"got {per}")
        print(f"{label}: symbolic row classes (rows, flop, table slots; "
              f"launches {[K.SYMBOLIC_CLASS_NAMES[c] for c in launched]}): "
              + "; ".join(f"{n} {v['rows']}, {v['flop']}, "
                          f"{v['table_slots']}" for n, v in per.items()),
              flush=True)
        return per

    # ---- phase 21 ----------------------------------------------------------
    def hash_class_times(self):
        """The hash kernels' device time per table class and the
        classifying launch's, both phases, each probe mode, on each
        phase-4 input (:meth:`class_event_ms`), through the one-member
        fleet call with the largest table given: the single product's own
        launches, without its read-back of the bins, so that nothing in
        the call waits for the card.  The numeric classification's time
        goes into its row of the kernels line."""
        K = self.K
        for label, args, cap_c, table_size, err, n_cols, row in \
                self.class_profiles:
            m = args[2].shape[0] - 1
            host = ([args[0].tolist()], [args[1].tolist()])
            class_ms = {}
            for vector, sfx in ((False, ""), (True, "_vector")):
                kw = dict(n_members=1, table_size=table_size, vector=vector,
                          errors=err, largest=K.fleet_table(
                              *host, table_size, m, vector))
                class_ms["numeric" + sfx] = self.class_event_ms(
                    lambda: K.batched_numeric_call(*args, cap_c=cap_c,
                                                   **kw))
                class_ms["symbolic" + sfx] = self.class_event_ms(
                    lambda: K.batched_symbolic_call(*args[:4], *args[5:],
                                                    **kw, n_cols=n_cols),
                    numeric=False)
            self.torch.cuda.synchronize()
            check(int(err) == 0, f"{label}: kernel errors while timing")
            row["ms"] = class_ms["numeric"]["classify"]
            print(json.dumps({"hash_class_device_ms": label,
                              "card": self.card, **class_ms}), flush=True)
        self.class_profiles = []

    def class_event_ms(self, fn, numeric: bool = True) -> dict:
        """Device ms of one call of ``fn`` (after one call to warm up) per
        launch of the numeric path (``numeric=False``: the symbolic path):
        ``classify`` (memset, classify and place) and each table class by
        its :data:`SYMBOLIC_CLASS_NAMES` name (0 where the class was not
        launched; the bitmap class symbolic only), from CUDA events around
        each launch (``K.CLASS_EVENTS``).  ``fn`` must not synchronise: it
        is issued behind a kernel that sleeps 50 M clocks (about 25 ms),
        and the check that the host issued the whole call before the sleep
        ended makes every event pair the card's work alone (without the
        sleep, an event pair holds the host's issue of its launch too)."""
        torch, K = self.torch, self.K
        names = K.CLASS_NAMES if numeric else K.SYMBOLIC_CLASS_NAMES
        fn()
        torch.cuda.synchronize()
        s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        K.CLASS_EVENTS = []
        try:
            s0.record()
            torch.cuda._sleep(50_000_000)
            s1.record()
            h0 = time.perf_counter()
            fn()
            host_ms = (time.perf_counter() - h0) * 1e3
            torch.cuda.synchronize()
            out = dict.fromkeys(("classify",) + names, 0.0)
            for _, name, t0, t1 in K.CLASS_EVENTS:
                out[name] += t0.elapsed_time(t1)
        finally:
            K.CLASS_EVENTS = None
        sleep_ms = s0.elapsed_time(s1)
        check(host_ms < sleep_ms, f"the host took {host_ms:.3f} ms to issue "
              f"the call, past the {sleep_ms:.3f} ms sleep before it")
        check(out["classify"] > 0, "no classifying launch was timed")
        return out

    # ---- phase 6 -----------------------------------------------------------
    def sorted_pb(self, a, a_d, label):
        """Sorted output under the recipe: propagation blocking."""
        torch, core, PK, pb_ref = self.torch, self.core, self.PK, self.pb_ref
        core.clear_plan_cache()
        self.pb_ops.reset_kernel_calls()
        t0 = time.perf_counter()
        plan = core.plan_spgemm(a, a, algorithm="auto", sorted_output=True)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        check(plan.algorithm == "pb",
              f"{label} sorted: recipe chose {plan.algorithm}, not pb")
        check(self.pb_ops.kernel_call_counts()["inspect"] == 1,
              f"{label} sorted: planning ran no PB inspection")
        p = plan.pb_plan
        flop, nnz_c, nb, cap = p.total_flop, p.nnz_c, p.n_buckets, \
            p.bucket_cap
        print(f"{label} sorted: recipe chose 'pb'; n_buckets {nb}, bucket_w "
              f"{p.bucket_w}, bucket_cap {cap}, total flop {flop}, nnz(C) "
              f"{nnz_c} (planned in {plan_s:.2f} s)", flush=True)

        c, launches = self.counted(lambda: plan.execute(a, a))
        self.expect(launches, {"pb_scatter": 1, "pb_merge": 1},
                    f"{label} sorted plan.execute")
        c_d, counts = self.counted(lambda: plan.execute(a_d, a_d))
        self.expect(counts, {"pb_scatter": 1, "pb_merge": 1},
                    f"{label} sorted plan.execute dyadic")
        again, counts = self.counted(lambda: (
            core.plan_spgemm(a, a, algorithm="auto", sorted_output=True),
            core.plan_pb(a, a)))
        self.expect(counts, {}, f"{label} sorted repeat plan")
        check(again[0] is plan and again[1] is p,
              f"{label} sorted: a repeat plan missed the cache")

        # the output: row-sorted, structure of the sorted hash route
        nnz = int(c.nnz)
        check(c.sorted_cols and nnz == nnz_c, f"{label} sorted: nnz/flag")
        keys = c.row_ids()[:nnz].long() * a.n_cols + c.indices[:nnz].long()
        check(bool((keys[1:] > keys[:-1]).all()),
              f"{label} sorted: rows are not sorted")
        plan_h = core.plan_spgemm(a, a, algorithm="hash")
        c_h = plan_h.execute(a, a, sorted_output=True)
        check(torch.equal(c.indptr, c_h.indptr) and
              torch.equal(c.indices, c_h.indices),
              f"{label} sorted: structure differs from the hash route's")

        # each kernel against its plain version on the main path's shapes
        counts_pp = self.pb_products_per_slot(p)
        errs = {}
        for vals, what in ((a_d.data, "dyadic"), (a.data, "rmat")):
            pp = PK.scatter_call(p.bucket_nnz, p.src_a, p.src_b, vals, vals)
            pp_plain = pb_ref.scatter_plain(p.bucket_nnz, p.src_a, p.src_b,
                                            vals, vals)
            check(torch.equal(pp, pp_plain),
                  f"{label} scatter ({what}): not bitwise equal")
            out = PK.merge_call(p.bucket_nnz, p.seg, pp, p.cap_c)
            out_plain = pb_ref.merge_plain(p.bucket_nnz, p.seg, pp, p.cap_c)
            diff = (out - out_plain).abs()
            if what == "dyadic":
                check(torch.equal(out, out_plain),
                      f"{label} merge (dyadic): not bitwise equal")
                check(torch.equal(c_d.data, out_plain),
                      f"{label} plan.execute (dyadic): values differ from "
                      f"the plain versions")
                continue
            ulp = torch.nextafter(out_plain.abs(), torch.full_like(
                out_plain, float("inf"))) - out_plain.abs()
            bad = diff > counts_pp.float() * ulp
            check(not bool(bad.any()), f"{label} merge: {int(bad.sum())} "
                  f"values past 1 ulp per product")
            check(bool(((c.data - out_plain).abs()
                        <= counts_pp.float() * ulp).all()),
                  f"{label} plan.execute: values past 1 ulp per product")
            errs["scatter"] = float((pp - pp_plain).abs().max())
            errs["merge"] = float(diff.max())
        print(f"{label} sorted: outputs match the plain versions and the "
              f"hash route's structure; max abs diff merge "
              f"{errs['merge']}, scatter {errs['scatter']}", flush=True)

        # ---- timings ------------------------------------------------------
        nnz_a = int(a.nnz)
        by = pb_bytes(p, nnz_a, nnz_a)
        bounds = {k: bound_ms(v, flop) for k, v in by.items()}
        bound = {k: v[0] for k, v in bounds.items()}
        # each kernel single and back to back (the card's time a call,
        # beside the host's to issue one), and its plain version
        calls, pp = self.pb_pair(p, a.data, a.data)
        t = self.kernel_times(calls)
        t.update({
            # the same launches through the custom ops (their own cost)
            "scatter_op": self.time_ms(lambda: self.pb_ops.scatter_op(
                p.bucket_nnz, p.src_a, p.src_b, a.data, a.data)),
            "merge_op": self.time_ms(lambda: self.pb_ops.merge_op(
                p.bucket_nnz, p.seg, pp, p.cap_c)),
            "execute_pb": self.time_ms(lambda: plan.execute(a, a)),
            "execute_hash_sorted": self.time_ms(
                lambda: plan_h.execute(a, a, sorted_output=True)),
            "torch_sparse_mm": self.library_ms[label]})
        print(json.dumps({"timing": f"{label} sorted", "card": self.card,
                          "n": a.n_rows, "nnz_a": nnz_a, "flop": flop,
                          "nnz_c": nnz_c, "algorithm": "pb",
                          "n_buckets": nb, "bucket_cap": cap, "ms": t,
                          "bound_ms": bound, "bytes": by,
                          "plan_s": plan_s}), flush=True)
        for name in ("scatter", "merge"):
            self.rows.append({
                "name": f"spgemm_pb_{name}[{label}]", "route": "cuda",
                "source": PB_SOURCE, "replaces": REPLACES[name],
                "launches": launches[f"pb_{name}"],
                "max_abs_err": errs[name], "ms": t[name],
                "plain_ms": t[f"plain_{name}"], "bound_ms": bound[name],
                "bound_by": bounds[name][1],
                "library_ms": t["torch_sparse_mm"]})
        del plan, plan_h, p, c, c_d, c_h, pp, out, again, calls
        core.clear_plan_cache()
        torch.cuda.empty_cache()


    # ---- phase 14 ----------------------------------------------------------
    def csr_fleet(self, a, n, seed, dyadic):
        """``n`` members of new values on ``a``'s pattern, ``(n, cap)``
        float32, zero past nnz, from a seeded numpy generator: dyadic, or
        uniform in [0.5, 1.5)."""
        torch = self.torch
        rng = np.random.default_rng(seed)
        shape = (n, a.cap)
        vals = (np.asarray(DYADIC, np.float32)[rng.integers(0, 4, shape)]
                if dyadic else rng.uniform(0.5, 1.5, shape).astype(np.float32))
        live = torch.arange(a.cap, device=self.dev) < a.nnz
        return torch.from_numpy(vals).to(self.dev) * live

    def pb_fleet_case(self, label, a, execute, p, cases):
        """One value-fleet case of phase 14: ``torch.func.vmap`` of
        ``execute`` (a plan's, on ``p``'s structure; the product is A·A)
        over the members' values (``cases``: ``(values, xa, xb)``, a
        ``(n, cap)`` stack or a shared vector), launching the batched
        scatter and merge once each and nothing else; C's structure, the
        batched kernels against the batched plain versions, each member
        against the single-product execute; then the timings of the uniform
        fleet (``loop_scatter``/``loop_merge``: the single-product kernels
        launched once per member)."""
        import dataclasses
        torch, PK, pb_ref = self.torch, self.PK, self.pb_ref

        def one(x, y):
            c = execute(dataclasses.replace(a, data=x),
                        dataclasses.replace(a, data=y))
            return c.indptr, c.indices, c.data

        def vmapped(xa, xb):
            dims = (0 if xa.dim() == 2 else None, 0 if xb.dim() == 2 else None)
            return torch.func.vmap(one, in_dims=dims)(xa, xb)

        def member(x, e):
            return x[e] if x.dim() == 2 else x

        n = max(x.shape[0] for _, xa, xb in cases for x in (xa, xb)
                if x.dim() == 2)
        arrays = (p.bucket_nnz, p.src_a, p.src_b)
        live = torch.arange(p.bucket_cap, device=self.dev)[None, :] < \
            p.bucket_nnz[:, None]
        counts_pp = torch.bincount(p.seg[live].long(),
                                   minlength=p.cap_c).float()
        del live
        err = {"batched_scatter": 0.0, "batched_merge": 0.0}
        launches = {}
        for values, xa, xb in cases:
            what = f"{label} ({values})"
            (ip, cols, data), counts = self.counted(lambda: vmapped(xa, xb))
            self.expect(counts, {"pb_batched_scatter": 1,
                                 "pb_batched_merge": 1},
                        f"{what} vmap(execute)")
            stacked = (xa.dim() == 2) + (xb.dim() == 2)
            check(self.pb_copy_counts["slot_major"] == stacked,
                  f"{what} vmap(execute): {self.pb_copy_counts} slot-major "
                  f"copies, want one per batched operand ({stacked})")
            launches = {k: counts[f"pb_{k}"] for k in err}
            launches["slot_major"] = stacked
            check(data.shape == (n, p.cap_c),
                  f"{what}: output shape {tuple(data.shape)}")
            check(torch.equal(ip, p.indptr_c.expand_as(ip)) and
                  torch.equal(cols, p.cols_c.expand_as(cols)),
                  f"{what}: structure differs from the plan's")
            del ip, cols
            pp = PK.batched_scatter_call(*arrays, xa, xb, n_members=n)
            pp_plain = pb_ref.batched_scatter_plain(*arrays, xa, xb, n)
            check(torch.equal(pp, pp_plain),
                  f"{what}: batched scatter not bitwise equal to its plain "
                  f"version")
            err["batched_scatter"] = max(err["batched_scatter"], float(
                (pp - pp_plain).abs().max()))
            del pp_plain
            out = PK.batched_merge_call(p.bucket_nnz, p.seg, pp, p.cap_c,
                                        n_members=n)
            out_plain = pb_ref.batched_merge_plain(p.bucket_nnz, p.seg, pp,
                                                   p.cap_c, n)
            del pp
            # the layout kernel.batched_merge_call states: slot-major
            check(out.shape == (n, p.cap_c) and
                  out.stride() == (1, PK.merge_width(n, True)),
                  f"{what}: batched merge returned strides {out.stride()}, "
                  f"not slot-major")
            out = out.contiguous()
            diff = (out - out_plain).abs()
            if values == "dyadic":
                check(torch.equal(out, out_plain), f"{what}: batched merge "
                      f"not bitwise equal to its plain version")
            else:
                ulp = torch.nextafter(out_plain.abs(), torch.full_like(
                    out_plain, float("inf"))) - out_plain.abs()
                bad = diff > counts_pp * ulp
                check(not bool(bad.any()), f"{what}: batched merge "
                      f"{int(bad.sum())} values past 1 ulp per product")
                err["batched_merge"] = max(err["batched_merge"],
                                           float(diff.max()))
            check(torch.equal(data, out), f"{what}: the vmapped execute "
                  f"differs from the batched kernels")
            del out, out_plain, diff
            for e in range(n):
                single = execute(
                    dataclasses.replace(a, data=member(xa, e)),
                    dataclasses.replace(a, data=member(xb, e)))
                check(torch.equal(single.data, data[e]), f"{what} member "
                      f"{e}: not bitwise equal to the single-product "
                      f"execute")
            del data, single
        print(f"{label}: {n} members, {len(cases)} fleets; one batched "
              f"scatter and merge a call; every member equals the "
              f"single-product execute, the kernels their plain versions; "
              f"max abs diff merge {err['batched_merge']}", flush=True)

        # ---- timings (the uniform fleet) ---------------------------------
        _, xa, xb = next(c for c in cases if c[0] == "uniform")
        pp = PK.batched_scatter_call(*arrays, xa, xb, n_members=n)
        m_a = [dataclasses.replace(a, data=member(xa, e)) for e in range(n)]
        m_b = [dataclasses.replace(a, data=member(xb, e)) for e in range(n)]
        nnz = int(a.nnz)
        ip, ix = a.indptr.long(), a.indices[:nnz].long()
        sp_a = [torch.sparse_csr_tensor(ip, ix, x.data[:nnz], size=a.shape)
                for x in m_a]
        sp_b = [torch.sparse_csr_tensor(ip, ix, y.data[:nnz], size=a.shape)
                for y in m_b]
        t = {"vmap_execute": self.time_ms(lambda: vmapped(xa, xb)),
             "batched_scatter": self.time_ms(lambda: PK.batched_scatter_call(
                 *arrays, xa, xb, n_members=n)),
             "batched_merge": self.time_ms(lambda: PK.batched_merge_call(
                 p.bucket_nnz, p.seg, pp, p.cap_c, n_members=n)),
             "loop": self.time_ms(lambda: [execute(x, y) for x, y in
                                           zip(m_a, m_b)]),
             "loop_scatter": self.time_ms(lambda: [PK.scatter_call(
                 *arrays, member(xa, e), member(xb, e)) for e in range(n)]),
             "loop_merge": self.time_ms(lambda: [PK.merge_call(
                 p.bucket_nnz, p.seg, pp[e], p.cap_c) for e in range(n)]),
             "plain_scatter": self.time_ms(
                 lambda: pb_ref.batched_scatter_plain(*arrays, xa, xb, n),
                 reps=3, warm=1),
             "plain_merge": self.time_ms(
                 lambda: pb_ref.batched_merge_plain(p.bucket_nnz, p.seg, pp,
                                                    p.cap_c, n),
                 reps=3, warm=1),
             "torch_sparse_mm_loop": self.time_ms(
                 lambda: [torch.sparse.mm(x, y) for x, y in
                          zip(sp_a, sp_b)])}
        # back to back; and the slot-major copy of each stacked operand
        # (inside the batched scatter's time), apart
        copy_err = 0.0
        t["batched_scatter_b2b"], t["batched_scatter_host"] = \
            self.stream_ms(lambda: PK.batched_scatter_call(
                *arrays, xa, xb, n_members=n))
        t["batched_merge_b2b"], t["batched_merge_host"] = self.stream_ms(
            lambda: PK.batched_merge_call(p.bucket_nnz, p.seg, pp, p.cap_c,
                                          n_members=n))
        for side, x in (("a", xa), ("b", xb)):
            if x.dim() == 2:
                got, want = PK.slot_major(x), pb_ref.slot_major_plain(x)
                check(torch.equal(got, want), f"{label}: slot-major copy of "
                      f"{side} differs from its plain version")
                copy_err = max(copy_err, float((got - want).abs().max()))
                del got, want
                t[f"slot_major_{side}"] = self.time_ms(
                    lambda x=x: PK.slot_major(x))
                t[f"slot_major_{side}_b2b"] = self.stream_ms(
                    lambda x=x: PK.slot_major(x))[0]
                t[f"plain_slot_major_{side}"] = self.time_ms(
                    lambda x=x: pb_ref.slot_major_plain(x))
                t[f"library_slot_major_{side}"] = self.time_ms(
                    lambda x=x: x.t().contiguous())
        # least time: the shared index arrays once (8 B per product for
        # the scatter, seg's 4 B for the merge), each member's A and B
        # values (once when shared), pp written by the scatter and its live
        # lanes read by the merge per member, C's values written per member
        flop, nb, cap = p.total_flop, p.n_buckets, p.bucket_cap
        n_a = n if xa.dim() == 2 else 1
        n_b = n if xb.dim() == 2 else 1
        by = {"batched_scatter": 8 * flop + 4 * nb + 4 * nnz * (n_a + n_b)
              + 4 * n * nb * cap,
              "batched_merge": 4 * flop + 4 * nb + 4 * n * flop
              + 4 * n * p.nnz_c}
        ops_n = n * flop
        bound = {k: max(v / HBM_BW, ops_n / FP32_FLOPS) * 1e3
                 for k, v in by.items()}
        print(json.dumps({"timing": f"PB value fleet {label}",
                          "card": self.card, "members": n,
                          "batched": {"a": n_a > 1, "b": n_b > 1},
                          "nnz_a": nnz, "flop": flop, "nnz_c": p.nnz_c,
                          "n_buckets": nb, "bucket_cap": cap,
                          "launches": launches, "ms": t, "bound_ms": bound,
                          "bound_pair_ms": sum(bound.values()),
                          "bound_bytes": by, "bound_operations": ops_n,
                          "shared_index_arrays": "counted once"}),
              flush=True)
        for k in err:
            self.rows.append({
                "name": f"spgemm_pb_{k}[{label}]", "route": "cuda",
                "source": PB_SOURCE, "replaces": REPLACES[k],
                "launches": launches[k], "max_abs_err": err[k], "ms": t[k],
                "plain_ms": t[f"plain_{k.split('_')[1]}"],
                "bound_ms": bound[k],
                "bound_by": "bytes" if by[k] / HBM_BW >=
                ops_n / FP32_FLOPS else "operations",
                "library_ms": t["torch_sparse_mm_loop"]})
        # the slot-major copy of A's values (read and written once)
        copy_by = 2 * 4 * n * a.cap
        self.rows.append({
            "name": f"spgemm_pb_slot_major[{label}]", "route": "cuda",
            "source": PB_SOURCE, "replaces": "none: lays out the batched "
            "operands of " + REPLACES["batched_scatter"] + "'s port "
            "slot-major", "launches": launches["slot_major"],
            "max_abs_err": copy_err, "ms": t["slot_major_a"],
            "plain_ms": t["plain_slot_major_a"],
            "bound_ms": copy_by / HBM_BW * 1e3, "bound_by": "bytes",
            "library_ms": t["library_slot_major_a"]})
        del pp, sp_a, sp_b, m_a, m_b
        torch.cuda.empty_cache()

    def pb_value_fleet(self, a, a_d, label):
        """Phase 14: ``torch.func.vmap`` of the sorted ER plan's execute
        over fleets of values on A's pattern (one structure, new values:
        re-assembly in a solver), the shared operand dyadic."""
        torch, core = self.torch, self.core
        core.clear_plan_cache()
        plan, counts = self.counted(lambda: core.plan_spgemm(
            a, a, algorithm="auto", sorted_output=True))
        check(plan.algorithm == "pb",
              f"{label} fleet: recipe chose {plan.algorithm}, not pb")
        check(counts["pb_inspect"] == 1,
              f"{label} fleet: planning ran no PB inspection")
        p = plan.pb_plan

        def fleets(n, seed, b_too=False):
            """A dyadic and a uniform fleet of ``n`` members on A's
            pattern, as ``(values, A's values, B's values)``: B's are
            ``a_d``'s (shared) unless ``b_too``."""
            out = []
            for i, values in enumerate(("dyadic", "uniform")):
                d = values == "dyadic"
                xb = self.csr_fleet(a, n, seed + 10 + i, d) if b_too \
                    else a_d.data
                out.append((values, self.csr_fleet(a, n, seed + i, d), xb))
            return out

        n, m = PB_FLEET_MEMBERS, PB_FLEET_MEMBERS_BOTH
        self.pb_fleet_case(f"{label}, {n} members, A batched", a, p.execute,
                           p, fleets(n, 80))
        self.pb_fleet_case(f"{label}, {m} members, A and B batched", a,
                           p.execute, p, fleets(m, 90, b_too=True))
        self.pb_fleet_case(f"{label}, plan_spgemm(sorted_output=True), {n} "
                           f"members, A batched", a, plan.execute, p,
                           fleets(n, 100))
        del plan, p
        core.clear_plan_cache()
        torch.cuda.empty_cache()


    # ---- phase 16 ----------------------------------------------------------
    def hash_fleet_case(self, label, a, plan, execute, cases,
                        planless=False):
        """One value-fleet case of phase 16: ``torch.func.vmap`` of
        ``execute`` (A·A on ``plan``'s structure, the hash family) over the
        members' values (``cases``: ``(values, xa, xb)``, each a ``(n,
        cap)`` stack or a shared vector), launching the batched kernels of
        each phase -- one classifying launch, then one launch per table
        class the plan's largest table allows (the numeric phase;
        ``planless``: the symbolic one too) -- and nothing else.  Checks:
        row pointers the plan's; the batched symbolic counts the plan's ESC
        counts and the batched plain version's; the batched numeric kernel
        and the vmapped output against the batched plain version (columns
        bitwise, values bitwise on dyadic values, else within 1 ulp per
        product); on dyadic values every member bitwise equal to the
        single-product execute (rows sorted).  Each phase's classes
        (:meth:`fleet_classes`).  Then the timings of the uniform fleet:
        both batched kernels as single calls and back to back, beside the
        single-product kernels."""
        import dataclasses
        torch, K, ref = self.torch, self.K, self.ref
        vector = plan.algorithm == "hash_vector"
        sfx = "_vector" if vector else ""
        m, shape = a.n_rows, a.shape
        table, cap_c, ic = plan.table_size, plan.cap_c, plan.indptr_c
        sched = (plan.offsets, plan.bin_tsize)

        def one(x, y):
            c = execute(dataclasses.replace(a, data=x),
                        dataclasses.replace(a, data=y))
            return c.indptr, c.indices, c.data

        def vmapped(xa, xb):
            dims = (0 if xa.dim() == 2 else None, 0 if xb.dim() == 2 else None)
            return torch.func.vmap(one, in_dims=dims)(xa, xb)

        def member(x, e):
            return x[e] if x.dim() == 2 else x

        def sym_args(xa, xb):
            return (*sched, a.indptr, a.indptr, a.indices, xa, a.indices, xb)

        def num_args(xa, xb):
            return (*sched, a.indptr, a.indptr, ic, a.indices, xa, a.indices,
                    xb)

        n = max(x.shape[0] for _, xa, xb in cases for x in (xa, xb)
                if x.dim() == 2)
        largest = K.fleet_table([plan.offsets.tolist()] * n,
                                [plan.bin_tsize.tolist()] * n, table, m,
                                vector)
        n_launches = len(K.launch_classes(largest))
        # the symbolic phase with B's width: its bitmap class where it fits
        n_sym = len(K.launch_classes(largest, ref.bitmap_above(a.n_cols)))
        check(0 < n_launches <= len(K.CLASS_NAMES) and 0 < n_sym,
              f"{label}: {n_launches} class launches a phase")
        want = {f"batched_numeric{sfx}": n_launches}
        if planless:
            want[f"batched_symbolic{sfx}"] = n_sym
        kw = dict(n_members=n, table_size=table, vector=vector)
        sym_kw = dict(kw, n_cols=a.n_cols)
        counts_pp = ref.products_per_entry(a.indptr, a.indptr, ic, a.indices,
                                           a.indices, cap_c)
        err = {"batched_numeric": 0.0, "batched_symbolic": 0.0}
        launches = {}
        for values, xa, xb in cases:
            what = f"{label} ({values})"
            dyadic = values == "dyadic"
            (ip, cols, data), counts = self.counted(lambda: vmapped(xa, xb))
            self.expect(counts, want, f"{what} vmap")
            check(self.class_counts["classify"] == 1 + planless,
                  f"{what} vmap: {self.class_counts['classify']} "
                  f"classifying launches")
            launches = {"batched_numeric": counts[f"batched_numeric{sfx}"],
                        "batched_symbolic": counts[f"batched_symbolic{sfx}"]}
            check(data.shape == cols.shape == (n, cap_c),
                  f"{what}: output shape {tuple(data.shape)}")
            check(torch.equal(ip, ic.expand_as(ip)),
                  f"{what}: row pointers differ from the plan's")
            del ip
            rows = K.batched_symbolic_call(*sym_args(xa, xb), **sym_kw)
            check(torch.equal(rows, plan.row_nnz_c.expand_as(rows)),
                  f"{what}: batched symbolic counts != the plan's ESC counts")
            check(torch.equal(rows, ref.batched_symbolic_plain(
                *sym_args(xa, xb), **kw)), f"{what}: batched symbolic "
                f"kernel differs from its plain version")
            del rows
            kc, kv = K.batched_numeric_call(*num_args(xa, xb), cap_c=cap_c,
                                            **kw)
            pc, pv = ref.batched_numeric_plain(*num_args(xa, xb),
                                               cap_c=cap_c, **kw)
            k = None if dyadic else counts_pp
            for e in range(n):
                err["batched_numeric"] = max(
                    err["batched_numeric"],
                    self.compare(f"{what} batched kernel member {e}", kc[e],
                                 kv[e], ic, shape, pc[e], pv[e], k),
                    self.compare(f"{what} vmap member {e}", cols[e],
                                 data[e], ic, shape, pc[e], pv[e], k))
                if dyadic:
                    single = execute(
                        dataclasses.replace(a, data=member(xa, e)),
                        dataclasses.replace(a, data=member(xb, e)))
                    s = single.sort_rows()
                    self.compare(f"{what} member {e} vs single execute",
                                 cols[e], data[e], ic, shape, s.indices,
                                 s.data)
                    del single, s
            del kc, kv, pc, pv, cols, data
        print(f"{label}: {n} members, {len(cases)} fleets; 1 classifying "
              f"and {n_launches} class launches a phase (symbolic {n_sym}); "
              f"row counts the "
              f"plan's, every member equal to the plain version and "
              f"(dyadic) the single-product execute; max abs diff numeric "
              f"{err['batched_numeric']}", flush=True)

        # ---- timings (the uniform fleet) ---------------------------------
        _, xa, xb = next(c for c in cases if c[0] == "uniform")
        errors = torch.zeros(1, dtype=torch.int32, device=self.dev)
        classes = self.fleet_classes(label, num_args(xa, xb), n, table,
                                     cap_c, vector, largest, a.n_cols)
        nnz = int(a.nnz)
        m_a = [dataclasses.replace(a, data=member(xa, e)) for e in range(n)]
        m_b = [dataclasses.replace(a, data=member(xb, e)) for e in range(n)]
        ip_l, ix_l = a.indptr.long(), a.indices[:nnz].long()
        sp_a = [torch.sparse_csr_tensor(ip_l, ix_l, x.data[:nnz], size=shape)
                for x in m_a]
        sp_b = [torch.sparse_csr_tensor(ip_l, ix_l, y.data[:nnz], size=shape)
                for y in m_b]

        def single(kernel, e, *extra):
            args = (*sched, a.indptr, a.indptr, *extra, a.indices,
                    member(xa, e), a.indices, member(xb, e))
            return kernel(*args, table_size=table, vector=vector,
                          errors=errors, **({"cap_c": cap_c} if extra
                                            else {"n_cols": a.n_cols}))

        def batched_numeric():
            return K.batched_numeric_call(*num_args(xa, xb), cap_c=cap_c,
                                          **kw, errors=errors,
                                          largest=largest)

        def batched_symbolic():
            return K.batched_symbolic_call(*sym_args(xa, xb), **sym_kw,
                                           errors=errors, largest=largest)

        t = {"vmap_execute": self.time_ms(lambda: vmapped(xa, xb)),
             "batched_numeric": self.time_ms(batched_numeric),
             "batched_symbolic": self.time_ms(batched_symbolic),
             "loop_numeric": self.time_ms(lambda: [
                 single(K.numeric_call, e, ic) for e in range(n)]),
             "loop_symbolic": self.time_ms(lambda: [
                 single(K.symbolic_call, e) for e in range(n)]),
             "loop": self.time_ms(lambda: [execute(x, y) for x, y in
                                           zip(m_a, m_b)]),
             "plain_numeric": self.time_ms(
                 lambda: ref.batched_numeric_plain(*num_args(xa, xb),
                                                   cap_c=cap_c, **kw),
                 reps=3, warm=1),
             "plain_symbolic": self.time_ms(
                 lambda: ref.batched_symbolic_plain(*sym_args(xa, xb), **kw),
                 reps=3, warm=1),
             "torch_sparse_mm_loop": self.time_ms(
                 lambda: [torch.sparse.mm(x, y) for x, y in
                          zip(sp_a, sp_b)])}
        b2b = {k: self.stream_ms(f)[0] for k, f in (
            ("batched_numeric", batched_numeric),
            ("batched_symbolic", batched_symbolic),
            ("single_numeric", lambda: single(K.numeric_call, 0, ic)),
            ("single_symbolic", lambda: single(K.symbolic_call, 0)))}
        torch.cuda.synchronize()
        check(int(errors) == 0, f"{label}: {int(errors)} kernel errors")
        # least time: the shared index arrays once (A's row pointer and
        # column ids, B's column ids, the schedule and, numeric, indptr_c),
        # each member's A and B values (once when shared), per member C's
        # columns and values (numeric) or row counts (symbolic)
        n_a = n if xa.dim() == 2 else 1
        n_b = n if xb.dim() == 2 else 1
        nb = plan.bin_tsize.shape[0]
        index = 4 * (m + 1) + 8 * nnz + 4 * (2 * nb + 1)
        by = {"batched_numeric": index + 4 * (m + 1)
              + 4 * nnz * (n_a + n_b) + 8 * n * plan.nnz_c,
              "batched_symbolic": index + 4 * n * m}
        ops_n = 2 * n * plan.total_flop
        bound = {"batched_numeric": max(by["batched_numeric"]
                                        / HBM_BW,
                                        ops_n / FP32_FLOPS) * 1e3,
                 "batched_symbolic": by["batched_symbolic"]
                 / HBM_BW * 1e3}
        bound_by = {"batched_numeric": "bytes" if by["batched_numeric"]
                    / HBM_BW >= ops_n / FP32_FLOPS
                    else "operations", "batched_symbolic": "bytes"}
        print(json.dumps({"timing": f"hash value fleet {label}",
                          "card": self.card, "members": n,
                          "algorithm": plan.algorithm, "planless": planless,
                          "batched": {"a": n_a > 1, "b": n_b > 1},
                          "nnz_a": nnz, "flop": plan.total_flop,
                          "nnz_c": plan.nnz_c, "table_size": table,
                          "launches": launches, "classes": classes,
                          "ms": t, "back_to_back_ms": b2b,
                          "bound_ms": bound,
                          "bound_bytes": by, "bound_operations": ops_n,
                          "shared_index_arrays": "counted once"}),
              flush=True)
        for k in ("batched_numeric", "batched_symbolic"):
            if not launches[k]:
                continue        # not on this path: timed in the line above
            self.rows.append({
                "name": f"spgemm_hash_{k}{sfx}[{label}]", "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": REPLACES["batched" if k == "batched_numeric"
                                     else k],
                "launches": launches[k], "max_abs_err": err[k], "ms": t[k],
                "plain_ms": t[f"plain_{k.split('_')[1]}"],
                "bound_ms": bound[k], "bound_by": bound_by[k],
                "library_ms": t["torch_sparse_mm_loop"]
                if k == "batched_numeric" else None})
        del m_a, m_b, sp_a, sp_b
        torch.cuda.empty_cache()

    def fleet_classes(self, label, args, n, table, cap_c, vector,
                      largest, n_cols) -> dict:
        """Each batched phase's table classes on a fleet's numeric
        arguments ``args`` (stacked or shared; the symbolic phase takes
        them without ``indptr_c``, with B's width ``n_cols``): the
        classifying kernel against its plain version (counts, each pair's
        table, each class's pairs as a set), rows, products and (numeric)
        nnz(C) per class, every class that holds pairs among the launched
        ones (the symbolic phase's bitmap class too), and the device ms of
        the
        classifying launch and of each class launch, CUDA events around it
        in one call of the batched kernel (``K.CLASS_EVENTS``).  Printed;
        returns ``{phase: {"classify_ms", class: {"rows", "products",
        "nnz_c", "ms"}}}``."""
        from repro_torch.kernels._build import member_view
        torch, K, ref = self.torch, self.K, self.ref
        off, bts, ia, ib, ic, ai = args[:6]
        m = min(ia.shape[-1], ic.shape[-1]) - 1
        flop = torch.stack([ref.row_flop_plain(
            member_view(ia, 1, e)[:m + 1], member_view(ib, 1, e),
            member_view(ai, 1, e)) for e in range(n)])
        nnz = torch.stack([member_view(ic, 1, e)[1:m + 1].long()
                           - member_view(ic, 1, e)[:m].long()
                           for e in range(n)])
        kw = dict(n_members=n, table_size=table, vector=vector)
        err = torch.zeros(1, dtype=torch.int32, device=self.dev)
        out = {}
        for numeric in (False, True):
            phase = "numeric" if numeric else "symbolic"
            c_ic = ic if numeric else None
            width = None if numeric else n_cols
            launched = K.launch_classes(
                largest, 0 if numeric else ref.bitmap_above(n_cols))
            counts, pairs, row_tsz = K.batched_row_classes(
                off, bts, ia, ib, c_ic, ai, n_members=n, table_size=table,
                numeric=numeric, errors=err, n_cols=width)
            p_counts, p_pairs, p_tsz = ref.batched_row_classes_plain(
                off, bts, ia, ib, c_ic, ai, n_members=n, table_size=table,
                numeric=numeric, n_cols=width)
            torch.cuda.synchronize()
            check(int(err) == 0, f"{label}: {phase} classify errors "
                  f"{int(err)}")
            check(torch.equal(counts, p_counts) and
                  torch.equal(row_tsz, p_tsz), f"{label}: {phase} classes "
                  f"{counts.tolist()} differ from the plain version's "
                  f"{p_counts.tolist()}")
            for c, (got, want) in enumerate(zip(pairs, p_pairs)):
                key = got[:, 0] * m + got[:, 1]
                check(torch.equal(torch.sort(key).values,
                                  p_pairs[c][:, 0] * m + p_pairs[c][:, 1]),
                      f"{label}: {phase} class {K.SYMBOLIC_CLASS_NAMES[c]} "
                      f"pairs differ from the plain version's")
                check(not want.shape[0] or c in launched,
                      f"{label}: {phase} class {K.SYMBOLIC_CLASS_NAMES[c]} "
                      f"holds pairs but is not launched")
            fn = (lambda: K.batched_numeric_call(
                *args, cap_c=cap_c, **kw, errors=err, largest=largest)) \
                if numeric else (lambda: K.batched_symbolic_call(
                    *args[:4], *args[5:], **kw, errors=err,
                    largest=largest, n_cols=n_cols))
            fn()
            K.CLASS_EVENTS = []
            fn()
            torch.cuda.synchronize()
            ms = {name: t0.elapsed_time(t1)
                  for _, name, t0, t1 in K.CLASS_EVENTS}
            K.CLASS_EVENTS = None
            check(int(err) == 0, f"{label}: {phase} kernel errors")
            out[phase] = {"classify_ms": ms["classify"]}
            for c, want in enumerate(p_pairs):
                e, r = want[:, 0], want[:, 1]
                name = K.SYMBOLIC_CLASS_NAMES[c]
                out[phase][name] = {
                    "rows": int(want.shape[0]),
                    "products": int(flop[e, r].sum()),
                    "nnz_c": int(nnz[e, r].sum()),
                    "ms": ms.get(name)}
            print(f"{label}: {phase} classes (rows, products, nnz(C), "
                  f"device ms; classify {ms['classify']:.4f} ms): "
                  + "; ".join(
                      f"{name} {v['rows']}, {v['products']}, {v['nnz_c']}, "
                      + ("-" if v["ms"] is None else f"{v['ms']:.4f}")
                      for name, v in out[phase].items()
                      if name != "classify_ms"), flush=True)
        return out

    def hash_value_fleet(self, a, a_d, label, members, both=0,
                         other=False):
        """Phase 16: ``torch.func.vmap`` of the hash plan's execute (the
        recipe's own plan, which must be of the hash family) over
        ``members`` members of A's values against the shared dyadic B, and
        of the planless ``spgemm_hash`` with the plan's schedule pinned
        (rows 4 and 5); with ``both``, also ``both`` members of A's and B's
        values; with ``other``, also the plan of the other probe mode.  A
        dyadic and a uniform fleet each.

        Memory (ER s18 ef16, 8 members): each member's output is 8 bytes x
        nnz(C) = 8 x 67,073,501 = 537 MB, so 4.3 GB a call; the check
        holds the vmapped output, the batched kernel's and the batched
        plain version's (12.9 GB) plus one plain product's sort at a time
        (about 2 GB); G500 s16 ef16 at 2 members: 8 x 163,577,005 x 2 =
        2.6 GB a call, 7.9 GB held.
        """
        torch, core, ops = self.torch, self.core, self.ops
        core.clear_plan_cache()
        plan = core.plan_spgemm(a, a, algorithm="auto", sorted_output=False)
        algo = plan.algorithm
        check(algo in ("hash", "hash_vector"),
              f"{label} fleet: recipe chose {algo}, not the hash family")

        def fleets(n, seed, b_too=False):
            out = []
            for i, values in enumerate(("dyadic", "uniform")):
                d = values == "dyadic"
                xb = self.csr_fleet(a, n, seed + 10 + i, d) if b_too \
                    else a_d.data
                out.append((values, self.csr_fleet(a, n, seed + i, d), xb))
            return out

        def planless(x, y):
            return ops.spgemm_hash(x, y, plan.cap_c,
                                   vector=algo == "hash_vector",
                                   table_size=plan.table_size,
                                   schedule=(plan.offsets, plan.bin_tsize))

        n = members
        self.hash_fleet_case(f"{label}, {algo}, {n} members, A batched", a,
                             plan, plan.execute, fleets(n, 110))
        if both:
            self.hash_fleet_case(f"{label}, {algo}, {both} members, A and B "
                                 f"batched", a, plan, plan.execute,
                                 fleets(both, 120, b_too=True))
        if other:
            other = "hash" if algo == "hash_vector" else "hash_vector"
            plan_o = core.plan_spgemm(a, a, algorithm=other)
            self.hash_fleet_case(f"{label}, {other}, {n} members, A "
                                 f"batched", a, plan_o, plan_o.execute,
                                 fleets(n, 130))
            del plan_o
        self.hash_fleet_case(f"{label}, planless spgemm_hash, {n} members, "
                             f"A batched", a, plan, planless, fleets(n, 140),
                             planless=True)
        del plan
        core.clear_plan_cache()
        torch.cuda.empty_cache()


    # ---- phase 7 -----------------------------------------------------------
    def block_csr(self, brow, bcol, g, seed, block=BLOCK):
        """Scalar CSR operands on the card whose block pattern is
        ``(brow, bcol)`` over a ``g x g`` grid of dense ``block`` tiles:
        uniform values in [0.5, 1.5) and a dyadic-valued copy, both drawn
        from seeded numpy generators."""
        torch = self.torch
        bm, bn = block
        key = np.unique(brow.astype(np.int64) * g + bcol)
        br, bc = key // g, key % g
        ii, jj = np.meshgrid(np.arange(bm), np.arange(bn), indexing="ij")
        rows = (br[:, None, None] * bm + ii).ravel()
        cols = (bc[:, None, None] * bn + jj).ravel()
        n = g * bm
        order = np.argsort(rows * n + cols, kind="stable")
        cols = cols[order]
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
        nnz = cols.shape[0]
        uni = np.random.default_rng(seed).uniform(
            0.5, 1.5, nnz).astype(np.float32)
        dy = np.asarray(DYADIC, np.float32)[
            np.random.default_rng(seed + 1).integers(0, 4, nnz)]
        a = self.CSR.from_numpy(indptr, cols, uni, nnz, (n, n), True,
                                device=self.dev)
        a_d = self.CSR(a.indptr, a.indices, torch.from_numpy(dy).to(self.dev),
                       a.nnz, a.shape, True)
        return a, a_d, int(key.shape[0])

    def bcsr_classes(self, label, bp, ab, preset) -> dict:
        """Phase 7's row classes of the block kernel: the classifying
        kernels against their plain version (counts per (class, A-block
        bucket), each row's table, each class's rows as a set and in bucket
        order), then rows, block pairs, A blocks and outputs per class.
        The G500 pattern's longest row (its hub) must be in the largest
        staged class, in its first bucket."""
        torch, BK, bref = self.torch, self.BK, self.bcsr_ref
        err = torch.zeros(1, dtype=torch.int32, device=self.dev)
        counts, rows, row_tsz = BK.row_classes(
            bp.offsets, bp.bin_tsize, ab.indptr, ab.indptr, bp.indptr_cb,
            ab.indices, table_size=bp.table_size, vector=False,
            block=BLOCK3, errors=err)
        p_counts, p_rows, p_tsz = bref.row_classes_plain(
            bp.offsets, bp.bin_tsize, ab.indptr, bp.indptr_cb,
            table_size=bp.table_size, vector=False, block=BLOCK3)
        check(int(err) == 0 and torch.equal(counts.cpu(), p_counts.cpu())
              and torch.equal(row_tsz.cpu(), p_tsz.cpu()),
              f"{label}: the classifying kernels differ from their plain "
              f"version")
        ia = ab.indptr.long().cpu()
        na = ia[1:] - ia[:-1]
        nnzb = int(ia[-1])
        # block pairs per row (B is A): the B row lengths of each A block
        pairs = torch.zeros(na.shape[0], dtype=torch.long)
        pairs.index_add_(0, torch.repeat_interleave(
            torch.arange(na.shape[0]), na), na[ab.indices[:nnzb].long().cpu()])
        need = (bp.indptr_cb[1:] - bp.indptr_cb[:-1]).long().cpu()
        per_class = {}
        for c, (r, pr) in enumerate(zip(rows, p_rows)):
            r, pr = r.long().cpu(), pr.long().cpu()
            check(sorted(r.tolist()) == sorted(pr.tolist()) and torch.equal(
                bref.len_bucket(na[r].clamp(min=1)),
                bref.len_bucket(na[pr].clamp(min=1))),
                f"{label}: class {BK.CLASS_NAMES[c]}'s rows differ from "
                f"the plain version's")
            if r.numel():
                per_class[BK.CLASS_NAMES[c]] = {
                    "rows": r.numel(), "pairs": int(pairs[r].sum()),
                    "outputs": int(need[r].sum()),
                    "max_a_blocks": int(na[r].max()),
                    "first_row_a_blocks": int(na[r[0]])}
        if preset == "G500":
            hub = int(torch.argmax(na))
            staged = BK.CLASS_NAMES[len(BK.CLASS_NAMES) - 2]
            r = rows[len(BK.CLASS_NAMES) - 2].long().cpu()
            check(hub in r.tolist() and int(bref.len_bucket(na[r[0]])) ==
                  int(bref.len_bucket(na[hub])),
                  f"{label}: the hub row ({int(na[hub])} A blocks) does not "
                  f"start first in {staged}")
        print(f"{label}: row classes equal to the plain version's: "
              f"{per_class}", flush=True)
        return {"per_class": per_class, "max_abs_err": 0.0}

    def bcsr_class_times(self, label, classes, args, kw, errors) -> dict:
        """Each class's launch alone, back to back (one event pair around
        20 launches, each after its pop counter is zeroed), beside the
        host's time to issue one and the class's launch shape; then the
        classifying kernels' single-call time and their plain version's.
        Returns ``{class: {...}, "classify": (ms, plain ms)}``."""
        torch, BK, bref = self.torch, self.BK, self.bcsr_ref
        offsets, bin_tsize, ia, _, ic = args[:5]
        table_size = kw["table_size"]
        call = BK.prepare(*args, n_members=1, **kw, errors=errors)
        BK.classify(call)
        n_keys = len(BK.CLASS_NAMES) * bref.LEN_BUCKETS
        res = {}
        for c, name in enumerate(BK.CLASS_NAMES):
            info = classes["per_class"].get(name)
            if info is None:
                continue

            def run(c=c):
                call.counts[n_keys + c].zero_()
                BK.launch_class(call, c)
            dev_ms, host_ms = self.stream_ms(run)
            shape = BK.class_shape(c, False) if c < len(BK.CLASS_NAMES) - 1 \
                else {"blocks": BK.GLOBAL_BLOCKS}
            res[name] = {**info, "back_to_back_ms": dev_ms,
                         "host_ms": host_ms, "shape": shape}

        def classify():
            call.counts.zero_()
            BK.classify(call)
        res["classify"] = (
            self.time_ms(classify),
            self.time_ms(lambda: bref.row_classes_plain(
                offsets, bin_tsize, ia, ic, table_size=table_size,
                vector=False, block=BLOCK3), reps=3, warm=1))
        del call
        return res

    def bcsr_input(self, preset, scale, ef):
        """The block-sparse route on an R-MAT block pattern."""
        torch, core = self.torch, self.core
        BK, bcsr_ops, bref, href = self.BK, self.bcsr_ops, self.bcsr_ref, \
            self.ref
        label = f"{preset}-pattern s{scale} ef{ef} {BLOCK[0]}x{BLOCK[1]}"
        t0 = time.perf_counter()
        br, bc = self.rmat.rmat_edges(scale, ef, preset, seed=0)
        a, a_d, nnzb = self.block_csr(br, bc, 1 << scale, seed=1)
        print(f"{label}: n={a.n_rows} nnzb(A)={nnzb} nnz(A)={int(a.nnz)} "
              f"(built in {time.perf_counter() - t0:.1f} s)", flush=True)

        core.clear_plan_cache()
        t0 = time.perf_counter()
        plan, plan_counts = self.counted(lambda: core.plan_spgemm(
            a, a, algorithm="bcsr"))
        plan_s = time.perf_counter() - t0
        self.expect(plan_counts, {"symbolic": 1, "bcsr_symbolic": 1},
                    f"{label} plan_spgemm(bcsr)")
        bp = plan.bcsr_plan
        print(f"{label}: block flop {bp.total_flop}, nnzb(C) {bp.nnzb_c}, "
              f"nnz(C) {plan.nnz_c}, table_size {bp.table_size}, bin_tsize "
              f"{bp.bin_tsize.tolist()}, offsets {bp.offsets.tolist()} "
              f"(planned in {plan_s:.2f} s)", flush=True)
        ab = core.csr_to_bcsr(a, BLOCK)
        ab_d = core.csr_to_bcsr(a_d, BLOCK)
        classes = self.bcsr_classes(label, bp, ab, preset)
        launched = bref.launch_classes(BLOCK3, bp.table_size, bp.bcap_c)
        want_classes = dict(dict.fromkeys(BK.CLASS_CALLS, 0), classify=1,
                            **{BK.CLASS_NAMES[x]: 1 for x in launched})
        again, counts = self.counted(lambda: (
            core.plan_spgemm(a, a, algorithm="bcsr"), core.plan_bcsr(ab, ab)))
        self.expect(counts, {}, f"{label} repeat plans")
        check(again[0] is plan and again[1] is bp,
              f"{label}: a repeat plan missed the cache")
        direct, direct_counts = self.counted(lambda: core.plan_bcsr(
            ab, ab, cache=False))
        self.expect(direct_counts, {"symbolic": 1, "bcsr_symbolic": 1},
                    f"{label} plan_bcsr")
        for f in ("flop", "offsets", "bin_tsize", "row_nnzb_c", "indptr_cb"):
            check(torch.equal(getattr(direct, f), getattr(bp, f)),
                  f"{label}: plan_bcsr {f} differs from the nested plan's")

        paths = {}
        c, counts = self.counted(lambda: plan.execute(a, a))
        self.expect(counts, {"bcsr_numeric": 1}, f"{label} plan.execute")
        paths["plan.execute"] = counts["bcsr_numeric"]
        exec_classes = self.bcsr_class_counts
        check(exec_classes == want_classes, f"{label} plan.execute: class "
              f"launches {exec_classes}, want {want_classes} (one "
              f"classification, one launch per class that can hold rows)")
        c_d, counts = self.counted(lambda: plan.execute(a_d, a_d))
        self.expect(counts, {"bcsr_numeric": 1},
                    f"{label} plan.execute dyadic")
        cb, counts = self.counted(lambda: direct.execute(ab, ab))
        self.expect(counts, {"bcsr_numeric": 1}, f"{label} BCSRPlan.execute")
        paths["BCSRPlan.execute"] = counts["bcsr_numeric"]
        cb_d, counts = self.counted(lambda: direct.execute(ab_d, ab_d))
        self.expect(counts, {"bcsr_numeric": 1},
                    f"{label} BCSRPlan.execute dyadic")
        # chunked probing (the vector mode), planned explicitly
        vplan, counts = self.counted(lambda: core.plan_bcsr(ab, ab,
                                                            vector=True))
        self.expect(counts, {"symbolic_vector": 1, "bcsr_symbolic": 1},
                    f"{label} plan_bcsr(vector=True)")
        for f in ("offsets", "bin_tsize", "row_nnzb_c", "indptr_cb"):
            check(torch.equal(getattr(vplan, f), getattr(bp, f)),
                  f"{label}: vector plan {f} differs from the scalar plan's")
        vpaths = {}
        cv, counts = self.counted(lambda: vplan.execute(ab, ab))
        self.expect(counts, {"bcsr_numeric_vector": 1},
                    f"{label} BCSRPlan(vector).execute")
        vpaths["BCSRPlan(vector).execute"] = counts["bcsr_numeric_vector"]
        cv_d, counts = self.counted(lambda: vplan.execute(ab_d, ab_d))
        self.expect(counts, {"bcsr_numeric_vector": 1},
                    f"{label} BCSRPlan(vector).execute dyadic")

        # the structure: the symbolic counts against the plain version of
        # the hash symbolic kernel on the block patterns
        pat = (bp.offsets, bp.bin_tsize, ab.indptr, ab.indptr, ab.indices,
               ab.valid_mask().float(), ab.indices, ab.valid_mask().float())
        rows_plain = href.symbolic_plain(*pat, table_size=bp.table_size,
                                         vector=False)
        check(torch.equal(bp.row_nnzb_c, rows_plain) and torch.equal(
            bp.indptr_cb, self.core.formats.prefix_sum(rows_plain).to(
                torch.int32)), f"{label}: symbolic block counts differ from "
              f"the plain version's")
        sym_err = torch.zeros(1, dtype=torch.int32, device=self.dev)
        rows_k = self.K.symbolic_call(*pat, table_size=bp.table_size,
                                      vector=False, errors=sym_err,
                                      n_cols=ab.grid[1])
        torch.cuda.synchronize()
        check(int(sym_err) == 0 and torch.equal(rows_k, rows_plain),
              f"{label}: the hash symbolic kernel on the block patterns")

        # the block kernel against its plain version, on the main path's
        # arguments, both value sets
        args = (bp.offsets, bp.bin_tsize, ab.indptr, ab.indptr, bp.indptr_cb,
                ab.indices, ab.blocks, ab.indices, ab.blocks)
        kw = dict(bcap_c=bp.bcap_c, table_size=bp.table_size, vector=False)
        pairs = bref.products_per_block(ab.indptr, ab.indptr, bp.indptr_cb,
                                        ab.indices, ab.indices, bp.bcap_c)
        errs = {}
        plain = {"dyadic": bref.numeric_plain(*args[:6], ab_d.blocks,
                                              ab.indices, ab_d.blocks, **kw),
                 "uniform": bref.numeric_plain(*args, **kw)}
        for mode, values, out in (
                ("numeric", "dyadic", cb_d), ("numeric", "uniform", cb),
                ("numeric_vector", "dyadic", cv_d),
                ("numeric_vector", "uniform", cv)):
            what = f"{label} {mode} ({values})"
            pc, pb = plain[values]
            sc, sb = bref.sort_block_rows(out.indptr, out.indices, out.blocks)
            check(torch.equal(out.indptr, bp.indptr_cb) and
                  torch.equal(sc, pc), f"{what}: block columns differ from "
                  f"the plain version's")
            diff = (sb - pb).abs()
            if values == "dyadic":
                check(torch.equal(sb, pb), f"{what}: tiles not bitwise "
                      f"equal (max abs diff {float(diff.max())})")
                continue
            ulp = torch.nextafter(pb.abs(), torch.full_like(
                pb, float("inf"))) - pb.abs()
            bad = diff > (pairs * BLOCK[1]).float()[:, None, None] * ulp
            check(not bool(bad.any()), f"{what}: {int(bad.sum())} cells "
                  f"past 1 ulp per product (max abs diff {float(diff.max())})")
            errs[mode] = float(diff.max())

        # two calls, and the two probe modes, give the same bits, rows
        # unsorted: tiles in order of first appearance, summed in A-block
        # order
        calls = [BK.numeric_call(*args, **{**kw, "vector": v})
                 for v in (False, False, True)]
        for other in calls[1:]:
            check(torch.equal(other[0], calls[0][0]) and
                  torch.equal(other[1], calls[0][1]),
                  f"{label}: two calls (or the probe modes) differ")
        del calls

        # the CSR output: the scalar hash plan's structure; on dyadic
        # values every order sums exactly, so the values agree bitwise
        check(int(c.nnz) == plan.nnz_c, f"{label}: nnz(C) {int(c.nnz)} != "
              f"the plan's {plan.nnz_c}")
        plan_h = core.plan_spgemm(a, a, algorithm="hash")
        c_h = plan_h.execute(a, a, sorted_output=True)
        c_hd = plan_h.execute(a_d, a_d, sorted_output=True)
        check(c.sorted_cols and torch.equal(c.indptr, c_h.indptr) and
              torch.equal(c.indices, c_h.indices),
              f"{label}: CSR structure differs from the hash plan's")
        check(torch.equal(c_d.data, c_hd.data),
              f"{label}: dyadic CSR values differ from the hash plan's")
        print(f"{label}: outputs match the plain versions and the hash "
              f"plan's structure; max abs diff {errs}; launches "
              f"{paths}, {vpaths}", flush=True)

        # ---- timings ------------------------------------------------------
        bm, bk = BLOCK
        bn = BLOCK[1]
        gm = ab.grid[0]
        nnzb_c = bp.nnzb_c
        by = (4 * bm * bk * nnzb + 4 * bk * bn * nnzb + 4 * bm * bn * nnzb_c
              + 4 * ((gm + 1) * 3 + nnzb * 2 + nnzb_c))
        ops_n = 2 * bp.total_flop * bm * bk * bn
        bound = max(by / HBM_BW, ops_n / FP32_FLOPS) * 1e3
        # the symbolic pass over the block pattern reads no values: one row
        # pointer, both index arrays and the row counts (as in phase 5)
        by_sym = 4 * (gm + 1) + 8 * nnzb + 4 * gm
        bound_sym = by_sym / HBM_BW * 1e3
        num_err = torch.zeros(1, dtype=torch.int32, device=self.dev)
        nnz_a = int(a.nnz)
        sp = torch.sparse_csr_tensor(a.indptr.long(),
                                     a.indices[:nnz_a].long(),
                                     a.data[:nnz_a], size=a.shape)
        t = {"kernel": self.time_ms(lambda: BK.numeric_call(
                 *args, **kw, errors=num_err)),
             "kernel_vector": self.time_ms(lambda: BK.numeric_call(
                 *args, **{**kw, "vector": True}, errors=num_err)),
             "plain": self.time_ms(lambda: bref.numeric_plain(*args, **kw)),
             # the wrapper with its own errors read-back, and through the
             # custom op the execute calls: the op's own cost is the gap
             "kernel_readback": self.time_ms(lambda: BK.numeric_call(
                 *args, **kw)),
             "kernel_op": self.time_ms(lambda: bcsr_ops.numeric_op(
                 *args, bp.bcap_c, bp.table_size, False)),
             "bcsr_execute": self.time_ms(lambda: direct.execute(ab, ab)),
             "reblock": self.time_ms(lambda: core.csr_to_bcsr(
                 a, BLOCK, bcap=bp.bcap_a)),
             "flatten": self.time_ms(lambda: core.bcsr_to_csr(
                 cb, cap=plan.cap_c)),
             "execute": self.time_ms(lambda: plan.execute(a, a)),
             "execute_hash": self.time_ms(lambda: plan_h.execute(a, a)),
             "symbolic": self.time_ms(lambda: self.K.symbolic_call(
                 *pat, table_size=bp.table_size, vector=False,
                 errors=sym_err, n_cols=ab.grid[1])),
             "plain_symbolic": self.time_ms(lambda: href.symbolic_plain(
                 *pat, table_size=bp.table_size, vector=False)),
             "torch_sparse_mm": self.time_ms(lambda: torch.sparse.mm(sp, sp))}
        # the card's time a call: 20 calls back to back in one event pair
        # (and the host's time to issue one)
        b2b, host = {}, {}
        for key, fn in (
                ("kernel", lambda: BK.numeric_call(*args, **kw,
                                                   errors=num_err)),
                ("kernel_vector", lambda: BK.numeric_call(
                    *args, **{**kw, "vector": True}, errors=num_err)),
                ("bcsr_execute", lambda: direct.execute(ab, ab)),
                ("torch_sparse_mm", lambda: torch.sparse.mm(sp, sp))):
            b2b[key], host[key] = self.stream_ms(fn)
        # the class kernels' device time in a trace (they overlap: the sum
        # passes the call's time)
        t["kernel_device"] = self.device_ms(lambda: BK.numeric_call(
            *args, **kw, errors=num_err), "bcsr_class_kernel")
        per_class = self.bcsr_class_times(label, classes, args, kw, num_err)
        t["classify"], t["plain_classify"] = per_class.pop("classify")
        torch.cuda.synchronize()
        check(int(num_err) == 0 and int(sym_err) == 0,
              f"{label}: kernel errors while timing")
        print(json.dumps({"timing": label, "card": self.card,
                          "n": a.n_rows, "nnzb_a": nnzb, "nnz_a": nnz_a,
                          "block_flop": bp.total_flop,
                          "scalar_flop": plan.total_flop, "nnzb_c": nnzb_c,
                          "nnz_c": plan.nnz_c, "table_size": bp.table_size,
                          "ms": t, "back_to_back_ms": b2b,
                          "host_ms_to_issue": host, "classes": per_class,
                          "bound_ms": {"numeric": bound,
                                       "symbolic": bound_sym},
                          "bound_bytes": by, "bound_operations": ops_n,
                          "plan_s": plan_s}), flush=True)
        bound_by = "bytes" if by / HBM_BW >= \
            ops_n / FP32_FLOPS else "operations"
        for mode, key, launches in (
                ("numeric", "kernel", paths),
                ("numeric_vector", "kernel_vector", vpaths)):
            self.rows.append({
                "name": f"spgemm_bcsr_{mode}[{label}]", "route": "cuda",
                "source": BCSR_SOURCE,
                "replaces": REPLACES[f"bcsr_{mode}"],
                "launches": next(iter(launches.values())),
                "launches_by_path": launches,
                "class_launches": exec_classes, "max_abs_err": errs[mode],
                "ms": b2b[key], "single_call_ms": t[key],
                "plain_ms": t["plain"], "bound_ms": bound,
                "bound_by": bound_by, "library_ms": b2b["torch_sparse_mm"]})
        # the classifying kernels (replace no TPU kernel): read the row
        # pointers of A and C and the schedule, write each row's table, key
        # and rank, and the class lists
        m = ab.grid[0]
        self.rows.append({
            "name": f"spgemm_bcsr_classify[{label}]", "route": "cuda",
            "source": BCSR_SOURCE,
            "replaces": "none: lists the rows of "
                        + REPLACES["bcsr_numeric"] + "'s port by class",
            "launches": exec_classes["classify"],
            "max_abs_err": classes["max_abs_err"], "ms": t["classify"],
            "plain_ms": t["plain_classify"],
            "bound_ms": 4 * (2 * (m + 1) + 4 * m) / HBM_BW * 1e3,
            "bound_by": "bytes", "library_ms": None})
        self.rows.append({
            "name": f"spgemm_hash_symbolic[{label} block pattern]",
            "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES["symbolic"],
            "launches": plan_counts["symbolic"],
            "launches_by_path": {
                "plan_spgemm(bcsr) inspection": plan_counts["symbolic"],
                "plan_bcsr inspection": direct_counts["symbolic"]},
            "max_abs_err": float((rows_k - rows_plain).abs().max()),
            "ms": t["symbolic"], "plain_ms": t["plain_symbolic"],
            "bound_ms": bound_sym, "bound_by": "bytes", "library_ms": None})
        del plan, bp, direct, vplan, again, c, c_d, cb, cb_d, cv, cv_d, \
            c_h, c_hd, plan_h, sp, plain
        core.clear_plan_cache()
        torch.cuda.empty_cache()

    def bcsr_auto(self):
        """A small block-clustered input: the recipe must route it to
        ``bcsr`` by itself, and its execute must launch the block kernel."""
        torch, core = self.torch, self.core
        rng = np.random.default_rng(7)
        occ = np.nonzero(rng.random((AUTO_GRID, AUTO_GRID)) < AUTO_DENSITY)
        a, a_d, nnzb = self.block_csr(occ[0], occ[1], AUTO_GRID, seed=8)
        core.clear_plan_cache()
        plan = core.plan_spgemm(a_d, a_d)
        check(plan.algorithm == "bcsr" and plan.provenance == "heuristic",
              f"auto: the recipe chose {plan.algorithm}, not bcsr")
        c, counts = self.counted(lambda: plan.execute(a_d, a_d))
        self.expect(counts, {"bcsr_numeric": 1}, "auto plan.execute")
        c_h = core.plan_spgemm(a_d, a_d, algorithm="hash").execute(
            a_d, a_d, sorted_output=True)
        check(torch.equal(c.indptr, c_h.indptr) and
              torch.equal(c.indices, c_h.indices) and
              torch.equal(c.data, c_h.data),
              "auto: the bcsr output differs from the hash plan's")
        print(f"auto: {AUTO_GRID}x{AUTO_GRID} grid of {BLOCK[0]}x{BLOCK[1]} "
              f"tiles, nnzb {nnzb}: the recipe chose 'bcsr'; plan.execute "
              f"launched the block kernel once and matches the hash plan",
              flush=True)
        for row in self.rows:
            if row["name"].startswith("spgemm_bcsr_numeric["):
                row["launches_by_path"][
                    f"plan_spgemm(auto).execute [{AUTO_GRID}x{AUTO_GRID} "
                    f"grid]"] = counts["bcsr_numeric"]
        del plan, c, c_h
        core.clear_plan_cache()

    # ---- phase 8 -----------------------------------------------------------
    def spmm_input(self, a, a_d, label, paths, widths=True,
                   classify_paths=None):
        """The SpMM kernel on ``a`` (and its dyadic copy ``a_d``): the front
        door's launches, the kernel against its plain version and scipy,
        the row classes (the classifying kernel against its plain version;
        rows, nonzeros and device time per class), then the timings.
        ``paths`` holds the launches of the runs that reached the kernel
        through a workload (the dense BFS), ``classify_paths`` those of
        the classifying kernel.  ``widths`` adds k = SPMM_K_ODD and a
        bfloat16 X (run on one input: the plain version of a skewed graph
        takes a second a call)."""
        import scipy.sparse as sps
        torch, SK, sref = self.torch, self.SK, self.spmm_ref
        m, n = a.shape
        nnz = int(a.nnz)
        host = a.to_numpy()
        a_sp = sps.csr_matrix((host[2][:nnz].astype(np.float64),
                               host[1][:nnz], host[0]), shape=a.shape)
        row_nnz = torch.from_numpy(np.diff(host[0])).to(self.dev)
        rng = np.random.default_rng(2)
        classify_paths = {} if classify_paths is None else classify_paths
        copy_paths = {}

        def x_of(k, values="uniform"):
            x = rng.uniform(0.5, 1.5, (n, k)) if values == "uniform" else \
                np.asarray(DYADIC)[rng.integers(0, 4, (n, k))]
            return torch.from_numpy(x.astype(np.float32)).to(self.dev)

        def run(mat, x, what):
            """The row lists first (the classifying kernel once on a CSR
            not classified yet, then memoized on it), then the front door:
            one SpMM launch, no plain version, no classifying launch; the
            kernel equals its plain version bitwise.  Returns y."""
            _, counts = self.counted(lambda: self.spmm_ops.row_classes(mat))
            n_cls = counts["spmm_classify"]
            check(n_cls <= 1, f"{label} spmm {what}: {n_cls} classifying "
                  f"launches for one CSR")
            self.expect(counts, {"spmm_classify": n_cls} if n_cls else {},
                        f"{label} spmm row classes {what}")
            if n_cls and not classify_paths:
                classify_paths["core.spmm (row lists memoized on the CSR)"] \
                    = n_cls
            y, counts = self.counted(lambda: self.core.spmm(mat, x))
            self.expect(counts, {"spmm_spmm": 1}, f"{label} spmm {what}")
            copy_paths[what] = next(k for k, v in SK.COPY_PATHS.items() if v)
            plain = sref.spmm_plain(mat.indptr, mat.indices,
                                    mat.data.float(), x, mat.nnz)
            check(y.dtype == x.dtype and torch.equal(y, plain),
                  f"{label} spmm {what}: kernel not bitwise equal to its "
                  f"plain version")
            return y

        x = x_of(SPMM_K)
        y = run(a, x, f"k={SPMM_K}")
        paths["core.spmm"] = 1
        want = torch.from_numpy(a_sp @ x.double().cpu().numpy()).to(self.dev)
        diff = (y.double() - want).abs()
        ulp = (torch.nextafter(want.float().abs(), torch.full_like(
            want.float(), float("inf"))) - want.float().abs()).double()
        bad = diff > row_nnz[:, None].double() * ulp
        check(not bool(bad.any()), f"{label} spmm: {int(bad.sum())} values "
              f"past 1 ulp per product of scipy's")
        err = float(diff.max())
        if widths:
            run(a, x_of(SPMM_K_ODD), f"k={SPMM_K_ODD}")
            run(a, x.to(torch.bfloat16), "bf16")
        x_d = x_of(SPMM_K, "dyadic")
        y_d = run(a_d, x_d, "dyadic")
        host_d = a_d.data[:nnz].double().cpu().numpy()
        want_d = sps.csr_matrix((host_d, host[1][:nnz], host[0]),
                                shape=a.shape) @ x_d.double().cpu().numpy()
        check(torch.equal(y_d, torch.from_numpy(want_d.astype(
            np.float32)).to(self.dev)),
              f"{label} spmm dyadic: not equal to scipy's exact product")
        cases = f"k={SPMM_K}, k={SPMM_K_ODD}, bf16, dyadic" if widths else \
            f"k={SPMM_K}, dyadic"
        length = sref.live_lengths(a.indptr, a.nnz, a.cap)
        n_long = int((length > sref.CLASS_BOUNDS[3]).sum())
        print(f"{label} spmm: kernel bitwise equal to its plain version "
              f"({cases}), within 1 ulp per product of scipy (max abs diff "
              f"{err}), exact on dyadic values; " + (
                  f"{n_long} rows past {sref.CLASS_BOUNDS[3]} nonzeros, "
                  f"their X rows by {copy_paths}" if n_long else
                  f"no row past {sref.CLASS_BOUNDS[3]} nonzeros"),
              flush=True)

        # ---- row classes ---------------------------------------------------
        data = a.data.float()
        args = (a.indptr, a.indices, data, x, a.nnz)
        cls = SK.classify(a.indptr, a.nnz, a.cap)
        counts_k, rows_k = SK.row_classes(a.indptr, a.nnz, a.cap)
        counts_p, rows_p = sref.row_classes_plain(a.indptr, a.nnz, a.cap)
        check(torch.equal(counts_k, counts_p) and all(
            torch.equal(torch.sort(r).values, w)
            for r, w in zip(rows_k, rows_p)),
              f"{label} spmm: the classifying kernel's lists differ from its "
              f"plain version's")
        per_class = {}
        for c, name in enumerate(SK.CLASS_NAMES):
            rows = int(counts_p[c])
            entry = {"rows": rows,
                     "nnz": int(length[rows_p[c].long()].sum()), "ms": 0.0,
                     "host_ms": 0.0}
            if rows:
                mask = torch.zeros(len(SK.CLASS_NAMES), dtype=torch.int32,
                                   device=self.dev)
                mask[c] = 1
                only = SK.RowClasses(cls.counts * mask, cls.lists)
                entry["ms"], entry["host_ms"] = self.stream_ms(
                    lambda: SK.spmm_call(*args, classes=only))
            per_class[name] = entry
        vw = SK.vector_width(SPMM_K, 4, x.data_ptr())
        shape = SK.launch_shape(x.dtype, vw)
        shape["grid"] = min(shape["blocks_per_sm"] * shape["sms"],
                            -(-m // shape["chunk_rows"]))
        print(json.dumps({"spmm_classes": label, "card": self.card,
                          "k": SPMM_K, "launch": shape,
                          "max_row_nnz": int(row_nnz.max()),
                          "classes": per_class}), flush=True)

        # ---- timings ------------------------------------------------------
        by = 4 * (m + 1) + 8 * nnz + 4 * n * SPMM_K + 4 * m * SPMM_K
        ops_n = 2 * nnz * SPMM_K
        bound = max(by / HBM_BW, ops_n / FP32_FLOPS) * 1e3
        sp = torch.sparse_csr_tensor(a.indptr.long(), a.indices[:nnz].long(),
                                     data[:nnz], size=a.shape)
        max_row = int(row_nnz.max())
        slow = max_row > 1000           # one plain step per slot of a row
        t = {"kernel": self.time_ms(lambda: SK.spmm_call(*args, classes=cls)),
             "kernel_classify": self.time_ms(lambda: SK.spmm_call(*args)),
             "spmm": self.time_ms(lambda: self.core.spmm(a, x)),
             "plain": self.time_ms(lambda: sref.spmm_plain(*args),
                                   reps=1 if slow else REPS,
                                   warm=0 if slow else 2),
             "torch_sparse_mm": self.time_ms(lambda: torch.sparse.mm(sp, x)),
             "classify": self.time_ms(
                 lambda: SK.classify(a.indptr, a.nnz, a.cap)),
             "plain_classify": self.time_ms(
                 lambda: sref.row_classes_plain(a.indptr, a.nnz, a.cap))}
        # back to back: the card's time a call, and the host's to issue one
        t["kernel_stream"], t["kernel_host"] = self.stream_ms(
            lambda: SK.spmm_call(*args, classes=cls))
        t["torch_sparse_mm_stream"], t["torch_sparse_mm_host"] = \
            self.stream_ms(lambda: torch.sparse.mm(sp, x))
        print(json.dumps({"timing": f"{label} spmm", "card": self.card,
                          "m": m, "n": n, "nnz_a": nnz, "k": SPMM_K,
                          "max_row_nnz": max_row, "ms": t,
                          "bound_ms": bound, "bound_bytes": by,
                          "bound_operations": ops_n}), flush=True)
        self.rows.append({
            "name": f"spmm[{label}]", "route": "cuda", "source": SPMM_SOURCE,
            "replaces": REPLACES["spmm"],
            "launches": next(iter(paths.values())),
            "launches_by_path": paths, "max_abs_err": err,
            "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
            "bound_by": "bytes" if by / HBM_BW >=
            ops_n / FP32_FLOPS else "operations",
            "library_ms": t["torch_sparse_mm"]})
        # the classifying kernel (replaces no TPU kernel): reads the row
        # pointer, writes each row id once and the counts
        self.rows.append({
            "name": f"spmm_classify[{label}]", "route": "cuda",
            "source": SPMM_SOURCE,
            "replaces": "none: lists the rows of " + REPLACES["spmm"]
                        + "'s port by live length",
            "launches": next(iter(classify_paths.values()), 0),
            "launches_by_path": classify_paths, "max_abs_err": 0.0,
            "ms": t["classify"], "plain_ms": t["plain_classify"],
            "bound_ms": (4 * (m + 1) + 4 * m + 4 * len(SK.CLASS_NAMES))
            / HBM_BW * 1e3,
            "bound_by": "bytes", "library_ms": None})
        torch.cuda.empty_cache()

    def dyadic_copy(self, a, seed):
        """``a`` with dyadic values drawn from a seeded generator."""
        nnz = int(a.nnz)
        dy = np.zeros(a.cap, np.float32)
        dy[:nnz] = np.asarray(DYADIC, np.float32)[
            np.random.default_rng(seed).integers(0, 4, nnz)]
        return self.CSR(a.indptr, a.indices,
                        self.torch.from_numpy(dy).to(self.dev), a.nnz,
                        a.shape, a.sorted_cols)

    # ---- phase 9 -----------------------------------------------------------
    def graph(self):
        """Sections 5.5-5.6 on the symmetrized R-MAT G500 graph: triangle
        count and multi-source BFS, against scipy.  Returns the graph and
        the launches of the dense BFS."""
        import scipy.sparse as sps
        from scipy.sparse.csgraph import shortest_path
        torch, core, rmat, ga = self.torch, self.core, self.rmat, self.ga
        label = f"graph G500 s{GRAPH_SCALE} ef{EDGE_FACTOR} seed {GRAPH_SEED}"
        t0 = time.perf_counter()
        a = rmat.rmat_csr(GRAPH_SCALE, EDGE_FACTOR, "G500", seed=GRAPH_SEED,
                          device=self.dev)
        g = rmat.symmetrize(a, cap=2 * a.cap, device=self.dev)
        n, nnz = g.n_rows, int(g.nnz)
        # scipy's own graph from the same edges
        r, c = rmat.rmat_edges(GRAPH_SCALE, EDGE_FACTOR, "G500",
                               seed=GRAPH_SEED)
        s = sps.coo_matrix((np.ones(r.shape[0]), (r, c)), shape=(n, n))
        s = ((s + s.T) > 0).astype(np.float64).tocsr()
        s.setdiag(0)
        s.eliminate_zeros()
        s.sort_indices()
        host = g.to_numpy()
        check(np.array_equal(host[0], s.indptr) and
              np.array_equal(host[1][:nnz], s.indices),
              f"{label}: symmetrize differs from scipy's A | A^T")
        print(f"{label}: n={n} nnz={nnz} max degree "
              f"{int(np.diff(s.indptr).max())} (built and checked in "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)

        # triangle count: masked L.U, the sum exact
        core.clear_plan_cache()
        t0 = time.perf_counter()
        tri = ga.triangle_count(g)
        torch.cuda.synchronize()
        tri_s = time.perf_counter() - t0
        deg = np.diff(s.indptr)
        order = np.argsort(deg, kind="stable")
        p = s[order][:, order]
        want_tri = int(round((sps.tril(p, -1) @ sps.triu(p, 1))
                             .multiply(p).sum() / 2))
        check(tri == want_tri, f"{label}: triangle count {tri}, scipy "
              f"{want_tri}")
        L, U, adj = rmat.triangular_split(g, return_adjacency=True,
                                          device=self.dev)
        t0 = time.perf_counter()
        plan = core.plan_spgemm(L, U, mask=adj, cache=False)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        t = {"lu_execute": self.time_ms(lambda: plan.execute(L, U),
                                        reps=3, warm=1)}
        print(f"{label}: {tri} triangles, as scipy (masked L.U: "
              f"{plan.algorithm}, flop {plan.total_flop}, nnz(C) "
              f"{plan.nnz_c})", flush=True)
        del L, U, adj, plan

        # multi-source BFS: dense frontier stack (SpMM) and masked frontiers
        sources = np.random.default_rng(0).choice(
            n, BFS_SOURCES, replace=False).tolist()
        dist, counts = self.counted(lambda: ga.multi_source_bfs(
            g, sources, BFS_HOPS))
        # one SpMM launch a hop, and the row lists made once for all hops
        self.expect(counts, {"spmm_spmm": BFS_HOPS, "spmm_classify": 1},
                    f"{label} dense BFS")
        paths = {"multi_source_bfs": counts["spmm_spmm"]}
        classify_paths = {"multi_source_bfs": counts["spmm_classify"]}
        core.clear_plan_cache()
        t0 = time.perf_counter()
        dist_m, counts = self.counted(lambda: ga.multi_source_bfs_masked(
            g, sources, BFS_HOPS))
        t["masked_bfs_first_s"] = time.perf_counter() - t0
        self.expect(counts, {}, f"{label} masked BFS")
        before = core.plan_cache_stats()
        t0 = time.perf_counter()
        dist_r = ga.multi_source_bfs_masked(g, sources, BFS_HOPS)
        torch.cuda.synchronize()
        t["masked_bfs_repeat_s"] = time.perf_counter() - t0
        after = core.plan_cache_stats()
        check(after["misses"] == before["misses"],
              f"{label}: the repeat masked BFS planned "
              f"{after['misses'] - before['misses']} products")
        sp_dist = shortest_path(s, unweighted=True, indices=sources)
        want = np.where(sp_dist <= BFS_HOPS, sp_dist, -1).astype(np.int32).T
        for name, d in (("dense", dist), ("masked", dist_m),
                        ("masked repeat", dist_r)):
            check(np.array_equal(d.cpu().numpy(), want),
                  f"{label}: {name} BFS distances differ from scipy's")
        reached = np.bincount(want[want > 0], minlength=BFS_HOPS + 1)[1:]
        print(f"{label}: BFS from {BFS_SOURCES} sources over {BFS_HOPS} "
              f"hops: dense == masked == scipy, newly reached per hop "
              f"{reached.tolist()}; the repeat hit "
              f"{after['hits'] - before['hits']} cached plans", flush=True)
        t["dense_bfs"] = self.time_ms(lambda: ga.multi_source_bfs(
            g, sources, BFS_HOPS), reps=3, warm=1)
        t["triangle_count_s"] = tri_s
        print(json.dumps({"timing": label, "card": self.card, "n": n,
                          "nnz": nnz, "triangles": tri,
                          "sources": BFS_SOURCES, "hops": BFS_HOPS,
                          "ms": {k: v for k, v in t.items()
                                 if not k.endswith("_s")},
                          "s": {k: v for k, v in t.items()
                                if k.endswith("_s")},
                          "plan_s": plan_s}), flush=True)
        del dist, dist_m, dist_r
        core.clear_plan_cache()
        torch.cuda.empty_cache()
        return g, label, paths, classify_paths

    # ---- phase 10 ----------------------------------------------------------
    def tall_skinny(self, a, label):
        """Section 5.5's square x tall-skinny product through the planner:
        the hash numeric kernel, held against its plain version."""
        torch, core, ref = self.torch, self.core, self.ref
        rows, cols = self.rmat.rmat_edges(G500_SCALE, EDGE_FACTOR, "G500",
                                          seed=0)
        b = self.rmat.tall_skinny_from(rows, cols, a.n_rows, TALL_K_SCALE,
                                       seed=3, device=self.dev)
        core.clear_plan_cache()
        t0 = time.perf_counter()
        plan = core.plan_spgemm(a, b, use_case="tall_skinny")
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        check(plan.algorithm == "hash", f"tall-skinny: the recipe chose "
              f"{plan.algorithm}, not hash")
        c, counts = self.counted(lambda: plan.execute(a, b))
        self.expect(counts, {"numeric": 1}, "tall-skinny plan.execute")
        args = (plan.offsets, plan.bin_tsize, a.indptr, b.indptr,
                plan.indptr_c, a.indices, a.data, b.indices, b.data)
        pc, pv = ref.numeric_plain(*args, cap_c=plan.cap_c,
                                   table_size=plan.table_size, vector=False)
        check(torch.equal(c.indptr, plan.indptr_c), "tall-skinny: indptr")
        err = self.compare("tall-skinny", c.indices, c.data, c.indptr,
                           c.shape, pc, pv, ref.products_per_entry(
                               a.indptr, b.indptr, plan.indptr_c, a.indices,
                               b.indices, plan.cap_c))
        ms = self.time_ms(lambda: plan.execute(a, b))
        print(json.dumps({"timing": f"{label} x tall-skinny", "card":
                          self.card, "k": b.n_cols, "nnz_b": int(b.nnz),
                          "flop": plan.total_flop, "nnz_c": plan.nnz_c,
                          "ms": {"execute": ms}, "max_abs_err": err,
                          "plan_s": plan_s}), flush=True)
        for row in self.rows:
            if row["name"] == f"spgemm_hash_numeric[{label}]":
                row["launches_by_path"][
                    "plan_spgemm(A, B tall-skinny).execute"] = \
                    counts["numeric"]
        del plan, c, pc, pv
        core.clear_plan_cache()

    # ---- phase 11 ----------------------------------------------------------
    def bcsr_large_tile(self):
        """Tiles of 4,096 output lanes through ``plan_spgemm(algorithm=
        "bcsr", block=(64, 64))``, against the plain version and the hash
        plan; dyadic values, so everything is bitwise.  The rows' classes
        (the classifying kernels against their plain version) and the
        kernel's times, single call and back to back."""
        torch, core, BK, bref = self.torch, self.core, self.BK, self.bcsr_ref
        rng = np.random.default_rng(9)
        occ = np.nonzero(rng.random((LARGE_GRID, LARGE_GRID)) < 0.5)
        _, a, _ = self.block_csr(occ[0], occ[1], LARGE_GRID, seed=10,
                                 block=LARGE_BLOCK)
        label = (f"{LARGE_GRID}x{LARGE_GRID} grid of {LARGE_BLOCK[0]}x"
                 f"{LARGE_BLOCK[1]} tiles")
        core.clear_plan_cache()
        plan = core.plan_spgemm(a, a, algorithm="bcsr", block=LARGE_BLOCK)
        bp = plan.bcsr_plan
        c, counts = self.counted(lambda: plan.execute(a, a))
        self.expect(counts, {"bcsr_numeric": 1}, f"{label} plan.execute")
        block3 = LARGE_BLOCK + LARGE_BLOCK[1:]
        launched = bref.launch_classes(block3, bp.table_size, bp.bcap_c)
        want = dict(dict.fromkeys(BK.CLASS_CALLS, 0), classify=1,
                    **{BK.CLASS_NAMES[x]: 1 for x in launched})
        check(self.bcsr_class_counts == want, f"{label} plan.execute: class "
              f"launches {self.bcsr_class_counts}, want {want}")
        ab = core.csr_to_bcsr(a, LARGE_BLOCK)
        n_rows, _, _ = BK.row_classes(
            bp.offsets, bp.bin_tsize, ab.indptr, ab.indptr, bp.indptr_cb,
            ab.indices, table_size=bp.table_size, vector=False, block=block3)
        p_rows, _, _ = bref.row_classes_plain(
            bp.offsets, bp.bin_tsize, ab.indptr, bp.indptr_cb,
            table_size=bp.table_size, vector=False, block=block3)
        check(torch.equal(n_rows.cpu(), p_rows.cpu()),
              f"{label}: the classifying kernels differ from their plain "
              f"version")
        per_class = {BK.CLASS_NAMES[k]: int(v) for k, v in
                     enumerate(n_rows.sum(1).tolist()) if v}
        args = (bp.offsets, bp.bin_tsize, ab.indptr, ab.indptr, bp.indptr_cb,
                ab.indices, ab.blocks, ab.indices, ab.blocks)
        kw = dict(bcap_c=bp.bcap_c, table_size=bp.table_size, vector=False)
        kc, kb = BK.numeric_call(*args, **kw)
        pc, pb = bref.numeric_plain(*args, **kw)
        kc, kb = bref.sort_block_rows(bp.indptr_cb, kc, kb)
        check(torch.equal(kc, pc) and torch.equal(kb, pb),
              f"{label}: the block kernel differs from its plain version")
        c_h = core.plan_spgemm(a, a, algorithm="hash").execute(
            a, a, sorted_output=True)
        check(torch.equal(c.indptr, c_h.indptr) and
              torch.equal(c.indices, c_h.indices) and
              torch.equal(c.data, c_h.data),
              f"{label}: the bcsr output differs from the hash plan's")
        for row in self.rows:
            if row["name"].startswith("spgemm_bcsr_numeric["):
                row["launches_by_path"][f"plan.execute [{label}]"] = \
                    counts["bcsr_numeric"]
        err = torch.zeros(1, dtype=torch.int32, device=self.dev)
        single = self.time_ms(lambda: BK.numeric_call(*args, **kw,
                                                      errors=err))
        b2b, host = self.stream_ms(lambda: BK.numeric_call(*args, **kw,
                                                           errors=err))
        torch.cuda.synchronize()
        check(int(err) == 0, f"{label}: kernel errors while timing")
        print(f"{label}: plan.execute launched the block kernel once (rows "
              f"by class {per_class}, tables of at most {bp.table_size} "
              f"slots); equal to the plain version and the hash plan",
              flush=True)
        print(json.dumps({"timing": label, "card": self.card,
                          "nnzb_c": bp.nnzb_c, "block_flop": bp.total_flop,
                          "classes": per_class,
                          "ms": {"kernel": single,
                                 "kernel_back_to_back": b2b,
                                 "host_ms_to_issue": host}}), flush=True)
        core.clear_plan_cache()

    # ---- phase 12 ----------------------------------------------------------
    def batch_args(self, cls, pairs):
        """The batched kernel's arguments for one hash class, as the class
        executor builds them (a shared operand passed once)."""
        from repro_torch.core import batch
        (M, K), (_, N) = cls.shape_a, cls.shape_b

        def side(k, rows, cols, cap, shared):
            ops = [pairs[i][k] for i in cls.members]
            if shared:
                return ops[0]
            return batch._stack_csr(ops, cols, True,
                                    batch._stack_index(ops, rows, cap))

        a = side(0, M, K, cls.cap_a, cls.a_shared)
        b = side(1, K, N, cls.cap_b, cls.b_shared)
        off, bts, ic = cls.hash_sched
        return (off, bts, a.indptr, b.indptr, ic, a.indices, a.data.float(),
                b.indices, b.data.float()), a, b

    def batch_plain(self, plan, pairs):
        """The batched plain version of every hash class of ``plan`` on
        ``pairs``: per member its (columns, values) and the products each
        entry sums; per class ``(cls, kernel args, kernel kw)``."""
        ref = self.ref
        plain, pp, class_args = {}, {}, []
        for cls in plan.classes:
            if cls.hash_sched is None:
                continue
            args, _, _ = self.batch_args(cls, pairs)
            kw = dict(n_members=cls.n_members, cap_c=cls.cap_c,
                      table_size=cls.table_size, vector=False)
            class_args.append((cls, args, kw))
            pc, pv = ref.batched_numeric_plain(*args, **kw)
            for e, i in enumerate(cls.members):
                a, b = pairs[i]
                plain[i] = (pc[e], pv[e])
                pp[i] = ref.products_per_entry(a.indptr, b.indptr,
                                               args[4][e], a.indices,
                                               b.indices, cls.cap_c)
            del pc, pv
        return plain, pp, class_args

    def serve_times(self, label, pairs, launches):
        """A serving loop's call, ``plan_batch(pairs).execute(pairs)`` under
        ``torch.inference_mode()`` (a plan-cache hit, the structure check
        and the execute), timed on the fleet's own tensors and on copies
        made under inference mode, which have no version counters; the
        copies' call must hit the cache and launch what the execute
        launches."""
        import dataclasses
        torch, core = self.torch, self.core
        copies = {}
        with torch.inference_mode():
            for x in (x for pair in pairs for x in pair):
                if id(x) not in copies:
                    copies[id(x)] = dataclasses.replace(
                        x, indptr=x.indptr.clone(), indices=x.indices.clone(),
                        data=x.data.clone(), nnz=x.nnz.clone())
        inf_pairs = [(copies[id(a)], copies[id(b)]) for a, b in pairs]

        def serve(ps):
            with torch.inference_mode():
                return core.plan_batch(ps).execute(ps)

        serve(inf_pairs)
        outs, counts = self.counted(lambda: serve(inf_pairs))
        self.expect(counts, {"batched_numeric": launches},
                    f"{label} plan_batch.execute of inference tensors")
        check([int(c.nnz) for c in outs] ==
              list(core.plan_batch(pairs).nnz_cs),
              f"{label}: nnz of the inference-mode execute")
        del outs
        return {"serve": self.time_ms(lambda: serve(pairs)),
                "serve_inference": self.time_ms(lambda: serve(inf_pairs))}

    def batch_fleet(self, label, pairs, gather_oracle=False,
                    vector_too=False, serve_too=False):
        """``plan_batch(pairs).execute`` on the card: per hash class one
        classifying launch and one launch per table class its largest
        table allows, no plain version; every member against the batched
        plain version, the port's per-product planned loop (and, for the
        MoE fleet, the gathered feature rows); each phase's classes
        (:meth:`fleet_classes`); then the timings (``serve_too``: also
        :meth:`serve_times`)."""
        torch, core, K, ref = self.torch, self.core, self.K, self.ref
        core.clear_plan_cache()
        t0 = time.perf_counter()
        plan = core.plan_batch(pairs)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        hash_cls = [c for c in plan.classes if c.hash_sched is not None]
        check(len(hash_cls) == plan.n_classes,
              f"{label}: the recipe chose {sorted(set(plan.algorithms))}, "
              f"not the hash kernel, for some class")

        def want(vector):
            return sum(len(K.launch_classes(K.fleet_table(
                *c.hash_host, c.table_size, c.shape_a[0], vector)))
                for c in hash_cls)

        outs, counts = self.counted(lambda: plan.execute(pairs))
        launches = want(False)
        check(launches == sum(len(K.launch_classes(c.hash_largest))
                              for c in hash_cls),
              f"{label}: the plan's largest tables")
        self.expect(counts, {"batched_numeric": launches},
                    f"{label} plan_batch.execute")
        check(self.class_counts["classify"] == len(hash_cls),
              f"{label}: {self.class_counts['classify']} classifying "
              f"launches for {len(hash_cls)} classes")
        check(launches <= len(K.CLASS_NAMES) * len(hash_cls),
              f"{label}: {launches} launches for {len(hash_cls)} classes")
        outs2, counts = self.counted(lambda: plan.execute(pairs))
        self.expect(counts, {"batched_numeric": launches},
                    f"{label} repeat plan_batch.execute")

        plain, pp, class_args = self.batch_plain(plan, pairs)
        err = 0.0
        for i, (c, c2) in enumerate(zip(outs, outs2)):
            check(c.shape == (pairs[i][0].n_rows, pairs[i][1].n_cols) and
                  int(c.nnz) == plan.nnz_cs[i],
                  f"{label} member {i}: shape or nnz")
            err = max(err, self.compare(f"{label} member {i}", c.indices,
                                        c.data, c.indptr, c.shape,
                                        *plain[i], pp[i]))
            self.compare(f"{label} member {i} repeat", c2.indices, c2.data,
                         c2.indptr, c2.shape, *plain[i], pp[i])
        del outs2

        # the per-product planned loop: the same structure, values in the
        # contract against the same plain version
        loop_plans = [core.plan_spgemm(a, b, algorithm=plan.algorithms[i])
                      for i, (a, b) in enumerate(pairs)]

        def loop():
            return [p.execute(a, b) for p, (a, b) in zip(loop_plans, pairs)]

        loop_outs, counts = self.counted(loop)
        self.expect(counts, {"numeric": len(pairs)},
                    f"{label} per-product loop")
        for i, (c, r) in enumerate(zip(outs, loop_outs)):
            check(torch.equal(c.indptr, r.indptr) and
                  int(c.nnz) == int(r.nnz),
                  f"{label} member {i}: indptr/nnz differ from the loop's")
            check(torch.equal(c.sort_rows().indices[:int(c.nnz)],
                              r.sort_rows().indices[:int(r.nnz)]),
                  f"{label} member {i}: column sets differ from the loop's")
            self.compare(f"{label} member {i} loop", r.indices, r.data,
                         r.indptr, r.shape, *plain[i], pp[i])
        del loop_outs
        if gather_oracle:
            self.check_dispatch(label, pairs, outs)
        del outs, plain, pp

        vec = None
        if vector_too:
            plan_v = core.plan_batch(pairs, algorithm="hash_vector")
            outs_v, counts = self.counted(lambda: plan_v.execute(pairs))
            self.expect(counts, {"batched_numeric_vector": want(True)},
                        f"{label} plan_batch(hash_vector).execute")
            vec = {"launches": counts["batched_numeric_vector"], "err": 0.0}
            for cls, args, kw in class_args:
                pc, pv = ref.batched_numeric_plain(*args, **kw)
                for e, i in enumerate(cls.members):
                    a, b = pairs[i]
                    c = outs_v[i]
                    vec["err"] = max(vec["err"], self.compare(
                        f"{label} vector member {i}", c.indices, c.data,
                        c.indptr, c.shape, pc[e], pv[e],
                        ref.products_per_entry(a.indptr, b.indptr,
                                               args[4][e], a.indices,
                                               b.indices, cls.cap_c)))
            del outs_v, plan_v

        # ---- timings ------------------------------------------------------
        errors = torch.zeros(1, dtype=torch.int32, device=self.dev)

        # each class's table classes, as the class executors launch them
        classes = [self.fleet_classes(
            f"{label} class {i}", args, cls.n_members, cls.table_size,
            cls.cap_c, False, cls.hash_largest, cls.shape_b[1])
            for i, (cls, args, _) in enumerate(class_args)]

        def kernels(vector):
            for cls, args, kw in class_args:
                K.batched_numeric_call(
                    *args, **{**kw, "vector": vector}, errors=errors,
                    largest=cls.hash_largest)

        def symbolic():
            for cls, args, kw in class_args:
                K.batched_symbolic_call(
                    *args[:4], *args[5:], n_members=cls.n_members,
                    table_size=cls.table_size, vector=False, errors=errors,
                    largest=cls.hash_largest, n_cols=cls.shape_b[1])

        def plain_fleet():
            for cls, args, kw in class_args:
                ref.batched_numeric_plain(*args, **kw)

        sparse = {}

        def sp(x):
            if id(x) not in sparse:
                nnz = int(x.nnz)
                sparse[id(x)] = torch.sparse_csr_tensor(
                    x.indptr.long(), x.indices[:nnz].long(), x.data[:nnz],
                    size=x.shape)
            return sparse[id(x)]

        sp_pairs = [(sp(a), sp(b)) for a, b in pairs]
        t = {"execute": self.time_ms(lambda: plan.execute(pairs)),
             "loop": self.time_ms(loop),
             "kernel": self.time_ms(lambda: kernels(False)),
             "kernel_symbolic": self.time_ms(symbolic),
             "plain": self.time_ms(plain_fleet, reps=3, warm=1),
             "torch_sparse_mm_loop": self.time_ms(
                 lambda: [torch.sparse.mm(x, y) for x, y in sp_pairs])}
        if vector_too:
            t["kernel_vector"] = self.time_ms(lambda: kernels(True))
        b2b = {"kernel": self.stream_ms(lambda: kernels(False))[0],
               "kernel_symbolic": self.stream_ms(symbolic)[0],
               "loop": self.stream_ms(loop)[0]}
        if serve_too:
            t.update(self.serve_times(label, pairs, launches))
        torch.cuda.synchronize()
        check(int(errors) == 0, f"{label}: {int(errors)} kernel errors")

        # least time: every operand read once (an operand shared by a class
        # once), each member's indptr_c read and C written once
        nbytes = 0
        for cls in hash_cls:
            for k, shared in ((0, cls.a_shared), (1, cls.b_shared)):
                ops = [pairs[i][k] for i in cls.members]
                for x in ops[:1] if shared else ops:
                    nbytes += 4 * (x.n_rows + 1) + 8 * int(x.nnz)
        nbytes += sum(4 * (a.n_rows + 1) + 8 * nnz_c for (a, _), nnz_c in
                      zip(pairs, plan.nnz_cs))
        by_bytes = nbytes / HBM_BW * 1e3
        by_ops = 2 * plan.total_flop / FP32_FLOPS * 1e3
        bound = max(by_bytes, by_ops)
        print(json.dumps({
            "timing": f"batch {label}", "card": self.card,
            "products": plan.n_products, "classes": plan.n_classes,
            "algorithms": sorted(set(plan.algorithms)),
            "total_flop": plan.total_flop, "nnz_c": plan.nnz_c,
            "table_sizes": [c.table_size for c in plan.classes],
            "launches": launches, "table_classes": classes, "ms": t,
            "back_to_back_ms": b2b, "bound_ms": bound,
            "bound_bytes": nbytes, "plan_s": plan_s}), flush=True)
        print(f"batch {label}: {plan.n_products} products in "
              f"{plan.n_classes} classes, {launches} batched launches; "
              f"batched execute {t['execute']:.3f} ms, per-product loop "
              f"{t['loop']:.3f} ms, torch.sparse.mm loop "
              f"{t['torch_sparse_mm_loop']:.3f} ms", flush=True)
        for name, ms, n_launch, e in (
                ("batched_numeric", t["kernel"], launches, err),
                ("batched_numeric_vector", t.get("kernel_vector"),
                 vec and vec["launches"], vec and vec["err"])):
            if ms is None:
                continue
            self.rows.append({
                "name": f"spgemm_hash_{name}[{label}]", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": REPLACES["batched"],
                "launches": n_launch, "max_abs_err": e, "ms": ms,
                "plain_ms": t["plain"], "bound_ms": bound,
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                "library_ms": t["torch_sparse_mm_loop"]})
        del plan, loop_plans, class_args, sparse, sp_pairs
        core.clear_plan_cache()
        torch.cuda.empty_cache()

    def check_dispatch(self, label, pairs, outs):
        """Expert e's output holds, row by row, the feature rows of the
        tokens routed to it (G_e's column ids), bitwise."""
        torch = self.torch
        for e, ((g, f), c) in enumerate(zip(pairs, outs)):
            tok = g.indices[:int(g.nnz)].long()
            starts = f.indptr[tok].long()
            lens = f.indptr[tok + 1].long() - starts
            total = int(lens.sum())
            first = torch.cumsum(lens, 0) - lens
            src = torch.repeat_interleave(starts - first, lens,
                                          output_size=total) \
                + torch.arange(total, device=self.dev)
            s = c.sort_rows()
            check(torch.equal((c.indptr[1:] - c.indptr[:-1]).long(), lens)
                  and torch.equal(s.indices[:total], f.indices[src])
                  and torch.equal(s.data[:total], f.data[src]),
                  f"{label}: expert {e}'s rows differ from its gathered "
                  f"feature rows")
        print(f"batch {label}: every expert's dispatched rows equal its "
              f"gathered feature rows", flush=True)

    def batch(self):
        """Phase 12: the batched fleet planner on three fleets."""
        from repro_torch.examples.moe_dispatch_batch import \
            build_dispatch_fleet
        t0 = time.perf_counter()
        pairs, _, _ = build_dispatch_fleet(
            0, n_experts=MOE_EXPERTS, top_k=MOE_TOP_K, tokens=MOE_TOKENS,
            d_model=MOE_D_MODEL, density=MOE_DENSITY, device=self.dev)
        f = pairs[0][1]
        label = (f"MoE dispatch {MOE_EXPERTS} experts top-{MOE_TOP_K} "
                 f"T={MOE_TOKENS} d={MOE_D_MODEL}")
        print(f"{label}: nnz(F)={int(f.nnz)} (built in "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        self.batch_fleet(label, pairs, gather_oracle=True, serve_too=True)
        del pairs, f
        pairs = []
        for i in range(FLEET_PRODUCTS):
            preset = "G500" if i % 2 else "ER"
            a = self.rmat.rmat_csr(FLEET_SCALE, 1 + (i % 3), preset, seed=i,
                                   device=self.dev)
            b = self.rmat.rmat_csr(FLEET_SCALE, 1 + ((i + 1) % 4), "ER",
                                   seed=100 + i, device=self.dev)
            pairs.append((a, b))
        self.batch_fleet(f"rmat_fleet({FLEET_PRODUCTS}, {FLEET_SCALE})",
                         pairs, vector_too=True)
        squares = [self.rmat.rmat_csr(G500_SCALE, EDGE_FACTOR, "G500",
                                      seed=s, device=self.dev)
                   for s in (0, 1)]
        self.batch_fleet(f"G500 s{G500_SCALE} ef{EDGE_FACTOR} squares "
                         f"(seeds 0, 1)", [(a, a) for a in squares])

    # ---- phase 13 ----------------------------------------------------------
    def fleet_values(self, blocks, n, seed, dyadic):
        """``n`` members of new tile values on ``blocks``' pattern, from a
        seeded numpy generator: dyadic, or uniform in [0.5, 1.5)."""
        torch = self.torch
        rng = np.random.default_rng(seed)
        shape = (n,) + tuple(blocks.shape)
        vals = (np.asarray(DYADIC, np.float32)[rng.integers(0, 4, shape)]
                if dyadic else rng.uniform(0.5, 1.5, shape).astype(np.float32))
        return torch.from_numpy(vals).to(self.dev) * (blocks != 0)

    def bcsr_fleet_classes(self, label, args, kw) -> dict:
        """The block kernel's work items of one fleet call by class: one
        call's classifying kernels and class launches issued one by one
        behind a kernel that sleeps 50 M clocks (about 25 ms), each
        bracketed by CUDA events, so that every event pair holds the
        card's time alone (the check that the host issued the whole call
        before the sleep ended); then each class's items, member rows,
        distinct rows and groups (members an item: count of items) from
        the classifier's lists.  The call's output must equal the batched
        call's."""
        torch, BK = self.torch, self.BK
        errors = torch.zeros(1, dtype=torch.int32, device=self.dev)
        call = BK.prepare(*args, **kw, errors=errors)
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(len(call.classes) + 4)]
        marks[0].record()
        torch.cuda._sleep(50_000_000)
        marks[1].record()
        h0 = time.perf_counter()
        BK.classify(call)
        marks[2].record()
        for i, c in enumerate(call.classes):
            BK.launch_class(call, c)
            marks[3 + i].record()
        host_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        sleep_ms = marks[0].elapsed_time(marks[1])
        check(host_ms < sleep_ms, f"{label}: the host took {host_ms:.3f} ms "
              f"to issue the call, past the {sleep_ms:.3f} ms sleep before "
              f"it")
        check(int(errors) == 0, f"{label}: kernel errors in the classed call")
        want = BK.batched_numeric_call(*args, **kw)
        check(torch.equal(call.out_bcol, want[0]) and
              torch.equal(call.out_blk, want[1]),
              f"{label}: the class-by-class call differs from the batched "
              f"call")
        out = {"classify_ms": marks[1].elapsed_time(marks[2]),
               "grouped": call.grouped, "classes": {}}
        items = call.items()
        for i, c in enumerate(call.classes):
            it = items[c].cpu()
            groups = torch.bincount(it[:, 1]) if it.numel() else []
            out["classes"][BK.CLASS_NAMES[c]] = {
                "items": it.shape[0], "member_rows": int(it[:, 1].sum()),
                "rows": int(it[:, 2].unique().numel()),
                "groups": {g: int(k) for g, k in enumerate(groups) if k},
                "ms": marks[2 + i].elapsed_time(marks[3 + i])}
        del call, want
        return out

    def fleet_case(self, label, ab, bp, cases):
        """One value-fleet case of phase 13: ``torch.func.vmap`` of
        ``bp.execute`` over the members' tiles (``cases``: ``(values, xa,
        xb)``, a 4-D stack or A's/B's own tiles), launching the kernel
        through the custom op's rule once -- one classification and one
        launch per class that can hold the fleet's items -- and nothing
        else; each member against the batched plain version and the
        per-member execute; then the timings of the uniform fleet, single
        calls and back to back, and the items and device time of each
        class.  ``ab`` is both operands' structure (the products are
        A·A)."""
        import dataclasses
        torch, core, BK, bref = self.torch, self.core, self.BK, \
            self.bcsr_ref
        vector = bp.vector
        bm, bk = ab.block
        bn = ab.block[1]
        key = "batched_numeric_vector" if vector else "batched_numeric"

        def one(x, y):
            c = bp.execute(dataclasses.replace(ab, blocks=x),
                           dataclasses.replace(ab, blocks=y))
            return c.indices, c.blocks

        def dims(xa, xb):
            return (0 if xa.dim() == 4 else None,
                    0 if xb.dim() == 4 else None)

        def vmapped(xa, xb):
            return torch.func.vmap(one, in_dims=dims(xa, xb))(xa, xb)

        n = max(x.shape[0] for _, xa, xb in cases for x in (xa, xb)
                if x.dim() == 4)
        pairs = bref.products_per_block(ab.indptr, ab.indptr, bp.indptr_cb,
                                        ab.indices, ab.indices, bp.bcap_c)
        bound_ulp = (pairs * bk).float()[:, None, None]
        err, launches = 0.0, None
        for values, xa, xb in cases:
            what = f"{label} ({values})"
            (bcol, blk), counts = self.counted(lambda: vmapped(xa, xb))
            self.expect(counts, {f"bcsr_{key}": 1},
                        f"{what} vmap(BCSRPlan.execute)")
            launched = bref.launch_classes(
                (bm, bk, bn), bp.table_size, bp.bcap_c, n,
                (xa.dim() == 4, xb.dim() == 4))
            want = dict(dict.fromkeys(BK.CLASS_CALLS, 0), classify=1,
                        **{BK.CLASS_NAMES[c]: 1 for c in launched})
            check(self.bcsr_class_counts == want, f"{what}: class launches "
                  f"{self.bcsr_class_counts}, want {want} (one "
                  f"classification, one launch per class that can hold "
                  f"items)")
            launches = counts[f"bcsr_{key}"]
            check(bcol.shape == (n, bp.bcap_c) and
                  blk.shape == (n, bp.bcap_c, bm, bn),
                  f"{what}: output shapes {tuple(bcol.shape)}, "
                  f"{tuple(blk.shape)}")
            args = (bp.offsets, bp.bin_tsize, ab.indptr, ab.indptr,
                    bp.indptr_cb, ab.indices, xa, ab.indices, xb)
            pc, pb = bref.batched_numeric_plain(
                *args, n_members=n, bcap_c=bp.bcap_c,
                table_size=bp.table_size, vector=vector)
            for e in range(n):
                x = xa[e] if xa.dim() == 4 else xa
                y = xb[e] if xb.dim() == 4 else xb
                single = bp.execute(dataclasses.replace(ab, blocks=x),
                                    dataclasses.replace(ab, blocks=y))
                sc, sb = bref.sort_block_rows(bp.indptr_cb, bcol[e], blk[e])
                oc, ob = bref.sort_block_rows(single.indptr, single.indices,
                                              single.blocks)
                for other, oc_, ob_ in (("the batched plain version", pc[e],
                                         pb[e]),
                                        ("the per-member execute", oc, ob)):
                    check(torch.equal(sc, oc_), f"{what} member {e}: block "
                          f"columns differ from {other}")
                    diff = (sb - ob_).abs()
                    if values == "dyadic":
                        check(torch.equal(sb, ob_), f"{what} member {e}: "
                              f"tiles not bitwise equal to {other} (max "
                              f"abs diff {float(diff.max())})")
                        continue
                    ulp = torch.nextafter(ob_.abs(), torch.full_like(
                        ob_, float("inf"))) - ob_.abs()
                    bad = diff > bound_ulp * ulp
                    check(not bool(bad.any()), f"{what} member {e}: "
                          f"{int(bad.sum())} cells past 1 ulp per product "
                          f"against {other} (max abs diff "
                          f"{float(diff.max())})")
                err = max(err, float((sb - pb[e]).abs().max()))
                del single
            del bcol, blk, pc, pb
        print(f"{label}: {n} members, {len(cases)} fleets; every member "
              f"equals the batched plain version and the per-member "
              f"execute; {launches} kernel call a call, class launches "
              f"{self.bcsr_class_counts}; max abs diff {err}", flush=True)

        # ---- timings (the uniform fleet) ---------------------------------
        _, xa, xb = next(c for c in cases if c[0] == "uniform")
        kw = dict(n_members=n, bcap_c=bp.bcap_c, table_size=bp.table_size,
                  vector=vector)
        args = (bp.offsets, bp.bin_tsize, ab.indptr, ab.indptr,
                bp.indptr_cb, ab.indices, xa, ab.indices, xb)
        errors = torch.zeros(1, dtype=torch.int32, device=self.dev)
        members = [(xa[e] if xa.dim() == 4 else xa,
                    xb[e] if xb.dim() == 4 else xb) for e in range(n)]
        m_a = [dataclasses.replace(ab, blocks=x) for x, _ in members]
        m_b = [dataclasses.replace(ab, blocks=y) for _, y in members]

        def sparse(x):
            c = core.bcsr_to_csr(x)
            nnz = int(c.nnz)
            return torch.sparse_csr_tensor(c.indptr.long(),
                                           c.indices[:nnz].long(),
                                           c.data[:nnz], size=c.shape)

        sp_a = [sparse(x) for x in m_a]
        sp_b = [sparse(y) for y in m_b] if xb.dim() == 4 else \
            [sparse(m_b[0])] * n
        t = {"vmap_execute": self.time_ms(lambda: vmapped(xa, xb)),
             "kernel": self.time_ms(lambda: BK.batched_numeric_call(
                 *args, **kw, errors=errors)),
             "loop": self.time_ms(lambda: [bp.execute(x, y) for x, y in
                                           zip(m_a, m_b)]),
             "plain": self.time_ms(lambda: bref.batched_numeric_plain(
                 *args, **kw), reps=3, warm=1),
             "torch_sparse_mm_loop": self.time_ms(
                 lambda: [torch.sparse.mm(x, y) for x, y in
                          zip(sp_a, sp_b)])}
        # the card's time a call: 20 calls back to back in one event pair
        b2b, host = {}, {}
        for name, fn in (("kernel", lambda: BK.batched_numeric_call(
                *args, **kw, errors=errors)),
                         ("vmap_execute", lambda: vmapped(xa, xb))):
            b2b[name], host[name] = self.stream_ms(fn)
        t["kernel_device"] = self.device_ms(lambda: BK.batched_numeric_call(
            *args, **kw, errors=errors), "bcsr_class_kernel")
        classes = self.bcsr_fleet_classes(label, args, kw)
        torch.cuda.synchronize()
        check(int(errors) == 0, f"{label}: kernel errors while timing")
        # least time: each member's A tiles (A once when shared), B's
        # likewise, each member's C tiles and block columns written once,
        # the shared structure read once
        gm = ab.indptr.shape[0] - 1
        nnzb = int(ab.nnzb)
        n_a = n if xa.dim() == 4 else 1
        n_b = n if xb.dim() == 4 else 1
        by = (4 * bm * bk * nnzb * n_a + 4 * bk * bn * nnzb * n_b
              + n * (4 * bm * bn + 4) * bp.nnzb_c
              + 4 * (3 * (gm + 1) + 2 * nnzb))
        ops_n = n * 2 * bp.total_flop * bm * bk * bn
        bound = max(by / HBM_BW, ops_n / FP32_FLOPS) * 1e3
        bound_by = "bytes" if by / HBM_BW >= \
            ops_n / FP32_FLOPS else "operations"
        print(json.dumps({"timing": f"value fleet {label}",
                          "card": self.card, "members": n,
                          "batched": {"a": n_a > 1, "b": n_b > 1},
                          "vector": vector, "nnzb_a": nnzb,
                          "nnzb_c": bp.nnzb_c, "block_flop": bp.total_flop,
                          "table_size": bp.table_size,
                          "launches": launches,
                          "class_launches": self.bcsr_class_counts,
                          "ms": t, "back_to_back_ms": b2b,
                          "host_ms_to_issue": host, "classes": classes,
                          "bound_ms": bound, "bound_bytes": by,
                          "bound_operations": ops_n}),
              flush=True)
        self.rows.append({
            "name": f"spgemm_bcsr_{key}[{label}]", "route": "cuda",
            "source": BCSR_SOURCE, "replaces": REPLACES["bcsr_batched"],
            "launches": launches, "max_abs_err": err, "ms": t["kernel"],
            "back_to_back_ms": b2b["kernel"], "plain_ms": t["plain"],
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": t["torch_sparse_mm_loop"]})
        del sp_a, sp_b, m_a, m_b, members
        torch.cuda.empty_cache()

    def value_fleet(self):
        """Phase 13: ``torch.func.vmap`` of ``BCSRPlan.execute`` over
        fleets of block values on one frozen structure (DBCSR's repeated
        products), on phase 7's block inputs and phase 11's 64x64 tiles."""
        torch, core = self.torch, self.core

        def fleets(ab, n, seed, b_too=False):
            """A dyadic and a uniform fleet of ``n`` members on ``ab``'s
            pattern, as ``(values, A's tiles, B's tiles)``: B's are
            ``ab``'s own (shared) unless ``b_too``."""
            out = []
            for i, values in enumerate(("dyadic", "uniform")):
                d = values == "dyadic"
                xb = self.fleet_values(ab.blocks, n, seed + 10 + i, d) \
                    if b_too else ab.blocks
                out.append((values,
                            self.fleet_values(ab.blocks, n, seed + i, d), xb))
            return out

        for preset, scale, ef in BCSR_INPUTS:
            br, bc = self.rmat.rmat_edges(scale, ef, preset, seed=0)
            # dyadic tiles: a fleet of dyadic members against them is exact
            _, a_d, _ = self.block_csr(br, bc, 1 << scale, seed=1)
            ab = core.csr_to_bcsr(a_d, BLOCK)
            del a_d
            label = f"{preset}-pattern s{scale} ef{ef} {BLOCK[0]}x{BLOCK[1]}"
            bp, counts = self.counted(lambda: core.plan_bcsr(ab, ab,
                                                             cache=False))
            self.expect(counts, {"symbolic": 1, "bcsr_symbolic": 1},
                        f"{label} fleet plan_bcsr")
            if preset == "ER":
                n, m = FLEET_MEMBERS, FLEET_MEMBERS_BOTH
                self.fleet_case(f"{label}, {n} members, A batched", ab, bp,
                                fleets(ab, n, 20))
                self.fleet_case(f"{label}, {m} members, A and B batched", ab,
                                bp, fleets(ab, m, 30, b_too=True))
                vp = core.plan_bcsr(ab, ab, vector=True, cache=False)
                self.fleet_case(f"{label}, {n} members, A batched, vector",
                                ab, vp, fleets(ab, n, 50))
                del vp
            else:
                m = FLEET_MEMBERS_G500
                self.fleet_case(f"{label}, {m} members, A batched", ab, bp,
                                fleets(ab, m, 60))
            del ab, bp
            torch.cuda.empty_cache()
        rng = np.random.default_rng(9)
        occ = np.nonzero(rng.random((LARGE_GRID, LARGE_GRID)) < 0.5)
        _, a_d, _ = self.block_csr(occ[0], occ[1], LARGE_GRID, seed=10,
                                   block=LARGE_BLOCK)
        ab = core.csr_to_bcsr(a_d, LARGE_BLOCK)
        bp = core.plan_bcsr(ab, ab, cache=False)
        m = FLEET_MEMBERS_LARGE
        self.fleet_case(f"{LARGE_GRID}x{LARGE_GRID} grid of {LARGE_BLOCK[0]}x"
                        f"{LARGE_BLOCK[1]} tiles, {m} members, A batched", ab,
                        bp, fleets(ab, m, 70))

    # ---- phase 17 ----------------------------------------------------------
    @staticmethod
    def bf16_ulp(x):
        """One bfloat16 ulp at each value of ``x`` (float32 of bf16s)."""
        _, e = x.float().abs().frexp()
        return (e.float() - 8).exp2()

    def flash_inputs(self, b, sq, skv, dtype, seed):
        torch = self.torch
        g = torch.Generator(self.dev).manual_seed(seed)
        return [torch.randn(s, generator=g, device=self.dev).to(dtype)
                for s in ((b, LM_HEADS, sq, LM_HEAD_DIM),
                          (b, LM_KV_HEADS, skv, LM_HEAD_DIM),
                          (b, LM_KV_HEADS, skv, LM_HEAD_DIM))]

    def flash_kernel(self):
        """Phase 17: the flash kernels at qwen3-0.6b's widths against their
        plain version (float32 through the CUDA-core kernel within
        FLASH_F32_TOL; bfloat16 through the tensor-core kernel within one
        bf16 ulp of the plain output plus FLASH_F32_TOL: each rounds its
        own float32 sum, and those may differ by FLASH_F32_TOL), each
        launch on the kernel ``FK.variant`` names, then CUDA-event medians
        beside the plain version, ``scaled_dot_product_attention`` (a
        yardstick only, never on the path) and the bound.  Returns the
        rows' numbers by length."""
        torch, FK, ref = self.torch, self.FK, self.fa_ref
        F = torch.nn.functional
        scale = LM_HEAD_DIM ** -0.5
        for line in FK.build()["wgmma"]["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "setmaxnreg" in \
                    line:
                print("phase 17: tensor-core kernel ptxas:", line.strip(),
                      flush=True)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            kind = FK.variant(dtype, LM_HEAD_DIM)
            for i, (b, sq, skv, causal) in enumerate(FLASH_CHECKS):
                q, k, v = self.flash_inputs(b, sq, skv, dtype, 100 + i)
                self.fa_ops.reset_kernel_calls()
                got = FK.flash_fwd(q, k, v, scale=scale, causal=causal)
                variants = self.fa_ops.variant_call_counts()
                want = ref.flash_attention_plain(q, k, v, causal=causal,
                                                 scale=scale)
                torch.cuda.synchronize()
                what = (f"flash {str(dtype)[6:]} B {b} Sq {sq} Skv {skv} "
                        f"causal {causal}")
                check(variants == {"wgmma": int(kind == "wgmma"),
                                   "fma": int(kind == "fma")},
                      f"{what}: launched {variants}, want one {kind}")
                check(got.shape == want.shape and got.dtype == dtype and
                      bool(torch.isfinite(got).all()),
                      f"{what}: shape, dtype or non-finite values")
                d = (got.float() - want.float()).abs()
                err = float(d.max())
                if dtype == torch.float32:
                    check(err <= FLASH_F32_TOL, f"{what}: max abs diff "
                          f"{err} > {FLASH_F32_TOL} against the plain "
                          f"version")
                else:
                    bad = int((d > self.bf16_ulp(want) + FLASH_F32_TOL)
                              .sum())
                    check(bad == 0, f"{what}: {bad} values past one bf16 "
                          f"ulp (+ {FLASH_F32_TOL}) of the plain version "
                          f"(max abs diff {err})")
                errs[(dtype, sq)] = err
                print(f"phase 17: {what}: {kind} kernel, max abs diff "
                      f"{err:.3g} to the plain version", flush=True)
                del q, k, v, got, want, d
        torch.cuda.empty_cache()

        rows = {}
        for s in FLASH_TIMED:
            q, k, v = self.flash_inputs(1, s, s, torch.bfloat16, 200 + s)
            t = {"kernel": self.time_ms(lambda: FK.flash_fwd(
                q, k, v, scale=scale, causal=True))}
            out = FK.flash_fwd(q, k, v, scale=scale, causal=True)
            if any(c[1] == s and c[3] for c in FLASH_CHECKS):
                t["plain"] = self.time_ms(
                    lambda: ref.flash_attention_plain(q, k, v, causal=True,
                                                      scale=scale),
                    reps=3, warm=1)
                err = errs[(torch.bfloat16, s)]
            else:
                # the score panel of all heads at once does not fit: the
                # plain version head by head is the check, timed as a loop
                def plain_heads():
                    g = LM_HEADS // LM_KV_HEADS
                    return torch.cat([ref.flash_attention_plain(
                        q[:, h:h + 1], k[:, h // g:h // g + 1],
                        v[:, h // g:h // g + 1], causal=True, scale=scale)
                        for h in range(LM_HEADS)], dim=1)
                want = plain_heads()
                d = (out.float() - want.float()).abs()
                bad = int((d > self.bf16_ulp(want) + FLASH_F32_TOL).sum())
                err = float(d.max())
                check(bad == 0, f"flash bf16 S {s}: {bad} values past one "
                      f"bf16 ulp (+ {FLASH_F32_TOL}) of the plain version, "
                      f"head by head (max abs diff {err})")
                print(f"phase 17: flash bf16 B 1 S {s} causal: max abs diff "
                      f"{err:.3g} to the plain version head by head",
                      flush=True)
                del want, d
                t["plain_heads"] = self.time_ms(plain_heads, reps=1, warm=0)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
            t["sdpa"] = self.time_ms(lib)
            lib_diff = float((lib().float() - out.float()).abs().max())
            if s == FLASH_TIMED[0]:
                # the float32 path, the CUDA-core kernel, for the record
                q32, k32, v32 = (x.float() for x in (q, k, v))
                t["kernel_f32_fma"] = self.time_ms(lambda: FK.flash_fwd(
                    q32, k32, v32, scale=scale, causal=True))
                del q32, k32, v32
            ops = 4 * LM_HEADS * LM_HEAD_DIM * s * (s + 1) / 2
            by = (q.numel() + k.numel() + v.numel() + out.numel()) * 2
            bound = max(ops / BF16_FLOPS, by / HBM_BW) * 1e3
            bound_by = "operations" if ops / BF16_FLOPS >= \
                by / HBM_BW else "bytes"
            print(json.dumps({
                "timing": f"flash_fwd bf16 B 1 H {LM_HEADS} Hkv "
                f"{LM_KV_HEADS} D {LM_HEAD_DIM} S {s} causal",
                "card": self.card, "ms": t, "bound_ms": bound,
                "bound_by": bound_by, "tflop_per_s": ops / t["kernel"] / 1e9,
                # P V runs twice (P_hi and P_lo): 1.5x the least operations
                "tflop_per_s_performed": 1.5 * ops / t["kernel"] / 1e9,
                "sdpa_tflop_per_s": ops / t["sdpa"] / 1e9,
                "sdpa_max_abs_diff": lib_diff}), flush=True)
            rows[s] = {"ms": t["kernel"],
                       "plain_ms": t.get("plain", t.get("plain_heads")),
                       "bound_ms": bound, "bound_by": bound_by,
                       "library_ms": t["sdpa"], "max_abs_err": err}
            del q, k, v, out
            torch.cuda.empty_cache()
        return rows

    # ---- phase 18 ----------------------------------------------------------
    def serve(self, flash_rows):
        """Phase 18: serve qwen3-0.6b at full width (random weights from a
        seeded generator, bf16) through ``Engine``: 9 requests, every
        admission launching the tensor-core flash kernel once per layer
        and the plain version never, decode launching neither; then the
        float32 and bf16 prefill logits of "flash" against "full", and a
        float32 copy's greedy decode against re-prefill.  Adds the flash
        kernel's rows."""
        import dataclasses
        torch = self.torch
        from repro_torch.configs import get
        from repro_torch.models import transformer as T
        from repro_torch.parallel.sharding import single_device_ctx
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"phase 18: torch {torch.__version__} (CUDA "
              f"{torch.version.cuda}); matmul allow_tf32 "
              f"{torch.backends.cuda.matmul.allow_tf32}, cudnn allow_tf32 "
              f"{torch.backends.cudnn.allow_tf32}", flush=True)
        cfg = get(LM_ARCH)
        check((cfg.n_heads, cfg.n_kv_heads, cfg.hd) ==
              (LM_HEADS, LM_KV_HEADS, LM_HEAD_DIM), f"{LM_ARCH} widths")
        t0 = time.perf_counter()
        model = T.init_params(torch.Generator(self.dev).manual_seed(0), cfg)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == cfg.param_count(), f"{LM_ARCH}: {n_params} "
              f"parameters, the config counts {cfg.param_count()}")
        print(f"phase 18: {LM_ARCH} at full width ({cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab_size}): {n_params} "
              f"float32 parameters from seed 0 in "
              f"{time.perf_counter() - t0:.1f} s; compute {cfg.dtype}",
              flush=True)
        pctx = single_device_ctx(attn_impl="flash")
        prompts = self.serve_prompts(cfg, model, pctx, SERVE_LONG)
        counts, timing = self.serve_run(cfg, model, pctx, prompts, "flash",
                                        "flash_fwd", "flash_ms", "phase 18",
                                        variant="wgmma")
        print(json.dumps({"timing": f"{LM_ARCH} serving", "card": self.card,
                          **timing}), flush=True)
        long = timing[f"prefill_{SERVE_LONG[-1]}"]
        if long["device_busy_ms"]:
            print(f"phase 18: {SERVE_LONG[-1]}-token prefill: host "
                  f"{long['host_ms']:.2f} ms, device busy "
                  f"{long['device_busy_ms']:.2f} ms, flash kernels "
                  f"{long['flash_ms']:.3f} ms "
                  f"({long['flash_ms'] / long['device_busy_ms']:.1%} of "
                  f"the device time)", flush=True)

        # prefill logits, the flash kernel against exact softmax: at float32
        # (the check that the kernel is wired in right) and at bf16 (each
        # path's distance from the float32 logits)
        full = single_device_ctx(attn_impl="full")
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        for p in (prompts[0], *prompts[SERVE_SHORT:]):
            tok = torch.from_numpy(p[None]).long().to(self.dev)
            f32 = T.prefill(model, tok, cfg32, pctx)[0]
            r32 = T.prefill(model, tok, cfg32, full)[0]
            rel = float((f32 - r32).norm() / r32.norm())
            check(bool(torch.isfinite(f32).all()) and
                  rel <= SERVE_F32_FLASH_REL,
                  f"phase 18: float32 prefill logits of a {p.shape[0]}-token "
                  f"prompt, flash against full: relative L2 {rel} > "
                  f"{SERVE_F32_FLASH_REL}")
            lf = T.prefill(model, tok, cfg, pctx)[0].float()
            lr = T.prefill(model, tok, cfg, full)[0].float()
            rel16 = [float((x - r32).norm() / r32.norm()) for x in (lf, lr)]
            check(bool(torch.isfinite(lf).all()) and
                  rel16[0] <= SERVE_BF16_RATIO * rel16[1],
                  f"phase 18: bf16 prefill logits of a {p.shape[0]}-token "
                  f"prompt: flash is {rel16[0]} from the float32 logits, "
                  f"more than {SERVE_BF16_RATIO} x full's {rel16[1]}")
            same = "equal" if int(lf.argmax()) == int(lr.argmax()) \
                else "differs"
            print(f"phase 18: prefill logits, {p.shape[0]} tokens: float32 "
                  f"flash vs full relative L2 {rel:.3g}, max abs diff "
                  f"{float((f32 - r32).abs().max()):.3g} (largest |logit| "
                  f"{float(r32.abs().max()):.3g}); bf16 flash vs full "
                  f"relative L2 {float((lf - lr).norm() / lr.norm()):.3g}, "
                  f"argmax {same}; bf16 against float32: flash "
                  f"{rel16[0]:.3g}, full {rel16[1]:.3g}", flush=True)
        torch.cuda.empty_cache()

        # float32 copy: greedy decode equals re-prefill (tests/test_serve.py)
        self.greedy_equals_reprefill(model, cfg32, pctx, "phase 18")
        del model
        torch.cuda.empty_cache()

        for s, row in flash_rows.items():
            self.rows.append({
                "name": f"flash_fwd[bf16 S{s}]", "route": "cuda",
                "source": FLASH_WGMMA_SOURCE,
                "replaces": REPLACES["flash_fwd"], "variant": "wgmma",
                "launches": counts["flash_flash_fwd"],
                "launches_per_admission": cfg.n_layers, **row})

    def serve_prompts(self, cfg, model, pctx, longs) -> list:
        """SERVE_SHORT prompts drawn as ``launch/serve.py`` draws them
        (seed 0, 4-23 tokens) and one of each length in ``longs``; then one
        short prefill as a warm-up (cuBLAS handles, the allocator)."""
        torch = self.torch
        from repro_torch.models import transformer as T
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size,
                                size=(int(rng.integers(4, 24)),))
                   .astype(np.int32) for _ in range(SERVE_SHORT)]
        prompts += [rng.integers(0, cfg.vocab_size, size=(n,))
                    .astype(np.int32) for n in longs]
        T.prefill(model, torch.from_numpy(prompts[0][None]).long()
                  .to(self.dev), cfg, pctx)
        torch.cuda.synchronize()
        return prompts

    def serve_run(self, cfg, model, pctx, prompts, prefix: str, key: str,
                  ms_name: str, phase: str, variant: str | None = None):
        """Serve ``prompts`` (SERVE_NEW new tokens each) through
        ``Engine(max_batch=SERVE_BATCH, max_len=SERVE_MAX_LEN)`` between a
        reset and a read of every launch counter: each admission launches
        the kernel ``key`` (counters under ``prefix``, as :meth:`counted`
        names them) once per layer and its plain version never, a decode
        step neither, nothing else runs, and every request finishes; with
        ``variant``, every launch of an admission ran that kernel variant
        (the ops module's ``variant_call_counts``).  Then the device's busy
        share of
        a decode step at batch SERVE_BATCH and of a prefill of the last
        prompt (``ms_name``: the kernel's own device ms).  Returns (counts,
        timing)."""
        torch = self.torch
        from repro_torch.models import transformer as T
        from repro_torch.serve import Engine, Request
        ops_mod = {"flash": self.fa_ops, "ssd": self.ssd_ops}[prefix]
        eng = Engine(cfg, model, pctx, max_batch=SERVE_BATCH,
                     max_len=SERVE_MAX_LEN, device=self.dev)
        prefills, decodes = [], []
        inner_prefill, inner_decode = eng._prefill, eng._decode

        def snapshot():
            c = ops_mod.kernel_call_counts()
            if variant is not None:
                c.update(ops_mod.variant_call_counts())
            return c

        def timed(inner, log, what):
            def call(*args):
                before = snapshot()
                t0 = time.perf_counter()
                out = inner(*args)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                after = snapshot()
                log.append((args[1].shape[1] if what == "prefill"
                            else eng.active(), ms,
                            {k: after[k] - before[k] for k in after}))
                return out
            return call
        eng._prefill = timed(inner_prefill, prefills, "prefill")
        eng._decode = timed(inner_decode, decodes, "decode")
        for r, p in enumerate(prompts):
            eng.add_request(Request(rid=r, prompt=p,
                                    max_new_tokens=SERVE_NEW))
        t0 = time.perf_counter()
        done, counts = self.counted(eng.run_to_completion)
        wall = time.perf_counter() - t0
        n_tok = sum(len(d.out_tokens) for d in done)
        self.expect(counts, {f"{prefix}_{key}": cfg.n_layers * len(prompts)},
                    f"{phase} {cfg.name} serving")
        per_admission = {key: cfg.n_layers, "plain": 0}
        if variant is not None:
            per_admission.update({v: cfg.n_layers if v == variant else 0
                                  for v in ops_mod.variant_call_counts()})
        for n, _, c in prefills:
            check(c == per_admission,
                  f"{phase}: the admission of a {n}-token prompt launched "
                  f"{c}, want {per_admission}")
        for _, _, c in decodes:
            check(not any(c.values()),
                  f"{phase}: a decode step launched {c}")
        check(sorted(d.rid for d in done) == list(range(len(prompts))),
              f"{phase}: finished {sorted(d.rid for d in done)}")
        for d in done:
            toks = np.asarray(d.out_tokens)
            check(len(d.out_tokens) == SERVE_NEW and
                  bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                  f"{phase}: request {d.rid} gave {len(d.out_tokens)} "
                  f"tokens (want {SERVE_NEW}) or ids past the vocabulary")
        dec4 = sorted(ms for b, ms, _ in decodes if b == SERVE_BATCH)
        check(bool(dec4), f"{phase}: no decode step at batch {SERVE_BATCH}")
        timing = {
            "prefill_ms": [[n, ms] for n, ms, _ in prefills],
            "decode_ms_batch4_median": dec4[len(dec4) // 2],
            "decode_steps": len(decodes), "tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall}
        print(f"{phase}: served {len(done)} requests, {n_tok} tokens; "
              f"{cfg.n_layers} {key} launches per admission"
              + (f", all on the {variant} kernel" if variant else "")
              + f", none per decode step ({counts[f'{prefix}_{key}']} in "
              f"all)", flush=True)
        del eng
        # where a call's time goes: the device's busy share of the host time
        caches = T.init_caches(cfg, SERVE_BATCH, SERVE_MAX_LEN,
                               torch.bfloat16, self.dev)
        tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.long,
                          device=self.dev)
        n_long = prompts[-1].shape[0]
        pos = torch.full((SERVE_BATCH,), n_long, device=self.dev)
        long_tok = torch.from_numpy(prompts[-1][None]).long().to(self.dev)
        for name, fn in (
                ("decode_batch4", lambda: T.decode_step(
                    model, tok, caches, pos, cfg, pctx)),
                (f"prefill_{n_long}", lambda: T.prefill(
                    model, long_tok, cfg, pctx))):
            host, busy, n_k, named = self.busy_ms(fn, key)
            timing[name] = {"host_ms": host, "device_busy_ms": busy,
                            "device_events": n_k, ms_name: named,
                            "device_idle_share": None if busy is None
                            else 1 - busy / host}
        del caches
        torch.cuda.empty_cache()
        return counts, timing

    def greedy_equals_reprefill(self, model, cfg32, pctx, phase: str):
        """A float32 copy's greedy decode of 4 tokens after a 6-token prompt
        equals re-prefill (``tests/test_serve.py``): each token the
        re-prefill's argmax where its top-2 gap passes the tolerance
        (SERVE_F32_REL of the largest |logit|), else the logits within it."""
        torch = self.torch
        from repro_torch.models import transformer as T
        from repro_torch.serve import Engine, Request
        eng = Engine(cfg32, model, pctx, max_batch=2, max_len=64,
                     device=self.dev)
        seen = []
        inner_prefill, inner_decode = eng._prefill, eng._decode

        def keep(inner):
            def call(*args):
                out = inner(*args)
                seen.append(out[0][0, 0].float().clone())
                return out
            return call
        eng._prefill, eng._decode = keep(inner_prefill), keep(inner_decode)
        prompt = np.random.default_rng(1).integers(
            0, cfg32.vocab_size, size=(6,)).astype(np.int32)
        eng.add_request(Request(rid=0, prompt=prompt, max_new_tokens=4))
        out = [int(t) for t in eng.run_to_completion()[0].out_tokens]
        seq, notes = list(prompt), []
        for i, t in enumerate(out):
            ref, _ = T.prefill(model, torch.tensor([seq], device=self.dev),
                               cfg32, pctx)
            ref = ref[0, 0].float()
            tol = SERVE_F32_REL * float(ref.abs().max())
            top2 = ref.topk(2).values
            gap = float(top2[0] - top2[1])
            diff = float((seen[i] - ref).abs().max())
            if gap > tol:
                check(t == int(ref.argmax()), f"{phase}: float32 greedy "
                      f"token {i} is {t}, re-prefill gives "
                      f"{int(ref.argmax())} (top-2 gap {gap})")
                notes.append(f"token {i} equal (gap {gap:.3g}, logits "
                             f"max abs diff {diff:.3g})")
            else:
                check(diff <= tol, f"{phase}: float32 logits at token {i} "
                      f"differ by {diff} > {tol} (top-2 gap {gap} under "
                      f"the tolerance)")
                notes.append(f"token {i}: top-2 gap {gap:.3g} under "
                             f"{tol:.3g}, logits compared instead "
                             f"(max abs diff {diff:.3g})")
            seq.append(t)
        print(f"{phase}: float32 {cfg32.name} greedy decode equals "
              f"re-prefill over {len(out)} tokens (tolerance "
              f"{SERVE_F32_REL} of the largest |logit|): "
              + "; ".join(notes), flush=True)
        del eng

    # ---- phase 19 ----------------------------------------------------------
    def ssd_tol(self, la, chunk, values) -> float:
        """Phase 19's tolerance for ``values`` (float32): (SSD_REL + 8
        float32 ulps of the largest |cumsum of log_a| over a chunk) x
        max(1, max |values|): each cum_i - cum_j carries a few ulps of
        |cum| from two cumsums taken in another order."""
        b, s, nh = la.shape
        cum = float(-la.reshape(b, s // chunk, chunk, nh).sum(2).min())
        return (SSD_REL + 8 * self.torch.finfo(self.torch.float32).eps
                * cum) * max(1.0, float(values.float().abs().max()))

    def ssd_inputs(self, b, s, g, dtype, seed):
        """xd, log_a, B, C at mamba2-780m's SSD widths: x ~ N(0, 1), dt =
        softplus(N(0, 1)), A the config's span exp(log linspace(1, 16)),
        log_a = -dt A, xd = x dt, B and C ~ N(0, 1)."""
        torch = self.torch
        gen = torch.Generator(self.dev).manual_seed(seed)
        dt = torch.nn.functional.softplus(torch.randn(
            (b, s, SSD_HEADS), generator=gen, device=self.dev))
        A = torch.linspace(1.0, 16.0, SSD_HEADS, device=self.dev)
        x = torch.randn((b, s, SSD_HEADS, SSD_HEAD_DIM), generator=gen,
                        device=self.dev)
        Bm, Cm = (torch.randn((b, s, g, SSD_STATE), generator=gen,
                              device=self.dev).to(dtype) for _ in range(2))
        return (x * dt[..., None]).to(dtype), -dt * A, Bm, Cm

    def ssd_kernel(self):
        """Phase 19: the SSD chunk kernels at mamba2-780m's widths against
        their plain version, each case on the kernel ``SSDK.variant`` names
        (float32 on the CUDA-core kernel, within ``ssd_tol``; bfloat16 on
        the tensor-core kernel, within one bf16 ulp of the plain output
        plus that), the variant counters checked; the tensor-core kernel's
        passes one by one against ``ref.py``'s plain passes (phase 19b);
        then at each timed length two calls bitwise equal, CUDA-event
        medians of a single call, the card's time a call back to back, each
        pass's device time, the plain version and the bound.  Returns the
        rows' numbers by length."""
        torch, SSDK, ref = self.torch, self.SSDK, self.ssd_ref
        from repro_torch.models.ssm import _pick_chunk
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            want = "tc" if dtype == torch.bfloat16 else "fma"
            for i, (b, s, g) in enumerate(SSD_CHECKS):
                q = _pick_chunk(s, SSD_CHUNK)
                xd, la, Bm, Cm = self.ssd_inputs(b, s, g, dtype, 300 + i)
                self.ssd_ops.reset_kernel_calls()
                y, hT = SSDK.ssd_fwd(xd, la, Bm, Cm, q)
                yw, hw = ref.ssd_chunked(xd, la, Bm, Cm, q)
                hw = hw.transpose(-1, -2)
                torch.cuda.synchronize()
                what = f"ssd_chunk {str(dtype)[6:]} B {b} S {s} g {g} Q {q}"
                variants = self.ssd_ops.variant_call_counts()
                check(variants == {"tc": int(want == "tc"),
                                   "fma": int(want == "fma")},
                      f"{what}: launched {variants}, want one {want}")
                check(y.shape == yw.shape and y.dtype == dtype and
                      hT.shape == hw.shape and
                      bool(torch.isfinite(y).all()) and
                      bool(torch.isfinite(hT).all()),
                      f"{what}: shape, dtype or non-finite values")
                tol = self.ssd_tol(la, q, yw)
                d = (y.float() - yw.float()).abs()
                err = float(d.max())
                if dtype == torch.float32:
                    check(err <= tol, f"{what}: y max abs diff {err} > "
                          f"{tol} against the plain version")
                else:
                    bad = int((d > self.bf16_ulp(yw) + tol).sum())
                    check(bad == 0, f"{what}: {bad} values of y past one "
                          f"bf16 ulp (+ {tol}) of the plain version (max "
                          f"abs diff {err})")
                herr = float((hT - hw).abs().max())
                check(herr <= self.ssd_tol(la, q, hw), f"{what}: final "
                      f"state max abs diff {herr} against the plain version")
                errs[(dtype, s, b, g)] = err
                print(f"phase 19: {what} ({want} kernel): max abs diff "
                      f"{err:.3g} (y, tolerance {tol:.3g}), {herr:.3g} "
                      f"(final state) to the plain version", flush=True)
                del xd, la, Bm, Cm, y, hT, yw, hw, d
        torch.cuda.empty_cache()
        self.ssd_passes()

        rows = {}
        for s in SSD_TIMED:
            q = _pick_chunk(s, SSD_CHUNK)
            xd, la, Bm, Cm = self.ssd_inputs(1, s, 1, torch.bfloat16,
                                             400 + s)
            check(SSDK.variant(xd, Bm, Cm) == "tc",
                  f"ssd_chunk bf16 S {s}: not on the tensor-core kernel")

            def call():
                return SSDK.ssd_fwd(xd, la, Bm, Cm, q)
            y, hT = call()
            y2, h2 = call()
            torch.cuda.synchronize()
            check(torch.equal(y, y2) and torch.equal(hT, h2),
                  f"ssd_chunk bf16 S {s}: two calls differ")
            del y2, h2
            t = {"kernel": self.time_ms(call)}
            t["kernel_back_to_back"], t["kernel_host"] = self.stream_ms(call)
            passes = {name: self.device_ms(call, f"ssd_chunk_{kname}")
                      for name, kname in (("a", "states"), ("b", "pass"),
                                          ("c", "output"))}
            if (torch.bfloat16, s, 1, 1) in errs:
                err = errs[(torch.bfloat16, s, 1, 1)]
            else:
                yw, _ = ref.ssd_chunked(xd, la, Bm, Cm, q)
                tol = self.ssd_tol(la, q, yw)
                d = (y.float() - yw.float()).abs()
                bad = int((d > self.bf16_ulp(yw) + tol).sum())
                err = float(d.max())
                check(bad == 0, f"ssd_chunk bf16 S {s}: {bad} values past "
                      f"one bf16 ulp (+ {tol}) of the plain version (max "
                      f"abs diff {err})")
                print(f"phase 19: ssd_chunk bf16 B 1 S {s} Q {q} (tc "
                      f"kernel): max abs diff {err:.3g} to the plain "
                      f"version", flush=True)
                del yw, d
            t["plain"] = self.time_ms(
                lambda: ref.ssd_chunked(xd, la, Bm, Cm, q), reps=3, warm=1)
            nc, tri = s // q, q * (q + 1) / 2
            ops = 2 * nc * (tri * SSD_STATE + SSD_HEADS * (
                tri * SSD_HEAD_DIM + 2 * q * SSD_STATE * SSD_HEAD_DIM))
            by = (2 * xd.numel() + Bm.numel() + Cm.numel()) * 2 \
                + (la.numel() + hT.numel()) * 4
            bound = max(ops / BF16_FLOPS, by / HBM_BW) * 1e3
            bound_by = "operations" if ops / BF16_FLOPS >= \
                by / HBM_BW else "bytes"
            print(json.dumps({
                "timing": f"ssd_chunk bf16 B 1 nh {SSD_HEADS} hp "
                f"{SSD_HEAD_DIM} g 1 n {SSD_STATE} S {s} Q {q}",
                "card": self.card, "variant": "tc", "ms": t,
                "passes_device_ms": passes, "bound_ms": bound,
                "bound_by": bound_by, "ops": ops, "bytes": by,
                "gflop_per_s": ops / t["kernel"] / 1e6,
                "gflop_per_s_back_to_back":
                    ops / t["kernel_back_to_back"] / 1e6}), flush=True)
            rows[s] = {"ms": t["kernel"],
                       "ms_back_to_back": t["kernel_back_to_back"],
                       "plain_ms": t["plain"],
                       "bound_ms": bound, "bound_by": bound_by,
                       "library_ms": None, "max_abs_err": err}
            del xd, la, Bm, Cm, y, hT
            torch.cuda.empty_cache()
        return rows

    def ssd_passes(self):
        """Phase 19b: the tensor-core kernel's passes one by one
        (``SSDK.tc_passes``) against ``ref.py``'s plain passes on the same
        inputs, bf16 at mamba2-780m's widths, S 4,096 and 1,000 (chunks of
        250): (a)'s cumsum within 8 float32 ulps of its largest |value|
        and chunk states within ``ssd_tol``, (b)'s entering states (the
        bf16 hi + lo pair) and last state within ``ssd_tol``, (c)'s output
        within one bf16 ulp plus ``ssd_tol`` of the plain pass fed the
        kernel's cumsum and the plain entering states."""
        torch, SSDK, ref = self.torch, self.SSDK, self.ssd_ref
        from repro_torch.models.ssm import _pick_chunk
        eps = torch.finfo(torch.float32).eps
        for s in (4096, 1000):
            q = _pick_chunk(s, SSD_CHUNK)
            xd, la, Bm, Cm = self.ssd_inputs(1, s, 1, torch.bfloat16, 500 + s)
            what = f"phase 19b: tc passes S {s} Q {q}"
            got = SSDK.tc_passes(xd, la, Bm, Cm, q, passes=1)
            cum = ref.chunk_cumsum(la, q)
            cerr = float((got["cum"] - cum).abs().max())
            check(cerr <= 8 * eps * float(cum.abs().max()),
                  f"{what}: cumsum max abs diff {cerr}")
            S = ref.chunk_states(xd, got["cum"], Bm, q)
            serr = float((got["states"] - S).abs().max())
            check(serr <= self.ssd_tol(la, q, S),
                  f"{what}: (a) chunk states max abs diff {serr}")
            got = SSDK.tc_passes(xd, la, Bm, Cm, q, passes=3)
            entering, h = ref.pass_states(S, got["cum"], q)
            eerr = float((SSDK.states_entering(got["states"]) - entering)
                         .abs().max())
            herr = float((got["hT"] - h.transpose(-1, -2)).abs().max())
            check(eerr <= self.ssd_tol(la, q, entering) and
                  herr <= self.ssd_tol(la, q, h),
                  f"{what}: (b) entering states max abs diff {eerr}, last "
                  f"state {herr}")
            got = SSDK.tc_passes(xd, la, Bm, Cm, q)
            yw = ref.chunk_output(xd, got["cum"], Bm, Cm, entering, q)
            d = (got["y"].float() - yw.float()).abs()
            bad = int((d > self.bf16_ulp(yw) +
                       self.ssd_tol(la, q, yw)).sum())
            check(bad == 0, f"{what}: (c) {bad} values of y past one bf16 "
                  f"ulp plus the tolerance (max abs diff {float(d.max())})")
            print(f"{what}: max abs diff cumsum {cerr:.3g}, (a) chunk states "
                  f"{serr:.3g}, (b) entering states {eerr:.3g} (bf16 hi + "
                  f"lo), last state {herr:.3g}, (c) y {float(d.max()):.3g}",
                  flush=True)
            del xd, la, Bm, Cm, got, cum, S, entering, h, yw, d
            torch.cuda.empty_cache()

    # ---- phase 20 ----------------------------------------------------------
    def serve_ssd(self, ssd_rows):
        """Phase 20: serve mamba2-780m at full width (random weights from a
        seeded generator, bf16) through ``Engine``: 8 requests, every
        admission launching the tensor-core SSD kernel once per layer and
        no plain version, decode launching nothing, and the SSD kernels'
        share of a 2,048-token prefill's device time; then the float32
        gate that does not pass through the kernel -- a prompt of
        SSD_GATE_LEN tokens (two chunks) through the CUDA-core kernel's
        prefill against the same tokens fed one at a time through
        ``decode_step`` (the recurrence) from empty caches -- and a float32
        copy's greedy decode against re-prefill.  Adds the SSD kernel's
        rows."""
        import dataclasses
        torch = self.torch
        from repro_torch.configs import get
        from repro_torch.models import ssm as S
        from repro_torch.models import transformer as T
        from repro_torch.parallel.sharding import single_device_ctx
        ssd_ops = self.ssd_ops
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = get(SSD_ARCH)
        _, nh, conv_ch = S.dims(cfg)
        check((nh, cfg.ssm.head_dim, cfg.ssm.d_state, cfg.ssm.n_groups,
               cfg.ssm.chunk) == (SSD_HEADS, SSD_HEAD_DIM, SSD_STATE, 1,
                                  SSD_CHUNK), f"{SSD_ARCH} widths")
        t0 = time.perf_counter()
        model = T.init_params(torch.Generator(self.dev).manual_seed(0), cfg)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        # the config's analytic count leaves out each layer's conv bias
        # and dt bias
        carried = cfg.param_count() + cfg.n_layers * (conv_ch + nh)
        check(n_params == carried, f"{SSD_ARCH}: {n_params} parameters, "
              f"want {carried} (the config's {cfg.param_count()} + conv and "
              f"dt biases)")
        print(f"phase 20: {SSD_ARCH} at full width ({cfg.n_layers} SSD "
              f"layers, d_model {cfg.d_model}, {nh} heads of "
              f"{cfg.ssm.head_dim}, state {cfg.ssm.d_state}, vocab "
              f"{cfg.vocab_size}): "
              f"{n_params} float32 parameters from seed 0 in "
              f"{time.perf_counter() - t0:.1f} s; compute {cfg.dtype}",
              flush=True)
        pctx = single_device_ctx(attn_impl="flash")
        prompts = self.serve_prompts(cfg, model, pctx, SSD_LONG)
        counts, timing = self.serve_run(cfg, model, pctx, prompts, "ssd",
                                        "ssd_chunk", "ssd_chunk_ms",
                                        "phase 20", variant="tc")
        print(json.dumps({"timing": f"{SSD_ARCH} serving", "card": self.card,
                          **timing}), flush=True)
        pre = timing[f"prefill_{SSD_LONG[-1]}"]
        if pre["device_busy_ms"]:
            share = pre["ssd_chunk_ms"] / pre["device_busy_ms"]
            print(f"phase 20: the {SSD_LONG[-1]}-token prefill: SSD kernels "
                  f"{pre['ssd_chunk_ms']:.3f} of {pre['device_busy_ms']:.3f} "
                  f"device ms ({share:.1%}), host {pre['host_ms']:.3f} ms; "
                  f"{cfg.n_layers} tc launches an admission", flush=True)

        # the gate: float32 prefill through the kernel against the
        # recurrence, token by token from empty caches
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        gate = np.random.default_rng(SSD_GATE_LEN).integers(
            0, cfg.vocab_size, size=(1, SSD_GATE_LEN))
        gate = torch.from_numpy(gate).long().to(self.dev)
        check(S._pick_chunk(SSD_GATE_LEN, cfg.ssm.chunk) * 2 == SSD_GATE_LEN,
              "phase 20: the gate's prompt is not two chunks")
        before = ssd_ops.kernel_call_counts()["ssd_chunk"]
        fma_before = ssd_ops.variant_call_counts()["fma"]
        want, wc = T.prefill(model, gate, cfg32, pctx)
        check(ssd_ops.kernel_call_counts()["ssd_chunk"] - before ==
              cfg.n_layers and ssd_ops.variant_call_counts()["fma"] -
              fma_before == cfg.n_layers, "phase 20: the float32 prefill "
              "did not launch the CUDA-core kernel once per layer")
        caches = T.init_caches(cfg32, 1, SSD_GATE_LEN + 1, torch.float32,
                               self.dev)
        t0 = time.perf_counter()
        for i in range(SSD_GATE_LEN):
            got, caches = T.decode_step(model, gate[:, i:i + 1], caches,
                                        torch.tensor(i, device=self.dev),
                                        cfg32, pctx)
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        check(ssd_ops.kernel_call_counts()["ssd_chunk"] - before ==
              cfg.n_layers, "phase 20: the recurrence launched the kernel")

        def rel(a, b):
            return float((a - b).norm() / b.norm())
        logit_rel = rel(want, got)
        h_rel = [rel(w.h, c.h) for w, c in zip(wc, caches)]
        conv_rel = [rel(w.conv, c.conv) for w, c in zip(wc, caches)]
        check(bool(torch.isfinite(want).all()) and logit_rel <= SSD_GATE_REL
              and max(h_rel) <= SSD_GATE_REL
              and max(conv_rel) <= SSD_GATE_REL,
              f"phase 20: float32 prefill against the recurrence over "
              f"{SSD_GATE_LEN} tokens: relative L2 logits {logit_rel}, "
              f"states up to {max(h_rel)}, conv windows up to "
              f"{max(conv_rel)} (limit {SSD_GATE_REL})")
        print(f"phase 20: float32 prefill of {SSD_GATE_LEN} tokens (2 chunks"
              f" of {SSD_GATE_LEN // 2}, the kernel) against {SSD_GATE_LEN} "
              f"decode steps (the recurrence, {rec_s:.1f} s): relative L2 "
              f"logits {logit_rel:.3g}, states max {max(h_rel):.3g} (layer "
              f"{int(np.argmax(h_rel))}), median "
              f"{float(np.median(h_rel)):.3g}, conv windows max "
              f"{max(conv_rel):.3g} (limit {SSD_GATE_REL})", flush=True)
        del caches, wc

        # float32 copy: greedy decode equals re-prefill (tests/test_serve.py)
        self.greedy_equals_reprefill(model, cfg32, pctx, "phase 20")
        del model
        torch.cuda.empty_cache()

        for s, row in ssd_rows.items():
            self.rows.append({
                "name": f"ssd_chunk[bf16 S{s}]", "route": "cuda",
                "source": SSD_SOURCE, "replaces": REPLACES["ssd_chunk"],
                "variant": "tc",
                "launches": counts["ssd_ssd_chunk"],
                "launches_per_admission": cfg.n_layers,
                "launches_per_decode_step": 0, **row})

    # ---- phase 22 ----------------------------------------------------------
    def chain_expect(self, counts, algorithms, what):
        """One chain (or stage) execute: each stage's kernels once, one
        classification per hash stage, no plain version, nothing else."""
        want: dict = {}
        for algo in algorithms:
            for k in CHAIN_KERNELS[algo]:
                want[k] = want.get(k, 0) + 1
        self.expect(counts, want, what)
        n_hash = sum(algo in ("hash", "hash_vector") for algo in algorithms)
        check(self.class_counts["classify"] == n_hash and
              self.class_counts["plain"] == 0,
              f"{what}: {self.class_counts['classify']} classifying launches "
              f"for {n_hash} hash stages")

    def plain_stage(self, stage, a, b):
        """The plain version of one chain stage on ``(a, b)``: its sorted
        output CSR and the products each output slot sums."""
        torch, ref, pb_ref = self.torch, self.ref, self.pb_ref
        if stage.algorithm == "pb":
            p = stage.pb_plan
            pp = pb_ref.scatter_plain(p.bucket_nnz, p.src_a, p.src_b, a.data,
                                      b.data)
            vals = pb_ref.merge_plain(p.bucket_nnz, p.seg, pp, p.cap_c)
            counts = self.pb_products_per_slot(p)
            cols, indptr = p.cols_c, p.indptr_c
        else:
            args = (stage.offsets, stage.bin_tsize, a.indptr, b.indptr,
                    stage.indptr_c, a.indices, a.data, b.indices, b.data)
            cols, vals = ref.numeric_plain(*args, cap_c=stage.cap_c,
                                           table_size=stage.table_size,
                                           vector=False)
            counts = ref.products_per_entry(a.indptr, b.indptr,
                                            stage.indptr_c, a.indices,
                                            b.indices, stage.cap_c)
            indptr = stage.indptr_c
        nnz = torch.tensor(stage.nnz_c, dtype=torch.int32, device=self.dev)
        return self.CSR(indptr, cols, vals, nnz, (a.n_rows, b.n_cols),
                        True), counts

    def check_stage(self, what, out, plain, counts):
        """A stage's (or chain's) output against the plain version: row
        pointers bitwise the plan's, each row's columns bitwise, values
        bitwise (``counts`` None) or within 1 ulp per product."""
        check(self.torch.equal(out.indptr, plain.indptr) and
              int(out.nnz) == int(plain.nnz),
              f"{what}: row pointers or nnz differ from the plan's")
        return self.compare(what, out.indices, out.data, out.indptr,
                            out.shape, plain.indices, plain.data, counts)

    def chain_run(self, label, chain, mats, mats_d, plain_d=None):
        """``chain.execute`` on the card (launches counted), its stages one
        by one, each against the plain version on the kernel's own
        intermediate (within 1 ulp per product), and the dyadic chain
        against the plain composition, bitwise.  Returns the output, one
        record per stage and the dyadic plain composition (``plain_d``:
        one computed before on the same plan arrays)."""
        torch = self.torch
        c, counts = self.counted(lambda: chain.execute(*mats))
        self.chain_expect(counts, chain.algorithms, f"{label} execute")
        check(torch.equal(c.indptr, chain.stages[-1].indptr_c) and
              int(c.nnz) == chain.nnz_c, f"{label}: row pointers or nnz "
              f"differ from the plan's")
        check(c.sorted_cols or not chain.sorted_output,
              f"{label}: sorted output not flagged sorted")
        stages, cur, last = [], mats[0], chain.n_stages - 1
        for k, stage in enumerate(chain.stages):
            b = mats[k + 1]
            so = chain.sorted_output if k == last else chain.sorted_hops[k]
            out, counts = self.counted(
                lambda: stage.execute(cur, b, sorted_output=so))
            self.chain_expect(counts, (stage.algorithm,),
                              f"{label} stage {k}")
            plain, pp = self.plain_stage(stage, cur, b)
            err = self.check_stage(f"{label} stage {k}", out, plain, pp)
            del plain, pp
            stages.append({"stage": stage, "a": cur, "b": b, "sorted": so,
                           "err": err})
            cur = out
        del cur, out
        c_d, counts = self.counted(lambda: chain.execute(*mats_d))
        self.chain_expect(counts, chain.algorithms,
                          f"{label} execute dyadic")
        if plain_d is None:
            plain_d = mats_d[0]
            for k, stage in enumerate(chain.stages):
                plain_d, _ = self.plain_stage(stage, plain_d, mats_d[k + 1])
        self.check_stage(f"{label} dyadic", c_d, plain_d, None)
        print(f"{label}: each stage's kernel within 1 ulp per product of "
              f"the plain version on its own intermediate (max abs diff "
              f"{[s['err'] for s in stages]}); dyadic bitwise the plain "
              f"composition", flush=True)
        return c, stages, plain_d

    def scipy_of(self, a):
        import scipy.sparse as sps
        nnz = int(a.nnz)
        return sps.csr_matrix((a.data[:nnz].double().cpu().numpy(),
                               a.indices[:nnz].cpu().numpy(),
                               a.indptr.cpu().numpy()), shape=a.shape)

    def scipy_check(self, what, c, want) -> float:
        """``c`` against scipy's float64 product ``want``: the same
        structure, values within a relative CHAIN_SCIPY_RTOL."""
        torch = self.torch
        s = self.core.finalize(c, True)
        want.sort_indices()
        nnz = int(s.nnz)
        check(nnz == want.nnz and np.array_equal(
            s.indptr.cpu().numpy().astype(np.int64),
            want.indptr.astype(np.int64)) and np.array_equal(
            s.indices[:nnz].cpu().numpy(), want.indices.astype(np.int32)),
            f"{what}: structure differs from scipy's")
        w = torch.from_numpy(want.data).to(self.dev)
        rel = float(((s.data[:nnz].double() - w).abs() / w.abs()).max()) \
            if nnz else 0.0
        check(rel <= CHAIN_SCIPY_RTOL, f"{what}: relative difference {rel} "
              f"from scipy's float64 chain past {CHAIN_SCIPY_RTOL}")
        return rel

    def sparse_of(self, a):
        nnz = int(a.nnz)
        return self.torch.sparse_csr_tensor(
            a.indptr.long(), a.indices[:nnz].long(), a.data[:nnz],
            size=a.shape)

    def stage_times(self, st):
        """One stage's kernels (phase 5's and 6's calls, bytes and bounds
        on the stage's own operands: single call and 20 back to back), its
        plain version, its execute and ``torch.sparse.mm`` of the same
        product."""
        torch, core = self.torch, self.core
        stage, a, b = st["stage"], st["a"], st["b"]
        if stage.algorithm == "pb":
            p = stage.pb_plan
            calls, _ = self.pb_pair(p, a.data, b.data)
            by = pb_bytes(p, int(a.nnz), int(b.nnz))
            ops = p.total_flop
        else:
            args = (stage.offsets, stage.bin_tsize, a.indptr, b.indptr,
                    stage.indptr_c, a.indices, a.data, b.indices, b.data)
            err = torch.zeros(1, dtype=torch.int32, device=self.dev)
            vector = stage.algorithm == "hash_vector"
            name = "numeric_vector" if vector else "numeric"
            calls = {name: self.hash_numeric_pair(
                args, stage.cap_c, stage.table_size, vector, err)}
            by = {name: hash_numeric_bytes(a, b, stage.nnz_c)}
            ops = 2 * stage.total_flop
        t = self.kernel_times(calls, plain_reps=3)
        if stage.algorithm != "pb":
            torch.cuda.synchronize()
            check(int(err) == 0, f"stage {stage.algorithm}: {int(err)} "
                  f"kernel errors")
        t["execute"] = self.time_ms(
            lambda: stage.execute(a, b, sorted_output=st["sorted"]))
        if st["sorted"] and stage.algorithm != "pb":
            # the sort epilogue of a sorted hop (or output) alone
            raw = stage.execute(a, b, sorted_output=False)
            t["sort"] = self.time_ms(lambda: core.finalize(raw, True))
            del raw
        sp_a, sp_b = self.sparse_of(a), self.sparse_of(b)
        t["torch_sparse_mm"] = self.yardstick_ms(lambda: torch.sparse.mm(
            sp_a, sp_b))
        bounds = {k: bound_ms(v, ops) for k, v in by.items()}
        return t, {k: v[0] for k, v in bounds.items()}, \
            {k: v[1] for k, v in bounds.items()}, by

    def yardstick_ms(self, fn):
        """:meth:`time_ms` of a library call (a yardstick, off the path);
        None where cuSPARSE runs out of device memory."""
        try:
            return self.time_ms(fn)
        except self.torch.OutOfMemoryError:
            self.torch.cuda.empty_cache()
            return None

    def chain_times(self, label, chain, mats, stages, launches,
                    sort_plan=None, plan_s=None, library_mats=None,
                    extra=None):
        """Timing line of one plan (``chain.execute(*mats)``; a chain, or
        a Gram plan as one stage): its execute, the execute with
        ``sort_intermediates=True`` (the C8 comparison), each stage's
        kernels, the chain of ``torch.sparse.mm`` over ``library_mats``
        (default ``mats``; a yardstick only), plan seconds and each
        stage's bound; one kernels-line row per stage kernel."""
        torch = self.torch
        t = {"execute": self.time_ms(lambda: chain.execute(*mats)),
             **(extra or {})}
        t["execute_b2b"], t["execute_host"] = self.stream_ms(
            lambda: chain.execute(*mats))
        if sort_plan is not None:
            t["execute_sorted_intermediates"] = self.time_ms(
                lambda: sort_plan.execute(*mats))
            t["execute_sorted_intermediates_b2b"], _ = self.stream_ms(
                lambda: sort_plan.execute(*mats))
        sp = [self.sparse_of(m) for m in library_mats or mats]

        def library_chain():
            cur = sp[0]
            for x in sp[1:]:
                cur = torch.sparse.mm(cur, x)
            return cur

        t["torch_sparse_mm_chain"] = self.yardstick_ms(library_chain)
        del sp
        per_stage = []
        for k, st in enumerate(stages):
            ts, bound, bound_by, by = self.stage_times(st)
            stage = st["stage"]
            per_stage.append({
                "stage": k, "algorithm": stage.algorithm,
                "sorted_out": st["sorted"], "flop": stage.total_flop,
                "nnz_a": int(st["a"].nnz), "nnz_c": stage.nnz_c,
                "ms": ts, "bound_ms": bound, "bytes": by})
            pb = stage.algorithm == "pb"
            for name, b_ms in bound.items():
                key = f"pb_{name}" if pb else name
                self.rows.append({
                    "name": f"spgemm_{'pb' if pb else 'hash'}_{name}"
                            f"[chain {label} stage {k}]",
                    "route": "cuda",
                    "source": PB_SOURCE if pb else KERNEL_SOURCE,
                    "replaces": REPLACES[name],
                    "launches": launches.get(key, 0),
                    "launches_in_stage": 1,
                    "max_abs_err": st["err"], "ms": ts[name],
                    "back_to_back_ms": ts[f"{name}_b2b"],
                    "plain_ms": ts[f"plain_{name}"], "bound_ms": b_ms,
                    "bound_by": bound_by[name],
                    "library_ms": ts["torch_sparse_mm"]})
        print(json.dumps({
            "timing": f"chain {label}", "card": self.card,
            "algorithms": [st["stage"].algorithm for st in stages],
            "sorted_hops": [st["sorted"] for st in stages[:-1]],
            "sort_intermediates_algorithms": None if sort_plan is None
            else list(sort_plan.algorithms),
            "total_flop": sum(st["stage"].total_flop for st in stages),
            "nnz_c": stages[-1]["stage"].nnz_c,
            "ms": t, "stages": per_stage, "plan_s": plan_s}), flush=True)
        return t

    def repeat_plan(self, label, plan, replan):
        """A repeat plan must return the cached plan with no new miss."""
        before = self.core.plan_cache_stats()["misses"]
        again = replan()
        check(again is plan and
              self.core.plan_cache_stats()["misses"] == before,
              f"{label}: a repeat plan missed the cache")

    def chain_galerkin(self, preset, scale):
        """R.A.P with ``aggregation_csr(n, n // 8)``, unsorted and sorted
        output; on ER s18 the sorted chain's last stage is ``pb`` on a
        sorted hop, and ten repeat executes agree."""
        torch, core, rmat = self.torch, self.core, self.rmat
        t0 = time.perf_counter()
        a = rmat.rmat_csr(scale, EDGE_FACTOR, preset, seed=0,
                          device=self.dev)
        a_d = self.dyadic_copy(a, 22)
        n = a.n_rows
        r, p = rmat.aggregation_csr(n, n // CHAIN_COARSEN, seed=0,
                                    device=self.dev)
        want = self.scipy_of(r) @ self.scipy_of(a) @ self.scipy_of(p)
        base = f"{preset} s{scale} ef{EDGE_FACTOR} R.A.P"
        print(f"{base}: n={n} nnz(A)={int(a.nnz)} coarse {n // CHAIN_COARSEN}"
              f" nnz(RAP) {want.nnz} (built, scipy's float64 chain in "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        mats, mats_d = (r, a, p), (r, a_d, p)
        for so in (False, True):
            label = f"{base} {'sorted' if so else 'unsorted'}"
            core.clear_plan_cache()
            t0 = time.perf_counter()
            plan = core.plan_galerkin(r, a, p, sorted_output=so)
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            self.repeat_plan(label, plan, lambda: core.plan_galerkin(
                r, a, p, sorted_output=so))
            print(f"{label}: stages {list(plan.algorithms)}, hops sorted "
                  f"{list(plan.sorted_hops)}, flop "
                  f"{[st.total_flop for st in plan.stages]}, nnz "
                  f"{[st.nnz_c for st in plan.stages]} (planned in "
                  f"{plan_s:.2f} s)", flush=True)
            check(plan.sorted_hops == (plan.algorithms[1] in
                                       self.chain_mod.A_SLOT_ALGORITHMS,),
                  f"{label}: the hop's sortedness breaks the slot-order rule")
            if so and preset == "ER":
                check(plan.algorithms[-1] == "pb",
                      f"{label}: the recipe sent the last stage to "
                      f"{plan.algorithms[-1]}, not pb")
            c, stages, _ = self.chain_run(label, plan, mats, mats_d)
            rel = self.scipy_check(label, c, want)
            print(f"{label}: within {rel:.3g} relative of scipy's float64 "
                  f"chain", flush=True)
            del c
            _, launches = self.counted(lambda: plan.execute(*mats))
            sort_plan = core.plan_galerkin(r, a, p, sorted_output=so,
                                           sort_intermediates=True)
            self.chain_times(label, plan, mats, stages, launches,
                             sort_plan=sort_plan, plan_s=plan_s)
            if so and preset == "ER":
                self.chain_repeats(label, plan, mats, mats_d)
            del stages, plan, sort_plan
            core.clear_plan_cache()
            torch.cuda.empty_cache()

    def chain_repeats(self, label, plan, mats, mats_d):
        """The pb-ended chain executed 10 times: the same structure every
        call, values bitwise on dyadic operands and within CHAIN_SCIPY_RTOL
        of the first call otherwise.  Evidence of the rule: two raw
        outputs of the hash stage (no sort) in other slot orders, and the
        unprotected composition feeding one into the pb stage."""
        torch = self.torch
        first_d = plan.execute(*mats_d)
        first = plan.execute(*mats)
        for _ in range(CHAIN_REPEATS):
            c_d = plan.execute(*mats_d)
            c = plan.execute(*mats)
            for f in ("indptr", "indices", "nnz"):
                check(torch.equal(getattr(c, f), getattr(first, f)) and
                      torch.equal(getattr(c_d, f), getattr(first_d, f)),
                      f"{label}: a repeat execute changed the structure")
            check(torch.equal(c_d.data, first_d.data),
                  f"{label}: a repeat dyadic execute changed the values")
            rel = ((c.data - first.data).abs()
                   / first.data.abs().clamp_min(1e-30)).max()
            check(float(rel) <= CHAIN_SCIPY_RTOL,
                  f"{label}: a repeat execute moved a value by {float(rel)}")
        s0 = plan.stages[0]
        raw1 = s0.execute(mats_d[0], mats_d[1], sorted_output=False)
        raw2 = s0.execute(mats_d[0], mats_d[1], sorted_output=False)
        srt = self.core.finalize(raw1, True)
        moved = int((raw1.indices != raw2.indices).sum())
        unsorted = int((raw1.indices != srt.indices).sum())
        bad = plan.stages[1].execute(raw1, mats_d[2])
        good = plan.execute(*mats_d)
        wrong = int((bad.data != good.data).sum())
        print(f"{label}: {CHAIN_REPEATS} repeat executes agree (structure "
              f"bitwise, dyadic values bitwise); the hash stage's raw "
              f"output: {unsorted} of {int(raw1.nnz)} slots off the sorted "
              f"order, {moved} differ between two calls; the unprotected "
              f"composition into pb: {wrong} wrong values", flush=True)

    def chain_power(self):
        """A^3 on ER s16 ef16 under ``auto``, pinned to ``hash`` and to
        ``hash_vector``."""
        torch, core = self.torch, self.core
        a = self.rmat.rmat_csr(CHAIN_POWER_SCALE, EDGE_FACTOR, "ER", seed=0,
                               device=self.dev)
        a_d = self.dyadic_copy(a, 23)
        plain_d = None
        for algorithm in ("auto", "hash", "hash_vector"):
            label = f"ER s{CHAIN_POWER_SCALE} ef{EDGE_FACTOR} A^3 {algorithm}"
            core.clear_plan_cache()
            t0 = time.perf_counter()
            plan = core.plan_power(a, 3, algorithm=algorithm)
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            self.repeat_plan(label, plan, lambda: core.plan_power(
                a, 3, algorithm=algorithm))
            check(plan.sorted_hops == (False,),
                  f"{label}: a hop into a hash stage was sorted")
            print(f"{label}: stages {list(plan.algorithms)}, flop "
                  f"{[s.total_flop for s in plan.stages]}, nnz "
                  f"{[s.nnz_c for s in plan.stages]} (planned in "
                  f"{plan_s:.2f} s)", flush=True)
            c, stages, plain_d = self.chain_run(label, plan, (a, a, a),
                                                (a_d, a_d, a_d), plain_d)
            del c
            _, launches = self.counted(lambda: plan.execute(a, a, a))
            sort_plan = core.plan_power(a, 3, algorithm=algorithm,
                                        sort_intermediates=True)
            self.chain_times(label, plan, (a, a, a), stages, launches,
                             sort_plan=sort_plan, plan_s=plan_s)
            del stages, plan, sort_plan
            core.clear_plan_cache()
            torch.cuda.empty_cache()
        del plain_d

    def chain_gram(self, preset, scale):
        """A^T A through ``plan_gram``: one product launch an execute; a
        re-weighted A re-gathers values only (no miss, one launch); ER
        against scipy's float64 product."""
        torch, core = self.torch, self.core
        a = self.rmat.rmat_csr(scale, EDGE_FACTOR, preset, seed=0,
                               device=self.dev)
        a_d = self.dyadic_copy(a, 24)
        label = f"{preset} s{scale} ef{EDGE_FACTOR} A^T.A"
        core.clear_plan_cache()
        t0 = time.perf_counter()
        plan = core.plan_gram(a)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        self.repeat_plan(label, plan, lambda: core.plan_gram(a))
        prod = plan.product
        print(f"{label}: product {plan.algorithm}, flop {prod.total_flop}, "
              f"nnz(C) {plan.nnz_c} (planned in {plan_s:.2f} s)", flush=True)
        t = core.csr_transpose(a)
        g, counts = self.counted(lambda: plan.execute(a))
        self.chain_expect(counts, (plan.algorithm,), f"{label} execute")
        plain, pp = self.plain_stage(prod, t, a)
        err = self.check_stage(label, g, plain, pp)
        del plain, pp
        g_d, counts = self.counted(lambda: plan.execute(a_d))
        self.chain_expect(counts, (plan.algorithm,), f"{label} dyadic")
        plain_d, _ = self.plain_stage(prod, core.csr_transpose(a_d), a_d)
        self.check_stage(f"{label} dyadic", g_d, plain_d, None)
        del g_d, plain_d
        # re-weighted: the cached plan, one gather and one product launch
        a3 = self.CSR(a.indptr, a.indices, a.data * 3, a.nnz, a.shape,
                      a.sorted_cols)
        before = core.plan_cache_stats()["misses"]
        (p3, g3), counts = self.counted(
            lambda: (core.plan_gram(a3), core.plan_gram(a3).execute(a3)))
        check(p3 is plan and core.plan_cache_stats()["misses"] == before,
              f"{label}: the re-weighted A missed the cache")
        self.chain_expect(counts, (plan.algorithm,), f"{label} re-weighted")
        plain3, pp3 = self.plain_stage(prod, core.csr_transpose(a3), a3)
        self.check_stage(f"{label} re-weighted", g3, plain3, pp3)
        del g3, plain3, pp3
        rel = None
        if preset == "ER":
            want = self.scipy_of(a).T.tocsr() @ self.scipy_of(a)
            rel = self.scipy_check(label, g, want)
            del want
        print(f"{label}: within 1 ulp per product of the plain version "
              f"(max abs diff {err}), dyadic bitwise, re-weighted A re-"
              f"gathered with no miss and one launch"
              + ("" if rel is None else f"; within {rel:.3g} relative of "
                 f"scipy's float64 product"), flush=True)
        del g
        stages = [{"stage": prod, "a": t, "b": a, "sorted": False,
                   "err": err}]
        _, launches = self.counted(lambda: plan.execute(a))
        self.chain_times(
            label, plan, (a,), stages, launches, plan_s=plan_s,
            library_mats=(t, a),
            extra={"transpose": self.time_ms(lambda: core.csr_transpose(a))})
        del plan, t, stages
        core.clear_plan_cache()
        torch.cuda.empty_cache()

    def chain_batch_power(self, label, mats, k):
        """``plan_batch_power(mats, k)``: each stage's hash classes launch
        one classification and one launch per table class, nothing else;
        each stage's members, run stage by stage, against phase 12's
        batched plain version on that stage's own intermediates (within 1
        ulp per product; dyadic values bitwise); the whole execute the
        same column sets (dyadic: values bitwise) as the stages."""
        torch, core, K = self.torch, self.core, self.K
        mats_d = [self.dyadic_copy(m, 30 + i) for i, m in enumerate(mats)]
        core.clear_plan_cache()
        t0 = time.perf_counter()
        plan = core.plan_batch_power(mats, k)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        self.repeat_plan(label, plan,
                         lambda: core.plan_batch_power(mats, k))
        classes = [c for st in plan.stages for c in st.classes]
        check(all(c.hash_sched is not None for c in classes),
              f"{label}: a class off the hash kernel: "
              f"{[c.algorithm for c in classes]}")

        def launches(stage_classes):
            want: dict = {}
            for c in stage_classes:
                key = "batched_numeric_vector" \
                    if c.algorithm == "hash_vector" else "batched_numeric"
                want[key] = want.get(key, 0) + len(K.launch_classes(
                    c.hash_largest))
            return want

        want = launches(classes)
        last, err = plan.n_stages - 1, 0.0
        for what, ops in (("", mats), (" dyadic", mats_d)):
            outs, counts = self.counted(lambda: plan.execute(ops))
            self.expect(counts, want, f"{label} execute{what}")
            check(self.class_counts["classify"] == len(classes),
                  f"{label}: {self.class_counts['classify']} classifying "
                  f"launches for {len(classes)} classes")
            cur = ops
            for j, stage in enumerate(plan.stages):
                pairs = list(zip(cur, ops))
                so = plan.sorted_output if j == last else False
                step, counts = self.counted(
                    lambda: stage.execute(pairs, sorted_output=so))
                self.expect(counts, launches(stage.classes),
                            f"{label} stage {j}{what}")
                plain, pp, _ = self.batch_plain(stage, pairs)
                for i, c in enumerate(step):
                    err = max(err, self.compare(
                        f"{label} stage {j}{what} member {i}", c.indices,
                        c.data, c.indptr, c.shape, *plain[i],
                        None if what else pp[i]))
                del plain, pp
                cur = step
            for i, (c, s) in enumerate(zip(outs, cur)):
                c, s = c.sort_rows(), s.sort_rows()
                nnz = int(s.nnz)
                check(torch.equal(c.indptr, s.indptr) and int(c.nnz) == nnz
                      and torch.equal(c.indices[:nnz], s.indices[:nnz]),
                      f"{label} member {i}{what}: the execute's structure "
                      f"differs from the stages'")
                check(not what or torch.equal(c.data[:nnz], s.data[:nnz]),
                      f"{label} member {i}{what}: the execute's values "
                      f"differ from the stages'")
            del outs, cur, step
        per_member = [core.plan_power(m, k) for m in mats]
        t = {"execute": self.time_ms(lambda: plan.execute(mats))}
        t["execute_b2b"], t["execute_host"] = self.stream_ms(
            lambda: plan.execute(mats))
        t["per_member_plan_power_loop"] = self.time_ms(
            lambda: [pm.execute([m] * k) for pm, m in zip(per_member, mats)])
        print(f"{label}: {plan.n_products} members x {plan.n_stages} "
              f"stages in {plan.n_classes} classes; launches {want} + "
              f"{len(classes)} classifications; every stage within 1 ulp "
              f"per product of the batched plain version on its own "
              f"intermediates (max abs diff {err}), dyadic bitwise",
              flush=True)
        print(json.dumps({"timing": f"chain {label}", "card": self.card,
                          "n_products": plan.n_products,
                          "n_stages": plan.n_stages,
                          "n_classes": plan.n_classes, "launches": want,
                          "max_abs_err": err, "ms": t, "plan_s": plan_s}),
              flush=True)
        del plan, per_member
        core.clear_plan_cache()

    def chains(self):
        """Phase 22: the chain planner at the paper's sizes."""
        from repro_torch.core import chain as chain_mod
        from repro_torch.examples import mcl as mcl_twin
        from repro_torch.examples.moe_dispatch_batch import diagonal_blocks
        self.chain_mod = chain_mod
        t_phase = time.perf_counter()
        for preset, scale in (("ER", ER_SCALE), ("G500", G500_SCALE)):
            self.chain_galerkin(preset, scale)
        self.chain_power()
        for preset, scale in (("ER", ER_SCALE), ("G500", G500_SCALE)):
            self.chain_gram(preset, scale)
        self.chain_batch_power("block_diagonal_demo (12 blocks, k 2)",
                               diagonal_blocks(self.dev), 2)
        fleet = [self.rmat.rmat_csr(FLEET_SCALE, 1 + (i % 3),
                                    "G500" if i % 2 else "ER", seed=i,
                                    device=self.dev)
                 for i in range(FLEET_PRODUCTS)]
        self.chain_batch_power(f"rmat_fleet({FLEET_PRODUCTS}, "
                               f"{FLEET_SCALE}) A (k 3)", fleet, 3)
        del fleet
        for n_clusters, size in MCL_GRAPHS:
            t0 = time.perf_counter()
            res, counts = self.counted(
                lambda: mcl_twin.run(n_clusters, size, device=self.dev))
            self.expect(counts, {"numeric": res["n_iters"]},
                        f"MCL {n_clusters} x {size}")
            print(json.dumps({"timing": f"chain MCL {n_clusters} x {size}",
                              "card": self.card,
                              "n_iters": res["n_iters"],
                              "distinct_caps": len(set(res["caps"])),
                              "numeric_launches": counts["numeric"],
                              "s": time.perf_counter() - t0}), flush=True)
        self.core.clear_plan_cache()
        self.torch.cuda.empty_cache()
        print(f"phase 22: chains ok in {time.perf_counter() - t_phase:.1f} s",
              flush=True)

    # ---- phase 23 ----------------------------------------------------------
    def race(self, label, a, db, gated: bool) -> dict:
        """Race ``a @ a`` through ``plan_spgemm(autotune=True)`` on a miss
        of ``db``: every lane's time, the winner, the heuristic plan's
        choice, the roofline of the winner.  Every lane that
        ``autotune.measure._candidates`` names ran (a lane that fails on
        the card raises); the measured plan's execute launches the
        winner's kernels, no plain version, and matches the plain version
        (structure bitwise, values within 1 ulp per accumulated product);
        a second request is a DB hit that times nothing.  ``gated``: the
        measured plan's execute is also no slower than AUTOTUNE_SLACK
        times the heuristic plan's (``benchmarks/bench_autotune.py``'s
        contract), both timed by the race's own timer."""
        torch, core, AT = self.torch, self.core, self.autotune
        heur = core.plan_spgemm(a, a, cache=False)
        check(heur.provenance == "heuristic",
              f"{label}: heuristic plan's provenance {heur.provenance}")
        AT.reset_measure_calls()
        t0 = time.perf_counter()
        meas = core.plan_spgemm(a, a, autotune=True, autotune_db=db,
                                cache=False)
        torch.cuda.synchronize()
        race_s = time.perf_counter() - t0
        calls = AT.measure_call_counts()
        entry = db.load().get(AT.db_key(a, a))
        check(meas.provenance == "measured" and calls["db_misses"] == 1
              and entry is not None and entry["algorithm"] == meas.algorithm,
              f"{label}: the race persisted no winner ({calls})")
        lanes = entry["candidates"]
        want_lanes = {lane[0] for lane in
                      AT.measure._candidates(a, a, "plus_times", None)}
        check(set(lanes) == want_lanes and
              calls["candidates_timed"] == len(want_lanes),
              f"{label}: lanes {sorted(lanes)} ran, want "
              f"{sorted(want_lanes)} ({calls})")
        check(lanes[entry["label"]] == entry["us"] == min(lanes.values()),
              f"{label}: winner {entry['label']} is not the fastest of "
              f"{lanes}")

        out, counts = self.counted(lambda: meas.execute(a, a))
        want: dict = {}
        for k in AUTOTUNE_KERNELS.get(meas.algorithm, ()):
            want[k] = 1
        self.expect(counts, want, f"{label} measured execute")
        plain, products = self.plain_stage(meas, a, a)
        err = self.check_stage(f"{label} measured execute", out, plain,
                               products)
        del out, plain, products

        AT.reset_measure_calls()
        again = core.plan_spgemm(a, a, autotune=True, autotune_db=db,
                                 cache=False)
        calls = AT.measure_call_counts()
        check(calls["candidates_timed"] == 0 and calls["db_hits"] == 1 and
              again.provenance == "measured" and
              again.algorithm == meas.algorithm and
              again.table_size == meas.table_size,
              f"{label}: the repeat request was not a DB hit ({calls})")
        del again

        row = {"timing": f"measured recipe {label}", "card": self.card,
               **AT.race_report(heur, lanes), "race_s": race_s,
               "max_abs_err": err, "roofline": entry["roofline"]}
        if gated:
            # the race's timer over AUTOTUNE_GATE_REPS rounds, with a
            # second copy of the heuristic plan: how far apart it puts
            # one program, beside the gate's slack
            t = AT.time_plans({"measured": meas, "heuristic": heur,
                               "heuristic again": dataclasses.replace(heur)},
                              a, a, reps=AUTOTUNE_GATE_REPS)
            ratio = t["measured"] / t["heuristic"]
            row.update(gate_us=t, gate_ratio=ratio, gate_same_program_spread=
                       abs(t["heuristic again"] / t["heuristic"] - 1.0))
            check(ratio <= AUTOTUNE_SLACK,
                  f"{label}: the measured plan ({meas.algorithm}, "
                  f"{t['measured']} us) is slower than {AUTOTUNE_SLACK} x "
                  f"the heuristic plan's ({heur.algorithm}, "
                  f"{t['heuristic']} us)")
        print(json.dumps(row), flush=True)
        del heur, meas
        core.clear_plan_cache()
        return row

    def scaled_entry(self, db):
        """(b): an entry naming ``hash`` at table scale 2 for G500 s16,
        planned: a DB hit that times nothing, tables the clipped doubles
        of the scale-1 plan's, the output against the plain version, and
        both plans' executes and table-class launches."""
        torch, core, AT = self.torch, self.core, self.autotune
        from repro_torch.core.recipe import measure_stats
        from repro_torch.core.schedule import lowest_p2, scale_table_sizes
        label = f"G500 s{G500_SCALE} ef{EDGE_FACTOR}"
        g = self.rmat.rmat_csr(G500_SCALE, EDGE_FACTOR, "G500", seed=0,
                               device=self.dev)
        base = core.plan_spgemm(g, g, algorithm="hash", cache=False)
        s = measure_stats(g, g)
        db.put(AT.db_key(g, g), {
            "schema": AT.SCHEMA_VERSION, "algorithm": "hash",
            "table_scale": 2, "label": "hash@t2", "us": 0.0,
            "candidates": {}, "backend": AT.measure.backend_of(g.device),
            "x64": False, "stats": {"flop": s.flop, "nnz_a": s.nnz_a,
                                    "nnz_c": s.nnz_c_est}})
        AT.reset_measure_calls()
        t0 = time.perf_counter()
        plan = core.plan_spgemm(g, g, autotune=True, autotune_db=db,
                                cache=False)
        plan_s = time.perf_counter() - t0
        calls = AT.measure_call_counts()
        check(calls["candidates_timed"] == 0 and calls["db_hits"] == 1 and
              plan.provenance == "measured" and plan.algorithm == "hash",
              f"{label} x2 entry: not a DB hit with nothing timed ({calls}, "
              f"{plan.algorithm}, {plan.provenance})")
        size, bins = scale_table_sizes(base.table_size, base.bin_tsize, 2,
                                       g.n_cols, self.K.CHUNK)
        check(plan.table_size == size and torch.equal(plan.bin_tsize, bins),
              f"{label} x2 entry: tables {plan.table_size} "
              f"{plan.bin_tsize.tolist()}, want {size} {bins.tolist()}")
        classes = {}
        for name, p in (("scale 1", base), ("scale 2", plan)):
            out, counts = self.counted(lambda: p.execute(g, g))
            self.expect(counts, {"numeric": 1}, f"{label} {name} execute")
            classes[name] = {k: v for k, v in self.class_counts.items() if v}
            del out
        out = plan.execute(g, g)
        plain, products = self.plain_stage(plan, g, g)
        err = self.check_stage(f"{label} x2 execute", out, plain, products)
        del out, plain, products
        row = {"timing": f"measured recipe {label} x2 tables",
               "card": self.card, "plan_s": plan_s,
               "table_size": [base.table_size, plan.table_size],
               "bin_tsize": [base.bin_tsize.tolist(), plan.bin_tsize.tolist()],
               "largest_table": lowest_p2(g.n_cols + 1),
               "class_launches": classes, "max_abs_err": err,
               "ms": {"scale 1": self.time_ms(lambda: base.execute(g, g)),
                      "scale 2": self.time_ms(lambda: plan.execute(g, g))}}
        print(json.dumps(row), flush=True)
        del base, plan, g
        core.clear_plan_cache()
        torch.cuda.empty_cache()

    def measured_recipe(self):
        """Phase 23: the measured recipe on a fresh DB."""
        import tempfile
        import repro_torch.autotune as autotune
        from repro_torch.data import matrices
        self.autotune = autotune
        t_phase = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            db = autotune.PerfDB(str(Path(tmp) / "autotune.json"))
            for preset, scale in (("ER", ER_SCALE),
                                  ("G500", AUTOTUNE_G500_SCALE)):
                a = self.rmat.rmat_csr(scale, EDGE_FACTOR, preset, seed=0,
                                       device=self.dev)
                self.race(f"{preset} s{scale} ef{EDGE_FACTOR}", a, db, True)
                del a
            self.torch.cuda.empty_cache()
            self.scaled_entry(db)
            rows = []
            for p, m in matrices.suite(divisor=AUTOTUNE_SUITE_DIVISOR,
                                       max_matrices=AUTOTUNE_SUITE_MATRICES,
                                       device=self.dev):
                rows.append(self.race(p.name, m, db, False))
                del m
            self.torch.cuda.empty_cache()
        near = [r["timing"].split()[-1] for r in rows
                if r["heuristic_us"] is not None
                and r["heuristic_us"] <= AUTOTUNE_SLACK * r["winner_us"]]
        names = [row[0] for row in matrices.TABLE2]
        print(json.dumps({
            "timing": "measured recipe Table 2 proxies", "card": self.card,
            "divisor": AUTOTUNE_SUITE_DIVISOR, "raced": len(rows),
            "not_raced": names[len(rows):],
            "table4_within_5pct": len(near), "table4_within_5pct_of": near,
            "scope": "a functional check: at this divisor the lanes time "
                     "host work an execute, not the algorithms",
            "winners": {r["timing"].split()[-1]: r["winner"] for r in rows},
            "s": time.perf_counter() - t_phase}), flush=True)
        self.core.clear_plan_cache()
        print(f"phase 23: measured recipe ok in "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    card = card_line()                                           # phase 1
    print(card, flush=True)

    from repro_torch.kernels import _build                       # phase 2
    from repro_torch.kernels.spgemm_hash import kernel as K
    from repro_torch.kernels.spgemm_pb import kernel as PK
    from repro_torch.kernels.spgemm_bcsr import kernel as BK
    from repro_torch.kernels.spmm import kernel as SK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssd_chunk import kernel as SSDK
    seconds = _build.compile_sources([K.SOURCE, PK.SOURCE, BK.SOURCE,
                                      SK.SOURCE, *FK.SOURCES, *SSDK.SOURCES])
    flash, ssd = FK.build(), SSDK.build()
    for info, src in ((K.build(), K.SOURCE), (PK.build(), PK.SOURCE),
                      (BK.build(), BK.SOURCE), (SK.build(), SK.SOURCE),
                      (flash["fma"], FK.SOURCE),
                      (flash["wgmma"], FK.WGMMA_SOURCE),
                      (ssd["fma"], SSDK.SOURCE),
                      (ssd["tc"], SSDK.TC_SOURCE)):
        print(f"phase 2: built {info['path']} in {seconds[src]:.1f} s",
              flush=True)
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip(), flush=True)

    smoke = Smoke(torch, card)
    smoke.saturation()                                           # phase 3
    er = smoke.one_input("ER", ER_SCALE)                         # 4, 5
    smoke.sorted_pb(*er)                                         # phase 6
    smoke.pb_value_fleet(*er)                                    # phase 14
    smoke.hash_value_fleet(*er, HASH_FLEET_MEMBERS,              # phase 16
                           both=HASH_FLEET_MEMBERS_BOTH, other=True)
    smoke.spmm_input(*er, {})                                    # phase 8
    del er
    g500, g500_d, g500_label = smoke.one_input("G500", G500_SCALE)
    smoke.hash_value_fleet(g500, g500_d, g500_label,             # phase 16
                           HASH_FLEET_MEMBERS_G500)
    del g500_d
    for preset, scale, ef in BCSR_INPUTS:                        # phase 7
        smoke.bcsr_input(preset, scale, ef)
    smoke.bcsr_auto()
    graph, label, paths, cls_paths = smoke.graph()               # phase 9
    smoke.spmm_input(graph, smoke.dyadic_copy(graph, 3), label, paths,
                     widths=False, classify_paths=cls_paths)
    del graph
    smoke.tall_skinny(g500, g500_label)                          # phase 10
    smoke.bcsr_large_tile()                                      # phase 11
    smoke.batch()                                                # phase 12
    smoke.value_fleet()                                          # phase 13
    flash_rows = smoke.flash_kernel()                            # phase 17
    smoke.serve(flash_rows)                                      # phase 18
    ssd_rows = smoke.ssd_kernel()                                # phase 19
    smoke.serve_ssd(ssd_rows)                                    # phase 20
    smoke.hash_class_times()                                     # phase 21
    smoke.chains()                                               # phase 22
    smoke.measured_recipe()                                      # phase 23

    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": smoke.rows}), flush=True)       # phase 15
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
