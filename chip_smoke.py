#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and decode paths on one card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; each prints one line (or a few), and the script stops
with a non-zero exit at the first failure:

1. toolchain — torch/CUDA versions and the card's name and power limit;
   build the CUDA kernels from src/repro_torch/kernels/csrc (nvcc, one
   process per source, into build/torch_kernels/). From the start, three
   worker processes compute phase 4's partitions (host work) while the
   card runs phases 2 and 3.
2. kernels — each of the kernels of the serving path against its plain
   PyTorch version, on seeded inputs at the shapes the path gives it (the
   PubMed-shaped features, the history tables and the blocks of a real
   SLO=0 refresh batch, d = 256), timed with CUDA events (warm-up, then
   the median of 25 launches) beside the plain version, one PyTorch
   library call (or a composition of a few, marked so) where one computes
   the same function, and the card's bound (`gather_rows` also beside
   `index_select` in alternating rounds, with the timings' spread and
   whether the gap is resolved; the history pulls `gather_rows`,
   `gather_rows_dq` and `gather_rows_vq` also with the L2 flushed before
   each launch, beside an empty kernel's launch on the same grid): the
   f32 kernels, the int8 body of `gather_spmm`, `gather_rows_dq` (the
   refresh batch's 4,096 rows of d = 256) and `scatter_rows_q` over an
   int8 store, the bf16 instantiations of `gather_spmm` and
   `scatter_rows`, and the vq body of `gather_spmm`, `gather_rows_vq`
   (the same 4,096 rows) and `scatter_rows_vq` over a vq store (S = 32
   codes a row, a 256 KB codebook; codes and scales bitwise; the push's
   bound by operations beside the floor of the same operations issued one
   unfused instruction each, and its device kernels from one profiled
   push). After
   phase 3 (they need the training plans), GAT's
   three edge-softmax kernels the same way, on the unit blocks of a
   Cora-shaped training batch at the hidden layer's shapes (8 heads of 8;
   the output layer's, 1 head of 7, on the same line), the GAT
   hidden layer's history pull from an int8 table (`gather_rows_dq`), a
   bf16 one and a vq one (`gather_rows_vq`) and its push into the vq
   one (`scatter_rows_vq` at the training shape, 8 codes a row) and
   the int8 one (`scatter_rows_q`, its device kernels profiled as at the
   refresh push), `bcsr_spmm` on the
   forward and the transposed blocks of a quickstart
   batch (the GCN backward's use of it), and PNA's three `pna_reduce`
   kernels on batch 0's unit blocks of the table-5 PNA plan at F = 48
   (min, max, count and tie counts bitwise, sums and gradients at 1e-5,
   beside a composition of PyTorch calls over the blocks' nonzeros; the
   edge-softmax kernels beside such a composition too and, with
   --parent-csrc, the parent checkout's three kernels), then the launch
   floor (an empty kernel of the same library on 1 CTA and on the PNA
   backward passes' grids, timed as the rows are), and PNA's three
   kernels on the seeded operands and on the operands a training step
   on batch 0 gives them at layers 0 and 1 (the forward's stats bitwise
   and the sums and gradients within 1e-5 of the plain versions; with
   --parent-csrc beside the parent checkout's kernels, every output
   bitwise equal). Then the kernels at the operator zoo's operands: the
   f32 `gather_spmm` of APPNP's fused layers (6-wide tables) and of
   GIN's over the unit-weight blocks (D = 48), `bcsr_spmm` on GIN's unit
   blocks (layer 0) and transposed unit blocks (its backward), and
   `scatter_rows` of APPNP's 6-wide push, each beside its plain version
   (and cuSPARSE's CSR product or `index_copy_`) and its bound.
   Each block contraction (`bcsr_spmm` on the refresh batch, on the same
   blocks made fully dense, and on the two quickstart families;
   `gather_spmm`'s four bodies) has a line with its time beside the
   earlier dense block core's: PERF.md's time, or, with --parent-csrc,
   the parent checkout's kernels run on the same inputs, with whether
   their outputs are bitwise equal.
3. serving — the PubMed-shaped graph (19,717 nodes, degree 4.5, 500
   features, 3 classes) and a 3-layer, 256-wide GCN with seeded random
   weights and a zero f32 history store; 16 requests x 128 queries at
   SLO=0, then the same 16 at SLO=None. Checks: halo_age_max <= slo,
   SLO=0 logits against the plain full-graph forward on the card, the
   SLO=None pass against SLO=0, a repeated request bit-identical, and
   every kernel's launch counter risen during the 32 requests. Then the
   same over a zero int8, a zero bf16 and a zero vq store: SLO=0 (every
   refresh push quantizes, rounds or encodes) against the port's CPU
   `serve_request` on the same store and queries (a vq store's codes
   >= 99.9% equal, each differing code a near-tie), SLO=None, a
   bit-identical warm repeat, `hist_quant_err`, the store's bytes, the
   vq codebooks and statistics unchanged by serving, and the counters of
   the store's kernels (these runs give the launches of the int8, bf16
   and vq rows timed in phase 2 at their shapes).
3c. operator serving — on the same graph, 3 layers, seeded weights and
   zero stores: GAT at phase 4's widths (8 heads of 64), PNA at table
   5's `gas-pna` (48 wide, log_deg_mean 1.8) and GIN at 256. Over f32
   stores the 16 x 128 queries at SLO=0, and the f32 full-graph forward
   on the card at the same nodes, against the same forward in float64 on
   the CPU (1e-4), then at SLO=None, halo_age_max <= slo, a warm
   repeat bit-identical, p50/p99 and the host batch build; over int8
   stores (GAT, PNA) 4 requests of 32 queries against the port's CPU
   `serve_request` (SERVE_Q_TOL; the stores within one quantization step
   per row). The launch counters of each run's forward kernels
   (`edge_softmax_fwd`, `pna_reduce_fwd`, GIN's `bcsr_spmm` and
   `gather_spmm` over the unit-weight blocks, `gather_rows_dq` and
   `scatter_rows_q` over int8) must rise and no backward kernel may
   launch.
3d. split serving — GCN at the same shape through `core.serve_service`:
   a `ServeFrontend` over an `InProcTransport` to a `HistoryBackend` on
   the card, over an f32 store on the card and an int8 store in pinned
   host memory, 16 x 128 queries at SLO=0, every answer (and the
   backend's store after them) bitwise the in-process `serve_request`
   from the same state, split latency beside in-process; then GCN served
   in process from a pinned host store, bitwise the device store; then
   the launcher's two processes (`serve_gas --role backend --port 0
   --port-file F`, started before phase 3c, then `--role frontend
   --smoke`), each under a timeout, the frontend's smoke OK. In phase 2
   `scatter_rows_raw` (the backend's push of a frontend's encoded rows)
   has its rows: every width bitwise its plain version into pinned and
   device tables at the frontend's 128-row query push, timed into both
   beside the plain version, `index_copy_` or a pinned copy, and the
   bound.
3b. decode — first `flash_decode` against its plain version at qwen3's
   attention shapes (8 KV heads, G = 2, Dh = 128): B = 8 over a
   4,096-slot cache at pos 3,000, 0 and past the end (a rolling buffer),
   B = 8 over decode_32k's 32,768 slots, and one f32 case, within 1e-5
   in f32 and 2e-2 of the largest |output| in bf16 (a planted fault, one
   warp's slots dropped from the plain version, must fail that limit),
   the masked tail redrawn without moving the output a bit; the
   4,096-slot cases at pos 3,000 and past the end (LONG's shape) and the
   32,768-slot case timed beside the plain version and SDPA (and, with
   --parent-csrc, the parent checkout's kernel on its own plan).
   Then transformer serving: qwen3-0.6b at its published widths in bf16
   with seeded random weights (`init_params`), 8 MarkovTokens prompts
   each; FULL prefills 2,048 tokens into a 4,096-slot cache, LONG
   (window 4,096) 6,144 tokens rolled into its window; 64 greedy
   `decode_step`s each (28 x 64 `flash_decode` launches, checked), every
   step's logits against `forward` at the same position over the prompt
   and the tokens fed, and every layer's cache after the steps against
   `prefill`'s over the same tokens (the KV-cache check; a planted fault,
   each new k / v written one slot early, must fail its cache number),
   a step repeated from two
   clones of the cache bit-identical, one step under torch.profiler
   (flash_decode's share), prefill time, step p50/p99, tokens/s and peak
   device memory; and 2 layers at the same widths in f32, prefill and 8
   decode steps on the card against the same on the CPU (logits 1e-4,
   caches 1e-5).
4. training — (a) the GCN quickstart (2,500 nodes, 128 features, 7
   classes, 16 METIS parts, 2 layers, d_hidden=64), (b) GAT on the
   Cora shape (2,708 nodes, 1,433 features, 7 classes, 16 parts, 2
   layers, 8 heads of 8) and (c) table 5's `gas-pna` (4,000 nodes, 64
   features, 6 classes, 16 parts, 2 layers, d_hidden=48,
   log_deg_mean=1.8), f32 histories; then the three over int8
   histories, the GCN over bf16 ones and the GCN and GAT over vq ones
   (refit off, as `examples/quickstart.py --history-dtype vq`), on the
   same partitions. For
   each: two steps on the card against the same steps on the CPU with
   the plain versions, each from the same state (loss and gradients at
   1e-4; f32 tables at 1e-4, quantized tables within one quantization
   step per row with the share of equal codes; the update from the
   card's gradients on both devices, params and moments at 1e-6); 60
   epochs with the step time's p50/p99, the epoch time and the peak
   device memory; the store's bytes and `hist_quant_err`;
   `evaluate_exact`'s test accuracy at most 1 pp below the reference's
   at the same precision on the same partition (keyed by its hash; for
   PNA the lowest of the reference's runs one ulp apart); the launch
   counters of the path's kernels; and one more epoch under
   torch.profiler for the device's busy share (PNA over f32, with
   --parent-csrc: also one on the parent's kernels, then one more on
   this build's). Two steps of a bf16 GAT
   show the bf16 history pull (`gather_rows_bf16`) on its path, two
   steps of PNA over a vq store PNA's vq path, and a GCN vq run with
   `vq_refit_every=2` over 4 epochs the codebook refit on the card
   against the same refit on the CPU. Then the rest of the operator zoo
   at the repo's published widths, the same checks each (its own depth,
   part count, clusters per batch and epochs): (d) table 5's
   `gas-gcnii16` (PNA's graph and partition, d_hidden=48, 16 layers,
   alpha 0.1, 60 epochs) over f32 and over int8 histories, (e) table 2's
   `gin-4L-cluster` (the 900-node CLUSTER SBM, 4 layers, d_hidden=48, 24
   parts, 8 clusters per batch regrouped each epoch, 80 epochs; the
   fused route over the unit-weight blocks), (f) the deep-GNN example's
   GIN with the Eq. 3 regularizer (the 6,000-node SBM, d_hidden=64,
   reg_delta = reg_weight = 0.05, 40 parts, 10 clusters per batch, 40
   epochs; every layer materialized; its two steps take the card's noise
   on the CPU too, and its accuracy is held below the lowest of six
   reference runs under six rng keys) and (g) table 1's `appnp-5L`
   (1,200 nodes, 5 layers, alpha 0.1, 8 parts, 60 epochs; 6-wide
   history tables). Every run's per-epoch `hist_quant_err` is held to
   its precision's analytic bound (0 for f32, 2^-8 for bf16, sqrt(d)/254
   for int8, below 1 for vq), and `scatter_rows_vq` pushes (ragged, a
   fifth of the rows exactly zero) to the codebook distortion of each
   row (`[bounds]`).
5. table 5 — `benchmarks/table5_baselines.py:run(quick=False)`'s rows at
   its full sizes through the port's trainers, on PNA's graph and
   partition: `graphsage` (`GraphSAGETrainer`: d_hidden 48, 2 layers,
   fanout 10, batch 256, 15 epochs; the host sampler, then each step on
   the card), `sgc` (`SGCTrainer`: k = 2, 240 epochs, lr 0.05),
   `cluster-gcn` (`GASTrainer(use_history=False)`) and `gas-gcn`
   (`GASTrainer`, GCN 48 wide), 60 epochs each, through their `fit`;
   `gas-gcnii16` and `gas-pna` are phase 4's runs. For each row the
   train time, step p50 and test accuracy, held at most 1 pp below the
   reference's (the GAS rows' by partition digest, GraphSAGE's and
   SGC's below the lowest of six seeds), and the GAS rows' launches.
6. host-store — history tables in pinned host memory and the pipelined
   epoch (`history_storage`, `prefetch_depth`): the GCN quickstart over
   f32 and int8, GAT over vq (a refit at epoch 2, over a host table
   too) and the deep-GNN example's GCNII-32L (10,000 nodes, f32; its
   31 tables are 79.4 MB), each 3 epochs under device/0, host/0, host/1
   and device/1 in turn. For each: bitwise equal to device/0 (params,
   moments, tables, scales, codes, codebooks, clock, epoch metrics),
   the store's device and host bytes, the run's peak device memory,
   step p50/p99, the launches of `gather_rows_raw` and the pushes, and
   every host table pinned. Then one depth-1 host epoch of GAT under
   torch.profiler in a child process: the device's busy share and how
   much of the side stream's prefetch time overlaps main-stream kernels.
   In phase 2 `gather_rows_raw` has its rows: every element width
   bitwise its plain version from a pinned and a device table, and its
   time at GAT's halo from each, beside the host link's bandwidth
   (one large pinned copy).
7. evolving graphs — `benchmarks/dyn_bench.py`'s configuration at its
   full size (2,500 nodes, 32 features, homophily 0.8, seed 77; a
   3-layer GCN, 64 wide; 8 parts, its METIS partition computed in a
   worker process; 2 epochs; f32 device store). (a) For each churn of
   0.002, 0.01 and 0.05 one `random_delta` (2 new nodes, churn / 2 of
   the features drifted) on the trained plan: the incremental
   `advance`, one untimed pass then the best of 3, its time and its
   partition / batches / re-push split, the closure fraction, rebuilt
   parts and moved nodes; checked on the card: the patched batches
   bitwise a from-scratch `build_batches` at the same pads (both block
   families, the card's stack too), rows outside the delta's
   out-closure bitwise the grown old store (tables and ages), rows
   inside bitwise an independent re-push of the closure through
   `gas_batch_forward(fuse_halo=False)` on the grown store, their ages
   0, the old plan and state unchanged (digests before and after), and
   the re-push's launches (`bcsr_spmm`, `gather_rows`, `scatter_rows`,
   no fused aggregation and no backward kernel). One cold rebuild at 1%
   churn beside it and the incremental/cold ratio beside the reference
   bench's 30% (recorded, not asserted), then one epoch on the advanced
   plan (step p50/p99, a finite loss). (b) GCN, GIN, GAT (8 heads of 8),
   GCNII, APPNP and PNA, 3 layers and 64 wide, over f32 and int8, and
   GAT over vq: 1 epoch, one incremental advance at 1% churn, the
   checks of (a) (int8 scales bitwise too; vq codebooks and statistics
   unchanged by `grow`), and each op's re-push kernels launched. (c)
   GCN over f32 and int8 in pinned host memory at prefetch depth 1:
   the advance's grown tables pinned, the store's device and host bytes,
   every table, scale and age bitwise the device store's advance, then
   one pipelined epoch bitwise the device store's synchronous one. (d)
   `python -m repro_torch.launch.train_dynamic --smoke` in a child
   process under a timeout, its "smoke OK".
8. distributed GAS — `examples/distributed_gas.py`'s configuration at
   its full size (2,000 nodes, 64 features, 6 classes, homophily 0.72,
   noise 2.2, seed 7; its METIS partition into 4 parts computed in a
   worker process; a 3-layer GCN 48 wide), 4 ranks spawned on the one
   card in one gloo group (a `core.dist_gas.RankPool` started right
   after the build, its ranks' start overlapping phases 2-7), every halo
   exchange and gradient all-reduce staged through pinned host buffers.
   (a) The example (`repro_torch.examples.distributed_gas.train_rank`):
   80 supersteps, clip 2.0 then AdamW; a `[setup]` line with the
   partition's digest, rows, max_halo and C; the world size, backend and
   each rank's device; superstep p50/p99, exchange and all-reduce ms a
   superstep and their four parts summed over every collective (the wait
   for the rank's queued kernels, the copy to pinned memory, the gloo
   call, the copy back), wire bytes; params bitwise across ranks; the exact
   forward's test accuracy within 1 pp of the reference's on the same
   partition (DIST_REF_ACC, keyed by digest); each rank's
   `gather_rows_raw` and `scatter_rows_raw` launches, each above 0.
   (b) Exchanges of a 48-wide f32, bf16 and int8 table (codes, then
   scales) bitwise a direct gather on every rank, their wire bytes, and
   GCN supersteps over f32, bf16 and int8 stores (the f32/int8 and
   f32/bf16 wire-byte ratios a superstep; `scatter_rows_q` launched on
   every rank for int8). (c) GCN, GIN, GAT, GCNII, APPNP and PNA, 3
   supersteps each from fixed params: the logits within 1e-3 of the
   exact full-graph forward after the last, the error falling, the
   summed gradients bitwise on every rank. Phase 2's kernel JSON gains
   three rows at the example's shapes: the exchange's pack
   (`gather_rows_raw`) and unpack (`scatter_rows_raw`) and the int8
   push (`scatter_rows_q`), each bitwise its plain version.

Phase 9, the seq-GAS scaffold and the other layer types (after phase
8): (a) `flash_decode` at recurrentgemma-9b's heads (B 8, Kh 1, G 16, Dh
256, the 2,048-slot window) in bf16 and f32, every slot valid and pos
inside the buffer, against its plain version, timed beside its bound
and SDPA (a kernels-line row, its launches from (b)). (b)
recurrentgemma-9b at its published widths in bf16 (rec, rec, local;
seeded weights): 8 MarkovTokens prompts of 3,072 tokens rolled into the
2,048-slot local caches, 64 greedy decode steps, every step's logits
against `forward` over the prompt and the tokens fed (in bf16, printed;
against the f32 truth on 2 sequences, no farther than the bf16 forward
is; the weights widened to f32 then decode within 1e-4 of max |logit| of
the f32 forward), a repeated step bit-identical, one step profiled, a
`[decode]` line; then one pattern repeat in f32 (B 1, 256 prompt
tokens, 8 steps) on the card against the CPU. (c) seq-GAS on qwen3-0.6b at its published
widths: the chunked forward against the full one in f32 (B 1, T 2,048,
chunks of 256), then 20 AdamW steps of `chunked_loss` in bf16 (B 1, T
4,096, chunks of 512; the last loss below 0.8 x the first), step p50,
tokens/s and the peak memory of a `chunked_loss` step beside a `loss_fn`
step. (d) hubert-xlarge at its published widths in f32 (B 1, 1,024
frames, chunks of 256): 49 bidirectional passes, the error against the
full forward every 8 passes, the first above its tolerance, the last
below. (e) the moe and cross layers (no published config: SMOKE widths
under the tests' overrides): forward, prefill and 8 decode steps on the
card against the CPU in f32.

    python3 chip_smoke.py --save-partitions chiprun_out/partitions.npz

also writes the training partitions (the port's METIS-like partitioner
on this host; GCNII's is PNA's) for `tests/test_torch_train.py
--reference-acc [--history-dtype ...] [--op ...]`, and phase 8's as
"dist" for `tests/test_torch_dist_gas.py --reference-acc`.

    mkdir -p build/parent-src
    git archive PARENT src/repro_torch/kernels/csrc | tar -x -C build/parent-src
    python3 chip_smoke.py --parent-csrc build/parent-src/src/repro_torch/kernels/csrc

also builds the kernels of another checkout (its C entry points must
have this build's signatures, but for `scatter_rows` and `flash_decode`,
which are called with the parent's own, and the history pulls, whose
entries from before the pulls clipped their own indices take no row
count, `_UnclippedParent`; `scatter_rows_q` is always handed a winner
scratch) and times its block contraction, the history
pulls `gather_rows` (f32 and bf16), `gather_rows_dq` and
`gather_rows_vq` (warm and with the L2 flushed, outputs bitwise; the
indices clipped once before any timing), `scatter_rows` (f32 and bf16),
`scatter_rows_q` and `scatter_rows_vq`
(at both push shapes; and on rows holding inf and NaN, bitwise),
`flash_decode`, the three edge-softmax kernels and PNA's three kernels
beside this build's on the same inputs in phases 2 and 3b, their
outputs compared.

    python3 chip_smoke.py --pna-edges 2,8

also builds the kernels once per number of queued edges that PNA's
drains load together (`csrc/pna_reduce.cu`'s REPRO_PNA_EDGES; 4 in this
build) and times its three kernels on each beside this build's on the
same operands, outputs bitwise this build's (`[pna-edges]` lines).

    python3 chip_smoke.py --vq-ablation

also builds the kernels once per build switch of `scatter_rows_vq`'s
search (`csrc/scatter.cu`, each mechanism off) and, after phase 2, times
each vq push of the main path (and three pushes between the training and
the refit push) at every lane split and on every such build, each output
bitwise the plain version's (`[vq-ablation]` lines).

Then it prints the kernels line (JSON), the card's name and power limit
(nvidia-smi), and as the last line {"ok": true, "device": {...}}. Without
a CUDA device, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import ctypes
import dataclasses
import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import delta as DL  # noqa: E402
from repro_torch.core import _rank_bodies as RB  # noqa: E402
from repro_torch.core import dist_gas as DG  # noqa: E402
from repro_torch.core import dynamic as DY  # noqa: E402
from repro_torch.core import gas as G  # noqa: E402
from repro_torch.core import partition as P  # noqa: E402
from repro_torch.core import runtime as RT  # noqa: E402
from repro_torch.core import seq_gas as SEQ  # noqa: E402
from repro_torch.core import serve as S  # noqa: E402
from repro_torch.core import serve_service as SS  # noqa: E402
from repro_torch.core.config import resolve_device  # noqa: E402
from repro_torch.core.history import (  # noqa: E402
    VQ_SUBDIM, HistoryStore, vq_init_codebook)
from repro_torch.data.graphs import (  # noqa: E402
    citation_graph, sbm_cluster_graph)
from repro_torch.data.tokens import MarkovTokens  # noqa: E402
from repro_torch.examples import distributed_gas as EX  # noqa: E402
from repro_torch.examples import seq_gas_long_context as EXSEQ  # noqa: E402
from repro_torch.gnn import model  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import scatter as scatter_mod  # noqa: E402
from repro_torch.kernels import edge_softmax as esk  # noqa: E402
from repro_torch.kernels import pna_reduce as pnk  # noqa: E402
from repro_torch.kernels.bcsr_spmm import bcsr_spmm  # noqa: E402
from repro_torch.kernels.decode_attn import flash_decode  # noqa: E402
from repro_torch.kernels.fused import gather_plan, gather_spmm  # noqa: E402
from repro_torch.kernels.gather import (  # noqa: E402
    dq_plan, gather_rows, gather_rows_dq, gather_rows_raw,
    gather_rows_vq, row_plan, vq_plan)
from repro_torch.kernels.scatter import (  # noqa: E402
    SCAN_MAX_ROWS, scatter_rows, scatter_rows_q, scatter_rows_raw,
    scatter_rows_vq)
from repro_torch.models import attention as ATT  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.train import checkpoint as CK  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    clip_by_global_norm, grad_leaves, tree_leaves, tree_map)

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# f32 outside the tensor cores — the kernels' bound_ms uses these; and the
# special-function rate of compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput): 16 results per clock per SM
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SFU_PER_CLOCK_PER_SM, N_SMS = 16, 132

N_NODES, AVG_DEGREE, N_FEATURES, N_CLASSES = 19717, 4.5, 500, 3
D_HIDDEN, N_LAYERS = 256, 3
N_REQUESTS, QUERY_SIZE, SEED = 16, 128, 0
# bcsr_spmm / gather_spmm against their plain versions, and serving
# against the full-graph forward: the same f32 sums taken in another order
RTOL, ATOL = 1e-4, 1e-4
TIMED_REPS = 25
# `_times_ms(fn, cold=True)` reads this many bytes (more than twice the
# H100's 50 MB L2) before each timed call: its lines are clean, so no
# write-back of an earlier call's dirty lines lands in the timed interval
L2_FLUSH_BYTES = 128 << 20
_L2_FLUSH = []
# `--parent-csrc DIR`: the kernel library built from another checkout's
# sources (the parent commit's), whose block contraction phase 2 runs
# through the same wrappers on the same inputs beside this build's; None
# without it, and then each contraction's time is printed beside
# EARLIER_MS: the dense block core's times on the same shapes (NVIDIA H100
# 80GB HBM3, 700.00 W), from PERF.md's kernel table and, for the
# dense-block and training lines, from this script run with --parent-csrc
PARENT_LIB = None
# `--vq-ablation`: the encoding push's search with each of its mechanisms
# turned off, one library per csrc/scatter.cu build switch
# ({label: (defines, library)}), timed at the main path's pushes into a vq
# store (and three between the training and refit pushes, where the
# plan's split changes) beside every lane split of this build, VQ_ROUNDS
# rounds each
VQ_ABLATION = {"one chain": ("REPRO_VQ_CHAINS=1",),
               "whole-slice staging": ("REPRO_VQ_HALVES=0",),
               "no bank padding": ("REPRO_VQ_PAD=0",)}
VQ_ABLATION_LIBS = {}
VQ_PUSHES = (("GCN training push", 179, 64), ("GAT training push", 194, 64),
             ("PNA training push", 287, 64), ("1,024 rows", 1024, 64),
             ("1,536 rows", 1536, 64), ("2,048 rows", 2048, 64),
             ("GCN refit push", 2501, 64),
             ("serving refresh push", 4096, 256))
VQ_ROUNDS = 5
# `--pna-edges N,...`: libraries built with each N queued edges loaded
# together by PNA's drains (csrc/pna_reduce.cu's REPRO_PNA_EDGES),
# {N: library}; PNA's three kernels are timed on each beside this build's
PNA_EDGE_LIBS = {}
# the training run whose profiled epoch also runs on the parent's kernels
# with --parent-csrc (the kernels this version redesigned are on its path:
# GAT over vq pulls its halo rows through gather_rows_vq and its features
# through gather_rows)
PARENT_EPOCH_RUN = ("gat", "vq")
# the history pulls' kernels (`ops.pull_rows`), one launch a pull
PULL_KERNELS = ("gather_rows", "gather_rows_bf16", "gather_rows_dq",
                "gather_rows_vq")
EARLIER_MS = {"bcsr_spmm": 2.016, "gather_spmm": 1.877,
              "gather_spmm_bf16": 1.965, "gather_spmm_dq": 2.031,
              "gather_spmm_vq": 1.942,
              "bcsr_spmm on dense blocks (refresh batch shape, D=500)": 2.0535,
              "bcsr_spmm on forward training blocks (D=128)": 0.0678,
              "bcsr_spmm on transposed training blocks (D=128)": 0.0373}

# Phase 4. The training configurations and the reference's exact test
# accuracy for each after 60 epochs on the "jnp" backend, per history
# precision, from the port's initial params (`init_gnn(spec, seed=0)`)
# carried across, so both runs share graph, partition, weights, store
# precision and hyperparameters. The METIS-like
# partition depends on the host (the same code and seed gave an H100 host
# other partitions than the CPU where the reference ran; the `[setup]`
# lines show whether the coarsening's degree orders part ways), so each
# accuracy is keyed by the first 12 hex digits of the sha256 of its
# partition. Measured on a CPU (jax 0.9.0)
# with `PYTHONPATH=src python tests/test_torch_train.py --reference-acc
# [PARTITIONS.npz] [--history-dtype int8|bf16|vq]` (vq: the reference
# starts from the port's initial codebooks): the first entry on the
# partitions computed there, the second on the ones an H100 host computed
# (`--save-partitions` above). PNA's training is chaotic at table 5's
# lr 0.01: two trajectories that agree step by step at rounding level
# part within a few epochs (`tests/test_torch_train.py --trajectory`), and
# the reference's own test accuracy moves by several pp when its initial
# weights move by one ulp. So a PNA entry holds the reference's runs from
# the unperturbed weights and from one-ulp perturbations of them
# (`--perturb 0 1 ...`), and the port is held at most 1 pp below the
# lowest of them. GAT over a vq store is chaotic too (its six runs span
# 0.9667-0.9824 on the card's partition and 0.9672-0.9824 on the CPU's;
# GCN's over vq agree to all digits at perturb 0, 1 and 2), so its
# entries hold six runs as PNA's do. The zoo's (`--op gcnii`,
# `gin`, `gin+reg`, `appnp`): the SBM and APPNP partitions are the same
# on both hosts, GCNII's is PNA's. Table 2's GIN is chaotic too (six
# runs one ulp apart span 0.8444-0.9167), GCNII spans 0.3 pp (int8 0.1
# pp) on the card's partition (0.9631 in one run on the CPU's), APPNP
# gives 0.9613 in all six; the regularized GIN's entry holds six rng keys
# (`--rng-key 1 ... 6`): in four of them the reference stays near chance
# (0.0975-0.1050 of 10 classes) after 40 epochs, one reaches 0.4758.
TRAIN_EPOCHS, TRAIN_PARTS, TRAIN_HIDDEN = 60, 16, 64
# each configuration's spec beside its graph: GCN and GAT at TRAIN_HIDDEN;
# PNA is table 5's `gas-pna` (benchmarks/table5_baselines.py: its graph,
# d_hidden=48, log_deg_mean=1.8, lr 0.01)
TRAIN_CONFIGS = {
    "gcn": dict(graph=dict(num_nodes=2500, num_features=128, num_classes=7,
                           homophily=0.75, feature_noise=2.0, seed=0),
                ref_test_acc={
                    "f32": {"8667bd3900f3": 0.9586901664733887,
                            "c2fcdf3f120a": 0.9591939449310303},
                    "int8": {"8667bd3900f3": 0.9586901664733887,
                             "c2fcdf3f120a": 0.9591939449310303},
                    "bf16": {"8667bd3900f3": 0.9586901664733887,
                             "c2fcdf3f120a": 0.9591939449310303},
                    "vq": {"8667bd3900f3": 0.9612090587615967,
                           "c2fcdf3f120a": 0.9627203941345215}}),
    "gat": dict(graph=dict(num_nodes=2708, num_features=1433, num_classes=7,
                           seed=0),
                ref_test_acc={
                    "f32": {"368f7b8cb6f7": 0.9680851101875305,
                            "41734945d697": 0.9764107465744019},
                    "int8": {"368f7b8cb6f7": 0.9653099179267883,
                             "41734945d697": 0.977798342704773},
                    "vq": {"368f7b8cb6f7": (0.9824236631393433,
                                            0.9814985990524292,
                                            0.9768732786178589,
                                            0.979185938835144,
                                            0.978723406791687,
                                            0.9671600461006165),
                           "41734945d697": (0.9824236631393433,
                                            0.9759482145309448,
                                            0.9824236631393433,
                                            0.9666975140571594,
                                            0.9694727063179016,
                                            0.9722478985786438)}}),
    "pna": dict(graph=dict(num_nodes=4000, num_features=64, num_classes=6,
                           homophily=0.7, feature_noise=2.5, seed=80),
                spec=dict(d_hidden=48, log_deg_mean=1.8),
                ref_test_acc={
                    "f32": {"2f9649d2dcc0": 0.8664634227752686,
                            "b441af5c2589": (0.8454268574714661,
                                             0.8161585330963135,
                                             0.8515244126319885,
                                             0.8615853786468506,
                                             0.8853658437728882,
                                             0.8493902683258057)},
                    "int8": {"2f9649d2dcc0": 0.8634146451950073,
                             "b441af5c2589": (0.8253048658370972,
                                              0.8804877996444702,
                                              0.8850609660148621,
                                              0.8582317233085632,
                                              0.8615853786468506,
                                              0.8844512104988098)}}),
    # table 5's `gas-gcnii16` (benchmarks/table5_baselines.py:51): PNA's
    # graph and partition, 16 layers, alpha 0.1
    "gcnii": dict(graph=dict(num_nodes=4000, num_features=64, num_classes=6,
                             homophily=0.7, feature_noise=2.5, seed=80),
                  spec=dict(d_hidden=48, num_layers=16, alpha=0.1),
                  partition_of="pna",
                  ref_test_acc={
                      "f32": {"2f9649d2dcc0": 0.9631097316741943,
                              "b441af5c2589": (0.8335365653038025,
                                               0.8332316875457764,
                                               0.8338414430618286,
                                               0.8307926654815674,
                                               0.8335365653038025,
                                               0.8335365653038025)},
                      "int8": {"2f9649d2dcc0": 0.9631097316741943,
                               "b441af5c2589": (0.8557927012443542,
                                                0.8560975790023804,
                                                0.8557927012443542,
                                                0.855182945728302,
                                                0.8557927012443542,
                                                0.8560975790023804)}}),
    # table 2's `gin-4L-cluster` (benchmarks/table2_ablation.py:52-71):
    # the CLUSTER SBM, 24 parts, 8 clusters per batch, 80 epochs
    "gin": dict(kind="sbm", graph=dict(num_nodes=900, num_communities=6,
                                       seed=22),
                spec=dict(d_hidden=48, num_layers=4),
                config=dict(num_parts=24, clusters_per_batch=8, epochs=80),
                ref_test_acc={"f32": {"bd103d0d8f27": (0.9166666865348816,
                                                       0.8777777552604675,
                                                       0.894444465637207,
                                                       0.8833333253860474,
                                                       0.8444444537162781,
                                                       0.8888888955116272)}}),
    # the deep-GNN example's GIN with the Eq. 3 regularizer
    # (examples/deep_gnn_large_graph.py:46-54): 40 parts, 10 clusters per
    # batch, 40 epochs. Its noise is not the reference's, so an entry
    # holds the reference's runs under six rng keys (1-6; 1 is
    # `init_state`'s seed + 1) from the same initial weights
    "gin+reg": dict(op="gin", kind="sbm",
                    graph=dict(num_nodes=6000, num_communities=10, seed=2),
                    spec=dict(d_hidden=64, num_layers=4, reg_delta=0.05,
                              reg_weight=0.05),
                    config=dict(num_parts=40, clusters_per_batch=10,
                                epochs=40),
                    ref_test_acc={"f32": {"d5434838cd8b": (
                        0.09749999642372131, 0.47583332657814026,
                        0.10499999672174454, 0.09749999642372131,
                        0.09749999642372131, 0.1991666704416275)}}),
    # the deep-GNN example's GCNII-32L (examples/deep_gnn_large_graph.py:
    # 22-36: d_hidden 64, 32 layers, alpha 0.1, nodes // 800 parts, 2
    # clusters a batch, lr 0.01) at 10,000 of its 20,000 nodes: the
    # pure-Python partition takes ~3x as long at 20,000. Only the
    # host-store phase runs it, HOST_EPOCHS epochs a variant
    "gcnii32": dict(op="gcnii",
                    graph=dict(num_nodes=10000, avg_degree=8,
                               num_features=128, num_classes=10,
                               homophily=0.7, feature_noise=2.0, seed=1),
                    spec=dict(d_hidden=64, num_layers=32, alpha=0.1),
                    config=dict(num_parts=12, clusters_per_batch=2)),
    # table 1's `appnp-5L` (benchmarks/table1_full_vs_gas.py:16-36), seed
    # 0's graph: 8 parts, 5 layers, 6-wide history tables
    "appnp": dict(graph=dict(num_nodes=1200, num_features=64, num_classes=6,
                             homophily=0.72, feature_noise=2.2, seed=10),
                  spec=dict(num_layers=5, alpha=0.1),
                  config=dict(num_parts=8),
                  ref_test_acc={"f32": {"0339ee90b37c": 0.9612832069396973}}),
}
# Phase 6, host-store: each run (label, configuration, precision, config
# changes) goes through HOST_VARIANTS in turn, in one process so that
# they share the host's run-to-run spread, HOST_EPOCHS epochs each;
# every variant must be bitwise the first (device storage, depth 0)
HOST_EPOCHS = 3
HOST_RUNS = (("gcn f32", "gcn", "f32", {}), ("gcn int8", "gcn", "int8", {}),
             ("gat vq", "gat", "vq", {"vq_refit_every": 2}),
             ("gcnii-32L f32", "gcnii32", "f32", {}))
HOST_VARIANTS = (("device", 0), ("host", 0), ("host", 1), ("device", 1))
# the training runs of phase 4, in order: (configuration, history
# precision)
TRAIN_RUNS = (("gcn", "f32"), ("gat", "f32"), ("pna", "f32"),
              ("gcn", "int8"), ("gat", "int8"), ("pna", "int8"),
              ("gcn", "bf16"), ("gcn", "vq"), ("gat", "vq"),
              ("gcnii", "f32"), ("gcnii", "int8"), ("gin", "f32"),
              ("gin+reg", "f32"), ("appnp", "f32"))
# Phase 7, evolving graphs: benchmarks/dyn_bench.py's configuration at
# its full size (`run(quick=False)`, :48-58): the graph, a 3-layer GCN 64
# wide, 8 parts, 2 epochs, and one `random_delta` per churn on the trained
# plan (deltas not chained), each advanced DYN_PASSES times after an
# untimed pass, the best kept (the bench's PASSES); the cold rebuild at
# DYN_COLD_CHURN only (its METIS runs on the host, ~10 s a pass)
DYN_GRAPH = dict(num_nodes=2500, num_features=32, num_classes=4,
                 homophily=0.8, seed=77)
DYN_PARTS, DYN_EPOCHS, DYN_PASSES = 8, 2, 3
DYN_CHURNS = (0.002, 0.01, 0.05)
DYN_COLD_CHURN = 0.01
# the reference bench's contract at 1% churn: incremental <= 30% of cold
DYN_REF_RATIO = 0.30
# phase 7b: every operator over f32 and int8, GAT over vq too
DYN_OP_RUNS = tuple((op, hd) for op in ("gcn", "gin", "gat", "gcnii",
                                        "appnp", "pna")
                    for hd in ("f32", "int8")) + (("gat", "vq"),)
DYN_AGG = {"gcn": "bcsr_spmm", "gin": "bcsr_spmm", "gcnii": "bcsr_spmm",
           "appnp": "bcsr_spmm", "gat": "edge_softmax_fwd",
           "pna": "pna_reduce_fwd"}
DYN_PULL_PUSH = {"f32": ("gather_rows", "scatter_rows"),
                 "int8": ("gather_rows_dq", "scatter_rows_q"),
                 "vq": ("gather_rows_vq", "scatter_rows_vq")}
DYN_LAUNCHER_TIMEOUT = 300
# Phase 8, distributed GAS: examples/distributed_gas.py's configuration
# at its full size (the graph, 4 ranks, a 3-layer GCN 48 wide, 80
# supersteps, clip 2.0 then AdamW; not cut), the 4 ranks on the one card
# in one gloo group
DIST_RANKS = 4
DIST_SUPERSTEPS = 80
# the reference example's test accuracy after its 80 supersteps from the
# port's initial params (`init_gnn(spec, seed=0)`) carried across, keyed
# by the partition's digest as TRAIN_CONFIGS is (`python
# tests/test_torch_dist_gas.py --reference-acc [PARTITIONS.npz]`, a CPU,
# jax 0.9.0; the file's "dist" entry, from --save-partitions): the first
# on the partition computed there, the second on the one an H100 host
# computed; the port is held within ACC_SLACK of it
DIST_REF_ACC = {"1bd28335ed69": 0.9189873417721519,
                "d1bcb9e3e979": 0.9227848101265823}
# 8b: the exchanged tables' width (the example's hidden layers) and the
# GCN supersteps over each store precision; 8c: every operator's
# supersteps from fixed params, after which the logits must be the exact
# full-graph forward's within DIST_CONV_TOL (3 layers: 3 supersteps)
# 8a's last supersteps, run under torch.profiler on every rank (left out
# of the superstep times)
DIST_PROFILE_STEPS = 10
DIST_WIDTH = 48
DIST_STORE_STEPS = 2
DIST_OPS = ("gcn", "gin", "gat", "gcnii", "appnp", "pna")
DIST_CONV_STEPS = 3
DIST_CONV_TOL = 1e-3
DIST_KERNELS = ("gather_rows_raw", "scatter_rows_raw")
SERVE_KERNELS = ("gather_rows", "scatter_rows", "bcsr_spmm", "gather_spmm")
# phase 3c: the operators served at their published widths (GAT at phase
# 4's, 8 heads of 64; PNA at table 5's gas-pna, 48 wide; GIN at phase 3's
# 256), each one's forward kernels (GIN's bcsr_spmm and gather_spmm over
# the unit-weight blocks); no backward kernel may launch; over int8 (GAT
# and PNA) OP_SERVE_Q_REQUESTS requests against the CPU's serve_request
OP_SERVE = {"gat": dict(d_hidden=64, heads=8),
            "pna": dict(d_hidden=48, log_deg_mean=1.8),
            "gin": dict(d_hidden=D_HIDDEN)}
OP_SERVE_KERNELS = {"gat": ("edge_softmax_fwd", "gather_rows",
                            "scatter_rows"),
                    "pna": ("pna_reduce_fwd", "gather_rows", "scatter_rows"),
                    "gin": ("bcsr_spmm", "gather_spmm", "gather_rows",
                            "scatter_rows")}
BACKWARD_KERNELS = ("edge_softmax_bwd_row", "edge_softmax_bwd_col",
                    "pna_reduce_bwd_row", "pna_reduce_bwd_col")
OP_SERVE_Q = ("gat", "pna")
# the CPU's plain versions serve a 128-query request at this shape in
# ~17 s (GAT) and ~80 s (PNA) on 4 cores, a 32-query one in ~1.3 and ~3.7 s
OP_SERVE_Q_REQUESTS, OP_SERVE_Q_SIZE = 4, 32
# phase 3d's two processes: the launcher's smoke (a 200-node graph, 2
# epochs of GCN training in the backend, SLO=0 held to the full forward at
# its SMOKE_TOL in the frontend), each process under this many seconds
SPLIT_LAUNCHER_ARGS = ("--smoke", "--slo", "0")
SPLIT_LAUNCHER_TIMEOUT = 300
# serving over a quantized store, SLO=0 on the card against the CPU: the
# logits' rtol (atol ATOL). An int8 push matched the CPU's codes in full
# at this shape; a bf16 push rounds each entry to 8 significant bits, and
# an entry the two devices compute a few f32 ulps apart near a rounding
# boundary lands one bf16 step apart (2 of 384 logits moved 1.7e-4, a
# relative 1.8e-3, on an H100): held to one bf16 step, 2^-8, relative. A
# vq push chose every code as the CPU did at this shape (all 1,261,888
# codes of the two tables equal after each of two requests on an H100; a
# code that flipped would move its subvector by a whole codebook step),
# so its logits differ by the f32 sums' order alone (1.1e-6): held to
# RTOL
SERVE_Q_TOL = {"int8": RTOL, "bf16": 2.0 ** -8, "vq": RTOL}
# serving over a quantized store: the feature pull and layer 0's
# aggregation as at f32, the push and the fused aggregation at the store's
SERVE_Q_KERNELS = {
    "int8": ("gather_rows", "scatter_rows_q", "bcsr_spmm", "gather_spmm_dq"),
    "bf16": ("gather_rows", "scatter_rows_bf16", "bcsr_spmm",
             "gather_spmm_bf16"),
    "vq": ("gather_rows", "scatter_rows_vq", "bcsr_spmm", "gather_spmm_vq")}
# each run's kernels; the GCN's second is its fused aggregation
_ES = ("edge_softmax_fwd", "edge_softmax_bwd_row", "edge_softmax_bwd_col")
_PNA = ("pna_reduce_fwd", "pna_reduce_bwd_row", "pna_reduce_bwd_col")
TRAIN_KERNELS = {
    ("gcn", "f32"): ("bcsr_spmm", "gather_spmm", "gather_rows",
                     "scatter_rows"),
    ("gat", "f32"): _ES + ("gather_rows", "scatter_rows"),
    ("gcn", "int8"): ("bcsr_spmm", "gather_spmm_dq", "gather_rows",
                      "scatter_rows_q"),
    ("gat", "int8"): _ES + ("gather_rows_dq", "gather_rows",
                            "scatter_rows_q"),
    ("pna", "f32"): _PNA + ("gather_rows", "scatter_rows"),
    ("pna", "int8"): _PNA + ("gather_rows_dq", "gather_rows",
                             "scatter_rows_q"),
    ("gcn", "bf16"): ("bcsr_spmm", "gather_spmm_bf16", "gather_rows",
                      "scatter_rows_bf16"),
    ("gcn", "vq"): ("bcsr_spmm", "gather_spmm_vq", "gather_rows",
                    "scatter_rows_vq"),
    ("gat", "vq"): _ES + ("gather_rows_vq", "gather_rows", "scatter_rows_vq"),
    ("pna", "vq"): _PNA + ("gather_rows_vq", "gather_rows",
                           "scatter_rows_vq"),
    # the zoo's fused layers aggregate through gather_spmm (GIN over the
    # unit-weight blocks); with the regularizer every layer is
    # materialized: the history pull is gather_rows
    ("gcnii", "f32"): ("bcsr_spmm", "gather_spmm", "gather_rows",
                       "scatter_rows"),
    ("gcnii", "int8"): ("bcsr_spmm", "gather_spmm_dq", "gather_rows",
                        "scatter_rows_q"),
    ("gin", "f32"): ("bcsr_spmm", "gather_spmm", "gather_rows",
                     "scatter_rows"),
    ("gin+reg", "f32"): ("bcsr_spmm", "gather_rows", "scatter_rows"),
    ("appnp", "f32"): ("bcsr_spmm", "gather_spmm", "gather_rows",
                       "scatter_rows"),
}
# every training run's per-epoch mean `hist_quant_err` (the mean relative
# L2 error of the pushed rows) under its precision's analytic bound, as
# tests/test_error_bounds.py and tests/test_torch_error_bounds.py hold
# them: exactly 0 for f32; 2^-8 for bf16's mantissa rounding; sqrt(d) /
# 254 for int8's per-row absmax scaling (d the widest history table); for
# vq strictly below 1 (its centroid 0 is pinned to zero)
def qerr_bound(hd: str, d: int) -> float:
    return {"f32": 0.0, "bf16": 2.0 ** -8, "int8": d ** 0.5 / 254,
            "vq": 1.0}[hd]


# scatter_rows_vq on ragged pushes with exact-zero rows (a fifth of the
# rows zero, 70% of them valid), each row's round-trip error held to its
# codebook distortion (and to its norm): (S codes a row, M rows, seed,
# log10 of the values' scale); tests/test_error_bounds.py's grid, then
# GAT's training push (M = 194, S = 8) and the serving refresh push's
# shape (M = 4,096, S = 32)
VQ_BOUND_PUSHES = ((1, 1, 0, -3.0), (2, 7, 2, 3.0), (3, 5, 3, -1.5),
                   (5, 12, 5, 0.5), (8, 194, 10, 0.0), (32, 4096, 11, 1.0))
# Table 5 (benchmarks/table5_baselines.py:run(quick=False)) at its full
# sizes, on table 5's graph (PNA's, TRAIN_CONFIGS) and its 16-part
# METIS-like partition (PNA's, from the worker processes); each row
# through the port's trainer entry points, 60 GAS epochs at lr 0.01:
# (row, trainer, its kwargs); `gas-gcnii16` and `gas-pna` are phase 4's
# ("gcnii", "f32") and ("pna", "f32") runs
TABLE5_ROWS = (
    ("graphsage", "sage", dict(d_hidden=48, num_layers=2, fanout=10,
                               batch_size=256, epochs=15, lr=0.01)),
    ("sgc", "sgc", dict(k=2, epochs=240, lr=0.05)),
    ("cluster-gcn", "gas", dict(use_history=False)),
    ("gas-gcn", "gas", dict(use_history=True)))
TABLE5_FROM_PHASE4 = (("gas-gcnii16", ("gcnii", "f32")),
                      ("gas-pna", ("pna", "f32")))
TABLE5_HIDDEN = 48
# the reference's test accuracy of each row. `gas-gcn` and `cluster-gcn`:
# after 60 epochs on the "jnp" backend from the port's initial params
# carried across, keyed by partition digest as TRAIN_CONFIGS is (`python
# tests/test_torch_train.py --reference-acc [PARTITIONS.npz] --op gas-gcn
# --op cluster-gcn --perturb 0 --perturb 1 --perturb 2`, a CPU, jax 0.9.0:
# the one-ulp perturbations agree with the unperturbed runs to all
# digits). `graphsage` and `sgc` draw their weights from torch's
# generator, not jax's, so each holds the reference's runs under
# `TrainConfig(seed=0..5)` (`python tests/test_torch_trainers.py
# --table5-baselines`), and the port is held 1 pp below their lowest
TABLE5_REF = {
    "gas-gcn": {"2f9649d2dcc0": 0.9475609660148621,
                "b441af5c2589": 0.944817066192627},
    "cluster-gcn": {"2f9649d2dcc0": 0.9375,
                    "b441af5c2589": 0.9445121884346008},
    "graphsage": (0.944817066192627, 0.9466463327407837, 0.9445121884346008,
                  0.9466463327407837, 0.9493902325630188,
                  0.9454268217086792),
    "sgc": (0.9420731663703918, 0.9393292665481567, 0.9445121884346008,
            0.9426829218864441, 0.9408536553382874, 0.9439024329185486),
}
# the kernels each GAS row must launch: without histories there is no
# fused aggregation, but the pulls and pushes still run
TABLE5_KERNELS = {"gas-gcn": ("bcsr_spmm", "gather_spmm", "gather_rows",
                              "scatter_rows"),
                  "cluster-gcn": ("bcsr_spmm", "gather_rows",
                                  "scatter_rows")}
# a code the card and the CPU chose apart must be a near-tie: the two
# entries' distances to the card's pushed subvector (summed left to right
# in f32, as the encode sums them) within this of each other
VQ_TIE = 1e-6
ACC_SLACK = 0.01             # at most 1 pp below the reference
# the optimizer on the card against the CPU's, both fed the card's
# gradients (rtol, atol by tree): the clip's global norm sums every
# gradient's square (91,712 of them in GAT's first weight) in another
# order on each device, so the clipped gradients differ by ulps, and the
# moments by more where they are small (a relative 2.6e-5 at an element
# of about 9e-6, seen on an H100): held at the gradients' 1e-4. An update
# is lr times a ratio of the two, so a param is held at lr * 1e-4
# absolute. A skipped clip, a wrong bias correction or a flipped sign
# moves them by orders more
OPT_TOL = {"params": (1e-6, 1e-6), "m": (1e-4, 1e-12), "v": (1e-4, 1e-12)}

# Transformer serving: qwen3-0.6b at its published widths in bf16 (its
# dtype), seeded random weights, DECODE_B MarkovTokens prompts each, then
# DECODE_STEPS greedy decode steps; (variant, prompt length, cache_len):
# FULL prefills 2,048 tokens into 4,096 slots (decode reads a masked
# tail), LONG (window 4,096) 6,144 tokens, rolled into its 4,096-slot
# window (every decode step past the end of the buffer)
DECODE_ARCH, DECODE_B, DECODE_STEPS, DECODE_SEED = "qwen3-0.6b", 8, 64, 0
DECODE_RUNS = (("full", 2048, 4096), ("long", 6144, None))
# each decode step's logits against forward's at the same position, both
# in bf16: max abs err <= DECODE_TOL x forward's max |logit|. The two
# paths round at other places (the decode's scores stay in f32, forward's
# are bf16 products; other matmul shapes), and the residual stream alone
# is rounded to bf16 56 times on the way (2^-9 relative each, ~1.5% as a
# random walk); an H100 gave 1.7-1.8% of max |logit| (0.0547-0.0625 of
# 3.3-3.4)
DECODE_TOL = 0.05
# the KV-cache check's second number: after the decode steps, every
# layer's k and v against `prefill`'s over the prompt and the tokens fed,
# max abs err <= DECODE_CACHE_TOL x that leaf's max |value|. The logits
# check above averages a slot's fault over the thousands of slots each
# head attends to; here a row in the wrong slot, or a roll off by one,
# moves by its own size. The control plants that fault in
# DECODE_CONTROL_STEPS steps of FULL and must fail this limit. An H100
# gave 1.7% (FULL) and 1.4% (LONG) sound, 128% under the planted fault,
# whose logits read 3.7% of max |logit|, inside DECODE_TOL
DECODE_CACHE_TOL = 0.1
DECODE_CONTROL_STEPS = 16
# flash_decode's rows: qwen3's attention shapes (Kh = 8, G = 2, Dh = 128)
# over the FULL cell's cache (B = 8, S = 4,096) and decode_32k's length
# (configs/base.py) at 8 of its 128 sequences; (B, S, pos, dtype, timed)
DECODE_KERNEL_CASES = ((8, 4096, 3000, torch.bfloat16, True),
                       (8, 4096, 0, torch.bfloat16, False),
                       (8, 4096, 5000, torch.bfloat16, True),
                       (8, 32768, 40000, torch.bfloat16, True),
                       (8, 4096, 3000, torch.float32, False))
# flash_decode against its plain version: f32 at the Pallas test's 1e-5
# (tests/test_kernels.py:148), rtol and atol; bf16 within
# DECODE_KERNEL_BF16_REL of the largest |output|. A sound bf16 kernel
# differs from the plain version by at most one flip of the output's
# rounding (the two round p against other running maxima), <= 2^-7 of
# the largest |output|. The Pallas test's absolute 2e-2 is the size of a
# typical output over thousands of slots (std ~sqrt(e / n_valid): ~0.03
# at 3,001 valid slots, ~0.009 at 32,768) and would pass a kernel that
# lost one warp's slots; a control drops them from the plain version and
# must fail this limit. An H100 gave 4.9e-4 and 2.4e-4 sound (limits
# 3.2e-3 and 8.7e-4), 0.020-0.072 with a warp's slots dropped
DECODE_KERNEL_F32_TOL, DECODE_KERNEL_BF16_REL = 1e-5, 2e-2

# Phase 9b: recurrentgemma-9b (configs/recurrentgemma_9b.py) at its
# published widths in bf16, seeded weights: REC_B MarkovTokens prompts of
# REC_PROMPT tokens (past the 2,048-slot window: the local caches roll),
# REC_STEPS greedy steps (the logits held as REC_TRUTH_B says below);
# then REC_F32: one pattern repeat (rec, rec, local) in f32, (batch,
# prompt, steps), the card against the CPU (logits REC_F32_TOL; every
# cache leaf, the RG-LRU's f32 state among them, the same)
REC_ARCH, REC_B, REC_PROMPT, REC_STEPS, REC_SEED = (
    "recurrentgemma-9b", 8, 3072, 64, 0)
REC_F32 = (1, 256, 8)
REC_F32_TOL = 1e-4
# the bf16 decode is held to the f32 truth (`forward` over the same bf16
# weights widened to f32) on the first REC_TRUTH_B sequences: its max abs
# error no more than REC_BF16_VS_FWD x the bf16 forward's. It is not held
# to the bf16 forward by DECODE_TOL as qwen3's is: here each bf16 path is
# ~5% of max |logit| from the truth on its own (38 layers, 26 of them
# rec; an H100 gave the bf16 forward 0.4016 and the decode 0.3848 of
# 7.553, 16 steps), so the two differ by ~6% (0.4375) wherever their
# roundings part. The widened weights then decode in f32, held to the f32
# forward within REC_F32_EXACT_REL x max |logit| (an H100 gave 1.9e-5):
# the program is exact at the published widths, and bf16 alone moves it
REC_TRUTH_B, REC_BF16_VS_FWD, REC_F32_EXACT_REL = 2, 1.25, 1e-4
# 9a: flash_decode at recurrentgemma's heads (Kh 1, G 16, Dh 256) over
# the window's 2,048 slots; (B, S, pos, dtype, timed)
REC_KERNEL_CASES = ((8, 2048, 3000, torch.bfloat16, True),
                    (8, 2048, 1000, torch.bfloat16, True),
                    (8, 2048, 3000, torch.float32, False),
                    (8, 2048, 1000, torch.float32, False))
# 9c: seq-GAS on qwen3-0.6b at its published widths. f32: (B, T, chunk),
# the chunked forward against the full one within SEQ_F32_TOL absolute
# (28 layers of f32 sums over up to 2,048 keys in another order; a chunk
# that read a wrong or stale history row would move logits of ~1 by
# ~0.1 or more). bf16: (B, T, chunk) at train_4k's length (its global
# batch of 256 cut to 1), SEQ_STEPS AdamW steps at SEQ_LR on the
# example's MarkovTokens; the last loss below SEQ_DROP x the first (the
# reference test's rule)
SEQ_ARCH = "qwen3-0.6b"
SEQ_F32, SEQ_BF16 = (1, 2048, 256), (1, 4096, 512)
SEQ_F32_TOL, SEQ_STEPS, SEQ_LR, SEQ_DROP = 1e-3, 20, 1e-3, 0.8
# 9d: hubert-xlarge at its published widths in f32, (B, frames, chunk);
# num_layers + 1 bidirectional passes (Theorem 2 on sequences: exact after
# them with frozen params); the first pass's error against the full
# forward above AUDIO_TOL, the last below (48 layers of f32 sums in
# another order; logits of ~1)
AUDIO_ARCH, AUDIO_SHAPE, AUDIO_TOL, AUDIO_EVERY = (
    "hubert-xlarge", (1, 1024, 256), 1e-3, 8)
# 9e: the moe and cross layers have no published config; the tests'
# overrides at SMOKE widths, f32, (label, arch, overrides); forward,
# prefill of MIXER_T tokens and MIXER_STEPS decode steps, the card
# against the CPU at MIXER_TOL (logits and every cache leaf)
MIXER_CASES = (
    ("moe", "qwen3-0.6b", dict(pattern=("moe",), num_experts=4, top_k=2)),
    ("cross", "qwen3-0.6b", dict(pattern=("dense", "cross"), family="vlm",
                                 num_image_tokens=4)))
MIXER_T, MIXER_STEPS, MIXER_TOL = 24, 8, 1e-5


def _phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:12]


def _degree_orders(g, num_parts: int) -> str:
    """The coarsening levels `metis_like_partition` walks and one digest
    over every level's degree order (the unstable argsort in
    `partition._coarsen`), the first level's digest beside it. The rest of
    the coarsening is deterministic given these orders, so where two
    hosts' partitions differ, a differing digest puts the cause in the
    argsort's order among equal degrees, and equal digests put it after
    the coarsening."""
    ptr, idx = g.indptr.astype(np.int64), g.indices.astype(np.int64)
    w = np.ones(len(idx))
    orders = []
    while len(ptr) - 1 > max(100, 8 * num_parts, 4 * num_parts):
        orders.append(np.argsort(-np.diff(ptr)))
        _, (cptr, cidx, cw, cid) = P._coarsen(ptr, idx, w)
        if cid >= len(ptr) - 1:
            break
        ptr, idx, w = cptr, cidx, cw
    return (f"{len(orders)} coarsening levels, degree orders "
            f"{_digest(np.concatenate(orders))} (level 0: "
            f"{_digest(orders[0])})")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, cold=False) -> float:
    """Median over TIMED_REPS calls of CUDA-event time (`_times_ms`)."""
    return statistics.median(_times_ms(fn, cold))


def _flush_l2() -> None:
    """Queue a read of L2_FLUSH_BYTES, evicting what the L2 held."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.ones(L2_FLUSH_BYTES // 4, device="cuda"))
    _L2_FLUSH[0].sum()


def _times_ms(fn, cold=False) -> list:
    """TIMED_REPS calls' CUDA-event times, after warm-up. Each call is
    queued behind a ~1 ms device sleep, so the host has issued all of its
    launches before the start event fires and the interval holds device
    time only, not the host's launch gaps. `cold`: the L2 is flushed
    (`_flush_l2`) before each sleep, outside the timed interval, so the
    call reads its inputs from device memory."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cold:
            _flush_l2()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _bound(n_bytes: float, flops: float, exps: float = 0.0,
           clock_hz: float = 1.0):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_F32_FLOPS,
                exps / (SFU_PER_CLOCK_PER_SM * N_SMS * clock_hz)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _row(name, source, replaces, err, ms, plain_ms, library_ms, n_bytes,
         flops, exps=0.0, clock_hz=1.0, library=None):
    """One kernel row; `library` names the yardstick where it is a
    composition of several PyTorch calls rather than one."""
    bound_ms, bound_by = _bound(n_bytes, flops, exps, clock_hz)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": None, "max_abs_err": err,
           "max_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    if library is not None:
        row["library"] = library
    return row


def _call_on(lib, fn):
    """`fn`, a wrapper call, on the kernels of another library `lib` with
    the same arguments; their launches are not counted."""
    saved, counts = _build._lib, dict(_build.launch_counts)
    _build._lib = lib
    try:
        return fn()
    finally:
        _build._lib = saved
        _build.launch_counts.update(counts)


def _parent_call(fn):
    """`fn`, a wrapper call, on the parent checkout's kernels (PARENT_LIB)
    with the same arguments; their launches are not counted."""
    return _call_on(PARENT_LIB, fn)


def _launch_floor(device, ctas):
    """{n: ms} for an empty kernel of this build's library on n CTAs of
    256 threads (a PNA row grid's CTA), for each n in `ctas`, timed by
    `_time_ms` as the kernel rows are: the time no launch goes under."""
    fn = _build.lib().repro_empty_kernel
    fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = _build.stream_ptr(device)
    return {n: _time_ms(lambda: _build.check(fn(n, 256, stream),
                                             "the empty kernel"))
            for n in ctas}


def _beside_earlier(label, fn, out, ms):
    """One phase-2 line: a contraction's time beside the earlier block
    core's. With --parent-csrc the parent's kernels run `fn` (the same
    wrapper call; their launches are not counted) on the same inputs, and
    their output is compared with `out`: equal values, equal bits."""
    if PARENT_LIB is None:
        earlier = EARLIER_MS.get(label)
        _phase("kernels", f"{label}: {ms:.4f} ms (the dense block core: "
               f"{'not measured' if earlier is None else f'{earlier} ms'}"
               f", PERF.md)")
        return
    old = _parent_call(fn)
    old_ms = _time_ms(lambda: _parent_call(fn))
    same = torch.equal(old, out)
    bits = same and torch.equal(old.view(torch.int32), out.view(torch.int32))
    _phase("kernels", f"{label}: {ms:.4f} ms, the parent's kernel "
           f"{old_ms:.4f} ms ({old_ms / ms:.2f}x) on the same inputs; "
           f"outputs equal {same}, bitwise {bits}, max diff "
           f"{float((old - out).abs().max()):.3g}")


def _beside_library_spread(label, fn, lib_name, lib_fn, cold=False):
    """A kernel's time beside one PyTorch call's on the same inputs, with
    the spread: TIMED_REPS timings of each in the order kernel, library,
    library, kernel, pooled per side (`cold`: the L2 flushed before each
    call); the gap counts as resolved where the two sides' interquartile
    ranges do not overlap."""
    times = {"kernel": [], lib_name: []}
    for side in ("kernel", lib_name, lib_name, "kernel"):
        times[side] += _times_ms(fn if side == "kernel" else lib_fn, cold)

    def spread(t):
        q = statistics.quantiles(t, n=4)
        return (f"median {statistics.median(t):.4f} ms [quartiles "
                f"{q[0]:.4f}-{q[2]:.4f}, range {min(t):.4f}-{max(t):.4f}]")

    qk = statistics.quantiles(times["kernel"], n=4)
    ql = statistics.quantiles(times[lib_name], n=4)
    verdict = ("the kernel resolvably slower" if qk[0] > ql[2] else
               "the kernel resolvably faster" if qk[2] < ql[0] else
               "not resolved (the quartile ranges overlap)")
    _phase("kernels", f"{label}: {len(times['kernel'])} timings a side in "
           f"two rounds of {TIMED_REPS}, the kernel {spread(times['kernel'])}"
           f", {lib_name} {spread(times[lib_name])}; {verdict}")


class _UnclippedParent:
    """A parent checkout's kernel library from before the history pulls
    clipped their own indices (`repro_gather_rows`, `_dq` and `_vq`
    without the table's row count, `_vq` without a launch plan), as this
    build's wrappers call it: each such entry drops what the parent's
    lacks and calls the parent's, so it must be handed indices already in
    [0, N). Phase 2's pulls are: their indices are clipped once, before
    any timing, so a parent's time leaves out the clamp launch its
    `pull_rows` paid; the parent's profiled epoch runs `_parent_pull_rows`,
    the parent's path. Every other entry is the parent's."""

    def __init__(self, lib):
        self._lib = lib
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        for name, argtypes in (
                ("repro_gather_rows", [ptr] * 3 + [i64] * 6 + [ptr]),
                ("repro_gather_rows_dq", [ptr] * 4 + [i64] * 6 + [ptr]),
                ("repro_gather_rows_vq", [ptr] * 5 + [i64] * 3 + [ptr])):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def repro_gather_rows(self, table, idx, out, m, n, *rest):
        return self._lib.repro_gather_rows(table, idx, out, m, *rest)

    def repro_gather_rows_dq(self, q, scales, idx, out, m, n, *rest):
        return self._lib.repro_gather_rows_dq(q, scales, idx, out, m, *rest)

    def repro_gather_rows_vq(self, codes, codebook, scales, idx, out, m, n,
                             s_n, n_codes, *plan_stream):
        return self._lib.repro_gather_rows_vq(codes, codebook, scales, idx,
                                              out, m, s_n, n_codes,
                                              plan_stream[-1])


def _parent_pull_rows(table, idx, **kw):
    """The parent commit's `ops.pull_rows`: a clamp launch, then the
    pull's kernel (`_NEW_PULL_ROWS`, this build's wrapper, which the
    parent's epoch runs on the parent's library)."""
    return _NEW_PULL_ROWS(table, torch.clamp(idx, 0, table.shape[0] - 1)
                          .to(torch.int32), **kw)


_NEW_PULL_ROWS = ops.pull_rows


def _pull_row(label, name, replaces, fn, plain_fn, lib_fn, library,
              parent_fn, n_bytes, ctas, case=None, flops=0):
    """A history pull's kernel row (`gather_rows`, `gather_rows_dq` or
    `gather_rows_vq`; `flops`: its multiplies):
    its output bitwise the plain version's; its time warm (the median of
    `_time_ms`) and with the L2 flushed before each launch (`cold_ms`),
    beside the same for the library yardstick (`lib_fn`), the plain
    version's, the bound (bytes) and the launch floor (an empty kernel on
    the plan's `ctas` CTAs); with --parent-csrc the parent's kernel
    (`parent_fn`) warm and cold on the same inputs, its output bitwise
    this one's."""
    out = fn()
    assert torch.equal(_bits(out), _bits(plain_fn())), \
        f"{label}: {name} differs from its plain version"
    ms, cold = _time_ms(fn), _time_ms(fn, cold=True)
    lib_ms, lib_cold = _time_ms(lib_fn), _time_ms(lib_fn, cold=True)
    floor = _launch_floor(out.device, (ctas,))[ctas]
    row = _row(name, "src/repro_torch/kernels/csrc/gather.cu", replaces, 0.0,
               ms, _time_ms(plain_fn), lib_ms, n_bytes, flops,
               library=library if library.startswith("composition") else None)
    row.update(cold_ms=cold, library_cold_ms=lib_cold, floor_ms=floor,
               ctas=ctas)
    if case is not None:
        row["case"] = case
    parent = "the parent's kernel not measured (no --parent-csrc)"
    if PARENT_LIB is not None:
        assert torch.equal(_bits(parent_fn()), _bits(out)), \
            f"{label}: {name} differs from the parent's kernel"
        old, old_cold = _time_ms(parent_fn), _time_ms(parent_fn, cold=True)
        row.update(parent_ms=old, parent_cold_ms=old_cold)
        parent = (f"the parent's kernel {old:.4f} ms warm ({old / ms:.2f}x)"
                  f", {old_cold:.4f} cold ({old_cold / cold:.2f}x), outputs "
                  f"bitwise equal")
    _phase("kernels", f"{label}: {name} {ms:.4f} ms warm ({ms - floor:.4f} "
           f"above the launch floor {floor:.4f} ms at {ctas} CTAs), "
           f"{cold:.4f} cold; bound {row['bound_ms']:.7f} ms by "
           f"{row['bound_by']} "
           f"({100 * row['bound_ms'] / cold:.1f}% of the cold time); "
           f"{library} {lib_ms:.4f} warm, "
           f"{lib_cold:.4f} cold; plain {row['plain_ms']:.4f}; {parent}")
    return row


def _parent_scatter_rows(table, idx, values):
    """The parent checkout's `scatter_rows` (PARENT_LIB) on the same
    operands: its launcher always takes the N-entry winner scratch of its
    claim passes. In place; returns `table`; no launch is counted."""
    m, (n, d) = idx.shape[0], table.shape
    winner = torch.empty((n,), dtype=torch.int32, device=table.device)
    sym = {torch.float32: "repro_scatter_rows_f32",
           torch.bfloat16: "repro_scatter_rows_bf16"}[table.dtype]
    _build.check(getattr(PARENT_LIB, sym)(
        table.data_ptr(), idx.data_ptr(), values.data_ptr(),
        winner.data_ptr(), m, n, d, _build.stream_ptr(table.device)),
        "the parent's scatter_rows")
    return table


def _push_kernels(label, M, fn):
    """The device kernels of one push (`fn`), from torch.profiler, as a
    phrase: one up to SCAN_MAX_ROWS rows (the one-launch scan), three past
    it (the claim passes); "not measured" where the profiler saw none."""
    kernels = _device_kernels(fn)
    if not kernels:
        return ("its device kernels not measured (the profiler saw no "
                "device event; the card tests count them)")
    want = 1 if M <= SCAN_MAX_ROWS else 3
    assert len(kernels) == want, f"{label}: one push ran {kernels}"
    return (f"one push ran {len(kernels)} device kernel(s) ("
            + ", ".join(f"{k.split('::')[-1].split('<')[0]} {us:.2f} us"
                        for k, us in kernels) + " profiled)")


def _parent_scatter_rows_q(table, scales, idx, values):
    """The parent checkout's `scatter_rows_q` (PARENT_LIB) on the same
    operands: its launcher always takes the claim passes' N-entry winner
    scratch. In place; returns (table, scales, err); no launch is
    counted."""
    m, (n, d) = idx.shape[0], table.shape
    winner = torch.empty((n,), dtype=torch.int32, device=table.device)
    err = torch.empty((m,), dtype=torch.float32, device=table.device)
    _build.check(PARENT_LIB.repro_scatter_rows_q(
        table.data_ptr(), scales.data_ptr(), err.data_ptr(), idx.data_ptr(),
        values.data_ptr(), winner.data_ptr(), m, n, d,
        _build.stream_ptr(table.device)), "the parent's scatter_rows_q")
    return table, scales, err


def _q_push_row(label, idx, values, table, scales):
    """`scatter_rows_q` of one push (`idx`, `values` [M, D]) into an int8
    store, as a kernel row: codes and scales bitwise its plain version's
    over the whole table (the sentinel row too), errors to rounding;
    timed beside the plain version and a composition of PyTorch calls,
    its device kernels counted from one profiled push, and with
    --parent-csrc beside the parent's kernel on the same push (codes and
    scales bitwise, errors within 1e-5). Returns the row."""
    N = table.shape[0] - 1
    M, D = values.shape
    a = scatter_rows_q(table.clone(), scales.clone(), idx, values)
    b = ref.scatter_rows_q_ref(table.clone(), scales.clone(), idx, values)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), \
        f"{label}: scatter_rows_q differs from its plain version"
    torch.testing.assert_close(a[2], b[2], rtol=1e-5, atol=1e-7)
    n_tgt = int(torch.unique(idx).numel())
    tq, ts = table.clone(), scales.clone()
    valid = idx < N                          # all but the sentinel row
    uniq = idx[valid].long()

    def composition():
        q, sc = ref.quantize_rows(values)
        tq.index_copy_(0, uniq, q[valid])
        ts.index_copy_(0, uniq, sc[valid])
        return ref.relative_row_error(values, ref.dequantize_rows(q, sc))

    row = _row(
        "scatter_rows_q", "src/repro_torch/kernels/csrc/scatter.cu",
        "src/repro/kernels/scatter.py:85", float((a[2] - b[2]).abs().max()),
        _time_ms(lambda: scatter_rows_q(tq, ts, idx, values)),
        _time_ms(lambda: ref.scatter_rows_q_ref(tq, ts, idx, values)),
        _time_ms(composition),
        M * 4 + M * D * 4 + n_tgt * (D + 4) + M * 4, 0,
        library="composition: quantize_rows, two index_copy_, the row "
                "errors (plain)")
    # the codes and scales alone: the table the push writes
    row["codes_scales_err"] = 0.0
    row["case"] = f"{label}, M={M}, D={D}"
    out, out_s = table.clone(), scales.clone()
    ran = _push_kernels(label, M, lambda: scatter_rows_q(out, out_s, idx,
                                                         values))
    _phase("kernels", f"{label} scatter_rows_q (M = {M}, D = {D}): err "
           f"{row['max_abs_err']:.3g} (codes, scales 0), {row['ms']:.4f} ms "
           f"(plain {row['plain_ms']:.4f}, comp. {row['library_ms']:.4f}, "
           f"bound {row['bound_ms']:.5f} by {row['bound_by']}); {ran}")
    if PARENT_LIB is None:
        _beside_parent(f"{label} scatter_rows_q", row["ms"], None, None,
                       None)
        return row
    old = _parent_scatter_rows_q(table.clone(), scales.clone(), idx, values)
    for x, y, what in zip(old[:2], a[:2], ("codes", "scales")):
        assert torch.equal(x, y), f"{label}: {what} differ from the parent's"
    torch.testing.assert_close(old[2], a[2], rtol=1e-5, atol=1e-7)
    ot, os_ = table.clone(), scales.clone()
    old_ms = _time_ms(lambda: _parent_scatter_rows_q(ot, os_, idx, values))
    _phase("kernels", f"{label} scatter_rows_q: {row['ms']:.4f} ms, the "
           f"parent's kernel {old_ms:.4f} ms ({old_ms / row['ms']:.2f}x) "
           f"on the same inputs; codes and scales bitwise equal, err max "
           f"diff {float((old[2] - a[2]).abs().max()):.3g}")
    row["parent_ms"] = old_ms
    return row


def _q_non_finite_beside_parent(idx, values, table, scales):
    """With --parent-csrc: a push whose rows hold inf, -inf and NaN,
    through this build's `scatter_rows_q` and the parent's: codes and
    scales bitwise equal, the errors NaN on the same rows and within 1e-5
    elsewhere."""
    v = values.clone()
    v[3, 5], v[4, -1], v[5, 9], v[6] = float("inf"), float("-inf"), \
        float("nan"), float("nan")
    v[7, 0], v[7, 1] = float("nan"), float("inf")
    a = scatter_rows_q(table.clone(), scales.clone(), idx, v)
    b = _parent_scatter_rows_q(table.clone(), scales.clone(), idx, v)
    for x, y, what in zip(b[:2], a[:2], ("codes", "scales")):
        assert torch.equal(x, y), \
            f"scatter_rows_q on non-finite rows: {what} differ from the " \
            f"parent's"
    torch.testing.assert_close(a[2], b[2], rtol=1e-5, atol=1e-7,
                               equal_nan=True)
    _phase("kernels", "scatter_rows_q on rows holding inf, -inf and NaN: "
           "codes and scales bitwise the parent kernel's, errors NaN on "
           f"the same {int(torch.isnan(a[2]).sum())} rows")


def _parent_scatter_rows_vq(table, scales, idx, values, codebook):
    """The parent checkout's `scatter_rows_vq` (PARENT_LIB) on the same
    operands, through this build's wrapper (its launcher has this build's
    signature since the one-launch push). In place; returns (table,
    scales, codes, err); no launch is counted."""
    return _parent_call(lambda: scatter_rows_vq(table, scales, idx, values,
                                                codebook))


def _vq_push_row(label, replaces, idx, values, codebook, table, scales,
                 clock_hz):
    """`scatter_rows_vq` of one push (`idx`, `values` [M, S*8]) into a vq
    store, as a kernel row: checked against its plain version (table,
    scales and codes bitwise, errors to rounding), timed beside the plain
    version and a composition of PyTorch calls, its device kernels counted
    from one profiled push, its bound (operations: 24 per row, subvector
    and entry at 67 TFLOP/s) printed beside the floor of the same work
    issued one unfused instruction each (128 lanes per SM and clock), and
    with --parent-csrc beside the parent's kernel on the same push
    (bitwise). Returns the row."""
    N = table.shape[0] - 1
    M, D = values.shape
    S = D // 8
    a = scatter_rows_vq(table.clone(), scales.clone(), idx, values, codebook)
    b = ref.scatter_rows_vq_ref(table.clone(), scales.clone(), idx, values,
                                codebook)
    assert torch.equal(a[0][:N], b[0][:N]) and \
        torch.equal(a[1][:N], b[1][:N]) and torch.equal(a[2], b[2]), \
        f"{label}: scatter_rows_vq differs from its plain version"
    torch.testing.assert_close(a[3], b[3], rtol=1e-5, atol=1e-7)
    n_tgt = int(torch.unique(idx).numel())
    tq, ts = table.clone(), scales.clone()
    valid = idx < N
    uniq = idx[valid].long()
    sub = torch.arange(S, device=codebook.device)

    def composition():
        amax = values.abs().amax(1)
        sc = torch.where(amax > 0, amax, torch.ones_like(amax))
        u = (values / sc[:, None]).view(M, S, 8).transpose(0, 1)
        q = torch.cdist(u, codebook).argmin(-1).t()
        tq.index_copy_(0, uniq, q[valid].to(torch.uint8))
        ts.index_copy_(0, uniq, sc[valid])
        back = codebook[sub, q].reshape(M, D) * sc[:, None]
        return ref.relative_row_error(values, back)

    # bytes: the index, the values, each target's codes and scale, every
    # pushed row's codes and error, the whole codebook once (each row is
    # held against every entry); operations: per pushed row, subvector and
    # entry 8 subtracts, 8 multiplies, 7 adds and a comparison (24), and
    # the row's max and division
    ops_n = 24.0 * M * S * 256
    row = _row(
        "scatter_rows_vq", "src/repro_torch/kernels/csrc/scatter.cu",
        replaces, float((a[3] - b[3]).abs().max()),
        _time_ms(lambda: scatter_rows_vq(tq, ts, idx, values, codebook)),
        _time_ms(lambda: ref.scatter_rows_vq_ref(tq, ts, idx, values,
                                                 codebook)),
        _time_ms(composition),
        M * 4 + M * D * 4 + n_tgt * (S + 4) + M * (S + 4)
        + codebook.numel() * 4, ops_n + 2.0 * M * D,
        library="composition: row max, divide, cdist (matmul form), "
                "argmin, two index_copy_, the row errors (plain)")
    row["codes_scales_err"] = 0.0
    row["case"] = f"{label}, M={M}, S={S}"
    # the same operations issued one instruction each, none fused
    floor_ms = ops_n / (128 * N_SMS * clock_hz) * 1e3
    out, out_s = tq.clone(), ts.clone()
    ran = _push_kernels(label, M, lambda: scatter_rows_vq(out, out_s, idx,
                                                          values, codebook))
    _phase("kernels", f"{label} (M = {M}, S = {S}): err {row['max_abs_err']:.3g}"
           f" (codes, scales 0), {row['ms']:.4f} ms (plain "
           f"{row['plain_ms']:.4f}, comp. {row['library_ms']:.4f}); bound "
           f"{row['bound_ms']:.5f} ms by {row['bound_by']} ({ops_n / 1e6:.0f}"
           f" M operations at 67 TFLOP/s), unfused-instruction floor "
           f"{floor_ms:.5f} ms (one instruction each, 128 lanes x {N_SMS} "
           f"SMs x {clock_hz / 1e9:.2f} GHz); {ran}")
    if PARENT_LIB is None:
        _beside_parent(f"{label} scatter_rows_vq", row["ms"], None, None,
                       None)
        return row
    old = _parent_scatter_rows_vq(table.clone(), scales.clone(), idx,
                                  values, codebook)
    for x, y, what in zip(old[:3], a[:3], ("table", "scales", "codes")):
        assert torch.equal(x, y), f"{label}: {what} differ from the parent's"
    torch.testing.assert_close(old[3], a[3], rtol=1e-5, atol=1e-7)
    ot, os_ = table.clone(), scales.clone()
    old_ms = _time_ms(lambda: _parent_scatter_rows_vq(ot, os_, idx, values,
                                                      codebook))
    _phase("kernels", f"{label} scatter_rows_vq: {row['ms']:.4f} ms, the "
           f"parent's kernel {old_ms:.4f} ms ({old_ms / row['ms']:.2f}x) "
           f"on the same inputs; table, scales and codes bitwise equal, err "
           f"max diff {float((old[3] - a[3]).abs().max()):.3g}")
    row["parent_ms"] = old_ms
    return row


def _vq_non_finite_beside_parent(idx, values, codebook, table, scales):
    """With --parent-csrc: a push whose rows hold inf, -inf and NaN,
    through this build's `scatter_rows_vq` and the parent's, table,
    scales and codes bitwise equal, the errors NaN on the same rows."""
    v = values.clone()
    v[3, 5], v[4, -1], v[5, 9], v[6] = float("inf"), float("-inf"), \
        float("nan"), float("nan")
    v[7, 0], v[7, 1] = float("nan"), float("inf")
    a = scatter_rows_vq(table.clone(), scales.clone(), idx, v, codebook)
    b = _parent_scatter_rows_vq(table.clone(), scales.clone(), idx, v,
                                codebook)
    for x, y, what in zip(b[:3], a[:3], ("table", "scales", "codes")):
        assert torch.equal(x, y), \
            f"scatter_rows_vq on non-finite rows: {what} differ from the " \
            f"parent's"
    assert torch.equal(torch.isnan(a[3]), torch.isnan(b[3]))
    _phase("kernels", "scatter_rows_vq on rows holding inf, -inf and NaN: "
           "table, scales and codes bitwise the parent kernel's, errors NaN "
           f"on the same {int(torch.isnan(a[3]).sum())} rows")


def _parent_flash_decode(q, k, v, pos):
    """The parent checkout's `flash_decode` (PARENT_LIB) on its own plan,
    the one its wrapper made for both types: group tiles of the least
    power of two >= min(G, 8) members, chunks of 256 slots. No launch is
    counted."""
    b_, kh, g, dh = q.shape
    n_valid = ref.flash_decode_valid(pos, k.shape[1])
    gt = 1 << (min(g, 8) - 1).bit_length()
    chunk = min(256, n_valid)
    n_splits = -(-n_valid // chunk)
    part = torch.empty((b_ * kh * -(-g // gt), n_splits, gt, dh + 2),
                       dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    sym = {torch.float32: "repro_flash_decode_f32",
           torch.bfloat16: "repro_flash_decode_bf16"}[q.dtype]
    _build.check(getattr(PARENT_LIB, sym)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), part.data_ptr(),
        out.data_ptr(), b_, k.shape[1], kh, g, dh, gt, n_valid, n_splits,
        chunk, dh ** -0.5, _build.stream_ptr(q.device)),
        "the parent's flash_decode")
    return out


def _beside_parent(label, ms, out, old_out, old_fn, limit=None):
    """A redesigned kernel's line: its time beside the parent checkout's
    kernel (`old_fn`, timed here on the same inputs, in the same call),
    and their outputs held together: bitwise, or within `limit` where the
    two designs sum in another order. Without --parent-csrc the parent
    is not measured."""
    if PARENT_LIB is None:
        _phase("kernels", f"{label}: {ms:.4f} ms (the parent's kernel: "
               f"not measured, no --parent-csrc)")
        return
    old_ms = _time_ms(old_fn)
    diff = float((old_out.float() - out.float()).abs().max())
    if limit is None:
        assert torch.equal(old_out, out), f"{label}: differs from the parent"
        held = "bitwise equal"
    else:
        assert diff <= limit, f"{label}: {diff:.3g} from the parent's"
        held = f"max diff {diff:.3g} (limit {limit:.3g})"
    _phase("kernels", f"{label}: {ms:.4f} ms, the parent's kernel "
           f"{old_ms:.4f} ms ({old_ms / ms:.2f}x) on the same inputs; "
           f"outputs {held}")


def _vq_ablation(device):
    """--vq-ablation: `scatter_rows_vq` at each push of VQ_PUSHES (seeded
    rows, unique targets, the store's codebook) with every lane split of
    this build forced in place of its plan's, and at the plan's split with
    each VQ_ABLATION library in place of this build's; every output
    bitwise the plain version's. Each time is the median over VQ_ROUNDS
    rounds (each a `_time_ms`, the configurations interleaved), printed
    with the rounds' range. No launch is counted."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    plan_fn, saved_lib = scatter_mod.scatter_rows_vq_plan, _build._lib
    counts = dict(_build.launch_counts)

    def run(cfg, args):
        lanes, lib = cfg
        _build._lib = saved_lib if lib is None else lib
        scatter_mod.scatter_rows_vq_plan = (
            lambda m, s_n, n_sm: (lanes,) + plan_fn(m, s_n, n_sm)[1:])
        try:
            return scatter_rows_vq(*args)
        finally:
            _build._lib = saved_lib
            scatter_mod.scatter_rows_vq_plan = plan_fn

    for label, M, D in VQ_PUSHES:
        S_n = D // 8
        vals = torch.randn((M, D), generator=gen, device=device)
        cb = vq_init_codebook(D, device=device)
        idx = torch.randperm(M, generator=gen, device=device).to(torch.int32)
        table = torch.zeros((M + 1, S_n), dtype=torch.uint8, device=device)
        scales = torch.zeros((M + 1,), dtype=torch.float32, device=device)
        want = ref.scatter_rows_vq_ref(table.clone(), scales.clone(), idx,
                                       vals, cb)
        planned = plan_fn(M, S_n, N_SMS)[0]
        cfgs = {f"lanes {L}": (L, None) for L in scatter_mod.VQ_LANES}
        cfgs.update({name: (planned, lib)
                     for name, (_, lib) in VQ_ABLATION_LIBS.items()})
        for name, cfg in cfgs.items():
            got = run(cfg, (table.clone(), scales.clone(), idx, vals, cb))
            for a, b, what in zip(got[:3], want[:3],
                                  ("table", "scales", "codes")):
                assert torch.equal(a, b), \
                    f"--vq-ablation {label}, {name}: {what} differ from " \
                    f"the plain version's"
            torch.testing.assert_close(got[3], want[3], rtol=1e-5,
                                       atol=1e-7)
        times = {name: [] for name in cfgs}
        tq, ts = table.clone(), scales.clone()
        for _ in range(VQ_ROUNDS):
            for name, cfg in cfgs.items():
                times[name].append(_time_ms(
                    lambda: run(cfg, (tq, ts, idx, vals, cb))))

        def fmt(name):
            t = times[name]
            return (f"{name} {statistics.median(t):.4f} [{min(t):.4f}-"
                    f"{max(t):.4f}]")

        _phase("vq-ablation", f"{label} (M = {M}, S = {S_n}; the plan: "
               f"{planned} lane(s)), ms, median [range] of {VQ_ROUNDS} "
               f"rounds: " + ", ".join(fmt(n) for n in cfgs)
               + "; every output bitwise the plain version's")
    _build.launch_counts.update(counts)


def _device_kernels(fn):
    """The device kernels one call of `fn` ran, from torch.profiler: a
    list of (name, device microseconds), empty where it saw no device
    activity. A marker kernel (`torch.cuda._sleep`'s `spin_kernel`) runs
    first in the window and is left out: late in a long run the profiler
    drops the first device event of a window."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.name]


def _scatter_lines(label, table, idx, vals, ms):
    """A push's device kernels from one profiled call (one: the
    last-writer scan and the copy in a single launch) with their device
    time beside that of the `index_copy_` yardstick on the same rows, and
    the push's time beside the parent's kernel on the same push, the
    tables bitwise."""
    out = table.clone()
    kernels = _device_kernels(lambda: scatter_rows(out, idx, vals))
    if kernels:
        assert len(kernels) == 1, f"{label}: one push ran {kernels}"
        valid = idx < table.shape[0] - 1   # all but the sentinel row
        lib_tab, lib_idx, lib_vals = (table.clone(), idx[valid].long(),
                                      vals[valid])
        lib = _device_kernels(lambda: lib_tab.index_copy_(0, lib_idx,
                                                          lib_vals))
        _phase("kernels", f"{label}: one push ran 1 device kernel "
               f"({kernels[0][0].split('::')[-1].split('<')[0]}, "
               f"{kernels[0][1]:.2f} us "
               f"profiled; index_copy_ on the same rows "
               f"{sum(us for _, us in lib):.2f} us in {len(lib)})")
    else:
        _phase("kernels", f"{label}: device kernels of one push not "
               f"measured (the profiler saw no device activity)")
    if PARENT_LIB is None:
        _beside_parent(label, ms, out, None, None)
        return
    tgt = table.clone()
    _beside_parent(label, ms, out,
                   _parent_scatter_rows(table.clone(), idx, vals),
                   lambda: _parent_scatter_rows(tgt, idx, vals))


def kernel_phase(g, spec, device):
    """Phase 2. Returns the kernel rows (launches filled in later)."""
    N = g.num_nodes
    kplan = S.build_serve_plan(g, spec, S.ServeConfig(staleness_slo=0),
                               device=device)
    rng = np.random.default_rng(SEED)
    q0 = rng.choice(N, size=QUERY_SIZE, replace=False)
    refresh, _ = S.stale_closure(kplan, np.ones(N + 1, np.int32), q0, 0)
    bucket = S._bucket_for(kplan.refresh_buckets, len(refresh))
    batch = S.build_request_batch(kplan, refresh, bucket)
    vals, cols = batch.forward.vals, batch.forward.cols
    R, K = cols.shape
    _phase("kernels", f"refresh batch of {len(refresh)} nodes, bucket "
           f"{bucket}, max_h {batch.max_h}, blocks [{R}, {K}, 128, 128]")
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []

    # gather_rows: the feature pull of the refresh batch
    idx = torch.clamp(batch.batch_nodes, 0, N - 1).to(torch.int32)
    table = kplan.x
    out = gather_rows(table, idx)
    want = ref.gather_rows_ref(table, idx)
    assert torch.equal(out, want), "gather_rows differs from its plain version"
    M, D = idx.shape[0], table.shape[1]
    # bytes this run's data needs: each distinct source row read once
    # (the padding indices all clamp to row N-1), every output row written
    n_src = int(torch.unique(idx).numel())
    rows.append(_pull_row(
        f"serving refresh batch's feature pull (M = {M}, d = {D}, f32)",
        "gather_rows", "src/repro/kernels/gather.py:37",
        lambda: gather_rows(table, idx),
        lambda: ref.gather_rows_ref(table, idx),
        lambda: torch.index_select(table, 0, idx), "index_select",
        lambda: _parent_call(lambda: gather_rows(table, idx)),
        M * 4 + n_src * D * 4 + M * D * 4,
        row_plan(M, D * 4, table.data_ptr()).ctas))
    for cold in (False, True):
        _beside_library_spread(
            f"gather_rows (f32, M = {M}, d = {D}{', L2 flushed' * cold})",
            lambda: gather_rows(table, idx), "index_select",
            lambda: torch.index_select(table, 0, idx), cold)

    # scatter_rows: the push into a [N+1, 256] table — first a check with
    # duplicate valid indices and masked rows, then timings on the real
    # push of the refresh batch (padding rows land on the sentinel row)
    hist = torch.randn((N + 1, D_HIDDEN), generator=gen, device=device)
    vals_p = torch.randn((M, D_HIDDEN), generator=gen, device=device)
    dup = torch.clamp(batch.batch_nodes, 0, N - 1).to(torch.int32).clone()
    dup[1::7] = dup[0:-1:7]                  # duplicates of earlier rows
    dup[5::11] = N                           # masked rows -> sentinel
    a = scatter_rows(hist.clone(), dup, vals_p)
    b = ref.scatter_rows_ref(hist.clone(), dup, vals_p)
    assert torch.equal(a[:N], b[:N]), "scatter_rows differs (duplicates)"
    push_idx = torch.where(batch.batch_mask, batch.batch_nodes,
                           torch.full_like(batch.batch_nodes, N)
                           ).to(torch.int32)
    a = scatter_rows(hist.clone(), push_idx, vals_p)
    b = ref.scatter_rows_ref(hist.clone(), push_idx, vals_p)
    assert torch.equal(a[:N], b[:N]), "scatter_rows differs (push)"
    valid = batch.batch_mask
    uniq_idx, uniq_vals = push_idx[valid].long(), vals_p[valid]
    tgt = hist.clone()
    # bytes this run's data needs: the index, and one row read and one
    # written per distinct target (the padding rows all land on the
    # sentinel row, one target); the kernel's scan of the later indices
    # is its own cost, not the function's
    n_tgt = int(torch.unique(push_idx).numel())
    rows.append(_row(
        "scatter_rows", "src/repro_torch/kernels/csrc/scatter.cu",
        "src/repro/kernels/scatter.py:39", 0.0,
        _time_ms(lambda: scatter_rows(tgt, push_idx, vals_p)),
        _time_ms(lambda: ref.scatter_rows_ref(tgt, push_idx, vals_p)),
        _time_ms(lambda: tgt.index_copy_(0, uniq_idx, uniq_vals)),
        M * 4 + 2 * n_tgt * D_HIDDEN * 4, 0))
    _scatter_lines("scatter_rows", hist, push_idx, vals_p, rows[-1]["ms"])
    # a push past SCAN_MAX_ROWS takes the claim passes (three kernels):
    # the refresh push twice over, the second copy of each row winning
    big_idx = torch.cat([push_idx, push_idx])
    big_vals = torch.cat([vals_p, -vals_p])
    neg_uniq = -uniq_vals
    assert big_idx.shape[0] > SCAN_MAX_ROWS
    assert torch.equal(scatter_rows(hist.clone(), big_idx, big_vals),
                       ref.scatter_rows_ref(hist.clone(), big_idx, big_vals)
                       ), "scatter_rows differs (claim passes)"
    _phase("kernels", f"scatter_rows past SCAN_MAX_ROWS (M = "
           f"{big_idx.shape[0]}, the claim passes): "
           f"{_time_ms(lambda: scatter_rows(tgt, big_idx, big_vals)):.4f} "
           f"ms (index_copy_ of its winning rows "
           f"{_time_ms(lambda: tgt.index_copy_(0, uniq_idx, neg_uniq)):.4f}"
           f" ms); table bitwise the plain version's")

    # bcsr_spmm: the layer-0 aggregation over [x_b ; x_halo ; 0]
    xb = ops.pull_rows(kplan.x, batch.batch_nodes) * batch.batch_mask[:, None]
    xh = ops.pull_rows(kplan.x, batch.halo_nodes) * batch.halo_mask[:, None]
    x_all = torch.cat([xb, xh, torch.zeros_like(xb[:1])], 0)
    out = bcsr_spmm(x_all, vals, cols)
    want = ref.bcsr_spmm_ref(x_all, vals, cols)
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    err = float((out - want).abs().max())
    # the library yardstick: cuSPARSE CSR x dense over the blocks' nonzeros
    a_csr, n_cols = _csr_of_blocks(vals, cols, x_all.shape[0])
    x_pad = torch.cat([x_all, x_all.new_zeros(n_cols - x_all.shape[0],
                                              x_all.shape[1])], 0)
    torch.testing.assert_close(torch.sparse.mm(a_csr, x_pad), want,
                               rtol=RTOL, atol=ATOL)
    nnz = a_csr._nnz()
    _phase("kernels", f"blocks hold {nnz} nonzeros in {vals.numel()} "
           f"stored values")
    # every bound counts the blocks as the reference stores them (all
    # R*K*128*128 values, padding blocks included), the source rows the
    # blocks' columns reach, each once, and the output written once; and
    # the operations this run's blocks need: one FMA (2 flops) per nonzero
    # entry and output column. The kernels multiply every stored value,
    # zeros included: that is their own cost, not the function's
    blk_bytes = vals.numel() * 4 + cols.numel() * 4
    n_x = sum(min(128, x_all.shape[0] - c * 128)
              for c in torch.unique(cols).tolist())
    rows.append(_row(
        "bcsr_spmm", "src/repro_torch/kernels/csrc/bcsr_spmm.cu",
        "src/repro/kernels/bcsr_spmm.py:42", err,
        _time_ms(lambda: bcsr_spmm(x_all, vals, cols)),
        _time_ms(lambda: ref.bcsr_spmm_ref(x_all, vals, cols)),
        _time_ms(lambda: torch.sparse.mm(a_csr, x_pad)),
        blk_bytes + n_x * x_all.shape[1] * 4 + R * 128 * x_all.shape[1] * 4,
        2.0 * nnz * x_all.shape[1]))
    _beside_earlier("bcsr_spmm", lambda: bcsr_spmm(x_all, vals, cols), out,
                    rows[-1]["ms"])
    # the same blocks with no entry zero: what the sparse stream costs
    # where it skips nothing (one L1 read per FMA on the CUDA cores). An
    # output sums 9,728 terms: on a grid (block values k/8, x integers)
    # every order of summation is exact, so the check holds the terms
    dense = torch.randint(1, 9, vals.shape, generator=gen, device=device,
                          dtype=torch.float32) / 8
    x_grid = torch.round(x_all)
    out = bcsr_spmm(x_grid, dense, cols)
    torch.testing.assert_close(out, ref.bcsr_spmm_ref(x_grid, dense, cols),
                               rtol=RTOL, atol=ATOL)
    _beside_earlier(f"bcsr_spmm on dense blocks (refresh batch shape, "
                    f"D={x_all.shape[1]})",
                    lambda: bcsr_spmm(x_grid, dense, cols), out,
                    _time_ms(lambda: bcsr_spmm(x_grid, dense, cols)))
    del dense, x_grid

    # gather_spmm: the layer-1 aggregation, halo rows out of the table
    x_in = torch.randn((bucket, D_HIDDEN), generator=gen, device=device)
    sel, xrow, trow = gather_plan(
        cols, batch.halo_nodes, batch.halo_mask, bucket, N + 1)
    out = gather_spmm(x_in, hist, vals, cols, sel, xrow, trow)
    want = ref.gather_spmm_ref(x_in, hist, vals, cols, sel, xrow, trow)
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    err = float((out - want).abs().max())
    n_xrows = int(torch.unique(xrow[sel == 0]).numel())
    n_trows = int(torch.unique(trow[sel == 1]).numel())
    rows.append(_row(
        "gather_spmm", "src/repro_torch/kernels/csrc/fused.cu",
        "src/repro/kernels/fused.py:203 (f32 body _make_kernel :172)", err,
        _time_ms(lambda: gather_spmm(
            x_in, hist, vals, cols, sel, xrow, trow)),
        _time_ms(lambda: ref.gather_spmm_ref(
            x_in, hist, vals, cols, sel, xrow, trow)),
        None,
        blk_bytes + 3 * sel.numel() * 4 + (n_xrows + n_trows) * D_HIDDEN * 4
        + R * 128 * D_HIDDEN * 4,
        2.0 * nnz * D_HIDDEN))
    _beside_earlier("gather_spmm", lambda: gather_spmm(
        x_in, hist, vals, cols, sel, xrow, trow), out, rows[-1]["ms"])
    rows += _quantized_kernel_rows(
        hist, x_in, vals, cols, (sel, xrow, trow), vals_p, dup, push_idx,
        uniq_idx, uniq_vals, blk_bytes, nnz)
    rows += _vq_kernel_rows(hist, x_in, vals, cols, (sel, xrow, trow),
                            vals_p, dup, push_idx, blk_bytes, nnz)
    rows += _raw_scatter_rows(kplan, q0, hist, gen)
    for r in rows:
        _phase("kernels", f"{r['name']}: err {r['max_abs_err']:.3g}, "
               f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
               f"{r['library_ms']}, bound {r['bound_ms']:.4f} by "
               f"{r['bound_by']})")
    del batch, x_all, xb, xh
    return rows, kplan


def _quantized_kernel_rows(hist, x_in, vals, cols, plan, vals_p, dup,
                           push_idx, uniq_idx, uniq_vals, blk_bytes, nnz):
    """Phase 2 over an int8 and a bf16 store of the refresh batch's table
    (the rows of the int8 serving path, and the bf16 lines): the int8
    body of gather_spmm, the quantizing push, and the bf16 instantiations
    of gather_spmm and scatter_rows, each against its plain version."""
    sel, xrow, trow = plan
    R, K = cols.shape
    D, N = hist.shape[1], hist.shape[0] - 1
    rows = []
    n_xrows = int(torch.unique(xrow[sel == 0]).numel())
    n_trows = int(torch.unique(trow[sel == 1]).numel())
    flops = 2.0 * nnz * D
    fixed = blk_bytes + 3 * sel.numel() * 4 + n_xrows * D * 4 + \
        R * 128 * D * 4
    q8, s8 = ref.quantize_rows(hist)
    b16 = hist.to(torch.bfloat16)
    for name, table, scales, body, row_bytes in (
            ("gather_spmm_dq", q8, s8, "int8 body _make_kernel_dq :181",
             D + 4),
            ("gather_spmm_bf16", b16, None, "f32 body :172 over a bf16 table",
             2 * D)):
        out = gather_spmm(x_in, table, vals, cols, sel, xrow, trow, scales)
        want = ref.gather_spmm_ref(x_in, table, vals, cols, sel, xrow, trow,
                                   scales)
        torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
        assert torch.equal(out, gather_spmm(x_in, table, vals, cols, sel,
                                            xrow, trow, scales)), \
            f"{name}: a warm repeat differs"
        rows.append(_row(
            name, "src/repro_torch/kernels/csrc/fused.cu",
            f"src/repro/kernels/fused.py:203 ({body})",
            float((out - want).abs().max()),
            _time_ms(lambda: gather_spmm(x_in, table, vals, cols, sel, xrow,
                                         trow, scales)),
            _time_ms(lambda: ref.gather_spmm_ref(x_in, table, vals, cols,
                                                 sel, xrow, trow, scales)),
            None, fixed + n_trows * row_bytes, flops))
        _beside_earlier(name, lambda: gather_spmm(
            x_in, table, vals, cols, sel, xrow, trow, scales), out,
            rows[-1]["ms"])

    # gather_rows_dq: the refresh batch's rows pulled from the int8 store
    # (masked rows read the sentinel row), d = 256: the int8 pull where
    # it moves real bytes
    M = push_idx.shape[0]
    n_src = int(torch.unique(push_idx).numel())
    row = _pull_row(
        f"serving refresh batch's int8 pull (M = {M}, d = {D})",
        "gather_rows_dq", "src/repro/kernels/gather.py:107",
        lambda: gather_rows_dq(q8, s8, push_idx),
        lambda: ref.gather_rows_dq_ref(q8, s8, push_idx),
        lambda: torch.index_select(q8, 0, push_idx).to(torch.float32).mul_(
            torch.index_select(s8, 0, push_idx)[:, None]),
        "composition: index_select of codes and scales, convert, multiply",
        lambda: _parent_call(lambda: gather_rows_dq(q8, s8, push_idx)),
        M * 4 + n_src * (D + 4) + M * D * 4,
        dq_plan(M, D, q8.data_ptr(), 0).ctas,
        case=f"serving refresh batch, M={M}, d={D}; launches: GAT's int8 "
             f"serving pulls, d=64")
    # its launches: the served int8 pulls (GAT's, d = 64)
    row["run"] = "gat int8 serving"
    rows.append(row)

    # scatter_rows_q: the push of the refresh batch into the int8 store,
    # codes and scales bitwise (duplicates and masked rows first), each
    # pushed row's relative error to rounding (sums in another order)
    a = scatter_rows_q(q8.clone(), s8.clone(), dup, vals_p)
    b = ref.scatter_rows_q_ref(q8.clone(), s8.clone(), dup, vals_p)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), \
        "scatter_rows_q differs (duplicates)"
    torch.testing.assert_close(a[2], b[2], rtol=1e-5, atol=1e-7)
    rows.append(_q_push_row("serving refresh push", push_idx, vals_p, q8,
                            s8))
    if PARENT_LIB is not None:
        _q_non_finite_beside_parent(push_idx[:64], vals_p[:64], q8, s8)

    # scatter_rows on a bf16 table: the values are rounded to bf16 first,
    # as the push does, so the kernel moves 2-byte rows
    M = push_idx.shape[0]
    n_tgt = int(torch.unique(push_idx).numel())
    vb = vals_p.to(torch.bfloat16)
    for idx in (dup, push_idx):
        a = scatter_rows(b16.clone(), idx, vb)
        b = ref.scatter_rows_ref(b16.clone(), idx, vb)
        assert torch.equal(a[:N], b[:N]), "scatter_rows (bf16) differs"
    tb, ub = b16.clone(), uniq_vals.to(torch.bfloat16)
    rows.append(_row(
        "scatter_rows_bf16", "src/repro_torch/kernels/csrc/scatter.cu",
        "src/repro/kernels/scatter.py:39 (bf16 table)", 0.0,
        _time_ms(lambda: scatter_rows(tb, push_idx, vb)),
        _time_ms(lambda: ref.scatter_rows_ref(tb, push_idx, vb)),
        _time_ms(lambda: tb.index_copy_(0, uniq_idx, ub)),
        M * 4 + 2 * n_tgt * D * 2, 0))
    _scatter_lines("scatter_rows_bf16", b16, push_idx, vb, rows[-1]["ms"])
    return rows


def _vq_kernel_rows(hist, x_in, vals, cols, plan, vals_p, dup, push_idx,
                    blk_bytes, nnz):
    """Phase 2 over a vq store of the refresh batch's table (d = 256,
    S = 32 subvectors, codebook [32, 256, 8], 256 KB: the rows of the vq
    serving path): the vq body of gather_spmm and the encoding push, each
    against its plain version on the same inputs; the plain encode on the
    card is first held to the CPU's, bitwise."""
    sel, xrow, trow = plan
    R, K = cols.shape
    D, N = hist.shape[1], hist.shape[0] - 1
    S = D // 8
    cb = vq_init_codebook(D, device=hist.device)
    codes, scales = ref.vq_encode_rows(hist, cb)
    cq, cs = ref.vq_encode_rows(hist[:1024].cpu(), cb.cpu())
    assert torch.equal(codes[:1024].cpu(), cq) and \
        torch.equal(scales[:1024].cpu(), cs), \
        "the plain vq encode differs between the card and the CPU"
    rows = []
    n_xrows = int(torch.unique(xrow[sel == 0]).numel())
    halo = torch.unique(trow[sel == 1])
    n_trows = int(halo.numel())
    # the codebook entries the halo code rows name: the only ones the
    # decode reads (32 B each)
    offs = torch.arange(S, device=cb.device) * 256
    n_entries = int(torch.unique(codes[halo.long()].long() + offs).numel())
    out = gather_spmm(x_in, codes, vals, cols, sel, xrow, trow, scales, cb)
    want = ref.gather_spmm_ref(x_in, codes, vals, cols, sel, xrow, trow,
                               scales, cb)
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(out, gather_spmm(x_in, codes, vals, cols, sel, xrow,
                                        trow, scales, cb)), \
        "gather_spmm_vq: a warm repeat differs"
    # bytes: as the int8 body, with S code bytes and a scale per halo row
    # and each codebook entry those rows name once; operations: the
    # contraction's, and one multiply per decoded element
    rows.append(_row(
        "gather_spmm_vq", "src/repro_torch/kernels/csrc/fused.cu",
        "src/repro/kernels/fused.py:203 (vq body _make_kernel_vq :191)",
        float((out - want).abs().max()),
        _time_ms(lambda: gather_spmm(x_in, codes, vals, cols, sel, xrow,
                                     trow, scales, cb)),
        _time_ms(lambda: ref.gather_spmm_ref(x_in, codes, vals, cols, sel,
                                             xrow, trow, scales, cb)),
        None,
        blk_bytes + 3 * sel.numel() * 4 + n_xrows * D * 4 + R * 128 * D * 4
        + n_trows * (S + 4) + n_entries * 32, 2.0 * nnz * D + n_trows * D))
    _beside_earlier("gather_spmm_vq", lambda: gather_spmm(
        x_in, codes, vals, cols, sel, xrow, trow, scales, cb), out,
        rows[-1]["ms"])

    # gather_rows_vq: the refresh batch's rows decoded from the vq store
    # (masked rows read the sentinel row), S = 32: the vq pull where it
    # moves bytes. No run of the main path pulls a vq table at this shape
    # (vq serving decodes inside gather_spmm_vq), so its launches are the
    # GCN vq refit's, which decodes every table row (2,501 rows, S = 8)
    M = push_idx.shape[0]
    n_src = int(torch.unique(push_idx).numel())
    n_pulled = int(torch.unique(codes[push_idx.long()].long() + offs)
                   .numel())
    cb_rows = cb.view(-1, 8)
    row = _pull_row(
        f"serving refresh batch's vq pull (M = {M}, S = {S})",
        "gather_rows_vq", "src/repro/kernels/gather.py:189",
        lambda: gather_rows_vq(codes, cb, scales, push_idx),
        lambda: ref.gather_rows_vq_ref(codes, cb, scales, push_idx),
        lambda: cb_rows.index_select(0, (torch.index_select(
            codes, 0, push_idx).long() + offs).view(-1)).view(M, D).mul_(
            torch.index_select(scales, 0, push_idx)[:, None]),
        "composition: index_select of codes and scales, index_select of "
        "codebook entries, multiply",
        lambda: _parent_call(lambda: gather_rows_vq(codes, cb, scales,
                                                    push_idx)),
        M * 4 + n_src * (S + 4) + n_pulled * 32 + M * D * 4,
        vq_plan(M, S).ctas, flops=M * D,
        case=f"serving refresh batch, M={M}, S={S}; launches: the GCN vq "
             f"refit's pulls, 2,501 rows of S=8")
    row["run"] = "gcn vq refit"
    rows.append(row)

    # scatter_rows_vq: the push of the refresh batch into the vq store
    # (duplicates and masked rows first, then the push itself)
    a = scatter_rows_vq(codes.clone(), scales.clone(), dup, vals_p, cb)
    b = ref.scatter_rows_vq_ref(codes.clone(), scales.clone(), dup, vals_p,
                                cb)
    assert torch.equal(a[0][:N], b[0][:N]) and \
        torch.equal(a[1][:N], b[1][:N]) and torch.equal(a[2], b[2]), \
        "scatter_rows_vq differs from its plain version"
    torch.testing.assert_close(a[3], b[3], rtol=1e-5, atol=1e-7)
    rows.append(_vq_push_row(
        "serving refresh push", "src/repro/kernels/scatter.py:141",
        push_idx, vals_p, cb, codes, scales, _clock_hz()))
    if PARENT_LIB is not None:
        _vq_non_finite_beside_parent(push_idx[:64], vals_p[:64].clone(), cb,
                                     codes, scales)
    return rows


def _history_pull_rows(plan, device, gen, clock_hz):
    """Phase 2: the GAT hidden layer's history pull (batch 0's halo rows,
    d = 64) from an int8 table (`gather_rows_dq`), a bf16 one
    (`gather_rows_bf16`) and a vq one (`gather_rows_vq`, S = 8, codebook
    [8, 256, 8]), each a `_pull_row`; and the same
    layer's push into the vq table (`scatter_rows_vq`: batch 0's rows,
    masked ones on the sentinel row), its second kernel row, and the same
    push into the int8 table (`scatter_rows_q`), its second row."""
    batch = plan.batch(0)
    n1 = plan.graph.num_nodes + 1
    idx = torch.clamp(batch.halo_nodes, 0, n1 - 1).to(torch.int32)
    hist = torch.randn((n1, TRAIN_HIDDEN), generator=gen, device=device)
    q8, s8 = ref.quantize_rows(hist)
    b16 = hist.to(torch.bfloat16)
    M, D = idx.shape[0], TRAIN_HIDDEN
    n_src = int(torch.unique(idx).numel())
    cb = vq_init_codebook(D, device=device)
    vq, vs = ref.vq_encode_rows(hist, cb)
    S = D // 8
    out = gather_rows_vq(vq, cb, vs, idx)
    assert torch.equal(out, ref.gather_rows_vq_ref(vq, cb, vs, idx)), \
        "gather_rows_vq differs from its plain version"
    assert torch.equal(out, gather_rows_vq(vq, cb, vs, idx))
    offs = torch.arange(S, device=device) * 256
    cb_rows = cb.view(-1, 8)
    # the codebook entries the pulled rows name: the only ones the kernel
    # reads (32 B each)
    n_entries = int(torch.unique(vq[idx.long()].long() + offs).numel())
    rows = [
        _pull_row(
            f"GAT hidden layer's int8 pull (M = {M}, d = {D})",
            "gather_rows_dq", "src/repro/kernels/gather.py:107",
            lambda: gather_rows_dq(q8, s8, idx),
            lambda: ref.gather_rows_dq_ref(q8, s8, idx),
            lambda: torch.index_select(q8, 0, idx).to(torch.float32).mul_(
                torch.index_select(s8, 0, idx)[:, None]),
            "composition: index_select of codes and scales, convert, "
            "multiply",
            lambda: _parent_call(lambda: gather_rows_dq(q8, s8, idx)),
            M * 4 + n_src * (D + 4) + M * D * 4,
            dq_plan(M, D, q8.data_ptr(), 0).ctas),
        _pull_row(
            f"GAT hidden layer's bf16 pull (M = {M}, d = {D})",
            "gather_rows_bf16", "src/repro/kernels/gather.py:37 (bf16 table)",
            lambda: gather_rows(b16, idx),
            lambda: ref.gather_rows_ref(b16, idx),
            lambda: torch.index_select(b16, 0, idx), "index_select",
            lambda: _parent_call(lambda: gather_rows(b16, idx)),
            M * 4 + n_src * D * 2 + M * D * 2,
            row_plan(M, D * 2, b16.data_ptr()).ctas),
        _pull_row(
            f"GAT hidden layer's vq pull (M = {M}, S = {S})",
            "gather_rows_vq", "src/repro/kernels/gather.py:189",
            lambda: gather_rows_vq(vq, cb, vs, idx),
            lambda: ref.gather_rows_vq_ref(vq, cb, vs, idx),
            lambda: cb_rows.index_select(0, (torch.index_select(
                vq, 0, idx).long() + offs).view(-1)).view(M, D).mul_(
                torch.index_select(vs, 0, idx)[:, None]),
            "composition: index_select of codes and scales, index_select "
            "of codebook entries, multiply",
            lambda: _parent_call(lambda: gather_rows_vq(vq, cb, vs, idx)),
            M * 4 + n_src * (S + 4) + n_entries * 32 + M * D * 4,
            vq_plan(M, S).ctas, flops=M * D)]
    push_idx = ops._push_index(batch.batch_nodes, batch.batch_mask, n1,
                               scratch_last_row=True)
    push = torch.randn((push_idx.shape[0], D), generator=gen, device=device)
    row = _vq_push_row("GAT hidden-layer training push",
                       "src/repro/kernels/scatter.py:141", push_idx, push,
                       cb, vq, vs, clock_hz)
    row["run"] = "gat vq"        # its launches: the GAT vq training run
    row_q = _q_push_row("GAT hidden-layer training push", push_idx, push,
                        q8, s8)
    row_q["run"] = "gat int8"    # its launches: the GAT int8 training run
    return rows + [row, row_q]


def _train_graph(name):
    """The graph and spec of training configuration `name`."""
    cfg = TRAIN_CONFIGS[name]
    make = sbm_cluster_graph if cfg.get("kind") == "sbm" else citation_graph
    g = make(**cfg["graph"])
    spec_kw = {"d_hidden": TRAIN_HIDDEN, "num_layers": 2,
               **cfg.get("spec", {})}
    spec = model.GNNSpec(op=cfg.get("op", name), d_in=g.x.shape[1],
                         num_classes=g.num_classes, heads=8, **spec_kw)
    return g, spec


def _train_config(name):
    """Configuration `name`'s GASConfig: TRAIN_PARTS parts and
    TRAIN_EPOCHS epochs at lr 0.01 unless it says otherwise."""
    kw = {"num_parts": TRAIN_PARTS, "epochs": TRAIN_EPOCHS, "lr": 0.01,
          **TRAIN_CONFIGS[name].get("config", {})}
    return RT.GASConfig(**kw)


# the configurations whose partitions the worker processes compute (one
# that names `partition_of` shares another's graph, part count and seed)
PARTITIONED = tuple(n for n, c in TRAIN_CONFIGS.items()
                    if "partition_of" not in c)


def _partition(name):
    """The partition of configuration `name`'s training graph and the
    seconds it took: host work, run in a process of its own while the
    card runs the first phases."""
    t0 = time.perf_counter()
    g, _ = _train_graph(name)
    return RT.partition(g, _train_config(name)), time.perf_counter() - t0


def train_plans(device, parts):
    """The training plans (stacked batches on the card) over the
    partitions `parts` ({name: `_partition(name)`})."""
    plans = {}
    for op in TRAIN_CONFIGS:
        t0 = time.perf_counter()
        part, part_s = parts[TRAIN_CONFIGS[op].get("partition_of", op)]
        g, spec = _train_graph(op)
        plans[op] = RT.build_plan(g, spec, _train_config(op), device=device,
                                  part=part)
        b = plans[op].batches
        unit = spec.op in model.UNIT_BLOCK_OPS
        fam = b.unit if unit else b.forward
        fam_t = b.unit_transposed if unit else b.transposed
        # the partition's digest keys the reference accuracy
        _phase("setup", f"{op}: {g.num_nodes} nodes, {g.num_edges} edges, "
               f"{g.x.shape[1]} features; {b.num_batches} batches, max_b "
               f"{b.max_b}, max_h {b.max_h}, blocks "
               f"{list(fam.vals.shape)} and transposed "
               f"{list(fam_t.vals.shape)} in "
               f"{time.perf_counter() - t0:.1f} s (the partition in "
               f"{part_s:.1f} s in a worker process); partition "
               f"{_digest(plans[op].part)}, "
               f"{_degree_orders(g, plans[op].config.num_parts)}")
    return plans


def _edge_softmax_case(plan, H, Fd, device, gen, clock_hz):
    """The three edge-softmax kernels on batch 0's unit blocks with seeded
    operands of H heads of Fd features: checks against the plain
    versions, times, bounds, the time of a composition of PyTorch calls
    over the blocks' nonzeros, and with --parent-csrc the parent's three
    kernels on the same inputs (M bitwise, the rest within RTOL / ATOL).
    Returns {name: kernel row}."""
    batch = plan.batch(0)
    uv, uc, uvt, uct = batch.ublocks
    n_out, M = batch.max_b, batch.max_b + batch.max_h + 1
    randn = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa
    ad, as_, wx, g = randn(n_out, H), randn(M, H), randn(M, H, Fd), \
        randn(n_out, H, Fd)
    tol = dict(rtol=RTOL, atol=ATOL)
    fwd = lambda: esk.edge_softmax_fwd(ad, as_, wx, uv, uc)  # noqa: E731
    out, mm, ll = fwd()
    p_out, p_mm, p_ll = ref.edge_softmax_fwd_ref(ad, as_, wx, uv, uc)
    assert torch.equal(mm, p_mm), "edge_softmax_fwd: M differs"
    torch.testing.assert_close(out, p_out, **tol)
    torch.testing.assert_close(ll, p_ll, **tol)
    delta = (g * p_out).sum(-1)
    bwd = (ad, as_, wx, g, p_mm, p_ll, delta)
    row = lambda: esk.edge_softmax_bwd_row(*bwd, uv, uc)  # noqa: E731
    dad = row()
    p_dad = ref.edge_softmax_bwd_row_ref(*bwd, uv, uc)
    torch.testing.assert_close(dad, p_dad, **tol)
    col = lambda: esk.edge_softmax_bwd_col(*bwd, uvt, uct)  # noqa: E731
    dwx, das = col()
    p_dwx, p_das = ref.edge_softmax_bwd_col_ref(*bwd, uvt, uct)
    torch.testing.assert_close(dwx, p_dwx, **tol)
    torch.testing.assert_close(das, p_das, **tol)
    for a, b in zip(fwd() + (row(),) + col(), (out, mm, ll, dad, dwx, das)):
        assert torch.equal(a, b), "edge softmax: a warm repeat differs"

    # the yardsticks: the same functions over the blocks' nonzeros as a
    # weighted COO (index_select, leaky_relu, scatter_reduce amax, exp,
    # index_add); no single PyTorch call computes them
    dst, src, mu = _block_coo(uv, uc)
    mu = mu[:, None]

    def scores():
        z = ad.index_select(0, dst) + as_.index_select(0, src)
        return z, torch.nn.functional.leaky_relu(z, 0.2)

    def comp_fwd():
        _, s = scores()
        m = ad.new_full((n_out, H), ref.NEG).scatter_reduce_(
            0, dst[:, None].expand(-1, H), s, "amax")
        p = mu * torch.exp(s - m.index_select(0, dst))
        l_ = ad.new_zeros((n_out, H)).index_add_(0, dst, p)
        acc = wx.new_zeros((n_out, H, Fd)).index_add_(
            0, dst, p[..., None] * wx.index_select(0, src))
        return acc / l_.clamp(min=ref.TINY)[..., None], m, l_

    def alphas():
        z, s = scores()
        p = mu * torch.exp(s - p_mm.index_select(0, dst))
        alpha = p / p_ll.clamp(min=ref.TINY).index_select(0, dst)
        gv = (g.index_select(0, dst) * wx.index_select(0, src)).sum(-1)
        ap = alpha * torch.where(z > 0, 1.0, 0.2)
        return alpha, ap * (gv - delta.index_select(0, dst))

    def comp_row():
        return ad.new_zeros((n_out, H)).index_add_(0, dst, alphas()[1])

    def comp_col():
        alpha, t = alphas()
        return (wx.new_zeros((M, H, Fd)).index_add_(
                    0, src, alpha[..., None] * g.index_select(0, dst)),
                as_.new_zeros((M, H)).index_add_(0, src, t))

    for a, b in zip(comp_fwd() + (comp_row(),) + comp_col(),
                    (p_out, p_mm, p_ll, p_dad, p_dwx, p_das)):
        torch.testing.assert_close(a, b, **tol)
    err = lambda a, b: float((a - b).abs().max())  # noqa: E731
    node = 4 * H                                   # one [*, H] row, f32
    blk, blk_t = uv.numel() * 4 + uc.numel() * 4, uvt.numel() * 4 + \
        uct.numel() * 4
    # the operations this run's blocks need: one exponential per nonzero
    # entry and head, and per nonzero, head and feature one FMA (2 flops)
    # for the forward's alpha * wx and the row pass's g . wx, two for the
    # column pass's alpha * g and g . wx
    ent, ent_t = int((uv > 0).sum()) * H, int((uvt > 0).sum()) * H
    lib = ("composition: index_select over the blocks' nonzeros, "
           "leaky_relu, {}exp, index_add (no single PyTorch call computes "
           "it)")
    cases = {
        "edge_softmax_fwd": (
            max(err(out, p_out), err(ll, p_ll)), fwd,
            lambda: ref.edge_softmax_fwd_ref(ad, as_, wx, uv, uc), comp_fwd,
            lib.format("scatter_reduce amax, "),
            blk + n_out * node + M * node * (1 + Fd) + n_out * node *
            (Fd + 2), 2.0 * ent * Fd, ent),
        "edge_softmax_bwd_row": (
            err(dad, p_dad), row,
            lambda: ref.edge_softmax_bwd_row_ref(*bwd, uv, uc), comp_row,
            lib.format(""),
            blk + n_out * node * (Fd + 5) + M * node * (1 + Fd),
            2.0 * ent * Fd, ent),
        "edge_softmax_bwd_col": (
            max(err(dwx, p_dwx), err(das, p_das)), col,
            lambda: ref.edge_softmax_bwd_col_ref(*bwd, uvt, uct), comp_col,
            lib.format(""),
            blk_t + n_out * node * (Fd + 4) + M * node * (2 + 2 * Fd),
            4.0 * ent_t * Fd, ent_t),
    }
    src_file = "src/repro_torch/kernels/csrc/edge_softmax.cu"
    line = {"edge_softmax_fwd": 92, "edge_softmax_bwd_row": 189,
            "edge_softmax_bwd_col": 276}
    rows = {name: _row(name, src_file,
                       f"src/repro/kernels/edge_softmax.py:{line[name]}", e,
                       _time_ms(fn), _time_ms(plain), _time_ms(comp),
                       n_bytes, flops, exps, clock_hz, library=label)
            for name, (e, fn, plain, comp, label, n_bytes, flops, exps)
            in cases.items()}
    if PARENT_LIB is not None:
        # the parent's three kernels on the same inputs in the same call
        o_out, o_mm, o_ll = _parent_call(fwd)
        assert torch.equal(o_mm, mm), \
            "edge_softmax_fwd: M differs from the parent's"
        o_dad = _parent_call(row)
        o_dwx, o_das = _parent_call(col)
        for name, pairs, fn in (
                ("edge_softmax_fwd", ((o_out, out), (o_ll, ll)), fwd),
                ("edge_softmax_bwd_row", ((o_dad, dad),), row),
                ("edge_softmax_bwd_col", ((o_dwx, dwx), (o_das, das)), col)):
            for a, b in pairs:
                torch.testing.assert_close(a, b, **tol)
            rows[name]["parent_ms"] = _time_ms(lambda: _parent_call(fn))
            rows[name]["parent_diff"] = max(err(a, b) for a, b in pairs)
    return rows


def _block_coo(vals, cols):
    """The blocks' nonzero entries as a weighted COO: (row ids, column
    ids, multiplicities), for the yardstick compositions."""
    nz = vals.nonzero(as_tuple=True)
    return (nz[0] * 128 + nz[2], cols[nz[0], nz[1]].long() * 128 + nz[3],
            vals[nz])


def _pna_kernel_rows(plan, device, gen):
    """PNA's three kernels on batch 0's unit blocks with seeded operands
    at the layers' width (d_hidden): the stats and tie counts bitwise
    against the plain versions, the sums and gradients at 1e-5, a warm
    repeat bit-identical; times, bounds, and the time of a PyTorch
    composition over the blocks' nonzeros. Returns the kernel rows."""
    batch = plan.batch(0)
    uv, uc, uvt, uct = batch.ublocks
    n_out, M = batch.max_b, batch.max_b + batch.max_h + 1
    Fd = plan.spec.d_hidden
    randn = lambda *s: torch.randn(s, generator=gen, device=device)  # noqa
    xd, xs = randn(n_out, Fd), randn(M, Fd)
    gs, gmn, gmx = randn(n_out, Fd), randn(n_out, Fd), randn(n_out, Fd)
    tol = dict(rtol=1e-5, atol=1e-5)
    out = pnk.pna_reduce_fwd(xd, xs, uv, uc)
    want = ref.pna_reduce_fwd_ref(xd, xs, uv, uc)
    for name, a, b in zip(("s", "mn", "mx", "cnt", "cmin", "cmax"), out,
                          want):
        if name == "s":
            torch.testing.assert_close(a, b, **tol)
        else:
            assert torch.equal(a, b), f"pna_reduce_fwd: {name} differs"
    s, mn, mx, cnt, cmin, cmax = want
    stats = (gs, gmn, gmx, mn, mx, cmin, cmax)
    dxd = pnk.pna_reduce_bwd_row(xd, xs, *stats, uv, uc)
    p_dxd = ref.pna_reduce_bwd_row_ref(xd, xs, *stats, uv, uc)
    torch.testing.assert_close(dxd, p_dxd, **tol)
    dxs = pnk.pna_reduce_bwd_col(xd, xs, *stats, uvt, uct)
    p_dxs = ref.pna_reduce_bwd_col_ref(xd, xs, *stats, uvt, uct)
    torch.testing.assert_close(dxs, p_dxs, **tol)
    for a, b in zip(pnk.pna_reduce_fwd(xd, xs, uv, uc), out):
        assert torch.equal(a, b), "pna_reduce_fwd: a warm repeat differs"
    assert torch.equal(pnk.pna_reduce_bwd_col(xd, xs, *stats, uvt, uct),
                       dxs), "pna_reduce_bwd_col: a warm repeat differs"
    err = lambda a, b: float((a - b).abs().max())  # noqa: E731
    stat_err = max(err(a, b) for a, b in zip(out[1:], want[1:]))
    assert stat_err == 0.0

    # the yardsticks: the same functions over the blocks' nonzeros as a
    # weighted COO (index_select, relu, scatter_reduce / index_add); the
    # forward's leaves out the tie counts, the backward's reuse them
    dst, src, mu = _block_coo(uv, uc)
    idx = dst[:, None].expand(-1, Fd)

    def comp_fwd():
        msg = torch.relu(xd.index_select(0, dst) + xs.index_select(0, src))
        s_ = xd.new_zeros((n_out, Fd)).index_add_(0, dst, mu[:, None] * msg)
        mn_ = xd.new_full((n_out, Fd), ref.BIG).scatter_reduce_(
            0, idx, msg, "amin")
        mx_ = xd.new_full((n_out, Fd), -ref.BIG).scatter_reduce_(
            0, idx, msg, "amax")
        return s_, mn_, mx_, xd.new_zeros(n_out).index_add_(0, dst, mu)

    gmn_c, gmx_c = gmn / cmin.clamp(min=1.0), gmx / cmax.clamp(min=1.0)

    def comp_dmsg():
        z = xd.index_select(0, dst) + xs.index_select(0, src)
        m = torch.relu(z)
        g = gs.index_select(0, dst) + torch.where(
            m == mn.index_select(0, dst), gmn_c.index_select(0, dst), 0.0) + \
            torch.where(m == mx.index_select(0, dst),
                        gmx_c.index_select(0, dst), 0.0)
        return torch.where(z > 0, mu[:, None] * g, 0.0)

    torch.testing.assert_close(comp_fwd()[0], s, **tol)
    torch.testing.assert_close(
        xd.new_zeros((n_out, Fd)).index_add_(0, dst, comp_dmsg()), p_dxd,
        **tol)
    nnz = int(mu.numel())
    # bytes: the blocks as stored, each other operand once (the source
    # rows the blocks' columns reach), each output once; operations over
    # the nonzero entries, per entry and feature: the add, the ReLU, the
    # multiply and the sum's add, and the two comparisons (forward); the
    # add, the ReLU test, the two tie tests, the multiply and the sum's
    # add (each backward)
    node = Fd * 4
    blk = uv.numel() * 4 + uc.numel() * 4
    blk_t = uvt.numel() * 4 + uct.numel() * 4
    n_x = sum(min(128, M - c * 128) for c in torch.unique(uc).tolist())
    n_d = sum(min(128, n_out - c * 128) for c in torch.unique(uct).tolist())
    ops6 = 6.0 * nnz * Fd
    cases = {
        "pna_reduce_fwd": (
            max(err(out[0], s), stat_err),
            lambda: pnk.pna_reduce_fwd(xd, xs, uv, uc),
            lambda: ref.pna_reduce_fwd_ref(xd, xs, uv, uc), comp_fwd,
            blk + n_out * node + n_x * node + 5 * n_out * node + n_out * 4),
        "pna_reduce_bwd_row": (
            err(dxd, p_dxd),
            lambda: pnk.pna_reduce_bwd_row(xd, xs, *stats, uv, uc),
            lambda: ref.pna_reduce_bwd_row_ref(xd, xs, *stats, uv, uc),
            lambda: xd.new_zeros((n_out, Fd)).index_add_(0, dst,
                                                         comp_dmsg()),
            blk + 8 * n_out * node + n_x * node + n_out * node),
        "pna_reduce_bwd_col": (
            err(dxs, p_dxs),
            lambda: pnk.pna_reduce_bwd_col(xd, xs, *stats, uvt, uct),
            lambda: ref.pna_reduce_bwd_col_ref(xd, xs, *stats, uvt, uct),
            lambda: xs.new_zeros((M, Fd)).index_add_(0, src, comp_dmsg()),
            blk_t + M * node + 8 * n_d * node + M * node),
    }
    line = {"pna_reduce_fwd": 98, "pna_reduce_bwd_row": 194,
            "pna_reduce_bwd_col": 254}
    rows = []
    for name, (e, fn, plain, comp, n_bytes) in cases.items():
        row = _row(name, "src/repro_torch/kernels/csrc/pna_reduce.cu",
                   f"src/repro/kernels/pna_reduce.py:{line[name]}", e,
                   _time_ms(fn), _time_ms(plain), _time_ms(comp), n_bytes,
                   ops6, library="composition: index_select over the "
                   "blocks' nonzeros, relu, " + (
                       "scatter_reduce amin/amax, index_add (no tie counts)"
                       if name == "pna_reduce_fwd" else
                       "the even split, index_add"))
        row["stats_err"] = stat_err
        rows.append(row)
    _phase("kernels", f"PNA batch 0 (F={Fd}): unit blocks {list(uv.shape)} "
           f"and transposed {list(uvt.shape)} hold {nnz} nonzeros; " +
           "; ".join(f"{r['name']}: err {r['max_abs_err']:.3g} (stats "
                     f"{r['stats_err']:.3g}), {r['ms']:.4f} ms (plain "
                     f"{r['plain_ms']:.4f}, comp. {r['library_ms']:.4f}, "
                     f"bound {r['bound_ms']:.5f} by {r['bound_by']})"
                     for r in rows))
    floor = _launch_floor(device, (1, -(-n_out // 8), -(-M // 8)))
    _phase("kernels", "launch floor: an empty kernel from this build's "
           "library, timed as the rows are: " + ", ".join(
               f"{n} CTA(s) of 256 threads {ms:.4f} ms"
               for n, ms in floor.items()) + f" ({-(-n_out // 8)} and "
           f"{-(-M // 8)} CTAs: the PNA backward row and column passes' "
           "grids)")
    _pna_pass_lines(plan, [("seeded operands", xd, xs, stats)] + [
        (f"layer {ell}'s operands", *ops_) for ell, ops_ in
        enumerate(_pna_layer_operands(plan))])
    return rows


def _pna_layer_operands(plan):
    """[(xd, xs, stats)] of `pna_reduce_bwd_row` (and of `_bwd_col`, which
    takes the same with the transposed blocks) at layers 0 and 1 of one
    training step on batch 0, from fresh params and a zero f32 store: the
    operands the main path gives them, taken from `ops`' autograd
    Function as it calls the row kernel. xd and xs are the forward's
    operands too (the Function saves them for the backward). No launch is
    counted."""
    calls, real = [], ops.pna_reduce_bwd_row

    def spy(xd, xs, *rest):
        calls.append((xd, xs, tuple(rest[:7])))
        return real(xd, xs, *rest)

    plan = with_history_dtype(plan, "f32")
    counts = dict(_build.launch_counts)
    ops.pna_reduce_bwd_row = spy
    try:
        with torch.enable_grad():
            RT.grads_and_metrics(plan, RT.init_state(plan), plan.batch(0))
    finally:
        ops.pna_reduce_bwd_row = real
        _build.launch_counts.update(counts)
    assert len(calls) == plan.spec.num_layers, len(calls)
    return calls[::-1]                  # the backward runs the last first


def _pna_bits(out):
    """A PNA kernel's output (a tensor, or the forward's six) as one int32
    tensor of its bits, for bitwise comparisons."""
    outs = out if isinstance(out, tuple) else (out,)
    return torch.cat([t.reshape(-1) for t in outs]).view(torch.int32)


def _pna_pass_lines(plan, cases):
    """PNA's three kernels on batch 0's blocks for each (label, xd, xs,
    stats) of `cases`: the forward's min, max, count and tie counts
    bitwise its plain version's and its sums within 1e-5, the backward
    passes within 1e-5 of theirs; with --parent-csrc beside the parent
    checkout's kernels on the same inputs, every output bitwise equal;
    with --pna-edges on each such build, every output bitwise this
    build's. No launch is counted."""
    uv, uc, uvt, uct = plan.batch(0).ublocks
    tol = dict(rtol=1e-5, atol=1e-5)
    counts = dict(_build.launch_counts)
    for label, xd, xs, stats in cases:
        got = pnk.pna_reduce_fwd(xd, xs, uv, uc)
        want = ref.pna_reduce_fwd_ref(xd, xs, uv, uc)
        torch.testing.assert_close(got[0], want[0], **tol)
        assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])), \
            f"pna_reduce_fwd, {label}: a stat differs from the plain version"
        edges = []
        for name, fn, plain in (
                ("pna_reduce_fwd",
                 lambda: pnk.pna_reduce_fwd(xd, xs, uv, uc), None),
                ("pna_reduce_bwd_row",
                 lambda: pnk.pna_reduce_bwd_row(xd, xs, *stats, uv, uc),
                 lambda: ref.pna_reduce_bwd_row_ref(xd, xs, *stats, uv,
                                                    uc)),
                ("pna_reduce_bwd_col",
                 lambda: pnk.pna_reduce_bwd_col(xd, xs, *stats, uvt, uct),
                 lambda: ref.pna_reduce_bwd_col_ref(xd, xs, *stats, uvt,
                                                    uct))):
            out = fn()
            if plain is not None:
                torch.testing.assert_close(out, plain(), **tol)
            out = _pna_bits(out)
            ms = _time_ms(fn)
            old = None if PARENT_LIB is None else _pna_bits(_parent_call(fn))
            _beside_parent(f"PNA batch 0 {name}, {label}", ms, out, old,
                           lambda: _parent_call(fn))
            if PNA_EDGE_LIBS:
                for n, lib in PNA_EDGE_LIBS.items():
                    assert torch.equal(_pna_bits(_call_on(lib, fn)), out), \
                        f"{name}, {label}: {n} edges a batch differ"
                edges.append(f"{name}: " + ", ".join(
                    f"{n} {_time_ms(lambda: _call_on(lib, fn)):.4f} ms"
                    for n, lib in PNA_EDGE_LIBS.items()) +
                    f", this build {ms:.4f} ms")
        if edges:
            _phase("pna-edges", f"PNA batch 0, {label}, queued edges "
                   f"loaded together: " + "; ".join(edges) +
                   "; every output bitwise this build's")
    _build.launch_counts.update(counts)


def training_kernel_phase(plans, device, clock_hz):
    """Phase 2, the training slices' kernels. Returns the three
    edge-softmax rows (the hidden layer's shapes), the GAT history pulls
    and the three PNA rows (launches filled in later)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    uv = plans["gat"].batch(0).ublocks[0]
    _phase("kernels", f"GAT batch 0: unit blocks {list(uv.shape)} hold "
           f"{int((uv > 0).sum())} nonzeros in {uv.numel()} stored values")
    hidden = _edge_softmax_case(plans["gat"], 8, 8, device, gen, clock_hz)
    output = _edge_softmax_case(plans["gat"], 1, 7, device, gen, clock_hz)
    rows = []
    for name, row in hidden.items():
        o = output[name]

        def layer(r):
            return (f"err {r['max_abs_err']:.3g}, {r['ms']:.4f} ms (plain "
                    f"{r['plain_ms']:.4f}, comp. {r['library_ms']:.4f}, "
                    f"bound {r['bound_ms']:.5f} by {r['bound_by']})")

        _phase("kernels", f"{name} (H=8, F=8): {layer(row)}; output layer "
               f"(H=1, F=7): {layer(o)}")
        if "parent_ms" in row:
            held = {"edge_softmax_fwd": "M bitwise equal, out and L max diff",
                    "edge_softmax_bwd_row": "dad max diff",
                    "edge_softmax_bwd_col": "dwx and das max diff"}[name]
            _phase("kernels", "; ".join(
                f"{name} ({shape}): {r['ms']:.4f} ms, the parent's kernel "
                f"{r['parent_ms']:.4f} ms ({r['parent_ms'] / r['ms']:.2f}x)"
                f" on the same inputs; {held} {r['parent_diff']:.3g}"
                for shape, r in (("H=8, F=8", row), ("H=1, F=7", o))))
        else:
            _phase("kernels", f"{name}: the parent's kernel not measured "
                   f"(no --parent-csrc)")
        # the row times the hidden layer's call; its error covers both
        row["max_abs_err"] = row["max_err"] = max(row["max_abs_err"],
                                                  o["max_abs_err"])
        rows.append(row)
    rows += _history_pull_rows(plans["gat"], device, gen, clock_hz)
    rows += _raw_gather_rows(plans["gat"], device, gen)
    rows += _pna_kernel_rows(plans["pna"], device, gen)
    rows += _zoo_kernel_rows(plans, device, gen)

    # bcsr_spmm on a quickstart batch's blocks (128 wide): the forward
    # family against the layer-0 input, and the GCN backward's use of it,
    # the transposed family against the aggregation's cotangent
    batch = plans["gcn"].batch(0)
    d = plans["gcn"].x.shape[1]
    fwd = batch.forward
    x_f = torch.randn(((int(fwd.cols.max()) + 1) * 128, d), generator=gen,
                      device=device)
    gout = torch.randn((fwd.cols.shape[0] * 128, d), generator=gen,
                       device=device)
    for what, x, v, c in (("forward", x_f, fwd.vals, fwd.cols),
                          ("transposed", gout, batch.transposed.vals,
                           batch.transposed.cols)):
        out = bcsr_spmm(x, v, c)
        want = ref.bcsr_spmm_ref(x, v, c)
        torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
        n_x = sum(min(128, x.shape[0] - i * 128)
                  for i in torch.unique(c).tolist())
        bound_ms, bound_by = _bound(
            v.numel() * 4 + c.numel() * 4 + n_x * d * 4
            + c.shape[0] * 128 * d * 4, 2.0 * int((v != 0).sum()) * d)
        label = f"bcsr_spmm on {what} training blocks (D={d})"
        ms = _time_ms(lambda: bcsr_spmm(x, v, c))
        _phase("kernels", f"{label}: GCN quickstart batch 0, "
               f"{list(v.shape)}, {int((v != 0).sum())} nonzeros; err "
               f"{float((out - want).abs().max()):.3g}, {ms:.4f} ms (plain "
               f"{_time_ms(lambda: ref.bcsr_spmm_ref(x, v, c)):.4f}, bound "
               f"{bound_ms:.4f} by {bound_by})")
        _beside_earlier(label, lambda: bcsr_spmm(x, v, c), out, ms)
    return rows


def _csr_of_blocks(vals, cols, n_x):
    """The blocks' nonzeros as a CSR matrix over n_x padded to whole
    blocks (cuSPARSE's operand: the library yardstick of a contraction),
    and its nonzero count."""
    nz = vals.nonzero(as_tuple=True)
    ridx = nz[0] * 128 + nz[2]
    cidx = cols[nz[0], nz[1]].long() * 128 + nz[3]
    n_cols = max(-(-n_x // 128), int(cols.max()) + 1) * 128
    a = torch.sparse_coo_tensor(torch.stack([ridx, cidx]), vals[nz],
                                (cols.shape[0] * 128, n_cols))
    return a.coalesce().to_sparse_csr(), n_cols


def _contraction_row(name, case, run, x, vals, cols, plan=None,
                     table=None):
    """One row of a block contraction at a training path's operands:
    `bcsr_spmm(x, vals, cols)`, or with `plan` and `table` the f32
    `gather_spmm` (x the in-batch rows); checked against the plain
    version, timed beside it and, for `bcsr_spmm`, beside cuSPARSE's CSR
    product. Bytes: the blocks as stored, each source row the blocks
    reach once (the gather plan's three index arrays too), the output
    once; operations: one FMA per nonzero entry and column."""
    D = x.shape[1]
    blk_bytes = vals.numel() * 4 + cols.numel() * 4
    nnz = int((vals != 0).sum())
    if plan is None:
        fn = lambda: bcsr_spmm(x, vals, cols)  # noqa: E731
        plain = lambda: ref.bcsr_spmm_ref(x, vals, cols)  # noqa: E731
        a_csr, n_cols = _csr_of_blocks(vals, cols, x.shape[0])
        x_pad = torch.cat([x, x.new_zeros(n_cols - x.shape[0], D)], 0)
        library = lambda: torch.sparse.mm(a_csr, x_pad)  # noqa: E731
        n_src = sum(min(128, x.shape[0] - c * 128)
                    for c in torch.unique(cols).tolist()
                    if c * 128 < x.shape[0])
        extra = 0
    else:
        sel, xrow, trow = plan
        fn = lambda: gather_spmm(x, table, vals, cols, *plan)  # noqa: E731
        plain = lambda: ref.gather_spmm_ref(  # noqa: E731
            x, table, vals, cols, *plan)
        library = None
        n_src = (int(torch.unique(xrow[sel == 0]).numel())
                 + int(torch.unique(trow[sel == 1]).numel()))
        extra = 3 * sel.numel() * 4
    out, want = fn(), plain()
    torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    if library is not None:
        torch.testing.assert_close(library(), want, rtol=RTOL, atol=ATOL)
    row = _row(name, f"src/repro_torch/kernels/csrc/"
               f"{'bcsr_spmm' if plan is None else 'fused'}.cu",
               "src/repro/kernels/bcsr_spmm.py:42" if plan is None else
               "src/repro/kernels/fused.py:203 (f32 body _make_kernel :172)",
               float((out - want).abs().max()), _time_ms(fn),
               _time_ms(plain), None if library is None else
               _time_ms(library),
               blk_bytes + extra + n_src * D * 4
               + cols.shape[0] * 128 * D * 4, 2.0 * nnz * D)
    row.update(case=case, run=run)
    _phase("kernels", f"{name}, {case}: blocks {list(vals.shape)}, {nnz} "
           f"nonzeros; err {row['max_abs_err']:.3g}, {row['ms']:.4f} ms "
           f"(plain {row['plain_ms']:.4f}, library {row['library_ms']}, "
           f"bound {row['bound_ms']:.5f} by {row['bound_by']})")
    return row


def _zoo_kernel_rows(plans, device, gen):
    """Phase 2, the kernels at the operator zoo's new operands: the f32
    `gather_spmm` of APPNP's fused layers at D = 6 (its class-score
    tables) over the forward blocks, and of GIN's at D = 48 over the
    unit-weight blocks; `bcsr_spmm` on GIN's unit blocks at layer 0 (the
    features) and on the transposed unit blocks (its backward); and
    `scatter_rows` of APPNP's 6-wide push. Each row's launches come from
    that configuration's training run."""
    rows = []
    cases = (("appnp", "forward", "APPNP layer >= 1, D = 6"),
             ("gin", "unit", "GIN layer >= 1, unit blocks, D = 48"))
    for name, fam_name, case in cases:
        plan = plans[name]
        batch = plan.batch(0)
        fam = getattr(batch, fam_name)
        n_table = plan.graph.num_nodes + 1
        D = plan.spec.hist_dims()[0]
        x_in = torch.randn((batch.max_b, D), generator=gen, device=device)
        table = torch.randn((n_table, D), generator=gen, device=device)
        gplan = gather_plan(fam.cols, batch.halo_nodes, batch.halo_mask,
                            batch.max_b, n_table)
        rows.append(_contraction_row("gather_spmm", case, f"{name} f32",
                                     x_in, fam.vals, fam.cols, gplan,
                                     table))
    batch = plans["gin"].batch(0)
    xb = ops.pull_rows(plans["gin"].x, batch.batch_nodes)
    xh = ops.pull_rows(plans["gin"].x, batch.halo_nodes)
    x_all = torch.cat([xb * batch.batch_mask[:, None],
                       xh * batch.halo_mask[:, None],
                       torch.zeros_like(xb[:1])], 0)
    rows.append(_contraction_row(
        "bcsr_spmm", f"GIN layer 0, unit blocks, D = {x_all.shape[1]}",
        "gin f32", x_all, batch.unit.vals, batch.unit.cols))
    gout = torch.randn((batch.unit.cols.shape[0] * 128, 48), generator=gen,
                       device=device)
    rows.append(_contraction_row(
        "bcsr_spmm", "GIN backward, transposed unit blocks, D = 48",
        "gin f32", gout, batch.unit_transposed.vals,
        batch.unit_transposed.cols))
    # APPNP's push of batch 0 into a 6-wide table (masked rows on the
    # sentinel row)
    plan = plans["appnp"]
    batch = plan.batch(0)
    N = plan.graph.num_nodes
    hist = torch.randn((N + 1, 6), generator=gen, device=device)
    vals_p = torch.randn((batch.max_b, 6), generator=gen, device=device)
    push_idx = torch.where(batch.batch_mask, batch.batch_nodes,
                           torch.full_like(batch.batch_nodes, N)
                           ).to(torch.int32)
    a = scatter_rows(hist.clone(), push_idx, vals_p)
    assert torch.equal(a, ref.scatter_rows_ref(hist.clone(), push_idx,
                                               vals_p)), "scatter_rows D=6"
    valid = batch.batch_mask
    uniq_idx, uniq_vals = push_idx[valid].long(), vals_p[valid]
    tgt = hist.clone()
    n_tgt = int(torch.unique(push_idx).numel())
    M = push_idx.shape[0]
    row = _row("scatter_rows", "src/repro_torch/kernels/csrc/scatter.cu",
               "src/repro/kernels/scatter.py:39", 0.0,
               _time_ms(lambda: scatter_rows(tgt, push_idx, vals_p)),
               _time_ms(lambda: ref.scatter_rows_ref(tgt, push_idx, vals_p)),
               _time_ms(lambda: tgt.index_copy_(0, uniq_idx, uniq_vals)),
               M * 4 + 2 * n_tgt * 6 * 4, 0)
    row.update(case="APPNP push, M = %d, D = 6" % M, run="appnp f32")
    _phase("kernels", f"scatter_rows, {row['case']}: err 0 (bitwise), "
           f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, index_copy_ "
           f"{row['library_ms']:.4f}, bound {row['bound_ms']:.5f} by "
           f"{row['bound_by']})")
    rows.append(row)
    return rows


def _plan_on_cpu(plan):
    """The same plan with its device arrays on the CPU (no re-partition)."""
    cpu = torch.device("cpu")
    return dataclasses.replace(
        plan, device=cpu, batch_stack=plan.batches.to(cpu), x=plan.x.cpu(),
        y=plan.y.cpu(), train_mask=plan.train_mask.cpu(),
        eval_edges=tuple(e.cpu() for e in plan.eval_edges),
        eval_w=plan.eval_w.cpu())


@torch.no_grad()
def _copy_state(dst, src):
    """Overwrite a training state's params, moments and history store
    (scales, vq codebooks and statistics included) with another's, across
    devices."""
    pairs = list(zip(tree_leaves(dst.params), tree_leaves(src.params)))
    for tree in ("m", "v"):
        pairs += zip(tree_leaves(getattr(dst.opt_state, tree)),
                     tree_leaves(getattr(src.opt_state, tree)))
    pairs += zip(dst.histories.tables, src.histories.tables)
    for name in ("scales", "codebooks", "cb_counts", "cb_sums"):
        pairs += zip(getattr(dst.histories, name) or [],
                     getattr(src.histories, name) or [])
    pairs += [(dst.histories.age, src.histories.age),
              (dst.opt_state.step, src.opt_state.step)]
    for a, b in pairs:
        a.copy_(b)


def _quantized_tables_close(store, cstore, max_steps=1 + 1e-5):
    """A quantized store on the card against the CPU's: every row (the
    sentinel row, which takes masked pushes, left out) within `max_steps`
    quantization steps (int8: s_i, by default plus 1e-5 of it for the
    scale's own rounding; bf16: one bf16 step at the larger magnitude
    plus the f32 tables' ATOL; None: not bounded), and >= 99.9% of the
    codes equal; returns (the largest error in steps, the share of equal
    codes)."""
    n = cstore.age.shape[0] - 1
    idx = torch.arange(n, dtype=torch.int32)
    worst, same = 0.0, []
    for ell, (a, c) in enumerate(zip(store.tables, cstore.tables)):
        got = store.pull(ell, idx.to(store.device)).float().cpu()
        want = cstore.pull(ell, idx).float()
        step = (cstore.scales[ell][:n, None] if cstore.scales is not None
                else torch.maximum(got.abs(), want.abs()) * 2.0 ** -7 + ATOL)
        ratio = float(((got - want).abs() / step.clamp(min=1e-30)).max())
        assert max_steps is None or ratio <= max_steps, \
            f"table {ell}: {ratio} steps apart"
        worst = max(worst, ratio)
        same.append((a[:n].cpu() == c[:n]).float().mean().item())
    assert min(same) >= 0.999, same
    return worst, min(same)


@contextlib.contextmanager
def _recorded_pushes(store, on=True):
    """Record every push into `store` inside the block (layer, index,
    values, mask, on the CPU) for `_vq_codes_close`'s near-tie test
    (nothing when `on` is False); the store's own method is back after
    it, so the store no longer refers to itself and is freed as soon as
    its last user lets go."""
    pushes = []
    if not on:
        yield pushes
        return
    real = store.push_measured

    def push_measured(ell, idx, values, mask, stats=True):
        pushes.append((ell, idx.cpu().numpy(), values.cpu().numpy(),
                       mask.cpu().numpy()))
        return real(ell, idx, values, mask, stats)

    store.push_measured = push_measured
    try:
        yield pushes
    finally:
        del store.push_measured


def _tie_gap(u, cb, a, b):
    """|d(u, cb[a]) - d(u, cb[b])|, each distance summed left to right in
    f32 over the subvector, as the encode sums it."""
    def dist(c):
        acc = np.float32(0.0)
        for j in range(u.shape[0]):
            diff = np.float32(u[j] - c[j])
            acc = np.float32(acc + diff * diff)
        return acc
    return float(abs(dist(cb[a]) - dist(cb[b])))


def _vq_codes_close(store, cstore, pushes):
    """A vq store on the card against the CPU's (the sentinel row, which
    takes masked pushes, left out): >= 99.9% of the codes equal, the scales
    at RTOL, and every code that differs a near-tie (VQ_TIE) for the row
    the card pushed into it last (`pushes`, from `_recorded_pushes`).
    Returns (the share of equal codes, the number of differing codes, the
    largest tie gap)."""
    n = cstore.age.shape[0] - 1
    shares, flips, gap = [], 0, 0.0
    for ell, (a, c) in enumerate(zip(store.tables, cstore.tables)):
        got, want = a[:n].cpu().numpy(), c[:n].numpy()
        torch.testing.assert_close(store.scales[ell][:n].cpu(),
                                   cstore.scales[ell][:n], rtol=RTOL,
                                   atol=0.0)
        shares.append(float(np.mean(got == want)))
        rows, subs = np.nonzero(got != want)
        flips += len(rows)
        if not len(rows):
            continue
        last = {}
        for e, idx, v, m in pushes:
            if e == ell:
                for j in np.flatnonzero(m):
                    last[int(idx[j])] = v[j]
        cb = cstore.codebooks[ell].numpy()
        for r, sub in zip(rows, subs):
            v = last[int(r)]
            u = (v / np.abs(v).max()).astype(np.float32).reshape(-1, 8)[sub]
            gap = max(gap, _tie_gap(u, cb[sub], got[r, sub], want[r, sub]))
    assert min(shares) >= 0.999, shares
    assert gap <= VQ_TIE, f"a vq code flipped {gap} away from a tie"
    return min(shares), flips, gap


@contextlib.contextmanager
def _noise_carried_to_cpu(on=True):
    """The Eq. 3 regularizer's draws on the card (from the state's
    generator) recorded, and the CPU's draws replaced by them in the same
    order, so that both devices perturb by the same noise (nothing when
    `on` is False). Yields the list of draws not yet replayed."""
    if not on:
        yield []
        return
    real = model.reg_noise
    drawn = []

    def reg_noise(gen, shape, device):
        if device.type == "cuda":
            drawn.append(real(gen, shape, device))
            return drawn[-1]
        out = drawn.pop(0)
        assert tuple(out.shape) == tuple(shape), (out.shape, shape)
        return out.to(device)

    model.reg_noise = reg_noise
    try:
        yield drawn
    finally:
        model.reg_noise = real


def _compare_steps(plan, cplan):
    """Two steps on the card against the same steps on the CPU, each from
    the same state (the card's is copied over before the second). The
    update runs on both devices from the card's gradients: fed their own,
    an element whose gradient sits at rounding level, where the two
    devices may round to opposite signs, moves by lr one way and not the
    other in AdamW's first steps. With the Eq. 3 regularizer on, the
    CPU's steps take the card's noise (`_noise_carried_to_cpu`). Returns
    the line's text."""
    with _noise_carried_to_cpu(plan.spec.reg_weight > 0) as drawn:
        line = _compare_steps_from(plan, cplan, drawn)
    if plan.spec.reg_weight > 0:
        line += ("; the regularizer's noise drawn on the card and carried "
                 "to the CPU")
    return line


def _compare_steps_from(plan, cplan, drawn):
    state, cstate = RT.init_state(plan), RT.init_state(cplan)
    hd = state.histories.history_dtype
    quant = hd != "f32"
    errs, opt_errs, norm_errs, tabs = [], {t: 0.0 for t in OPT_TOL}, [], []
    for b in (0, 1):
        if b:
            _copy_state(cstate, state)
        with _recorded_pushes(state.histories, hd == "vq") as pushes:
            grads, m = RT.grads_and_metrics(plan, state, plan.batch(b))
        cgrads, cm = RT.grads_and_metrics(cplan, cstate, cplan.batch(b))
        assert not drawn, f"{len(drawn)} draws of the card not replayed"
        pairs = [(m["loss"], cm["loss"]), (m["reg"], cm["reg"])] + list(
            zip(grads, cgrads))
        if hd == "vq":
            pairs.append((m["hist_quant_err"], cm["hist_quant_err"]))
            tabs.append(_vq_codes_close(state.histories, cstate.histories,
                                        pushes))
            # the statistics: one count per pushed subvector, each entry's
            # count moved by at most one per differing code
            for a, c in zip(state.histories.cb_counts,
                            cstate.histories.cb_counts):
                assert float(a.sum()) == float(c.sum())
                assert float((a.cpu() - c).abs().max()) <= tabs[-1][1]
        elif quant:
            pairs.append((m["hist_quant_err"], cm["hist_quant_err"]))
            tabs.append(_quantized_tables_close(state.histories,
                                                cstate.histories))
        else:
            # the tables' last row is the push's sentinel, unspecified
            pairs += [(a[:-1], c[:-1]) for a, c in zip(
                state.histories.tables, cstate.histories.tables)]
        for a, c in pairs:
            torch.testing.assert_close(a.cpu(), c, rtol=RTOL, atol=ATOL)
            errs.append(float((a.cpu() - c).abs().max()))
        cgrads = [g.cpu() for g in grads]
        gn = clip_by_global_norm(grads, plan.config.grad_clip)[1].item()
        cgn = clip_by_global_norm(cgrads, plan.config.grad_clip)[1].item()
        norm_errs.append(abs(gn - cgn) / cgn)
        RT.apply_update(plan, state, grads)
        RT.apply_update(cplan, cstate, cgrads)
        for tree, (rtol, atol) in OPT_TOL.items():
            src = state.params if tree == "params" else \
                getattr(state.opt_state, tree)
            dst = cstate.params if tree == "params" else \
                getattr(cstate.opt_state, tree)
            for a, c in zip(tree_leaves(src), tree_leaves(dst)):
                torch.testing.assert_close(a.cpu(), c, rtol=rtol, atol=atol)
                opt_errs[tree] = max(opt_errs[tree],
                                     float((a.cpu() - c).abs().max()))
    if hd == "vq":
        tables = ("hist_quant_err; the scales, and the codes "
                  f"{100 * min(t[0] for t in tabs):.3f}% equal "
                  f"({sum(t[1] for t in tabs)} differing, each a tie to "
                  f"{max(t[2] for t in tabs):.3g})")
    elif quant:
        tables = ("hist_quant_err; the tables within "
                  f"{max(t[0] for t in tabs):.6g} quantization steps, "
                  f"{100 * min(t[1] for t in tabs):.3f}% of the codes equal")
    else:
        tables = "the history tables"
    return (f"two steps on the card vs the CPU's plain versions: loss, "
            f"{len(grads)} gradients and {tables} within {max(errs):.3g}; "
            f"the update from the same gradients: global norms within a "
            f"relative {max(norm_errs):.3g}, "
            + ", ".join(f"{t} within {e:.3g}" for t, e in opt_errs.items()))


def with_history_dtype(plan, history_dtype):
    """The same plan (partition, batches, device arrays) over another
    store precision: `init_state` reads the config's `history_dtype`."""
    return dataclasses.replace(plan, config=dataclasses.replace(
        plan.config, history_dtype=history_dtype))


def training_phase(op, hd, plan, device):
    """Phase 4 for configuration `op` at one store precision. Returns the
    launch counts of its epochs and a summary for table 5's rows: the
    epochs' summed time, step p50, test accuracy and the reference's."""
    cfg = TRAIN_CONFIGS[op]
    tag = f"{op} {hd}"
    plan = with_history_dtype(plan, hd)
    spec, n_epochs = plan.spec, plan.config.epochs
    # (i) two steps on the card against the same steps on the CPU
    _phase("training", f"{tag}: " + _compare_steps(plan, _plan_on_cpu(plan)))

    # (ii) the configuration's epochs from fresh params, each step timed
    # to its sync; with several clusters per batch they are regrouped
    # before every epoch but the first, as `RT.train_epoch` does (host
    # work, timed apart)
    state = RT.init_state(plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    steps, epochs, losses, qerrs, regroups = [], [], [], [], []
    nb = plan.batches.num_batches
    for e in range(n_epochs):
        if plan.config.clusters_per_batch > 1 and e > 0:
            t0 = time.perf_counter()
            RT._regroup(plan)
            regroups.append(time.perf_counter() - t0)
        order = np.random.default_rng(plan.config.seed * 1000 + e
                                      ).permutation(nb)
        t_ep = time.perf_counter()
        for b in order:
            t0 = time.perf_counter()
            state, m = RT.train_step(plan, state, plan.batch(int(b)))
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"])
            qerrs.append(m["hist_quant_err"])
        epochs.append((time.perf_counter() - t_ep) * 1e3)
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    loss = torch.stack(losses[-nb:]).mean().item()
    epoch_qerr = torch.stack(qerrs).view(n_epochs, nb).mean(1).tolist()
    qerr = epoch_qerr[-1]
    assert np.isfinite(loss), loss
    store = state.histories
    f32_bytes = store.f32_bytes()
    assert (qerr == 0.0) == (hd == "f32"), qerr
    # every epoch's hist_quant_err under the precision's analytic bound
    q_bound = qerr_bound(hd, max(spec.hist_dims()))
    q_max = max(epoch_qerr)
    assert all(np.isfinite(epoch_qerr)), epoch_qerr
    assert (q_max < q_bound if hd == "vq" else q_max <= q_bound), \
        (tag, q_max, q_bound)
    # (iii) exact evaluation against the reference's accuracy at the same
    # precision on the same partition (the lowest of its runs where the
    # entry holds several); a partition the table does not hold is held to
    # the first entry, and the line says that the comparison crosses
    # partitions
    acc = RT.evaluate_exact(plan, state)
    logits = RT.predict(plan, state)
    assert logits.shape == (plan.graph.num_nodes, plan.spec.num_classes)
    assert torch.isfinite(logits).all(), "non-finite predict logits"
    digest = _digest(plan.part)
    refs = cfg["ref_test_acc"][hd]
    runs = np.atleast_1d(refs.get(digest, next(iter(refs.values()))))
    ref_acc = float(runs.min())
    ref_note = "same partition" if digest in refs else \
        f"partition {digest} not in the table: crosses partitions"
    if len(runs) > 1:
        apart = ("under six rng keys (the regularizer's noise)"
                 if spec.reg_weight else
                 "one ulp of the initial weights apart")
        ref_note += (f"; the lowest of {len(runs)} runs {apart}, "
                     f"{runs.min():.4f}-{runs.max():.4f}")
    assert acc["test_acc"] >= ref_acc - ACC_SLACK, (tag, acc, ref_acc)
    # (iv) the path's kernels, and the backward's launches per step: a
    # fused op runs bcsr_spmm once forward at layer 0 and once backward
    # per fused layer (and once more where layer 0's input carries a
    # gradient: GCNII's and APPNP's `_pre`), its fused aggregation once
    # per layer >= 1; with the regularizer every layer runs forward twice
    # and layers >= 1 backward twice (layer 0's input, the features, has
    # no gradient); GAT (PNA) runs each edge-softmax (pna_reduce) kernel
    # once per layer
    kernels = TRAIN_KERNELS[(op, hd)]
    missing = [k for k in kernels if launches[k] == 0]
    assert not missing, f"{tag}: kernels never launched: {missing}"
    n, L = len(steps), spec.num_layers
    if spec.reg_weight:
        assert launches["bcsr_spmm"] == (4 * L - 2) * n, launches
    elif spec.op in model.FUSED_OPS:
        layer0_grad = spec.op in ("gcnii", "appnp")
        assert launches["bcsr_spmm"] == (L + layer0_grad) * n, launches
        assert launches[kernels[1]] == (L - 1) * n, launches
    else:
        assert all(launches[k] == L * n for k in kernels[:3]), launches
    busy = _profiled_epoch(plan, state)
    regroup = (f" (and a regroup of the clusters before each: median "
               f"{1e3 * np.median(regroups):.1f} ms on the host)"
               if regroups else "")
    _phase("training", f"{tag}: {n_epochs} epochs x {nb} steps of "
           f"{L} layers: step "
           f"p50 {np.percentile(steps, 50):.3f} ms, p99 "
           f"{np.percentile(steps, 99):.3f} ms; epoch median "
           f"{np.median(epochs):.1f} ms (first {epochs[0]:.1f} ms)"
           f"{regroup}; peak "
           f"device memory {peak / 2**20:.1f} MiB; history store "
           f"{store.bytes():,} bytes ({f32_bytes / store.bytes():.2f}x vs "
           f"f32), last-epoch hist_quant_err {qerr:.4g} (every epoch's at "
           f"most {q_max:.4g}, bound {q_bound:.4g}); last-epoch loss "
           f"{loss:.3g}; test acc {acc['test_acc']:.4f} (reference "
           f"{ref_acc:.4f} at {hd}, {ref_note}), val {acc['val_acc']:.4f}; "
           f"launches " + str({k: v for k, v in launches.items() if v}))
    _phase("training", f"{tag}: one more epoch under torch.profiler: {busy}")
    if PARENT_LIB is not None and (op, hd) == PARENT_EPOCH_RUN:
        # the same epoch on the parent's kernels (the ones this version
        # redesigned) and the parent's pull_rows (a clamp before each
        # pull), then once more on this build's, in the same call
        def on_parent():
            ops.pull_rows = _parent_pull_rows
            try:
                return _profiled_epoch(plan, state)
            finally:
                ops.pull_rows = _NEW_PULL_ROWS

        for which, run in (("the parent's kernels and pull_rows",
                            lambda: _parent_call(on_parent)),
                           ("this build's kernels again",
                            lambda: _profiled_epoch(plan, state))):
            _phase("training", f"{tag}: one more epoch under "
                   f"torch.profiler on {which}: {run()}")
    return launches, {"train_ms": sum(epochs),
                      "step_p50": float(np.percentile(steps, 50)),
                      "acc": acc["test_acc"], "ref": ref_acc,
                      "ref_note": ref_note}


def two_steps(plan, hd, kernels):
    """Two steps of `plan`'s op over a store of precision `hd` on the card
    against the CPU's (`_compare_steps`), for a path the 60-epoch runs do
    not take: GAT over bf16 (the bf16 history pull) and PNA over vq.
    Returns the launch counts of the card's steps."""
    plan = with_history_dtype(plan, hd)
    cplan = _plan_on_cpu(plan)
    _build.reset_launch_counts()
    line = _compare_steps(plan, cplan)
    launches = dict(_build.launch_counts)
    missing = [k for k in kernels if launches[k] == 0]
    assert not missing, f"{plan.spec.op} {hd}: never launched: {missing}"
    _phase("training", f"{plan.spec.op} {hd}: {line}; launches "
           + str({k: v for k, v in launches.items() if v}))
    return launches


def vq_refit_phase(plan):
    """Phase 4, the codebook refit: the GCN quickstart over a vq store with
    `vq_refit_every=2` for 4 epochs (the refit runs at the start of epoch
    2). After epoch 1 the card's store is copied to the CPU and both
    refit their copy (the card decodes every row through gather_rows_vq
    and re-encodes it through scatter_rows_vq): the codebooks within 1e-6,
    >= 99.9% of the codes equal. Then the run goes on: the codebooks
    moved, entry 0 zero, the statistics finite and non-negative, the
    losses finite. Returns the launch counts of the 4 epochs."""
    cfg = dataclasses.replace(plan.config, history_dtype="vq",
                              vq_refit_every=2)
    plan = dataclasses.replace(plan, config=cfg)
    state = RT.init_state(plan)
    init = [c.clone() for c in state.histories.codebooks]
    _build.reset_launch_counts()
    losses = []
    for e in range(2):
        state, m = RT.train_epoch(plan, state, e)
        losses.append(m["loss"])
    # the GCN's path decodes no rows outside the fused body: every
    # gather_rows_vq launch from here on is the refit's
    assert _build.launch_counts["gather_rows_vq"] == 0
    card, cpu = state.histories.clone(), state.histories.to("cpu")
    before = dict(_build.launch_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.refit_codebooks()
    torch.cuda.synchronize()
    refit_ms = (time.perf_counter() - t0) * 1e3
    n_layers = card.num_layers
    for k in ("gather_rows_vq", "scatter_rows_vq"):
        assert _build.launch_counts[k] - before[k] == n_layers, k
    cpu.refit_codebooks()
    cb_err, same = 0.0, []
    for a, c in zip(card.codebooks, cpu.codebooks):
        torch.testing.assert_close(a.cpu(), c, rtol=0.0, atol=1e-6)
        cb_err = max(cb_err, float((a.cpu() - c).abs().max()))
        assert torch.all(a[:, 0] == 0)
    for a, c in zip(card.tables, cpu.tables):
        same.append(float((a.cpu() == c).float().mean()))
    assert min(same) >= 0.999, same
    for a, c in zip(card.scales, cpu.scales):
        torch.testing.assert_close(a.cpu(), c, rtol=RTOL, atol=0.0)
    for e in (2, 3):
        state, m = RT.train_epoch(plan, state, e)
        losses.append(m["loss"])
    assert np.isfinite(losses).all(), losses
    hist = state.histories
    for cb, cb0, cnt in zip(hist.codebooks, init, hist.cb_counts):
        assert not torch.equal(cb, cb0) and torch.all(cb[:, 0] == 0)
        assert (cnt >= 0).all() and torch.isfinite(cnt).all()
    launches = dict(_build.launch_counts)
    assert launches["gather_rows_vq"] == 2 * n_layers, launches
    acc = RT.evaluate_exact(plan, state)
    _phase("training", f"gcn vq refit (vq_refit_every=2, 4 epochs): the "
           f"refit of the epoch-1 store on the card ({refit_ms:.2f} ms, "
           f"{n_layers} table(s) of {card.tables[0].shape[0]} rows) vs the "
           f"same refit on the CPU: codebooks within {cb_err:.3g}, "
           f"{100 * min(same):.3f}% of the codes equal; epoch-2 refit in "
           f"the run: codebooks moved, entry 0 zero; losses "
           + ", ".join(f"{x:.4g}" for x in losses) + f"; test acc "
           f"{acc['test_acc']:.4f}; launches "
           + str({k: v for k, v in launches.items() if v}))
    return launches


def vq_bound_phase(device):
    """`scatter_rows_vq` through the store's push on ragged pushes with
    exact-zero rows (VQ_BOUND_PUSHES): each valid row's round trip (the
    push's codes and scale, read back by `gather_rows_vq`) within its
    codebook distortion sqrt(sum_s min_c ||u_s - c||^2) * scale (the
    distances in float64 on the host) and within its norm, masked rows
    read back zero. Fails the run on any miss."""
    _build.reset_launch_counts()
    worst = []
    for S, M, seed, scale_log in VQ_BOUND_PUSHES:
        d = S * VQ_SUBDIM
        rng = np.random.default_rng(seed)
        vals = (rng.normal(size=(M, d)) * 10.0 ** scale_log).astype(
            np.float32)
        vals[rng.random(M) < 0.2] = 0.0
        mask = rng.random(M) < 0.7
        N = M + 5
        idx = rng.choice(N - 1, M, replace=False).astype(np.int32)
        store = HistoryStore.create(N, [d], history_dtype="vq",
                                    device=device)
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        store.push(0, t(idx), t(vals), t(mask))
        got = store.pull(0, t(idx)).cpu().numpy().astype(np.float64)
        cb = store.layer_codebook(0).cpu().numpy().astype(np.float64)
        v = vals.astype(np.float64)
        amax = np.abs(v).max(axis=1)
        scale = np.where(amax > 0, amax, 1.0)
        u = (v / scale[:, None]).reshape(M, S, 1, VQ_SUBDIM)
        dist = scale * np.sqrt(((u - cb[None]) ** 2).sum(-1).min(-1).sum(-1))
        err = np.linalg.norm(got - v, axis=1)
        norm = np.linalg.norm(v, axis=1)
        assert (err[mask] <= dist[mask] * (1 + 1e-4) + 1e-5).all(), \
            (S, M, float(err[mask].max()), float(dist[mask].max()))
        assert (err[mask] <= norm[mask] * (1 + 1e-4) + 1e-6).all(), (S, M)
        assert (got[~mask] == 0).all(), (S, M)
        ratio = err[mask] / np.maximum(dist[mask], 1e-30)
        worst.append(f"S={S} M={M}: {int(mask.sum())} valid rows, "
                     f"{int((amax[mask] == 0).sum())} zero, max err / "
                     f"distortion {ratio.max() if ratio.size else 0:.6f}")
    pushes = _build.launch_counts["scatter_rows_vq"]
    assert pushes >= len(VQ_BOUND_PUSHES), pushes
    _phase("bounds", f"scatter_rows_vq ({pushes} launches) within the "
           f"codebook distortion and each row's norm on "
           f"{len(VQ_BOUND_PUSHES)} ragged pushes: " + "; ".join(worst))


@contextlib.contextmanager
def _timed_calls(obj, name, times):
    """Each call of `obj.name` (a module function, or an instance's
    method) timed to a sync of the card into `times` (ms) while the
    context is open."""
    fn = getattr(obj, name)
    own = name in vars(obj)

    def timed(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, timed)
    try:
        yield times
    finally:
        if own:
            setattr(obj, name, fn)
        else:
            delattr(obj, name)


def table5_phase(device, part, summaries):
    """Table 5 at its full sizes through the port's trainers on the card:
    GraphSAGE (its host sampler, then each step on the card), SGC, and
    CLUSTER-GCN and GAS-GCN through `GASTrainer` on table 5's partition
    (`part`), each trained by its `fit`, with every step timed to a sync;
    then the two deep rows from phase 4's runs (`summaries`). Each row's
    test accuracy is held at most ACC_SLACK below the reference's
    (TABLE5_REF); the GAS rows must launch their kernels. Returns the GAS
    rows' launch counts."""
    from repro_torch.train.baselines import GraphSAGETrainer, SGCTrainer
    from repro_torch.train.gas_trainer import GASTrainer, TrainConfig

    g = citation_graph(**TRAIN_CONFIGS["pna"]["graph"])
    digest = _digest(part)
    launches = {}
    for name, kind, kw in TABLE5_ROWS:
        kw = dict(kw)
        steps, samples = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _build.reset_launch_counts()
        if kind == "gas":
            spec = model.GNNSpec(op="gcn", d_in=g.x.shape[1],
                                 d_hidden=TABLE5_HIDDEN,
                                 num_classes=g.num_classes, num_layers=2)
            tr = GASTrainer(g, spec, num_parts=TRAIN_PARTS,
                            partitioner="metis", device=device, part=part,
                            tcfg=TrainConfig(epochs=TRAIN_EPOCHS, lr=0.01,
                                             seed=0), **kw)
            with _timed_calls(RT, "train_step", steps):
                tr.fit()
        else:
            tcfg = TrainConfig(epochs=kw.pop("epochs"), lr=kw.pop("lr"),
                               seed=0)
            if kind == "sage":
                tr = GraphSAGETrainer(g, tcfg=tcfg, device=device, **kw)
                with _timed_calls(tr, "_sample_batch", samples), \
                        _timed_calls(tr, "train_step", steps):
                    tr.fit()
            else:
                tr = SGCTrainer(g, tcfg=tcfg, device=device, **kw)
                with _timed_calls(tr, "train_step", steps):
                    tr.fit()
        torch.cuda.synchronize()
        train_ms = (time.perf_counter() - t0) * 1e3
        acc = tr.evaluate()["test_acc"]
        refs = TABLE5_REF[name]
        if isinstance(refs, dict):
            ref = refs.get(digest, next(iter(refs.values())))
            note = ("same partition" if digest in refs else
                    f"partition {digest} not in the table: crosses "
                    "partitions")
        else:
            ref = min(refs)
            note = (f"the lowest of the reference's {len(refs)} runs under "
                    f"seeds 0-{len(refs) - 1}, {min(refs):.4f}-"
                    f"{max(refs):.4f}")
        assert acc >= ref - ACC_SLACK, (name, acc, ref)
        extra = ""
        if kind == "gas":
            launches[f"table5 {name}"] = got = dict(_build.launch_counts)
            missing = [k for k in TABLE5_KERNELS[name] if got[k] == 0]
            assert not missing, f"table5 {name}: never launched: {missing}"
            extra = "; launches " + str({k: v for k, v in got.items() if v})
        if samples:
            extra += (f"; host sampling median {np.median(samples):.1f} ms "
                      f"a batch")
        _phase("table5", f"{name}: train {train_ms:.1f} ms (construction "
               f"and fit, {len(steps)} steps), step p50 "
               f"{np.percentile(steps, 50):.3f} ms; test acc {acc:.4f} "
               f"(reference {ref:.4f}, {note}){extra}")
    for name, run in TABLE5_FROM_PHASE4:
        r = summaries[run]
        _phase("table5", f"{name}: phase 4's {' '.join(run)} run "
               f"({TRAIN_EPOCHS} epochs through the runtime): train "
               f"{r['train_ms']:.1f} ms (the epochs), step p50 "
               f"{r['step_p50']:.3f} ms; test acc {r['acc']:.4f} "
               f"(reference {r['ref']:.4f}, {r['ref_note']})")
    return launches


def _profiled_epoch(plan, state) -> str:
    """One epoch (after the timed ones and the evaluation) under
    torch.profiler: the device's busy share of the window (the summed
    time of every kernel and copy on the device over the window's wall
    time, the profiler's own overhead included), the device kernels a
    step launches beside the history and feature pulls it makes (the
    launch counters of PULL_KERNELS: each pull is one of those kernels
    and nothing else), and the kernels taking the most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    nb = plan.batches.num_batches
    pulls = sum(_build.launch_counts[k] for k in PULL_KERNELS)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in range(nb):
            RT.train_step(plan, state, plan.batch(b))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: a kernel launched from an autograd.Function
    # (not an aten op) also books its time on the Function's host event
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in ev)
    if dev_us == 0:
        return "not measured (the profiler saw no device time)"
    pulls = sum(_build.launch_counts[k] for k in PULL_KERNELS) - pulls
    kernels = sum(e.count for e in ev if not e.key.startswith("Mem"))
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    return (f"device busy {dev_us / 1e3:.2f} of {wall_us / 1e3:.1f} ms "
            f"({100 * dev_us / wall_us:.1f}%) over {nb} steps; "
            f"{kernels / nb:.1f} device kernels a step, of which "
            f"{pulls / nb:.1f} pulls; most device "
            "time: " + "; ".join(
                f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x"
                f"{e.count}" for e in top))



def _raw_gather_rows(plan, device, gen):
    """Phase 2: `gather_rows_raw` at the GAT hidden layer's halo (batch
    0's halo ids, d = 64 f32, the sentinel's padding clipped in the
    kernel), bitwise its plain version for every element width a store
    holds (f32 and bf16 rows, int8 codes, vq's uint8 codes, the f32
    scales as 1-wide rows), each from a pinned host table and from a
    device table. Timed from both beside the plain version and the
    library: from the pinned table a contiguous non_blocking copy of the
    same bytes to the card, its bound the pulled rows over the host
    link's bandwidth measured here (one 64 MiB pinned copy_); from the
    device table `index_select`, its bound by HBM bytes. Returns the two
    rows (their launches from phase 6's GAT vq runs)."""
    batch = plan.batch(0)
    n1 = plan.graph.num_nodes + 1
    idx = batch.halo_nodes
    idx_cpu = idx.cpu()
    D = TRAIN_HIDDEN
    hist = torch.randn((n1, D), generator=gen, device=device)
    q8, s8 = ref.quantize_rows(hist)
    codes = ref.vq_encode_rows(hist, vq_init_codebook(D, device=device))[0]
    for what, t in (("f32", hist), ("bf16", hist.to(torch.bfloat16)),
                    ("int8 codes", q8), ("vq codes", codes),
                    ("scales", s8)):
        want = ref.gather_rows_raw_ref(t.cpu(), idx_cpu)
        for where, src in (("pinned", t.cpu().pin_memory()), ("device", t)):
            got = gather_rows_raw(src, idx)
            assert torch.equal(got.cpu(), want), \
                f"gather_rows_raw ({what}, {where} table) differs"
    big = torch.empty(64 << 20, dtype=torch.uint8, pin_memory=True)
    big_d = torch.empty_like(big, device=device)
    link_ms = _time_ms(lambda: big_d.copy_(big, non_blocking=True))
    link = big.numel() / (link_ms * 1e-3)
    M, R = idx.shape[0], D * 4
    n_src = int(torch.unique(idx.clamp(0, n1 - 1)).numel())
    host = hist.cpu().pin_memory()
    flat = torch.empty(M * R, dtype=torch.uint8, pin_memory=True)
    flat_d = torch.empty_like(flat, device=device)

    def plain_from_host():
        # the plain version runs on the CPU; its rows then go to the card
        t0 = time.perf_counter()
        ref.gather_rows_raw_ref(host, idx_cpu).to(device)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_from_host()
    pinned = _row("gather_rows_raw", "src/repro_torch/kernels/csrc/gather.cu",
                  "src/repro/core/history.py:596-600 (jnp.take in "
                  "prefetch; no pallas_call)", 0.0,
                  _time_ms(lambda: gather_rows_raw(host, idx)),
                  statistics.median(plain_from_host()
                                    for _ in range(TIMED_REPS)),
                  _time_ms(lambda: flat_d.copy_(flat, non_blocking=True)),
                  M * 4 + M * R, 0,
                  library="a contiguous non_blocking copy of the same "
                          "bytes from pinned memory")
    pinned["case"] = "pinned host table, GAT hidden-layer halo"
    link_bound = n_src * R / link * 1e3
    if link_bound > pinned["bound_ms"]:
        pinned["bound_ms"], pinned["bound_by"] = link_bound, "bytes"
    pinned["run"] = "host-store gat vq host/1"
    device_row = _row(
        "gather_rows_raw", "src/repro_torch/kernels/csrc/gather.cu",
        "src/repro/core/history.py:596-600 (jnp.take in prefetch; no "
        "pallas_call)", 0.0, _time_ms(lambda: gather_rows_raw(hist, idx)),
        _time_ms(lambda: ref.gather_rows_raw_ref(hist, idx)),
        _time_ms(lambda: torch.index_select(hist, 0, idx)),
        M * 4 + n_src * R + M * R, 0)
    device_row["case"] = "device table, GAT hidden-layer halo"
    device_row["run"] = "host-store gat vq device/1"
    _phase("kernels", f"gather_rows_raw, GAT hidden-layer halo ({M} rows of "
           f"{R} B, {n_src} distinct): every width (f32, bf16, int8 and vq "
           f"codes, 1-wide scales) bitwise its plain version from pinned "
           f"and device tables; the host link {link / 1e9:.2f} GB/s (a "
           f"64 MiB pinned copy_, {link_ms:.4f} ms); " + "; ".join(
               f"{r['case'].split(',')[0]}: {r['ms']:.4f} ms (plain "
               f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
               f"{r['bound_ms']:.5f} by {r['bound_by']})"
               for r in (pinned, device_row)))
    return [pinned, device_row]


def _raw_scatter_rows(kplan, q0, hist, gen):
    """Phase 2: `scatter_rows_raw` at the split frontend's query push (the
    128 rows of a query batch, d = 256), bitwise its plain version for
    every width a store holds (f32 and bf16 rows, int8 and vq codes, the
    f32 scales as 1-wide rows) into a pinned host table and a device one,
    with repeated indices and dropped rows. Timed into both beside the
    plain version and the library: into the device table `index_copy_`,
    its bound by HBM bytes; into the pinned table a contiguous
    non_blocking copy of the same bytes from the card, its bound the
    pushed rows over the card-to-host link's bandwidth measured here (one
    64 MiB copy_). Returns the two rows (their launches from phase 3d's
    split runs: f32 into a device store, int8 into a host one)."""
    device = hist.device
    n1 = hist.shape[0]
    batch = S.build_request_batch(kplan, np.sort(q0), QUERY_SIZE)
    idx = torch.where(batch.batch_mask, batch.batch_nodes,
                      torch.full_like(batch.batch_nodes, n1)
                      ).to(torch.int32)
    M, D = idx.shape[0], hist.shape[1]
    pay = torch.randn((M, D), generator=gen, device=device)
    q8, s8 = ref.quantize_rows(pay)
    codes = ref.vq_encode_rows(pay, vq_init_codebook(D, device=device))[0]
    dup = idx.clone()
    dup[1::9] = dup[0:-1:9]                  # repeats of earlier rows
    dup[4::13] = n1                          # dropped rows
    for what, t, rows in (
            ("f32", hist, pay), ("bf16", hist.to(torch.bfloat16),
                                 pay.to(torch.bfloat16)),
            ("int8 codes", ref.quantize_rows(hist)[0], q8),
            ("vq codes", torch.zeros((n1, D // VQ_SUBDIM), dtype=torch.uint8,
                                     device=device), codes),
            ("scales", torch.ones(n1, device=device), s8)):
        want = ref.scatter_rows_raw_ref(t.cpu(), dup.cpu(), rows.cpu())
        for where, dst in (("pinned", t.cpu().pin_memory()),
                           ("device", t.clone())):
            scatter_rows_raw(dst, dup, rows)
            torch.cuda.synchronize()
            assert torch.equal(dst.cpu(), want), \
                f"scatter_rows_raw ({what}, {where} table) differs"
    big = torch.empty(64 << 20, dtype=torch.uint8, pin_memory=True)
    big_d = torch.empty_like(big, device=device)
    link_ms = _time_ms(lambda: big.copy_(big_d, non_blocking=True))
    link = big.numel() / (link_ms * 1e-3)
    R = D * 4
    n_tgt = int(torch.unique(idx).numel())
    host = hist.cpu().pin_memory()
    idx_cpu = idx.cpu()
    flat = torch.empty(M * R, dtype=torch.uint8, pin_memory=True)
    flat_d = torch.empty_like(flat, device=device)

    def plain_into_host():
        # the plain version runs on the CPU, after the rows reach the host
        t0 = time.perf_counter()
        ref.scatter_rows_raw_ref(host, idx_cpu, pay.cpu())
        return (time.perf_counter() - t0) * 1e3

    plain_into_host()
    replaces = ("src/repro/core/serve_service.py:255-298 (.at[].set in "
                "HistoryBackend._op_push; no pallas_call)")
    source = "src/repro_torch/kernels/csrc/scatter.cu"
    pinned = _row("scatter_rows_raw", source, replaces, 0.0,
                  _time_ms(lambda: scatter_rows_raw(host, idx, pay)),
                  statistics.median(plain_into_host()
                                    for _ in range(TIMED_REPS)),
                  _time_ms(lambda: flat.copy_(flat_d, non_blocking=True)),
                  M * 4 + M * R + n_tgt * R, 0,
                  library="a contiguous non_blocking copy of the same "
                          "bytes into pinned memory")
    pinned["case"] = "pinned host table, split frontend's query push"
    link_bound = n_tgt * R / link * 1e3
    if link_bound > pinned["bound_ms"]:
        pinned["bound_ms"], pinned["bound_by"] = link_bound, "bytes"
    pinned["run"] = "split serving gcn int8"
    valid = batch.batch_mask
    uniq_idx, uniq_vals = idx[valid].long(), pay[valid]
    tgt = hist.clone()
    device_row = _row(
        "scatter_rows_raw", source, replaces, 0.0,
        _time_ms(lambda: scatter_rows_raw(tgt, idx, pay)),
        _time_ms(lambda: ref.scatter_rows_raw_ref(tgt, idx, pay)),
        _time_ms(lambda: tgt.index_copy_(0, uniq_idx, uniq_vals)),
        M * 4 + M * R + n_tgt * R, 0)
    device_row["case"] = "device table, split frontend's query push"
    device_row["run"] = "split serving gcn f32"
    _phase("kernels", f"scatter_rows_raw, the split frontend's query push "
           f"({M} rows of {R} B, {n_tgt} distinct targets): every width "
           f"(f32, bf16, int8 and vq codes, 1-wide scales) bitwise its plain "
           f"version into pinned and device tables, repeats and dropped "
           f"rows included; the card-to-host link {link / 1e9:.2f} GB/s (a "
           f"64 MiB pinned copy_, {link_ms:.4f} ms); " + "; ".join(
               f"{r['case'].split(',')[0]}: {r['ms']:.4f} ms (plain "
               f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
               f"{r['bound_ms']:.5f} by {r['bound_by']})"
               for r in (pinned, device_row)))
    return [pinned, device_row]


def _state_leaves(state):
    """Every tensor of a training state that a run changes, on the CPU:
    params, AdamW step and moments, tables, scales, codebooks, k-means
    statistics and the clock."""
    h = state.histories.sync()
    out = tree_leaves(state.params) + [state.opt_state.step]
    for tree in (state.opt_state.m, state.opt_state.v):
        out += tree_leaves(tree)
    out += h.tables + [h.age]
    for name in ("scales", "codebooks", "cb_counts", "cb_sums"):
        out += getattr(h, name) or []
    return [t.detach().cpu().clone() for t in out]


def host_store_phase(plans, device, gat_part):
    """Phase 6 (HOST_RUNS under HOST_VARIANTS): every variant bitwise
    device/0's, every host table pinned, or the phase fails. Returns
    {"host-store LABEL STORAGE/DEPTH": launch counts}."""
    launches = {}
    for label, name, hd, extra in HOST_RUNS:
        base = plans[name]
        rng0 = copy.deepcopy(base._np_rng)
        ref_run, ref_peak = None, None
        for storage, depth in HOST_VARIANTS:
            tag = f"{storage}/{depth}"
            plan = dataclasses.replace(
                base, config=dataclasses.replace(
                    base.config, history_dtype=hd, history_storage=storage,
                    prefetch_depth=depth, epochs=HOST_EPOCHS, **extra),
                history_storage=storage, _np_rng=copy.deepcopy(rng0),
                _last_qerr=None, _side=None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            _build.reset_launch_counts()
            state = RT.init_state(plan)
            where = state.histories.placement_bytes()
            steps = []
            with _timed_calls(RT, "train_step", steps), \
                    _timed_calls(RT, "prefetch_step", steps):
                metrics = [RT.train_epoch(plan, state, e)[1]
                           for e in range(HOST_EPOCHS)]
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            counts = dict(_build.launch_counts)
            launches[f"host-store {label} {tag}"] = counts
            h = state.histories
            host_tables = h.tables + (h.scales or [])
            if storage == "host":
                assert all(t.device.type == "cpu" and t.is_pinned()
                           for t in host_tables), \
                    f"{label} {tag}: a host table is not pinned"
            leaves = _state_leaves(state)
            table_bytes = sum(t.numel() * t.element_size()
                              for t in host_tables)
            host_tables_rows = h.tables[0].shape[0]
            n_steps, n_layers = len(steps), plan.spec.num_layers
            del state, h, host_tables
            if ref_run is None:
                ref_run, ref_peak, same = (leaves, metrics), peak, \
                    "the reference run"
            else:
                assert metrics == ref_run[1], \
                    f"{label} {tag}: epoch metrics differ from device/0"
                assert len(leaves) == len(ref_run[0]) and all(
                    torch.equal(a, b) for a, b in zip(leaves, ref_run[0])), \
                    f"{label} {tag}: state differs from device/0"
                same = "bitwise device/0 (params, moments, tables, scales, " \
                       "codebooks, clock, epoch metrics)"
            # the tables leave the card. A step holds one set of
            # mini-tables (every layer's max_h halo rows) at depth 0, two
            # at depth 1; GCNII-32L's peak is its regroup's upload of the
            # next epoch's blocks beside the last (two ~0.5 GiB stacks),
            # where no mini-table is live, so the peak falls by the tables
            mini = plan.batches.max_h * table_bytes // max(
                host_tables_rows, 1)
            if name == "gcnii32" and storage == "host":
                assert abs((ref_peak - peak) - table_bytes) < \
                    0.1 * table_bytes, (label, tag, ref_peak, peak,
                                        table_bytes)
            pushes = {k: v for k, v in counts.items()
                      if k.startswith("scatter_rows") and v}
            _phase("host-store", f"{label} {tag}: {HOST_EPOCHS} epochs x "
                   f"{n_steps // HOST_EPOCHS} steps of {n_layers} layers, "
                   f"{same}; store {where['device']:,} B on the device, "
                   f"{where['host']:,} B on the host (tables {table_bytes:,}"
                   f" B, a step's set of mini-tables {mini:,} B); peak "
                   f"device memory +{peak / 2**20:.2f} MiB over the run, "
                   f"{(ref_peak - peak) / 2**20:.2f} MiB below device/0's "
                   f"(the tables {table_bytes / 2**20:.2f} MiB); step p50 {np.percentile(steps, 50):.3f} ms, "
                   f"p99 {np.percentile(steps, 99):.3f} ms; launches "
                   f"gather_rows_raw {counts['gather_rows_raw']}, pushes "
                   f"{pushes}; host tables pinned: "
                   + ("yes" if storage == "host" else "none (device)"))
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        line = pool.submit(_profiled_host_epoch, gat_part).result()
    _phase("host-store", f"gat vq host/1, one epoch under torch.profiler in "
           f"a child process: {line}")
    return launches


def _intervals_union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _profiled_host_epoch(part):
    """Phase 6's profile, in a child process of its own: the GAT vq plan
    over a pinned host store at depth 1, one epoch to warm up, then one
    under torch.profiler. From its trace: the device's busy share (the
    union of the kernels' and copies' intervals over the window's wall
    time), the side stream's kernels (the prefetches, `gather_rows_raw`)
    and how much of their time overlaps main-stream kernels."""
    device = resolve_device("cuda")
    g, spec = _train_graph("gat")
    cfg = dataclasses.replace(_train_config("gat"), history_dtype="vq",
                              vq_refit_every=2, history_storage="host",
                              prefetch_depth=1)
    plan = RT.build_plan(g, spec, cfg, device=device, part=part)
    state = RT.init_state(plan)
    RT.train_epoch(plan, state, 0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        RT.train_epoch(plan, state, 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    path = ROOT / "build" / f"host_epoch_trace_{os.getpid()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        return "not measured (the profiler saw no device event)"
    side = {e["args"].get("stream") for e in dev
            if "gather_rows_raw" in e.get("name", "")}
    iv = lambda es: [(e["ts"], e["ts"] + e["dur"]) for e in es]  # noqa
    on_side = [e for e in dev if e["args"].get("stream") in side]
    main = _intervals_union(iv(e for e in dev
                               if e["args"].get("stream") not in side))
    busy = sum(b - a for a, b in _intervals_union(iv(dev)))
    side_us = sum(e["dur"] for e in on_side)
    over = sum(max(0.0, min(b, mb) - max(a, ma))
               for a, b in iv(on_side) for ma, mb in main)
    others = sorted({e["name"][:40] for e in on_side
                     if "gather_rows_raw" not in e["name"]})
    return (f"device busy {busy / 1e3:.3f} of {wall_us / 1e3:.1f} ms "
            f"({100 * busy / wall_us:.1f}%) over "
            f"{plan.batches.num_batches} steps; {len(on_side)} kernels on "
            f"the side stream(s) {sorted(side)} ({side_us:.1f} us; other "
            f"than gather_rows_raw: {others or 'none'}), {over:.1f} us of "
            f"them ({100 * over / max(side_us, 1e-9):.1f}%) overlapping "
            f"main-stream kernels; {len(dev) - len(on_side)} device events "
            f"on the main stream")


def _serve_stream(plan, state, queries, slo):
    """`serve_request` over `queries` in turn: (latencies ms, logits, the
    next state, host batch-build ms, the refreshed rows of each request).
    Every answer finite and of the right shape, its served halo rows no
    older than `slo`."""
    lat, logits, host_ms, refreshed = [], [], 0.0, []
    for q in queries:
        t0 = time.perf_counter()
        lg, state, d = S.serve_request(plan, state, q)
        lat.append((time.perf_counter() - t0) * 1e3)
        assert lg.shape == (len(q), N_CLASSES), lg.shape
        assert np.isfinite(lg).all(), "non-finite logits"
        if slo is not None:
            assert d["halo_age_max"] <= slo, (d, slo)
        assert d["host_build_ms"] > 0, d
        logits.append(lg)
        host_ms += d["host_build_ms"]
        refreshed.append(int(d["refreshed"]))
    return lat, logits, state, host_ms, refreshed


def _p50_p99(lat) -> str:
    return (f"p50 {np.percentile(lat, 50):.3f} ms, p99 "
            f"{np.percentile(lat, 99):.3f} ms")


def serving_phase(g, spec, device, kplan):
    """Phase 3. Returns the launch counts of the 32 requests."""
    N = g.num_nodes
    params = model.init_gnn(spec, seed=SEED, device=device)

    def fresh_state(plan):
        store = HistoryStore.create(N + 1, spec.hist_dims(), device=device)
        return S.init_serve_state(plan, S.ServeState(params, store))

    rng = np.random.default_rng(SEED + 1)
    queries = [rng.choice(N, size=QUERY_SIZE, replace=False)
               for _ in range(N_REQUESTS)]
    # warm-up on a throwaway store (library load, cuBLAS handles)
    S.serve_request(kplan, fresh_state(kplan), queries[0])

    plan0 = S.build_serve_plan(g, spec, S.ServeConfig(staleness_slo=0),
                               device=device)
    plan_none = dataclasses.replace(
        plan0, config=S.ServeConfig(staleness_slo=None))
    state = fresh_state(plan0)
    results = {}
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for slo, plan in ((0, plan0), (None, plan_none)):
        # host_ms: host time spent cutting request batches and tiling
        # their blocks (numpy), from the request diagnostics; the rest of
        # a request is the upload, the device work and the orchestration
        lat, logits, state, host_ms, refreshed = _serve_stream(
            plan, state, queries, slo)
        results[slo] = (lat, logits, refreshed, host_ms)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    assert not missing, f"kernels never launched while serving: {missing}"

    for slo, (lat, _, refreshed, host_ms) in results.items():
        _phase("serving", f"slo={slo}: {N_REQUESTS} x {QUERY_SIZE} queries, "
               f"{_p50_p99(lat)}, total {sum(lat):.1f} ms of which host "
               f"batch build {host_ms:.1f} ms; refreshed rows {refreshed} "
               f"(total {sum(refreshed)})")

    # SLO=0 against the plain full-graph forward on the card
    dst, src, w = G.gcn_edge_weights(g)
    exact = model.full_forward(
        params, spec, plan0.x,
        (torch.from_numpy(dst).to(device), torch.from_numpy(src).to(device)),
        torch.from_numpy(w).to(device), N).cpu().numpy()
    err0 = max(float(np.abs(lg - exact[q]).max())
               for q, lg in zip(queries, results[0][1]))
    for q, lg in zip(queries, results[0][1]):
        np.testing.assert_allclose(lg, exact[q], rtol=RTOL, atol=ATOL)
    # the warm cache holds the rows SLO=0 proved exact
    err_none = max(float(np.abs(a - b).max())
                   for a, b in zip(results[None][1], results[0][1]))
    for a, b in zip(results[None][1], results[0][1]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # a repeated request reads the same cached rows: bit-identical
    rep1 = S.serve_request(plan_none, state, queries[0])[0]
    rep2 = S.serve_request(plan_none, state, queries[0])[0]
    assert np.array_equal(rep1, rep2), "warm-cache repeat differs"
    _phase("serving", f"SLO=0 vs full forward max abs err {err0:.3g}; "
           f"SLO=None vs SLO=0 {err_none:.3g}; repeat bit-identical; "
           f"launches {launches}")
    return launches


def serving_quant_phase(g, spec, device, hd):
    """Phase 3 over a zero int8, bf16 or vq store (`hd`: every SLO=0
    refresh push quantizes, rounds or encodes, every fused aggregation
    dequantizes, upcasts or decodes). Returns the launch counts of the 32
    timed requests."""
    N = g.num_nodes
    params = model.init_gnn(spec, seed=SEED, device=device)
    cfg0 = S.ServeConfig(staleness_slo=0, history_dtype=hd)
    plan0 = S.build_serve_plan(g, spec, cfg0, device=device)
    plan_none = dataclasses.replace(plan0, config=S.ServeConfig(
        staleness_slo=None, history_dtype=hd))

    def fresh_state(plan, p):
        store = HistoryStore.create(N + 1, spec.hist_dims(), hd,
                                    plan.device)
        return S.init_serve_state(plan, S.ServeState(p, store))

    rng = np.random.default_rng(SEED + 1)
    queries = [rng.choice(N, size=QUERY_SIZE, replace=False)
               for _ in range(N_REQUESTS)]
    # SLO=0 on the card against the port's CPU serve_request (the plain
    # versions) on the same store and queries: two requests, as the CPU
    # takes seconds for each refresh at this shape. The stores: >= 99.9% of
    # the entries equal, and an int8 store's within one quantization step
    # per row, plus 127 * RTOL of it: a row's scale is its max / 127, an
    # f32 value the two devices compute at this depth and width to RTOL
    # apart (a row 1.0093 steps apart on an H100: its scales at least
    # 7.3e-5 apart). A bf16 store's differing entries are not bounded in
    # steps: an upper layer's refresh in the same request reads a lower
    # table's entries that rounded apart, so its own entries inherit that
    # difference (table 1 2.9 steps apart on an H100); the logits bound
    # what it does. A vq store's codes >= 99.9% equal, every code the two
    # chose apart a near-tie for the row the card pushed (VQ_TIE), the
    # scales at RTOL. The logits at SERVE_Q_TOL
    cplan = S.build_serve_plan(g, spec, cfg0, device="cpu")
    state = fresh_state(plan0, params)
    cstate = fresh_state(cplan, model.to_device(params, "cpu"))
    errs, tabs = [], []
    with _recorded_pushes(state.histories, hd == "vq") as pushes:
        for q in queries[:2]:
            lg, state, _ = S.serve_request(plan0, state, q)
            clg, cstate, _ = S.serve_request(cplan, cstate, q)
            if hd == "vq":
                tabs.append(_vq_codes_close(state.histories,
                                            cstate.histories, pushes))
            else:
                tabs.append(_quantized_tables_close(
                    state.histories, cstate.histories,
                    1 + 127 * RTOL if hd == "int8" else None))
            np.testing.assert_allclose(lg, clg, rtol=SERVE_Q_TOL[hd],
                                       atol=ATOL)
            errs.append(float(np.abs(lg - clg).max()))
    if hd == "vq":
        stores = (f"the codes {100 * min(t[0] for t in tabs):.3f}% equal, "
                  f"{sum(t[1] for t in tabs)} differing, each a tie to "
                  f"{max(t[2] for t in tabs):.3g}")
    else:
        stores = (f"the stores within {max(t[0] for t in tabs):.3g} "
                  f"quantization steps, {100 * min(t[1] for t in tabs):.3f}"
                  f"% of the entries equal")
    del cplan, cstate

    state = fresh_state(plan0, params)
    aux = ("codebooks", "cb_counts", "cb_sums")
    frozen = {k: [t.clone() for t in getattr(state.histories, k) or []]
              for k in aux}
    results = {}
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for slo, plan in ((0, plan0), (None, plan_none)):
        lat, logits, host_ms, qerr = [], [], 0.0, []
        for q in queries:
            t0 = time.perf_counter()
            lg, state, d = S.serve_request(plan, state, q)
            lat.append((time.perf_counter() - t0) * 1e3)
            assert lg.shape == (QUERY_SIZE, N_CLASSES), lg.shape
            assert np.isfinite(lg).all(), "non-finite logits"
            if slo is not None:
                assert d["halo_age_max"] <= slo, (d, slo)
            assert d["host_build_ms"] > 0 and d["hist_quant_err"] > 0, d
            logits.append(lg)
            host_ms += d["host_build_ms"]
            qerr.append(d["hist_quant_err"])
        results[slo] = (lat, logits, host_ms, qerr)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    missing = [k for k in SERVE_Q_KERNELS[hd] if launches[k] == 0]
    assert not missing, f"kernels never launched serving {hd}: {missing}"
    rep1 = S.serve_request(plan_none, state, queries[0])[0]
    rep2 = S.serve_request(plan_none, state, queries[0])[0]
    assert np.array_equal(rep1, rep2), f"{hd} warm-cache repeat differs"
    store = state.histories
    # serving leaves a vq store's codebooks and statistics bitwise as they
    # were (the tables moved)
    for k in aux:
        for a, b in zip(frozen[k], getattr(store, k) or []):
            assert torch.equal(a, b), f"serving changed the store's {k}"
    f32_bytes = store.f32_bytes()
    err_none = max(float(np.abs(a - b).max())
                   for a, b in zip(results[None][1], results[0][1]))
    for slo, (lat, _, host_ms, qerr) in results.items():
        _phase("serving", f"{hd} slo={slo}: {N_REQUESTS} x {QUERY_SIZE} "
               f"queries, p50 {np.percentile(lat, 50):.3f} ms, p99 "
               f"{np.percentile(lat, 99):.3f} ms, total {sum(lat):.1f} ms "
               f"of which host batch build {host_ms:.1f} ms; "
               f"hist_quant_err mean {np.mean(qerr):.4g}")
    _phase("serving", f"{hd}: SLO=0 vs the CPU's serve_request on the same "
           f"store and queries max abs err {max(errs):.3g} (2 requests; "
           f"{stores}); SLO=None vs SLO=0 {err_none:.3g}; repeat "
           f"bit-identical; " + ("codebooks and statistics unchanged; "
                                 if hd == "vq" else "") + "store "
           f"{store.bytes():,} bytes ({f32_bytes / store.bytes():.2f}x vs "
           f"f32); launches " + str({k: v for k, v in launches.items()
                                     if v}))
    return launches


def _decode_fault_controls(q, k, v, pos, want, limit) -> str:
    """Two faults planted in the plain version, held to the bf16 limit:
    the slots of one of the bf16 kernel's 4 warps dropped (warp 3: each
    warp scores 16 slots of every 64-slot tile, and the chunks start on
    tile boundaries), which the limit must fail; and p left unrounded
    before p @ v (v in f32), printed only."""
    s = torch.arange(ref.flash_decode_valid(pos, k.shape[1]),
                     device=k.device)
    keep = s[(s // 16) % 4 != 3]
    # pos = the kept count: every kept slot valid
    drop = ref.flash_decode_ref(q, k[:, keep], v[:, keep], len(keep))
    drop_err = float((drop.float() - want.float()).abs().max())
    assert drop_err > limit, (
        f"flash_decode's bf16 limit {limit:.3g} passes a plain version "
        f"with one warp's slots dropped (err {drop_err:.3g})")
    unr = ref.flash_decode_ref(q, k, v.float(), pos)
    unr_err = float((unr.float() - want.float()).abs().max())
    return (f"controls: one warp's slots dropped err {drop_err:.3g} "
            f"(fails the limit), p unrounded err {unr_err:.3g} "
            f"({'fails' if unr_err > limit else 'passes'} it)")


def decode_kernel_rows(device, clock_hz, arch=DECODE_ARCH,
                       cases=DECODE_KERNEL_CASES, run=None):
    """flash_decode against its plain version on seeded inputs at `arch`'s
    attention shapes (qwen3's DECODE_KERNEL_CASES by default): f32 within
    1e-5, bf16 within 2e-2 of the largest |output| (with two planted
    faults held to that limit where 256 slots or more are valid), and
    where slots lie past pos, the masked tail redrawn (k and v) leaving
    the output bitwise unchanged; the timed cases beside the plain version
    and SDPA. Returns the timed rows (launches filled in from the decode
    phase, or from `run`'s)."""
    cfg = get_config(arch, "full")
    Kh, Dh = cfg.num_kv_heads, cfg.head_dim_
    G = cfg.num_heads // Kh
    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=device).to(dt)

    rows = []
    for B_, S_, pos, dt, timed in cases:
        q = randn((B_, Kh, G, Dh), dt)
        k, v = randn((B_, S_, Kh, Dh), dt), randn((B_, S_, Kh, Dh), dt)
        out = flash_decode(q, k, v, pos)
        want = ref.flash_decode_ref(q, k, v, pos)
        err = float((out.float() - want.float()).abs().max())
        n_valid = ref.flash_decode_valid(pos, S_)
        line = (f"flash_decode B={B_} S={S_} pos={pos} "
                f"{str(dt).split('.')[-1]}"
                + ("" if run is None else f" Kh={Kh} G={G} Dh={Dh}")
                + f": err {err:.3g} ")
        if dt == torch.float32:
            torch.testing.assert_close(out.float(), want.float(),
                                       rtol=DECODE_KERNEL_F32_TOL,
                                       atol=DECODE_KERNEL_F32_TOL)
            line += f"(tol {DECODE_KERNEL_F32_TOL})"
        else:
            top = float(want.float().abs().max())
            limit = DECODE_KERNEL_BF16_REL * top
            assert err <= limit, (
                f"flash_decode bf16 err {err:.3g} above {limit:.3g} = "
                f"{DECODE_KERNEL_BF16_REL} x max |output| {top:.3g}")
            line += (f"(limit {limit:.3g} = {DECODE_KERNEL_BF16_REL} x max "
                     f"|output| {top:.3g})")
            if n_valid >= 256:
                line += "; " + _decode_fault_controls(q, k, v, pos, want,
                                                      limit)
        if n_valid < S_:
            k2, v2 = k.clone(), v.clone()
            k2[:, n_valid:] = randn(k2[:, n_valid:].shape, dt)
            v2[:, n_valid:] = randn(v2[:, n_valid:].shape, dt)
            assert torch.equal(flash_decode(q, k2, v2, pos), out), \
                "slots past pos moved flash_decode's output"
            line += "; masked tail redrawn: output bitwise unchanged"
            del k2, v2
        if timed:
            # the library yardstick: SDPA over the same cache with GQA and
            # a boolean mask of the valid slots; its heads-first layouts
            # are made here, outside the timed call
            qs = q.reshape(B_, Kh * G, 1, Dh)
            ks = k.permute(0, 2, 1, 3).contiguous()
            vs = v.permute(0, 2, 1, 3).contiguous()
            mask = (torch.arange(S_, device=device) < n_valid)[None, None,
                                                                None]

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True)

            lib_err = float((sdpa().reshape(q.shape).float()
                             - want.float()).abs().max())
            E = q.element_size()
            # bytes: each valid k and v row once, q read and out written;
            # operations: the two products' FMAs and one exp per slot
            row = _row(
                "flash_decode", "src/repro_torch/kernels/csrc/decode_attn.cu",
                "src/repro/kernels/decode_attn.py:67 (body _kernel :26-63)",
                err, _time_ms(lambda: flash_decode(q, k, v, pos)),
                _time_ms(lambda: ref.flash_decode_ref(q, k, v, pos)),
                _time_ms(sdpa),
                2 * B_ * n_valid * Kh * Dh * E + 2 * q.numel() * E,
                4.0 * B_ * Kh * G * n_valid * Dh, exps=B_ * Kh * G * n_valid,
                clock_hz=clock_hz)
            row["case"] = f"B={B_}, S={S_}, pos={pos}, bf16"
            if run is not None:
                row["case"] = (f"{arch}: B={B_}, Kh={Kh}, G={G}, Dh={Dh}, "
                               f"S={S_}, pos={pos}, bf16")
                row["run"] = run
            rows.append(row)
            line += (f"; {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
                     f"SDPA {row['library_ms']:.4f} with err {lib_err:.3g}, "
                     f"bound {row['bound_ms']:.4f} by {row['bound_by']})")
            del qs, ks, vs
        _phase("kernels", line)
        if timed and run is None:
            _beside_parent(
                f"flash_decode B={B_} S={S_} pos={pos}", row["ms"], out,
                None if PARENT_LIB is None else _parent_flash_decode(
                    q, k, v, pos),
                lambda: _parent_flash_decode(q, k, v, pos), limit)
        del q, k, v, out, want
    return rows


def _greedy_decode(params, cfg, cache, logits, steps):
    """`steps` greedy decode steps from the prefill's last logits, each
    timed on the host clock to its synchronize. Returns (logits [steps +
    1, B, V], the prefill's first; the tokens fed [B, steps]; the steps'
    ms; the cache)."""
    out, toks, ms = [logits], [], []
    for _ in range(steps):
        tok = out[-1].argmax(-1, keepdim=True).to(torch.int32)
        t0 = time.perf_counter()
        logits, cache = TF.decode_step(params, cfg, cache, tok)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits)
        toks.append(tok)
    return torch.stack(out), torch.cat(toks, dim=1), ms, cache


def _decode_logits_err(params, cfg, prompts, fed, steps):
    """The KV-cache check's first number: (max |decode logits - forward's
    at the same positions|, forward's max |logit|, argmax agreement) over
    the prefill's last logits and each step's; `forward` runs on the
    prompts and the tokens fed."""
    T, n = prompts.shape[1], fed.shape[1]
    full, _ = TF.forward(params, cfg, {"tokens": torch.cat([prompts, fed],
                                                           dim=1)})
    at = full[:, T - 1:T + n].transpose(0, 1).float()
    del full
    err = float((steps.float() - at).abs().max())
    agree = float((steps.argmax(-1) == at.argmax(-1)).float().mean())
    return err, float(at.abs().max()), agree


def _decode_cache_err(params, cfg, cache, prompts, fed, cache_len) -> float:
    """The KV-cache check's second number: the largest |decode cache -
    prefill's cache over the prompts and the tokens fed|, each leaf's (k
    or v of every layer) as a share of that leaf's max |value| in
    prefill's."""
    _, want = TF.prefill(params, cfg, {"tokens": torch.cat([prompts, fed],
                                                           dim=1)},
                         cache_len)
    assert want["pos"] == cache["pos"], (want["pos"], cache["pos"])
    worst = 0.0
    for a, b in zip(tree_leaves(cache["segs"]), tree_leaves(want["segs"])):
        d = max(float((x.float() - y.float()).abs().max())
                for x, y in zip(a, b))
        worst = max(worst, d / float(b.abs().max()))
    return worst


def _slot_fault_control(params, cfg, prompts, cache_len):
    """A planted fault: FULL's prefill, then DECODE_CONTROL_STEPS greedy
    steps in which each new k / v lands one slot early (slot pos - 1,
    slot pos left as prefill left it, zero past the prompt), as if
    attention_decode computed its slot off by one. Returns the two
    KV-cache numbers under it ((logits err, max |logit|), cache err)."""
    logits, cache = TF.prefill(params, cfg, {"tokens": prompts}, cache_len)

    def planted(q, k, v, pos, scale=None):
        s, e = pos % k.shape[1], (pos - 1) % k.shape[1]
        k[:, e], v[:, e] = k[:, s], v[:, s]
        k[:, s], v[:, s] = 0, 0
        return flash_decode(q, k, v, pos, scale)

    ATT.flash_decode = planted
    try:
        steps, fed, _, cache = _greedy_decode(params, cfg, cache, logits,
                                              DECODE_CONTROL_STEPS)
    finally:
        ATT.flash_decode = flash_decode
    err, top, _ = _decode_logits_err(params, cfg, prompts, fed, steps)
    return (err, top), _decode_cache_err(params, cfg, cache, prompts, fed,
                                         cache_len)


def _profile(fn, cpu=True):
    """One call of `fn` under torch.profiler: (its device events, most
    device time first; their device us; the call's wall us). `cpu=False`
    records the device alone (a training step's ~10^5 host events take
    the profiler longer to process than the step)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = sorted((e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0),
                key=lambda e: -e.self_device_time_total)
    return ev, sum(e.self_device_time_total for e in ev), wall_us


def _profiled_decode_step(params, cfg, cache, tok) -> str:
    """One decode step under torch.profiler: flash_decode's share of the
    step's device time and of its wall time."""
    ev, dev_us, wall_us = _profile(
        lambda: TF.decode_step(params, cfg, cache, tok))
    if dev_us == 0:
        return "not measured (the profiler saw no device time)"
    fd_us = sum(e.self_device_time_total for e in ev
                if "flash_decode" in e.key)
    return (f"flash_decode {fd_us / 1e3:.3f} ms of {dev_us / 1e3:.3f} ms "
            f"device time ({100 * fd_us / dev_us:.1f}%), the step "
            f"{wall_us / 1e3:.2f} ms wall under the profiler (device busy "
            f"{100 * dev_us / wall_us:.1f}%)")


def decode_phase(device, smi):
    """Phase 3b. qwen3-0.6b serving at its published widths in bf16 with
    seeded random weights: for each of DECODE_RUNS a prefill of DECODE_B
    MarkovTokens prompts, then DECODE_STEPS greedy decode steps, each
    step's logits held against `forward` over the prompt and the tokens
    fed so far at its position and every layer's cache after the steps
    against `prefill`'s over the same tokens (the KV-cache check; both run
    attention_forward, never the kernel), with a planted slot fault on
    FULL that the cache number must fail; a decode step repeated from two
    clones of the cache bit-identical; one step profiled. Then 2 layers of
    the same widths in f32: prefill and 8 decode steps on the card
    against the same on the CPU. Returns the launch counts of the decode
    loops."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg_full = get_config(DECODE_ARCH, "full")
    # LONG differs from FULL in its window alone: one set of params
    params = TF.init_params(cfg_full, seed=DECODE_SEED, device=device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    source = MarkovTokens(cfg_full.vocab_size, seed=DECODE_SEED)
    # warm-up: cuBLAS's handles and heuristics, the kernel library
    wl, wc = TF.prefill(params, cfg_full, {"tokens": torch.zeros(
        (DECODE_B, 16), dtype=torch.int32, device=device)}, cache_len=32)
    TF.decode_step(params, cfg_full, wc, wl.argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    _phase("decode", f"{cfg_full.name} at its published widths "
           f"({cfg_full.num_layers} layers, d_model {cfg_full.d_model}, "
           f"{cfg_full.num_heads} heads over {cfg_full.num_kv_heads} KV "
           f"heads of {cfg_full.head_dim_}, vocab {cfg_full.vocab_size}): "
           f"{n_params:,} params in bf16, seed {DECODE_SEED}, ready in "
           f"{time.perf_counter() - t0:.1f} s")
    del wl, wc
    launches = dict.fromkeys(_build.KERNELS, 0)
    for variant, T, cache_len in DECODE_RUNS:
        cfg = get_config(DECODE_ARCH, variant)
        prompts = torch.from_numpy(source.sample(DECODE_B, T)[:, :T]).to(
            device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = TF.prefill(params, cfg, {"tokens": prompts},
                                   cache_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        Sc = cache["segs"][0]["0"]["k"].shape[2]
        _build.reset_launch_counts()
        steps, fed, ms, cache = _greedy_decode(params, cfg, cache, logits,
                                               DECODE_STEPS)
        counts = dict(_build.launch_counts)
        want = DECODE_STEPS * cfg.num_layers
        assert counts["flash_decode"] == want, (counts["flash_decode"], want)
        for name, n in counts.items():
            launches[name] += n
        assert steps.shape == (DECODE_STEPS + 1, DECODE_B,
                               cfg.vocab_size), steps.shape
        assert torch.isfinite(steps).all(), "non-finite decode logits"
        # the KV-cache check: forward's logits at each step's position,
        # then prefill's cache over the same tokens
        err, scale, agree = _decode_logits_err(params, cfg, prompts, fed,
                                               steps)
        assert err <= DECODE_TOL * scale, (
            f"{variant}: decode logits {err:.3g} from forward's, above "
            f"{DECODE_TOL} x {scale:.3g}")
        cerr = _decode_cache_err(params, cfg, cache, prompts, fed, cache_len)
        assert cerr <= DECODE_CACHE_TOL, (
            f"{variant}: the decode cache {cerr:.3g} of max |value| from "
            f"prefill's, above {DECODE_CACHE_TOL}")
        # a decode step from two clones of the cache: bit-identical
        tok = steps[-1].argmax(-1, keepdim=True).to(torch.int32)
        c1, c2 = ({"pos": cache["pos"],
                   "segs": tree_map(torch.clone, cache["segs"])}
                  for _ in range(2))
        l1, c1 = TF.decode_step(params, cfg, c1, tok)
        l2, c2 = TF.decode_step(params, cfg, c2, tok)
        assert torch.equal(l1, l2) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(c1["segs"]),
                                              tree_leaves(c2["segs"]))), \
            f"{variant}: a repeated decode step differs"
        del c1, c2, l1, l2
        prof = _profiled_decode_step(params, cfg, cache, tok)
        control = ""
        if variant == "full":
            (f_err, f_top), f_cerr = _slot_fault_control(params, cfg,
                                                          prompts, cache_len)
            assert f_cerr > DECODE_CACHE_TOL, (
                f"the cache check passes a planted slot fault ({f_cerr:.3g})")
            control = (f"; control, each new k / v one slot early for "
                       f"{DECODE_CONTROL_STEPS} steps: logits err {f_err:.3g} "
                       f"of max |logit| {f_top:.3g} ("
                       + ("fails" if f_err > DECODE_TOL * f_top else "passes")
                       + f" the logits check), cache err {f_cerr:.3g} (fails "
                       f"the cache check)")
        _phase("decode", f"{variant}: prefill {DECODE_B} x {T} tokens into "
               f"{Sc} slots a layer in {prefill_ms:.1f} ms; {DECODE_STEPS} "
               f"greedy steps (pos {T} to {T + DECODE_STEPS - 1}"
               + (", all past the rolling buffer's end" if T >= Sc else "")
               + f"): step p50 {np.percentile(ms, 50):.3f} ms, p99 "
               f"{np.percentile(ms, 99):.3f} ms, "
               f"{DECODE_B * DECODE_STEPS / (sum(ms) / 1e3):.1f} tokens/s; "
               f"flash_decode launches {counts['flash_decode']}; logits vs "
               f"forward's max abs err {err:.3g} (max |logit| {scale:.3g}, "
               f"tol {DECODE_TOL} x that), argmax agreement "
               f"{100 * agree:.2f}%; caches vs prefill's {cerr:.3g} of max "
               f"|value| (tol {DECODE_CACHE_TOL}){control}; a repeated "
               f"step bit-identical; one step profiled: {prof}")
        del cache, steps, fed, logits, prompts
    peak = torch.cuda.max_memory_allocated()
    _phase("decode", f"peak device memory {peak / 2**30:.2f} GiB; "
           f"nvidia-smi: {smi}")

    # 2 layers of the same widths in f32, the card against the CPU on one
    # set of weights and the same tokens (a cache of 300 slots: decode
    # reads a masked tail, and 300 is no multiple of the kernel's chunks)
    cfg2 = dataclasses.replace(cfg_full, num_layers=2, dtype="float32")
    p2 = TF.init_params(cfg2, seed=DECODE_SEED + 1, device=device)
    toks = torch.from_numpy(source.sample(2, 264)[:, :264])
    res = {}
    for d, p in ((device, p2), ("cpu", tree_map(lambda a: a.cpu(), p2))):
        logits, cache = TF.prefill(p, cfg2, {"tokens": toks[:, :256].to(d)},
                                   cache_len=300)
        outs = [logits]
        for s in range(8):
            logits, cache = TF.decode_step(p, cfg2, cache,
                                           toks[:, 256 + s:257 + s].to(d))
            outs.append(logits)
        res[d] = (torch.stack(outs).cpu(),
                  [a.cpu() for a in tree_leaves(cache["segs"])])
    torch.testing.assert_close(res[device][0], res["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(res[device][1], res["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    lerr = float((res[device][0] - res["cpu"][0]).abs().max())
    cerr = max(float((a - b).abs().max())
               for a, b in zip(res[device][1], res["cpu"][1]))
    _phase("decode", f"2 layers at the full widths in f32, prefill 2 x 256 "
           f"tokens into 300 slots and 8 decode steps: the card vs the CPU "
           f"logits max abs err {lerr:.3g} (tol 1e-4), caches {cerr:.3g} "
           f"(tol 1e-5)")
    del params, p2, res
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 9: recurrentgemma-9b decode, seq-GAS training, hubert's passes,
# the moe and cross layers
# ---------------------------------------------------------------------------

def _open_gates(params):
    """Every cross layer's tanh gates opened (the init closes them, which
    would hide the layer)."""
    for seg in params["segs"]:
        for lp in seg.values():
            if "g_attn" in lp:
                lp["g_attn"].fill_(0.5)
                lp["g_mlp"].fill_(-0.3)
    return params


def _max_err(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def _logits_at(params, cfg, toks, T) -> torch.Tensor:
    """`forward`'s logits at positions T - 1 onward ([n + 1, B, V] f32),
    the last norm and lm_head applied to those positions alone (no [B,
    T, V] logits held)."""
    x, ctx = TF._embed_inputs(params, cfg, {"tokens": toks})
    x, _, _ = TF._run_segments(params, x, ctx, cfg, None)
    x = TF._norm(cfg, params["final_norm"], x[:, T - 1:])
    return (x @ params["lm_head"]).transpose(0, 1).float()


def _widen(tree) -> None:
    """Every tensor of a params tree cast to f32 in place, leaf by leaf
    (each bf16 leaf freed as its f32 copy replaces it)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, torch.Tensor):
            tree[k] = v.float()
        else:
            _widen(v)


def _profiled_ms(fn) -> str:
    """One call of `fn` under torch.profiler: its device time, busy share
    of the wall time, and the three kernels with the most device time."""
    ev, dev_us, wall_us = _profile(fn, cpu=False)
    if dev_us == 0:
        return "not measured (the profiler saw no device time)"
    top = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms "
                    f"({e.count} launches)" for e in ev[:3])
    return (f"{dev_us / 1e3:.1f} ms device time in {wall_us / 1e3:.1f} ms "
            f"wall (busy {100 * dev_us / wall_us:.1f}%); most: {top}")


def _card_vs_cpu(params, cfg, toks, steps, extra=None, cache_len=None):
    """Prefill of toks[:, :-steps] and `steps` decode steps on the card
    and on the CPU from the same weights. Returns ({device: (logits,
    cache leaves)} on the host, the card's flash_decode launches in its
    decode steps, seconds per device)."""
    extra = extra or {}
    T = toks.shape[1] - steps
    dev = tree_leaves(params)[0].device
    out, secs, launches = {}, {}, None
    for d, p in ((dev, params), ("cpu", tree_map(lambda a: a.cpu(),
                                                 params))):
        t0 = time.perf_counter()
        ex = {k: v.to(d) for k, v in extra.items()}
        full, _ = TF.forward(p, cfg, {"tokens": toks.to(d), **ex})
        logits, cache = TF.prefill(p, cfg, {"tokens": toks[:, :T].to(d),
                                            **ex}, cache_len)
        outs = [full[:, T - 1], logits]
        del full
        if d == dev:
            _build.reset_launch_counts()
        for s_ in range(steps):
            logits, cache = TF.decode_step(p, cfg, cache,
                                           toks[:, T + s_:T + s_ + 1].to(d))
            outs.append(logits)
        if d == dev:
            torch.cuda.synchronize()
            launches = _build.launch_counts["flash_decode"]
        out[d] = ([o.cpu() for o in outs],
                  [a.cpu() for a in tree_leaves(cache["segs"])])
        secs[d] = time.perf_counter() - t0
        del p, cache
    return out, launches, secs


@torch.no_grad()
def rec_decode_phase(device, smi):
    """Phase 9b. recurrentgemma-9b at its published widths in bf16 with
    seeded weights: a prefill of REC_B MarkovTokens prompts of REC_PROMPT
    tokens (the local layers' caches rolled to the 2,048-slot window),
    REC_STEPS greedy decode steps, every step's logits against `forward`
    over the prompt and the tokens fed (bf16, printed) and against the
    f32 truth (held as REC_TRUTH_B's comment says), the widened weights'
    f32 decode against the f32 forward, a step repeated from two clones
    of the cache bit-identical, one step profiled. Then one pattern
    repeat at the same widths in f32 on the card against the CPU.
    Returns the launch counts of the decode loop."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_config(REC_ARCH, "full")
    params = TF.init_params(cfg, seed=REC_SEED, device=device)
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_local = cfg.layer_types().count("local")
    source = MarkovTokens(cfg.vocab_size, seed=REC_SEED)
    wl, wc = TF.prefill(params, cfg, {"tokens": torch.zeros(
        (REC_B, 16), dtype=torch.int32, device=device)}, cache_len=32)
    TF.decode_step(params, cfg, wc, wl.argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    del wl, wc
    _phase("decode", f"{cfg.name} at its published widths "
           f"({cfg.num_layers} layers of {'/'.join(cfg.pattern)}, d_model "
           f"{cfg.d_model}, lru_width {cfg.lru_width}, {cfg.num_heads} heads "
           f"over {cfg.num_kv_heads} KV head of {cfg.head_dim_}, window "
           f"{cfg.window}, vocab {cfg.vocab_size}): {n_params:,} params in "
           f"bf16, seed {REC_SEED}, built in {init_s:.1f} s (peak "
           f"{init_peak / 2**30:.2f} GiB while the layers are stacked)")
    prompts = torch.from_numpy(source.sample(REC_B, REC_PROMPT)
                               [:, :REC_PROMPT]).to(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = TF.prefill(params, cfg, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    Sc = cache["segs"][0][str(cfg.pattern.index("local"))]["k"].shape[2]
    assert Sc == cfg.window < REC_PROMPT, Sc
    _build.reset_launch_counts()
    steps, fed, ms, cache = _greedy_decode(params, cfg, cache, logits,
                                           REC_STEPS)
    counts = dict(_build.launch_counts)
    assert counts["flash_decode"] == REC_STEPS * n_local, (
        counts["flash_decode"], REC_STEPS * n_local)
    assert steps.shape == (REC_STEPS + 1, REC_B, cfg.vocab_size)
    assert torch.isfinite(steps).all(), "non-finite decode logits"
    toks = torch.cat([prompts, fed], dim=1)
    fwd_b = _logits_at(params, cfg, toks, REC_PROMPT)
    err = float((steps.float() - fwd_b).abs().max())
    scale = float(fwd_b.abs().max())
    agree = float((steps.argmax(-1) == fwd_b.argmax(-1)).float().mean())
    tok = steps[-1].argmax(-1, keepdim=True).to(torch.int32)
    c1, c2 = ({"pos": cache["pos"],
               "segs": tree_map(torch.clone, cache["segs"])}
              for _ in range(2))
    l1, c1 = TF.decode_step(params, cfg, c1, tok)
    l2, c2 = TF.decode_step(params, cfg, c2, tok)
    assert torch.equal(l1, l2) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(c1["segs"]),
                                          tree_leaves(c2["segs"]))), \
        f"{cfg.name}: a repeated decode step differs"
    del c1, c2, l1, l2
    prof = _profiled_decode_step(params, cfg, cache, tok)
    peak = torch.cuda.max_memory_allocated()
    del cache
    torch.cuda.empty_cache()

    # the f32 truth: the same weights widened in place, `forward` over the
    # first REC_TRUTH_B sequences; then they decode in f32 from the same
    # prompts, fed the same tokens
    Bt = REC_TRUTH_B
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    _widen(params)
    truth = _logits_at(params, cfg32, toks[:Bt], REC_PROMPT)
    top = float(truth.abs().max())
    dec_err = float((steps[:, :Bt].float() - truth).abs().max())
    fwd_err = float((fwd_b[:, :Bt] - truth).abs().max())
    assert dec_err <= REC_BF16_VS_FWD * fwd_err, (
        f"{cfg.name}: the bf16 decode {dec_err:.3g} from the f32 truth, "
        f"above {REC_BF16_VS_FWD} x the bf16 forward's {fwd_err:.3g}")
    logits32, c32 = TF.prefill(params, cfg32, {"tokens": prompts[:Bt]})
    steps32 = [logits32]
    for s_ in range(REC_STEPS):
        logits32, c32 = TF.decode_step(params, cfg32, c32,
                                       fed[:Bt, s_:s_ + 1])
        steps32.append(logits32)
    ex_err = float((torch.stack(steps32) - truth).abs().max())
    assert ex_err <= REC_F32_EXACT_REL * top, (
        f"{cfg.name}: the f32 decode {ex_err:.3g} from the f32 forward, "
        f"above {REC_F32_EXACT_REL} x {top:.3g}")
    del c32, steps32, truth
    _phase("decode", f"{cfg.name}: prefill {REC_B} x {REC_PROMPT} tokens "
           f"(each local layer's cache rolled into its {Sc} slots) in "
           f"{prefill_ms:.1f} ms; {REC_STEPS} greedy steps (pos "
           f"{REC_PROMPT} to {REC_PROMPT + REC_STEPS - 1}, all past the "
           f"window's end): step p50 {np.percentile(ms, 50):.3f} ms, p99 "
           f"{np.percentile(ms, 99):.3f} ms, "
           f"{REC_B * REC_STEPS / (sum(ms) / 1e3):.1f} tokens/s; "
           f"flash_decode launches {counts['flash_decode']} ({n_local} "
           f"local layers a step); logits vs the bf16 forward's at every "
           f"step max abs err {err:.3g} (max |logit| {scale:.3g}; "
           f"{100 * err / scale:.2f}%, not held to qwen3's {DECODE_TOL}), "
           f"argmax agreement {100 * agree:.2f}%; against the f32 truth on "
           f"{Bt} sequences (max |logit| {top:.3g}): the bf16 decode "
           f"{dec_err:.3g}, the bf16 forward {fwd_err:.3g} (held: decode <= "
           f"{REC_BF16_VS_FWD} x forward), the f32 decode {ex_err:.3g} (tol "
           f"{REC_F32_EXACT_REL} x max |logit|); a repeated step "
           f"bit-identical; one step profiled: {prof}; peak device memory "
           f"{peak / 2**30:.2f} GiB; nvidia-smi: {smi}")
    del params, steps, fed, logits, prompts, fwd_b
    torch.cuda.empty_cache()

    # one pattern repeat at the full widths in f32: the card against the
    # CPU on one set of weights and the same tokens
    B1, T1, n1 = REC_F32
    cfg3 = dataclasses.replace(cfg, num_layers=len(cfg.pattern),
                               dtype="float32")
    p3 = TF.init_params(cfg3, seed=REC_SEED + 1, device=device)
    toks = torch.from_numpy(source.sample(B1, T1 + n1)[:, :T1 + n1])
    res, n_fd, secs = _card_vs_cpu(p3, cfg3, toks, n1)
    assert n_fd == n1 * cfg3.layer_types().count("local"), n_fd
    lerr = _max_err(res[device][0], res["cpu"][0])
    cerr = _max_err(res[device][1], res["cpu"][1])
    for a, b in zip(res[device][0] + res[device][1],
                    res["cpu"][0] + res["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=REC_F32_TOL, atol=REC_F32_TOL)
    _phase("decode", f"{cfg3.name}, one pattern repeat "
           f"({', '.join(cfg3.pattern)}) at the full widths in f32: forward, "
           f"prefill {B1} x {T1} tokens and {n1} decode steps, the card vs "
           f"the CPU: logits max abs err {lerr:.3g}, caches (the RG-LRU's "
           f"f32 h and conv, the local k / v) {cerr:.3g} (tol "
           f"{REC_F32_TOL}); {secs[device]:.1f} s on the card, "
           f"{secs['cpu']:.1f} s on the CPU")
    del p3, res
    torch.cuda.empty_cache()
    return counts


def _peak_step_bytes(params, loss) -> int:
    """Device bytes above what is allocated before it that one step of
    `loss(params tree)` and its gradients peak at."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tree, leaves = grad_leaves(params)
    grads = torch.autograd.grad(loss(tree), leaves)
    torch.cuda.synchronize()
    del grads
    return torch.cuda.max_memory_allocated() - base


def seq_gas_phase(device):
    """Phase 9c. seq-GAS on qwen3-0.6b at its published widths: in f32
    the chunked forward against the full one (causal chunking is exact);
    in bf16 SEQ_STEPS AdamW steps of `chunked_loss` through the example's
    `train` (the loss must fall by 1 - SEQ_DROP), and the peak memory of
    a `chunked_loss` step beside a `loss_fn` step at the same B and T.
    TF32 stays off (`resolve_device`)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(SEQ_ARCH, "full")
    B, T, C = SEQ_F32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = TF.init_params(cfg32, seed=SEED, device=device)
    src = MarkovTokens(cfg.vocab_size, effective=32, concentration=0.08,
                       seed=SEED)
    toks = torch.from_numpy(src.sample(B, T)[:, :T]).to(device)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full, _ = TF.forward(p32, cfg32, {"tokens": toks})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        chunked, hist = SEQ.forward_chunked(p32, cfg32, {"tokens": toks}, C)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    err, top = float((chunked - full).abs().max()), float(full.abs().max())
    assert err <= SEQ_F32_TOL, (err, SEQ_F32_TOL)
    assert len(hist) == cfg.num_layers and hist[0]["k"].shape[1] == T
    _phase("seq-gas", f"{cfg.name} at its published widths in f32, {B} x "
           f"{T} MarkovTokens: the chunked forward ({T // C} chunks of {C}, "
           f"{(t2 - t1) * 1e3:.1f} ms) vs the full one "
           f"({(t1 - t0) * 1e3:.1f} ms): max abs err {err:.3g} (max "
           f"|logit| {top:.3g}, tol {SEQ_F32_TOL}); every layer's "
           f"{T}-position K/V history pushed")
    del p32, full, chunked, hist
    torch.cuda.empty_cache()

    B, T, C = SEQ_BF16
    t0 = time.perf_counter()
    params = TF.init_params(cfg, seed=SEED, device=device)
    b = next(MarkovTokens(cfg.vocab_size, effective=32, concentration=0.08,
                          seed=SEED + 1).batches(B, T))
    batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    peak_chunked = _peak_step_bytes(
        params, lambda p: SEQ.chunked_loss(p, cfg, batch, C)[0])
    peak_full = _peak_step_bytes(params,
                                 lambda p: TF.loss_fn(p, cfg, batch)[0])
    t1 = time.perf_counter()
    losses, ms, _ = EXSEQ.train(cfg, params, batch=B, seq_len=T, chunk=C,
                                steps=SEQ_STEPS, lr=SEQ_LR, seed=SEED,
                                log_every=0)

    def one_step():
        tree, leaves = grad_leaves(params)
        torch.autograd.grad(SEQ.chunked_loss(tree, cfg, batch, C)[0],
                            leaves)

    t2 = time.perf_counter()
    prof = _profiled_ms(one_step)
    t3 = time.perf_counter()
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < SEQ_DROP * losses[0], (losses[0], losses[-1])
    _phase("seq-gas", f"{cfg.name} in bf16, {B} x {T} tokens ({T // C} "
           f"chunks of {C}), {SEQ_STEPS} AdamW steps at lr {SEQ_LR}: loss "
           f"{losses[0]:.4f} -> " + ", ".join(
               f"{x:.4f}" for x in losses[4::5])
           + f" (below {SEQ_DROP} x the first); step p50 "
           f"{np.percentile(ms, 50):.1f} ms, p99 {np.percentile(ms, 99):.1f} "
           f"ms, {B * T / (np.percentile(ms, 50) / 1e3):,.0f} tokens/s; "
           f"peak memory above the params of a chunked_loss step "
           f"{peak_chunked / 2**30:.2f} GiB, of a loss_fn step "
           f"{peak_full / 2**30:.2f} GiB; one chunked_loss step and its "
           f"gradients profiled: {prof}; seconds: init and the two peak "
           f"steps {t1 - t0:.1f}, the {SEQ_STEPS} steps with their batches "
           f"{t2 - t1:.1f}, the profiled step {t3 - t2:.1f}")
    del params
    torch.cuda.empty_cache()


@torch.no_grad()
def audio_phase(device):
    """Phase 9d. hubert-xlarge at its published widths in f32: num_layers
    + 1 bidirectional seq-GAS passes from frozen seeded weights, each
    reading the last pass's history for future chunks; the error against
    the full forward every AUDIO_EVERY passes, the first above AUDIO_TOL,
    the last below."""
    cfg = dataclasses.replace(get_config(AUDIO_ARCH, "full"),
                              dtype="float32")
    params = TF.init_params(cfg, seed=SEED, device=device)
    B, T, C = AUDIO_SHAPE
    gen = torch.Generator(device=device).manual_seed(SEED)
    batch = {"frames": torch.randn((B, T, cfg.d_model), generator=gen,
                                   device=device)}
    full, _ = TF.forward(params, cfg, batch)
    hist, errs = None, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cfg.num_layers + 1):
        logits, hist = SEQ.forward_chunked(params, cfg, batch, C,
                                           history=hist, bidirectional=True)
        errs.append(float((logits - full).abs().max()))
    torch.cuda.synchronize()
    pass_ms = (time.perf_counter() - t0) * 1e3 / len(errs)
    assert errs[0] > AUDIO_TOL and errs[-1] < AUDIO_TOL, errs
    shown = [(i + 1, e) for i, e in enumerate(errs)
             if i % AUDIO_EVERY == 0 or i == len(errs) - 1]
    _phase("seq-gas", f"{cfg.name} at its published widths in f32 "
           f"({cfg.num_layers} layers, d_model {cfg.d_model}, head_dim "
           f"{cfg.head_dim_}), {B} x {T} frames in chunks of {C}: "
           f"{len(errs)} bidirectional passes ({pass_ms:.1f} ms each), max "
           f"abs err vs the full forward (max |logit| "
           f"{float(full.abs().max()):.3g}) by pass: "
           + ", ".join(f"{i}: {e:.3g}" for i, e in shown)
           + f" (the first above {AUDIO_TOL}, the last below)")
    del params, full, hist, logits
    torch.cuda.empty_cache()


@torch.no_grad()
def mixer_layers_phase(device):
    """Phase 9e. The moe and cross layers at SMOKE widths under the
    tests' overrides (no published config has them), f32: forward,
    prefill and MIXER_STEPS decode steps on the card against the CPU.
    Returns each decode loop's launch counts."""
    launches = {}
    for label, arch, over in MIXER_CASES:
        cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32",
                                  **over)
        params = _open_gates(TF.init_params(cfg, seed=SEED, device=device))
        toks = torch.from_numpy(MarkovTokens(cfg.vocab_size, seed=SEED)
                                .sample(2, MIXER_T + MIXER_STEPS)
                                [:, :MIXER_T + MIXER_STEPS])
        extra = {}
        if "cross" in cfg.layer_types():
            extra["image_embeds"] = torch.randn(
                (2, cfg.num_image_tokens, cfg.d_model),
                generator=torch.Generator().manual_seed(SEED))
        res, n_fd, _ = _card_vs_cpu(params, cfg, toks, MIXER_STEPS, extra,
                                    cache_len=MIXER_T + MIXER_STEPS)
        n_attn = sum(lt != "rec" for lt in cfg.layer_types())
        assert n_fd == MIXER_STEPS * n_attn, (label, n_fd)
        for a, b in zip(res[device][0] + res[device][1],
                        res["cpu"][0] + res["cpu"][1]):
            torch.testing.assert_close(a, b, rtol=MIXER_TOL, atol=MIXER_TOL)
        launches[f"{label} decode"] = {"flash_decode": n_fd}
        _phase("layers", f"{label} ({', '.join(f'{k}={v}' for k, v in over.items())}) "
               f"at {arch}'s SMOKE widths in f32: forward, prefill 2 x "
               f"{MIXER_T} tokens and {MIXER_STEPS} decode steps, the card vs "
               f"the CPU: logits max abs err "
               f"{_max_err(res[device][0], res['cpu'][0]):.3g}, caches "
               f"{_max_err(res[device][1], res['cpu'][1]):.3g} (tol "
               f"{MIXER_TOL}); flash_decode launches {n_fd}")
    return launches


def _op_spec(op):
    return model.GNNSpec(op=op, d_in=N_FEATURES, num_classes=N_CLASSES,
                         num_layers=N_LAYERS, **OP_SERVE[op])


def _f64_forward(params, spec, g, dst, src, w) -> np.ndarray:
    """`full_forward` of `params` on graph `g` (COO dst, src, w) in
    float64 on the CPU: the yardstick of phase 3c's SLO=0 answers."""
    p64 = tree_map(lambda t: t.detach().cpu().double(), params)
    return model.full_forward(
        p64, spec, torch.from_numpy(g.x).double(),
        (torch.from_numpy(dst), torch.from_numpy(src)),
        torch.from_numpy(w).double(), g.num_nodes).numpy()


def operator_serving_phase(g, device):
    """Phase 3c: GAT, PNA and GIN served at their published widths on the
    PubMed-shaped graph (3 layers, seeded weights, zero stores). Over f32
    stores 16 x 128 queries at SLO=0 against `full_forward` in float64 on
    the CPU (and so is the f32 `full_forward` on the card), then the same
    at SLO=None against the SLO=0 answers, a warm repeat
    bit-identical; over int8 stores (GAT, PNA) OP_SERVE_Q_REQUESTS
    requests of OP_SERVE_Q_SIZE queries at SLO=0 against the port's CPU
    `serve_request`. Each run's
    kernels must launch and no backward kernel may. Returns the launch
    counts of each run."""
    N = g.num_nodes
    rng = np.random.default_rng(SEED + 1)
    queries = [rng.choice(N, size=QUERY_SIZE, replace=False)
               for _ in range(N_REQUESTS)]
    dst, src, w = G.gcn_edge_weights(g)
    coo = (torch.from_numpy(dst).to(device), torch.from_numpy(src).to(device))
    ew = torch.from_numpy(w).to(device)
    launches = {}
    for op in OP_SERVE:
        spec = _op_spec(op)
        params = model.init_gnn(spec, seed=SEED, device=device)

        def fresh_state(plan, hd="f32", p=params):
            store = HistoryStore.create(N + 1, spec.hist_dims(), hd,
                                        plan.device)
            return S.init_serve_state(plan, S.ServeState(p, store))

        plan0 = S.build_serve_plan(g, spec, S.ServeConfig(staleness_slo=0),
                                   device=device)
        plan_none = dataclasses.replace(
            plan0, config=S.ServeConfig(staleness_slo=None))
        # warm-up on a throwaway store (the op's first launches)
        S.serve_request(plan0, fresh_state(plan0), queries[0])
        state = fresh_state(plan0)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        runs = {}
        for slo, plan in ((0, plan0), (None, plan_none)):
            lat, logits, state, host_ms, refreshed = _serve_stream(
                plan, state, queries, slo)
            runs[slo] = (lat, logits, host_ms, refreshed)
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        launches[f"{op} f32 serving"] = counts
        missing = [k for k in OP_SERVE_KERNELS[op] if counts[k] == 0]
        assert not missing, f"{op} serving never launched {missing}"
        backward = {k: counts[k] for k in BACKWARD_KERNELS if counts[k]}
        assert not backward, f"{op} serving launched backward kernels " \
                             f"{backward}"
        # SLO=0 and the f32 full forward on the card, each held to the
        # same forward in float64 on the CPU: the two f32 answers sum in
        # other orders, and where a logit cancels (GIN's, |x| ~ 0.2 out of
        # terms ~ 100) they can sit more than RTOL/ATOL apart though each
        # is within it of the exact value
        exact = model.full_forward(params, spec, plan0.x, coo, ew,
                                   N).cpu().numpy()
        truth = _f64_forward(params, spec, g, dst, src, w)
        served = np.concatenate(runs[0][1])
        rows = np.concatenate(queries)
        for name, got in (("SLO=0", served), ("the f32 full forward",
                                              exact[rows])):
            np.testing.assert_allclose(got, truth[rows], rtol=RTOL,
                                       atol=ATOL, err_msg=name)
        err0 = float(np.abs(served - truth[rows]).max())
        err_f32 = float(np.abs(exact[rows] - truth[rows]).max())
        apart = np.abs(served - exact[rows])
        n_apart = int((apart > ATOL + RTOL * np.abs(exact[rows])).sum())
        err_none = max(float(np.abs(a - b).max())
                       for a, b in zip(runs[None][1], runs[0][1]))
        for a, b in zip(runs[None][1], runs[0][1]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        rep1 = S.serve_request(plan_none, state, queries[0])[0]
        rep2 = S.serve_request(plan_none, state, queries[0])[0]
        assert np.array_equal(rep1, rep2), f"{op} warm-cache repeat differs"
        for slo, (lat, _, host_ms, refreshed) in runs.items():
            _phase("serving", f"{op} f32 slo={slo}: {N_REQUESTS} x "
                   f"{QUERY_SIZE} queries, {_p50_p99(lat)}, total "
                   f"{sum(lat):.1f} ms of which host batch build "
                   f"{host_ms:.1f} ms; refreshed rows {sum(refreshed)}")
        _phase("serving", f"{op} f32 ({spec.d_hidden} wide"
               + (f", {spec.heads} heads" if op == "gat" else "")
               + f"): SLO=0 vs the float64 full forward on the CPU max abs "
               f"err {err0:.3g}, the f32 full forward on the card vs it "
               f"{err_f32:.3g}; SLO=0 vs the f32 forward {apart.max():.3g} "
               f"({n_apart} of {apart.size} logits outside RTOL/ATOL of "
               f"each other); "
               f"SLO=None vs SLO=0 {err_none:.3g}; repeat bit-identical; "
               f"no backward kernel; launches "
               + str({k: v for k, v in counts.items() if v}))
        del state, runs, exact
        if op not in OP_SERVE_Q:
            continue
        # int8: the card against the port's CPU serve_request, same store
        # and queries
        cfg = S.ServeConfig(staleness_slo=0, history_dtype="int8")
        plan8 = S.build_serve_plan(g, spec, cfg, device=device)
        cplan = S.build_serve_plan(g, spec, cfg, device="cpu")
        state = fresh_state(plan8, "int8")
        cstate = fresh_state(cplan, "int8", model.to_device(params, "cpu"))
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        lat, errs, cpu_s = [], [], 0.0
        for q in queries[:OP_SERVE_Q_REQUESTS]:
            q = q[:OP_SERVE_Q_SIZE]
            t0 = time.perf_counter()
            lg, state, d = S.serve_request(plan8, state, q)
            lat.append((time.perf_counter() - t0) * 1e3)
            assert d["halo_age_max"] == 0 and d["hist_quant_err"] > 0, d
            t0 = time.perf_counter()
            clg, cstate, _ = S.serve_request(cplan, cstate, q)
            cpu_s += time.perf_counter() - t0
            np.testing.assert_allclose(lg, clg, rtol=SERVE_Q_TOL["int8"],
                                       atol=ATOL)
            errs.append(float(np.abs(lg - clg).max()))
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        launches[f"{op} int8 serving"] = counts
        want = OP_SERVE_KERNELS[op] + ("gather_rows_dq", "scatter_rows_q")
        missing = [k for k in want if k not in ("scatter_rows",)
                   and counts[k] == 0]
        assert not missing, f"{op} int8 serving never launched {missing}"
        assert not any(counts[k] for k in BACKWARD_KERNELS), counts
        tabs = _quantized_tables_close(state.histories, cstate.histories,
                                       1 + 127 * RTOL)
        _phase("serving", f"{op} int8 slo=0: {len(lat)} x {OP_SERVE_Q_SIZE} "
               f"queries, {_p50_p99(lat)}; vs the CPU's serve_request on "
               f"the same store and queries max abs err {max(errs):.3g} "
               f"(the CPU took {cpu_s:.1f} s); the stores within "
               f"{tabs[0]:.3g} quantization steps, {100 * tabs[1]:.3f}% of "
               f"the entries equal; launches "
               + str({k: v for k, v in counts.items() if v}))
        del state, cstate, cplan
    return launches


def _start_backend_process():
    """The launcher's `--role backend --smoke` in a child process on the
    card (it trains, then listens on an ephemeral port): (the process, the
    port file). Started before phase 3c so that its start-up overlaps."""
    port_file = ROOT / "build" / f"serve-port-{os.getpid()}"
    port_file.parent.mkdir(parents=True, exist_ok=True)
    port_file.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_gas",
         *SPLIT_LAUNCHER_ARGS, "--role", "backend", "--port", "0",
         "--port-file", str(port_file)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, port_file


def _stop(proc) -> str:
    """End a child process (SIGTERM, then SIGKILL) and return its output."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.stdout.read() if proc.stdout else ""


def split_serving_phase(g, spec, device, backend_proc, port_file):
    """Phase 3d: GCN at PubMed shape through the split, f32 (the backend's
    store on the card) and int8 (the backend's store in pinned host
    memory): a `ServeFrontend` over `InProcTransport` to a `HistoryBackend`
    on the card, 16 x 128 queries at SLO=0, every answer bitwise the
    in-process `serve_request` from the same state, and the tables after
    it; then GCN served in process from a host store, bitwise the device
    store; then the launcher's two processes (the backend started before
    phase 3c), the frontend's smoke under a timeout. Returns the launch
    counts of each split run."""
    N = g.num_nodes
    rng = np.random.default_rng(SEED + 2)
    queries = [rng.choice(N, size=QUERY_SIZE, replace=False)
               for _ in range(N_REQUESTS)]
    params = model.init_gnn(spec, seed=SEED, device=device)
    cfg = S.ServeConfig(staleness_slo=0)
    launches = {}
    inproc_f32 = None
    for hd, storage in (("f32", "device"), ("int8", "host")):
        def fresh(plan, where="device"):
            store = HistoryStore.create(N + 1, spec.hist_dims(), hd, device,
                                        storage=where)
            return S.init_serve_state(plan, S.ServeState(params, store))

        plan_in = S.build_serve_plan(g, spec, cfg, device=device)
        state_in = fresh(plan_in)
        plan_be = S.build_serve_plan(g, spec, cfg, device=device)
        backend = SS.HistoryBackend(plan_be, fresh(plan_be, storage))
        front = SS.ServeFrontend(g, spec, cfg, SS.InProcTransport(backend),
                                 device=device)
        # one warm-up request each (the same one: the states stay alike)
        _, state_in, _ = S.serve_request(plan_in, state_in, queries[0])
        front.serve_request(queries[0])
        lat_in, want, state_in, _, _ = _serve_stream(plan_in, state_in,
                                                     queries, 0)
        if hd == "f32":
            inproc_f32 = want
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        lat, retries = [], 0.0
        for q, w in zip(queries, want):
            t0 = time.perf_counter()
            got, d = front.serve_request(q)
            lat.append((time.perf_counter() - t0) * 1e3)
            assert np.array_equal(got, w), \
                f"split serving {hd} differs from in-process serving"
            retries += d["num_retries"]
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        launches[f"split serving gcn {hd}"] = counts
        assert counts["scatter_rows_raw"] and counts["gather_rows_raw"], \
            counts
        a, b = state_in.histories, backend.state.histories.sync()
        for x, y in zip(a.tables + (a.scales or []) + [a.age],
                        b.tables + (b.scales or []) + [b.age]):
            assert torch.equal(x[:N].cpu(), y[:N].cpu()), \
                f"split serving {hd}: the backend's store differs"
        if storage == "host":
            assert all(t.is_pinned() for t in b.tables + (b.scales or []))
        _phase("serving", f"split gcn {hd} (backend store on the "
               f"{'card' if storage == 'device' else 'host, pinned'}): "
               f"{N_REQUESTS} x {QUERY_SIZE} queries at SLO=0 bitwise the "
               f"in-process serve_request, the store too; split "
               f"{_p50_p99(lat)} beside in-process {_p50_p99(lat_in)}; "
               f"retries {retries:.0f}; launches "
               + str({k: v for k, v in counts.items() if v}))
        del backend, front, state_in
    # in process from a host store: bitwise the device store's answers
    plan_h = S.build_serve_plan(g, spec, cfg, device=device)
    store = HistoryStore.create(N + 1, spec.hist_dims(), "f32", device,
                                storage="host")
    state_h = S.init_serve_state(plan_h, S.ServeState(params, store))
    _, state_h, _ = S.serve_request(plan_h, state_h, queries[0])
    lat_h, got, state_h, _, _ = _serve_stream(plan_h, state_h, queries, 0)
    assert all(np.array_equal(a, b) for a, b in zip(got, inproc_f32)), \
        "serving from a host store differs from the device store"
    _phase("serving", f"gcn f32 in process from a host store (pinned): "
           f"bitwise the device store's {N_REQUESTS} answers; "
           f"{_p50_p99(lat_h)}")
    del state_h
    # the launcher's two processes
    deadline = time.time() + SPLIT_LAUNCHER_TIMEOUT
    while not (port_file.exists() and port_file.read_text().strip()):
        if backend_proc.poll() is not None or time.time() > deadline:
            raise AssertionError("the backend process never listened:\n"
                                 + _stop(backend_proc))
        time.sleep(0.2)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_gas",
         *SPLIT_LAUNCHER_ARGS, "--role", "frontend", "--port",
         port_file.read_text().strip()], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=SPLIT_LAUNCHER_TIMEOUT)
    front_s = time.perf_counter() - t0
    back_out = _stop(backend_proc)
    port_file.unlink(missing_ok=True)
    assert out.returncode == 0 and "smoke OK" in out.stdout, \
        out.stdout + out.stderr + back_out
    served = [ln for ln in out.stdout.splitlines() if ln.startswith("served")]
    _phase("serving", f"two processes ({' '.join(SPLIT_LAUNCHER_ARGS)}): "
           f"the frontend's smoke OK in {front_s:.1f} s; "
           + "; ".join(served))
    return launches


# ---------------------------------------------------------------------------
# Phase 7: evolving graphs
# ---------------------------------------------------------------------------

def _dyn_config(hd="f32", storage="device", depth=0):
    """Phase 7's dynamic configuration: the bench's GASConfig over store
    `hd` placed as `storage`, pipelined `depth` deep, always taking the
    incremental path (`cold_rebuild_frac` above 1)."""
    return DY.DynamicGASConfig(base=RT.GASConfig(
        num_parts=DYN_PARTS, epochs=DYN_EPOCHS, seed=0, history_dtype=hd,
        history_storage=storage, prefetch_depth=depth),
        cold_rebuild_frac=1.01)


def _dyn_partition():
    """Phase 7's METIS partition and the seconds it took: host work, run
    in a worker process while the card runs the first phases."""
    t0 = time.perf_counter()
    g = citation_graph(**DYN_GRAPH)
    return RT.partition(g, _dyn_config().base), time.perf_counter() - t0


def _dyn_spec(op):
    """A 3-layer operator 64 wide over phase 7's graph (GAT: 8 heads of
    8)."""
    return model.GNNSpec(op=op, d_in=DYN_GRAPH["num_features"],
                         d_hidden=64, num_classes=DYN_GRAPH["num_classes"],
                         num_layers=3, heads=8)


def _dyn_delta(g, churn):
    """dyn_bench's delta at `churn` on `g`: 2 new nodes, churn / 2 of the
    features drifted."""
    return DL.random_delta(g, edge_churn=churn, nodes_add=2,
                           feat_frac=churn / 2, seed=int(churn * 1e4))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of `t`'s bits (floats viewed as integers of their
    width), for bitwise comparisons."""
    t = t.detach().cpu().contiguous()
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return (t.view(view[t.dtype]) if t.dtype in view else t).clone()


_INDEX_FIELDS = ("batch_nodes", "batch_mask", "halo_nodes", "halo_mask",
                 "edge_dst", "edge_src", "edge_w")


def _dyn_families(plan):
    return (("unit", "unit_transposed") if plan.unit_blocks
            else ("forward", "transposed"))


def _dyn_digest(plan, state) -> str:
    """One digest over a plan's graph, partition, host batches (index rows
    and blocks), device stack (index rows) and device arrays, and over
    every tensor of its state (params, moments, tables, scales, codebooks,
    statistics, clock)."""
    h = hashlib.sha256()
    b = plan.batches
    arrays = [plan.part, plan.graph.indptr, plan.graph.indices,
              plan.graph.x] + [getattr(b, f) for f in _INDEX_FIELDS]
    for fam in _dyn_families(plan):
        arrays += [getattr(b, fam).vals, getattr(b, fam).cols]
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    tensors = [getattr(plan.batch_stack, f) for f in _INDEX_FIELDS] + [
        plan.x, plan.y, plan.train_mask, plan.eval_w] + _state_leaves(state)
    for t in tensors:
        h.update(_bits(t).numpy().tobytes())
    return h.hexdigest()[:12]


def _dyn_checks(label, plan, state, plan2, state2, d):
    """Phase 7's checks of one incremental advance (on the card): the
    patched batches bitwise a from-scratch `build_batches` at the same
    pads (both block families, host and device), rows outside the
    delta's out-closure bitwise the grown old store (tables, scales,
    ages), rows inside bitwise an independent re-push of the closure
    through `gas_batch_forward(fuse_halo=False)` on the grown store,
    their ages 0, and `grow` keeping a vq store's codebooks and
    statistics. Returns the closure's size."""
    b = plan2.batches
    ref = G.build_batches(plan2.graph, plan2.part, pad_to=plan2._pad_to,
                          build_blocks=True, unit_weights=plan2.unit_blocks,
                          pad_k=plan2._pad_k, pad_k_t=plan2._pad_k_t)
    pairs = [(f, getattr(b, f), getattr(ref, f),
              getattr(plan2.batch_stack, f)) for f in _INDEX_FIELDS]
    for fam in _dyn_families(plan2):
        for a in ("vals", "cols"):
            pairs.append((f"{fam}.{a}", getattr(getattr(b, fam), a),
                          getattr(getattr(ref, fam), a),
                          getattr(getattr(plan2.batch_stack, fam), a)))
    for name, got, want, on_card in pairs:
        assert np.array_equal(got, want), f"{label}: patched {name}"
        assert torch.equal(_bits(on_card), _bits(torch.from_numpy(
            np.ascontiguousarray(want)))), f"{label}: the card's {name}"
    n_old, n_new = plan.graph.num_nodes, d.num_new_nodes
    N2 = plan2.graph.num_nodes
    closure = DL.out_closure(plan2.graph, d.invalidation_seeds(n_old),
                             plan.spec.num_layers - 1)
    outside = np.setdiff1d(np.arange(N2), closure)
    h = state.histories
    grown = h.grow(n_new) if n_new else h.clone()
    ref_store = h.grow(n_new) if n_new else h.clone()
    indptr, src, w = G.weighted_in_csr(plan2.graph)
    batch = G.subgraph_batch(indptr, src, w, N2, closure, build_blocks=True,
                             transposed=False,
                             unit_weights=plan2.unit_blocks).to(plan2.device)
    with torch.no_grad():
        model.gas_batch_forward(state.params, plan.spec, plan2.x, batch,
                                ref_store, use_history=True, fuse_halo=False)
    new, grown, ref_store = (x.sync() for x in (state2.histories, grown,
                                                ref_store))
    for kind in ("tables", "scales"):
        for ell, t in enumerate(getattr(new, kind) or ()):
            got = _bits(t)
            where = f"{label}: {kind} {ell}"
            assert torch.equal(got[outside], _bits(getattr(
                grown, kind)[ell])[outside]), f"{where} outside the closure"
            assert torch.equal(got[closure], _bits(getattr(
                ref_store, kind)[ell])[closure]), f"{where} inside the closure"
    age = new.age.cpu()
    assert bool((age[closure] == 0).all()), f"{label}: closure ages"
    assert torch.equal(age[outside], grown.age.cpu()[outside]), \
        f"{label}: ages outside"
    for kind in ("codebooks", "cb_counts", "cb_sums"):
        for a, o in zip(getattr(grown, kind) or (), getattr(h, kind) or ()):
            assert torch.equal(_bits(a), _bits(o)), f"{label}: grow {kind}"
    return len(closure)


def _dyn_launches(label, op, hd, counts):
    """The re-push's kernels launched in one advance, and no fused
    aggregation and no backward kernel."""
    pull, push = DYN_PULL_PUSH[hd]
    for name in (DYN_AGG[op], "gather_rows", pull, push):
        assert counts[name] > 0, f"{label}: {name} never launched {counts}"
    stray = {k: v for k, v in counts.items()
             if v and ("_bwd" in k or k.startswith("gather_spmm"))}
    assert not stray, f"{label}: launched {stray} in the re-push"
    return {k: v for k, v in counts.items() if v}


def _dyn_split(info) -> str:
    return (f"partition {info.partition_s * 1e3:.1f} / batches "
            f"{info.batches_s * 1e3:.1f} / re-push "
            f"{info.repush_s * 1e3:.1f} ms")


def _dyn_advance(plan, state, d, dcfg):
    """One advance with the launch counts it made."""
    _build.reset_launch_counts()
    out = DY.advance(plan, state, d, dcfg)
    return out, dict(_build.launch_counts)


def dynamic_bench_phase(device, part, part_s):
    """Phase 7a: dyn_bench's configuration on the card. Returns its launch
    counts by run."""
    launches = {}
    g = citation_graph(**DYN_GRAPH)
    dcfg = _dyn_config()
    t0 = time.perf_counter()
    plan = DY.build_dynamic_plan(g, _dyn_spec("gcn"), dcfg, device=device,
                                 part=part)
    state, _ = RT.fit(plan, RT.init_state(plan), epochs=DYN_EPOCHS)
    torch.cuda.synchronize()
    fam, fam_t = (getattr(plan.batches, f) for f in _dyn_families(plan))
    _phase("setup", f"dynamic: {g.num_nodes} nodes, {g.num_edges} edges, "
           f"{g.x.shape[1]} features; {DYN_PARTS} parts, pads "
           f"{plan._pad_to}, blocks {list(fam.vals.shape)} and transposed "
           f"{list(fam_t.vals.shape)}; the plan and {DYN_EPOCHS} epochs in "
           f"{time.perf_counter() - t0:.1f} s (the partition in "
           f"{part_s:.1f} s in a worker process); partition "
           f"{_digest(part)}, {_degree_orders(g, DYN_PARTS)}")
    before = _dyn_digest(plan, state)
    kept = None
    for churn in DYN_CHURNS:
        d = _dyn_delta(g, churn)
        DY.advance(plan, state, d, dcfg)          # untimed
        best = None
        for _ in range(DYN_PASSES):
            out, counts = _dyn_advance(plan, state, d, dcfg)
            if best is None or out[2].total_s < best[0][2].total_s:
                best = (out, counts)
        (plan2, state2, info), counts = best
        label = f"dyn_bench churn {churn:g}"
        assert not info.cold, f"{label}: {info.reason}"
        n_closure = _dyn_checks(label, plan, state, plan2, state2, d)
        assert n_closure == info.closure_size
        launches[f"dynamic {churn:g}"] = counts
        kinds = _dyn_launches(label, "gcn", "f32", counts)
        assert _dyn_digest(plan, state) == before, \
            f"{label}: the old plan or state changed"
        _phase("dynamic", f"{label}: incremental advance "
               f"{info.total_s * 1e3:.1f} ms (best of {DYN_PASSES} after an "
               f"untimed pass: {_dyn_split(info)}), closure "
               f"{info.closure_size} nodes ({info.closure_frac:.3f}), "
               f"rebuilt {info.rebuilt_parts} of {DYN_PARTS} parts, moved "
               f"{info.reassigned} nodes, +{info.num_new_nodes} nodes; "
               f"launches {kinds}; patched batches bitwise a from-scratch "
               f"build (host and card, both block families), outside the "
               f"closure bitwise the grown store, inside bitwise an "
               f"independent re-push, closure ages 0, old plan and state "
               f"unchanged (digest {before})")
        if churn == DYN_COLD_CHURN:
            kept, inc_ms = (plan2, state2), info.total_s * 1e3
            (_, cstate, cinfo), ccounts = _dyn_advance(
                plan, state, d, dataclasses.replace(dcfg,
                                                    cold_rebuild_frac=-1.0))
            assert cinfo.cold and cinfo.rebuilt_parts == DYN_PARTS
            ch = cstate.histories
            assert bool((ch.age[:-1] == 0).all()) and all(
                bool(torch.isfinite(t).all()) for t in ch.tables)
            launches["dynamic cold"] = ccounts
            ratio = inc_ms / (cinfo.total_s * 1e3)
            _phase("dynamic", f"{label}: cold rebuild "
                   f"{cinfo.total_s * 1e3:.1f} ms ({_dyn_split(cinfo)}; "
                   f"{cinfo.reason}), every age 0; incremental/cold "
                   f"{ratio:.3f} (the reference bench's contract <= "
                   f"{DYN_REF_RATIO:.2f}, recorded, not asserted)")
            del cstate, ch
        del plan2, state2
    plan2, state2 = kept
    steps = []
    with _timed_calls(RT, "train_step", steps):
        state2, m = RT.train_epoch(plan2, state2, 0)
    assert np.isfinite(m["loss"]), m
    _phase("dynamic", f"one epoch on the plan advanced at "
           f"{DYN_COLD_CHURN:g} churn ({plan2.graph.num_nodes} nodes, "
           f"{len(steps)} steps): loss {m['loss']:.4f}, step "
           f"{_p50_p99(steps)}")
    return launches


def _dyn_run(g, part, device, op, hd, storage="device", depth=0, epochs=1):
    """Phase 7b/7c's run: a dynamic plan of `op` over store `hd`, `epochs`
    epochs, then one incremental advance at 1% churn. Returns (plan,
    state, advanced plan, advanced state, info, delta, launch counts,
    digest of the old plan and state before the advance, loss)."""
    dcfg = _dyn_config(hd, storage, depth)
    plan = DY.build_dynamic_plan(g, _dyn_spec(op), dcfg, device=device,
                                 part=part)
    state, m = RT.fit(plan, RT.init_state(plan), epochs=epochs)
    d = _dyn_delta(g, DYN_COLD_CHURN)
    before = _dyn_digest(plan, state)
    (plan2, state2, info), counts = _dyn_advance(plan, state, d, dcfg)
    assert not info.cold, info.reason
    return (plan, state, plan2, state2, info, d, counts, before,
            m[-1]["loss"])


def dynamic_ops_phase(device, part):
    """Phase 7b: every operator's history contract through one advance.
    Returns its launch counts by run."""
    launches = {}
    g = citation_graph(**DYN_GRAPH)
    for op, hd in DYN_OP_RUNS:
        t0 = time.perf_counter()
        plan, state, plan2, state2, info, d, counts, before, loss = \
            _dyn_run(g, part, device, op, hd)
        label = f"{op} {hd}"
        _dyn_checks(label, plan, state, plan2, state2, d)
        kinds = _dyn_launches(label, op, hd, counts)
        assert _dyn_digest(plan, state) == before, \
            f"{label}: the old plan or state changed"
        launches[f"dynamic {label}"] = counts
        _phase("dynamic", f"{label}: 1 epoch (loss {loss:.4f}), advance "
               f"{info.total_s * 1e3:.1f} ms ({_dyn_split(info)}), closure "
               f"{info.closure_frac:.3f}, rebuilt {info.rebuilt_parts} "
               f"parts; re-push launches {kinds}; batches, outside, inside"
               + (", scales" if hd != "f32" else "")
               + (", codebooks and statistics" if hd == "vq" else "")
               + f" and ages as in 7a, old unchanged; "
               f"{time.perf_counter() - t0:.1f} s")
    return launches


def dynamic_host_phase(device, part):
    """Phase 7c: GCN over f32 and int8 in pinned host memory at prefetch
    depth 1, against the device store. Returns its launch counts by
    run."""
    launches = {}
    g = citation_graph(**DYN_GRAPH)
    for hd in ("f32", "int8"):
        runs = {}
        for storage, depth in (("device", 0), ("host", 1)):
            _, _, plan2, state2, info, _, counts, _, _ = _dyn_run(
                g, part, device, "gcn", hd, storage, depth)
            h = state2.histories
            host_tables = h.tables + (h.scales or [])
            advanced = _state_leaves(state2)
            state3, m = RT.train_epoch(plan2, state2, 1)
            runs[storage] = (advanced, _state_leaves(state3), m,
                             h.placement_bytes(), counts)
            if storage == "host":
                assert all(t.device.type == "cpu" and t.is_pinned()
                           for t in host_tables), f"{hd}: not pinned"
                assert counts["gather_rows_raw"] > 0
        (a0, e0, m0, _, _), (a1, e1, m1, where, counts) = (
            runs["device"], runs["host"])
        assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a0, a1)), \
            f"{hd}: the host store's advance differs from the device's"
        assert m0 == m1 and all(torch.equal(_bits(x), _bits(y))
                                for x, y in zip(e0, e1)), \
            f"{hd}: the pipelined epoch differs from device/0's"
        launches[f"dynamic host {hd}"] = counts
        _phase("dynamic", f"gcn {hd} host/1: advance bitwise the device "
               f"store's (every table, scale and age), then one pipelined "
               f"epoch bitwise device/0 (params, moments, store, metrics); "
               f"store {where['device']:,} B on the device, "
               f"{where['host']:,} B on the host; gather_rows_raw "
               f"{counts['gather_rows_raw']} in the advance; host tables "
               f"pinned: yes")
    return launches


def dynamic_launcher_phase():
    """Phase 7d: the launcher's smoke in a child process."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_dynamic",
         "--smoke"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=DYN_LAUNCHER_TIMEOUT)
    assert out.returncode == 0 and "smoke OK" in out.stdout, \
        f"train_dynamic --smoke: rc {out.returncode}\n{out.stdout[-3000:]}" \
        f"\n{out.stderr[-3000:]}"
    last = [ln for ln in out.stdout.splitlines() if ln.startswith(
        "snapshot 2")]
    _phase("dynamic", f"python -m repro_torch.launch.train_dynamic --smoke: "
           f"smoke OK in {time.perf_counter() - t0:.1f} s; "
           f"{last[0] if last else ''}")



def _dist_partition():
    """Phase 8's METIS partition (the example's: 4 parts, seed 0) and the
    seconds it took, in a worker process."""
    t0 = time.perf_counter()
    g = citation_graph(**EX.GRAPH)
    part = P.metis_like_partition(g.indptr, g.indices, DIST_RANKS, seed=0)
    return part, time.perf_counter() - t0


def _dist_launches(label, out, names=DIST_KERNELS):
    """Every rank launched each of `names`; returns the counts summed over
    the ranks and a per-rank summary."""
    for r, o in enumerate(out):
        for name in names:
            assert o["launches"][name] > 0, \
                f"{label}: rank {r} never launched {name}: {o['launches']}"
    total = {k: sum(o["launches"][k] for o in out) for k in out[0]["launches"]}
    per = "; ".join(f"rank {r} " + ", ".join(
        f"{k} {o['launches'][k]}" for k in names) for r, o in enumerate(out))
    return total, per


def _dist_inputs(g, S):
    return (DG.permute_node_array(S, g.x),
            DG.permute_node_array(S, g.y.astype(np.int32)),
            DG.permute_node_array(S, g.train_mask))


def dist_phase(device, pool, part, part_s):
    """Phase 8 on the ranks of `pool` (a `DG.RankPool` started after the
    build, whose start overlapped the phases before), one task per run:
    8a the example's `train_rank`, 8b three exchanges and three stores'
    supersteps, 8c the six operators' supersteps. Returns (launches by
    run, the structs)."""
    g = citation_graph(**EX.GRAPH)
    spec = model.GNNSpec(**EX.SPEC)
    S = DG.build_dist_structs(g, part)
    digest = _digest(np.asarray(part, np.int32))
    _phase("setup", f"distributed GAS: {g.num_nodes} nodes, {g.num_edges} "
           f"edges, {g.x.shape[1]} features; partition {digest} "
           f"({part_s:.1f} s in a worker process), rank sizes "
           f"{S.sizes.tolist()}, rows {S.rows}, max_halo {S.max_halo}, C "
           f"{S.send_idx.shape[-1]}, max_edges {S.max_edges}")
    x, y, m = _dist_inputs(g, S)
    n = S.num_ranks * S.rows
    vals = np.random.default_rng(8).normal(
        size=(n, DIST_WIDTH)).astype(np.float32)
    q, s = (t.numpy() for t in ref.quantize_rows(torch.from_numpy(vals)))
    specs = {op: dict(EX.SPEC, op=op, heads=8, log_deg_mean=1.8)
             for op in DIST_OPS}
    params = {op: CK._flatten("", model.init_gnn(model.GNNSpec(**sp), seed=0,
                                                 device="cpu"))
              for op, sp in specs.items()}
    common = dict(x=x, y=y, m=m, adamw=None)
    t0 = time.perf_counter()
    ready = pool.ready()
    waited = time.perf_counter() - t0
    # each run's results by rank
    example = pool.run(EX.train_rank, S, spec, params["gcn"], x, y, m,
                       DIST_SUPERSTEPS, False, DIST_PROFILE_STEPS)
    stores = [pool.run(RB.exchange_rank, S, [t], [sc], [hd])
              for t, sc, hd in ((vals, None, "f32"), (vals, None, "bf16"),
                                (q, s, "int8"))]
    stores += [pool.run(RB.supersteps_rank, S, dict(
        common, spec=specs["gcn"], params=params["gcn"], history_dtype=hd,
        steps=DIST_STORE_STEPS)) for hd in ("f32", "bf16", "int8")]
    ops_out = [pool.run(RB.supersteps_rank, S, dict(
        common, spec=specs[op], params=params[op], history_dtype="f32",
        steps=DIST_CONV_STEPS)) for op in DIST_OPS]
    wall = time.perf_counter() - t0 - waited
    _phase("dist", f"world size {DIST_RANKS}, backend gloo (a file:// "
           f"rendezvous), rank devices {[o['device'] for o in example]} "
           f"({torch.cuda.get_device_name(0)}); every halo exchange and "
           f"all-reduce staged through pinned host buffers "
           f"({example[0]['stats']['staged']} stagings on rank 0 in 8a); "
           f"the ranks, started after the build, had their imports, CUDA "
           f"context and group "
           + ", ".join(f"{a:.1f}/{b:.1f}/{c:.1f}" for a, b, c in ready)
           + f" s after their spawn (this phase waited {waited:.1f} s for "
           f"them); 8a-8c in {wall:.1f} s")
    launches = _dist_example_lines(device, g, spec, digest, example)
    launches.update(_dist_stores_lines(S, vals, q, s, stores))
    launches.update(_dist_ops_lines(device, g, S, specs, params, ops_out))
    return launches, S


def _dist_example_lines(device, g, spec, digest, out):
    """Phase 8a's lines from the ranks' `train_rank` results."""
    for r, o in enumerate(out[1:], 1):
        for k, v in o["params"].items():
            assert np.array_equal(v, out[0]["params"][k]), \
                f"dist example: rank {r}'s {k} differs from rank 0's"
    acc = EX.exact_accuracy(g, spec, out[0]["params"], device)
    ref_acc = DIST_REF_ACC.get(digest)
    assert ref_acc is not None, (
        f"dist example: no reference accuracy for partition {digest}; "
        f"run tests/test_torch_dist_gas.py --reference-acc on it "
        f"(--save-partitions writes it as 'dist')")
    assert abs(acc - ref_acc) <= ACC_SLACK, ("dist example", acc, ref_acc)
    assert all(np.isfinite(o["loss"]).all() for o in out)
    assert all(o["stats"]["staged"] > 0 for o in out)
    st = out[0]["stats"]
    secs = [x * 1e3 for x in out[0]["seconds"][:-DIST_PROFILE_STEPS]]
    n = DIST_SUPERSTEPS
    wire = sum(o["stats"]["wire_bytes"] for o in out) / n
    launches, per = _dist_launches("dist example f32", out)
    _phase("dist", f"8a example f32: {n} supersteps, superstep p50/p99 "
           f"{_p50_p99(secs[1:])} (rank 0, host clock to a sync, the last "
           f"{DIST_PROFILE_STEPS} left out; the first {secs[0]:.1f} ms); "
           f"exchanges {st['exchanges'] / n:.0f} a superstep, "
           f"{st['exchange_s'] / n * 1e3:.3f} ms, all-reduces "
           f"{st['allreduce_s'] / n * 1e3:.3f} ms a superstep (rank 0, the "
           f"profiled ones in); wire {wire:.0f} B a superstep (all ranks)")
    _phase("dist", "8a the staged collectives' parts, ms a superstep by "
           "rank (host clock, the profiled ones in): " + ", ".join(
               f"{what} {[round(o['stats'][k] / n * 1e3, 3) for o in out]}"
               for what, k in (("wait for the queued kernels", "wait_s"),
                               ("copy to pinned memory", "d2h_s"),
                               ("gloo call", "gloo_s"),
                               ("copy back", "h2d_s"))))
    _phase("dist", f"8a result: final loss {out[0]['loss'][-1]:.4f}, train "
           f"acc {out[0]['acc'][-1]:.4f}; test acc {acc:.4f} (the reference's "
           f"{ref_acc:.4f} on the same partition, within {ACC_SLACK}); "
           f"params bitwise across ranks")
    _phase("dist", f"8a launches: {per}")
    profs = [o.get("profile") for o in out]
    if all(p and p["device_us"] > 0 for p in profs):
        dev_us = [p["device_us"] for p in profs]
        wall_us = max(p["wall_us"] for p in profs)
        busy = (f"device time a superstep by rank "
                f"{[round(d / DIST_PROFILE_STEPS / 1e3, 3) for d in dev_us]}"
                f" ms; the card busy {100 * sum(dev_us) / wall_us:.1f}% of "
                f"the {wall_us / 1e3:.1f} ms window (the ranks' device time "
                f"summed: their contexts time-slice the card)")
    else:
        busy = "not measured (the profiler saw no device time)"
    _phase("dist", f"8a, the last {DIST_PROFILE_STEPS} supersteps under "
           f"torch.profiler on every rank: {busy}")
    return {"dist example": launches}


def _dist_direct(S, table):
    """Each rank's halo rows gathered straight from the padded table, 0 at
    the masked slots ([P, max_halo, ...])."""
    hn = np.clip(S.batch.halo_nodes, 0, S.num_ranks * S.rows - 1)
    m = S.batch.halo_mask.reshape(S.batch.halo_mask.shape
                                  + (1,) * (table.ndim - 1))
    return np.where(m, table[hn], 0)


def _dist_stores_lines(S, vals, q, s, out):
    """Phase 8b's lines: the three exchanges (runs 0-2) bitwise a direct
    gather, then the GCN supersteps over each store (runs 3-5); `out[j]`
    is run j's results by rank."""
    launches = {}
    want = {"f32": vals, "bf16": torch.from_numpy(vals).to(
        torch.bfloat16).float().numpy(), "int8": q}
    wires = {}
    for j, hd in enumerate(("f32", "bf16", "int8")):
        got = np.stack([o["halos"][0] for o in out[j]])
        hm = S.batch.halo_mask[..., None]
        assert np.array_equal(np.where(hm, got, 0), _dist_direct(S, want[hd])), \
            f"dist exchange {hd}: the halo differs from a direct gather"
        if hd == "int8":
            scl = np.stack([o["scales"][0] for o in out[j]])
            assert np.array_equal(np.where(S.batch.halo_mask, scl, 0),
                                  _dist_direct(S, s))
        wires[hd] = sum(o["stats"]["wire_bytes"] for o in out[j])
        launches[f"dist exchange {hd}"] = _dist_launches(
            f"dist exchange {hd}", out[j])[0]
    _phase("dist", f"8b exchange of a {DIST_WIDTH}-wide table on the card: "
           f"f32, bf16 and int8 (raw codes, then the scales) halos bitwise "
           f"a direct gather of the same rows on every rank; wire bytes "
           f"per exchange (all ranks) f32 {wires['f32']}, bf16 "
           f"{wires['bf16']}, int8 {wires['int8']} (f32/int8 "
           f"{wires['f32'] / wires['int8']:.3f})")
    per_step = {}
    for k, hd in enumerate(("f32", "bf16", "int8"), start=3):
        res = out[k]
        assert all(np.isfinite(r["loss"]).all() for r in res), hd
        per_step[hd] = sum(r["stats"]["wire_bytes"] for r in res) / \
            DIST_STORE_STEPS
        names = DIST_KERNELS + (("scatter_rows_q",) if hd == "int8" else ())
        launches[f"dist gcn {hd}"], per = _dist_launches(
            f"dist gcn {hd}", res, names)
        if hd == "int8":
            assert all(t.dtype == np.int8 for r in res
                       for t in r["tables"][-1])
            q_per = per
        secs = [x for r in res for x in r["seconds"][1:]]
        _phase("dist", f"8b gcn {hd} store, {DIST_STORE_STEPS} supersteps: "
               f"loss {res[0]['loss'][-1]:.4f}, superstep "
               f"{statistics.median(secs) * 1e3:.2f} ms (median over the "
               f"ranks' later steps), wire {per_step[hd]:.0f} B a "
               f"superstep (all ranks; layer 0's f32 rows included)")
    _phase("dist", f"8b wire bytes a superstep f32/int8 "
           f"{per_step['f32'] / per_step['int8']:.3f}, f32/bf16 "
           f"{per_step['f32'] / per_step['bf16']:.3f}; int8 launches: "
           f"{q_per}")
    return launches


def _dist_ops_lines(device, g, S, specs, params, out):
    """Phase 8c's lines: each operator's supersteps from fixed params
    against the exact full-graph forward on the card (`out[k]`, operator
    k's results by rank)."""
    launches = {}
    dst, src, w = G.gcn_edge_weights(g)
    valid = S.old_of_new >= 0
    T = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    for k, op in enumerate(DIST_OPS):
        res = out[k]
        sp = model.GNNSpec(**specs[op])
        with torch.no_grad():
            exact = model.full_forward(
                CK.params_from_numpy(params[op], device=device), sp,
                T(g.x), (T(dst), T(src)), T(w), g.num_nodes).cpu().numpy()
        errs = []
        for step in range(DIST_CONV_STEPS):
            got = np.zeros_like(exact)
            got[S.old_of_new[valid]] = np.concatenate(
                [r["logits"][step] for r in res])[valid]
            errs.append(float(np.abs(got - exact).max()))
        assert errs[-1] < DIST_CONV_TOL and errs[0] > errs[-1], (op, errs)
        assert all(np.isfinite(r["loss"]).all() for r in res), op
        for r in res[1:]:
            for key, v in r["grads"][0].items():
                assert np.array_equal(v, res[0]["grads"][0][key]), (op, key)
        launches[f"dist {op}"], _ = _dist_launches(f"dist {op}", res)
        _phase("dist", f"8c {op} f32, {DIST_CONV_STEPS} supersteps from "
               f"fixed params: loss {res[0]['loss'][0]:.4f}, logits' max "
               f"error against the exact full-graph forward "
               + " -> ".join(f"{e:.2e}" for e in errs)
               + f" (< {DIST_CONV_TOL:g}); summed gradients bitwise on "
               f"every rank; superstep "
               f"{statistics.median(res[0]['seconds']) * 1e3:.2f} ms")
    return launches


def dist_kernel_rows(device, S):
    """Phase 8's kernel rows at the example's shapes: the exchange's pack
    (`gather_rows_raw`, rank 0's [P*C] send list over its [rows, 48] f32
    shard), its unpack (`scatter_rows_raw` into the [max_halo, 48] halo,
    the padded entries dropped) and the int8 store's push
    (`scatter_rows_q` over all rows), each bitwise its plain version."""
    gen = torch.Generator(device=device).manual_seed(8)
    plan = S.exchange_arrays(0, device)
    send, recv_idx = plan["send_idx"].reshape(-1), plan["recv_idx"]
    M, D = send.shape[0], DIST_WIDTH
    R = D * 4
    shard = torch.randn((S.rows, D), generator=gen, device=device)
    packed = gather_rows_raw(shard, send)
    assert torch.equal(packed, ref.gather_rows_raw_ref(shard, send))
    valid = recv_idx < S.max_halo
    n_valid = int(valid.sum())
    halo = torch.zeros((S.max_halo, D), device=device)
    want = ref.scatter_rows_raw_ref(halo.clone(), recv_idx, packed)
    assert torch.equal(scatter_rows_raw(halo.clone(), recv_idx, packed), want)
    vi, vr = recv_idx[valid].long(), packed[valid]
    src = "src/repro_torch/kernels/csrc/gather.cu"
    pack = _row("gather_rows_raw", src, "src/repro/core/dist_gas.py:199-236 "
                "(jnp.take in halo_exchange; no pallas_call)", 0.0,
                _time_ms(lambda: gather_rows_raw(shard, send)),
                _time_ms(lambda: ref.gather_rows_raw_ref(shard, send)),
                _time_ms(lambda: torch.index_select(shard, 0, send)),
                M * 4 + M * R + M * R, 0)
    pack.update(case=f"dist exchange pack, {M} rows of {R} B",
                run="dist example")
    unpack = _row("scatter_rows_raw", "src/repro_torch/kernels/csrc/"
                  "scatter.cu", "src/repro/core/dist_gas.py:199-236 "
                  "(.at[].add in halo_exchange; no pallas_call)", 0.0,
                  _time_ms(lambda: scatter_rows_raw(halo, recv_idx, packed)),
                  _time_ms(lambda: ref.scatter_rows_raw_ref(halo, recv_idx,
                                                            packed)),
                  _time_ms(lambda: halo.index_copy_(0, vi, vr)),
                  M * 4 + 2 * n_valid * R, 0,
                  library="index_copy_ of the real entries")
    unpack.update(case=f"dist exchange unpack, {M} entries ({n_valid} real) "
                       f"into {S.max_halo} halo slots", run="dist example")
    fresh = torch.randn((S.rows, D), generator=gen, device=device)
    idx = torch.arange(S.rows, dtype=torch.int32, device=device)
    qt = torch.empty((S.rows, D), dtype=torch.int8, device=device)
    st = torch.empty((S.rows,), dtype=torch.float32, device=device)
    qw, sw, _ = ref.scatter_rows_q_ref(qt.clone(), st.clone(), idx, fresh)
    q_out = scatter_rows_q(qt, st, idx, fresh)
    assert torch.equal(q_out[0], qw) and torch.equal(q_out[1], sw)
    push = _row("scatter_rows_q", "src/repro_torch/kernels/csrc/scatter.cu",
                "src/repro/kernels/scatter.py:85 scatter_rows_q (the "
                "reference's dist push runs the plain quantize_rows)", 0.0,
                _time_ms(lambda: scatter_rows_q(qt, st, idx, fresh)),
                _time_ms(lambda: ref.scatter_rows_q_ref(qt, st, idx, fresh)),
                None, S.rows * (4 + D * 4 + D + 4 + 4), 0)
    push.update(case=f"dist int8 push, {S.rows} rows of {D}",
                run="dist gcn int8")
    _phase("kernels", "dist exchange at the example's shapes: " + "; ".join(
        f"{r['name']} ({r['case']}): bitwise its plain version, "
        f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
        f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}, "
        f"bound {r['bound_ms']:.5f} by {r['bound_by']})"
        for r in (pack, unpack, push)))
    return [pack, unpack, push]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save-partitions", metavar="NPZ",
                    help="also write the training partitions here")
    ap.add_argument("--parent-csrc", metavar="DIR",
                    help="also build the kernels in DIR (another "
                         "checkout's kernels/csrc) and run its block "
                         "contraction, scatter_rows, scatter_rows_q, "
                         "scatter_rows_vq, flash_decode, edge-softmax and "
                         "PNA kernels beside this build's")
    ap.add_argument("--pna-edges", metavar="N,...",
                    help="also build the kernels with each N queued edges "
                         "loaded together by PNA's drains and time its "
                         "three kernels on each")
    ap.add_argument("--vq-ablation", action="store_true",
                    help="also build the kernels once per build switch of "
                         "scatter_rows_vq's search (each mechanism off) and "
                         "time the main path's vq pushes on every build and "
                         "at every lane split")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    # the training partitions (host work, 25-39 s) in worker processes
    # while the card builds its kernels and serves
    with concurrent.futures.ProcessPoolExecutor(
            len(PARTITIONED) + 2,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {op: pool.submit(_partition, op) for op in PARTITIONED}
        futures["dynamic"] = pool.submit(_dyn_partition)
        futures["dist"] = pool.submit(_dist_partition)

        def partitions():
            """{op: (partition, seconds)} once all are done; the workers
            then exit."""
            out = {op: f.result() for op, f in futures.items()}
            pool.shutdown()
            return out

        with contextlib.ExitStack() as stack:
            return _smoke(args, partitions, t_start, stack)


def _smoke(args, partitions, t_start, stack) -> int:
    global PARENT_LIB
    smi = _smi()
    _phase("toolchain", f"python {sys.version.split()[0]}, torch "
           f"{torch.__version__}, numpy {np.__version__}, CUDA "
           f"{torch.version.cuda}, "
           f"{torch.cuda.device_count()} device(s); nvidia-smi: {smi}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _phase("build", f"{lib_path.relative_to(ROOT)} in "
           f"{time.perf_counter() - t0:.1f} s")
    log = (lib_path.parent / "build.log").read_text().splitlines()
    for line in log:
        if "Compiling entry" in line or "registers" in line:
            print("  " + line.strip())
    if args.parent_csrc:
        t0 = time.perf_counter()
        PARENT_LIB = _build.load(_build.build(
            Path(args.parent_csrc).resolve(), ROOT / "build" / "parent"))
        if "clip_row" not in (Path(args.parent_csrc) /
                              "gather.cu").read_text():
            PARENT_LIB = _UnclippedParent(PARENT_LIB)
        _phase("build", f"the kernels of {args.parent_csrc} in "
               f"{time.perf_counter() - t0:.1f} s")
    if args.pna_edges:
        t0 = time.perf_counter()
        sizes = [int(n) for n in args.pna_edges.split(",")]
        with concurrent.futures.ThreadPoolExecutor(len(sizes)) as ex:
            built = {n: ex.submit(_build.build, _build.CSRC,
                                  ROOT / "build" / "pna-edges",
                                  (f"REPRO_PNA_EDGES={n}",))
                     for n in sizes}
            for n, fut in built.items():
                PNA_EDGE_LIBS[n] = _build.load(fut.result())
        _phase("build", f"{len(sizes)} builds with other PNA edge batches "
               f"in {time.perf_counter() - t0:.1f} s")
    if args.vq_ablation:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(VQ_ABLATION)) as ex:
            built = {name: ex.submit(_build.build, _build.CSRC,
                                     ROOT / "build" / "vq-ablation", flags)
                     for name, flags in VQ_ABLATION.items()}
            for name, fut in built.items():
                VQ_ABLATION_LIBS[name] = (VQ_ABLATION[name],
                                          _build.load(fut.result()))
        _phase("build", f"{len(VQ_ABLATION)} vq-ablation builds in "
               f"{time.perf_counter() - t0:.1f} s")

    device = resolve_device("cuda")
    # phase 8's ranks start now, so that their processes, imports, CUDA
    # contexts and rendezvous overlap the phases before it; they wait idle
    dist_pool = stack.enter_context(DG.RankPool(DIST_RANKS, "cuda"))
    spent = {}                   # wall seconds per phase, for the budget
    clock = [t_start]

    def lap(name):
        now = time.perf_counter()
        spent[name] = spent.get(name, 0.0) + now - clock[0]
        clock[0] = now

    lap("toolchain and build")
    with torch.no_grad():
        t0 = time.perf_counter()
        g = citation_graph(num_nodes=N_NODES, avg_degree=AVG_DEGREE,
                           num_features=N_FEATURES, num_classes=N_CLASSES,
                           seed=SEED)
        spec = model.GNNSpec(op="gcn", d_in=N_FEATURES, d_hidden=D_HIDDEN,
                             num_classes=N_CLASSES, num_layers=N_LAYERS)
        _phase("setup", f"graph {g.num_nodes} nodes, {g.num_edges} edges, "
               f"{N_FEATURES} features in {time.perf_counter() - t0:.1f} s")
        rows, kplan = kernel_phase(g, spec, device)
        lap("serving kernels")
        backend_proc, port_file = _start_backend_process()
        launches = {"f32 serving": serving_phase(g, spec, device, kplan)}
        del kplan
        lap("f32 serving")
        for hd in ("int8", "bf16", "vq"):
            launches[f"{hd} serving"] = serving_quant_phase(g, spec, device,
                                                            hd)
            lap(f"{hd} serving")
        try:
            launches.update(operator_serving_phase(g, device))
            lap("operator serving")
            launches.update(split_serving_phase(g, spec, device,
                                                backend_proc, port_file))
            lap("split serving")
        finally:
            _stop(backend_proc)
        rows += decode_kernel_rows(device, _clock_hz())
        lap("decode kernels")
        launches["decode"] = decode_phase(device, smi)
        lap("decode serving")
        parts = partitions()
        lap("waiting for the partitions")
        plans = train_plans(device, parts)
        lap("training plans")
        if args.save_partitions:
            Path(args.save_partitions).parent.mkdir(parents=True,
                                                    exist_ok=True)
            np.savez(args.save_partitions,
                     **{op: p.part for op, p in plans.items()},
                     dist=parts["dist"][0])
        rows += training_kernel_phase(plans, device, _clock_hz())
        lap("training kernels")
        if args.vq_ablation:
            _vq_ablation(device)
            lap("vq ablation")
    summaries = {}
    for op, hd in TRAIN_RUNS:
        launches[f"{op} {hd}"], summaries[(op, hd)] = training_phase(
            op, hd, plans[op], device)
        lap(f"{op} {hd}")
    launches["gat bf16"] = two_steps(plans["gat"], "bf16", (
        "gather_rows_bf16", "scatter_rows_bf16"))
    launches["pna vq"] = two_steps(plans["pna"], "vq",
                                   TRAIN_KERNELS[("pna", "vq")])
    launches["gcn vq refit"] = vq_refit_phase(plans["gcn"])
    lap("two-step lines and the refit")
    vq_bound_phase(device)
    lap("vq distortion bound")
    launches.update(table5_phase(device, parts["pna"][0], summaries))
    lap("table 5")
    launches.update(host_store_phase(plans, device, parts["gat"][0]))
    lap("host-store")
    launches.update(dynamic_bench_phase(device, *parts["dynamic"]))
    launches.update(dynamic_ops_phase(device, parts["dynamic"][0]))
    launches.update(dynamic_host_phase(device, parts["dynamic"][0]))
    dynamic_launcher_phase()
    lap("evolving graphs")
    dist_launches, dist_structs = dist_phase(device, dist_pool,
                                             *parts["dist"])
    launches.update(dist_launches)
    rows += dist_kernel_rows(device, dist_structs)
    lap("distributed GAS")
    rows += decode_kernel_rows(device, _clock_hz(), REC_ARCH,
                               REC_KERNEL_CASES, run="rec decode")
    lap("recurrentgemma kernels")
    launches["rec decode"] = rec_decode_phase(device, smi)
    lap("recurrentgemma decode")
    seq_gas_phase(device)
    lap("seq-GAS training")
    audio_phase(device)
    lap("hubert passes")
    launches.update(mixer_layers_phase(device))
    lap("moe and cross layers")
    _phase("time", ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    # each row's launches come from the run of the path it was timed on
    source = {"edge_softmax_fwd": "gat f32", "edge_softmax_bwd_row":
              "gat f32", "edge_softmax_bwd_col": "gat f32",
              "gather_spmm_dq": "int8 serving", "scatter_rows_q":
              "int8 serving", "gather_rows_dq": "gat int8",
              "gather_spmm_bf16": "bf16 serving", "scatter_rows_bf16":
              "bf16 serving", "gather_rows_bf16": "gat bf16",
              "gather_spmm_vq": "vq serving", "scatter_rows_vq":
              "vq serving", "gather_rows_vq": "gat vq",
              "flash_decode": "decode", **{k: "pna f32" for k in _PNA}}
    for r in rows:
        run = r.pop("run", None) or source.get(r["name"], "f32 serving")
        r["launches"] = launches[run][r["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
