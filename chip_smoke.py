#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on past):

1. build   every CUDA kernel from ``src/repro_torch/kernels/csrc`` for
           sm_90a (one nvcc per source, in parallel) and print ptxas's report;
2. kernels each kernel against its plain PyTorch version on the card, over
           the ``tests/test_kernels.py`` sweeps and the main paths' shapes
           (flash at Yi-6B's, at MLA's and at Zamba2's (4, 32, 2048, 80)
           and its training microbatch's (2, 32, 4096, 80) as head-split
           views, bf16 also against the bf16-scores plain version;
           Zamba2-7B's (2, 32, 4096, 224) and a ragged S of 1000 in bf16
           alone, forward and backward, timed beside the other pairs), with
           the reference's tolerances;
           then its time beside the plain version's, one PyTorch library
           call's (a yardstick only) and the card's bound for the same work
           (flash: also its achieved TFLOP/s, share of the bound, ratio to
           SDPA, the float32 kernel's time beside its two bounds, float32
           FFMA and 3xTF32 on the tensor cores, and float32 SDPA's, and the
           HGMMA instructions in the SASS of both libraries, neither of
           which may be 0; rwkv6_scan: also at the decode shape, 256 rows
           of one step, and at phase 13's training microbatch, 128 rows of
           4096 steps; rwkv6_scan_bwd: at that microbatch as the layer hands
           it over ((2, 64, 4096, 64) head-split views, u expanded, nonzero
           s0 and ds_fin), on tests/test_kernels.py's decays and on wide
           ones (exp(-exp(x)), x in [-6, 5): exact zeros), against the
           plain backward in float64 at SCAN_TOL, every output finite, two
           calls equal bit for bit, timed as training calls it (each
           launch's device time) beside its bound, the chunked design's own
           FLOP and byte count, the plain version and the first design's
           time (a walk back from checkpoints of the state), with
           its scratch bytes and the tensor-core MMA instructions in its
           SASS, which may not be 0; relational_matmul:
           each of the MLP step's five products timed with the schedule it takes, by events and by the
           profiler, beside torch.sparse.mm, every phase-2 case also with
           b in bf16, bit for bit the result for its float32 widening, and
           DeepSeek-V2-Lite's MoE combine, 48,000 tuples into 8000 x 2048,
           with b in float32 and in bf16, beside the bf16 -> float32 copy
           the MoE layer no longer makes, and the MoE layer's two backward
           products at phase 12's microbatch (the combine's d ys into
           61,440 slot rows, the dispatch's d x into 8192 token rows from
           bf16 rows) on the transposed relations the autograd Functions
           build; tuple_dot: a sweep of float32 and bf16 operands with
           padding tuples and the gates' gradient of the MoE combine in
           training (49,152 tuples, dOut 8192 x 2048 float32, the expert
           rows 61,440 x 2048 bf16) against the plain version in float64
           and float32, two calls equal bit for bit, timed beside
           ``torch.sparse.sampled_addmm``; moe_dispatch: the profiler's
           device events of a call on the random slot layout and on the
           bucket-sorted one the MoE layer builds, a good call after a bad
           one, and the card's rate for writing the output alone (a
           zero fill of the same bytes); fused_sigmoid_matmul:
           both layers of the main path, each also by the profiler's
           device time, two calls equal bit for bit, and no tensor-core
           instruction in its SASS; onehot_embed: the profiler's device
           events of a call, which must be one kernel and no memset or
           memcpy, and the C launcher's launch-and-wait alone;
           flash_attention_bwd: at Yi-6B's training microbatch as phase
           11 hands it over ((2, 32/4, 4096, 128) head-split views), at
           its global batch (4, 32/4, 4096, 128), at MLA's training
           microbatch as phase 12 hands it over ((2, 16, 4096, 192/128)),
           MLA's prefill shape and Zamba2's prefill and training
           microbatch ((2, 32, 4096, 80) head-split views, phase 14's),
           causal and full, float32 (F32_TOL) and bf16 (BF16_BWD_TOL: one
           bf16 ulp beyond it), against the plain backward in float64,
           two calls equal bit for bit, timed beside its bound, its
           design's operation count, the plain backward and SDPA's
           backward alone; and the forward's bf16 kernel against the
           float32-P plain version at the microbatch; the optimizer tail's
           global_norm and adamw kernels at each LM cell's largest leaf
           (DeepSeek-V2-Lite's stacked experts, Zamba2-7B's stacked
           in_proj): the norm within 1e-6 of float64's and two calls
           equal, the fused update the per-leaf PyTorch update's bits
           given its factor, both timed beside the plain passes);
3. main    the paper's pipeline at the full width of Fig. 10 (2000 rows,
           784 → 200 → 10, random weights from Listing 2's seed): one-hot
           labels, 5 training steps and inference on Engine("dense") and
           Engine("relational"), with the launch counters zeroed just before
           and read just after; the weights are held against Listing 2's
           numpy training in float64 and the engines against each other;
4. profile one training step of each engine: wall time, device time by
           kernel (torch.profiler) and the device's busy share;
5. serve   the LM serving path on the full-width Yi-6B (32 layers, d_model
           4096, weights from ``LM.init`` with a seeded generator, float32
           as the JAX package stores them): (a) ``LM.prefill`` of 4 prompts
           × 2000 tokens, one flash_attention launch per layer, counted;
           (b) the continuous-batching ``ServingEngine`` with 4 slots serving
           8 greedy requests; (c) 4 prompts of 8 tokens through
           ``prefill`` (the kernel) and through 8 ``decode_step``s (plain
           attention over the cache), in bf16 and float32 compute, for
           weight seeds 0, 1 and 2, held together; then a profile of one
           prefill and one decode step; (d) (a)'s prompts prefilled in
           float32 under the flash path, attn_impl "dense", "chunked"
           (chunks of 1000) and flash_impl="scan", and in float64: the
           flash path, "dense" and "chunked" within (c)'s float32 atol of
           float64, "scan" the flash path bit for bit, a one-ulp nudge's
           distance read beside them; flash launched 32 times under "scan"
           and never under the other two;
6. rwkv    the same serving path on the full-width RWKV-6 7B (32 layers,
           d_model 4096, 64 heads of 64, 30.1 GB of float32 weights), after
           phase 5 has freed Yi-6B's: (a) ``LM.prefill`` of 4 prompts × 2000
           tokens, one rwkv6_scan launch per layer and no other kernel;
           (b) the engine with 4 slots serving 8 greedy requests, 32
           rwkv6_scan launches per ``decode_step`` call; (c) prefill vs
           token-by-token decode (both through the kernel, so the state
           carries across calls) in bf16 and float32 compute for weight
           seeds 0, 1 and 2: end to end on the first 2 layers, then each
           of the 32 layers alone on the input the prefill path gives it
           (float32 binds in both), and end to end on all 32 as a smoke
           run beside what a one-ulp nudge of the input does there; then
           a profile of one prefill and one decode step;
7. moe     the same serving path on the full-width DeepSeek-V2-Lite (27
           layers: MLA attention, a dense first layer, then 26 layers of
           64 routed experts top-6 and 2 shared; 62.8 GB of float32
           weights) with the relational MoE (``impl="sort"``), after phase
           6 has freed RWKV-6's: (a) ``LM.prefill`` of 4 prompts × 2000
           tokens, 27 flash_attention launches (q/k of head dim 192, v of
           128) and 26 each of moe_dispatch and relational_matmul, with the
           dropped assignments of each layer; (b) the engine with 4 slots
           serving 8 greedy requests, 26 + 26 launches per ``decode_step``;
           (c) prefill vs token-by-token decode as phase 6 reads it, with
           every routing difference reported; (d) one full-width MoE layer
           on 8000 tokens, einsum against sort; and a profile of one
           prefill and one decode step;
8. hybrid  the same serving path on the full-width Zamba2-2.7B (54
           Mamba-2 layers, d_model 2560, 80 heads of 64, d_state 64, a
           shared attention + SwiGLU block of 32 heads of 80 before every 6;
           9.74 GB of float32 weights), after phase 7 has freed
           DeepSeek-V2-Lite's: (a) ``LM.prefill`` of 4 prompts × 2048
           tokens (the reference's SSD takes whole chunks of 64), 9
           flash_attention launches and no other kernel; (b) the engine
           with 4 slots serving 8 greedy requests, no kernel per
           ``decode_step``; (c) prefill vs token-by-token decode in bf16
           and float32 compute for weight seeds 0, 1 and 2: end to end on
           the shared block and 2 layers, each of the 9 shared-block uses
           and 54 layers alone (float32 binds in both), and the first
           segment (6 layers) and all 54 as smoke runs beside a one-ulp
           nudge; (d) a profile of one prefill and one decode step;
9. in-db   the paper's training inside sqlite (``:memory:``) at Fig. 10's
           widths (784 → 200 → 10, lr 0.1, Listing 2's weights) on 32 rows
           (cut for sqlite's time) for 3 iterations, after phase 8 has
           freed Zamba2's model: (a) ``nn2sql.train`` with
           ``Engine("sql")``, relational and ``dialect="array"`` (Listing
           10's recursion), Listing 7's step as INSERT … SELECT, and the
           stepped ``sgd_step_fn`` in both representations, the weights
           back as float32 on the card; (b) ``Engine("dense")`` and
           ``Engine("relational")`` on the card from the same start, every
           weight within 1e-4 of every (a) run, the launches of
           onehot_embed, fused_sigmoid_matmul and relational_matmul
           counted; (c) the card's weights through sqlite and back as
           RelTensors bit for bit, inference on them through
           relational_matmul, and ``infer_in_db`` against the card within
           1e-4 with equal accuracy; (d) wall times, ingest, plan-cache
           hits and peak memory.
10. db-tier the rest of the in-database tier, all SQL in sqlite
           ``:memory:`` on the host under one tracer: (a) ``train_in_db(...,
           shards=N)`` at phase 9's size, array at N = 1, 2, 4 for 3
           iterations and relational at N = 1, 4 for 1 (N = 1: one shard
           through the sharded trainer), every run within 1e-4 of both
           card engines from the same start and of each other, with the
           wall of an iteration and the SQL AllReduce's traffic; (b)
           ``SQLBatchServer`` serving Listing 8's forward with (a)'s
           weights, 32 one-row requests over 2 pooled connections in each
           representation, every future within 1e-4 of the dense card
           engine with equal argmax, with requests/s, p50/p99 latency and
           the micro-batches formed; (c) the DAG zoo in
           SQL against the card on inputs from ``RandomState(0)``: the MoE
           bucket fill and combine at d_model 2048 (the relational form at
           256) against moe_dispatch and relational_matmul, one RWKV-6 head
           (12, 64) against rwkv6_scan in both forms, the SSD at (64, 64)
           against ``ssd_chunked``, and the MoE layer, channel mix and LRU
           against their float32 counterparts on the card, within 1e-4,
           the launches counted; (d) the capture into
           ``db_tier_trace.db`` and ``db_tier_trace.json`` beside
           ``chip_smoke.json``, both printed by ``python -m
           repro_torch.obs.report --top 5``, and (a)'s and (b)'s metrics
           through ``regress.compare`` against themselves.
11. train  LM training on the full-width Yi-6B cut to 12 layers (2.6 B
           parameters; float32 weights, gradients and AdamW moments, 41.6
           GB), after phase 10: (a) ``Trainer(LM, adamw(3e-4),
           TokenPipeline(seq 4096, global batch 4), grad_accum=2)`` for 1
           warm step and 3 more (remat="full", loss "full"), the counts
           zeroed before and read after: 48 flash_attention and 24
           flash_attention_bwd launches a step; each step's wall, tokens/s,
           loss and grad norm (finite), the peak device memory, and one
           profiled step; (b) at the same width on 2 layers, one
           microbatch of 2 x 4096, the loss and every gradient leaf in
           float32 compute (both flash kernels) against float64 on the card
           with attention through the plain versions (each leaf within 1e-3
           of its largest magnitude, the loss within 1e-5 relative), bf16
           compute beside it as a reading; (c) the reduced Yi-6B on the card
           for 6 steps with a checkpoint every 3 under ``chiprun_out/``: a
           fresh Trainer resumes at 6, every parameter and AdamW leaf equal
           bit for bit; (d) remat="dots" at (a)'s depth and width: one
           microbatch's loss and gradients equal to remat="full"'s, 6
           products kept a layer (the JAX policy's count), then
           ``Trainer`` for 1 warm step and 2 more (48 flash_attention and
           24 flash_attention_bwd launches a step), wall, tokens/s and
           peak; (e) fused_sigmoid_matmul, a card kernel with no
           backward, refuses an operand that requires grad before it
           launches.  The device bytes allocated after the phase, cuBLAS's
           workspaces let go, must equal those before it.
12. moe-train MoE training on the full-width DeepSeek-V2-Lite cut to 5
           layers (the dense first layer and 4 MoE layers, impl="sort";
           2.84 B parameters, 45.4 GB of float32 weights, gradients and
           AdamW moments), after phase 11: (a) ``Trainer`` as phase 11's
           for 1 warm step and 3 more, the counts zeroed before and read
           after: 20 flash_attention, 10 flash_attention_bwd, 16
           moe_dispatch, 32 relational_matmul (16 forward, 16 backward)
           and 8 tuple_dot launches a step, one global_norm and one adamw
           (the optimizer tail); each step's wall and tokens/s,
           the peak device memory, the dropped assignments of each layer
           (the recompute must route as the forward did) and one profiled
           step with each kernel's share; (b) on the dense layer and 1 MoE
           layer at the same width, one microbatch, the loss and every
           gradient leaf in float32 compute against float64 on the card
           (attention through the plain versions, the MoE through ``ref``,
           the routing pinned to the float32 run's experts), phase 11's
           bound, bf16 beside it as a reading.  It frees all it allocates.
13. rwkv-train RWKV-6 training on the full-width RWKV-6 7B cut to 12
           layers (3.16 B parameters, 50.58 GB of float32 weights,
           gradients and AdamW moments), after phase 12: (a) ``Trainer`` as
           phase 11's for 1 warm step and 3 more, the counts zeroed before
           and read after: 48 rwkv6_scan (the forward and remat's
           recompute) and 24 rwkv6_scan_bwd launches a step and no other
           kernel; each step's wall, tokens/s, loss and grad norm (finite),
           the peak device memory (under 75 GiB) and one profiled step with
           the scan kernels' share; (b) on 2 layers at the same width, one
           microbatch, the loss and every gradient leaf in float32 compute
           against float64 on the card with the recurrence through the
           plain versions (``OracleScan``), phase 11's bound, bf16 beside
           it as a reading.  It frees all it allocates.
14. hybrid-train Zamba2-2.7B trained at its full width and depth (54
           Mamba-2 layers, the shared block 9 times; 2.44 B parameters,
           38.97 GB of float32 weights, gradients and AdamW moments), after
           phase 13: (a) ``Trainer`` as phase 11's for 1 warm step and 3
           more, the counts zeroed before and read after: 18
           flash_attention and 18 flash_attention_bwd launches a step (the
           shared block is not under remat) and no other kernel; each
           step's wall, tokens/s, loss and grad norm (finite), the peak
           device memory (under 75 GiB) and one profiled step with the
           flash kernels' share; (b) on the shared block and 2 Mamba-2
           layers at the same width, one microbatch, the loss and every
           gradient leaf in float32 compute against float64 on the card
           (the SSD raised to float64 through layers.ACCUM_DTYPE, attention
           through the plain versions), phase 11's bound, bf16 beside it as
           a reading.  It frees all it allocates.
15. expert-parallel the expert-owner MoE plan and the roofline, after
           phase 14, under a minute: (a) ``moe_ffn(impl="shard")`` on one
           full-width DeepSeek-V2-Lite MoE layer, 8000 tokens, float32, on
           a (data 1, model 1) mesh over a one-rank NCCL group (a local
           TCPStore, destroyed after), against the array form at phase 7
           (d)'s bound, exactly one moe_dispatch and one relational_matmul
           launch; (b) four owners of 16 experts each through
           ``_moe_sort_local``, summed, against the full range at
           tests/test_moe.py's rtol 2e-3, atol 2e-4; (c) the dry-run's
           count (``launch.dryrun.measure_costs`` on a (1, 1) mesh of one
           placeholder rank) of phase 11 (a)'s step: its three terms, the
           bottleneck and roofline_fraction, beside the step phase 11
           measured, which the modelled step may not exceed by more than
           5 %.
16. examples the repository's examples as the port runs them
           (``repro_torch.examples``), each ``main`` on the card with the
           command line its docstring names, the counts zeroed just before
           and read just after each, exactly as ``example_launches`` gives
           them (every other kernel 0): quickstart (300 Iris iterations on
           both engines; their accuracies equal, and their weights, which
           float32 rounding parts by far more than any bound over 300
           iterations at lr 0.05, held below QUICKSTART_DRIFT_LIMIT there,
           and to each other and to numpy's float64 training at
           QUICKSTART_BIND_ITERS with phase 3's bound);
           mnist_e2e --batch 1000 --hidden 20 (30 epochs, the engines'
           weights at phase 3's bound, accuracies equal); train_in_db,
           observe_in_db (in a temporary working directory) and zoo_in_db
           in sqlite (the database against the card and the zoo against its
           oracles within 1e-4); serve_lm --requests 8 --slots 4 (every
           request its 16 new tokens; the engine's decode path launches no
           kernel); train_lm --preset 100m --steps 200 (the loss at the last
           step below the first, the checkpoints at 100 and 200 written to a
           fresh temporary directory) and train_lm --arch dbrx_132b --steps
           20.  Each example's wall, rates and peak device memory, its own
           printed lines and its launches; then every kernel it launched,
           at each shape, type and layout it was given (``ShapeLog``),
           against its plain version at phase 2's tolerance, timed beside
           the plain version, one PyTorch call and its bound.

``python3 chip_smoke.py --kernels [name ...]`` runs phases 1 and 2 alone,
for the named kernels (all ten without a name), and prints no result line:
two trees are compared on one card by running it in each, in turns.

``python3 chip_smoke.py --rwkv-margin`` runs phase 1 and phase 13 (b)
alone, with where (b)'s float32 margin comes from: the float64 model with
one op group at a time in float32 (the group norm, the token-shift mixes,
the layers' products, the scan kernels); it prints no result line and
writes ``chiprun_out/chip_smoke_margin.json``.

``python3 chip_smoke.py --flash-margin [name ...]`` runs phase 1 and the
float32 flash path's error split by part (FLASH_MARGIN, all without a
name): on one layer's operands at Yi-6B's prefill shape, and through phase
5 (d)'s prefill at all 32 layers, the kernel and the plain emulation of
its arithmetic with one source of error changed at a time
(``ref.flash_attention_emulated``) against float64; it prints no result
line and writes ``chiprun_out/chip_smoke_flash_margin.json``.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists the kernels as JSON.  Details also go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.  It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# Published peaks of one H100 SXM (NVIDIA data sheet), at 700 W.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12            # float32 outside the tensor cores (no TF32)
BF16_FLOPS = 989e12          # bf16 on the tensor cores, dense
TF32_FLOPS = 495e12          # TF32 on the tensor cores, dense

F32_TOL = dict(rtol=2e-4, atol=2e-5)      # tests/test_kernels.py
BF16_TOL = dict(rtol=6e-2, atol=3e-2)
# float64 numpy training vs the float32 engines after 5 steps at full
# width: sums run over k = 784 features forward and over 2000 rows in the
# Eq. 10/11 weight gradients, in float32 and in another order, so the
# reference test's 3e-4/3e-5 (30 rows x 4 features) is too tight here.
TRAIN_TOL = dict(rtol=1e-3, atol=1e-4)
N_ROWS, N_FEAT, N_HID, N_CLS, LR, ITERS = 2000, 784, 200, 10, 0.1, 5


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events over ``iters`` calls
    after ``warmup`` calls (inputs stay warm in the 50 MB L2)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float,
             flops_per_s: float = F32_FLOPS) -> tuple[float, str]:
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def max_err(got: torch.Tensor, want: torch.Tensor, tol: dict | None,
            what: str) -> float:
    """Max |got - want|; raises unless within ``tol`` (exact when None)."""
    got32, want32 = got.float(), want.float()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    if tol is None:
        if not torch.equal(got32, want32):
            raise AssertionError(f"{what}: not exact")
    else:
        torch.testing.assert_close(got32, want32, **tol, msg=lambda m: f"{what}: {m}")
    return float((got32 - want32).abs().max()) if got.numel() else 0.0


def expect_raise(exc, fn, what: str) -> None:
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"{what}: expected {exc.__name__}")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_relational(mod, RelTensor, data, report):
    """The sweep, padding, the main path's five products, and a relation in
    reverse order, each held against the plain version, and with b in bf16
    equal bit for bit to the result for its float32 widening; then each
    product timed (``relmm_product``)."""
    rng = np.random.RandomState(42)
    dev = "cuda"
    err = 0.0

    def run(rel, b, what):
        args = (rel.i, rel.j, rel.v, b, rel.shape[0])
        e = max_err(mod.relational_matmul(*args), mod.plain(*args), F32_TOL,
                    what)
        same_bits(mod, rel.i, rel.j, rel.v, b, rel.shape[0], what)
        return e

    for m, k, n in [(8, 16, 128), (16, 32, 256), (64, 64, 128), (12, 16, 384)]:
        a = torch.tensor(rng.randn(m, k), dtype=torch.float32, device=dev)
        b = torch.tensor(rng.randn(k, n), dtype=torch.float32, device=dev)
        err = max(err, run(RelTensor.from_dense(a), b, f"relmm dense {m,k,n}"))
    m, k, n = 16, 32, 128
    for nnz, pad in [(32, 0), (48, 16), (8, 56)]:
        b = torch.tensor(rng.randn(k, n), dtype=torch.float32, device=dev)
        rows = np.concatenate([np.sort(rng.randint(0, m, nnz)),
                               np.full(pad, m)]).astype(np.int32)
        rel = RelTensor(i=torch.tensor(rows, device=dev),
                        j=torch.tensor(rng.randint(0, k, nnz + pad),
                                       dtype=torch.int32, device=dev),
                        v=torch.tensor(rng.randn(nnz + pad),
                                       dtype=torch.float32, device=dev),
                        shape=(m, k))
        err = max(err, run(rel, b, f"relmm padding {nnz, pad}"))

    # the main path's five products, at their real layouts
    img, w_xh, w_ho = data["img"], data["w_xh"], data["w_ho"]
    d_ho = torch.tensor(rng.randn(N_ROWS, N_CLS) * 0.05, dtype=torch.float32,
                        device=dev)
    d_xh = torch.tensor(rng.randn(N_ROWS, N_HID) * 0.01, dtype=torch.float32,
                        device=dev)
    a_xh = torch.sigmoid(img @ w_xh)
    cases = {
        "z_xh = img.w_xh": (RelTensor.from_dense(img), w_xh),
        "z_ho = a_xh.w_ho": (RelTensor.from_dense(a_xh), w_ho),
        "Eq8 d_ho.w_ho^T": (RelTensor.from_dense(d_ho), w_ho.T.contiguous()),
        "Eq10 a_xh^T.d_ho": (RelTensor.from_dense(a_xh).transpose(), d_ho),
        "Eq11 img^T.d_xh": (RelTensor.from_dense(img).transpose(), d_xh),
    }
    for what, (rel, b) in cases.items():
        err = max(err, run(rel, b, f"relmm {what}"))

    # a relation in reverse order is sorted by the wrapper, as the plain
    # version takes any order; an id out of range still raises
    rel, b = cases["z_xh = img.w_xh"]
    rev = RelTensor(i=rel.i.flip(0).contiguous(), j=rel.j.flip(0).contiguous(),
                    v=rel.v.flip(0).contiguous(), shape=rel.shape)
    err = max(err, run(rev, b, "relmm z_xh reversed"))
    expect_raise(ValueError, lambda: mod.relational_matmul(
        rel.i, rel.j + N_FEAT, rel.v, b, N_ROWS), "col out of range")

    products = {what: relmm_product(mod, rel, b)
                for what, (rel, b) in cases.items()}
    main = products["z_xh = img.w_xh"]
    report["relational_matmul"] = dict(
        name="relational_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/relational_matmul.cu",
        replaces="src/repro/kernels/relational_matmul.py:61",
        max_abs_err=err, **main, products=products)
    for what, r in products.items():
        log(f"relational_matmul {what} {r['shape']}, {r['schedule']}: "
            f"{r['ms']:.4f} ms a call, device {r['device_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, torch.sparse.mm {r['library_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def same_bits(mod, rows, cols, vals, b, m, what) -> None:
    """relational_matmul with b in bf16 gives the bits of its float32
    widening (and the same bits twice)."""
    b16 = b.to(torch.bfloat16)
    got = mod.relational_matmul(rows, cols, vals, b16, m)
    if not (torch.equal(got, mod.relational_matmul(rows, cols, vals,
                                                   b16.float(), m))
            and torch.equal(got, mod.relational_matmul(rows, cols, vals, b16,
                                                       m))):
        raise AssertionError(f"{what}: bf16 b differs from its float32 "
                             "widening or from itself")


def relmm_bound(nnz: int, named: int, m: int, n: int, b_size: int):
    """The least time of a product: the tuples (two int32 ids and a float32
    value), the ``named`` rows of b that they name and the float32 output,
    each moved once, or 2·nnz·n float32 FLOPs."""
    return bound_ms(12 * nnz + b_size * named * n + 4 * m * n, 2 * nnz * n)


def relmm_product(mod, rel, b) -> dict:
    """One product of the main path timed by events and by the profiler,
    beside the plain version, one ``torch.sparse.mm`` call and its bound."""
    m, (k, n) = rel.shape[0], b.shape
    args = (rel.i, rel.j, rel.v, b, m)
    coo = torch.sparse_coo_tensor(torch.stack([rel.i.long(), rel.j.long()]),
                                  rel.v, (m, k),
                                  check_invariants=True).coalesce()
    named = int(torch.unique(rel.j).numel())
    bms, by = relmm_bound(rel.capacity, named, m, n, b.element_size())
    return dict(
        shape=f"({m}x{k}).({k}x{n}) as {rel.capacity} tuples",
        schedule=dataclasses.asdict(mod.schedule(m, k, n, rel.capacity,
                                                 b.dtype)),
        ms=time_ms(lambda: mod.relational_matmul(*args)),
        device_ms=device_ms(device_events(
            lambda: mod.relational_matmul(*args))),
        plain_ms=time_ms(lambda: mod.plain(*args), iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.sparse.mm(coo, b)))


#: the benchmark's table (``portbench/configs/mlp-mnist-60k.json``):
#: MNIST's 60,000 training rows, where Eqs. 10 and 11 have k past any slab
LONG_ROWS = 60000


def check_relmm_long(mod, RelTensor, data, report):
    """Eqs. 10 and 11 at the benchmark's 60,000 rows, the transposed
    relations as the engine builds them, which take the ``kslab`` schedule:
    each held against the float64 dense product (``img`` is dense in the
    relation; the plain version's join of 47 M x 200 values would need
    37.6 GB), two calls equal bit for bit and bf16 b equal to its float32
    widening; then timed beside the stream route they took before (the
    wrapper's schedule told the cols are unsorted), one ``torch.sparse.mm``
    call and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(LONG_ROWS)
    img = torch.rand(LONG_ROWS, N_FEAT, generator=gen, device="cuda")
    a_xh = torch.sigmoid(img @ data["w_xh"])
    d_ho = torch.randn(LONG_ROWS, N_CLS, generator=gen, device="cuda") * 0.05
    d_xh = torch.randn(LONG_ROWS, N_HID, generator=gen, device="cuda") * 0.01
    schedule, out = mod.schedule, {}

    def as_stream(*args, **kw):
        return schedule(*args, **{**kw, "cols_sorted": False})

    for what, (a, b) in {"Eq10 a_xh^T.d_ho": (a_xh, d_ho),
                         "Eq11 img^T.d_xh": (img, d_xh)}.items():
        rel = RelTensor.from_dense(a).transpose()
        (m, k), n = rel.shape, b.shape[1]
        args = (rel.i, rel.j, rel.v, b, m)
        plan = schedule(m, k, n, rel.capacity, b.dtype)
        if plan.kind != "kslab":
            raise AssertionError(f"relmm {what} at {LONG_ROWS} rows: "
                                 f"{plan.kind}, not kslab")
        want = (a.double().T @ b.double()).float()
        err = max_err(mod.relational_matmul(*args), want, F32_TOL,
                      f"relmm {what} at {LONG_ROWS} rows")
        same_bits(mod, *args, f"relmm {what} at {LONG_ROWS} rows")
        coo = torch.sparse_coo_tensor(
            torch.stack([rel.i.long(), rel.j.long()]), rel.v, (m, k),
            check_invariants=True).coalesce()
        bms, by = relmm_bound(rel.capacity, k, m, n, 4)
        events = device_events(lambda: mod.relational_matmul(*args), 5)
        mod.schedule = as_stream
        try:
            stream_ms = time_ms(lambda: mod.relational_matmul(*args), 5, 1)
        finally:
            mod.schedule = schedule
        r = out[what] = dict(
            shape=f"({m}x{k}).({k}x{n}) as {rel.capacity} tuples",
            schedule=dataclasses.asdict(plan),
            scratch_bytes=plan.scratch(m, n), max_abs_err=err,
            ms=time_ms(lambda: mod.relational_matmul(*args)),
            device=events, device_ms=device_ms(events), stream_ms=stream_ms,
            yardstick="float64 dense product", bound_ms=bms, bound_by=by,
            library_ms=time_ms(lambda: torch.sparse.mm(coo, b), 5))
        del coo
        log(f"relational_matmul {what} {r['shape']}, kslab (ranges "
            f"{plan.ranges}, {plan.blocks} blocks, scratch "
            f"{r['scratch_bytes']} B): {r['ms']:.4f} ms a call, device "
            f"{r['device_ms']:.4f} ms in {events}; the stream route "
            f"{stream_ms:.4f} ms, torch.sparse.mm {r['library_ms']:.4f} ms, "
            f"bound {bms:.4f} ms ({by}), max |err| {err:.3e}")
    report["relational_matmul"]["long"] = out


# DeepSeek-V2-Lite prefill's MoE combine: 8000 tokens x top-6 = 48,000
# tuples (token, slot, gate) into 8000 x 2048 rows, from the 64 x 944 =
# 60,416-slot expert output (nn/moe.py, _moe_sort)
COMBINE = (8000, 6, 60416, 2048)
COMBINE_DROPPED = 0.15       # assignments past capacity: 4.4-25.4 % a layer


def check_relmm_combine(mod, report):
    """The MoE combine as the sort path builds it: token-major rows, each
    assignment its own slot, a dropped one slot 0 with value 0; held against
    the plain version and timed beside one ``torch.sparse.mm`` call and the
    bytes of the tuples, the slot rows they name and the output."""
    rng = np.random.RandomState(48)
    t, k, slots, d = COMBINE
    nnz = t * k
    keep = rng.rand(nnz) >= COMBINE_DROPPED
    cols_np = np.where(keep, rng.permutation(slots)[:nnz], 0)
    rows = torch.arange(t, dtype=torch.int32,
                        device="cuda").repeat_interleave(k)
    cols = torch.tensor(cols_np, dtype=torch.int32, device="cuda")
    vals = torch.tensor(np.where(keep, rng.rand(nnz), 0.0),
                        dtype=torch.float32, device="cuda")
    b = torch.tensor(rng.randn(slots, d), dtype=torch.float32, device="cuda")
    args = (rows, cols, vals, b, t)
    err = max_err(mod.relational_matmul(*args), mod.plain(*args), F32_TOL,
                  f"relmm MoE combine {COMBINE}")
    same_bits(mod, rows, cols, vals, b, t, f"relmm MoE combine {COMBINE}")
    coo = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]),
                                  vals, (t, slots),
                                  check_invariants=True).coalesce()
    named = len(np.unique(cols_np))
    bms, by = relmm_bound(nnz, named, t, d, 4)
    events = device_events(lambda: mod.relational_matmul(*args), 10)
    b16 = b.to(torch.bfloat16)
    args16 = (rows, cols, vals, b16, t)
    events16 = device_events(lambda: mod.relational_matmul(*args16), 10)
    bms16, by16 = relmm_bound(nnz, named, t, d, 2)
    out = dict(
        shape=f"{nnz} tuples ({COMBINE_DROPPED:.0%} dropped) into {t}x{d} "
              f"from ({slots}x{d}) float32",
        max_abs_err=err,
        ms=time_ms(lambda: mod.relational_matmul(*args)),
        device=events, device_ms=device_ms(events),
        plain_ms=time_ms(lambda: mod.plain(*args), iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.sparse.mm(coo, b)),
        schedule=dataclasses.asdict(mod.schedule(t, slots, d, nnz,
                                                 b.dtype)),
        # the expert rows in bf16, as the MoE layer gives them
        bf16=dict(ms=time_ms(lambda: mod.relational_matmul(*args16)),
                  device=events16, device_ms=device_ms(events16),
                  plain_ms=time_ms(lambda: mod.plain(*args16), iters=5),
                  bound_ms=bms16, bound_by=by16),
        # the float32 copy of bf16 expert rows that the MoE layer made
        # before the combine took bf16 rows
        copy_bf16_to_f32_ms=time_ms(lambda: b16.to(torch.float32)))
    report["relational_matmul"]["combine"] = out
    log(f"relational_matmul at the MoE combine ({out['shape']}): "
        f"{out['ms']:.4f} ms a call, device {out['device_ms']:.4f} "
        f"ms in {events}, plain {out['plain_ms']:.4f} ms, torch.sparse.mm "
        f"{out['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}), max |err| "
        f"{err:.3e}; a bf16 -> float32 copy of the expert rows "
        f"{out['copy_bf16_to_f32_ms']:.4f} ms")
    r = out["bf16"]
    log(f"relational_matmul at the MoE combine, b in bf16: {r['ms']:.4f} ms "
        f"a call, device {r['device_ms']:.4f} ms in {events16}, plain "
        f"{r['plain_ms']:.4f} ms, bound {bms16:.4f} ms ({by16}), bit for bit "
        f"the result for its float32 widening")


# DeepSeek-V2-Lite's MoE layer in a training microbatch (phase 12): 2 x 4096
# tokens in 4 groups of 2048, top-6: 49,152 assignments (token, slot, gate)
# into 64 experts x 4 groups x 240 = 61,440 capacity slots of d_model 2048
MOE_TRAIN = (8192, 6, 61440, 2048)


def moe_train_relations(rng):
    """The two relations ``nn/moe.py::_moe_sort`` builds at MOE_TRAIN, with
    COMBINE_DROPPED of the assignments dropped: the combine's token-major
    (row token, col its assignment's slot, value its gate; a dropped one
    slot 0 with value 0) and the dispatch's (slot -> token with gate 1, or
    token 0 with gate 0 where the slot is empty)."""
    t, k, slots, _ = MOE_TRAIN
    nnz = t * k
    keep = rng.rand(nnz) >= COMBINE_DROPPED
    cols = np.where(keep, rng.permutation(slots)[:nnz], 0)
    rows = np.repeat(np.arange(t), k)
    live = np.zeros(slots, bool)
    live[cols[keep]] = True
    src = np.zeros(slots, np.int64)
    src[cols[keep]] = rows[keep]
    as_i32 = lambda a: torch.tensor(a, dtype=torch.int32, device="cuda")
    as_f32 = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    return (as_i32(rows), as_i32(cols),
            as_f32(np.where(keep, rng.rand(nnz), 0.0)), as_i32(src),
            as_f32(live))


def check_relmm_backward(mod, report):
    """relational_matmul at the two products of the MoE layer's backward
    (phase 12), on the transposed relations ``ops._transpose`` builds, as
    the autograd Functions run them: d ys = Rᵀ · dOut of the combine (into
    the 61,440 slot rows, dOut float32) and d x = Rᵀ · dBuf of the dispatch
    (into the 8192 token rows, dBuf bf16).  Held against the plain version
    in float64 at F32_TOL, b in bf16 bit for bit its float32 widening, and
    timed beside the plain version, one ``torch.sparse.mm`` call (float32
    b: it takes no bf16 beside float32 values) and the bound of the live
    tuples."""
    from repro_torch.kernels import ops
    rng = np.random.RandomState(50)
    t, _, slots, d = MOE_TRAIN
    rows, cols, vals, src, live = moe_train_relations(rng)
    arange = torch.arange(slots, dtype=torch.int32, device="cuda")
    cases = {
        "combine d ys": (ops._transpose(rows, cols, vals, t, slots),
                         torch.tensor(rng.randn(t, d), dtype=torch.float32,
                                      device="cuda"), slots),
        "dispatch d x": (ops._transpose(arange, src, live, slots, t),
                         torch.tensor(rng.randn(slots, d), dtype=torch.float32,
                                      device="cuda").to(torch.bfloat16), t)}
    out = {}
    for what, ((r, c, v), b, m) in cases.items():
        args = (r, c, v, b, m)
        n_live = int((r < m).sum())
        err = max_err(mod.relational_matmul(*args),
                      mod.plain(r, c, v.double(), b.double(), m).float(),
                      F32_TOL, f"relmm backward {what}")
        same_bits(mod, r, c, v, b.float(), m, f"relmm backward {what}")
        coo = torch.sparse_coo_tensor(
            torch.stack([r[:n_live].long(), c[:n_live].long()]), v[:n_live],
            (m, b.shape[0]), check_invariants=True).coalesce()
        b32 = b.float()
        named = int(torch.unique(c[:n_live]).numel())
        bms, by = relmm_bound(n_live, named, m, d, b.element_size())
        events = device_events(lambda: mod.relational_matmul(*args), 10)
        row = dict(
            shape=f"{r.numel()} tuples, {n_live} live, into {m}x{d} from "
                  f"({b.shape[0]}x{d}) {str(b.dtype).removeprefix('torch.')}",
            max_abs_err=err,
            schedule=dataclasses.asdict(mod.schedule(m, b.shape[0], d,
                                                     r.numel(), b.dtype)),
            ms=time_ms(lambda: mod.relational_matmul(*args)),
            device=events, device_ms=device_ms(events),
            plain_ms=time_ms(lambda: mod.plain(*args), iters=5),
            library_ms=time_ms(lambda: torch.sparse.mm(coo, b32)),
            bound_ms=bms, bound_by=by)
        out[what] = row
        log(f"relational_matmul backward {what} ({row['shape']}, "
            f"{row['schedule']['kind']}): {row['ms']:.4f} ms a call, device "
            f"{row['device_ms']:.4f} ms in {events}, plain "
            f"{row['plain_ms']:.4f} ms, torch.sparse.mm (float32 b) "
            f"{row['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}), max "
            f"|err| {err:.3e}")
    report["relational_matmul"]["backward"] = out


def check_tuple_dot(mod, report):
    """tuple_dot over a sweep of shapes (float32 and bf16 a and b, padding
    tuples) and at the gates' gradient of the MoE combine in training
    (MOE_TRAIN: 49,152 tuples, dOut 8192 x 2048 float32, the expert rows
    61,440 x 2048 bf16), against the plain version in float64 and in
    float32 at F32_TOL; two calls equal bit for bit.  a (dOut) is drawn
    at d^-1/2 the scale of b, so each dot product is O(1), the scale
    F32_TOL's atol was set for: at unit scale a sum of 2048 products is
    about 45 in magnitude, and where it cancels near 0 float32's rounding
    alone (the plain float32 version's as much as the kernel's) reaches
    the atol.  Timed beside the plain
    version, ``torch.sparse.sampled_addmm`` on the relation's distinct
    (row, col) pairs as CSR (float32 rows: it takes no bf16) and the bytes
    of the ids, of the distinct rows the tuples name and of the output."""
    rng = np.random.RandomState(49)
    dev = "cuda"
    f32, b16 = torch.float32, torch.bfloat16
    err = 0.0
    for ma, mb, d, nnz in [(16, 24, 64, 100), (50, 40, 136, 300),
                           (7, 9, 2048, 64)]:
        rows = torch.tensor(np.r_[rng.randint(0, ma, nnz - 4), [ma] * 4],
                            dtype=torch.int32, device=dev)
        cols = torch.tensor(rng.randint(0, mb, nnz), dtype=torch.int32,
                            device=dev)
        for ta, tb in ((f32, f32), (f32, b16), (b16, f32), (b16, b16)):
            a = torch.tensor(rng.randn(ma, d) * d ** -0.5, dtype=f32,
                             device=dev).to(ta)
            b = torch.tensor(rng.randn(mb, d), dtype=f32, device=dev).to(tb)
            got = mod.tuple_dot(a, rows, b, cols)
            err = max(err, max_err(
                got, mod.plain(a.double(), rows, b.double(), cols).float(),
                F32_TOL, f"tuple_dot {ma, mb, d, nnz} {ta} {tb}"))
            if got[-4:].any():
                raise AssertionError("tuple_dot: a padding tuple is not 0")
    t, _, slots, d = MOE_TRAIN
    rows, cols, _, _, _ = moe_train_relations(rng)
    dout = torch.tensor(rng.randn(t, d) * d ** -0.5, dtype=f32, device=dev)
    ys = torch.tensor(rng.randn(slots, d), dtype=f32, device=dev).to(b16)
    args = (dout, rows, ys, cols)
    got = mod.tuple_dot(*args)
    err = max(err, max_err(
        got, mod.plain(dout.double(), rows, ys.double(), cols).float(),
        F32_TOL, "tuple_dot MoE gates, float64 plain"))
    err32 = max_err(got, mod.plain(*args), F32_TOL,
                    "tuple_dot MoE gates, float32 plain")
    if not torch.equal(got, mod.tuple_dot(*args)):
        raise AssertionError("tuple_dot: two calls differ")
    pairs = torch.sparse_coo_tensor(
        torch.stack([rows.long(), cols.long()]),
        torch.ones(rows.numel(), dtype=f32, device=dev),
        (t, slots), check_invariants=True).coalesce()
    csr = pairs.to_sparse_csr()
    ys_t = ys.float().t()
    sddmm = lambda: torch.sparse.sampled_addmm(csr, dout, ys_t, beta=0.0)
    ci = pairs.indices()
    lib_err = float((sddmm().values() - mod.plain(
        dout, ci[0].int(), ys, ci[1].int())).abs().max())
    nnz = rows.numel()
    named_a = int(torch.unique(rows).numel())
    named_b = int(torch.unique(cols).numel())
    bms, by = bound_ms(12 * nnz + 4 * d * named_a + 2 * d * named_b,
                       2 * nnz * d)
    events = device_events(lambda: mod.tuple_dot(*args), 10)
    r = dict(name="tuple_dot", route="cuda",
             source="src/repro_torch/kernels/csrc/tuple_dot.cu",
             replaces="none: the gradient of relational_matmul "
                      "(src/repro/kernels/relational_matmul.py:61) with "
                      "respect to its values and of moe_dispatch "
                      "(src/repro/kernels/moe_dispatch.py:27) with respect "
                      "to its gates, which JAX gets from jax.grad",
             shape=f"{nnz} tuples, dOut ({t}x{d}) float32, ys ({slots}x{d}) "
                   "bf16",
             max_abs_err=err, max_abs_err_f32_plain=err32,
             ms=time_ms(lambda: mod.tuple_dot(*args)),
             device=events, device_ms=device_ms(events),
             plain_ms=time_ms(lambda: mod.plain(*args), iters=5),
             library_ms=time_ms(sddmm),
             library="torch.sparse.sampled_addmm on the "
                     f"{ci.shape[1]} distinct pairs as CSR, float32 ys",
             library_max_abs_diff=lib_err,
             bound_ms=bms, bound_by=by)
    report["tuple_dot"] = r
    log(f"tuple_dot at the MoE gates' gradient ({r['shape']}): max |err| "
        f"{err:.3e} (float32 plain {err32:.3e}), two calls equal bit for "
        f"bit; {r['ms']:.4f} ms a call, device {r['device_ms']:.4f} ms in "
        f"{events}, plain {r['plain_ms']:.4f} ms, sampled_addmm "
        f"{r['library_ms']:.4f} ms (max |diff| {lib_err:.3e}), bound "
        f"{bms:.4f} ms ({by})")


#: the largest leaf of each LM cell's AdamW (``portbench/``): DeepSeek-V2-
#: Lite's stacked expert output projection at 5 layers (4 MoE layers) and
#: Zamba2-7B's stacked Mamba-2 in_proj at 24 layers, float32 without a
#: master, as the cells hold them
OPT_LEAVES = {"adamw_deepseek": (4, 64, 1408, 2048),
              "adamw_zamba2": (24, 3584, 14704)}
OPT_HYPER = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def check_optimizer(mod, report):
    """The optimizer tail's two kernels at each LM cell's largest leaf
    (OPT_LEAVES), as the trainer calls them at step 2 of 2 microbatches
    with a binding clip: ``global_norm`` within 1e-6 of the float64 norm
    and two calls equal bit for bit; ``adamw_update`` against the per-leaf
    PyTorch code (``optimizers.adamw_plain``) given the kernel's factor,
    bit for bit in the parameter and both moments.  Timed beside the plain
    versions (the norm of the divided gradients and the factor; the
    division, the clip and AdamW's passes) and the bytes at 3.35 TB/s:
    each input read once, each output written once (4 B an element for
    the norm; g, m, v and w read and m, v and w written, 28 B, for the
    update).  The kernels replace no TPU kernel: the JAX package leaves
    AdamW and the clip to XLA."""
    from repro_torch.optim import GradScale, optimizers

    dev = "cuda"
    replaces = ("none: JAX leaves AdamW and the clip to XLA "
                "(src/repro/optim/optimizers.py::adamw, "
                "::clip_by_global_norm)")
    for key, shape in OPT_LEAVES.items():
        n = int(np.prod(shape))
        gen = torch.Generator(device=dev).manual_seed(len(shape))
        g = torch.randn(shape, generator=gen, device=dev)
        w = torch.randn(shape, generator=gen, device=dev).mul_(0.02)
        m = torch.randn(shape, generator=gen, device=dev).mul_(1e-3)
        v = torch.randn(shape, generator=gen, device=dev).mul_(1e-3).square_()
        t = torch.tensor(2, dtype=torch.int32, device=dev).float()
        b1t, b2t = (1.0 - torch.pow(torch.tensor(b, dtype=torch.float32,
                                                 device=dev), t)
                    for b in (0.9, 0.95))
        want = sum(float((c.double() / 2).square().sum())
                   for c in g.view(-1).split(1 << 26)) ** 0.5
        out = mod.global_norm([g], 2, 1.0)
        norm_err = abs(float(out[0]) - want) / want
        if norm_err > 1e-6:
            raise AssertionError(f"global_norm {key}: {norm_err:.3e} of the "
                                 "float64 norm")
        if not torch.equal(out, mod.global_norm([g], 2, 1.0)):
            raise AssertionError(f"global_norm {key}: two calls differ")
        scale = GradScale(2, out[1])
        kw, km, kv = w.clone(), m.clone(), v.clone()
        mod.adamw_update([kw], [kw], [g], [km], [kv], b1t, b2t,
                         grad_scale=scale, **OPT_HYPER)
        gp = g.clone()
        optimizers.adamw_plain([w], [w], [gp], [m], [v], b1t, b2t,
                               grad_scale=scale, **OPT_HYPER)
        for what, a, b in (("w", kw, w), ("m", km, m), ("v", kv, v)):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"adamw {key}: {what} differs from the "
                                     "plain update")
        del gp
        torch.cuda.empty_cache()

        def plain_norm():
            norm = optimizers.global_norm([g], 2)
            return torch.clamp(1.0 / (norm + 1e-9), max=1.0)

        def plain_update():
            optimizers.adamw_plain([w], [w], [g], [m], [v], b1t, b2t,
                                   grad_scale=GradScale(2, plain_norm()),
                                   **OPT_HYPER)

        update = lambda: mod.adamw_update([kw], [kw], [g], [km], [kv], b1t,
                                          b2t, grad_scale=scale, **OPT_HYPER)
        shape_s = f"{tuple(shape)} float32, {n:,} elements"
        for name, fn, plain, nbytes, flops in (
                ("global_norm", lambda: mod.global_norm([g], 2, 1.0),
                 plain_norm, 4 * n, 3 * n),
                ("adamw", update, plain_update, 28 * n, 16 * n)):
            events = device_events(fn, 5)
            bms, by = bound_ms(nbytes, flops)
            r = dict(name=name, route="cuda",
                     source="src/repro_torch/kernels/csrc/adamw.cu",
                     replaces=replaces, shape=shape_s,
                     max_abs_err=norm_err if name == "global_norm" else 0.0,
                     ms=time_ms(fn, iters=10), device=events,
                     device_ms=device_ms(events),
                     plain_ms=time_ms(plain, iters=3, warmup=1),
                     library_ms=None, bound_ms=bms, bound_by=by)
            report[f"{name}_{key.split('_')[1]}"] = r
            log(f"{name} at {key} ({shape_s}): {r['ms']:.4f} ms a call, "
                f"device {r['device_ms']:.4f} ms in {events}, plain "
                f"{r['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}), "
                f"{bms / r['ms']:.3f} of it" + (
                    f"; norm {norm_err:.3e} of float64's, two calls equal"
                    if name == "global_norm" else
                    "; w, m, v equal to the plain update bit for bit"))
        del g, w, m, v, kw, km, kv, out, scale
        gc.collect()
        torch.cuda.empty_cache()


#: the profiler sessions ``profiled`` ran again, in this run
PROFILER_RETRIES: list[dict] = []


def profiled(fn, calls: int = 1, sessions: int = 3, cpu: bool = True
             ) -> list:
    """The device events of ``calls`` calls of ``fn`` under torch.profiler,
    in order.  The session runs ``fn`` once first, then three groups of
    three marker kernels (``torch.cuda._sleep``), each group followed by a
    synchronize and a 10 ms pause of the host, and keeps only the events
    after the last marker it holds: on an H100 a session's first device
    events were at times missing from it (one or two after an idle spell
    or many launches; once, in all three sessions of a call, everything
    before the calls: ``fn``'s run and a single group of markers), and
    where ``fn`` is one kernel those can take the markers with them; once,
    a session held its markers and none of the calls' events after them).
    A session that holds none of its markers, or nothing after the last,
    is run again, up to ``sessions`` in all, and logged in
    ``PROFILER_RETRIES`` with the kernels it held before its markers
    (``fn``'s first run).  ``cpu=False`` records the device's activity
    alone: the host's ops of a step of 94,000 launches took the profiler
    about two minutes to read."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if cpu else [])
    for session in range(1, sessions + 1):
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
            for _ in range(3):
                for _ in range(3):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                time.sleep(0.01)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        # the program's spans (``repro_torch.obs``) are ``record_function``
        # ranges under the profiler, which it also lists on the device as
        # annotations over the kernels launched inside: not device work
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not e.is_user_annotation),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        if marks and marks[-1] + 1 < len(events):
            return events[marks[-1] + 1:]
        before = sorted({short_name(e.name)
                         for e in events[:marks[0] if marks else None]})
        PROFILER_RETRIES.append(dict(session=session, events=len(events),
                                     markers=len(marks), before=before))
        log(f"profiler session {session} of {sessions} held "
            + ("no event after its last marker kernel" if marks else
               "none of its marker kernels")
            + f" ({len(events)} device events; before the markers: "
            + (", ".join(before) or "none") + ")")
    raise AssertionError("no profiler session held the calls' events after "
                         "its marker kernels")


def device_events(fn, calls: int = 20) -> dict:
    """Each device event of ``calls`` calls of ``fn`` (``profiled``): how
    many a call issues and its milliseconds a call (kernels, and any
    memset or memcpy)."""
    by_name = {}
    for e in profiled(fn, calls):
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    if not by_name:
        raise AssertionError("the profiler saw no device event")
    return {name: dict(per_call=n / calls, ms=ms / calls)
            for name, (n, ms) in by_name.items()}


def device_ms(events: dict) -> float:
    return sum(e["ms"] for e in events.values())


def top_kernels(fn, n: int = 3) -> list[str]:
    """The names of the ``n`` device events that take longest in one call
    of ``fn`` (which backend a PyTorch call chose)."""
    events = device_events(fn, calls=1)
    return sorted(events, key=lambda k: -events[k]["ms"])[:n]


def sass_functions(name: str) -> dict[str, list[str]]:
    """The opcodes (``FFMA``, ``HFMA2.MMA``, ``HGMMA.64x128x16.F32.BF16``,
    ...) of each kernel function in the SASS of the library built from
    ``csrc/<name>.cu``, by mangled function name."""
    from repro_torch.kernels import build
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(build.target(name))], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, ops = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            ops = out.setdefault(head.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and ops is not None:
            ops.append(m.group(1))
    return out


def sass_opcodes(name: str) -> list[str]:
    """The opcode of each instruction in the SASS of the library built
    from ``csrc/<name>.cu``, all its kernels together."""
    return [op for ops in sass_functions(name).values() for op in ops]


def check_fused(mod, data, report):
    """The sweep, the edges of both tile instances, then the two layers of
    the main path: each held against the plain version and called twice
    (the same bits), timed by events and by the profiler beside
    ``torch.sigmoid(x @ w)``; and no tensor-core instruction in the SASS."""
    rng = np.random.RandomState(43)
    err = 0.0
    sweep = [(128, 128, 128), (256, 384, 256), (128, 512, 384),
             (150, 4, 8), (150, 8, 3),
             # n one below / above the 40-wide and 16-wide tiles, k off the
             # 32 and 64 slices and off 4 (4-byte copies), m off 40 and 16
             (81, 100, 39), (79, 100, 41), (150, 70, 15), (17, 65, 16),
             (33, 30, 17)]
    for m, k, n in sweep:
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x = torch.tensor(rng.randn(m, k), dtype=torch.float32,
                             device="cuda").to(dtype)
            w = torch.tensor(rng.randn(k, n), dtype=torch.float32,
                             device="cuda").to(dtype)
            e = max_err(mod.fused_sigmoid_matmul(x, w), mod.plain(x, w), tol,
                        f"fused {m,k,n} {dtype}")
            if dtype == torch.float32:
                err = max(err, e)
    img, w_xh, w_ho = data["img"], data["w_xh"], data["w_ho"]
    a_xh = mod.plain(img, w_xh)
    layers = {}
    for what, (x, w) in {"a_xh": (img, w_xh), "a_ho": (a_xh, w_ho)}.items():
        events = device_events(lambda: mod.fused_sigmoid_matmul(x, w))
        if [e["per_call"] for e in events.values()] != [1]:
            raise AssertionError(f"fused {what}: a call's device events "
                                 f"{events}, expected one kernel")
        got = mod.fused_sigmoid_matmul(x, w)
        err = max(err, max_err(got, mod.plain(x, w), F32_TOL, f"fused {what}"))
        if not torch.equal(got, mod.fused_sigmoid_matmul(x, w)):
            raise AssertionError(f"fused {what}: two calls differ")
        (m, k), n = x.shape, w.shape[1]
        bms, by = bound_ms(4 * (m * k + k * n + m * n), 2 * m * k * n)
        layers[what] = dict(
            shape=f"({m}x{k}).({k}x{n}) float32",
            tile=mod.instance(m, k, n), blocks=mod.blocks(m, k, n),
            ms=time_ms(lambda: mod.fused_sigmoid_matmul(x, w)),
            device_ms=device_ms(events),
            plain_ms=time_ms(lambda: mod.plain(x, w)),
            bound_ms=bms, bound_by=by,
            library_ms=time_ms(lambda: torch.sigmoid(x @ w)),
            library_device_ms=device_ms(device_events(
                lambda: torch.sigmoid(x @ w))))
    ops = sass_opcodes("fused_sigmoid_matmul")
    ffma = sum(op.startswith("FFMA") for op in ops)
    tensor_ops = sorted({op for op in ops if op.split(".")[0].endswith("MMA")})
    if tensor_ops or not ffma:
        raise AssertionError(f"fused_sigmoid_matmul SASS: {ffma} FFMA, "
                             f"tensor-core instructions {tensor_ops}")
    report["fused_sigmoid_matmul"] = dict(
        name="fused_sigmoid_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_sigmoid_matmul.cu",
        replaces="src/repro/kernels/fused_sigmoid_matmul.py:41",
        max_abs_err=err, **layers["a_xh"], a_ho=layers["a_ho"],
        sass_ffma=ffma, sass_tensor_ops=tensor_ops)
    for what, r in layers.items():
        log(f"fused_sigmoid_matmul {what} {r['shape']}, {r['tile']} tile, "
            f"{r['blocks']} blocks: {r['ms']:.4f} ms a call, device "
            f"{r['device_ms']:.4f} ms; torch.sigmoid(x @ w) "
            f"{r['library_ms']:.4f} ms, device {r['library_device_ms']:.4f}"
            f" ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"fused_sigmoid_matmul SASS: {ffma} FFMA, no tensor-core "
        f"instruction; max |err| {err:.3e}, two calls equal bit for bit")


def check_onehot(mod, data, report):
    """The sweep and the labels, exact; a bad id raises and the next call
    is clean; then a call's time beside ``F.embedding``'s, by events and by
    the profiler, whose events for one call must be one kernel and no
    memset or memcpy, and the C launcher's launch-and-wait alone."""
    from repro_torch.kernels import build
    rng = np.random.RandomState(44)
    for t, v, d in [(16, 100, 64), (64, 1000, 128), (128, 333, 256),
                    (7, 5, 3), (9, 4, 10)]:
        ids = torch.tensor(rng.randint(0, v, t), dtype=torch.int32,
                           device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.tensor(rng.randn(v, d), dtype=torch.float32,
                                 device="cuda").to(dtype)
            max_err(mod.onehot_embed(ids, table), mod.plain(ids, table), None,
                    f"onehot {t,v,d} {dtype}")
    labels = data["labels"]
    eye = torch.eye(N_CLS, dtype=torch.float32, device="cuda")
    err = max_err(mod.onehot_embed(labels, eye), mod.plain(labels, eye), None,
                  "onehot labels")
    expect_raise(IndexError, lambda: mod.onehot_embed(labels + N_CLS, eye),
                 "id out of range")
    max_err(mod.onehot_embed(labels, eye), mod.plain(labels, eye), None,
            "onehot labels after a bad call")
    t, d = labels.shape[0], N_CLS
    bms, by = bound_ms(4 * t + 4 * N_CLS * d + 4 * t * d, 0)
    long_ids = labels.long()
    embedding = lambda: torch.nn.functional.embedding(long_ids, eye)
    events = device_events(lambda: mod.onehot_embed(labels, eye))
    kernels = {k: e for k, e in events.items()
               if not k.startswith(("Memset", "Memcpy"))}
    if len(kernels) != 1 or next(iter(kernels.values()))["per_call"] != 1 \
            or len(kernels) != len(events):
        raise AssertionError(f"onehot_embed: a call's device events {events}, "
                             "expected one kernel and no memset or memcpy")
    library_events = device_events(embedding)
    # the C launcher alone (launch, event, wait, flag), by the host clock
    lib = build.library("onehot_embed", mod._SIGNATURES)
    out = torch.empty((t, d), device="cuda")
    args = (labels.data_ptr(), eye.data_ptr(), out.data_ptr(), t, N_CLS,
            4 * d, 8, *build.device_and_stream(eye))
    rcs = [lib.onehot_launch(*args) for _ in range(10)]
    t0 = time.perf_counter()
    rcs += [lib.onehot_launch(*args) for _ in range(200)]
    launch_wait_ms = (time.perf_counter() - t0) / 200 * 1e3
    if any(rcs) or not torch.equal(out, mod.plain(labels, eye)):
        raise AssertionError(f"onehot_launch returned {set(rcs)}")
    report["onehot_embed"] = dict(
        name="onehot_embed", route="cuda",
        source="src/repro_torch/kernels/csrc/onehot_embed.cu",
        replaces="src/repro/kernels/onehot_embed.py:28",
        max_abs_err=err,
        ms=time_ms(lambda: mod.onehot_embed(labels, eye)),
        device_ms=device_ms(events), device_events=events,
        launch_wait_ms=launch_wait_ms,
        plain_ms=time_ms(lambda: mod.plain(labels, eye)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(embedding),
        library_device_ms=device_ms(library_events),
        library_device_events=library_events,
        shape=f"({t},) ids into eye({N_CLS})")
    r = report["onehot_embed"]
    log(f"onehot_embed: {r['ms']:.4f} ms a call, of which the C launcher's "
        f"launch and wait {launch_wait_ms:.4f} ms; device {r['device_ms']:.5f}"
        f" ms a call in {events}; F.embedding {r['library_ms']:.4f} ms a "
        f"call, device {r['library_device_ms']:.5f} ms in {library_events}")


MOE_MAIN = (8000, 64, 944, 2048)     # DeepSeek-V2-Lite prefill: T, E, cap, d
MOE_LIVE = 8000 * 6                  # slots that take a token (top-6)


def check_moe_dispatch(mod, report):
    """tests/test_kernels.py's shapes, then the bucket fill of one
    DeepSeek-V2-Lite prefill layer: 8000 tokens into 64 x 944 slots, of
    which 48000 take a token with gate 1 and the rest row 0 with gate 0.
    Exact in float32 and bf16."""
    rng = np.random.RandomState(47)
    t, e, cap, d = MOE_MAIN
    slots = e * cap
    cases = [(32, 64, 64), (64, 96, 128), (t, slots, d)]
    for n, n_slots, width in cases:
        idx = torch.tensor(rng.randint(0, n, n_slots), dtype=torch.int32,
                           device="cuda")
        gates = torch.tensor(rng.rand(n_slots), dtype=torch.float32,
                             device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.tensor(rng.randn(n, width), dtype=torch.float32,
                             device="cuda").to(dtype)
            max_err(mod.moe_dispatch(x, idx, gates), mod.plain(x, idx, gates),
                    None, f"moe_dispatch {n, n_slots, width} {dtype}")
    live = torch.zeros(slots, dtype=torch.bool, device="cuda")
    live[torch.tensor(rng.permutation(slots)[:MOE_LIVE], device="cuda")] = True
    idx = torch.where(live, torch.tensor(rng.randint(0, t, slots),
                                         dtype=torch.int32, device="cuda"), 0)
    layouts = {"random": (idx.to(torch.int32), live.to(torch.float32)),
               "bucket-sorted": bucket_layout(rng)}
    x = torch.tensor(rng.randn(t, d), dtype=torch.float32,
                     device="cuda").to(torch.bfloat16)
    err = 0.0
    for what, (idx, gates) in layouts.items():
        err = max(err, max_err(mod.moe_dispatch(x, idx, gates),
                               mod.plain(x, idx, gates), None,
                               f"moe_dispatch main bucket fill bf16, {what}"))
    expect_raise(ValueError, lambda: mod.moe_dispatch(x, idx + t, gates),
                 "moe_dispatch index out of range")
    max_err(mod.moe_dispatch(x, idx, gates), mod.plain(x, idx, gates), None,
            "moe_dispatch after a bad call")
    bms, by = bound_ms(8 * slots + 2 * t * d + 2 * slots * d, slots * d)
    timed_layouts = {}
    for what, (idx, gates) in layouts.items():
        events = device_events(lambda: mod.moe_dispatch(x, idx, gates))
        timed_layouts[what] = dict(
            ms=time_ms(lambda: mod.moe_dispatch(x, idx, gates)),
            device_ms=device_ms(events), device_events=events,
            plain_ms=time_ms(lambda: mod.plain(x, idx, gates)),
            # two PyTorch calls, a yardstick: no single call gathers and
            # scales
            library_ms=time_ms(lambda: x.index_select(0, idx)
                               * gates.to(x.dtype)[:, None]))
    # the output's bytes written alone, by one zero fill: what the card's
    # write rate makes of the 247.5 MB
    fill = torch.empty((slots, d), dtype=x.dtype, device="cuda")
    fill_ms = time_ms(fill.zero_)
    report["moe_dispatch"] = dict(
        name="moe_dispatch", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_dispatch.cu",
        replaces="src/repro/kernels/moe_dispatch.py:27",
        max_abs_err=err, **timed_layouts["random"],
        bound_ms=bms, bound_by=by, fill_ms=fill_ms,
        library="two PyTorch calls: x.index_select(0, idx) * gates",
        shape=f"x ({t},{d}) bf16 into {e}x{cap} = {slots} slots, "
              f"{MOE_LIVE} live", layouts=timed_layouts)
    log(f"moe_dispatch vs plain: exact over the sweep and the main shape "
        f"in float32 and bf16, a good call after a bad one exact; a zero "
        f"fill of the output's {2 * slots * d / 1e6:.1f} MB {fill_ms:.4f} ms")
    for what, r in timed_layouts.items():
        log(f"moe_dispatch {what} layout: {r['ms']:.4f} ms a call, device "
            f"{r['device_ms']:.4f} ms in {r['device_events']}, plain "
            f"{r['plain_ms']:.4f} ms, index_select * gates "
            f"{r['library_ms']:.4f} ms, bound {bms:.4f} ms ({by})")


def bucket_layout(rng):
    """The slot layout ``nn/moe.py::_moe_sort`` builds for one group of
    MOE_MAIN's tokens, each routed to 6 distinct experts at random: each
    expert's bucket holds its tokens in ascending order for each routing
    rank in turn, the empty slots take row 0 with gate 0.  Returns (int32
    row of each slot, float32 gate)."""
    from repro_torch.nn import moe
    t, e, cap, _ = MOE_MAIN
    top = np.argsort(rng.rand(t, e), axis=1)[:, :MOE_LIVE // t]
    idx = torch.tensor(top[None], dtype=torch.int64, device="cuda")
    slot_token, slot_live, _ = moe._sort_relation(idx, cap, e)
    if int(slot_live.sum()) != MOE_LIVE:
        raise AssertionError(f"bucket layout: {int(slot_live.sum())} live "
                             f"slots, expected {MOE_LIVE}")
    src = torch.where(slot_live, slot_token, 0).reshape(-1)
    return src.to(torch.int32), slot_live.reshape(-1).to(torch.float32)


FLASH_MAIN = (4, 32, 4, 2000, 128)      # Yi-6B prefill: B, Hq, Hkv, S, D
# DeepSeek-V2-Lite's MLA prefill: B, H, S, Dqk (128 + 64), Dv
FLASH_MLA = (4, 16, 2000, 192, 128)
# Zamba2-2.7B's shared attention in its prefill (phase 8): B, H (= Hkv),
# S, D = Dv = 80, which both kernels pad on chip to whole slabs; and in a
# training microbatch (phase 14), 18 launches a step
FLASH_ZAMBA2 = (4, 32, 2048, 80)
FLASH_ZAMBA2_TRAIN = (2, 32, 4096, 80)
# Zamba2-7B's shared attention in a training microbatch of the benchmark's
# cell, (D, Dv) = (224, 224), bf16 alone (the float32 kernels stop at
# 192), and at a ragged S
FLASH_ZAMBA2_7B = ((2, 32, 4096, 224), (2, 32, 1000, 224))
# bf16 at the main shape: the kernel rounds P to bf16 before P V (and sums
# the rounded P), the plain version keeps P in float32, and both round the
# output to bf16, so they differ by P's rounding (2^-9 of each weight, which
# averages out over 2000 keys) and by one bf16 ulp of the output, at most
# 2^-7 of the value.  Typical outputs are about 0.05 here, so the sweep's
# atol 3e-2 would hide a wrong row, and 1e-2 does not.
FLASH_MAIN_BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def flash_flops(b, hq, s, d, dv, causal=True):
    """Operations of the score pairs the call needs: QKᵀ over d and PV over
    dv, 2 FLOPs a multiply-add."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 2 * b * hq * pairs * (d + dv)


def flash_bytes(b, hq, hkv, s, d, dv, size):
    """Bytes of q, k, v read and out written once."""
    return size * (b * hq * s * (d + dv) + b * hkv * s * (d + dv))


def flash_bound(b, hq, hkv, s, d, dtype, causal=True, dv=None):
    """The card's least time for one call: the operations of
    ``flash_flops`` at the type's peak, or ``flash_bytes``."""
    dv = d if dv is None else dv
    size = torch.tensor([], dtype=dtype).element_size()
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    return bound_ms(flash_bytes(b, hq, hkv, s, d, dv, size),
                    flash_flops(b, hq, s, d, dv, causal), peak)


def hgmma_count(name: str) -> int:
    """HGMMA (wgmma) instructions in the SASS of a flash library: the bf16
    one (``flash_attention_tc``) or the float32 one (``flash_attention``,
    3xTF32)."""
    return sum(op.startswith("HGMMA") for op in sass_opcodes(name))


def flash_bound_tf32(b, hq, hkv, s, d, causal=True, dv=None):
    """The float32 kernel's least time on the tensor cores: its 3xTF32
    split runs three TF32 products for each float32 one, 3 x
    ``flash_flops`` at the TF32 peak (or the float32 bytes, if more)."""
    dv = d if dv is None else dv
    return bound_ms(flash_bytes(b, hq, hkv, s, d, dv, 4),
                    3 * flash_flops(b, hq, s, d, dv, causal), TF32_FLOPS)


def f32_rates(f32_ms, flops, bound, tf32_bound, library_ms) -> dict:
    """The float32 kernel's TFLOP/s (float32 operations), its share of both
    bounds and its ratio to float32 SDPA."""
    return dict(f32_tflops=flops / f32_ms * 1e-9,
                f32_bound_share=bound / f32_ms,
                f32_tf32_bound_share=tf32_bound / f32_ms,
                f32_sdpa_ratio=f32_ms / library_ms)


def flash_rates(out: dict, flops: float) -> dict:
    """Achieved TFLOP/s, share of the bound and the ratio to SDPA, from the
    times in ``out``."""
    return dict(tflops=flops / out["ms"] * 1e-9,
                bound_share=out["bound_ms"] / out["ms"],
                sdpa_ratio=out["ms"] / out["library_ms"])


def check_flash(mod, report):
    rng = np.random.RandomState(45)

    def inputs(b, hq, hkv, s, d, dtype):
        return [torch.tensor(rng.randn(b, h, s, d), dtype=torch.float32,
                             device="cuda").to(dtype)
                for h in (hq, hkv, hkv)]

    # tests/test_kernels.py's sweep, then ragged S, causal and not
    shapes = [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 8, 1, 256, 128),
              (1, 4, 2, 77, 32), (2, 8, 2, 1000, 128)]
    err32 = 0.0
    for shape in shapes:
        for causal in (True, False):
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                q, k, v = inputs(*shape, dtype)
                e = max_err(mod.flash_attention(q, k, v, causal=causal),
                            mod.plain(q, k, v, causal=causal), tol,
                            f"flash {shape} causal={causal} {dtype}")
                if dtype == torch.float32:
                    err32 = max(err32, e)
    # the main shape in both types: float32 (the path of phase 5 (c)'s
    # float32 check) at the tests' tolerance, bf16 tighter than the sweep's
    # and against the bf16-scores plain version, whose numerics it has
    b, hq, hkv, s, d = FLASH_MAIN
    q, k, v = inputs(*FLASH_MAIN, torch.float32)
    err32_main = max_err(mod.flash_attention(q, k, v), mod.plain(q, k, v),
                         F32_TOL, f"flash main {FLASH_MAIN} float32 causal")
    f32_ms = time_ms(lambda: mod.flash_attention(q, k, v), iters=10)
    f32_device = device_events(lambda: mod.flash_attention(q, k, v), 5)
    f32_bound, f32_by = flash_bound(*FLASH_MAIN, torch.float32)
    f32_tf32_bound, _ = flash_bound_tf32(*FLASH_MAIN)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f32_sdpa = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
    f32_library_ms = time_ms(f32_sdpa, iters=5)
    f32_library_kernels = top_kernels(f32_sdpa)
    q, k, v = inputs(*FLASH_MAIN, torch.bfloat16)
    err = max_err(mod.flash_attention(q, k, v), mod.plain(q, k, v),
                  FLASH_MAIN_BF16_TOL, f"flash main {FLASH_MAIN} bf16 causal")
    err_scores = max_err(mod.flash_attention(q, k, v),
                         mod.plain(q, k, v, bf16_scores=True),
                         FLASH_MAIN_BF16_TOL,
                         f"flash main {FLASH_MAIN} bf16 vs bf16 scores")
    bms, by = flash_bound(*FLASH_MAIN, torch.bfloat16)
    mla = check_flash_mla(mod, inputs, sdpa)
    zamba2 = check_flash_zamba2(mod, sdpa)
    zamba2_train = check_flash_zamba2(mod, sdpa, FLASH_ZAMBA2_TRAIN)
    zamba2_7b = {f"s{shape[2]}": check_flash_zamba2_7b(mod, sdpa, shape)
                 for shape in FLASH_ZAMBA2_7B}
    hgmma = hgmma_count("flash_attention_tc")
    hgmma_f32 = hgmma_count("flash_attention")
    log(f"SASS: flash_attention_tc {hgmma}, flash_attention (float32, "
        f"3xTF32) {hgmma_f32} HGMMA instructions")
    if not hgmma or not hgmma_f32:
        raise AssertionError("a flash library has no HGMMA instruction: "
                             "not on the tensor cores")
    out = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        replaces="src/repro/kernels/flash_attention.py:69",
        max_abs_err=err,
        ms=time_ms(lambda: mod.flash_attention(q, k, v), iters=20),
        plain_ms=time_ms(lambda: mod.plain(q, k, v), iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                        enable_gqa=True)),
        shape=f"q ({b},{hq},{s},{d}), k/v ({b},{hkv},{s},{d}) bf16 causal",
        max_abs_err_bf16_scores=err_scores,
        max_abs_err_f32_sweep=err32, max_abs_err_f32_main=err32_main,
        f32_ms=f32_ms, f32_device=f32_device, f32_bound_ms=f32_bound,
        f32_bound_by=f32_by, f32_tf32_bound_ms=f32_tf32_bound,
        f32_library_ms=f32_library_ms, f32_library_kernels=f32_library_kernels,
        f32_source="src/repro_torch/kernels/csrc/flash_attention.cu",
        hgmma=hgmma, hgmma_f32=hgmma_f32, mla=mla, zamba2=zamba2,
        zamba2_train=zamba2_train, zamba2_7b=zamba2_7b)
    out |= flash_rates(out, flash_flops(b, hq, s, d, d))
    out |= f32_rates(f32_ms, flash_flops(b, hq, s, d, d), f32_bound,
                     f32_tf32_bound, f32_library_ms)
    report["flash_attention"] = out
    log(f"flash vs plain, max |err|: float32 sweep {err32:.3e}, float32 "
        f"main {err32_main:.3e}, bf16 main {err:.3e}, bf16 main vs "
        f"bf16-scores plain {err_scores:.3e} (held at "
        f"{FLASH_MAIN_BF16_TOL}); Yi shape {out['ms']:.4f} ms = "
        f"{out['tflops']:.1f} TFLOP/s, {out['bound_share']:.3f} of the "
        f"bound, {out['sdpa_ratio']:.2f} x SDPA; float32 kernel "
        f"{f32_ms:.4f} ms ({out['f32_tflops']:.1f} TFLOP/s; device "
        f"{device_ms(f32_device):.4f} ms: {summary(f32_device)}), float32 "
        f"bound {f32_bound:.4f} ms ({f32_by}), 3xTF32 bound "
        f"{f32_tf32_bound:.4f} ms ({out['f32_tf32_bound_share']:.3f} of it), "
        f"float32 SDPA (TF32 off) {f32_library_ms:.4f} ms "
        f"{f32_library_kernels}, {out['f32_sdpa_ratio']:.2f} x SDPA")


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments,
    cut to 40 characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.sub(r"\(.*", "", name)[:40]


def summary(events: dict) -> str:
    """Each device event's name (cut short) and milliseconds a call."""
    return ", ".join(f"{short_name(name)} {e['ms']:.4f} ms"
                     for name, e in events.items())


def check_flash_mla(mod, inputs, sdpa):
    """MLA's prefill attention, q/k of head dim 192 and v of 128: a small
    sweep of (D, Dv) pairs with Dv < D and a ragged S, then the main shape
    in float32 (the tests' tolerance) and bf16 (the Yi shape's), timed."""
    err32 = 0.0
    for b, h, s, d, dv in [(1, 4, 77, 64, 32), (2, 4, 130, 128, 64),
                           (1, 4, 100, 192, 128), (1, 2, 65, 192, 32)]:
        for causal in (True, False):
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                q, k = inputs(b, h, h, s, d, dtype)[:2]
                v = inputs(b, h, h, s, dv, dtype)[2]
                e = max_err(mod.flash_attention(q, k, v, causal=causal),
                            mod.plain(q, k, v, causal=causal), tol,
                            f"flash {b, h, s, d, dv} causal={causal} {dtype}")
                if dtype == torch.float32:
                    err32 = max(err32, e)
    b, h, s, d, dv = FLASH_MLA
    q, k = inputs(b, h, h, s, d, torch.float32)[:2]
    v = inputs(b, h, h, s, dv, torch.float32)[2]
    err32_main = max_err(mod.flash_attention(q, k, v), mod.plain(q, k, v),
                         F32_TOL, f"flash MLA {FLASH_MLA} float32 causal")
    f32_ms = time_ms(lambda: mod.flash_attention(q, k, v), iters=10)
    f32_device = device_events(lambda: mod.flash_attention(q, k, v), 5)
    f32_bound, f32_by = flash_bound(b, h, h, s, d, torch.float32, dv=dv)
    f32_tf32_bound, _ = flash_bound_tf32(b, h, h, s, d, dv=dv)
    f32_sdpa = lambda: sdpa(q, k, v, is_causal=True)
    f32_library_ms = time_ms(f32_sdpa, iters=5)
    f32_library_kernels = top_kernels(f32_sdpa)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    err = max_err(mod.flash_attention(q, k, v), mod.plain(q, k, v),
                  FLASH_MAIN_BF16_TOL, f"flash MLA {FLASH_MLA} bf16 causal")
    err_scores = max_err(mod.flash_attention(q, k, v),
                         mod.plain(q, k, v, bf16_scores=True),
                         FLASH_MAIN_BF16_TOL,
                         f"flash MLA {FLASH_MLA} bf16 vs bf16 scores")
    bms, by = flash_bound(b, h, h, s, d, torch.bfloat16, dv=dv)
    out = dict(
        shape=f"q, k ({b},{h},{s},{d}), v ({b},{h},{s},{dv}) bf16 causal",
        max_abs_err=err, max_abs_err_bf16_scores=err_scores,
        max_abs_err_f32_main=err32_main, max_abs_err_f32_sweep=err32,
        f32_ms=f32_ms, f32_device=f32_device, f32_bound_ms=f32_bound,
        f32_bound_by=f32_by, f32_tf32_bound_ms=f32_tf32_bound,
        f32_library_ms=f32_library_ms, f32_library_kernels=f32_library_kernels,
        ms=time_ms(lambda: mod.flash_attention(q, k, v), iters=20),
        plain_ms=time_ms(lambda: mod.plain(q, k, v), iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: sdpa(q, k, v, is_causal=True)))
    out |= flash_rates(out, flash_flops(b, h, s, d, dv))
    out |= f32_rates(f32_ms, flash_flops(b, h, s, d, dv), f32_bound,
                     f32_tf32_bound, f32_library_ms)
    log(f"flash MLA vs plain, max |err|: float32 sweep {err32:.3e}, float32 "
        f"main {err32_main:.3e}, bf16 main {err:.3e}, bf16 main vs "
        f"bf16-scores plain {err_scores:.3e}; {out['ms']:.4f} ms = "
        f"{out['tflops']:.1f} TFLOP/s, {out['bound_share']:.3f} of the "
        f"bound ({bms:.4f} ms, {by}), {out['sdpa_ratio']:.2f} x SDPA "
        f"({out['library_ms']:.4f} ms), plain {out['plain_ms']:.4f} ms, "
        f"float32 kernel {f32_ms:.4f} ms ({out['f32_tflops']:.1f} TFLOP/s; "
        f"device {device_ms(f32_device):.4f} ms: {summary(f32_device)}), "
        f"float32 bound {f32_bound:.4f} ms ({f32_by}), 3xTF32 bound "
        f"{f32_tf32_bound:.4f} ms ({out['f32_tf32_bound_share']:.3f} of it), "
        f"float32 SDPA (TF32 off) {f32_library_ms:.4f} ms "
        f"{f32_library_kernels}, {out['f32_sdpa_ratio']:.2f} x SDPA")
    return out


def check_flash_zamba2_7b(mod, sdpa, shape):
    """Zamba2-7B's shared attention, (D, Dv) = (224, 224), causal at
    ``shape`` as the model hands it over (head-split views of (B, S, 7168)
    projections): the bf16 kernel against the float32-P plain version and
    the bf16-scores one at the Yi shape's tolerance, timed beside the
    plain version, SDPA and the bound; the float32 kernels have no 224 and
    raise their head-dim error."""
    b, h, s, d = shape
    rng = np.random.RandomState(224 + s)
    q, k, v = (torch.tensor(rng.randn(b, s, h, d), dtype=torch.float32,
                            device="cuda").transpose(1, 2) for _ in range(3))
    expect_raise(ValueError, lambda: mod.flash_attention(q, k, v),
                 "flash Zamba2-7B float32 at 224")
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    if not all(mod.takes(t) for t in (q, k, v)):
        raise AssertionError("flash Zamba2-7B: the head-split views need a "
                             "copy")
    err = max_err(mod.flash_attention(q, k, v), mod.plain(q, k, v),
                  FLASH_MAIN_BF16_TOL, f"flash Zamba2-7B {shape} bf16 causal")
    err_scores = max_err(mod.flash_attention(q, k, v),
                         mod.plain(q, k, v, bf16_scores=True),
                         FLASH_MAIN_BF16_TOL,
                         f"flash Zamba2-7B {shape} bf16 vs bf16 scores")
    causal_sdpa = lambda q, k, v: sdpa(q, k, v, is_causal=True)
    bms, by = flash_bound(b, h, h, s, d, torch.bfloat16)
    out = dict(
        shape=f"q, k, v ({b},{h},{s},{d}) head-split views, causal",
        max_abs_err=err, max_abs_err_bf16_scores=err_scores,
        ms=time_ms(lambda: mod.flash_attention(q, k, v), iters=20),
        device=device_events(lambda: mod.flash_attention(q, k, v), 5),
        plain_ms=time_ms(lambda: mod.plain(q, k, v), iters=3),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: causal_sdpa(q, k, v)),
        library_kernels=top_kernels(lambda: causal_sdpa(q, k, v)))
    out |= flash_rates(out, flash_flops(b, h, s, d, d))
    log(f"flash Zamba2-7B {shape} vs plain, max |err|: bf16 {err:.3e}, bf16 "
        f"vs bf16-scores plain {err_scores:.3e}; {out['ms']:.4f} ms (device "
        f"{device_ms(out['device']):.4f} ms) = {out['tflops']:.1f} TFLOP/s, "
        f"{out['bound_share']:.3f} of the bound ({bms:.4f} ms, {by}), "
        f"{out['sdpa_ratio']:.2f} x SDPA ({out['library_ms']:.4f} ms "
        f"{out['library_kernels']}), plain {out['plain_ms']:.4f} ms")
    return out


def check_flash_zamba2(mod, sdpa, shape=FLASH_ZAMBA2):
    """Zamba2's shared attention, (D, Dv) = (80, 80), at ``shape`` (its
    prefill's, or its training microbatch's) as the model hands it over
    (head-split views of (B, S, 2560) projections, read in place): float32
    at the tests' tolerance, bf16 at the Yi shape's and against the
    bf16-scores plain version; each timed beside the plain version, SDPA
    and the bound."""
    b, h, s, d = shape
    rng = np.random.RandomState(80)
    q, k, v = (torch.tensor(rng.randn(b, s, h, d), dtype=torch.float32,
                            device="cuda").transpose(1, 2) for _ in range(3))
    if not all(mod.takes(t) for t in (q, k, v)):
        raise AssertionError("flash Zamba2: the head-split views need a copy")
    causal_sdpa = lambda q, k, v: sdpa(q, k, v, is_causal=True)
    err32 = max_err(mod.flash_attention(q, k, v), mod.plain(q, k, v),
                    F32_TOL, f"flash Zamba2 {shape} float32 causal")
    f32_ms = time_ms(lambda: mod.flash_attention(q, k, v), iters=10)
    f32_device = device_events(lambda: mod.flash_attention(q, k, v), 5)
    f32_plain_ms = time_ms(lambda: mod.plain(q, k, v), iters=5)
    f32_bound, f32_by = flash_bound(b, h, h, s, d, torch.float32)
    f32_tf32_bound, _ = flash_bound_tf32(b, h, h, s, d)
    f32_library_ms = time_ms(lambda: causal_sdpa(q, k, v), iters=5)
    f32_library_kernels = top_kernels(lambda: causal_sdpa(q, k, v))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    err = max_err(mod.flash_attention(q, k, v), mod.plain(q, k, v),
                  FLASH_MAIN_BF16_TOL, f"flash Zamba2 {shape} bf16 causal")
    err_scores = max_err(mod.flash_attention(q, k, v),
                         mod.plain(q, k, v, bf16_scores=True),
                         FLASH_MAIN_BF16_TOL,
                         f"flash Zamba2 {shape} bf16 vs bf16 scores")
    bms, by = flash_bound(b, h, h, s, d, torch.bfloat16)
    out = dict(
        shape=f"q, k, v ({b},{h},{s},{d}) head-split views, causal",
        max_abs_err=err, max_abs_err_bf16_scores=err_scores,
        max_abs_err_f32_main=err32,
        ms=time_ms(lambda: mod.flash_attention(q, k, v), iters=20),
        device=device_events(lambda: mod.flash_attention(q, k, v), 5),
        plain_ms=time_ms(lambda: mod.plain(q, k, v), iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: causal_sdpa(q, k, v)),
        library_kernels=top_kernels(lambda: causal_sdpa(q, k, v)),
        f32_ms=f32_ms, f32_device=f32_device, f32_plain_ms=f32_plain_ms,
        f32_bound_ms=f32_bound, f32_bound_by=f32_by,
        f32_tf32_bound_ms=f32_tf32_bound, f32_library_ms=f32_library_ms,
        f32_library_kernels=f32_library_kernels)
    out |= flash_rates(out, flash_flops(b, h, s, d, d))
    out |= f32_rates(f32_ms, flash_flops(b, h, s, d, d), f32_bound,
                     f32_tf32_bound, f32_library_ms)
    log(f"flash Zamba2 {shape} vs plain, max |err|: float32 "
        f"{err32:.3e}, bf16 {err:.3e}, bf16 vs bf16-scores plain "
        f"{err_scores:.3e}; bf16 {out['ms']:.4f} ms (device "
        f"{device_ms(out['device']):.4f} ms) = {out['tflops']:.1f} TFLOP/s, "
        f"{out['bound_share']:.3f} of the bound ({bms:.4f} ms, {by}), "
        f"{out['sdpa_ratio']:.2f} x SDPA ({out['library_ms']:.4f} ms "
        f"{out['library_kernels']}), plain {out['plain_ms']:.4f} ms; "
        f"float32 kernel {f32_ms:.4f} ms ({out['f32_tflops']:.1f} TFLOP/s; "
        f"device {device_ms(f32_device):.4f} ms: {summary(f32_device)}), "
        f"plain {f32_plain_ms:.4f} ms, float32 bound {f32_bound:.4f} ms "
        f"({f32_by}), 3xTF32 bound {f32_tf32_bound:.4f} ms "
        f"({out['f32_tf32_bound_share']:.3f} of it), float32 SDPA (TF32 "
        f"off) {f32_library_ms:.4f} ms {f32_library_kernels}, "
        f"{out['f32_sdpa_ratio']:.2f} x SDPA")
    return out


# flash_attention_bwd at the training shape of phase 11 (Yi-6B, the
# repo's train_4k sequence: B, Hq, Hkv, S, D; B = 2 is a microbatch, 4 the
# global batch), and at the MLA and Zamba2 shapes phase 2 times the
# forward at
FLASH_TRAIN = (2, 32, 4, 4096, 128)
FLASH_TRAIN_B4 = (4, 32, 4, 4096, 128)
# DeepSeek-V2-Lite's MLA in phase 12's training microbatch: B, Hq, Hkv, S,
# D, Dv, and no head-split views (torch.cat makes q and k contiguous there)
FLASH_MLA_TRAIN = (2, 16, 16, 4096, 192, 128, False)
# bf16 gradients: the kernel widens the operands exactly, sums in float32
# (F32_TOL's error) and rounds each gradient once; the oracle is the
# float64 answer rounded once.  So they lie at most one bf16 ulp (2^-7 of
# the rounded value) beyond the float32 error: F32_TOL plus 2^-7, with
# 1 % for measuring against the rounded value rather than the exact one.
BF16_BWD_TOL = dict(rtol=8.1e-3, atol=2.1e-5)


def bwd_pairs(b, hq, s, causal=True):
    return b * hq * (s * (s + 1) // 2 if causal else s * s)


def bwd_flops(b, hq, s, d, dv, causal=True):
    """The least operations of the backward: five products over the live
    pairs (S, dP, dV, dK, dQ), 2 FLOPs a multiply-add."""
    return 2 * bwd_pairs(b, hq, s, causal) * (3 * d + 2 * dv)


def bwd_tile_pairs(b, hq, s, causal=True):
    """Score pairs of the 64 x 64 tiles the kernel visits: whole tiles, the
    diagonal's masked half and the ragged end of S included."""
    n = -(-s // 64)
    return b * hq * 64 * 64 * (n * (n + 1) // 2 if causal else n * n)


def bwd_design_flops(b, hq, s, d, dv, dtype, causal=True):
    """What the kernel's design computes on the tensor cores, 2 operations
    a multiply-add over the pairs of the tiles it visits: S = q·kᵀ in both
    walks of the dQ kernel and in the dV and the dK kernel, dP in the dQ
    kernel's walks and the dK kernel, and dV, dK and dQ over the widths
    their wgmmas run (whole slabs or blocks).  bf16: the three gradient
    products twice (P and dS in two bf16 parts); float32: every product
    three times (3xTF32), counted as TF32 operations."""
    if dtype == torch.bfloat16:
        def width(x):
            slab = 64 if x >= 64 else 32
            return -(-x // slab) * slab
        per_pair = 4 * d + 3 * dv + 2 * (width(dv) + 2 * width(d))
    else:
        def width(x):
            block = 64 if x % 64 == 0 else 32
            return -(-x // block) * block
        per_pair = 3 * (4 * d + 3 * dv + width(dv) + 2 * width(d))
    return 2 * bwd_tile_pairs(b, hq, s, causal) * per_pair


def check_bwd_sass() -> dict:
    """Every product kernel of ``flash_attention_bwd`` (the bf16 and float32
    dQ and dK/dV kernels of each head-dim pair) holds HGMMA instructions,
    bf16 ones in the bf16 kernels and TF32 ones in the float32 kernels; the
    only kernels without are the float32 split pre-pass's."""
    funcs = sass_functions("flash_attention_bwd")
    counts = {"bf16": 0, "tf32": 0}
    for fn, ops in funcs.items():
        kind = re.search(r"flash_bwd_(bf16|tf32)_(dq|dkdv)", fn)
        kind = kind and kind.group(1)
        if kind is None:
            if not re.search(r"flash_bwd_split_(rows|t)", fn):
                raise AssertionError(f"flash_attention_bwd: unexpected kernel "
                                     f"{fn}")
            continue
        want = "BF16" if kind == "bf16" else "TF32"
        n = sum(op.startswith("HGMMA") and want in op for op in ops)
        if not n:
            raise AssertionError(f"flash_attention_bwd: {fn} has no {want} "
                                 "HGMMA instruction: not on the tensor cores")
        counts[kind] += n
    return dict(functions=len(funcs), hgmma_bf16=counts["bf16"],
                hgmma_tf32=counts["tf32"])


def bwd_bound(b, hq, hkv, s, d, dv, dtype, causal=True):
    """q, k, v and dO read once, dq, dk and dv written once; the least
    operations at the type's peak."""
    size = torch.tensor([], dtype=dtype).element_size()
    n_bytes = 2 * size * (b * hq * s * (d + dv) + b * hkv * s * (d + dv))
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    return bound_ms(n_bytes, bwd_flops(b, hq, s, d, dv, causal), peak)


def bwd_oracle(mod, q, k, v, do, causal):
    """The plain backward in float64 on the card, one batch entry at a
    time (a (1, 32, 4096, 4096) float64 score tensor is 4.3 GB)."""
    outs = [mod.plain_bwd(*(t[i:i + 1].double() for t in (q, k, v, do)),
                          causal=causal) for i in range(q.shape[0])]
    return [torch.cat(parts).to(t.dtype) for parts, t in
            zip(zip(*outs), (q, k, v))]


def check_flash_bwd(mod, report):
    """The gradient kernel against its plain version (float64 oracle) at
    Yi-6B's training microbatch as phase 11 hands it over (head-split
    views), Yi-6B's global batch, MLA's training microbatch as phase 12
    hands it over, MLA's prefill shape and Zamba2's (head-split views),
    causal and full, float32 at F32_TOL and bf16 at BF16_BWD_TOL; two
    calls equal bit for bit; timed beside its bound, its design's count, the plain
    backward and one library call (the backward of SDPA alone, its forward
    outside the timed region).  Also the forward's bf16 kernel against
    the float32-P plain version at the training shape (the difference the
    backward makes visible: it differentiates the float32-P function)."""
    rng = np.random.RandomState(22)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def inputs(b, hq, hkv, s, d, dv, dtype, views=False):
        if views:        # (B, S, H, D) projections seen as (B, H, S, D)
            return [torch.tensor(rng.randn(b, s, h, w), dtype=torch.float32,
                                 device="cuda").to(dtype).transpose(1, 2)
                    for h, w in ((hq, d), (hkv, d), (hkv, dv), (hq, dv))]
        return [torch.tensor(rng.randn(b, h, s, w), dtype=torch.float32,
                             device="cuda").to(dtype)
                for h, w in ((hq, d), (hkv, d), (hkv, dv), (hq, dv))]

    def sdpa_backward(q, k, v, do):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = sdpa(*leaves, is_causal=True, enable_gqa=True)
        return lambda: torch.autograd.grad(out, leaves, do,
                                           retain_graph=True)

    # name: (B, Hq, Hkv, S, D, Dv, head-split views)
    cases = {"yi_train": FLASH_TRAIN + (128, True),
             "yi_b4": FLASH_TRAIN_B4 + (128, False),
             "mla_train": FLASH_MLA_TRAIN,
             "mla": (4, 16, 16, 2000, 192, 128, False),
             "zamba2": (4, 32, 32, 2048, 80, 80, True),
             "zamba2_train": (2, 32, 32, 4096, 80, 80, True),
             "zamba2_7b_train": (2, 32, 32, 4096, 224, 224, True),
             "zamba2_7b_ragged": (2, 32, 32, 1000, 224, 224, True)}
    out = {}
    for name, (b, hq, hkv, s, d, dv, views) in cases.items():
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_BWD_TOL)):
            if (d, dv) not in mod.head_dims(dtype):
                continue          # (224, 224): bf16 alone
            q, k, v, do = inputs(b, hq, hkv, s, d, dv, dtype, views=views)
            key = f"{name}_{str(dtype).removeprefix('torch.')}"
            row = dict(shape=f"q ({b},{hq},{s},{d}), k/v ({b},{hkv},{s},"
                             f"{d}/{dv}) {dtype}"
                             + (" head-split views" if views else ""))
            for causal in (True, False):
                got = mod.flash_attention_bwd(q, k, v, do, causal=causal)
                want = bwd_oracle(mod, q, k, v, do, causal)
                errs = [max_err(g, w, tol, f"flash_bwd {key} d{n} "
                                f"causal={causal}")
                        for n, g, w in zip("qkv", got, want)]
                mode = "causal" if causal else "full"
                row[f"max_abs_err_{mode}"] = max(errs)
                # the largest |got - want| / (atol + rtol |want|): 1 is
                # the tolerance's edge
                row[f"tol_share_{mode}"] = max(
                    float(((g.float() - w.float()).abs() / (
                        tol["atol"] + tol["rtol"] * w.float().abs())).max())
                    for g, w in zip(got, want))
                del got, want
            first = mod.flash_attention_bwd(q, k, v, do)
            if not all(torch.equal(a, c) for a, c in
                       zip(first, mod.flash_attention_bwd(q, k, v, do))):
                raise AssertionError(f"flash_bwd {key}: two calls differ")
            del first
            row["ms"] = time_ms(lambda: mod.flash_attention_bwd(q, k, v, do),
                                iters=5, warmup=1)
            row["device"] = device_events(
                lambda: mod.flash_attention_bwd(q, k, v, do), 2)
            row["plain_ms"] = time_ms(lambda: mod.plain_bwd(q, k, v, do),
                                      iters=2, warmup=1)
            torch.cuda.empty_cache()
            row["library_ms"] = time_ms(sdpa_backward(q, k, v, do), iters=5,
                                        warmup=1)
            row["library_kernels"] = top_kernels(sdpa_backward(q, k, v, do))
            row["bound_ms"], row["bound_by"] = bwd_bound(b, hq, hkv, s, d,
                                                         dv, dtype)
            flops = bwd_flops(b, hq, s, d, dv)
            if dtype == torch.float32:
                # on the tensor cores: three TF32 products for each float32
                # one (3xTF32), at the TF32 peak
                row["tf32_bound_ms"] = 3 * flops / TF32_FLOPS * 1e3
            design = bwd_design_flops(b, hq, s, d, dv, dtype)
            # the design's operations run at the bf16 peak, or (float32,
            # 3xTF32) at the TF32 one
            peak = BF16_FLOPS if dtype == torch.bfloat16 else TF32_FLOPS
            dev_ms = device_ms(row["device"])
            row |= dict(flops=flops, design_flops=design,
                        design_peak=peak, design_ms=design / peak * 1e3,
                        tflops=flops / row["ms"] * 1e-9,
                        design_tflops=design / row["ms"] * 1e-9,
                        design_share=design / peak * 1e3 / row["ms"],
                        bound_share=row["bound_ms"] / row["ms"],
                        sdpa_ratio=row["ms"] / row["library_ms"],
                        device_share={k: e["ms"] / dev_ms
                                      for k, e in row["device"].items()})
            if name == "yi_train" and dtype == torch.bfloat16:
                # the forward's bf16 kernel rounds P before P V; the plain
                # version (and JAX's attend_flash) keeps P in float32
                row["fwd_bf16_vs_f32p"] = max_err(
                    mod.flash_attention(q, k, v),
                    mod.plain(q, k, v), FLASH_MAIN_BF16_TOL,
                    f"flash {key} forward bf16 vs float32-P plain")
            out[key] = row
            log(f"flash_bwd {key} {row['shape']}: max |err| causal "
                f"{row['max_abs_err_causal']:.3e}, full "
                f"{row['max_abs_err_full']:.3e} (held at {tol}, "
                f"{row['tol_share_causal']:.3f} / {row['tol_share_full']:.3f}"
                f" of it); "
                f"{row['ms']:.4f} ms (device {device_ms(row['device']):.4f} "
                f"ms: {summary(row['device'])}) = {row['tflops']:.1f} "
                f"TFLOP/s least, {row['design_tflops']:.1f} TFLOP/s done; "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                f"{row['bound_share']:.3f} of it"
                + (f", 3xTF32 bound {row['tf32_bound_ms']:.4f} ms"
                   if "tf32_bound_ms" in row else "")
                + "; the design's "
                f"{design / 1e12:.3f} TFLOP on the tensor cores "
                f"{row['design_ms']:.4f} ms at {peak / 1e12:.0f} TFLOP/s "
                f"({row['design_share']:.3f} of it); plain "
                f"{row['plain_ms']:.4f} ms; SDPA backward "
                f"{row['library_ms']:.4f} ms {row['library_kernels']} "
                f"({row['sdpa_ratio']:.2f} x); device shares "
                + ", ".join(f"{short_name(k)} {v:.3f}"
                            for k, v in row["device_share"].items()))
            del q, k, v, do
            torch.cuda.empty_cache()
    main = out["yi_train_bfloat16"]
    log(f"flash forward bf16 kernel vs the float32-P plain version at "
        f"{main['shape']}: max |err| {main['fwd_bf16_vs_f32p']:.3e}")
    sass = check_bwd_sass()
    log(f"SASS: flash_attention_bwd {sass['functions']} kernels, "
        f"{sass['hgmma_bf16']} bf16 and {sass['hgmma_tf32']} TF32 HGMMA "
        f"instructions, every product kernel on the tensor cores")
    report["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:69",
        shape=main["shape"] + " causal",
        max_abs_err=main["max_abs_err_causal"], ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        sass=sass, cases=out)


RWKV_MAIN = (4, 64, 2000, 64)      # RWKV-6 7B prefill: B, H, S, N
RWKV_TRAIN = (2, 64, 4096, 64)     # phase 13's microbatch: B, H, S, N
SCAN_TOL = dict(rtol=3e-4, atol=3e-4)         # tests/test_kernels.py


def rwkv6_bound(rows, s, n):
    """Bytes of r, k, v, w read and o written once, u read, s0 read and
    s_fin written; operations: what the recurrence needs, 5 FLOPs for each
    (t, i, j) (S <- w S + k v, a multiply and an FMA; o += r S, an FMA),
    since the u term factors, sum_i r_i u_i k_i v_j = v_j sum_i r_i u_i k_i,
    and costs O(N) a step, not O(N^2)."""
    n_bytes = 4 * (5 * rows * s * n + rows * n + 2 * rows * n * n)
    return bound_ms(n_bytes, 5 * rows * s * n * n)


def rwkv6_bwd_bound(rows, s, n, ds_fin=True, ds0=True):
    """Bytes of r, k, v, w and do read and dr, dk, dv, dw written once, u
    and s0 read, du written, ds_fin read and ds0 written where the call
    has them; operations: 14 FLOPs for each (t, i, j): the four gradient
    products (dr's S do, dk's G v, dv's G k, dw's G S: an FMA each), G's
    update (w G + r do: a multiply and an FMA) and the state's (w S + k v:
    the same), since S_{t-1} has to be had again on the way back.  They
    run where the kernel runs them, on the tensor cores in 3xTF32: three
    TF32 products for each float32 one, at the TF32 peak (as
    ``flash_bound_tf32``).  Also the float32 pipes' time for them."""
    n_bytes = 4 * (9 * rows * s * n + 2 * rows * n
                   + (1 + ds_fin + ds0) * rows * n * n)
    flops = 14 * rows * s * n * n
    return (*bound_ms(n_bytes, 3 * flops, TF32_FLOPS),
            flops / F32_FLOPS * 1e3)


def scan_inputs(rng, lead, s, n):
    """tests/test_kernels.py's inputs: w uniform in [0.4, 0.9), s0 =
    0.1·randn."""
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    r, k, v = (f32(rng.randn(*lead, s, n)) for _ in range(3))
    return (r, k, v, f32(rng.rand(*lead, s, n) * 0.5 + 0.4),
            f32(rng.randn(*lead, n)), f32(rng.randn(*lead, n, n) * 0.1))


def layer_scan_inputs(rng, b, h, s, n):
    """The layer's call: (B, S, H, N) projections seen as (B, H, S, N), u
    (H, N) expanded over the batch, s0 from the cache."""
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    bshn = scan_inputs(rng, (b, s), h, n)[:4]
    return (*(t.transpose(1, 2) for t in bshn),
            f32(rng.randn(h, n)).expand(b, h, n),
            f32(rng.randn(b, h, n, n) * 0.1))


def check_rwkv6(mod, report):
    rng = np.random.RandomState(46)
    inputs = lambda lead, s, n: scan_inputs(rng, lead, s, n)

    def compare(args, what):
        (o, sf), (po, psf) = mod.rwkv6_scan(*args), mod.plain(*args)
        return max(max_err(o, po, SCAN_TOL, f"{what} o"),
                   max_err(sf, psf, SCAN_TOL, f"{what} s_fin"))

    # tests/test_kernels.py's sweep, ragged S, then the main shape as the
    # JAX kernel takes it, (BH, S, N)
    err = 0.0
    for bh, s, n in [(2, 32, 16), (4, 64, 32), (1, 128, 64), (256, 1, 64),
                     (8, 7, 64), (8, 77, 32)]:
        err = max(err, compare(inputs((bh,), s, n), f"rwkv6 {bh, s, n}"))
    b, h, s, n = RWKV_MAIN
    err = max(err, compare(inputs((b * h,), s, n),
                           f"rwkv6 main {(b * h, s, n)}"))
    # the main path's call: (B, S, H, N) projections seen as (B, H, S, N),
    # u (H, N) expanded over the batch, s0 from the cache
    args = layer_scan_inputs(rng, b, h, s, n)
    err = max(err, compare(args, f"rwkv6 main layer views {RWKV_MAIN}"))
    # the decode shape: the same 256 rows of state, one step each, as the
    # layer's head-split views of (B, 1, H, N) projections
    dec = layer_scan_inputs(rng, b, h, 1, n)
    err = max(err, compare(dec, f"rwkv6 decode views {(b, h, 1, n)}"))
    # the training microbatch of phase 13: 128 rows of 4096 steps
    tb, th, ts, tn = RWKV_TRAIN
    trn = layer_scan_inputs(rng, tb, th, ts, tn)
    err = max(err, compare(trn, f"rwkv6 training views {RWKV_TRAIN}"))
    trn_bound, trn_by = rwkv6_bound(tb * th, ts, tn)
    train = dict(
        shape=f"r/k/v/w (B,H,S,N)={RWKV_TRAIN} head-split views, float32",
        ms=time_ms(lambda: mod.rwkv6_scan(*trn), iters=10),
        device=device_events(lambda: mod.rwkv6_scan(*trn), 5),
        bound_ms=trn_bound, bound_by=trn_by)
    del trn
    dec_bound, dec_by = rwkv6_bound(b * h, 1, n)
    decode = dict(
        shape=f"r/k/v/w (B,H,S,N)={(b, h, 1, n)} head-split views, float32",
        ms=time_ms(lambda: mod.rwkv6_scan(*dec), iters=50),
        device=device_events(lambda: mod.rwkv6_scan(*dec), 20),
        plain_ms=time_ms(lambda: mod.plain(*dec), iters=20),
        bound_ms=dec_bound, bound_by=dec_by)
    expect_raise(TypeError, lambda: mod.rwkv6_scan(
        args[0].to(torch.bfloat16), *args[1:]), "rwkv6 bf16 r")
    expect_raise(ValueError, lambda: mod.rwkv6_scan(
        args[0], args[1][:, :, :7], *args[2:]), "rwkv6 mismatched k")
    bms, by = rwkv6_bound(b * h, s, n)
    report["rwkv6_scan"] = dict(
        name="rwkv6_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:54",
        max_abs_err=err,
        ms=time_ms(lambda: mod.rwkv6_scan(*args), iters=10),
        plain_ms=time_ms(lambda: mod.plain(*args), iters=2, warmup=1),
        bound_ms=bms, bound_by=by,
        library_ms=None,      # no single PyTorch call runs this recurrence
        shape=f"r/k/v/w (B,H,S,N)={RWKV_MAIN} head-split views, float32",
        decode=decode, train=train)
    log(f"rwkv6_scan vs plain, max |err| over the sweep, S in {{1, 7, 77}}, "
        f"the main shape, the decode shape and the training microbatch (o "
        f"and s_fin): {err:.3e} (held at {SCAN_TOL}); decode shape "
        f"{decode['ms']:.4f} ms a call (events), device "
        f"{device_ms(decode['device']):.5f} ms, bound {dec_bound:.5f} ms "
        f"({dec_by}); training microbatch {train['ms']:.4f} ms, device "
        f"{device_ms(train['device']):.4f} ms, bound {trn_bound:.4f} ms "
        f"({trn_by})")


#: rwkv6_scan_bwd at the training microbatch in its first design, a walk back
#: from checkpoints of the state (PERF.md §6; NVIDIA H100 80GB HBM3,
#: 700.00 W), printed for reference
RWKV_BWD_FIRST_DESIGN_MS = 4.8617


def rwkv6_bwd_design(rows, s, n, ds_fin=True, ds0=True, chunk=64, sub=16):
    """The work of the chunked design (``csrc/rwkv6_scan_bwd.cu``'s note):
    (product FLOPs, TF32 MMA FLOPs = 3 x them, float32-pipe FLOPs, bytes).
    Products: the walk over the chunks, an (n x chunk)(chunk x n) product a
    chunk each way (the forward skips its last); in each chunk G's and P's
    updates between its sub-chunks and, for every sub-chunk, Y, Z and U
    (sub x n x n) and M (sub x sub x n).  float32 pipes, a row of a
    sub-chunk: 11 FLOPs a step pair for dr, dk, dw (the three sums, Q's
    update, the decay), 4 for Bm, 2 for dv.  Bytes: r, k, v, w, do read by
    both launches (w twice by the first), dr, dk, dv, dw written, the state
    before and G after every chunk written and read, du's chunk sums, s0
    (ds_fin) read, ds0 and du written."""
    nc, ns = -(-s // chunk), chunk // sub
    walk = 2 * n * n * chunk * (2 * nc - 1)
    per_chunk = (2 * (ns - 1) * 2 * n * n * sub
                 + ns * (3 * 2 * sub * n * n + 2 * sub * sub * n))
    products = rows * (walk + nc * per_chunk)
    pairs = sub * (sub - 1) // 2
    fp32 = rows * nc * ns * n * (11 * pairs + 4 * pairs + 2 * (pairs + sub))
    x = 4 * rows * s * n
    n_bytes = (6 * x + 5 * x + 4 * x + 2 * 2 * 4 * rows * nc * n * n
               + 2 * 4 * rows * nc * n + 4 * rows * n
               + (1 + ds_fin + ds0) * 4 * rows * n * n)
    return products, 3 * products, fp32, n_bytes


def mma_count(name: str) -> int:
    """Tensor-core MMA instructions (HMMA: mma.sync; HGMMA: wgmma) in the
    SASS of the library built from ``csrc/<name>.cu``."""
    return sum(op.startswith(("HMMA", "HGMMA")) for op in sass_opcodes(name))


def wide_decay_inputs(rng, b, h, s, n):
    """The layer's call (``layer_scan_inputs``) with the decay a trained
    RWKV-6 spreads: w = exp(-exp(x)), x uniform in [-6, 5), exact float32
    zeros and values within 0.003 of 1."""
    r, k, v, _, u, s0 = layer_scan_inputs(rng, b, h, s, n)
    w = torch.tensor(np.exp(-np.exp(rng.uniform(-6, 5, size=(b, s, h, n)))),
                     dtype=torch.float32, device="cuda").transpose(1, 2)
    return r, k, v, w, u, s0


def check_rwkv6_bwd(mod, report):
    """rwkv6_scan_bwd at phase 13's microbatch as the layer hands it over,
    (2, 64, 4096, 64) head-split views, u expanded, nonzero s0 and ds_fin,
    on tests/test_kernels.py's decays and on the wide decays, against the
    plain backward in float64 at SCAN_TOL, every output finite, two calls
    equal bit for bit; then its time (events, and each launch's device
    time) beside its bound, the design's own count, the plain version's
    and the first design's; the scratch it takes; the MMA instructions in
    its SASS."""
    rng = np.random.RandomState(47)
    b, h, s, n = RWKV_TRAIN
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    cases = {}
    for what, make in (("narrow", layer_scan_inputs),
                       ("wide", wide_decay_inputs)):
        args = make(rng, b, h, s, n)
        do = torch.tensor(rng.randn(b, s, h, n), dtype=torch.float32,
                          device="cuda").transpose(1, 2)
        ds_fin = torch.tensor(rng.randn(b, h, n, n), dtype=torch.float32,
                              device="cuda")
        got = mod.rwkv6_scan_bwd(*args, do, ds_fin)
        again = mod.rwkv6_scan_bwd(*args, do, ds_fin)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"rwkv6_scan_bwd {what}: two calls differ")
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"rwkv6_scan_bwd {what}: an output is not "
                                 "finite")
        want = mod.plain_bwd(*(t.double() for t in (*args, do, ds_fin)))
        errs = {nm: max_err(g, w.float(), SCAN_TOL,
                            f"rwkv6_scan_bwd {what} {nm}")
                for nm, g, w in zip(names, got, want, strict=True)}
        # each gradient's largest |diff| in units of SCAN_TOL at that entry
        shares = {nm: float(((g.double() - w).abs() / (SCAN_TOL["atol"]
                             + SCAN_TOL["rtol"] * w.abs())).max())
                  for nm, g, w in zip(names, got, want)}
        cases[what] = dict(errs=errs, tol_shares=shares,
                           zeros_in_w=int((args[3] == 0).sum()))
        del got, again, want
    # training's call (narrow inputs): no ds_fin (s_fin unused), no ds0
    args = layer_scan_inputs(np.random.RandomState(48), b, h, s, n)
    do = torch.tensor(rng.randn(b, s, h, n), dtype=torch.float32,
                      device="cuda").transpose(1, 2)
    train_call = lambda: mod.rwkv6_scan_bwd(*args, do, None, False)
    bms, by, f32_pipe_ms = rwkv6_bwd_bound(b * h, s, n, ds_fin=False,
                                           ds0=False)
    products, mma_flops, fp32_flops, design_bytes = rwkv6_bwd_design(
        b * h, s, n, ds_fin=False, ds0=False)
    design = dict(product_flops=products, tf32_mma_flops=mma_flops,
                  fp32_flops=fp32_flops, bytes=design_bytes,
                  tf32_ms=mma_flops / TF32_FLOPS * 1e3,
                  fp32_ms=fp32_flops / F32_FLOPS * 1e3,
                  bytes_ms=design_bytes / HBM_BYTES_PER_S * 1e3)
    from repro_torch.kernels import build
    lib = build.library("rwkv6_scan_bwd", mod._BWD_SIGNATURES)
    scratch = lib.rwkv6_scan_bwd_scratch(b * h, s, n)
    mmas = mma_count("rwkv6_scan_bwd")
    if not mmas:
        raise AssertionError("rwkv6_scan_bwd: no tensor-core MMA instruction "
                             "in its SASS")
    events = device_events(train_call, 3)
    report["rwkv6_scan_bwd"] = dict(
        name="rwkv6_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:54",    # its gradient
        max_abs_err=max(max(c["errs"].values()) for c in cases.values()),
        cases=cases,
        ms=time_ms(train_call, iters=10, warmup=2),
        device=events, device_ms=device_ms(events),
        plain_ms=time_ms(lambda: mod.plain_bwd(*args, do, None, False),
                         iters=1, warmup=0),
        bound_ms=bms, bound_by=by, f32_pipe_bound_ms=f32_pipe_ms,
        design=design, scratch_bytes=scratch,
        mma_instructions=mmas, first_design_ms=RWKV_BWD_FIRST_DESIGN_MS,
        library_ms=None,      # no single PyTorch call runs this recurrence
        shape=f"r/k/v/w/do (B,H,S,N)={RWKV_TRAIN} head-split views, "
              f"u expanded, float32 (held with s0 and ds_fin nonzero, on "
              f"narrow and wide decays; timed as training calls it: ds_fin "
              f"None, no ds0)")
    r = report["rwkv6_scan_bwd"]
    for what, c in cases.items():
        log(f"rwkv6_scan_bwd vs the plain backward in float64 at "
            f"{RWKV_TRAIN}, {what} decays ({c['zeros_in_w']} exact zeros in "
            f"w): max |err| "
            + ", ".join(f"{nm} {e:.3e}" for nm, e in c["errs"].items())
            + f"; largest share of {SCAN_TOL}: "
            + ", ".join(f"{nm} {x:.3f}" for nm, x in c["tol_shares"].items())
            + "; every output finite; two calls equal bit for bit")
    log(f"rwkv6_scan_bwd: {r['ms']:.4f} ms a call (events; the first "
        f"design's {RWKV_BWD_FIRST_DESIGN_MS} ms), device "
        f"{r['device_ms']:.4f} ms ("
        + ", ".join(f"{short_name(k)} {v['ms']:.4f}"
                    for k, v in events.items())
        + f"), plain {r['plain_ms']:.1f} ms, bound {bms:.4f} ms ({by}; the "
        f"function's operations in 3xTF32 at 495 TFLOP/s, on the float32 "
        f"pipes {f32_pipe_ms:.4f} ms); the "
        f"design's own count: {products / 1e9:.2f} GFLOP of products, "
        f"{mma_flops / 1e9:.2f} GFLOP of TF32 MMAs ({design['tf32_ms']:.4f} "
        f"ms at 495 TFLOP/s), {fp32_flops / 1e9:.2f} GFLOP on the float32 "
        f"pipes ({design['fp32_ms']:.4f} ms), {design_bytes / 1e9:.3f} GB "
        f"({design['bytes_ms']:.4f} ms at 3.35 TB/s); scratch "
        f"{scratch / 1e6:.1f} MB; {mmas} MMA instructions (HMMA/HGMMA) in "
        f"its SASS")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main_path(counters, core, nn2sql, data_mod, result):
    """Drive the pipeline; ``counters`` maps each kernel's name to its
    wrapper, whose ``launches`` count is zeroed here and read after."""
    x, y = data_mod.make_mnist_like(N_ROWS)
    spec = nn2sql.MLPSpec(N_ROWS, N_FEAT, N_HID, N_CLS, lr=LR)
    graph = nn2sql.build_graph(spec)
    w0 = nn2sql.init_weights(spec)

    for fn in counters.values():
        fn.launches = 0
    y_oh = data_mod.one_hot_labels(y, N_CLS)
    runs = {}
    for kind in ("dense", "relational"):
        eng = core.Engine(kind)
        torch.cuda.reset_peak_memory_stats()
        (wf, _), t_train = timed(
            lambda: nn2sql.train(graph, w0, x, y_oh, ITERS, eng))
        peak = torch.cuda.max_memory_allocated()
        probs, t_infer = timed(lambda: nn2sql.infer(graph, eng)(wf, x))
        acc = float(nn2sql.accuracy(probs, y))
        runs[kind] = dict(weights=wf, probs=probs, train_s=t_train,
                          infer_s=t_infer, accuracy=acc, peak_bytes=peak)
    launches = {name: fn.launches for name, fn in counters.items()}

    # launches this path must make: one one-hot transform; per training
    # step 2 fused layers (dense) and 5 relational products (2 forward,
    # Eqs. 8, 10, 11); per inference 2 of each.
    expected = {name: 0 for name in counters} | {
        "onehot_embed": 1, "fused_sigmoid_matmul": 2 * ITERS + 2,
        "relational_matmul": 5 * ITERS + 2}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")

    x_np = x.cpu().numpy().astype(np.float64)
    y_np = y_oh.cpu().numpy().astype(np.float64)
    if not np.array_equal(y_np, np.eye(N_CLS)[y.cpu().numpy()]):
        raise AssertionError("one-hot labels differ from numpy's")
    ref = nn2sql.numpy_train(x_np, y_np, N_HID, ITERS, lr=LR)
    checks = {}
    for kind, run in runs.items():
        if not torch.isfinite(run["probs"]).all() or \
                run["probs"].shape != (N_ROWS, N_CLS):
            raise AssertionError(f"{kind}: probabilities not finite or "
                                 f"shaped {tuple(run['probs'].shape)}")
        for name in ("w_xh", "w_ho"):
            got = run["weights"][name].cpu().numpy().astype(np.float64)
            np.testing.assert_allclose(got, ref[name], **TRAIN_TOL,
                                       err_msg=f"{kind} {name} vs numpy f64")
            checks[f"{kind} {name} vs numpy_train f64"] = float(
                np.abs(got - ref[name]).max())
    for name in ("w_xh", "w_ho"):
        a = runs["dense"]["weights"][name]
        b = runs["relational"]["weights"][name]
        torch.testing.assert_close(a, b, **TRAIN_TOL)
        checks[f"dense vs relational {name}"] = float((a - b).abs().max())
    torch.testing.assert_close(runs["dense"]["probs"],
                               runs["relational"]["probs"], **TRAIN_TOL)
    checks["dense vs relational probs"] = float(
        (runs["dense"]["probs"] - runs["relational"]["probs"]).abs().max())

    result["main_path"] = dict(
        shape=f"{N_ROWS} rows, {N_FEAT}->{N_HID}->{N_CLS}, lr={LR}, "
              f"{ITERS} steps", launches=launches, max_abs_diff=checks,
        tolerance=TRAIN_TOL,
        runs={k: {f: v for f, v in r.items() if f not in ("weights", "probs")}
              for k, r in runs.items()})
    for kind, r in runs.items():
        log(f"main path {kind} on {result['card']}: train {ITERS} steps "
            f"{r['train_s']:.4f} s, infer {r['infer_s']:.4f} s, accuracy "
            f"{r['accuracy']:.4f}, peak device memory "
            f"{r['peak_bytes'] / 2**20:.1f} MiB")
    for what, v in checks.items():
        log(f"  max |diff| {what}: {v:.3e}")
    log(f"main path launches: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 4: where a training step's time goes
# ---------------------------------------------------------------------------

def device_profile(fn, wall_ms: float, what: str, card: str,
                   groups: dict | None = None, cpu: bool = True) -> dict:
    """One run of ``fn`` under torch.profiler (``profiled``): device time
    by kernel name, summed, over ``wall_ms`` (the same work timed without
    the profiler) as the device's busy share; with ``groups`` (label ->
    regular expression on the kernel's name) also each group's device time
    and share of the device time; ``cpu`` as ``profiled`` takes it."""
    by_name, counts = {}, {}
    for e in profiled(fn, cpu=cpu):
        counts[e.name] = counts.get(e.name, 0) + 1
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    n_events = sum(counts.values())
    device = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    log(f"profile {what} on {card}: wall {wall_ms:.4f} ms, device "
        f"{device:.4f} ms in {n_events} events, busy share "
        f"{device / wall_ms:.4f}" if n_events else
        f"profile {what}: wall {wall_ms:.4f} ms; the profiler saw no device "
        "events (device time not measured)")
    for name, ms in top.items():
        log(f"  {ms:9.4f} ms  {name[:100]}")
    flash_ms = sum(ms for name, ms in by_name.items() if "flash" in name)
    flash_bwd_ms = sum(ms for name, ms in by_name.items()
                       if "flash_bwd" in name)
    if flash_ms:
        log(f"  flash_attention kernels: {flash_ms:.4f} ms, "
            f"{flash_ms / device:.4f} of device time")
    if flash_bwd_ms:
        log(f"    of which the backward (flash_bwd_*): {flash_bwd_ms:.4f} "
            f"ms, {flash_bwd_ms / device:.4f} of device time")
    # copies and casts: PyTorch's copy kernels (a type conversion is one)
    # and the runtime's memcpys
    copies = {name: ms for name, ms in by_name.items()
              if "copy" in name.lower()}
    copies_ms = sum(copies.values())
    if n_events:
        log(f"  copies and casts: {copies_ms:.4f} ms in "
            f"{sum(counts[name] for name in copies)} events")
    grouped = {}
    for label, pattern in (groups or {}).items():
        names = [n for n in by_name if re.search(pattern, n)]
        ms = sum(by_name[n] for n in names)
        grouped[label] = dict(ms=ms, share=ms / device if device else 0.0,
                              events=sum(counts[n] for n in names))
        log(f"  {label}: {ms:.4f} ms in {grouped[label]['events']} events, "
            f"{grouped[label]['share']:.4f} of device time")
    return dict(wall_ms=wall_ms, device_ms=device,
                busy_share=device / wall_ms, device_events=n_events,
                top_ms=top, flash_ms=flash_ms, flash_bwd_ms=flash_bwd_ms,
                copies_ms=copies_ms, counts=counts, groups=grouped)


def profile_step(counters, core, nn2sql, data_mod, result):
    """One training step of each engine at full width, after the main path
    (its counts are read already): the step's wall time, then the same step
    under torch.profiler for the device time by kernel name.  The kernels
    run on one stream and never overlap, so their sum over the unprofiled
    wall time is the device's busy share.  Every launch of the engine's
    kernel that its wrapper counts in one step must be among the
    profiler's events of the measured step."""
    x, y = data_mod.make_mnist_like(N_ROWS)
    spec = nn2sql.MLPSpec(N_ROWS, N_FEAT, N_HID, N_CLS, lr=LR)
    graph, w0 = nn2sql.build_graph(spec), nn2sql.init_weights(spec)
    y_oh = data_mod.one_hot_labels(y, N_CLS)
    out = {}
    for kind in ("dense", "relational"):
        eng = core.Engine(kind)
        step = lambda: nn2sql.train(graph, w0, x, y_oh, 1, eng)
        timed(step)
        wall = min(timed(step)[1] for _ in range(5)) * 1e3
        wrapper, kernel = {
            "dense": (counters["fused_sigmoid_matmul"], "sigmoid_matmul"),
            "relational": (counters["relational_matmul"], "_spmm")}[kind]
        before = wrapper.launches
        step()
        per_step = wrapper.launches - before
        out[kind] = device_profile(step, wall, f"{kind} step", result["card"])
        seen = sum(n for name, n in out[kind]["counts"].items()
                   if kernel in name)
        if seen != per_step:
            raise AssertionError(f"profile {kind} step: {seen} {kernel} "
                                 f"events for {per_step} launches a step")
    result["profile"] = out


# ---------------------------------------------------------------------------
# phase 5: the LM serving path on the full-width Yi-6B
# ---------------------------------------------------------------------------

PREFILL_BATCH, PREFILL_LEN = 4, 2000      # 2000: no multiple of any tile
SLOTS, MAX_LEN, REQUESTS, NEW_TOKENS = 4, 256, 8, 16
# (c) prefill vs token-by-token decode, last-token logits of the full-depth
# model, over PVD_PROMPTS prompts of PVD_LEN tokens for each weight seed.
# float32 compute is the binding check: the two paths compute the same
# function, up to sums over k = 4096 and 11008 in another order in each of
# 32 layers.  bf16 is a sanity bound: each block rounds its output to bf16
# (2^-8 relative) at other places on the two paths, and a logit's error is
# the final hidden state's error times the head, absolute, not relative to
# the logit, so the bound is an atol alone.  tests/test_models_smoke.py's
# atol=0.05 was set on 2 layers.  At 32, over the seeds and prompts below,
# an H100 read at most 0.0781 in bf16 and 1.22e-5 in float32 (PERF.md):
# the atols are 1.5 x and about 8 x those readings.
PVD_PROMPTS, PVD_LEN, PVD_SEEDS = 4, 8, (0, 1, 2)
LOGIT_TOL = {"bfloat16": dict(rtol=0.0, atol=0.12),
             "float32": dict(rtol=0.0, atol=1e-4)}


def leaves(tree):
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def serve_path(counters, result):
    """Drive the serving path; every counter is zeroed before (a) and read
    after it, then (b) and (c) are checked for their own launches."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.nn import layers
    from repro_torch.nn.model import LM
    from repro_torch.serving import Request, ServingEngine

    card, flash = result["card"], counters["flash_attention"]
    cfg = get_config("yi_6b")
    lm = LM(cfg)
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    params, t_init = timed(lambda: lm.init(gen))
    n_params = sum(t.numel() for t in leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    log(f"serve: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}: {n_params} parameters, "
        f"{param_bytes / 1e9:.2f} GB float32, made in {t_init:.2f} s")

    # (a) bulk prefill, one flash_attention launch per layer
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN)).astype(np.int32)).to(
            lm.device)
    for fn in counters.values():
        fn.launches = 0
    (logits, cache), t_prefill = timed(
        lambda: lm.prefill(params, {"tokens": tokens}))
    launches = {name: fn.launches for name, fn in counters.items()}
    expected = {name: 0 for name in counters} | {
        "flash_attention": cfg.n_layers}
    if launches != expected:
        raise AssertionError(f"prefill launches {launches}, expected "
                             f"{expected}")
    kv_shape = (cfg.n_layers, PREFILL_BATCH, cfg.n_kv_heads, PREFILL_LEN,
                cfg.d_head)
    if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or \
            not torch.isfinite(logits).all() or \
            any(c.shape != kv_shape for c in cache):
        raise AssertionError(f"prefill gave logits {tuple(logits.shape)}, "
                             f"cache {[tuple(c.shape) for c in cache]}")
    del cache

    # (b) continuous batching, greedy; the decode path launches no kernel
    eng = ServingEngine(lm, params, max_len=MAX_LEN, batch_slots=SLOTS)
    eng.tracer = obs.Tracer()
    for uid in range(REQUESTS):
        eng.submit(Request(uid, rng.randint(0, cfg.vocab, int(
            rng.randint(4, 33))).astype(np.int32), max_new_tokens=NEW_TOKENS))
    done, t_serve = timed(eng.run_to_completion)
    if flash.launches != cfg.n_layers:
        raise AssertionError("the engine's decode path launched "
                             f"{flash.launches - cfg.n_layers} flash kernels")
    if sorted(r.uid for r in done) != list(range(REQUESTS)) or any(
            len(r.generated) != NEW_TOKENS for r in done):
        raise AssertionError("the engine left requests unserved: "
                             f"{[(r.uid, len(r.generated)) for r in done]}")
    n_generated = sum(len(r.generated) for r in done)
    tokens4 = torch.zeros((SLOTS, 1), dtype=torch.int32, device=lm.device)
    step = lambda: lm.decode_step(params, {"tokens": tokens4}, eng.cache, 100)
    timed(step)
    step_ms = min(timed(step)[1] for _ in range(3)) * 1e3

    # (c) prefill (the kernel) vs decode steps (plain attention), weight
    # seed 0 here; seeds 1 and 2 after the profiles
    readings = prefill_vs_decode(lm, params, 0, layers)
    if flash.launches != (1 + len(LOGIT_TOL)) * cfg.n_layers:
        raise AssertionError(f"(c) launched {flash.launches - cfg.n_layers} "
                             f"flash kernels, expected "
                             f"{len(LOGIT_TOL) * cfg.n_layers}")
    peak = torch.cuda.max_memory_allocated()

    prefill = lambda: lm.prefill(params, {"tokens": tokens})
    wall = timed(prefill)[1] * 1e3
    out = dict(
        model=cfg.name, layers=cfg.n_layers, parameters=n_params,
        param_bytes=param_bytes, init_s=t_init,
        prefill=dict(shape=f"{PREFILL_BATCH} x {PREFILL_LEN} tokens",
                     first_s=t_prefill, warm_ms=wall,
                     tokens_per_s=PREFILL_BATCH * PREFILL_LEN / wall * 1e3,
                     launches=launches),
        engine=dict(slots=SLOTS, max_len=MAX_LEN, requests=REQUESTS,
                    new_tokens=NEW_TOKENS, wall_s=t_serve,
                    generated=n_generated,
                    tokens_per_s=n_generated / t_serve,
                    counters=eng.tracer.counters,
                    step_ms=eng.tracer.histograms.get("serve.step_ms")),
        decode_step=dict(slots=SLOTS, ms=step_ms,
                         tokens_per_s=SLOTS / step_ms * 1e3),
        peak_bytes=peak)
    log(f"serve (a) prefill {PREFILL_BATCH} x {PREFILL_LEN} on {card}: first "
        f"call {t_prefill:.4f} s, warm {wall:.4f} ms "
        f"({out['prefill']['tokens_per_s']:.1f} tokens/s), launches "
        f"{launches}")
    log(f"serve (b) engine on {card}: {len(done)} requests, {n_generated} "
        f"tokens in {t_serve:.4f} s ({n_generated / t_serve:.2f} tokens/s), "
        f"counters {eng.tracer.counters}; decode step at {SLOTS} slots "
        f"{step_ms:.4f} ms ({SLOTS / step_ms * 1e3:.2f} tokens/s)")
    log(f"serve peak device memory {peak / 2**30:.2f} GiB")
    out["profile"] = dict(
        prefill=device_profile(prefill, wall, "prefill 4 x 2000", card),
        decode_step=device_profile(step, step_ms, "decode step at 4 slots",
                                   card))

    # (c) for the other weight seeds, each drawn in place of the last
    eng = step = prefill = None
    for seed in PVD_SEEDS[1:]:
        params = None
        torch.cuda.empty_cache()
        params = lm.init(gen.manual_seed(seed))
        readings += prefill_vs_decode(lm, params, seed, layers)
    out["prefill_vs_decode"] = hold_agreement(readings)
    out["attention_impls"] = attention_impls(cfg, params, tokens, flash, card)
    result["serve"] = out
    return launches


# (d) the full-sequence attention options of item 12 on the same prompts
# (the last weight seed's model), in float32: the dense path materialises
# a (4, 4, 8, 2000, 2000) float32 score tensor a layer, 2.05 GB; "chunked"
# takes chunks of 1000, since 2000 is no multiple of auto's 1024 and
# attend_chunked asserts that the chunk divides S.  The flash kernel must
# run once a layer under flash_impl="scan" and never under the other two.
# Each run's last-token logits are read against the model in float64
# (dense attention: no kernel takes float64) and against the flash path's,
# beside a one-ulp nudge of the flash path's embeddings.  Held: the flash
# path, "dense" and "chunked" within (c)'s float32 atol of float64, "scan"
# equal to the flash path bit for bit (the same kernel on the same
# operands).  The float32 kernel once read 1.260e-4 here, where the dense
# float32 path reads 2.203e-5: its P.V accumulator, carried through every
# key tile's wgmmas, shrank under the tensor cores' truncation; each
# tile's P.V is now summed apart (csrc/flash_attention.cu, PERF.md).
ATTN_IMPLS = {"dense": dict(attn_impl="dense"),
              "chunked": dict(attn_impl="chunked", attn_chunk=1000),
              "scan": dict(flash_impl="scan")}


def attention_impls(cfg, params, tokens, flash, card) -> dict:
    """(d) ``LM.prefill`` in float32 under the flash path and each of
    ATTN_IMPLS, then in float64: the last-token logits of each against the
    flash path's and the float64 ones, the flash launches, the wall of one
    call and the peak memory.  Consumes ``params``: its leaves are raised
    to float64 in place for the reference."""
    from repro_torch.nn import layers
    from repro_torch.nn.model import LM

    runs = {"flash": {}} | ATTN_IMPLS
    compute, accum = layers.COMPUTE_DTYPE, layers.ACCUM_DTYPE
    got = {}

    def prefill(name, change, batch):
        lm = LM(dataclasses.replace(cfg, **change))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = flash.launches
        (logits, _), wall = timed(lambda: lm.prefill(params, batch))
        got[name] = dict(logits=logits[:, 0].double(), wall_s=wall,
                         launches=flash.launches - before,
                         peak_bytes=torch.cuda.max_memory_allocated())

    layers.COMPUTE_DTYPE = torch.float32
    try:
        for name, change in runs.items():
            prefill(name, change, {"tokens": tokens})
        x = LM(cfg).embed_inputs(params, {"tokens": tokens})
        sign = torch.randint(0, 2, x.shape, device=x.device,
                             generator=torch.Generator(
                                 device=x.device).manual_seed(0))
        x = x * (1.0 + torch.finfo(x.dtype).eps * (2.0 * sign - 1.0))
        prefill("flash, nudged", {}, {"embeds": x})
        del x, sign
        stack = [params]
        while stack:
            tree = stack.pop()
            for k, v in tree.items():
                if isinstance(v, dict):
                    stack.append(v)
                else:
                    tree[k] = v.double()
        layers.COMPUTE_DTYPE = layers.ACCUM_DTYPE = torch.float64
        prefill("float64", dict(attn_impl="dense"), {"tokens": tokens})
    finally:
        layers.COMPUTE_DTYPE, layers.ACCUM_DTYPE = compute, accum
    want, exact = got["flash"]["logits"], got["float64"]["logits"]
    expected = {"flash": cfg.n_layers, "scan": cfg.n_layers, "dense": 0,
                "chunked": 0, "flash, nudged": cfg.n_layers, "float64": 0}
    out = {}
    for name, rec in got.items():
        logits = rec.pop("logits")
        rec["to_flash"] = float((logits - want).abs().max())
        rec["to_float64"] = float((logits - exact).abs().max())
        out[name] = rec
        log(f"serve (d) prefill {PREFILL_BATCH} x {PREFILL_LEN} under "
            f"{name} {runs.get(name, '')} on {card}: {rec['wall_s']:.4f} s, "
            f"peak {rec['peak_bytes'] / 2**30:.2f} GiB, {rec['launches']} "
            f"flash launches; last-token logits {rec['to_flash']:.3e} from "
            f"the flash path's, {rec['to_float64']:.3e} from float64's")
        if not torch.isfinite(logits).all() or \
                rec["launches"] != expected[name]:
            raise AssertionError(f"serve (d) {name}: {rec['launches']} flash "
                                 f"launches (expected {expected[name]}) or "
                                 "logits not finite")
        if name in ("flash", "dense", "chunked"):
            torch.testing.assert_close(
                logits, exact, **LOGIT_TOL["float32"],
                msg=lambda m: f"serve (d) {name} against float64: {m}")
        if name == "scan" and rec["to_flash"]:
            raise AssertionError("serve (d) scan: not the flash path's "
                                 "logits bit for bit")
    return out


#: ``--flash-margin``: the float32 flash kernel's arithmetic emulated
#: (``ref.flash_attention_emulated``) with one source of error changed at a
#: time, in place of the kernel on (d)'s prefill; "O carried" is the design
#: before each tile's P.V was summed apart (the wgmma accumulator carried
#: through every tile).
FLASH_MARGIN = {
    "the kernel": {},
    "O carried through all tiles": dict(pv_tile=False),
    "O carried, no TF32 split": dict(pv_tile=False, parts=0),
    "O carried, 3 parts, 6 products": dict(pv_tile=False, parts=3),
    "O carried, softmax in float64": dict(pv_tile=False,
                                          softmax_dtype=torch.float64),
    "O carried, accumulation to nearest": dict(
        pv_tile=False, s_round="nearest", pv_round="nearest"),
    "O carried, S to nearest": dict(pv_tile=False, s_round="nearest"),
    "O carried, P.V to nearest": dict(pv_tile=False, pv_round="nearest"),
    "S's small products apart": dict(s_apart=True),
    "small products apart": dict(s_apart=True, pv_apart=True),
}


def flash_margin(card, names) -> dict:
    """K13: where the float32 flash path's distance from float64 at (d)'s
    depth comes from.  On one layer's operands at Yi-6B's prefill shape,
    the kernel and each emulation against the plain version in float64
    (the largest error and the mean error along the sign of the exact
    value: a shrink reads negative); then (d)'s prefill (Yi-6B, 32 layers,
    4 x 2000 tokens, the last weight seed) in float32 through the kernel,
    the dense path and each emulation, and in float64: each run's
    last-token logits against float64's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.nn import layers
    from repro_torch.nn.model import LM

    runs = {n: FLASH_MARGIN[n] for n in names or FLASH_MARGIN}
    out = {"card": card, "operands": {}, "prefill": {}}
    cfg = get_config("yi_6b")
    lm = LM(cfg)
    rng = np.random.RandomState(0)
    b, hq, hkv, s, d = FLASH_MAIN
    q = torch.tensor(rng.randn(b, hq, s, d), dtype=torch.float32,
                     device=lm.device)
    k, v = (torch.tensor(rng.randn(b, hkv, s, d), dtype=torch.float32,
                         device=lm.device) for _ in range(2))
    exact = ref.flash_attention(q.double(), k.double(), v.double())

    def read(what, got):
        err = got.double() - exact
        rec = dict(max_abs_err=float(err.abs().max()),
                   shrink=float((err * exact.sign()).mean()
                                / exact.abs().mean()))
        out["operands"][what] = rec
        log(f"flash margin, one layer {FLASH_MAIN} on {card}: {what}: max "
            f"|err| {rec['max_abs_err']:.3e}, mean signed error "
            f"{rec['shrink']:+.3e} of the mean |value|")
        return got

    kernel = read("kernel", flash_mod.flash_attention(q, k, v))
    read("plain float32", ref.flash_attention(q, k, v))
    for name, kw in runs.items():
        out["operands"][name]["to_kernel"] = float((read(
            name, ref.flash_attention_emulated(q, k, v, **kw)) - kernel
        ).abs().max())
    del q, k, v, exact, kernel

    params = lm.init(torch.Generator(device=lm.device).manual_seed(
        PVD_SEEDS[-1]))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN)).astype(np.int32)).to(
            lm.device)
    compute, accum, kernel = (layers.COMPUTE_DTYPE, layers.ACCUM_DTYPE,
                              ops.flash_attention)
    got = {}

    def prefill(name, change=None):
        torch.cuda.empty_cache()
        lm_run = LM(dataclasses.replace(cfg, **(change or {})))
        (logits, _), wall = timed(lambda: lm_run.prefill(
            params, {"tokens": tokens}))
        got[name] = (logits[:, 0].double(), wall)

    layers.COMPUTE_DTYPE = torch.float32
    try:
        prefill("flash")
        prefill("dense", dict(attn_impl="dense"))
        for name, kw in runs.items():
            ops.flash_attention = (
                lambda q, k, v, causal=True, scale=None, bf16_scores=False,
                kw=kw: ref.flash_attention_emulated(q, k, v, causal, scale,
                                                    **kw))
            prefill(name)
            ops.flash_attention = kernel
        stack = [params]
        while stack:
            node = stack.pop()
            for key, val in node.items():
                if isinstance(val, dict):
                    stack.append(val)
                else:
                    node[key] = val.double()
        layers.COMPUTE_DTYPE = layers.ACCUM_DTYPE = torch.float64
        prefill("float64", dict(attn_impl="dense"))
    finally:
        layers.COMPUTE_DTYPE, layers.ACCUM_DTYPE = compute, accum
        ops.flash_attention = kernel
    want = got.pop("float64")[0]
    for name, (logits, wall) in got.items():
        dist = float((logits - want).abs().max())
        out["prefill"][name] = dict(to_float64=dist, wall_s=wall)
        log(f"flash margin, prefill {PREFILL_BATCH} x {PREFILL_LEN}, "
            f"{cfg.n_layers} layers, float32 on {card}: {name}: last-token "
            f"logits {dist:.3e} from float64's ({wall:.1f} s)")
    return out


def prefill_vs_decode(lm, params, seed: int, layers, logit_tol=LOGIT_TOL,
                      depth: int | None = None, ulp: bool = False
                      ) -> list[dict]:
    """PVD_PROMPTS prompts of PVD_LEN tokens through ``prefill`` and
    through PVD_LEN ``decode_step``s, in each compute type of
    ``logit_tol``: one reading per prompt.  ``depth`` cuts the model to its
    first layers (the weights are views of the full model's).  A type whose
    tolerance is None is a smoke run: its logits need only be finite.
    ``ulp`` adds one more prefill, each of its embeddings scaled by 1 ± the
    compute type's epsilon at random (about one ulp), and reads how far
    that moves the logits: what rounding alone does at this depth."""
    if depth is not None:
        cut = dict(n_layers=depth)
        if lm.cfg.shared_attn_every:    # one segment: the shared block first
            cut["shared_attn_every"] = min(lm.cfg.shared_attn_every, depth)
        lm = type(lm)(dataclasses.replace(lm.cfg, **cut), device=lm.device)
        n_dense = lm.cfg.moe.first_k_dense if lm.cfg.moe else 0
        params = dict(params, layers=slice_layers(params["layers"], 0,
                                                  depth - n_dense))
    toks = pvd_tokens(lm, seed)
    readings = []
    for dtype, tol in logit_tol.items():
        layers.COMPUTE_DTYPE = getattr(torch, dtype)
        try:
            logits_p, _ = lm.prefill(params, {"tokens": toks})
            kv = lm.init_cache(PVD_PROMPTS, 2 * PVD_LEN)
            for t in range(PVD_LEN):
                logits_d, kv = lm.decode_step(
                    params, {"tokens": toks[:, t:t + 1]}, kv, t)
            if ulp:
                x = lm.embed_inputs(params, {"tokens": toks})
                sign = torch.randint(0, 2, x.shape, device=x.device,
                                     generator=torch.Generator(
                                         device=x.device).manual_seed(seed))
                nudge = torch.finfo(x.dtype).eps * (2.0 * sign - 1.0)
                x = (x.float() * (1.0 + nudge)).to(x.dtype)
                logits_u = lm.prefill(params, {"embeds": x})[0][:, 0].float()
        finally:
            layers.COMPUTE_DTYPE = torch.bfloat16
        lp, ld = logits_p[:, 0].float(), logits_d[:, 0].float()
        held = torch.isfinite(lp).all(-1) & torch.isfinite(ld).all(-1)
        if tol is not None:
            held &= ((lp - ld).abs()
                     <= tol["atol"] + tol["rtol"] * ld.abs()).all(-1)
        top2 = lp.topk(2, dim=-1).values
        for i in range(PVD_PROMPTS):
            readings.append(dict(
                dtype=dtype, seed=seed, prompt=i, layers=lm.cfg.n_layers,
                max_abs_diff=float((lp[i] - ld[i]).abs().max()),
                logit_abs_max=float(lp[i].abs().max()),
                top1_margin=float(top2[i, 0] - top2[i, 1]),
                argmax=(int(lp[i].argmax()), int(ld[i].argmax())),
                held=bool(held[i]))
                | ({"ulp_abs_diff": float((logits_u[i] - lp[i]).abs().max())}
                   if ulp else {}))
    return readings


def pvd_tokens(lm, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(7 + seed).randint(
        0, lm.cfg.vocab, (PVD_PROMPTS, PVD_LEN)).astype(np.int32)).to(
            lm.device)


def slice_layers(tree, lo: int, hi: int):
    return {k: slice_layers(v, lo, hi) if isinstance(v, dict) else v[lo:hi]
            for k, v in tree.items()}


def hold_agreement(readings: list[dict], logit_tol=LOGIT_TOL,
                   what: str = "serve") -> dict:
    """Print every reading of (c), then fail if one is past ``logit_tol``
    (or, where a type's tolerance is None, not finite) or the two paths
    pick another next token where the top-1 margin exceeds their
    difference."""
    out = {}
    for dtype, tol in logit_tol.items():
        rs = [r for r in readings if r["dtype"] == dtype]
        for r in rs:
            ulp = (f", one-ulp input nudge moves them {r['ulp_abs_diff']:.4e}"
                   if "ulp_abs_diff" in r else "")
            log(f"{what} (c) {dtype} seed {r['seed']} prompt {r['prompt']}: "
                f"prefill vs decode max |diff| {r['max_abs_diff']:.4e} "
                f"(|logit| up to {r['logit_abs_max']:.4f}), top-1 margin "
                f"{r['top1_margin']:.4e}, argmax {r['argmax'][0]} vs "
                f"{r['argmax'][1]}{ulp}")
        worst = max(r["max_abs_diff"] for r in rs)
        log(f"{what} (c) {dtype}: largest |diff| over {len(rs)} prompts "
            f"{worst:.4e}, " + (f"held at {tol}" if tol is not None else
                                "a smoke run: finite, no tolerance"))
        out[dtype] = dict(tolerance=tol, largest_abs_diff=worst, readings=rs)
    for r in readings:
        if not r["held"]:
            raise AssertionError(f"{what} (c) past {logit_tol[r['dtype']]}: "
                                 f"{r}")
        if r["top1_margin"] > r["max_abs_diff"] and \
                r["argmax"][0] != r["argmax"][1]:
            raise AssertionError(f"{what} (c) prefill and decode disagree "
                                 f"on the next token: {r}")
    return out


# ---------------------------------------------------------------------------
# phase 6: the serving path on the full-width RWKV-6 7B
# ---------------------------------------------------------------------------

# (c) on RWKV-6: both paths run the rwkv6_scan kernel, the decode path one
# token a call with the state carried in the cache.  Over 32 layers the
# random full-width model amplifies rounding differences (the two paths'
# products have other shapes, so cuBLAS sums in another order) by orders of
# magnitude, so three readings per weight seed:
#   - end to end on the first RWKV_BIND_DEPTH layers, held at
#     RWKV_LOGIT_TOL;
#   - every one of the 32 layers alone (``rwkv_layerwise``): each gets the
#     same input on both paths, so rounding does not compound, held at
#     RWKV_LAYER_TOL;
#   - end to end at the full depth, a smoke run (finite logits), read
#     beside the spread that a one-ulp nudge of the embeddings makes there.
# float32 binds; bf16 is a sanity bound.  An NVIDIA H100 80GB HBM3 at
# 700.00 W read, over 3 weight seeds x 4 prompts (PERF.md): at 2 layers at
# most 1.955e-5 in float32 and 0.0352 in bf16.  The float32 atol is 1e-4,
# about 5 x its reading (Yi-6B's too); the bf16 one 1.5 x, rounded up.
RWKV_BIND_DEPTH = 2
RWKV_LOGIT_TOL = {"bfloat16": dict(rtol=0.0, atol=0.06),
                  "float32": dict(rtol=0.0, atol=1e-4)}
RWKV_SMOKE_TOL = {"bfloat16": None, "float32": None}
# layer by layer: the one-layer model's last-token logits (absolute, as
# above) and its states (relative to each state's largest value).  Set
# before the first reading; the same card then read, over 3 x 32 layers, at
# most 9.239e-6 and 1.618e-6 in float32 (about 11 x and 6 x below their
# bounds) and 0.03125 and 4.274e-3 in bf16.
RWKV_LAYER_TOL = {"bfloat16": dict(logits=0.06, state=0.05),
                  "float32": dict(logits=1e-4, state=1e-5)}


def rwkv_layerwise(lm, params, seed: int, layers) -> list[dict]:
    """Every layer of the full depth alone, in each compute type of
    RWKV_LAYER_TOL.  Layer i's input is the residual stream that the
    prefill path hands it for PVD_PROMPTS prompts of PVD_LEN tokens; a
    one-layer model on layer i's weights runs ``prefill`` on it, and
    PVD_LEN ``decode_step``s on its positions one by one, from zero states.
    One reading per layer: the last-token logits' largest difference, and
    the states' (x_prev, S, cm_prev) largest difference over their largest
    value."""
    one = type(lm)(dataclasses.replace(lm.cfg, n_layers=1), device=lm.device)
    toks = pvd_tokens(lm, seed)
    readings = []
    for dtype in RWKV_LAYER_TOL:
        layers.COMPUTE_DTYPE = getattr(torch, dtype)
        try:
            x = lm.embed_inputs(params, {"tokens": toks})
            for i in range(lm.cfg.n_layers):
                p = dict(params, layers=slice_layers(params["layers"], i,
                                                     i + 1))
                logits_p, cache_p = one.prefill(p, {"embeds": x})
                cache = one.init_cache(PVD_PROMPTS, PVD_LEN)
                for t in range(PVD_LEN):
                    logits_d, cache = one.decode_step(
                        p, {"embeds": x[:, t:t + 1]}, cache, t)
                state = max(float((a - b).abs().max()
                                  / a.abs().max().clamp_min(1e-30))
                            for a, b in zip(cache_leaves(cache_p),
                                            cache_leaves(cache)))
                lp, ld = logits_p.float(), logits_d.float()
                readings.append(dict(
                    dtype=dtype, seed=seed, layer=i,
                    logits=float((lp - ld).abs().max()),
                    logit_abs_max=float(lp.abs().max()), state=state,
                    finite=bool(torch.isfinite(lp).all()
                                and torch.isfinite(ld).all())))
                x = one.backbone(p, {"embeds": x})[0]
        finally:
            layers.COMPUTE_DTYPE = torch.bfloat16
    return readings


def cache_leaves(tree):
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in cache_leaves(t)]
    return [tree]


def hold_layerwise(readings: list[dict]) -> dict:
    """Print the worst layer of each weight seed and type, then fail if a
    reading is past RWKV_LAYER_TOL or not finite."""
    out = {}
    for dtype, tol in RWKV_LAYER_TOL.items():
        rs = [r for r in readings if r["dtype"] == dtype]
        for seed in sorted({r["seed"] for r in rs}):
            mine = [r for r in rs if r["seed"] == seed]
            wl = max(mine, key=lambda r: r["logits"])
            ws = max(mine, key=lambda r: r["state"])
            log(f"rwkv (c) layer by layer, {dtype} seed {seed}, "
                f"{len(mine)} layers: logits max |diff| {wl['logits']:.4e} "
                f"(layer {wl['layer']}, |logit| up to "
                f"{wl['logit_abs_max']:.4f}), states max relative diff "
                f"{ws['state']:.4e} (layer {ws['layer']})")
        worst = {k: max(r[k] for r in rs) for k in ("logits", "state")}
        log(f"rwkv (c) layer by layer, {dtype}: largest over {len(rs)} "
            f"layer readings {worst}, held at {tol}")
        out[dtype] = dict(tolerance=tol, largest=worst, readings=rs)
    for r in readings:
        tol = RWKV_LAYER_TOL[r["dtype"]]
        if not r["finite"] or r["logits"] > tol["logits"] or \
                r["state"] > tol["state"]:
            raise AssertionError(f"rwkv (c) layer by layer past {tol}: {r}")
    return out


def serve_rwkv(counters, result):
    """Drive the RWKV-6 serving path; every counter is zeroed before (a)
    and read after it, then (b) and (c) are checked for their own rwkv6_scan
    launches."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.nn import layers
    from repro_torch.nn.model import LM
    from repro_torch.serving import Request, ServingEngine

    card, scan = result["card"], counters["rwkv6_scan"]
    cfg = get_config("rwkv6_7b")
    lm = LM(cfg)
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, t_init = timed(lambda: lm.init(gen))
    n_params = sum(t.numel() for t in leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    log(f"rwkv: {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model // cfg.ssm.head_dim} heads of {cfg.ssm.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n_params} parameters, "
        f"{param_bytes / 1e9:.2f} GB float32, made in {t_init:.2f} s")

    # (a) bulk prefill, one rwkv6_scan launch per layer and no other kernel
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN)).astype(np.int32)).to(
            lm.device)
    for fn in counters.values():
        fn.launches = 0
    (logits, cache), t_prefill = timed(
        lambda: lm.prefill(params, {"tokens": tokens}))
    launches = {name: fn.launches for name, fn in counters.items()}
    expected = {name: 0 for name in counters} | {"rwkv6_scan": cfg.n_layers}
    if launches != expected:
        raise AssertionError(f"rwkv prefill launches {launches}, expected "
                             f"{expected}")
    shapes = lambda c: [(tuple(t.shape), t.dtype) for t in
                        (c[0][0], c[0][1], c[1])]
    want = shapes(lm.init_cache(PREFILL_BATCH, PREFILL_LEN))
    if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or \
            not torch.isfinite(logits).all() or shapes(cache) != want or \
            not all(torch.isfinite(t).all() for t in
                    (cache[0][0], cache[0][1], cache[1])):
        raise AssertionError(f"rwkv prefill gave logits "
                             f"{tuple(logits.shape)}, cache {shapes(cache)}, "
                             f"expected {want}")
    del cache

    # (b) continuous batching, greedy: every decode_step call (admission
    # and decoding alike) runs the kernel once per layer
    eng = ServingEngine(lm, params, max_len=MAX_LEN, batch_slots=SLOTS)
    eng.tracer = obs.Tracer()
    for uid in range(REQUESTS):
        eng.submit(Request(uid, rng.randint(0, cfg.vocab, int(
            rng.randint(4, 33))).astype(np.int32), max_new_tokens=NEW_TOKENS))
    done, t_serve = timed(eng.run_to_completion)
    calls = (eng.tracer.counters["serve.prefill_tokens"]
             + eng.tracer.histograms["serve.step_ms"]["count"])
    if scan.launches != cfg.n_layers * (1 + calls):
        raise AssertionError(f"the engine made {calls} decode_step calls "
                             f"and {scan.launches - cfg.n_layers} rwkv6_scan "
                             "launches")
    if sorted(r.uid for r in done) != list(range(REQUESTS)) or any(
            len(r.generated) != NEW_TOKENS for r in done):
        raise AssertionError("the engine left requests unserved: "
                             f"{[(r.uid, len(r.generated)) for r in done]}")
    n_generated = sum(len(r.generated) for r in done)
    tokens4 = torch.zeros((SLOTS, 1), dtype=torch.int32, device=lm.device)
    step = lambda: lm.decode_step(params, {"tokens": tokens4}, eng.cache, 0)
    timed(step)
    step_ms = min(timed(step)[1] for _ in range(3)) * 1e3

    # (c) prefill vs decode at RWKV_BIND_DEPTH layers, layer by layer and
    # at the full depth, weight seed 0 here; seeds 1 and 2 after the
    # profiles
    def pvd(seed):
        return dict(
            bind=prefill_vs_decode(lm, params, seed, layers, RWKV_LOGIT_TOL,
                                   RWKV_BIND_DEPTH),
            layerwise=rwkv_layerwise(lm, params, seed, layers),
            smoke=prefill_vs_decode(lm, params, seed, layers, RWKV_SMOKE_TOL,
                                    ulp=True))

    before = scan.launches
    readings = pvd(0)
    # (1 + PVD_LEN) calls a layer per type at RWKV_BIND_DEPTH and at full
    # depth, with one more prefill there; layer by layer, (2 + PVD_LEN)
    # calls (backbone, prefill, decode steps) of one layer
    want = (len(RWKV_LOGIT_TOL) * (1 + PVD_LEN) * RWKV_BIND_DEPTH
            + (len(RWKV_SMOKE_TOL) + len(RWKV_LAYER_TOL)) * (2 + PVD_LEN)
            * cfg.n_layers)
    if scan.launches - before != want:
        raise AssertionError(f"rwkv (c) launched {scan.launches - before} "
                             f"rwkv6_scan kernels, expected {want}")
    peak = torch.cuda.max_memory_allocated()

    prefill = lambda: lm.prefill(params, {"tokens": tokens})
    wall = timed(prefill)[1] * 1e3
    out = dict(
        model=cfg.name, layers=cfg.n_layers, parameters=n_params,
        param_bytes=param_bytes, init_s=t_init,
        prefill=dict(shape=f"{PREFILL_BATCH} x {PREFILL_LEN} tokens",
                     first_s=t_prefill, warm_ms=wall,
                     tokens_per_s=PREFILL_BATCH * PREFILL_LEN / wall * 1e3,
                     launches=launches),
        engine=dict(slots=SLOTS, requests=REQUESTS, new_tokens=NEW_TOKENS,
                    wall_s=t_serve, generated=n_generated,
                    decode_step_calls=calls,
                    tokens_per_s=n_generated / t_serve,
                    counters=eng.tracer.counters,
                    step_ms=eng.tracer.histograms.get("serve.step_ms")),
        decode_step=dict(slots=SLOTS, ms=step_ms,
                         tokens_per_s=SLOTS / step_ms * 1e3),
        peak_bytes=peak)
    log(f"rwkv (a) prefill {PREFILL_BATCH} x {PREFILL_LEN} on {card}: first "
        f"call {t_prefill:.4f} s, warm {wall:.4f} ms "
        f"({out['prefill']['tokens_per_s']:.1f} tokens/s), launches "
        f"{launches}")
    log(f"rwkv (b) engine on {card}: {len(done)} requests, {n_generated} "
        f"tokens in {t_serve:.4f} s ({n_generated / t_serve:.2f} tokens/s), "
        f"{calls} decode_step calls, counters {eng.tracer.counters}; decode "
        f"step at {SLOTS} slots {step_ms:.4f} ms "
        f"({SLOTS / step_ms * 1e3:.2f} tokens/s)")
    log(f"rwkv peak device memory {peak / 2**30:.2f} GiB")
    out["profile"] = dict(
        prefill=device_profile(prefill, wall, "rwkv prefill 4 x 2000", card),
        decode_step=device_profile(step, step_ms,
                                   "rwkv decode step at 4 slots", card))

    eng = step = prefill = None
    for seed in PVD_SEEDS[1:]:
        params = None
        torch.cuda.empty_cache()
        params = lm.init(gen.manual_seed(seed))
        more = pvd(seed)
        readings = {k: v + more[k] for k, v in readings.items()}
    out["prefill_vs_decode"] = dict(
        bind=hold_agreement(readings["bind"], RWKV_LOGIT_TOL,
                            f"rwkv {RWKV_BIND_DEPTH} layers"),
        smoke=hold_agreement(readings["smoke"], RWKV_SMOKE_TOL,
                             f"rwkv {cfg.n_layers} layers"),
        layerwise=hold_layerwise(readings["layerwise"]))
    result["rwkv"] = out
    return launches


# ---------------------------------------------------------------------------
# phase 7: the serving path on the full-width DeepSeek-V2-Lite
# ---------------------------------------------------------------------------

# (c) on DeepSeek-V2-Lite, as phase 6 reads RWKV-6: end to end on the first
# DS_BIND_DEPTH layers (the dense prologue layer and the first MoE layer),
# each of the 27 layers alone on the input the prefill path gives it, and
# the full depth as a smoke run beside a one-ulp nudge.  float32 binds, at
# Yi-6B's and RWKV-6's atol; bf16 is a sanity bound (1 / 4 of the random
# model's logits' spread, about 1), set before the first reading.  The
# layer-by-layer caches (c_kv, k_rope) are compared relative to their
# largest value, as RWKV-6's states are.
DS_BIND_DEPTH = 2
DS_LOGIT_TOL = {"bfloat16": dict(rtol=0.0, atol=0.25),
                "float32": dict(rtol=0.0, atol=1e-4)}
DS_SMOKE_TOL = {"bfloat16": None, "float32": None}
DS_LAYER_TOL = {"bfloat16": dict(logits=0.25, state=0.05),
                "float32": dict(logits=1e-4, state=1e-5)}
MOE_IMPL_TOL = dict(rtol=2e-3, atol=2e-4)      # tests/test_moe.py
# jax.eval_shape(repro.nn.model.LM(CONFIG).init, ...) of
# configs/deepseek_v2_lite_16b.py, counted leaf by leaf
DS_PARAMS = 15_706_484_224


class RouteLog:
    """Records every routing call of ``nn/moe.py`` while active: each
    token's router probabilities (float32, recomputed as ``_route`` does),
    its chosen experts, and the assignments the call's capacity drops."""

    def __init__(self, moe):
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.route = route = self.moe._route

        def logged(p, x, cfg):
            gates, idx, aux = route(p, x, cfg)
            probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
            counts = torch.nn.functional.one_hot(
                idx.reshape(idx.shape[0], -1), cfg.n_experts).sum(1)
            cap = self.moe._capacity(x.shape[-2], cfg)
            self.calls.append(dict(
                probs=probs.reshape(-1, cfg.n_experts),
                idx=idx.reshape(-1, cfg.top_k).sort(-1).values,
                drops=int((counts - cap).clamp(min=0).sum())))
            return gates, idx, aux

        self.moe._route = logged
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route


def routing_flips(prefill_calls, decode_calls, n_moe, what) -> list[dict]:
    """Pair the prefill's routing of token (b, t) in MoE layer l with the
    t-th decode step's (prefill rows b·S + t, decode rows b), and report
    every token whose chosen experts differ: the margin between its k-th
    and (k+1)-th probability on the prefill path, and the largest
    difference of its probabilities between the paths, delta.  The paths
    can choose differently only where margin <= 2·delta; a flip above
    that is a fault."""
    flips = []
    for layer in range(n_moe):
        pre = prefill_calls[layer]
        for t in range(PVD_LEN):
            dec = decode_calls[t * n_moe + layer]
            rows = torch.arange(PVD_PROMPTS, device=dec["idx"].device)
            pi, pp = pre["idx"][rows * PVD_LEN + t], \
                pre["probs"][rows * PVD_LEN + t]
            differ = (pi != dec["idx"]).any(-1)
            for b in differ.nonzero().flatten().tolist():
                k = pi.shape[-1]
                top = pp[b].topk(k + 1).values
                flip = dict(what=what, layer=layer, prompt=b, position=t,
                            margin=float(top[k - 1] - top[k]),
                            delta=float((pp[b] - dec["probs"][b]).abs().max()),
                            prefill=pi[b].tolist(),
                            decode=dec["idx"][b].tolist())
                log(f"deepseek (c) routing differs, {what}: MoE layer "
                    f"{layer}, prompt {b}, position {t}: experts "
                    f"{flip['prefill']} vs {flip['decode']}, margin "
                    f"{flip['margin']:.4e}, delta {flip['delta']:.4e}")
                if flip["margin"] > 2 * flip["delta"]:
                    raise AssertionError(f"routing flip above the rounding: "
                                         f"{flip}")
                flips.append(flip)
    return flips


def waive_last_token_flips(readings, flips, last_moe_layer):
    """A reading whose last token's experts differ in the model's last MoE
    layer (by a near-tie, routing_flips has checked that) compares two
    different mixtures of experts: it is reported, and not held to the
    tolerance."""
    for f in flips:
        if f["layer"] == last_moe_layer and f["position"] == PVD_LEN - 1:
            for r in readings:
                if r["prompt"] == f["prompt"] and not r["held"]:
                    r["held"], r["waived"] = True, f


def deepseek_pvd(lm, params, seed, layers, moe, logit_tol, depth=None,
                 ulp=False):
    """prefill_vs_decode on DeepSeek-V2-Lite, one compute type at a time,
    with its routing logged and every flip reported."""
    cfg = lm.cfg
    n_moe = (depth or cfg.n_layers) - cfg.moe.first_k_dense
    readings, flips = [], []
    for dtype, tol in logit_tol.items():
        with RouteLog(moe) as rl:
            rs = prefill_vs_decode(lm, params, seed, layers, {dtype: tol},
                                   depth, ulp)
        what = f"{dtype} seed {seed}, {depth or cfg.n_layers} layers"
        fl = routing_flips(rl.calls[:n_moe],
                           rl.calls[n_moe:(1 + PVD_LEN) * n_moe], n_moe, what)
        if tol is not None:
            waive_last_token_flips(rs, fl, n_moe - 1)
        readings += rs
        flips += fl
    return readings, flips


def deepseek_layerwise(lm, params, seed, layers, moe):
    """Every layer of the full depth alone, as rwkv_layerwise reads RWKV-6:
    layer i's input is the residual stream the prefill path hands it; a
    one-layer model on layer i's weights (the prologue's dense layer runs
    as a one-layer stack with its SwiGLU) runs ``prefill`` on it and
    PVD_LEN ``decode_step``s.  One reading per layer: the last-token
    logits' largest difference, the caches' (c_kv, k_rope) over their
    largest value, and the routing flips."""
    n_dense = lm.cfg.moe.first_k_dense
    one = type(lm)(dataclasses.replace(
        lm.cfg, n_layers=1, moe=dataclasses.replace(lm.cfg.moe,
                                                    first_k_dense=0)),
        device=lm.device)
    toks = pvd_tokens(lm, seed)
    readings, flips = [], []
    for dtype in DS_LAYER_TOL:
        layers.COMPUTE_DTYPE = getattr(torch, dtype)
        try:
            x = lm.embed_inputs(params, {"tokens": toks})
            for i in range(lm.cfg.n_layers):
                stack, j = (("prologue", i) if i < n_dense
                            else ("layers", i - n_dense))
                p = {k: v for k, v in params.items() if k != "prologue"}
                p["layers"] = slice_layers(params[stack], j, j + 1)
                with RouteLog(moe) as rl:
                    logits_p, cache_p = one.prefill(p, {"embeds": x})
                    cache = one.init_cache(PVD_PROMPTS, PVD_LEN)
                    for t in range(PVD_LEN):
                        logits_d, cache = one.decode_step(
                            p, {"embeds": x[:, t:t + 1]}, cache, t)
                n_moe = int(stack == "layers")
                fl = routing_flips(rl.calls[:n_moe], rl.calls[n_moe:], n_moe,
                                   f"{dtype} seed {seed}, layer {i} alone")
                state = max(float((a - b).abs().max()
                                  / a.abs().max().clamp_min(1e-30))
                            for a, b in zip(cache_leaves(cache_p),
                                            cache_leaves(cache)))
                lp, ld = logits_p.float(), logits_d.float()
                last = [f for f in fl if f["position"] == PVD_LEN - 1]
                kept = [b for b in range(PVD_PROMPTS)
                        if b not in {f["prompt"] for f in last}]
                readings.append(dict(
                    dtype=dtype, seed=seed, layer=i,
                    logits=float((lp - ld).abs().max()),
                    logits_unflipped=float((lp[kept] - ld[kept]).abs().max())
                    if kept else 0.0,
                    logit_abs_max=float(lp.abs().max()), state=state,
                    flips=len(fl), last_token_flips=len(last),
                    finite=bool(torch.isfinite(lp).all()
                                and torch.isfinite(ld).all())))
                flips += fl
                x = one.backbone(p, {"embeds": x})[0]
        finally:
            layers.COMPUTE_DTYPE = torch.bfloat16
    return readings, flips


def hold_deepseek_layerwise(readings: list[dict]) -> dict:
    """Print the worst layer of each weight seed and type, then fail if a
    reading is past DS_LAYER_TOL (the logits of prompts whose last token
    kept its experts; the caches, which the routing does not touch) or not
    finite."""
    out = {}
    for dtype, tol in DS_LAYER_TOL.items():
        rs = [r for r in readings if r["dtype"] == dtype]
        for seed in sorted({r["seed"] for r in rs}):
            mine = [r for r in rs if r["seed"] == seed]
            wl = max(mine, key=lambda r: r["logits_unflipped"])
            ws = max(mine, key=lambda r: r["state"])
            log(f"deepseek (c) layer by layer, {dtype} seed {seed}, "
                f"{len(mine)} layers: logits max |diff| "
                f"{wl['logits_unflipped']:.4e} (layer {wl['layer']}, |logit| "
                f"up to {wl['logit_abs_max']:.4f}), caches max relative diff "
                f"{ws['state']:.4e} (layer {ws['layer']}), "
                f"{sum(r['flips'] for r in mine)} routing flips "
                f"({sum(r['last_token_flips'] for r in mine)} at the last "
                f"token)")
        worst = {k: max(r[k] for r in rs)
                 for k in ("logits", "logits_unflipped", "state")}
        log(f"deepseek (c) layer by layer, {dtype}: largest over {len(rs)} "
            f"layer readings {worst}, held at {tol}")
        out[dtype] = dict(tolerance=tol, largest=worst, readings=rs)
    for r in readings:
        tol = DS_LAYER_TOL[r["dtype"]]
        if not r["finite"] or r["logits_unflipped"] > tol["logits"] or \
                r["state"] > tol["state"]:
            raise AssertionError(f"deepseek (c) layer by layer past {tol}: "
                                 f"{r}")
    return out


def serve_deepseek(counters, result):
    """Drive the DeepSeek-V2-Lite serving path with the relational MoE
    (impl="sort"); every counter is zeroed before (a) and read after it,
    then (b) is checked for its own launches."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.nn import layers, moe
    from repro_torch.nn.model import LM
    from repro_torch.serving import Request, ServingEngine

    card = result["card"]
    base = get_config("deepseek_v2_lite_16b")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                            impl="sort"))
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    lm = LM(cfg)
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, t_init = timed(lambda: lm.init(gen))
    n_params = sum(t.numel() for t in leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    log(f"deepseek: {cfg.name}, {cfg.n_layers} layers ({n_moe} MoE of "
        f"{cfg.moe.n_experts} experts of {cfg.moe.d_ff_expert}, top-"
        f"{cfg.moe.top_k}, {cfg.moe.n_shared} shared; impl "
        f"{cfg.moe.impl!r}), d_model {cfg.d_model}, MLA kv_lora "
        f"{cfg.mla.kv_lora}, {cfg.n_heads} heads of "
        f"{cfg.mla.d_nope}+{cfg.mla.d_rope} / {cfg.mla.d_v}, vocab "
        f"{cfg.vocab}: {n_params} parameters, {param_bytes / 1e9:.2f} GB "
        f"float32, made in {t_init:.2f} s")
    if n_params != DS_PARAMS:
        raise AssertionError(f"{n_params} parameters, not the JAX init's "
                             f"{DS_PARAMS}")

    # (a) bulk prefill: flash in every layer, moe_dispatch and
    # relational_matmul in every MoE layer, nothing else
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN)).astype(np.int32)).to(
            lm.device)
    for fn in counters.values():
        fn.launches = 0
    with RouteLog(moe) as rl:
        (logits, cache), t_prefill = timed(
            lambda: lm.prefill(params, {"tokens": tokens}))
    launches = {name: fn.launches for name, fn in counters.items()}
    expected = {name: 0 for name in counters} | {
        "flash_attention": cfg.n_layers, "moe_dispatch": n_moe,
        "relational_matmul": n_moe}
    if launches != expected:
        raise AssertionError(f"deepseek prefill launches {launches}, "
                             f"expected {expected}")
    peak_prefill = torch.cuda.max_memory_allocated()
    drops = [c["drops"] for c in rl.calls]
    shapes = lambda c: [tuple(t.shape) for t in cache_leaves(c)]
    want = shapes(lm.init_cache(PREFILL_BATCH, PREFILL_LEN))
    if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or \
            not torch.isfinite(logits).all() or shapes(cache) != want or \
            len(drops) != n_moe:
        raise AssertionError(f"deepseek prefill gave logits "
                             f"{tuple(logits.shape)}, cache {shapes(cache)} "
                             f"(expected {want}), {len(drops)} routings")
    del cache
    assignments = PREFILL_BATCH * PREFILL_LEN * cfg.moe.top_k
    log(f"deepseek (a) dropped assignments per MoE layer at capacity factor "
        f"{cfg.moe.capacity_factor} (of {assignments}): {drops}")

    # (b) continuous batching, greedy: every decode_step call runs
    # moe_dispatch and relational_matmul once per MoE layer, and no flash
    eng = ServingEngine(lm, params, max_len=MAX_LEN, batch_slots=SLOTS)
    eng.tracer = obs.Tracer()
    for uid in range(REQUESTS):
        eng.submit(Request(uid, rng.randint(0, cfg.vocab, int(
            rng.randint(4, 33))).astype(np.int32), max_new_tokens=NEW_TOKENS))
    done, t_serve = timed(eng.run_to_completion)
    calls = (eng.tracer.counters["serve.prefill_tokens"]
             + eng.tracer.histograms["serve.step_ms"]["count"])
    got = {name: fn.launches - launches[name] for name, fn in counters.items()}
    want = {name: 0 for name in counters} | {
        "moe_dispatch": n_moe * calls, "relational_matmul": n_moe * calls}
    if got != want:
        raise AssertionError(f"the engine made {calls} decode_step calls and "
                             f"launched {got}, expected {want}")
    if sorted(r.uid for r in done) != list(range(REQUESTS)) or any(
            len(r.generated) != NEW_TOKENS for r in done):
        raise AssertionError("the engine left requests unserved: "
                             f"{[(r.uid, len(r.generated)) for r in done]}")
    n_generated = sum(len(r.generated) for r in done)
    tokens4 = torch.zeros((SLOTS, 1), dtype=torch.int32, device=lm.device)
    step = lambda: lm.decode_step(params, {"tokens": tokens4}, eng.cache, 100)
    timed(step)
    step_ms = min(timed(step)[1] for _ in range(3)) * 1e3

    prefill = lambda: lm.prefill(params, {"tokens": tokens})
    wall = timed(prefill)[1] * 1e3
    out = dict(
        model=cfg.name, impl=cfg.moe.impl, layers=cfg.n_layers,
        parameters=n_params, param_bytes=param_bytes, init_s=t_init,
        prefill=dict(shape=f"{PREFILL_BATCH} x {PREFILL_LEN} tokens",
                     first_s=t_prefill, warm_ms=wall,
                     tokens_per_s=PREFILL_BATCH * PREFILL_LEN / wall * 1e3,
                     launches=launches, dropped_assignments=drops,
                     assignments_per_layer=assignments,
                     peak_bytes=peak_prefill),
        engine=dict(slots=SLOTS, requests=REQUESTS, new_tokens=NEW_TOKENS,
                    wall_s=t_serve, generated=n_generated,
                    decode_step_calls=calls,
                    tokens_per_s=n_generated / t_serve,
                    counters=eng.tracer.counters,
                    step_ms=eng.tracer.histograms.get("serve.step_ms")),
        decode_step=dict(slots=SLOTS, ms=step_ms,
                         tokens_per_s=SLOTS / step_ms * 1e3))
    log(f"deepseek (a) prefill {PREFILL_BATCH} x {PREFILL_LEN} on {card}: "
        f"first call {t_prefill:.4f} s, warm {wall:.4f} ms "
        f"({out['prefill']['tokens_per_s']:.1f} tokens/s), launches "
        f"{launches}, peak device memory {peak_prefill / 2**30:.2f} GiB")
    log(f"deepseek (b) engine on {card}: {len(done)} requests, {n_generated} "
        f"tokens in {t_serve:.4f} s ({n_generated / t_serve:.2f} tokens/s), "
        f"{calls} decode_step calls, counters {eng.tracer.counters}; decode "
        f"step at {SLOTS} slots {step_ms:.4f} ms "
        f"({SLOTS / step_ms * 1e3:.2f} tokens/s)")
    out["profile"] = dict(
        prefill=device_profile(prefill, wall, "deepseek prefill 4 x 2000",
                               card),
        decode_step=device_profile(step, step_ms,
                                   "deepseek decode step at 4 slots", card))
    eng = step = prefill = None

    # (c) prefill vs token-by-token decode.  Capacity is per group, and the
    # two paths group differently (the prefill routes B·S tokens as one
    # group, a decode step B), so at the published capacity factor they
    # may drop different assignments by the reference's own rule; at
    # n_experts / top_k no assignment can drop on either path.
    lm_c = LM(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)))

    def pvd(seed):
        bind, f1 = deepseek_pvd(lm_c, params, seed, layers, moe,
                                DS_LOGIT_TOL, DS_BIND_DEPTH)
        lw, f2 = deepseek_layerwise(lm_c, params, seed, layers, moe)
        smoke, f3 = deepseek_pvd(lm_c, params, seed, layers, moe,
                                 DS_SMOKE_TOL, ulp=True)
        return dict(bind=bind, layerwise=lw, smoke=smoke, flips=f1 + f2 + f3)

    before = {name: fn.launches for name, fn in counters.items()}
    readings = pvd(0)
    for seed in PVD_SEEDS[1:]:
        params = None
        torch.cuda.empty_cache()
        params = lm.init(gen.manual_seed(seed))
        more = pvd(seed)
        readings = {k: v + more[k] for k, v in readings.items()}
    ran = {name: fn.launches - before[name] for name, fn in counters.items()}
    if ran["moe_dispatch"] == 0 or ran["moe_dispatch"] != \
            ran["relational_matmul"] or ran["rwkv6_scan"]:
        raise AssertionError(f"deepseek (c) launched {ran}")
    out["prefill_vs_decode"] = dict(
        capacity_factor=lm_c.cfg.moe.capacity_factor,
        bind=hold_agreement(readings["bind"], DS_LOGIT_TOL,
                            f"deepseek {DS_BIND_DEPTH} layers"),
        smoke=hold_agreement(readings["smoke"], DS_SMOKE_TOL,
                             f"deepseek {cfg.n_layers} layers"),
        layerwise=hold_deepseek_layerwise(readings["layerwise"]),
        routing_flips=readings["flips"], launches=ran)
    log(f"deepseek (c): {len(readings['flips'])} routing flips over 3 seeds, "
        f"every one a near-tie (margin <= 2 delta)")

    # (d) one full-width MoE layer alone on 8000 tokens, float32: the
    # array representation (einsum) against the relational one (sort)
    first = lambda tree: {k: first(v) if isinstance(v, dict)
                          else v[0].clone() for k, v in tree.items()}
    layer = first(params["layers"]["moe"])
    params = None
    torch.cuda.empty_cache()
    out["one_layer"] = one_moe_layer(layer, cfg, moe, layers, card, counters)
    result["deepseek"] = out
    return launches


def one_moe_layer(p, cfg, moe, layers, card, counters) -> dict:
    """The paper's array-against-relational comparison at one full-width
    DeepSeek-V2-Lite MoE layer: 8000 tokens (one group), float32 compute,
    each impl's output, kernel launches, time and peak memory above the
    layer's weights."""
    from repro_torch.nn.model import _moe_cfg

    t = PREFILL_BATCH * PREFILL_LEN
    dev = p["router"].device
    x = torch.randn((t, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    layers.COMPUTE_DTYPE = torch.float32
    out = {}
    try:
        for impl in ("einsum", "sort"):
            mcfg = dataclasses.replace(_moe_cfg(cfg), impl=impl)
            run = lambda: moe.moe_ffn(p, x, mcfg)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = {n: fn.launches for n, fn in counters.items()}
            (y, aux), _ = timed(run)
            peak = torch.cuda.max_memory_allocated() - base
            launched = {n: fn.launches - before[n]
                        for n, fn in counters.items() if fn.launches > before[n]}
            out[impl] = dict(y=y, aux=float(aux), peak_bytes=peak,
                             launches=launched,
                             ms=time_ms(run, iters=3, warmup=1))
    finally:
        layers.COMPUTE_DTYPE = torch.bfloat16
    # the array form runs no kernel; the relational one its join and
    # group-by once each
    if out["einsum"]["launches"] or out["sort"]["launches"] != {
            "moe_dispatch": 1, "relational_matmul": 1}:
        raise AssertionError(f"deepseek (d) launches: einsum "
                             f"{out['einsum']['launches']}, sort "
                             f"{out['sort']['launches']}")
    ys, ye = out["sort"]["y"], out["einsum"]["y"]
    err = max_err(ys, ye, MOE_IMPL_TOL, "deepseek (d) einsum vs sort")
    differ = int((ys != ye).sum())
    for impl, r in out.items():
        r.pop("y")
        log(f"deepseek (d) one MoE layer, {t} tokens, float32, {impl} on "
            f"{card}: {r['ms']:.4f} ms, peak {r['peak_bytes'] / 2**30:.3f} "
            f"GiB above the inputs, kernel launches {r['launches']}")
    log(f"deepseek (d) einsum vs sort max |diff| {err:.3e} (held at "
        f"{MOE_IMPL_TOL}); {differ} of {ys.numel()} elements differ")
    return dict(tokens=t, max_abs_diff=err, elements_differ=differ,
                tolerance=MOE_IMPL_TOL, **out)


# ---------------------------------------------------------------------------
# phase 8: the serving path on the full-width Zamba2-2.7B
# ---------------------------------------------------------------------------

# The reference's SSD takes a sequence whole chunks long or one token
# (src/repro/nn/ssm.py:173, ssd_chunked), with the model's chunk of 64: it
# refuses 2000-token prompts (2000 % 64 = 16), and the port keeps that
# rule and pads nothing.  So phase 8 prefills 4 x 2048 tokens, 32 chunks.
ZAMBA_PREFILL_LEN = 2048
# jax.eval_shape(repro.nn.model.LM(CONFIG).init, ...) of
# configs/zamba2_2_7b.py, counted leaf by leaf
ZAMBA_PARAMS = 2_435_494_048
# (c) as phases 6 and 7 read theirs: end to end on the shared block and
# the first ZAMBA_BIND_LAYERS Mamba-2 layers, held at ZAMBA_LOGIT_TOL;
# each of the 9 shared-block uses and 54 Mamba-2 layers alone on the input
# the prefill path hands it, held at ZAMBA_LAYER_TOL; the first segment
# (the shared block and 6 layers) and all 54 layers end to end as smoke
# runs, each beside a one-ulp nudge of the input, which the bind depth
# reads too.  float32 binds, at phases 5-7's atol; bf16 is a sanity bound
# (1 / 4 of the random model's logits' spread, as phase 7's), set before
# the first reading.  States and K/V are compared relative to their
# largest value, as RWKV-6's states are.  The first card run (NVIDIA H100
# 80GB HBM3, 700.00 W, PERF.md) bound the first segment and read up to
# 2.236e-4 there in float32 (0.389 in bf16): the random model amplifies
# rounding as RWKV-6's does, so the bind depth is 2 layers, as phase 6's.
ZAMBA_BIND_LAYERS = 2
ZAMBA_SEGMENT = 6
ZAMBA_LOGIT_TOL = {"bfloat16": dict(rtol=0.0, atol=0.25),
                   "float32": dict(rtol=0.0, atol=1e-4)}
ZAMBA_SMOKE_TOL = {"bfloat16": None, "float32": None}
ZAMBA_LAYER_TOL = {"bfloat16": dict(logits=0.25, state=0.05),
                   "float32": dict(logits=1e-4, state=1e-5)}


def zamba_layerwise(lm, params, seed: int, layers) -> list[dict]:
    """Every unit of the full depth alone, in each compute type of
    ZAMBA_LAYER_TOL: each use of the shared block (on the hidden state and
    the embeddings) and each Mamba-2 layer.  A unit's input is what the
    prefill path hands it for PVD_PROMPTS prompts of PVD_LEN tokens; it
    runs once over the whole prompt (the prefill path: SSD chunks, flash
    attention) and PVD_LEN times a token (the decode path: the recurrence,
    attention over a cache) from zero states.  One reading per unit: the
    last token's logits through the final norm and head, and the states'
    (conv and SSM; the shared block's K/V) largest difference over their
    largest value."""
    cfg = lm.cfg
    toks = pvd_tokens(lm, seed)
    readings = []
    for dtype in ZAMBA_LAYER_TOL:
        layers.COMPUTE_DTYPE = getattr(torch, dtype)
        try:
            x0 = x = lm.embed_inputs(params, {"tokens": toks})
            cos, sin = lm._rope(PVD_LEN, x.device)
            steps = [lm._rope_at(t, x.device) for t in range(PVD_LEN)]
            units = []
            for seg in range(cfg.n_layers // cfg.shared_attn_every):
                units.append(("shared", seg))
                units += [("mamba", seg * cfg.shared_attn_every + i)
                          for i in range(cfg.shared_attn_every)]
            for kind, idx in units:
                if kind == "shared":
                    sb = params["shared_block"]
                    out_p, kv_p = lm._shared_block(sb, x, x0, cos, sin)
                    kv = tuple(torch.zeros_like(t) for t in kv_p)
                    for t in range(PVD_LEN):
                        out_d, kv = lm._shared_block(
                            sb, x[:, t:t + 1], x0[:, t:t + 1], *steps[t],
                            cache=kv, pos=t)
                    pairs = zip(kv_p, kv)
                else:
                    lp = layer_at(params["layers"], idx)
                    out_p, _, st_p = lm._block(lp, x, None, None)
                    st = tuple(torch.zeros_like(t) for t in st_p)
                    for t in range(PVD_LEN):
                        out_d, _, st = lm._block(lp, x[:, t:t + 1], None,
                                                 None, cache=st)
                    pairs = zip(st_p, st)
                state = max(float((a - b).abs().max()
                                  / a.abs().max().clamp_min(1e-30))
                            for a, b in pairs)
                lp_, ld_ = (lm.unembed(params, o[:, -1:]).float()
                            for o in (out_p, out_d))
                readings.append(dict(
                    dtype=dtype, seed=seed, unit=f"{kind} {idx}",
                    logits=float((lp_ - ld_).abs().max()),
                    logit_abs_max=float(lp_.abs().max()), state=state,
                    finite=bool(torch.isfinite(lp_).all()
                                and torch.isfinite(ld_).all())))
                x = out_p
        finally:
            layers.COMPUTE_DTYPE = torch.bfloat16
    return readings


def layer_at(tree, i: int):
    """Layer i's parameters of a stacked tree."""
    return {k: layer_at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def hold_zamba_layerwise(readings: list[dict]) -> dict:
    """Print the worst unit of each weight seed and type, then fail if a
    reading is past ZAMBA_LAYER_TOL or not finite."""
    out = {}
    for dtype, tol in ZAMBA_LAYER_TOL.items():
        rs = [r for r in readings if r["dtype"] == dtype]
        for seed in sorted({r["seed"] for r in rs}):
            mine = [r for r in rs if r["seed"] == seed]
            wl = max(mine, key=lambda r: r["logits"])
            ws = max(mine, key=lambda r: r["state"])
            log(f"zamba2 (c) unit by unit, {dtype} seed {seed}, "
                f"{len(mine)} units: logits max |diff| {wl['logits']:.4e} "
                f"({wl['unit']}, |logit| up to {wl['logit_abs_max']:.4f}), "
                f"states max relative diff {ws['state']:.4e} ({ws['unit']})")
        worst = {k: max(r[k] for r in rs) for k in ("logits", "state")}
        log(f"zamba2 (c) unit by unit, {dtype}: largest over {len(rs)} "
            f"unit readings {worst}, held at {tol}")
        out[dtype] = dict(tolerance=tol, largest=worst, readings=rs)
    for r in readings:
        tol = ZAMBA_LAYER_TOL[r["dtype"]]
        if not r["finite"] or r["logits"] > tol["logits"] or \
                r["state"] > tol["state"]:
            raise AssertionError(f"zamba2 (c) unit by unit past {tol}: {r}")
    return out


def serve_zamba(counters, result):
    """Drive the Zamba2-2.7B serving path; every counter is zeroed before
    (a) and read after it, then (b) and (c) are checked for their own
    launches: flash_attention once a shared-block use in a prefill, no
    kernel in a decode step."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.nn import layers
    from repro_torch.nn.model import LM
    from repro_torch.serving import Request, ServingEngine

    card, flash = result["card"], counters["flash_attention"]
    cfg = get_config("zamba2_2_7b")
    n_seg = cfg.n_layers // cfg.shared_attn_every
    lm = LM(cfg)
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, t_init = timed(lambda: lm.init(gen))
    n_params = sum(t.numel() for t in leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    log(f"zamba2: {cfg.name}, {cfg.n_layers} Mamba-2 layers (d_model "
        f"{cfg.d_model}, {cfg.n_heads_mamba()} heads of {cfg.ssm.head_dim}, "
        f"d_state {cfg.ssm.d_state}, chunk {cfg.ssm.chunk}), a shared block "
        f"every {cfg.shared_attn_every} ({cfg.n_heads} heads of "
        f"{cfg.d_head}, d_ff {cfg.d_ff}), vocab {cfg.vocab}: {n_params} "
        f"parameters, {param_bytes / 1e9:.2f} GB float32, made in "
        f"{t_init:.2f} s")
    if n_params != ZAMBA_PARAMS:
        raise AssertionError(f"{n_params} parameters, not the JAX init's "
                             f"{ZAMBA_PARAMS}")

    # (a) bulk prefill: flash_attention once a shared-block use, nothing
    # else (the SSD is PyTorch products)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(
        0, cfg.vocab, (PREFILL_BATCH, ZAMBA_PREFILL_LEN)).astype(
            np.int32)).to(lm.device)
    for fn in counters.values():
        fn.launches = 0
    (logits, cache), t_prefill = timed(
        lambda: lm.prefill(params, {"tokens": tokens}))
    launches = {name: fn.launches for name, fn in counters.items()}
    expected = {name: 0 for name in counters} | {"flash_attention": n_seg}
    if launches != expected:
        raise AssertionError(f"zamba2 prefill launches {launches}, expected "
                             f"{expected}")
    peak_prefill = torch.cuda.max_memory_allocated()
    shapes = lambda c: [(tuple(t.shape), t.dtype) for t in cache_leaves(c)]
    want = shapes(lm.init_cache(PREFILL_BATCH, ZAMBA_PREFILL_LEN))
    if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or \
            not torch.isfinite(logits).all() or shapes(cache) != want or \
            not all(torch.isfinite(t).all() for t in cache_leaves(cache)):
        raise AssertionError(f"zamba2 prefill gave logits "
                             f"{tuple(logits.shape)}, cache {shapes(cache)}, "
                             f"expected {want}")
    del cache

    # (b) continuous batching, greedy: no decode_step call launches a
    # kernel (the shared attention reads its cache in plain PyTorch)
    eng = ServingEngine(lm, params, max_len=MAX_LEN, batch_slots=SLOTS)
    eng.tracer = obs.Tracer()
    for uid in range(REQUESTS):
        eng.submit(Request(uid, rng.randint(0, cfg.vocab, int(
            rng.randint(4, 33))).astype(np.int32), max_new_tokens=NEW_TOKENS))
    done, t_serve = timed(eng.run_to_completion)
    calls = (eng.tracer.counters["serve.prefill_tokens"]
             + eng.tracer.histograms["serve.step_ms"]["count"])
    got = {name: fn.launches - launches[name] for name, fn in counters.items()}
    if any(got.values()):
        raise AssertionError(f"the engine made {calls} decode_step calls and "
                             f"launched {got}")
    if sorted(r.uid for r in done) != list(range(REQUESTS)) or any(
            len(r.generated) != NEW_TOKENS for r in done):
        raise AssertionError("the engine left requests unserved: "
                             f"{[(r.uid, len(r.generated)) for r in done]}")
    n_generated = sum(len(r.generated) for r in done)
    tokens4 = torch.zeros((SLOTS, 1), dtype=torch.int32, device=lm.device)
    step = lambda: lm.decode_step(params, {"tokens": tokens4}, eng.cache, 100)
    timed(step)
    step_ms = min(timed(step)[1] for _ in range(3)) * 1e3

    prefill = lambda: lm.prefill(params, {"tokens": tokens})
    wall = timed(prefill)[1] * 1e3
    n_tok = PREFILL_BATCH * ZAMBA_PREFILL_LEN
    out = dict(
        model=cfg.name, layers=cfg.n_layers, shared_block_uses=n_seg,
        parameters=n_params, param_bytes=param_bytes, init_s=t_init,
        prefill=dict(shape=f"{PREFILL_BATCH} x {ZAMBA_PREFILL_LEN} tokens",
                     first_s=t_prefill, warm_ms=wall,
                     tokens_per_s=n_tok / wall * 1e3, launches=launches,
                     peak_bytes=peak_prefill),
        engine=dict(slots=SLOTS, requests=REQUESTS, new_tokens=NEW_TOKENS,
                    wall_s=t_serve, generated=n_generated,
                    decode_step_calls=calls,
                    tokens_per_s=n_generated / t_serve,
                    counters=eng.tracer.counters,
                    step_ms=eng.tracer.histograms.get("serve.step_ms")),
        decode_step=dict(slots=SLOTS, ms=step_ms,
                         tokens_per_s=SLOTS / step_ms * 1e3))
    log(f"zamba2 (a) prefill {PREFILL_BATCH} x {ZAMBA_PREFILL_LEN} on "
        f"{card}: first call {t_prefill:.4f} s, warm {wall:.4f} ms "
        f"({out['prefill']['tokens_per_s']:.1f} tokens/s), launches "
        f"{launches}, peak device memory {peak_prefill / 2**30:.2f} GiB")
    log(f"zamba2 (b) engine on {card}: {len(done)} requests, {n_generated} "
        f"tokens in {t_serve:.4f} s ({n_generated / t_serve:.2f} tokens/s), "
        f"{calls} decode_step calls, counters {eng.tracer.counters}; decode "
        f"step at {SLOTS} slots {step_ms:.4f} ms "
        f"({SLOTS / step_ms * 1e3:.2f} tokens/s)")
    # (d) the profiles
    out["profile"] = dict(
        prefill=device_profile(prefill, wall, "zamba2 prefill 4 x 2048",
                               card),
        decode_step=device_profile(step, step_ms,
                                   "zamba2 decode step at 4 slots", card))
    eng = step = prefill = None

    # (c) prefill vs token-by-token decode, weight seeds 0, 1 and 2
    def pvd(seed):
        return dict(
            bind=prefill_vs_decode(lm, params, seed, layers, ZAMBA_LOGIT_TOL,
                                   ZAMBA_BIND_LAYERS, ulp=True),
            layerwise=zamba_layerwise(lm, params, seed, layers),
            segment=prefill_vs_decode(lm, params, seed, layers,
                                      ZAMBA_SMOKE_TOL, ZAMBA_SEGMENT,
                                      ulp=True),
            full=prefill_vs_decode(lm, params, seed, layers,
                                   ZAMBA_SMOKE_TOL, ulp=True))

    before = flash.launches
    readings = pvd(0)
    for seed in PVD_SEEDS[1:]:
        params = None
        torch.cuda.empty_cache()
        params = lm.init(gen.manual_seed(seed))
        more = pvd(seed)
        readings = {k: v + more[k] for k, v in readings.items()}
    # flash, a seed and a type: two prefills (one nudged) at the bind depth
    # and at the first segment, one a unit's shared block, two at the full
    # depth
    types = len(ZAMBA_LOGIT_TOL)
    want = len(PVD_SEEDS) * types * (2 + n_seg + 2 + 2 * n_seg)
    if flash.launches - before != want:
        raise AssertionError(f"zamba2 (c) launched {flash.launches - before} "
                             f"flash kernels, expected {want}")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    # every reading is printed before any is held: the smoke runs first
    out["prefill_vs_decode"] = pvd_out = {}
    atol = ZAMBA_LOGIT_TOL["float32"]["atol"]
    for key, depth in (("full", cfg.n_layers), ("segment", ZAMBA_SEGMENT)):
        pvd_out[key] = hold_agreement(readings[key], ZAMBA_SMOKE_TOL,
                                      f"zamba2 {depth} layers")
        f32 = [r for r in readings[key] if r["dtype"] == "float32"]
        log(f"zamba2 (c) {depth} layers, float32: "
            f"{sum(r['max_abs_diff'] <= atol for r in f32)} of {len(f32)} "
            f"readings within atol {atol}, largest |diff| "
            f"{max(r['max_abs_diff'] for r in f32):.4e}, largest one-ulp "
            f"nudge spread {max(r['ulp_abs_diff'] for r in f32):.4e}")
    pvd_out["layerwise"] = hold_zamba_layerwise(readings["layerwise"])
    pvd_out["bind"] = hold_agreement(readings["bind"], ZAMBA_LOGIT_TOL,
                                     f"zamba2 {ZAMBA_BIND_LAYERS} layers")
    log(f"zamba2 peak device memory {out['peak_bytes'] / 2**30:.2f} GiB")
    result["zamba2"] = out
    return launches


# ---------------------------------------------------------------------------
# phase 9: the paper's in-database training beside the card
# ---------------------------------------------------------------------------

# Fig. 10's widths (784 -> 200 -> 10), lr 0.1, Listing 2's weights.  The
# rows are cut for sqlite's time, never the widths: sqlite runs the
# SQL-92 forms at about 0.4 s a row and an iteration on one CPU core (the
# join of img with w_xh is rows x 784 x 200 tuples), so 32 rows, the
# count of BENCH_db_mnist.json's own sqlite run, and its 3 iterations
# keep the phase near 2 minutes.
DB_ROWS, DB_ITERS = 32, 3
DB_TOL = 1e-4                 # tests/test_db_backend.py: TOL
DB_DEVICE = "cuda"            # where the weights come back and (b) runs


def in_database(counters, core, nn2sql, data_mod, result):
    """(a) train in sqlite in both representations and the stepped form;
    (b) the card's engines from the same start, held to (a) within
    ``DB_TOL`` with their kernel launches counted; (c) relations across
    the boundary and inference in the database against the card's; (d) the
    readings.  The SQL runs on the host: sqlite is the executor."""
    import sqlite3

    from repro_torch.core import rel_engine
    from repro_torch.core.relational import RelTensor
    from repro_torch.db import connect, relation_io
    from repro_torch.db import train as db_train

    card = result["card"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x, y = data_mod.make_mnist_like(DB_ROWS)
    spec = nn2sql.MLPSpec(DB_ROWS, N_FEAT, N_HID, N_CLS, lr=LR)
    graph = nn2sql.build_graph(spec)
    w0 = nn2sql.init_weights(spec)
    y_oh = data_mod.one_hot_labels(y, N_CLS)
    log(f"in-database: sqlite {sqlite3.sqlite_version}, {DB_ROWS} rows "
        f"(cut for sqlite's time), {N_FEAT}->{N_HID}->{N_CLS} (Fig. 10's "
        f"widths), lr {LR}, {DB_ITERS} iterations")

    # (a) training in the database.  nn2sql.train hands Engine("sql")'s
    # relational form to train_in_db as "auto", as the reference does: on
    # sqlite, whose recursive CTE cannot hold Listing 7, that is Listing
    # 10's recursion too; the relational recursion runs below, stepped
    trained, walls, stats = {}, {}, {}
    for rep, opts in (("relational", {}), ("array", {"dialect": "array"})):
        eng = core.Engine("sql", **opts)
        (final, hist), t = timed(lambda: nn2sql.train(
            graph, w0, x, y_oh, DB_ITERS, eng, materialize_history=True))
        for name, w in final.items():
            if w.dtype != torch.float32 or w.device.type != DB_DEVICE or \
                    hist[name].shape != (DB_ITERS + 1,) + w.shape:
                raise AssertionError(
                    f"in-database {rep}: {name} came back as {w.dtype} on "
                    f"{w.device}, history {tuple(hist[name].shape)}")
        trained[f"train sql {rep}"] = final
        walls[f"train sql {rep}"] = t / DB_ITERS
        stats[f"train sql {rep}"] = eng._sql.stats
        eng.close()
    # Listing 7's step as INSERT ... SELECT: the relational recursion in
    # pure SQL-92 (sqlite's recursive CTE cannot hold Listing 7 itself)
    res, t = timed(lambda: db_train.train_in_db(
        graph, w0, x, y_oh, DB_ITERS, representation="relational"))
    if res.strategy != "stepped":
        raise AssertionError(f"relational recursion ran as {res.strategy}")
    trained["listing 7 stepped"] = {
        k: torch.as_tensor(v, dtype=torch.float32, device=DB_DEVICE)
        for k, v in res.weights.items()}
    walls["listing 7 stepped"] = t / DB_ITERS
    # the stepped form through sgd_step_fn: forward and Algorithm 1 in the
    # database, the update on the host, in both representations
    for rep, opts in (("relational", {}), ("array", {"dialect": "array"})):
        eng = core.Engine("sql", **opts)
        step = core.sgd_step_fn(graph.loss, [graph.w_xh, graph.w_ho], LR,
                                eng)
        w = dict(w0)
        t0 = time.perf_counter()
        for _ in range(DB_ITERS):
            w, loss = step(w, {"img": x, "one_hot": y_oh})
        walls[f"sgd_step {rep}"] = (time.perf_counter() - t0) / DB_ITERS
        trained[f"sgd_step {rep}"] = {
            k: torch.as_tensor(v, dtype=torch.float32, device=DB_DEVICE)
            for k, v in w.items()}
        stats[f"sgd_step {rep}"] = eng._sql.stats
        eng.close()

    # (b) the card's engines from the same start, every launch counted
    for fn in counters.values():
        fn.launches = 0
    y_card = data_mod.one_hot_labels(y, N_CLS)
    card_w = {}
    for kind in ("dense", "relational"):
        eng = core.Engine(kind)
        (card_w[kind], _), t = timed(lambda: nn2sql.train(
            graph, w0, x, y_card, DB_ITERS, eng))
        walls[f"card {kind}, first run"] = t / DB_ITERS
    launches = {name: fn.launches for name, fn in counters.items()}
    for kind in ("dense", "relational"):       # warm, after the count
        eng = core.Engine(kind)
        _, t = timed(lambda: nn2sql.train(graph, w0, x, y_card, DB_ITERS,
                                          eng))
        walls[f"card {kind}"] = t / DB_ITERS
    expected = {name: 0 for name in counters} | {
        "onehot_embed": 1, "fused_sigmoid_matmul": 2 * DB_ITERS,
        "relational_matmul": 5 * DB_ITERS}
    if launches != expected:
        raise AssertionError(f"in-database (b) launches {launches}, "
                             f"expected {expected}")
    if not torch.equal(y_card, y_oh):
        raise AssertionError("one-hot labels differ between two calls")
    diffs = {}
    for kind, cw in card_w.items():
        for what, dw in trained.items():
            for name in ("w_xh", "w_ho"):
                d = float((cw[name] - dw[name]).abs().max())
                diffs[f"card {kind} vs {what} {name}"] = d
    for what, d in diffs.items():
        log(f"  max |diff| {what}: {d:.3e}")
    worst = max(diffs, key=diffs.get)
    if diffs[worst] > DB_TOL:
        raise AssertionError(f"in-database (b): {worst} {diffs[worst]:.3e} "
                             f"above {DB_TOL}")

    # (c) relations across the boundary: the card's weights into sqlite and
    # back onto the card bit for bit, then inference on the read-back
    # relations through relational_matmul and inference in the database
    before = counters["relational_matmul"].launches
    ad = connect("sqlite")
    back = {}
    for name, w in card_w["relational"].items():
        relation_io.write_reltensor(ad, name, RelTensor.from_dense(w))
        back[name] = relation_io.read_reltensor(ad, name, tuple(w.shape),
                                                device=DB_DEVICE)
        if not torch.equal(back[name].to_dense(), w):
            raise AssertionError(f"in-database (c): {name} did not survive "
                                 "sqlite bit for bit")
    ad.close()
    probs_rel, = rel_engine.evaluate(
        [graph.a_ho], {**back, "img": RelTensor.from_dense(x)}, DB_DEVICE)
    card_probs = nn2sql.infer(graph, core.Engine("relational"))(
        card_w["relational"], x)
    if not torch.equal(probs_rel.to_dense(), card_probs):
        raise AssertionError("in-database (c): read-back relations infer "
                             "differently")
    db_w = trained["train sql relational"]
    probs_db, t_infer_db = timed(lambda: db_train.infer_in_db(
        graph, db_w, x))
    probs_card = nn2sql.infer(graph, core.Engine("relational"))(db_w, x)
    infer_diff = float(np.abs(probs_db - probs_card.cpu().numpy()).max())
    acc_db = float(nn2sql.accuracy(probs_db, y.cpu()))
    acc_card = float(nn2sql.accuracy(probs_card, y))
    labels_db = db_train.predict_in_db(graph, db_w, x)
    if infer_diff > DB_TOL or acc_db != acc_card or not np.array_equal(
            labels_db, probs_card.argmax(dim=1).cpu().numpy()):
        raise AssertionError(
            f"in-database (c): infer |diff| {infer_diff:.3e}, accuracy "
            f"{acc_db} in the database against {acc_card} on the card")
    infer_launches = counters["relational_matmul"].launches - before
    if infer_launches != 6:     # 2 products a pass: card, read-back, db_w
        raise AssertionError(f"in-database (c): {infer_launches} "
                             "relational_matmul launches, expected 6")
    if not (torch.isfinite(card_probs).all()
            and card_probs.shape == (DB_ROWS, N_CLS)):
        raise AssertionError("in-database (c): probabilities not finite")

    # (d) readings
    peak = torch.cuda.max_memory_allocated()
    for what, wall in walls.items():
        log(f"in-database wall a {'step' if 'card' in what else 'iteration'}"
            f", {what}: {wall * 1e3:.4f} ms on {card}")
    for what, st in stats.items():
        a = st["adapter"]
        log(f"in-database {what}: ingest {st['ingest_bytes']} bytes, "
            f"{a.get('ingest_cells', 0)} cells, {st['queries']} queries, "
            f"plan cache {st['cache_hits']} hits / {st['cache_misses']} "
            f"misses")
    log(f"in-database (c): round trip bit for bit, infer |diff| "
        f"{infer_diff:.3e}, accuracy {acc_db:.4f} both, infer_in_db "
        f"{t_infer_db * 1e3:.4f} ms; peak device memory "
        f"{peak / 2**20:.1f} MiB on {card}")
    log(f"in-database launches: {launches}, inference "
        f"{infer_launches} relational_matmul")
    result["in_database"] = dict(
        sqlite=sqlite3.sqlite_version, rows=DB_ROWS, iters=DB_ITERS,
        widths=[N_FEAT, N_HID, N_CLS], lr=LR, tolerance=DB_TOL,
        wall_s=walls, max_abs_diff=diffs, infer_abs_diff=infer_diff,
        accuracy=acc_db, launches=launches, infer_launches=infer_launches,
        peak_bytes=peak,
        stats={k: {f: v for f, v in st.items() if f != "plan_cache"}
               for k, st in stats.items()})
    return launches


# ---------------------------------------------------------------------------
# phase 10: the rest of the in-database tier beside the card
# ---------------------------------------------------------------------------

# (a) sharded training at phase 9's size (Fig. 10's widths, DB_ROWS rows,
# lr 0.1, Listing 2's weights): one shard through the sharded trainer, the
# baseline sharding is measured against, then N pooled connections.  The
# relational form runs 1 iteration, cut for sqlite's time: at 32 rows an
# iteration took 16.2 s with 1 shard and 52.3 s with 4 on the card
# machine's host (sqlite 3.45.1, 8 cores), 3 of each 205 s.
SHARD_COUNTS = {"array": (1, 2, 4), "relational": (1, 4)}
SHARD_ITERS = {"array": 3, "relational": 1}
# (b) Listing 8's forward served from the database: one-row requests over
# a pool of sqlite :memory: connections, in each representation.
SERVE_REQUESTS, SERVE_POOL = 32, 2
# (c) the zoo in SQL against the card, inputs from RandomState(0):
# the MoE bucket fill and combine at DeepSeek-V2-Lite's d_model, top-6 of
# 16 tokens (96 slots); the relational form at a d cut for sqlite's time
ZOO_MOE = dict(tokens=16, top_k=6, d=2048, d_relational=256)
# one head of the RWKV-6 time mix at RWKV-6 7B's head size; S cut so that
# the relational form stays near 30 s (S = 16 took 40.4 s there)
ZOO_RWKV = dict(seq=12, n=64)
# one head of the SSD at Zamba2's (d_state, head dim), S whole chunks
ZOO_SSD = dict(seq=16, chunk=8, n=64, p=64)
# the MoE layer, channel mix and LRU at examples/zoo_in_db.py's sizes (the
# LRU at tests/test_ssm_db.py's)
ZOO_MOE_LAYER = dict(n_tokens=16, d_model=8, n_experts=4, top_k=2, d_ff=16)
ZOO_CMIX = dict(seq=12, d=6, d_ff=12)
ZOO_LRU = dict(seq=6, d_in=3, d_state=4, d_out=2)
ZOO_TOL = 1e-4                # tests/test_zoo_db.py: TOL


def zero_launches(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_launches(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def max_diff(got, want) -> float:
    if isinstance(want, torch.Tensor):
        want = want.detach().double().cpu().numpy()
    return float(np.abs(np.asarray(got, np.float64) - want).max())


def db_shard(counters, core, nn2sql, data_mod, card):
    """(a) ``train_in_db(..., shards=N)`` in both representations, held to
    both card engines from the same start and to each other."""
    from repro_torch.db import train as db_train
    from repro_torch.db.shard import train_in_db_sharded

    x, y = data_mod.make_mnist_like(DB_ROWS)
    spec = nn2sql.MLPSpec(DB_ROWS, N_FEAT, N_HID, N_CLS, lr=LR)
    graph = nn2sql.build_graph(spec)
    w0 = nn2sql.init_weights(spec)
    y_oh = data_mod.one_hot_labels(y, N_CLS)
    runs, walls, traffic = {}, {}, {}
    for rep, shard_counts in SHARD_COUNTS.items():
        iters = SHARD_ITERS[rep]
        for n in shard_counts:
            # train_in_db(shards=1) is the unsharded path phase 9 times
            train = (train_in_db_sharded if n == 1 else db_train.train_in_db)
            res, t = timed(lambda: train(graph, w0, x, y_oh, iters,
                                         shards=n, representation=rep))
            if res.strategy != "sharded" or len(res.history) != iters + 1:
                raise AssertionError(f"db-tier (a) {rep} shards={n}: ran "
                                     f"{res.strategy}, {len(res.history)} "
                                     "iterates")
            what = f"{rep} shards={n}"
            runs[what] = (iters, res.weights)
            walls[what] = t / iters
            traffic[what] = res.cte_bytes
            log(f"db-tier (a) {what}: {t / iters * 1e3:.4f} ms an "
                f"iteration ({iters}), AllReduce traffic {res.cte_bytes} "
                "bytes")

    zero_launches(counters)
    y_card = data_mod.one_hot_labels(y, N_CLS)
    card_w = {}
    for iters in sorted(set(SHARD_ITERS.values())):
        for kind in ("dense", "relational"):
            card_w[(kind, iters)], _ = nn2sql.train(graph, w0, x, y_card,
                                                    iters, core.Engine(kind))
    launches = read_launches(counters)
    steps = sum(set(SHARD_ITERS.values()))
    expected = {name: 0 for name in counters} | {
        "onehot_embed": 1, "fused_sigmoid_matmul": 2 * steps,
        "relational_matmul": 5 * steps}
    if launches != expected:
        raise AssertionError(f"db-tier (a) launches {launches}, expected "
                             f"{expected}")
    diffs = {}
    for what, (iters, w) in runs.items():
        for kind in ("dense", "relational"):
            cw = card_w[(kind, iters)]
            diffs[f"{what} vs card {kind}"] = max(
                max_diff(w[k], cw[k]) for k in ("w_xh", "w_ho"))
        for other, (o_iters, ow) in runs.items():
            if other < what and o_iters == iters:
                diffs[f"{what} vs {other}"] = max(
                    max_diff(w[k], ow[k]) for k in ("w_xh", "w_ho"))
    worst = max(diffs, key=diffs.get)
    log(f"db-tier (a): largest |diff| {diffs[worst]:.3e} ({worst}); "
        f"launches {launches}")
    if diffs[worst] > DB_TOL:
        raise AssertionError(f"db-tier (a): {worst} {diffs[worst]:.3e} "
                             f"above {DB_TOL}")
    served = runs[f"array shards={SHARD_COUNTS['array'][0]}"][1]
    return dict(rows=DB_ROWS, iters=SHARD_ITERS, wall_s=walls,
                allreduce_bytes=traffic, max_abs_diff=diffs,
                launches=launches), served


def db_serve(counters, core, nn2sql, data_mod, weights, tracer, card):
    """(b) ``SQLBatchServer`` serving Listing 8's forward with (a)'s
    weights, every future held to the dense card engine's inference."""
    from repro_torch import obs
    from repro_torch.serving import SQLBatchServer

    x, _ = data_mod.make_mnist_like(SERVE_REQUESTS)
    one = nn2sql.build_graph(nn2sql.MLPSpec(1, N_FEAT, N_HID, N_CLS, lr=LR))
    every = nn2sql.build_graph(nn2sql.MLPSpec(SERVE_REQUESTS, N_FEAT, N_HID,
                                              N_CLS, lr=LR))
    w = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(DB_DEVICE)
         for k, v in weights.items()}
    zero_launches(counters)
    card_probs = nn2sql.infer(every, core.Engine("dense"))(w, x)
    launches = read_launches(counters)
    if launches["fused_sigmoid_matmul"] != 2 or sum(launches.values()) != 2:
        raise AssertionError(f"db-tier (b) card launches {launches}")
    card_probs = card_probs.double().cpu().numpy()
    out = {"launches": launches}
    for rep, dialect in (("relational", None), ("array", "array")):
        t_start = obs.epoch_clock()       # the tracer's clock
        with SQLBatchServer([one.a_ho], ["img"], w, pool_size=SERVE_POOL,
                            dialect=dialect) as srv:
            done = [0.0] * SERVE_REQUESTS
            sent, futs = [], []
            t0 = time.perf_counter()
            for i in range(SERVE_REQUESTS):
                sent.append(time.perf_counter())
                fut = srv.submit({"img": x[i:i + 1]}, tenant=f"t{i % 4}")
                fut.add_done_callback(
                    lambda f, i=i: done.__setitem__(i, time.perf_counter()))
                futs.append(fut)
            got = [f.result(timeout=900)[0] for f in futs]
            t_all = max(done) - t0
        lat_ms = [(d - s) * 1e3 for d, s in zip(done, sent)]
        pct = obs.percentiles_from_values(lat_ms, ps=(50, 99))
        sizes = [s.attrs["batch"] for s in tracer.spans
                 if s.name == "sql.evaluate_batched" and s.t0 >= t_start]
        diff = max(max_diff(g, card_probs[i:i + 1])
                   for i, g in enumerate(got))
        argmax = all(int(np.argmax(g)) == int(np.argmax(card_probs[i]))
                     for i, g in enumerate(got))
        log(f"db-tier (b) {rep}: {SERVE_REQUESTS} requests, pool "
            f"{SERVE_POOL}: {SERVE_REQUESTS / t_all:.4f} requests/s, future "
            f"p50 {pct['p50']:.4f} ms p99 {pct['p99']:.4f} ms, micro-batches "
            f"{sorted(sizes, reverse=True)}, max |diff| vs the dense card "
            f"engine {diff:.3e}, argmax equal {argmax}")
        if diff > DB_TOL or not argmax or sum(sizes) != SERVE_REQUESTS:
            raise AssertionError(f"db-tier (b) {rep}: |diff| {diff:.3e}, "
                                 f"argmax equal {argmax}, batches {sizes}")
        out[rep] = dict(requests_per_s=SERVE_REQUESTS / t_all,
                        p50_ms=pct["p50"], p99_ms=pct["p99"],
                        batch_sizes=sizes, max_abs_diff=diff)
    return out


def lru_on_card(u, a, wb, wc, diagonal: bool) -> torch.Tensor:
    """The LRU layer's recurrence in float32 on the card: the plain version
    the in-database LRU is held to (the port has no LRU model layer)."""
    u, a, wb, wc = (torch.as_tensor(t, dtype=torch.float32, device=DB_DEVICE)
                    for t in (u, a, wb, wc))
    b = u @ wb
    h = torch.zeros(wb.shape[1], dtype=torch.float32, device=DB_DEVICE)
    hs = []
    for t in range(u.shape[0]):
        h = (h * a if diagonal else h @ a) + b[t]
        hs.append(h)
    return torch.stack(hs) @ wc


def db_zoo(counters, card):
    """(c) the zoo in SQL against its card counterparts on the same
    inputs: kernels 4 and 1 (bucket fill and combine), kernel 6 (the RWKV-6
    time mix), ``ssd_chunked``, and the MoE layer, channel mix and LRU."""
    from repro_torch.db import zoo
    from repro_torch.db.sql_engine import SQLEngine
    from repro_torch.kernels import ops
    from repro_torch.nn import layers, ssm
    from repro_torch.nn import moe as nnmoe

    rng = np.random.RandomState(0)
    engines = {"relational": SQLEngine(), "array": SQLEngine(dialect="array")}
    diffs, walls = {}, {}

    def on_card(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=DB_DEVICE)

    def held(what, got, want, seconds=None):
        diffs[what] = max_diff(got, want)
        if seconds is not None:
            walls[what] = seconds
        log(f"db-tier (c) {what}: max |diff| {diffs[what]:.3e}"
            + ("" if seconds is None else f", SQL {seconds * 1e3:.4f} ms"))

    zero_launches(counters)
    # MoE bucket fill and combine: the slot -> token index relation is a
    # float64 (S, 1) column in the database, int32 indices on the card
    t, k, d = ZOO_MOE["tokens"], ZOO_MOE["top_k"], ZOO_MOE["d"]
    slots = t * k
    x = rng.randn(t, d).astype(np.float32)
    slot_token = rng.randint(0, t, (slots, 1)).astype(np.float64)
    slot_gate = rng.rand(slots, 1).astype(np.float32)
    y = rng.randn(slots, d).astype(np.float32)
    idx = on_card(slot_token[:, 0].astype(np.int32), torch.int32)
    fill = ops.moe_dispatch(on_card(x), idx, on_card(slot_gate[:, 0]))
    combined = ops.moe_combine(on_card(y), idx, t)
    # the relational form runs the first d_relational columns: both
    # functions act on each column alone, so the card's columns compare
    for rep, width in (("array", d), ("relational", ZOO_MOE["d_relational"])):
        out, _, _, _ = zoo.moe_dispatch_graph(t, width, slots)
        (got,), s = timed(lambda: engines[rep].evaluate([out], {
            "x": x[:, :width], "slot_token": slot_token,
            "slot_gate": slot_gate}))
        held(f"moe bucket fill {rep} d={width} vs moe_dispatch", got,
             fill[:, :width], s)
        out, _, _ = zoo.moe_combine_graph(slots, width, t)
        (got,), s = timed(lambda: engines[rep].evaluate([out], {
            "expert_out": y[:, :width], "slot_token": slot_token}))
        held(f"moe combine {rep} d={width} vs relational_matmul", got,
             combined[:, :width], s)

    # the RWKV-6 time mix, one head of (S, N)
    s_len, n = ZOO_RWKV["seq"], ZOO_RWKV["n"]
    r, kk, v = (rng.randn(s_len, n).astype(np.float32) * 0.5
                for _ in range(3))
    w = (rng.rand(s_len, n) * 0.5 + 0.3).astype(np.float32)
    u = (rng.randn(n) * 0.5).astype(np.float32)
    s0 = (rng.randn(n, n) * 0.3).astype(np.float32)
    o_card, sfin_card = ops.rwkv6_scan(*(on_card(a)[None]
                                         for a in (r, kk, v, w, u, s0)))
    for rep in ("array", "relational"):
        (o, sfin), s = timed(lambda: zoo.run_rwkv6_in_db(
            r, kk, v, w, u, s0, engine=engines[rep]))
        held(f"rwkv6 time mix {rep} (S, N) = ({s_len}, {n}) vs rwkv6_scan",
             o, o_card[0], s)
        held(f"rwkv6 final state {rep} vs rwkv6_scan", sfin, sfin_card[0])

    # the SSD, one head at (N, P), against ssd_chunked on the card
    s_len, chunk = ZOO_SSD["seq"], ZOO_SSD["chunk"]
    n, p = ZOO_SSD["n"], ZOO_SSD["p"]
    xs = rng.randn(s_len, p).astype(np.float32)
    a = -rng.rand(s_len).astype(np.float32)
    b = (rng.randn(s_len, n) * 0.5).astype(np.float32)
    c = (rng.randn(s_len, n) * 0.5).astype(np.float32)
    y_card, h_card = ssm.ssd_chunked(on_card(xs)[None, :, None],
                                     on_card(a)[None, :, None],
                                     on_card(b)[None], on_card(c)[None],
                                     chunk=chunk)
    (y_db, h_db), s = timed(lambda: zoo.run_ssd_in_db(
        xs, a, b, c, chunk=chunk, engine=engines["array"]))
    held(f"ssd array (S, N, P) = ({s_len}, {n}, {p}), chunk {chunk} vs "
         "ssd_chunked", y_db, y_card[0, :, 0], s)
    held("ssd final state array vs ssd_chunked", h_db, h_card[0, 0])

    # the MoE layer: the oracle in float32 on the card, and the model's
    # layer (impl="sort": moe_dispatch and relational_matmul)
    cfg = zoo.MoESQLConfig(**ZOO_MOE_LAYER)
    params = zoo.init_moe_params(cfg)
    xm = rng.randn(cfg.n_tokens, cfg.d_model).astype(np.float32)
    got, s = timed(lambda: zoo.run_moe_in_db(cfg, params, xm,
                                             engine=engines["relational"]))
    held("moe layer relational vs moe_ffn_ref float32 on the card", got,
         zoo.moe_ffn_ref(cfg, params, on_card(xm), dtype=torch.float32,
                         device=DB_DEVICE), s)
    mcfg = nnmoe.MoEConfig(n_experts=cfg.n_experts, top_k=cfg.top_k,
                           d_model=cfg.d_model, d_ff=cfg.d_ff, impl="sort")
    compute = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        layer_out, _ = nnmoe.moe_ffn({k_: on_card(v_)
                                      for k_, v_ in params.items()},
                                     on_card(xm), mcfg)
    finally:
        layers.COMPUTE_DTYPE = compute
    held("moe layer relational vs nn/moe.py impl=sort float32", got,
         layer_out)

    # the channel mix against nn/ssm.py's (it mixes x + (x_prev - x)·mu,
    # the zoo x·mu + x_prev·(1 - mu): the same function at mu' = 1 - mu)
    s_len, d, f = ZOO_CMIX["seq"], ZOO_CMIX["d"], ZOO_CMIX["d_ff"]
    xc = rng.randn(s_len, d).astype(np.float32)
    mu_k, mu_r = rng.rand(d), rng.rand(d)
    wk, wv, wr = (rng.randn(d, f) * 0.3, rng.randn(f, d) * 0.3,
                  rng.randn(d, d) * 0.3)
    got, s = timed(lambda: zoo.run_channel_mix_in_db(
        xc, mu_k, mu_r, wk, wv, wr, engine=engines["relational"]))
    cmix, _ = ssm.rwkv6_channel_mix(
        {"mu_k": on_card(1.0 - mu_k), "mu_r": on_card(1.0 - mu_r),
         "wk": on_card(wk), "wv": on_card(wv), "wr": on_card(wr)},
        on_card(xc)[None])
    held("channel mix relational vs nn/ssm.py float32", got, cmix[0], s)

    # the LRU, dense block and diagonal
    L = ZOO_LRU
    u_in = rng.randn(L["seq"], L["d_in"]).astype(np.float32)
    a_dense = (rng.randn(L["d_state"], L["d_state"]) * 0.3).astype(np.float32)
    lam = (rng.rand(L["d_state"]) * 0.8).astype(np.float32)
    wb = (rng.randn(L["d_in"], L["d_state"]) * 0.5).astype(np.float32)
    wc = (rng.randn(L["d_state"], L["d_out"]) * 0.5).astype(np.float32)
    for diagonal, a_lru in ((False, a_dense), (True, lam)):
        got, s = timed(lambda: zoo.run_lru_in_db(
            u_in, a_lru, wb, wc, diagonal=diagonal,
            engine=engines["relational"]))
        held(f"lru {'diagonal' if diagonal else 'dense'} relational vs "
             "float32 scan on the card", got,
             lru_on_card(u_in, a_lru, wb, wc, diagonal), s)
    for eng in engines.values():
        eng.close()

    launches = read_launches(counters)
    expected = {name: 0 for name in counters} | {
        "relational_matmul": 2, "moe_dispatch": 2, "rwkv6_scan": 1}
    if launches != expected:
        raise AssertionError(f"db-tier (c) launches {launches}, expected "
                             f"{expected}")
    worst = max(diffs, key=diffs.get)
    log(f"db-tier (c): largest |diff| {diffs[worst]:.3e} ({worst}); "
        f"launches {launches}")
    if diffs[worst] > ZOO_TOL:
        raise AssertionError(f"db-tier (c): {worst} {diffs[worst]:.3e} "
                             f"above {ZOO_TOL}")
    return dict(max_abs_diff=diffs, sql_s=walls, launches=launches)


def db_observe(tracer, out):
    """(d) phase 10's capture into a sqlite file and a Chrome trace in
    ``OUT_DIR``, both through the report CLI; (a)'s and (b)'s metrics
    compared against themselves by the regression gate."""
    from repro_torch import obs
    from repro_torch.db import connect
    from repro_torch.obs import regress

    OUT_DIR.mkdir(exist_ok=True)
    db_path = OUT_DIR / "db_tier_trace.db"
    db_path.unlink(missing_ok=True)
    ad = connect("sqlite", str(db_path))
    n_spans = obs.write_trace_spans(ad, tracer)
    n_points = obs.write_metric_points(ad, tracer)
    ad.commit()
    ad.close()
    json_path = Path(obs.write_chrome_trace(tracer,
                                            str(OUT_DIR / "db_tier_trace.json")))
    log(f"db-tier (d): {n_spans} spans and {n_points} metric points into "
        f"{db_path.relative_to(ROOT)}, Chrome trace "
        f"{json_path.relative_to(ROOT)}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for path in (db_path, json_path):
        log(f"$ python -m repro_torch.obs.report {path.relative_to(ROOT)} "
            "--top 5")
        run = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                              str(path), "--top", "5"], capture_output=True,
                             text=True, env=env, timeout=300, check=True)
        log(run.stdout.rstrip())

    metrics = {}
    for what, wall in out["shard"]["wall_s"].items():
        metrics[f"shard.{what.replace(' ', '.')}.iter_s"] = regress.metric(
            wall, "s", "lower")
    for rep in ("relational", "array"):
        r = out["serve"][rep]
        metrics[f"serve.{rep}.requests_per_s"] = regress.metric(
            r["requests_per_s"], "req/s", "higher")
        metrics[f"serve.{rep}.p50_ms"] = regress.metric(r["p50_ms"], "ms")
        metrics[f"serve.{rep}.p99_ms"] = regress.metric(r["p99_ms"], "ms")
    report_ = {"metrics": metrics}
    deltas = regress.compare(report_, report_)
    log(regress.delta_table(deltas, title="db-tier (d): (a) and (b) against "
                                          "themselves"))
    bad = [d.name for d in deltas if d.status != "ok"]
    if bad or len(deltas) != len(metrics):
        raise AssertionError(f"db-tier (d): regress.compare against itself "
                             f"flagged {bad}")
    return dict(spans=n_spans, metric_points=n_points, metrics=metrics)


def db_tier(counters, core, nn2sql, data_mod, result):
    """Phase 10: (a) sharded training, (b) the SQL batch server, (c) the
    zoo in SQL against the card, all SQL in sqlite ``:memory:`` on the
    host under one tracer; (d) that capture through the report CLI and the
    regression gate."""
    import sqlite3

    from repro_torch import obs

    card = result["card"]
    log(f"db-tier: sqlite {sqlite3.sqlite_version}, os.cpu_count() "
        f"{os.cpu_count()}, {card}")
    tracer = obs.Tracer()
    out = {"sqlite": sqlite3.sqlite_version, "cpu_count": os.cpu_count()}
    t0 = time.perf_counter()
    with obs.use(tracer):
        out["shard"], served = db_shard(counters, core, nn2sql, data_mod,
                                        card)
        out["serve"] = db_serve(counters, core, nn2sql, data_mod, served,
                                tracer, card)
        out["zoo"] = db_zoo(counters, card)
    out["obs"] = db_observe(tracer, out)
    out["wall_s"] = time.perf_counter() - t0
    log(f"db-tier: phase 10 in {out['wall_s']:.1f} s")
    result["db_tier"] = out
    return out


# ---------------------------------------------------------------------------
# phase 11: LM training on the full-width Yi-6B, cut in depth
# ---------------------------------------------------------------------------

# The full width (d_model 4096, 32/4 heads of 128, d_ff 11008, vocab
# 64000), cut in depth because one card forces it: float32 parameters,
# gradients and AdamW's m and v take 16 bytes a parameter, 97.0 GB at 32
# layers (6,061,035,520 parameters) and 41.6 GB at 12 (2,600,570,880), which
# leaves room for the activations under remat="full" and the float32
# logits.  The repo's training sequence (train_4k, 4096); the global batch
# 4 (train_4k's 256, cut) in 2 microbatches of 2 x 4096 tokens.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = 12, 4096, 4, 2
TRAIN_STEPS = 4                    # 1 warm step, then the 3 that are read
TRAIN_PARAMS = 2_600_570_880
# (b) the gradients at the same width on 2 layers, one microbatch of
# 2 x 4096, float32 compute (the 3xTF32 forward kernel, the float32
# backward) against float64 on the card with attention through the plain
# versions.  Bound: each leaf's largest difference within 1e-3 of the
# leaf's largest magnitude (3xTF32 products and float32 sums over 8192
# tokens); the loss within 1e-5 relative.
GRAD_LAYERS, GRAD_BATCH, GRAD_REL, LOSS_REL = 2, 2, 1e-3, 1e-5
# (c) restart on the reduced Yi-6B: 6 steps, a checkpoint every 3
RESTART_STEPS, RESTART_EVERY, RESTART_SEQ = 6, 3, 64
# (d) remat="dots" at (a)'s depth and width: one microbatch's loss and
# gradients against remat="full"'s (the same kernels on the same operands,
# so equal bit for bit; else each leaf within DOTS_REL of its largest
# magnitude, with the reason), the products kept a layer against the JAX
# policy's count for the same block (jax.ad_checkpoint's saved residuals
# of a Yi-6B block: q, k, v, the output projection, gate and up; the down
# projection's output, which only the residual add reads, is no residual;
# tests/test_torch_remat_dots.py holds the port to that list on the CPU),
# then Trainer for 1 warm step and DOTS_STEPS - 1 read steps
DOTS_REL, DOTS_KEPT, DOTS_STEPS = 1e-6, 6, 3


class OracleAttention(torch.autograd.Function):
    """Attention through the plain versions (``ref.flash_attention`` and
    ``ref.flash_attention_bwd``), one KV head's query group at a time: at
    (2, 32, 4096, 4096) one float64 score tensor of all heads is 8.6 GB.
    An oracle only; the port never calls it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        from repro_torch.kernels import ref
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        g = q.shape[1] // k.shape[1]
        return torch.cat([ref.flash_attention(
            q[:, h * g:(h + 1) * g], k[:, h:h + 1], v[:, h:h + 1],
            causal=causal, scale=scale) for h in range(k.shape[1])], dim=1)

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels import ref
        q, k, v = ctx.saved_tensors
        g = q.shape[1] // k.shape[1]
        parts = [ref.flash_attention_bwd(
            q[:, h * g:(h + 1) * g], k[:, h:h + 1], v[:, h:h + 1],
            do[:, h * g:(h + 1) * g], causal=ctx.causal, scale=ctx.scale)
            for h in range(k.shape[1])]
        return (*(torch.cat(p, dim=1) for p in zip(*parts)), None, None)


def value_and_grad(lm, params, batch):
    """(loss, gradient leaves in JAX's order) of ``lm.loss_fn``."""
    from repro_torch.tree import leaves, unflatten
    flat = [t.detach().requires_grad_() for t in leaves(params)]
    loss, _ = lm.loss_fn(unflatten(params, flat), batch)
    return loss.detach(), torch.autograd.grad(loss, flat)


def train_trainer(counters, card):
    """(a) ``Trainer`` on the full-width 12-layer Yi-6B: the counts are
    zeroed just before ``run`` and read just after it."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.nn.model import LM
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=TRAIN_LAYERS)
    lm = LM(cfg)
    data = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH)
    trainer = Trainer(lm, adamw(3e-4), data, grad_accum=TRAIN_ACCUM)
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(0)
    log(f"train (a): {cfg.name} at {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, remat "
        f"{cfg.remat}, loss {cfg.loss_impl}; global batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} in {TRAIN_ACCUM} microbatches, AdamW 3e-4, on {card}")
    torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    run = trainer.run(gen, TRAIN_STEPS, log_every=0)
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    params, opt_state, hist = run["params"], run["opt_state"], run["history"]
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != TRAIN_PARAMS:
        raise AssertionError(f"train (a): {n_params} parameters, expected "
                             f"{TRAIN_PARAMS}")
    # a microbatch: each layer's forward once and once more in remat's
    # recompute, and one backward
    per_step = {"flash_attention": 2 * TRAIN_ACCUM * cfg.n_layers,
                "flash_attention_bwd": TRAIN_ACCUM * cfg.n_layers}
    expected = {name: 0 for name in counters} | {
        k: n * TRAIN_STEPS for k, n in per_step.items()}
    if launches != expected:
        raise AssertionError(f"train (a) launches {launches}, expected "
                             f"{expected}")
    if not all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist):
        raise AssertionError(f"train (a): a loss or norm is not finite: "
                             f"{hist}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    read = hist[1:]
    step_s = [h["seconds"] for h in read]
    out = dict(
        model=cfg.name, layers=cfg.n_layers, parameters=n_params,
        tokens_per_step=tokens, steps=len(hist),
        history=hist, step_s=step_s,
        step_s_mean=float(np.mean(step_s)),
        tokens_per_s=[tokens / t for t in step_s],
        launches=launches, launches_per_step=per_step, peak_bytes=peak)
    for h in hist:
        log(f"train (a) step {h['step']}: {h['seconds'] * 1e3:.4f} ms, "
            f"{tokens / h['seconds']:.1f} tokens/s, loss {h['loss']:.6f}, "
            f"grad norm {h['grad_norm']:.6f}")
    log(f"train (a): {TRAIN_STEPS} steps, launches {launches} ({per_step} a "
        f"step), peak device memory {peak / 2**30:.2f} GiB")
    batch = data.batch_at(TRAIN_STEPS)
    out["profile"] = device_profile(
        lambda: trainer.step_fn(params, opt_state, batch),
        out["step_s_mean"] * 1e3, "training step (2 x 2 x 4096 tokens)",
        card)
    return out


def train_gradients(card):
    """(b) loss and every gradient leaf of a 2-layer full-width Yi-6B,
    float32 compute through both flash kernels, against float64 on the
    card with attention through the plain versions; bf16 compute beside
    it as a sanity reading."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    from repro_torch.nn import layers
    from repro_torch.nn.model import LM
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=GRAD_LAYERS)
    lm = LM(cfg)
    gen = torch.Generator(device=lm.device)
    params = lm.init(gen.manual_seed(1))
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=GRAD_BATCH, seed=1).batch_at(0)
    compute, accum = layers.COMPUTE_DTYPE, layers.ACCUM_DTYPE
    fwd0 = flash_mod.flash_attention.launches
    bwd0 = flash_mod.flash_attention_bwd.launches
    layers.COMPUTE_DTYPE = torch.float32
    try:
        (l32, g32), t32 = timed(lambda: value_and_grad(lm, params, batch))
    finally:
        layers.COMPUTE_DTYPE = compute
    got = (flash_mod.flash_attention.launches - fwd0,
           flash_mod.flash_attention_bwd.launches - bwd0)
    if got != (2 * GRAD_LAYERS, GRAD_LAYERS):
        raise AssertionError(f"train (b) float32: flash launches {got}, "
                             f"expected {(2 * GRAD_LAYERS, GRAD_LAYERS)}")
    (l16, g16), t16 = timed(lambda: value_and_grad(lm, params, batch))
    p64 = tree_map(lambda t: t.double(), params)
    del params
    plain = ops.flash_attention
    layers.COMPUTE_DTYPE = layers.ACCUM_DTYPE = torch.float64
    ops.flash_attention = (lambda q, k, v, causal=True, scale=None,
                           bf16_scores=False:
                           OracleAttention.apply(q, k, v, causal, scale))
    try:
        (l64, g64), t64 = timed(lambda: value_and_grad(lm, p64, batch))
    finally:
        layers.COMPUTE_DTYPE, layers.ACCUM_DTYPE = compute, accum
        ops.flash_attention = plain
    del p64
    loss_rel = abs(float(l32) - float(l64)) / abs(float(l64))
    ratios32, ratios16 = [], []
    for a, c, w in zip(g32, g16, g64):
        scale = float(w.abs().max())
        ratios32.append(float((a.double() - w).abs().max()) / scale)
        ratios16.append(float((c.double() - w).abs().max()) / scale)
    out = dict(layers=GRAD_LAYERS, tokens=GRAD_BATCH * TRAIN_SEQ,
               loss_f32=float(l32), loss_bf16=float(l16),
               loss_f64=float(l64), loss_rel=loss_rel,
               grad_ratio_f32=max(ratios32), grad_ratio_bf16=max(ratios16),
               ratios_f32=ratios32, seconds=dict(f32=t32, bf16=t16, f64=t64))
    log(f"train (b) on {card}: loss float32 {float(l32):.8f}, float64 "
        f"{float(l64):.8f} (relative {loss_rel:.3e}, bound {LOSS_REL}), "
        f"bf16 {float(l16):.8f}; largest |grad diff| / leaf max over "
        f"{len(g64)} leaves: float32 {max(ratios32):.3e} (bound "
        f"{GRAD_REL}), bf16 {max(ratios16):.3e} (a sanity reading); "
        f"{t32:.2f} / {t16:.2f} / {t64:.2f} s")
    if loss_rel > LOSS_REL or max(ratios32) > GRAD_REL:
        raise AssertionError("train (b): the float32 gradients miss the "
                             "float64 oracle")
    return out


def train_restart(card):
    """(c) the reduced Yi-6B on the card for 6 steps, a checkpoint every
    3; a fresh Trainer resumes at 6 with every parameter and AdamW state
    leaf equal to the saved one bit for bit."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.nn.model import LM
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves

    cfg = get_config("yi_6b", reduced=True)
    ckpt_dir = OUT_DIR / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def trainer():
        return Trainer(LM(cfg), adamw(1e-3),
                       TokenPipeline(cfg.vocab, RESTART_SEQ, 4),
                       checkpoint_dir=str(ckpt_dir),
                       checkpoint_every=RESTART_EVERY)

    first = trainer()
    run = first.run(torch.Generator(device=first.model.device).manual_seed(0),
                    RESTART_STEPS, log_every=0)
    fresh = trainer()
    params, state, start = fresh.restore_or_init(
        torch.Generator(device=fresh.model.device).manual_seed(9))
    saved = leaves((run["params"], run["opt_state"]))
    same = [torch.equal(a, b) and a.device == b.device
            for a, b in zip(leaves((params, state)), saved)]
    losses = [h["loss"] for h in run["history"]]
    out = dict(steps=fresh.ckpt.list_steps(), resumed_at=start,
               leaves=len(saved), equal=sum(same), losses=losses)
    log(f"train (c) on {card}: reduced {cfg.name}, checkpoints at "
        f"{out['steps']}, a fresh Trainer resumes at {start}, {sum(same)} "
        f"of {len(saved)} leaves equal bit for bit; losses {losses}")
    if start != RESTART_STEPS or not all(same) or \
            out["steps"] != [RESTART_EVERY, RESTART_STEPS]:
        raise AssertionError(f"train (c): restart failed: {out}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def train_dots(counters, card):
    """(d) remat="dots" on (a)'s 12-layer Yi-6B: one microbatch's loss and
    gradients against remat="full"'s, the products each layer keeps, and
    ``Trainer`` for DOTS_STEPS steps, the counts zeroed just before its
    ``run`` and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.nn import model as model_mod
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves

    full = dataclasses.replace(get_config("yi_6b"), n_layers=TRAIN_LAYERS)
    cfg = dataclasses.replace(full, remat="dots")
    lm, lm_full = model_mod.LM(cfg), model_mod.LM(full)
    gen = torch.Generator(device=lm.device)
    params = lm.init(gen.manual_seed(0))
    data = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH)
    micro = {k: v[:TRAIN_BATCH // TRAIN_ACCUM]
             for k, v in data.batch_at(0).items()}
    kept = []

    class Counted(model_mod._Dots):
        def prune(self):
            super().prune()
            kept.append([tuple(t.shape) for t in self.kept[:self.read]])

    flash = counters["flash_attention"], counters["flash_attention_bwd"]
    (l_full, g_full), t_full = timed(
        lambda: value_and_grad(lm_full, params, micro))
    before = [f.launches for f in flash]
    plain, model_mod._Dots = model_mod._Dots, Counted
    try:
        torch.cuda.reset_peak_memory_stats()
        (l_dots, g_dots), t_dots = timed(
            lambda: value_and_grad(lm, params, micro))
    finally:
        model_mod._Dots = plain
    grad_peak = torch.cuda.max_memory_allocated()
    got = tuple(f.launches - b for f, b in zip(flash, before))
    exact = bool(torch.equal(l_full, l_dots)) and all(
        torch.equal(a, b) for a, b in zip(g_full, g_dots, strict=True))
    ratio = max(float((a.double() - b.double()).abs().max())
                / (float(b.abs().max()) or 1.0)
                for a, b in zip(g_dots, g_full))
    del g_full, g_dots, params
    torch.cuda.empty_cache()
    log(f"train (d) remat=\"dots\" on {card}: one microbatch of "
        f"{TRAIN_BATCH // TRAIN_ACCUM} x {TRAIN_SEQ}, loss "
        f"{float(l_dots):.8f} against \"full\"'s {float(l_full):.8f}, "
        f"gradients {'equal bit for bit' if exact else 'not bit for bit'}"
        f" (largest |diff| / leaf max {ratio:.3e}); {t_dots:.3f} s against "
        f"{t_full:.3f} s; flash launches {got}; products kept a layer "
        f"{[len(k) for k in kept]}, the first layer's {kept[0]}; peak "
        f"{grad_peak / 2**30:.2f} GiB")
    if got != (2 * cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"train (d): flash launches {got}, expected "
                             f"{(2 * cfg.n_layers, cfg.n_layers)}")
    if len(kept) != cfg.n_layers or any(len(k) != DOTS_KEPT for k in kept):
        raise AssertionError(f"train (d): products kept a layer "
                             f"{[len(k) for k in kept]}, expected "
                             f"{DOTS_KEPT} (the JAX policy's) in each of "
                             f"{cfg.n_layers}")
    if not exact and ratio > DOTS_REL:
        raise AssertionError(f"train (d): \"dots\" is {ratio:.3e} from "
                             f"\"full\", past {DOTS_REL}")
    trainer = Trainer(lm, adamw(3e-4), data, grad_accum=TRAIN_ACCUM)
    torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    run = trainer.run(gen.manual_seed(0), DOTS_STEPS, log_every=0)
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    hist = run["history"]
    n_params = sum(t.numel() for t in leaves(run["params"]))
    del run, trainer
    per_step = {"flash_attention": 2 * TRAIN_ACCUM * cfg.n_layers,
                "flash_attention_bwd": TRAIN_ACCUM * cfg.n_layers}
    expected = {name: 0 for name in counters} | {
        k: n * DOTS_STEPS for k, n in per_step.items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = [h["seconds"] for h in hist[1:]]
    out = dict(exact=exact, grad_ratio=ratio, loss_full=float(l_full),
               loss_dots=float(l_dots), seconds=dict(full=t_full,
                                                     dots=t_dots),
               kept=kept, grad_peak_bytes=grad_peak, parameters=n_params,
               history=hist, step_s=step_s,
               step_s_mean=float(np.mean(step_s)),
               tokens_per_s=[tokens / t for t in step_s], launches=launches,
               launches_per_step=per_step, peak_bytes=peak)
    for h in hist:
        log(f"train (d) step {h['step']}: {h['seconds'] * 1e3:.4f} ms, "
            f"{tokens / h['seconds']:.1f} tokens/s, loss {h['loss']:.6f}, "
            f"grad norm {h['grad_norm']:.6f}")
    log(f"train (d): {DOTS_STEPS} steps under remat=\"dots\", launches "
        f"{launches} ({per_step} a step), peak device memory "
        f"{peak / 2**30:.2f} GiB")
    if launches != expected or n_params != TRAIN_PARAMS or not all(
            np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist):
        raise AssertionError(f"train (d): launches {launches} (expected "
                             f"{expected}), {n_params} parameters, or a "
                             f"loss or norm not finite: {hist}")
    return out


def train_guard():
    """(e) fused_sigmoid_matmul, a card kernel with no backward (the
    paper's dense engine differentiates in its own IR), refuses an operand
    that requires grad, before it launches."""
    from repro_torch.kernels import fused_sigmoid_matmul as fsm_mod
    from repro_torch.kernels import ops
    from repro_torch.nn.model import resolve

    dev = resolve("cuda")
    x = torch.randn(64, 32, device=dev, requires_grad=True)
    w = torch.randn(32, 16, device=dev)
    before = fsm_mod.fused_sigmoid_matmul.launches
    expect_raise(NotImplementedError,
                 lambda: ops.fused_sigmoid_matmul(x, w),
                 "train (e): fused_sigmoid_matmul with an operand requiring "
                 "grad")
    if fsm_mod.fused_sigmoid_matmul.launches != before:
        raise AssertionError("train (e): the guard launched the kernel")
    log("train (e): fused_sigmoid_matmul with an operand that requires grad "
        "raised NotImplementedError before any launch")
    return dict(raised=True)


def held_bytes() -> int:
    """Device bytes still allocated once garbage is collected and cuBLAS's
    workspaces are let go, as PyTorch's own leak check reads them: cuBLAS
    takes a workspace from the caching allocator for each handle and
    stream, and the autograd engine's device thread has a handle of its
    own."""
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def train_path(counters, result):
    """Phase 11; frees everything it allocates (fails otherwise).  Returns
    (a)'s launches."""
    card = result["card"]
    held = held_bytes()
    t0 = time.perf_counter()
    out = {"trainer": train_trainer(counters, card)}
    torch.cuda.empty_cache()
    out["gradients"] = train_gradients(card)
    torch.cuda.empty_cache()
    out["restart"] = train_restart(card)
    torch.cuda.empty_cache()
    out["dots"] = train_dots(counters, card)
    out["guard"] = train_guard()
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    workspaces = torch.cuda.memory_allocated() - held
    left = held_bytes() - held
    out["memory"] = dict(allocated_before=held, cublas_workspaces=workspaces,
                         left=left)
    log(f"train: phase 11 in {out['wall_s']:.1f} s; {held} B allocated "
        f"before it, {workspaces} B more after it, all of them cuBLAS "
        f"workspaces but {left} B")
    if left:
        raise AssertionError(f"train: phase 11 left {left} B allocated")
    result["train"] = out
    return out["trainer"]["launches"]


# ---------------------------------------------------------------------------
# phase 12: MoE training on the full-width DeepSeek-V2-Lite, cut in depth
# ---------------------------------------------------------------------------

# Every published width (d_model 2048, MLA kv_lora 512, 16 heads of 128 + 64
# with v 128, 64 routed experts of 1408 top-6, 2 shared, capacity 1.25,
# vocab 102400) with the relational MoE (impl="sort"), cut in depth because
# one card forces it: float32 parameters, gradients and AdamW's m and v take
# 16 bytes a parameter, 251.3 GB at 27 layers (DS_PARAMS) and 45.44 GB at 5,
# the dense first layer and 4 MoE layers (2,839,831,040 parameters, counted
# as DS_PARAMS is).  Phase 11's traffic: the train_4k sequence, a global
# batch of 4 in 2 microbatches of 2 x 4096 tokens (each MoE layer: 4 groups
# of 2048 tokens, 61,440 capacity slots, 49,152 assignments), AdamW 3e-4,
# clip 1.0, remat="full", 1 warm step and 3 read.
MOE_LAYERS = 5
MOE_PARAMS = 2_839_831_040
MOE_STEPS = 4
# (b) the gradients on the dense layer and 1 MoE layer at the same width
# (1,085,287,424 parameters), one microbatch of 2 x 4096, float32 compute
# against float64 on the card, phase 11's bound; the routing is pinned: the
# float64 run takes the float32 run's experts and recomputes its gates in
# float64 there (a near-tie in top-k, and so the capacity drops, can fall
# the other way in another precision)
MOE_GRAD_LAYERS = 2
#: device kernels of the MoE training step by name, for the profile
MOE_KERNELS = {"flash_attention (forward)": r"flash(?!_bwd)",
               "flash_attention_bwd": r"flash_bwd",
               "moe_dispatch": r"dispatch_rows",
               "relational_matmul": r"segment_offsets|_spmm",
               "tuple_dot": r"tuple_dot"}


class RoutePin:
    """Records each routing call's chosen experts and dropped assignments
    while active; ``replay`` instead routes every call to the recorded
    experts of the call with the same number (the run must call in the
    same order), the gates and the aux loss recomputed at those experts
    in the input's type, as ``nn/moe.py::_route`` computes them
    (``router_softmax="pre"``)."""

    def __init__(self, moe, replay=None):
        self.moe, self.replay, self.calls = moe, replay, []

    def __enter__(self):
        self.route = route = self.moe._route
        moe = self.moe

        def pinned(p, x, cfg):
            if self.replay is None:
                gates, idx, aux = route(p, x, cfg)
            else:
                if cfg.router_softmax != "pre":
                    raise AssertionError("RoutePin replays pre-softmax "
                                         "routing only")
                idx = self.replay[len(self.calls)]["idx"]
                logits = x @ p["router"].to(x.dtype)
                probs = torch.softmax(logits, dim=-1)
                gates = torch.gather(probs, -1, idx)
                gates = gates / gates.sum(dim=-1, keepdim=True)
                me = probs.mean(dim=tuple(range(probs.dim() - 1)))
                ce = torch.nn.functional.one_hot(idx, cfg.n_experts).to(
                    probs.dtype).sum(dim=-2).mean(
                    dim=tuple(range(idx.dim() - 1)))
                aux = cfg.n_experts * (me * ce).sum() / cfg.top_k
            counts = torch.nn.functional.one_hot(
                idx.reshape(idx.shape[0], -1), cfg.n_experts).sum(1)
            cap = moe._capacity(x.shape[-2], cfg)
            # kept on the device: reading it here would wait for the card
            self.calls.append(dict(
                idx=idx, drops=(counts - cap).clamp(min=0).sum()))
            return gates, idx, aux

        moe._route = pinned
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route

    def drops(self) -> list[int]:
        """The assignments each call dropped."""
        return [int(c["drops"]) for c in self.calls]


def moe_train_config(layers: int):
    from repro_torch.configs import get_config
    cfg = get_config("deepseek_v2_lite_16b")
    return dataclasses.replace(cfg, n_layers=layers, moe=dataclasses.replace(
        cfg.moe, impl="sort"))


def moe_trainer(counters, card):
    """(a) ``Trainer`` on the 5-layer full-width DeepSeek-V2-Lite: the
    counts are zeroed just before ``run`` and read just after it."""
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import adamw as optim_mod
    from repro_torch.nn import moe
    from repro_torch.nn.model import LM
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves

    cfg = moe_train_config(MOE_LAYERS)
    m = cfg.moe
    n_moe = cfg.n_layers - m.first_k_dense
    lm = LM(cfg)
    data = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH)
    trainer = Trainer(lm, adamw(3e-4), data, grad_accum=TRAIN_ACCUM)
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(0)
    log(f"moe-train (a): {cfg.name} at {cfg.n_layers} layers ({m.first_k_dense}"
        f" dense, {n_moe} MoE), d_model {cfg.d_model}, MLA kv_lora "
        f"{cfg.mla.kv_lora}, {cfg.n_heads} heads of {cfg.mla.d_nope} + "
        f"{cfg.mla.d_rope} / v {cfg.mla.d_v}, {m.n_experts} experts of "
        f"{m.d_ff_expert} top-{m.top_k} + {m.n_shared} shared, capacity "
        f"{m.capacity_factor}, impl {m.impl}, vocab {cfg.vocab}, remat "
        f"{cfg.remat}; global batch {TRAIN_BATCH} x {TRAIN_SEQ} in "
        f"{TRAIN_ACCUM} microbatches, AdamW 3e-4, on {card}")
    torch.cuda.reset_peak_memory_stats()
    optim_kernels = {"global_norm": optim_mod.global_norm,
                     "adamw": optim_mod.adamw_update}
    with RoutePin(moe) as routes:
        zero_launches(counters | optim_kernels)
        run = trainer.run(gen, MOE_STEPS, log_every=0)
        launches = read_launches(counters)
        optim_launches = read_launches(optim_kernels)
    peak = torch.cuda.max_memory_allocated()
    params, opt_state, hist = run["params"], run["opt_state"], run["history"]
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != MOE_PARAMS:
        raise AssertionError(f"moe-train (a): {n_params} parameters, "
                             f"expected {MOE_PARAMS}")
    # a microbatch: each layer's forward once and once more in remat's
    # recompute, and one backward; in a MoE layer's backward the combine's
    # d ys and the dispatch's d x (relational_matmul on the transposed
    # relations) and the combine's d gates (tuple_dot; the dispatch's gates
    # are constant)
    per_step = {"flash_attention": 2 * TRAIN_ACCUM * cfg.n_layers,
                "flash_attention_bwd": TRAIN_ACCUM * cfg.n_layers,
                "moe_dispatch": 2 * TRAIN_ACCUM * n_moe,
                "relational_matmul": 2 * TRAIN_ACCUM * n_moe
                                     + 2 * TRAIN_ACCUM * n_moe,
                "tuple_dot": TRAIN_ACCUM * n_moe}
    expected = {name: 0 for name in counters} | {
        k: n * MOE_STEPS for k, n in per_step.items()}
    if launches != expected:
        raise AssertionError(f"moe-train (a) launches {launches}, expected "
                             f"{expected}")
    # the optimizer tail: one norm and one fused update a step, whatever
    # the number of leaves
    if optim_launches != {k: MOE_STEPS for k in optim_kernels}:
        raise AssertionError(f"moe-train (a) optimizer kernels' launches "
                             f"{optim_launches}, expected {MOE_STEPS} each")
    if not all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist):
        raise AssertionError(f"moe-train (a): a loss or norm is not finite: "
                             f"{hist}")
    # each microbatch routes every MoE layer in order, then again in the
    # backward's recompute (in reverse order); the recompute must route as
    # the forward did
    calls = routes.drops()
    per_mb = [calls[i:i + 2 * n_moe] for i in range(0, len(calls), 2 * n_moe)]
    if len(calls) != 2 * n_moe * TRAIN_ACCUM * MOE_STEPS or any(
            c[:n_moe] != c[n_moe:][::-1] for c in per_mb):
        raise AssertionError(f"moe-train (a): routing calls {calls}")
    drops = [c[:n_moe] for c in per_mb]
    assignments = TRAIN_BATCH // TRAIN_ACCUM * TRAIN_SEQ * m.top_k
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = [h["seconds"] for h in hist[1:]]
    # every relational_matmul call waits once for its first pass's status
    # flags, every moe_dispatch call once for its own (status_flag.cuh)
    waits = per_step["relational_matmul"] + per_step["moe_dispatch"]
    out = dict(
        model=cfg.name, layers=cfg.n_layers, moe_layers=n_moe,
        parameters=n_params, tokens_per_step=tokens, steps=len(hist),
        history=hist, step_s=step_s, step_s_mean=float(np.mean(step_s)),
        tokens_per_s=[tokens / t for t in step_s],
        launches=launches, launches_per_step=per_step,
        optim_launches=optim_launches,
        host_waits_per_step=waits, peak_bytes=peak,
        assignments_per_layer=assignments, drops_per_layer=drops)
    for h in hist:
        log(f"moe-train (a) step {h['step']}: {h['seconds'] * 1e3:.4f} ms, "
            f"{tokens / h['seconds']:.1f} tokens/s, loss {h['loss']:.6f}, "
            f"grad norm {h['grad_norm']:.6f}")
    log(f"moe-train (a): {MOE_STEPS} steps, launches {launches} ({per_step} "
        f"a step; {waits} host waits on status flags a step), peak device "
        f"memory {peak / 2**30:.2f} GiB; dropped assignments of "
        f"{assignments} a layer, each microbatch's layers in order: {drops}")
    batch = data.batch_at(MOE_STEPS)
    out["profile"] = device_profile(
        lambda: trainer.step_fn(params, opt_state, batch),
        out["step_s_mean"] * 1e3, "MoE training step (2 x 2 x 4096 tokens)",
        card, groups=MOE_KERNELS)
    return out


def moe_gradients(card):
    """(b) loss and every gradient leaf of the 2-layer full-width
    DeepSeek-V2-Lite (the dense layer and one MoE layer), float32 compute
    through the kernels, against float64 on the card with attention
    through the plain versions (``OracleAttention``) and the MoE through
    ``ref``'s plain versions called directly, the routing pinned to the
    float32 run's; bf16 compute beside it as a sanity reading."""
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import moe_dispatch as moe_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import relational_matmul as relmm_mod
    from repro_torch.kernels import tuple_dot as dot_mod
    from repro_torch.nn import layers, moe
    from repro_torch.nn.model import LM
    from repro_torch.tree import tree_map

    cfg = moe_train_config(MOE_GRAD_LAYERS)
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    lm = LM(cfg)
    gen = torch.Generator(device=lm.device)
    params = lm.init(gen.manual_seed(1))
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=GRAD_BATCH, seed=1).batch_at(0)
    compute, accum = layers.COMPUTE_DTYPE, layers.ACCUM_DTYPE
    wrappers = (flash_mod.flash_attention, flash_mod.flash_attention_bwd,
                moe_mod.moe_dispatch, relmm_mod.relational_matmul,
                dot_mod.tuple_dot)
    before = [w.launches for w in wrappers]
    layers.COMPUTE_DTYPE = torch.float32
    try:
        with RoutePin(moe) as routes:
            (l32, g32), t32 = timed(lambda: value_and_grad(lm, params, batch))
    finally:
        layers.COMPUTE_DTYPE = compute
    got = tuple(w.launches - b for w, b in zip(wrappers, before))
    want = (2 * cfg.n_layers, cfg.n_layers, 2 * n_moe, 4 * n_moe, n_moe)
    if got != want:
        raise AssertionError(f"moe-train (b) float32: launches {got} of "
                             f"(flash, flash_bwd, moe_dispatch, "
                             f"relational_matmul, tuple_dot), expected {want}")
    # the forward's routing, then the recompute's (remat="full"), equal
    fwd, again = routes.calls[:n_moe], routes.calls[n_moe:][::-1]
    if len(routes.calls) != 2 * n_moe or not all(
            torch.equal(a["idx"], b["idx"]) for a, b in zip(fwd, again)):
        raise AssertionError("moe-train (b): the recompute routed otherwise")
    (l16, g16), t16 = timed(lambda: value_and_grad(lm, params, batch))
    p64 = tree_map(lambda t: t.double(), params)
    del params
    lm64 = LM(dataclasses.replace(cfg, remat="none"))
    saved = ops.flash_attention, ops.moe_dispatch, ops.relational_matmul
    layers.COMPUTE_DTYPE = layers.ACCUM_DTYPE = torch.float64
    ops.flash_attention = (lambda q, k, v, causal=True, scale=None,
                           bf16_scores=False:
                           OracleAttention.apply(q, k, v, causal, scale))
    ops.moe_dispatch, ops.relational_matmul = (ref.moe_dispatch,
                                               ref.relational_matmul)
    try:
        with RoutePin(moe, replay=fwd) as replayed:
            (l64, g64), t64 = timed(lambda: value_and_grad(lm64, p64, batch))
    finally:
        layers.COMPUTE_DTYPE, layers.ACCUM_DTYPE = compute, accum
        ops.flash_attention, ops.moe_dispatch, ops.relational_matmul = saved
    fwd_drops = routes.drops()[:n_moe]
    if replayed.drops() != fwd_drops:
        raise AssertionError("moe-train (b): the pinned routing dropped "
                             "otherwise")
    del p64
    loss_rel = abs(float(l32) - float(l64)) / abs(float(l64))
    ratios32, ratios16 = [], []
    for a, c, w in zip(g32, g16, g64, strict=True):
        scale = float(w.abs().max()) or 1.0
        ratios32.append(float((a.double() - w).abs().max()) / scale)
        ratios16.append(float((c.double() - w).abs().max()) / scale)
    out = dict(layers=MOE_GRAD_LAYERS, tokens=GRAD_BATCH * TRAIN_SEQ,
               drops=fwd_drops,
               loss_f32=float(l32), loss_bf16=float(l16),
               loss_f64=float(l64), loss_rel=loss_rel,
               grad_ratio_f32=max(ratios32), grad_ratio_bf16=max(ratios16),
               ratios_f32=ratios32, ratios_bf16=ratios16,
               seconds=dict(f32=t32, bf16=t16, f64=t64))
    log(f"moe-train (b) on {card}: loss float32 {float(l32):.8f}, float64 "
        f"{float(l64):.8f} (relative {loss_rel:.3e}, bound {LOSS_REL}), bf16 "
        f"{float(l16):.8f}; largest |grad diff| / leaf max over {len(g64)} "
        f"leaves: float32 {max(ratios32):.3e} (bound {GRAD_REL}), bf16 "
        f"{max(ratios16):.3e} (a sanity reading, its own routing); the "
        f"routing pinned, {out['drops']} assignments dropped; "
        f"{t32:.2f} / {t16:.2f} / {t64:.2f} s")
    if loss_rel > LOSS_REL or max(ratios32) > GRAD_REL:
        raise AssertionError("moe-train (b): the float32 gradients miss the "
                             "float64 oracle")
    return out


def moe_train_path(counters, result):
    """Phase 12; frees everything it allocates (fails otherwise).  Returns
    (a)'s launches."""
    card = result["card"]
    if not torch.cuda.is_available():
        raise RuntimeError("moe-train: no CUDA device")
    held = held_bytes()
    t0 = time.perf_counter()
    out = {"trainer": moe_trainer(counters, card)}
    gc.collect()
    torch.cuda.empty_cache()
    out["gradients"] = moe_gradients(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    workspaces = torch.cuda.memory_allocated() - held
    left = held_bytes() - held
    out["memory"] = dict(allocated_before=held, cublas_workspaces=workspaces,
                         left=left)
    log(f"moe-train: phase 12 in {out['wall_s']:.1f} s; {held} B allocated "
        f"before it, {workspaces} B more after it, all of them cuBLAS "
        f"workspaces but {left} B")
    if left:
        raise AssertionError(f"moe-train: phase 12 left {left} B allocated")
    result["train_moe"] = out
    return out["trainer"]["launches"]


# ---------------------------------------------------------------------------
# phase 13: RWKV-6 training on the full-width RWKV-6 7B, cut in depth
# ---------------------------------------------------------------------------

# Every published width of RWKV-6 7B (arXiv:2404.05892: d_model 4096, 64
# heads of 64, d_ff 14336, vocab 65536), cut in depth because one card
# forces it: float32 parameters, gradients and AdamW's m and v take 16 bytes
# a parameter, 120.56 GB at 32 layers (7,534,944,256 parameters) and 50.58
# GB at 12 (3,161,153,536, counted leaf by leaf from the JAX package's
# LM.init shapes); past 75 GiB at its peak the phase fails, and the depth
# drops to 10 (2,723,774,464 parameters, 43.58 GB).  Phase 11's traffic and
# settings: the train_4k sequence, a global batch of 4 in 2 microbatches of
# 2 x 4096 tokens, AdamW 3e-4, clip 1.0, remat="full", loss "full", 1 warm
# step and 3 read.
RWKV_TRAIN_LAYERS = 12
RWKV_TRAIN_PARAMS = 3_161_153_536
RWKV_PEAK_LIMIT = 75 * 2 ** 30
#: device kernels of the RWKV-6 training step by name, for the profile
RWKV_KERNELS = {"rwkv6_scan (forward)": r"rwkv6_fwd",
                "rwkv6_scan_bwd": r"rwkv6_bwd"}


class OracleScan(torch.autograd.Function):
    """The recurrence through the plain versions, ``ref.rwkv6_scan``
    forward and ``ref.rwkv6_scan_bwd`` backward (states recomputed from
    checkpoints: autograd of the plain loop would keep all 4096 states, 17
    GB a layer in float64).  An oracle only; the port never calls it."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        from repro_torch.kernels import ref
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return ref.rwkv6_scan(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, do, ds_fin):
        from repro_torch.kernels import ref
        r, k, v, w, u, s0 = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        return ref.rwkv6_scan_bwd(r, k, v, w, u, s0, do, ds_fin,
                                  ctx.needs_input_grad[5])


#: the op groups of an RWKV-6 layer that phase 13 (b) rounds to float32 one
#: at a time in the float64 model ("none": the layers as written, which must
#: give the float64 gradients again); the scan kernels' reading is the run
#: with the recurrence alone through them
RWKV_OP_GROUPS = ("none", "group norm", "token-shift mixes",
                  "float32 products")


def rounded_rwkv_layers(group: str):
    """``nn/ssm.py``'s ``rwkv6_time_mix`` and ``rwkv6_channel_mix`` as the
    float64 training step runs them (no state; the recurrence through
    ``ops.rwkv6_scan``), with one op group in float32, forward and
    backward: the per-head group norm, the token-shift mixes x + (x_{t-1}
    - x) mu, or the layers' products (the projections, the decay's LoRA,
    the output and the channel mix, float32 on the card without TF32).  A
    reading for phase 13 (b); the port never calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.nn import ssm as S

    def mm(a, b):
        if group == "float32 products":
            return (a.float() @ b.float()).double()
        return a @ b

    def mix(x, xs, mu):
        if group == "token-shift mixes":
            x, xs, mu = x.float(), xs.float(), mu.float()
        return (x + (xs - x) * mu).double()

    def time_mix(p, x, n_heads, state=None):
        assert state is None
        b, s, d = x.shape
        n = d // n_heads
        xs = S._token_shift(x, torch.zeros_like(x[:, :1]))
        m = {nm: mix(x, xs, p["mu"][nm]) for nm in S._MIX}
        r, k, v = (mm(m[nm], p[f"w{nm}"]) for nm in "rkv")
        g = F.silu(mm(m["g"], p["wg"]))
        lora = mm(torch.tanh(mm(m["w"], p["w_lora_a"])), p["w_lora_b"])
        w = torch.exp(-torch.exp(p["w0"] + lora))
        heads = lambda t: t.reshape(b, s, n_heads, n).transpose(1, 2)
        o, s_fin = ops.rwkv6_scan(
            heads(r), heads(k), heads(v), heads(w),
            p["u"].expand(b, n_heads, n),
            x.new_zeros((b, n_heads, n, n)))
        o = o.transpose(1, 2)
        if group == "group norm":
            o = o.float()
        mu = o.mean(-1, keepdim=True)
        var = o.var(-1, keepdim=True, unbiased=False)
        o = ((o - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
        o = o * p["ln_x"]["w"].to(o.dtype) + p["ln_x"]["b"].to(o.dtype)
        return mm(o.double() * g, p["wo"]), (x[:, -1:], s_fin)

    def channel_mix(p, x, state=None):
        assert state is None
        xs = S._token_shift(x, torch.zeros_like(x[:, :1]))
        xk, xr = mix(x, xs, p["mu_k"]), mix(x, xs, p["mu_r"])
        h = torch.square(torch.relu(mm(xk, p["wk"])))
        return torch.sigmoid(mm(xr, p["wr"])) * mm(h, p["wv"]), x[:, -1:]

    return time_mix, channel_mix


def grad_ratio(grads, want) -> tuple[float, int]:
    """The largest |grad diff| / leaf max over the leaves, and its leaf."""
    ratios = [float((g.double() - w).abs().max()) / (float(w.abs().max())
                                                     or 1.0)
              for g, w in zip(grads, want, strict=True)]
    worst = max(range(len(ratios)), key=ratios.__getitem__)
    return ratios[worst], worst


def leaf_names(tree, prefix: str = "") -> list[str]:
    """The path of each leaf of ``tree``, in ``tree.leaves``' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


def scan_at_layer_inputs(cfg, params, batch) -> list[dict]:
    """Both scan kernels on the operands each layer hands them in a float32
    training step (remat off, so each layer's o takes its gradient once),
    against the plain versions in float64: each output's largest |diff| in
    units of its largest magnitude, and the operands' magnitudes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan as scan_mod
    from repro_torch.nn import layers
    from repro_torch.nn.model import LM

    lm = LM(dataclasses.replace(cfg, remat="none"))
    seen, kernel = [], ops.rwkv6_scan

    def capture(r, k, v, w, u, s0):
        o, s_fin = kernel(r, k, v, w, u, s0)
        rec = dict(args=[t.detach() for t in (r, k, v, w, u, s0)])
        o.register_hook(lambda g: rec.update(do=g.detach()))
        seen.append(rec)
        return o, s_fin

    compute = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE, ops.rwkv6_scan = torch.float32, capture
    try:
        value_and_grad(lm, params, batch)
    finally:
        layers.COMPUTE_DTYPE, ops.rwkv6_scan = compute, kernel
    rel = lambda a, w: float((a.double() - w).abs().max()) / float(
        w.abs().max())
    out = []
    for rec in seen:
        args, do = rec["args"], rec["do"]
        a64 = [t.double() for t in args]
        o64, s64 = ref.rwkv6_scan(*a64)
        o, s_fin = scan_mod.rwkv6_scan(*args)
        errs = dict(o=rel(o, o64), s_fin=rel(s_fin, s64))
        del o64, s64, o, s_fin
        grads = scan_mod.rwkv6_scan_bwd(*args, do, None, False)
        want = ref.rwkv6_scan_bwd(*a64, do.double(), None, False)
        errs |= {nm: rel(g, w) for nm, g, w in
                 zip(("dr", "dk", "dv", "dw", "du"), grads, want)}
        out.append(dict(
            errors=errs,
            max_abs={nm: float(t.abs().max()) for nm, t in
                     zip(("r", "k", "v", "u", "do"),
                         (*args[:3], args[4], do))},
            w_range=(float(args[3].min()), float(args[3].max()))))
        del a64, grads, want
    return out


def rwkv_train_config(layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("rwkv6_7b"), n_layers=layers)


def rwkv_trainer(counters, card):
    """(a) ``Trainer`` on the 12-layer full-width RWKV-6 7B: the counts are
    zeroed just before ``run`` and read just after it."""
    from repro_torch.data import TokenPipeline
    from repro_torch.nn.model import LM
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves

    cfg = rwkv_train_config(RWKV_TRAIN_LAYERS)
    lm = LM(cfg)
    data = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH)
    trainer = Trainer(lm, adamw(3e-4), data, grad_accum=TRAIN_ACCUM)
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(0)
    log(f"rwkv-train (a): {cfg.name} at {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.d_model // cfg.n_heads}"
        f", d_ff {cfg.d_ff}, vocab {cfg.vocab}, remat {cfg.remat}, loss "
        f"{cfg.loss_impl}; global batch {TRAIN_BATCH} x {TRAIN_SEQ} in "
        f"{TRAIN_ACCUM} microbatches, AdamW 3e-4, on {card}")
    torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    run = trainer.run(gen, TRAIN_STEPS, log_every=0)
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    params, opt_state, hist = run["params"], run["opt_state"], run["history"]
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != RWKV_TRAIN_PARAMS:
        raise AssertionError(f"rwkv-train (a): {n_params} parameters, "
                             f"expected {RWKV_TRAIN_PARAMS}")
    # a microbatch: each layer's recurrence once and once more in remat's
    # recompute, and one backward
    per_step = {"rwkv6_scan": 2 * TRAIN_ACCUM * cfg.n_layers,
                "rwkv6_scan_bwd": TRAIN_ACCUM * cfg.n_layers}
    expected = {name: 0 for name in counters} | {
        k: n * TRAIN_STEPS for k, n in per_step.items()}
    if launches != expected:
        raise AssertionError(f"rwkv-train (a) launches {launches}, expected "
                             f"{expected}")
    if not all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist):
        raise AssertionError(f"rwkv-train (a): a loss or norm is not "
                             f"finite: {hist}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = [h["seconds"] for h in hist[1:]]
    out = dict(
        model=cfg.name, layers=cfg.n_layers, parameters=n_params,
        tokens_per_step=tokens, steps=len(hist), history=hist,
        step_s=step_s, step_s_mean=float(np.mean(step_s)),
        tokens_per_s=[tokens / t for t in step_s],
        launches=launches, launches_per_step=per_step, peak_bytes=peak)
    for h in hist:
        log(f"rwkv-train (a) step {h['step']}: {h['seconds'] * 1e3:.4f} ms, "
            f"{tokens / h['seconds']:.1f} tokens/s, loss {h['loss']:.6f}, "
            f"grad norm {h['grad_norm']:.6f}")
    log(f"rwkv-train (a): {TRAIN_STEPS} steps, launches {launches} "
        f"({per_step} a step), peak device memory {peak / 2**30:.2f} GiB")
    if peak > RWKV_PEAK_LIMIT:
        raise AssertionError(f"rwkv-train (a): peak {peak / 2**30:.2f} GiB "
                             "past 75 GiB: drop to 10 layers")
    batch = data.batch_at(TRAIN_STEPS)
    out["profile"] = device_profile(
        lambda: trainer.step_fn(params, opt_state, batch),
        out["step_s_mean"] * 1e3, "RWKV-6 training step (2 x 2 x 4096 "
        "tokens)", card, groups=RWKV_KERNELS)
    return out


def rwkv_margin_split(lm, p64, batch, g64, l64, names) -> dict:
    """Where phase 13 (b)'s float32 margin comes from: the float64 model
    (the caller's settings: float64 compute, the recurrence through
    ``OracleScan``) with one op group of ``RWKV_OP_GROUPS`` at a time in
    float32.  Fails unless the layers' twin with nothing in float32 gives
    the float64 gradients again."""
    from repro_torch.nn import ssm as S

    layer_fns = S.rwkv6_time_mix, S.rwkv6_channel_mix
    split = {}
    try:
        for group in RWKV_OP_GROUPS:
            S.rwkv6_time_mix, S.rwkv6_channel_mix = rounded_rwkv_layers(
                group)
            (lg, gg), tg = timed(lambda: value_and_grad(lm, p64, batch))
            ratio, worst = grad_ratio(gg, g64)
            split[group] = dict(grad_ratio=ratio, worst_leaf=names[worst],
                                loss_rel=abs(float(lg) - float(l64))
                                / abs(float(l64)), seconds=tg)
            del gg
    finally:
        S.rwkv6_time_mix, S.rwkv6_channel_mix = layer_fns
    if split["none"]["grad_ratio"] > 1e-10:
        raise AssertionError("rwkv-train (b): the op-group twin of the "
                             "layers misses the float64 model: "
                             f"{split['none']}")
    return split


def rwkv_gradients(card, margin_split=False):
    """(b) loss and every gradient leaf of the 2-layer full-width RWKV-6
    7B, float32 compute through both scan kernels, against float64 on the
    card with the recurrence through the plain versions (``OracleScan``);
    bf16 compute beside it as a sanity reading; with ``margin_split``,
    ``rwkv_margin_split`` too, and the scan kernels' share beside it."""
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as scan_mod
    from repro_torch.nn import layers
    from repro_torch.nn.model import LM
    from repro_torch.tree import tree_map

    cfg = rwkv_train_config(GRAD_LAYERS)
    lm = LM(cfg)
    gen = torch.Generator(device=lm.device)
    params = lm.init(gen.manual_seed(1))
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=GRAD_BATCH, seed=1).batch_at(0)
    compute, accum = layers.COMPUTE_DTYPE, layers.ACCUM_DTYPE
    wrappers = (scan_mod.rwkv6_scan, scan_mod.rwkv6_scan_bwd)
    before = [w.launches for w in wrappers]
    layers.COMPUTE_DTYPE = torch.float32
    try:
        (l32, g32), t32 = timed(lambda: value_and_grad(lm, params, batch))
    finally:
        layers.COMPUTE_DTYPE = compute
    got = tuple(w.launches - b for w, b in zip(wrappers, before))
    if got != (2 * GRAD_LAYERS, GRAD_LAYERS):
        raise AssertionError(f"rwkv-train (b) float32: scan launches {got}, "
                             f"expected {(2 * GRAD_LAYERS, GRAD_LAYERS)}")
    (l16, g16), t16 = timed(lambda: value_and_grad(lm, params, batch))
    # a reading beside it: float32 with the recurrence through the plain
    # versions, which no kernel's rounding reaches
    plain = ops.rwkv6_scan
    layers.COMPUTE_DTYPE, ops.rwkv6_scan = torch.float32, OracleScan.apply
    try:
        (lp, gp), tp = timed(lambda: value_and_grad(lm, params, batch))
    finally:
        layers.COMPUTE_DTYPE, ops.rwkv6_scan = compute, plain
    at_inputs = scan_at_layer_inputs(cfg, params, batch)
    names = leaf_names(params)
    p64 = tree_map(lambda t: t.double(), params)
    del params
    layers.COMPUTE_DTYPE = layers.ACCUM_DTYPE = torch.float64
    ops.rwkv6_scan = OracleScan.apply
    try:
        (l64, g64), t64 = timed(lambda: value_and_grad(lm, p64, batch))
        # a reading: the model in float64 with only the recurrence through
        # the float32 kernels, which bounds what they add to the gradients
        ops.rwkv6_scan = lambda *a: tuple(
            t.double() for t in plain(*(x.float() for x in a)))
        (lk, gk), tk = timed(lambda: value_and_grad(lm, p64, batch))
        ratiosk = [float((x - w).abs().max()) / (float(w.abs().max()) or 1.0)
                   for x, w in zip(gk, g64, strict=True)]
        del gk
        split = {}
        if margin_split:
            ops.rwkv6_scan = OracleScan.apply
            split = rwkv_margin_split(lm, p64, batch, g64, l64, names)
            worst = max(range(len(ratiosk)), key=ratiosk.__getitem__)
            split["scan kernels"] = dict(
                grad_ratio=ratiosk[worst], worst_leaf=names[worst],
                loss_rel=abs(float(lk) - float(l64)) / abs(float(l64)),
                seconds=tk)
    finally:
        layers.COMPUTE_DTYPE, layers.ACCUM_DTYPE = compute, accum
        ops.rwkv6_scan = plain
    del p64
    loss_rel = abs(float(l32) - float(l64)) / abs(float(l64))
    ratios32, ratios16, ratiosp = [], [], []
    for a, c, q, w in zip(g32, g16, gp, g64, strict=True):
        scale = float(w.abs().max()) or 1.0
        ratios32.append(float((a.double() - w).abs().max()) / scale)
        ratios16.append(float((c.double() - w).abs().max()) / scale)
        ratiosp.append(float((q.double() - w).abs().max()) / scale)
    worst = sorted(range(len(names)), key=lambda i: -ratios32[i])[:4]
    out = dict(layers=GRAD_LAYERS, tokens=GRAD_BATCH * TRAIN_SEQ,
               loss_f32=float(l32), loss_bf16=float(l16),
               loss_f32_plain=float(lp), loss_f64=float(l64),
               loss_rel=loss_rel, grad_ratio_f32=max(ratios32),
               grad_ratio_bf16=max(ratios16),
               grad_ratio_f32_plain=max(ratiosp),
               grad_ratio_f64_kernels=max(ratiosk),
               loss_f64_kernels=float(lk),
               ratios_f32=dict(zip(names, ratios32)),
               ratios_f32_plain=dict(zip(names, ratiosp)),
               ratios_bf16=dict(zip(names, ratios16)),
               scan_at_layer_inputs=at_inputs,
               seconds=dict(f32=t32, bf16=t16, f32_plain=tp, f64=t64,
                            f64_kernels=tk))
    log(f"rwkv-train (b) on {card}: loss float32 {float(l32):.8f}, float64 "
        f"{float(l64):.8f} (relative {loss_rel:.3e}, bound {LOSS_REL}), "
        f"bf16 {float(l16):.8f}; largest |grad diff| / leaf max over "
        f"{len(g64)} leaves: float32 {max(ratios32):.3e} (bound "
        f"{GRAD_REL}), bf16 {max(ratios16):.3e} (a sanity reading), float32 "
        f"with the recurrence through the plain versions {max(ratiosp):.3e} "
        f"(a reading), float64 with the recurrence alone through the "
        f"float32 kernels {max(ratiosk):.3e} (a reading); {t32:.2f} / "
        f"{t16:.2f} / {tp:.2f} / {t64:.2f} / {tk:.2f} s")
    log("rwkv-train (b): the largest float32 leaves (kernels / plain "
        "versions): " + ", ".join(
            f"{names[i]} {ratios32[i]:.3e} / {ratiosp[i]:.3e}"
            for i in worst))
    if split:
        out["op_groups_in_f32"] = split
        log("rwkv-train (b): where the float32 margin comes from, the "
            "float64 model with one op group in float32 (largest |grad "
            "diff| / leaf max, its leaf, the loss's relative difference): "
            + "; ".join(f"{grp} {x['grad_ratio']:.3e} ({x['worst_leaf']}, "
                        f"loss {x['loss_rel']:.2e})"
                        for grp, x in split.items()))
    for i, rec in enumerate(at_inputs):
        log(f"rwkv-train (b): layer {i}'s scan operands (max |r| "
            f"{rec['max_abs']['r']:.3f}, |k| {rec['max_abs']['k']:.3f}, |v| "
            f"{rec['max_abs']['v']:.3f}, w in [{rec['w_range'][0]:.4f}, "
            f"{rec['w_range'][1]:.4f}], |do| {rec['max_abs']['do']:.3e}): "
            "the kernels against float64, |diff| / max: " + ", ".join(
                f"{nm} {e:.3e}" for nm, e in rec["errors"].items()))
    if loss_rel > LOSS_REL or max(ratios32) > GRAD_REL:
        raise AssertionError("rwkv-train (b): the float32 gradients miss the "
                             "float64 oracle")
    return out


def rwkv_train_path(counters, result):
    """Phase 13; frees everything it allocates (fails otherwise).  Returns
    (a)'s launches."""
    card = result["card"]
    if not torch.cuda.is_available():
        raise RuntimeError("rwkv-train: no CUDA device")
    held = held_bytes()
    t0 = time.perf_counter()
    out = {"trainer": rwkv_trainer(counters, card)}
    gc.collect()
    torch.cuda.empty_cache()
    out["gradients"] = rwkv_gradients(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    workspaces = torch.cuda.memory_allocated() - held
    left = held_bytes() - held
    out["memory"] = dict(allocated_before=held, cublas_workspaces=workspaces,
                         left=left)
    log(f"rwkv-train: phase 13 in {out['wall_s']:.1f} s; {held} B allocated "
        f"before it, {workspaces} B more after it, all of them cuBLAS "
        f"workspaces but {left} B")
    if left:
        raise AssertionError(f"rwkv-train: phase 13 left {left} B allocated")
    result["train_rwkv"] = out
    return out["trainer"]["launches"]


# ---------------------------------------------------------------------------
# phase 14: hybrid training on the full-width Zamba2-2.7B
# ---------------------------------------------------------------------------

# Every published width of Zamba2-2.7B (arXiv:2411.15242: 54 Mamba-2 layers
# of d_model 2560, 80 heads of 64, d_state 64, chunk 64; a shared attention
# + SwiGLU block of 32 heads of 80 and d_ff 10240 before every 6; vocab
# 32000) at its full depth: float32 parameters, gradients and AdamW's m and
# v take 16 bytes a parameter, 38.97 GB for ZAMBA_PARAMS.  Past
# ZAMBA_PEAK_LIMIT at its peak the phase fails, and the depth drops by a
# whole segment of 6 (48 layers: 2,196,196,096 parameters, 35.14 GB), since
# n_layers // shared_attn_every segments run.  Phase 11's traffic: the
# train_4k sequence (4096, a whole number of the SSD's 64-token chunks), a
# global batch of 4 in 2 microbatches of 2 x 4096 tokens, AdamW 3e-4, clip
# 1.0, remat="full" (the Mamba layers; the shared block runs plain, as in
# JAX), loss "full", 1 warm step and 3 read.
ZAMBA_TRAIN_LAYERS = 54
ZAMBA_TRAIN_PARAMS = ZAMBA_PARAMS
ZAMBA_PEAK_LIMIT = 75 * 2 ** 30
#: device kernels of the hybrid training step by name, for the profile
ZAMBA_KERNELS = {"flash_attention (forward)": r"flash(?!_bwd)",
                 "flash_attention_bwd": r"flash_bwd"}
# (b) the gradients on the shared block and 2 Mamba-2 layers at the same
# width (a shared block every min(6, depth) layers, as phase 8 cuts it),
# one microbatch of 2 x 4096, float32 compute against float64 on the card
# (the SSD raised with layers.ACCUM_DTYPE, attention through the plain
# versions), phase 11's bound, bf16 beside it as a reading
ZAMBA_GRAD_LAYERS = 2


def zamba_train_config(layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("zamba2_2_7b"), n_layers=layers,
                               shared_attn_every=min(ZAMBA_SEGMENT, layers))


def zamba_trainer(counters, card):
    """(a) ``Trainer`` on the full-width Zamba2-2.7B: the counts are zeroed
    just before ``run`` and read just after it."""
    from repro_torch.data import TokenPipeline
    from repro_torch.nn.model import LM
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves

    cfg = zamba_train_config(ZAMBA_TRAIN_LAYERS)
    lm = LM(cfg)
    data = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH)
    trainer = Trainer(lm, adamw(3e-4), data, grad_accum=TRAIN_ACCUM)
    gen = torch.Generator(device=lm.device)
    gen.manual_seed(0)
    uses = cfg.n_layers // cfg.shared_attn_every
    log(f"hybrid-train (a): {cfg.name} at {cfg.n_layers} Mamba-2 layers, "
        f"d_model {cfg.d_model}, {cfg.d_model * cfg.ssm.expand // cfg.ssm.head_dim}"
        f" heads of {cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, chunk "
        f"{cfg.ssm.chunk}; the shared block ({cfg.n_heads} heads of "
        f"{cfg.d_head}, d_ff {cfg.d_ff}) {uses} times; vocab {cfg.vocab}, "
        f"remat {cfg.remat}, loss {cfg.loss_impl}; global batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_ACCUM} microbatches, AdamW "
        f"3e-4, on {card}")
    torch.cuda.reset_peak_memory_stats()
    zero_launches(counters)
    run = trainer.run(gen, TRAIN_STEPS, log_every=0)
    launches = read_launches(counters)
    peak = torch.cuda.max_memory_allocated()
    params, opt_state, hist = run["params"], run["opt_state"], run["history"]
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != ZAMBA_TRAIN_PARAMS:
        raise AssertionError(f"hybrid-train (a): {n_params} parameters, "
                             f"expected {ZAMBA_TRAIN_PARAMS}")
    # a microbatch: each use of the shared block once (it is not under
    # remat, so nothing recomputes its attention), and one backward each
    per_step = {"flash_attention": TRAIN_ACCUM * uses,
                "flash_attention_bwd": TRAIN_ACCUM * uses}
    expected = {name: 0 for name in counters} | {
        k: n * TRAIN_STEPS for k, n in per_step.items()}
    if launches != expected:
        raise AssertionError(f"hybrid-train (a) launches {launches}, "
                             f"expected {expected}")
    if not all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist):
        raise AssertionError(f"hybrid-train (a): a loss or norm is not "
                             f"finite: {hist}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = [h["seconds"] for h in hist[1:]]
    out = dict(
        model=cfg.name, layers=cfg.n_layers, parameters=n_params,
        tokens_per_step=tokens, steps=len(hist), history=hist,
        step_s=step_s, step_s_mean=float(np.mean(step_s)),
        tokens_per_s=[tokens / t for t in step_s],
        launches=launches, launches_per_step=per_step, peak_bytes=peak)
    for h in hist:
        log(f"hybrid-train (a) step {h['step']}: {h['seconds'] * 1e3:.4f} "
            f"ms, {tokens / h['seconds']:.1f} tokens/s, loss "
            f"{h['loss']:.6f}, grad norm {h['grad_norm']:.6f}")
    log(f"hybrid-train (a): {TRAIN_STEPS} steps, launches {launches} "
        f"({per_step} a step), peak device memory {peak / 2**30:.2f} GiB")
    if peak > ZAMBA_PEAK_LIMIT:
        raise AssertionError(f"hybrid-train (a): peak {peak / 2**30:.2f} GiB "
                             "past 75 GiB: drop a segment (48 layers)")
    batch = data.batch_at(TRAIN_STEPS)
    out["profile"] = device_profile(
        lambda: trainer.step_fn(params, opt_state, batch),
        out["step_s_mean"] * 1e3, "Zamba2 training step (2 x 2 x 4096 "
        "tokens)", card, groups=ZAMBA_KERNELS, cpu=False)
    return out


def zamba_gradients(card):
    """(b) loss and every gradient leaf of the shared block and 2 Mamba-2
    layers at full width, float32 compute through both flash kernels,
    against float64 on the card (``layers.ACCUM_DTYPE`` raised, so the SSD
    runs in float64 too; attention through the plain versions); bf16
    compute beside it as a sanity reading."""
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    from repro_torch.nn import layers
    from repro_torch.nn.model import LM
    from repro_torch.tree import tree_map

    cfg = zamba_train_config(ZAMBA_GRAD_LAYERS)
    lm = LM(cfg)
    gen = torch.Generator(device=lm.device)
    params = lm.init(gen.manual_seed(1))
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=GRAD_BATCH, seed=1).batch_at(0)
    names = leaf_names(params)
    compute, accum = layers.COMPUTE_DTYPE, layers.ACCUM_DTYPE
    wrappers = (flash_mod.flash_attention, flash_mod.flash_attention_bwd)
    before = [w.launches for w in wrappers]
    layers.COMPUTE_DTYPE = torch.float32
    try:
        (l32, g32), t32 = timed(lambda: value_and_grad(lm, params, batch))
    finally:
        layers.COMPUTE_DTYPE = compute
    got = tuple(w.launches - b for w, b in zip(wrappers, before))
    uses = cfg.n_layers // cfg.shared_attn_every
    if got != (uses, uses):
        raise AssertionError(f"hybrid-train (b) float32: flash launches "
                             f"{got}, expected {(uses, uses)}")
    (l16, g16), t16 = timed(lambda: value_and_grad(lm, params, batch))
    p64 = tree_map(lambda t: t.double(), params)
    del params
    plain = ops.flash_attention
    layers.COMPUTE_DTYPE = layers.ACCUM_DTYPE = torch.float64
    ops.flash_attention = (lambda q, k, v, causal=True, scale=None,
                           bf16_scores=False:
                           OracleAttention.apply(q, k, v, causal, scale))
    try:
        (l64, g64), t64 = timed(lambda: value_and_grad(lm, p64, batch))
    finally:
        layers.COMPUTE_DTYPE, layers.ACCUM_DTYPE = compute, accum
        ops.flash_attention = plain
    del p64
    loss_rel = abs(float(l32) - float(l64)) / abs(float(l64))
    ratio32, worst32 = grad_ratio(g32, g64)
    ratio16, _ = grad_ratio(g16, g64)
    ratios32 = [grad_ratio([a], [w])[0] for a, w in zip(g32, g64)]
    top = sorted(range(len(names)), key=lambda i: -ratios32[i])[:4]
    out = dict(layers=cfg.n_layers, shared_attn_every=cfg.shared_attn_every,
               tokens=GRAD_BATCH * TRAIN_SEQ, loss_f32=float(l32),
               loss_bf16=float(l16), loss_f64=float(l64), loss_rel=loss_rel,
               grad_ratio_f32=ratio32, worst_leaf_f32=names[worst32],
               grad_ratio_bf16=ratio16,
               ratios_f32=dict(zip(names, ratios32)),
               seconds=dict(f32=t32, bf16=t16, f64=t64))
    log(f"hybrid-train (b) on {card}: the shared block and "
        f"{cfg.n_layers} Mamba-2 layers, loss float32 {float(l32):.8f}, "
        f"float64 {float(l64):.8f} (relative {loss_rel:.3e}, bound "
        f"{LOSS_REL}), bf16 {float(l16):.8f}; largest |grad diff| / leaf "
        f"max over {len(g64)} leaves: float32 {ratio32:.3e} ({names[worst32]}"
        f"; bound {GRAD_REL}), bf16 {ratio16:.3e} (a sanity reading); "
        f"{t32:.2f} / {t16:.2f} / {t64:.2f} s; the largest float32 leaves: "
        + ", ".join(f"{names[i]} {ratios32[i]:.3e}" for i in top))
    if loss_rel > LOSS_REL or ratio32 > GRAD_REL:
        raise AssertionError("hybrid-train (b): the float32 gradients miss "
                             "the float64 oracle")
    return out


def zamba_train_path(counters, result):
    """Phase 14; frees everything it allocates (fails otherwise).  Returns
    (a)'s launches."""
    card = result["card"]
    held = held_bytes()
    t0 = time.perf_counter()
    out = {"trainer": zamba_trainer(counters, card)}
    gc.collect()
    torch.cuda.empty_cache()
    out["gradients"] = zamba_gradients(card)
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    workspaces = torch.cuda.memory_allocated() - held
    left = held_bytes() - held
    out["memory"] = dict(allocated_before=held, cublas_workspaces=workspaces,
                         left=left)
    log(f"hybrid-train: phase 14 in {out['wall_s']:.1f} s; {held} B "
        f"allocated before it, {workspaces} B more after it, all of them "
        f"cuBLAS workspaces but {left} B")
    if left:
        raise AssertionError(f"hybrid-train: phase 14 left {left} B "
                             "allocated")
    result["train_hybrid"] = out
    return out["trainer"]["launches"]


# ---------------------------------------------------------------------------
# phase 15: the expert-parallel MoE layer and the roofline on the card
# ---------------------------------------------------------------------------

# (a) impl="shard" on one full-width DeepSeek-V2-Lite MoE layer (d_model
# 2048, 64 experts of 1408, top-6, 2 shared), phase 7 (d)'s 8000 tokens, in
# float32, on a (data 1, model 1) mesh over a one-rank NCCL group: the
# owner fills all 64 experts through one moe_dispatch and combines through
# one relational_matmul, the all_reduce over 'model' runs on one rank.
# Held against the layer's plain version (the array form, no kernel: at
# 8000 tokens both take one group and the same capacity) at phase 7 (d)'s
# MOE_IMPL_TOL.  (b) four expert owners on one card, each _moe_sort_local
# over its 16 experts, summed, against the full range at OWNER_TOL, the
# bound of tests/test_moe.py::test_shard_partials_sum_to_full.  (c) the
# dry-run's count of phase 11 (a)'s Yi-6B step (12 layers, 2 microbatches
# of 2 x 4096, AdamW) on a (1, 1) mesh of one placeholder rank, beside the
# step phase 11 measured: the modelled step may not exceed the measured
# one by more than ROOFLINE_SLACK, since a step faster than its bound
# means the count is wrong.
OWNERS = 4
OWNER_TOL = dict(rtol=2e-3, atol=2e-4)
ROOFLINE_SLACK = 1.05


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def moe_shard_layer(counters, card, device="cuda", backend="nccl") -> dict:
    """Phase 15 (a) and (b); destroys the process group it makes.
    ``device`` / ``backend``: the CPU and gloo rehearse it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.nn import layers, moe
    from repro_torch.nn.model import _moe_cfg

    cfg = get_config("deepseek_v2_lite_16b")
    mcfg = _moe_cfg(cfg)
    t, e = PREFILL_BATCH * PREFILL_LEN, mcfg.n_experts
    p = moe.init_moe(torch.Generator(device=device).manual_seed(0), mcfg)
    x = torch.randn((t, cfg.d_model), device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    store = dist.TCPStore("127.0.0.1", free_port(), 1, is_master=True)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    layers.COMPUTE_DTYPE = torch.float32
    try:
        mesh = init_device_mesh(device, (1, 1),
                                mesh_dim_names=("data", "model"))
        moe.set_moe_mesh(mesh, ("data",))
        shard = dataclasses.replace(mcfg, impl="shard")
        run = lambda: moe.moe_ffn(p, x, shard)
        zero_launches(counters)
        (y, _), first_s = timed(run)
        launched = {n: c for n, c in read_launches(counters).items() if c}
        if launched != {"moe_dispatch": 1, "relational_matmul": 1}:
            raise AssertionError(f"moe-shard (a) launches {launched}")
        plain, _ = moe.moe_ffn(p, x, dataclasses.replace(mcfg,
                                                         impl="einsum"))
        err = max_err(y, plain, MOE_IMPL_TOL,
                      "moe-shard (a) against the array form")
        ms = time_ms(run, iters=3, warmup=1)
        plain_ms = time_ms(lambda: moe.moe_ffn(
            p, x, dataclasses.replace(mcfg, impl="einsum")), iters=3,
            warmup=1)
        del y, plain
        gates, idx, _ = moe._route(p, x, mcfg)
        cap = moe._capacity(t, mcfg)
        full = moe._moe_sort_local(p["wi"], p["wg"], p["wo"], x, mcfg,
                                   gates, idx, 0, e, cap)
        e_loc = e // OWNERS
        parts = sum(moe._moe_sort_local(
            p["wi"][lo:lo + e_loc], p["wg"][lo:lo + e_loc],
            p["wo"][lo:lo + e_loc], x, mcfg, gates, idx, lo, e_loc, cap)
            for lo in range(0, e, e_loc))
        owners_err = max_err(parts, full, OWNER_TOL,
                             "moe-shard (b) four owners against the full "
                             "range")
    finally:
        moe.set_moe_mesh(None, None)
        layers.COMPUTE_DTYPE = torch.bfloat16
        dist.destroy_process_group()
    out = dict(tokens=t, experts=e, capacity=cap, launches=launched,
               first_s=first_s, ms=ms, plain_ms=plain_ms, max_abs_err=err,
               tolerance=MOE_IMPL_TOL, owners=OWNERS,
               owners_max_abs_err=owners_err, owners_tolerance=OWNER_TOL)
    log(f"moe-shard (a) impl=shard, one DeepSeek-V2-Lite MoE layer, {t} "
        f"tokens, float32, (data 1, model 1) {backend} mesh on {card}: "
        f"{ms:.4f} ms (first call {first_s:.4f} s), launches {launched}, "
        f"max |err| {err:.3e} against the array form ({plain_ms:.4f} ms; "
        f"held at {MOE_IMPL_TOL})")
    log(f"moe-shard (b) {OWNERS} owners of {e_loc} experts summed against "
        f"the full range on {card}: max |err| {owners_err:.3e} (held at "
        f"{OWNER_TOL})")
    return out


def roofline_step(result, card) -> dict:
    """Phase 15 (c): the dry-run's count of phase 11 (a)'s step beside its
    measured step."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis

    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=TRAIN_LAYERS)
    shape = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    dryrun.placeholder_group(1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        flops, hbm, wire, by_kind = dryrun.measure_costs(
            cfg, shape, mesh, True, grad_accum=TRAIN_ACCUM)
    finally:
        dist.destroy_process_group()
    rl = analysis.roofline(flops, hbm, wire,
                           analysis.model_flops(cfg, shape, 1), by_kind)
    measured = result["train"]["trainer"]["step_s_mean"]
    ratio = rl.step_s / measured
    out = dict(flops=flops, hbm_bytes=hbm, wire_bytes=wire,
               terms_s=dict(compute=rl.compute_s, memory=rl.memory_s,
                            collective=rl.collective_s),
               bottleneck=rl.bottleneck, modelled_step_s=rl.step_s,
               measured_step_s=measured, modelled_over_measured=ratio,
               roofline_fraction=rl.roofline_fraction,
               measured_fraction=rl.model_flops / analysis.PEAK_FLOPS
               / measured, count_s=time.perf_counter() - t0)
    log(f"roofline (c) Yi-6B, {TRAIN_LAYERS} layers, {TRAIN_ACCUM} x "
        f"{TRAIN_BATCH // TRAIN_ACCUM} x {TRAIN_SEQ} tokens, AdamW, "
        f"counted on a (1, 1) mesh (modelled, {out['count_s']:.1f} s): "
        f"{flops:.4e} FLOPs, {hbm:.4e} bytes (unfused), {wire:.4e} wire "
        f"bytes; compute {rl.compute_s:.4f} s, memory {rl.memory_s:.4f} s, "
        f"collective {rl.collective_s:.4f} s, bottleneck {rl.bottleneck}, "
        f"roofline_fraction {rl.roofline_fraction:.4f}; measured in phase "
        f"11 (a) on {card}: {measured:.4f} s a step, the modelled step "
        f"{ratio:.4f} of it (held at {ROOFLINE_SLACK}), model FLOPs at "
        f"{out['measured_fraction']:.4f} of the bf16 peak")
    if ratio > ROOFLINE_SLACK:
        raise AssertionError(f"roofline (c): the modelled step is {ratio:.4f}"
                             " of the measured one: the count is wrong")
    return out


def moe_shard_path(counters, result):
    """Phase 15; under a minute."""
    t0 = time.perf_counter()
    out = {"moe_shard": moe_shard_layer(counters, result["card"])}
    gc.collect()
    torch.cuda.empty_cache()
    out["roofline"] = roofline_step(result, result["card"])
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 15 in {out['wall_s']:.1f} s")
    result["expert_parallel"] = out
    return out


# ---------------------------------------------------------------------------
# phase 16: the examples on the card
# ---------------------------------------------------------------------------

#: each example and the command line phase 16 gives it (its docstring's);
#: observe_in_db runs in a temporary working directory and train_lm gets a
#: fresh temporary --ckpt-dir
EXAMPLES = [
    ("quickstart", []),
    ("mnist_e2e", ["--batch", "1000", "--hidden", "20"]),
    ("train_in_db", []),
    ("observe_in_db", []),
    ("zoo_in_db", []),
    ("serve_lm", ["--requests", "8", "--slots", "4"]),
    ("train_lm", ["--preset", "100m", "--steps", "200"]),
    ("train_lm", ["--arch", "dbrx_132b", "--steps", "20"]),
]
#: ops' entries into the card kernels that the examples reach, and the
#: wrapper behind each
EXAMPLE_ENTRIES = {"_fsm_cuda": "fused_sigmoid_matmul",
                   "_relmm_cuda": "relational_matmul",
                   "_embed_cuda": "onehot_embed",
                   "_flash_cuda": "flash_attention",
                   "_flash_bwd_cuda": "flash_attention_bwd"}
# quickstart's 300 Iris iterations at lr 0.05 part the float32 engines by
# far more than any float32 bound (0.16 on the card, 0.05 on the CPU, and
# the JAX package's own two engines 0.09 on the CPU): its first dozen
# iterations about double the rounding error each.  The engines are held to each other and to numpy's
# float64 training at QUICKSTART_BIND_ITERS, before that growth.
QUICKSTART_BIND_ITERS = 8
# and the 300-iteration distance is held below about three times the card's
# reading (0.156), so that a relational path that drifts fails
QUICKSTART_DRIFT_LIMIT = 0.5


def example_launches(name: str, out: dict) -> dict:
    """The launches one example's run must make, from what it ran: one
    one-hot transform, 2 fused layers (dense) and 5 relational products
    (relational) a training step, 2 of either an inference; a flash
    forward a layer and another in remat's recompute, and a backward a
    layer, a training step.  The serving engine feeds every prompt through
    ``decode_step``, which attends over the cache in plain PyTorch, and the
    in-database examples run SQL on the host: they launch nothing."""
    if name == "quickstart":
        it = out["iters"]
        return {"fused_sigmoid_matmul": 2 * it + 2,
                "relational_matmul": 5 * it + 2}
    if name == "mnist_e2e":           # inference warm, then timed
        it = out["epochs"]
        return {"onehot_embed": 1, "fused_sigmoid_matmul": 2 * it + 4,
                "relational_matmul": 5 * it + 4}
    if name == "train_in_db":          # the dense engine's differential
        return {"fused_sigmoid_matmul": 2 * out["n_iters"] + 2}
    if name == "train_lm":
        steps = len(out["history"])
        return {"flash_attention": 2 * out["layers"] * steps,
                "flash_attention_bwd": out["layers"] * steps}
    return {}


def copy_as(t: torch.Tensor) -> torch.Tensor:
    """A copy with ``t``'s size and strides (a kernel reads views by
    stride)."""
    out = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                              device=t.device)
    return out.copy_(t)


class ShapeLog:
    """Wraps ops' entries into the card kernels (``EXAMPLE_ENTRIES``): the
    first call of each kernel at each shape, type and layout keeps a copy
    of its operands, and the call goes on to the kernel unchanged.  Phase
    16 then holds each kernel against its plain version where the examples
    called it, after their counts are read."""

    def __init__(self, ops):
        self.ops, self.calls, self.saved = ops, {}, {}

    def __enter__(self):
        for attr, name in EXAMPLE_ENTRIES.items():
            self.saved[attr] = getattr(self.ops, attr)
            setattr(self.ops, attr, self._wrap(name, self.saved[attr]))
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.ops, attr, fn)

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            key = (name, *(
                (tuple(a.shape), a.dtype, a.stride())
                if isinstance(a, torch.Tensor) else a for a in args),
                *sorted(kwargs.items()))
            if key not in self.calls:
                self.calls[key] = (name, [copy_as(a) if isinstance(
                    a, torch.Tensor) else a for a in args], kwargs)
            return fn(*args, **kwargs)
        return call

    def take(self) -> list:
        calls, self.calls = list(self.calls.values()), {}
        return calls


def check_at_shape(name: str, args: list, kwargs: dict, mods: dict) -> dict:
    """One kernel at one shape an example gave it, against its plain
    version at the reference's tolerance (relational_matmul's oracle in
    float64, flash_attention_bwd's too, as phase 2 holds them): its time,
    the plain version's, one PyTorch call's and the card's bound."""
    mod = mods[name]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if name == "fused_sigmoid_matmul":
        x, w = args
        kernel = lambda: mod.fused_sigmoid_matmul(x, w)
        plain = lambda: mod.plain(x, w)
        want = plain()
        tol = F32_TOL if x.dtype == torch.float32 else BF16_TOL
        library = lambda: torch.sigmoid(x @ w)
        (m, k), n = x.shape, w.shape[1]
        bound = bound_ms(x.element_size() * (m * k + k * n + m * n),
                         2 * m * k * n)
        shape = f"({m}x{k}).({k}x{n}) {x.dtype}"
    elif name == "relational_matmul":
        rows, cols, vals, b, m = args
        kernel = lambda: mod.relational_matmul(rows, cols, vals, b, m)
        plain = lambda: mod.plain(rows, cols, vals, b, m)
        want = mod.plain(rows, cols, vals.double(), b.double(), m).float()
        tol = F32_TOL
        (k, n), nnz = b.shape, rows.numel()
        live = rows < m
        coo = torch.sparse_coo_tensor(
            torch.stack([rows[live].long(), cols[live].long()]), vals[live],
            (m, k), check_invariants=True).coalesce()
        b32 = b.float()
        library = lambda: torch.sparse.mm(coo, b32)
        bound = relmm_bound(nnz, int(torch.unique(cols[live]).numel()), m, n,
                            b.element_size())
        shape = f"({m}x{k}).({k}x{n}) as {nnz} tuples, b {b.dtype}"
    elif name == "onehot_embed":
        ids, table = args
        kernel = lambda: mod.onehot_embed(ids, table)
        plain = lambda: mod.plain(ids, table)
        want, tol = plain(), None
        long_ids = ids.long()
        library = lambda: torch.nn.functional.embedding(long_ids, table)
        (t,), (v, d) = ids.shape, table.shape
        size = table.element_size()
        bound = bound_ms(4 * t + size * v * d + size * t * d, 0)
        shape = f"{t} ids into ({v}x{d}) {table.dtype}"
    elif name == "flash_attention":
        q, k, v = args
        causal, scale = kwargs["causal"], kwargs["scale"]
        bf16 = q.dtype == torch.bfloat16
        kernel = lambda: mod.flash_attention(q, k, v, causal=causal,
                                             scale=scale)
        plain = lambda: mod.plain(q, k, v, causal=causal, scale=scale,
                                  bf16_scores=bf16)
        want, tol = plain(), BF16_TOL if bf16 else F32_TOL
        library = lambda: sdpa(q, k, v, is_causal=causal, scale=scale,
                               enable_gqa=True)
        (b, hq, s, d), hkv, dv = q.shape, k.shape[1], v.shape[-1]
        bound = flash_bound(b, hq, hkv, s, d, q.dtype, causal, dv)
        shape = (f"q ({b},{hq},{s},{d}), k/v ({b},{hkv},{s},{d}/{dv}) "
                 f"{q.dtype} causal={causal}")
    elif name == "flash_attention_bwd":
        q, k, v, do = args
        causal, scale = kwargs["causal"], kwargs["scale"]
        kernel = lambda: mod.flash_attention_bwd(q, k, v, do, causal=causal,
                                                 scale=scale)
        plain = lambda: mod.plain_bwd(q, k, v, do, causal=causal, scale=scale)
        want = [g.to(t.dtype) for g, t in zip(mod.plain_bwd(
            *(t.double() for t in (q, k, v, do)), causal=causal,
            scale=scale), (q, k, v))]
        tol = BF16_BWD_TOL if q.dtype == torch.bfloat16 else F32_TOL
        leaves_ = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = sdpa(*leaves_, is_causal=causal, scale=scale, enable_gqa=True)
        library = lambda: torch.autograd.grad(out, leaves_, do,
                                              retain_graph=True)
        (b, hq, s, d), hkv, dv = q.shape, k.shape[1], v.shape[-1]
        bound = bwd_bound(b, hq, hkv, s, d, dv, q.dtype, causal)
        shape = (f"q ({b},{hq},{s},{d}), k/v ({b},{hkv},{s},{d}/{dv}) "
                 f"{q.dtype} causal={causal}")
    else:
        raise AssertionError(f"no plain check for {name}")
    got = kernel()
    what = f"phase 16 {name} at {shape}"
    if isinstance(want, list):
        err = max(max_err(g, w_, tol, f"{what} d{n_}")
                  for n_, g, w_ in zip("qkv", got, want))
    else:
        err = max_err(got, want, tol, what)
    return dict(name=name, shape=shape, max_abs_err=err, tolerance=tol,
                ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
                library_ms=time_ms(library, iters=5), bound_ms=bound[0],
                bound_by=bound[1])


def quickstart_bind(card: str) -> dict:
    """Quickstart's training (its own ``train_both``) for
    QUICKSTART_BIND_ITERS iterations on the card: both engines within phase
    3's TRAIN_TOL of each other and of numpy's float64 training, their
    accuracies equal."""
    from repro_torch.core import nn2sql
    from repro_torch.core.relational import one_hot_dense
    from repro_torch.data import make_iris
    from repro_torch.examples import quickstart

    x, y = make_iris()
    y_oh = one_hot_dense(y, 3).to_dense()
    spec = nn2sql.MLPSpec(n_rows=150, n_features=4,
                          n_hidden=quickstart.HIDDEN, n_classes=3, lr=0.05)
    runs = quickstart.train_both(nn2sql.build_graph(spec),
                                 nn2sql.init_weights(spec), x, y, y_oh,
                                 QUICKSTART_BIND_ITERS, "cuda")
    ref = nn2sql.numpy_train(x.cpu().double().numpy(),
                             y_oh.cpu().double().numpy(), quickstart.HIDDEN,
                             QUICKSTART_BIND_ITERS, lr=spec.lr)
    diffs = {}
    for name in ("w_xh", "w_ho"):
        a, b = (runs[kind]["weights"][name] for kind in ("dense",
                                                         "relational"))
        torch.testing.assert_close(a, b, **TRAIN_TOL)
        diffs[f"dense vs relational {name}"] = float((a - b).abs().max())
        for kind in ("dense", "relational"):
            got = runs[kind]["weights"][name].cpu().double().numpy()
            np.testing.assert_allclose(got, ref[name], **TRAIN_TOL,
                                       err_msg=f"quickstart {kind} {name}")
            diffs[f"{kind} {name} vs numpy f64"] = float(
                np.abs(got - ref[name]).max())
    if runs["dense"]["accuracy"] != runs["relational"]["accuracy"]:
        raise AssertionError("quickstart: the engines' accuracies differ "
                             f"after {QUICKSTART_BIND_ITERS} iterations")
    log(f"phase 16 quickstart at {QUICKSTART_BIND_ITERS} iterations on "
        f"{card}: " + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()))
    return diffs


def example_checks(name: str, argv: list, out: dict, wall: float,
                   card: str) -> dict:
    """What one example's run must show, and its rates."""
    def engines_agree(runs, tol):
        diffs = {n: float((runs["dense"]["weights"][n]
                           - runs["relational"]["weights"][n]).abs().max())
                 for n in ("w_xh", "w_ho")}
        if tol is not None:
            for n in diffs:
                torch.testing.assert_close(runs["dense"]["weights"][n],
                                           runs["relational"]["weights"][n],
                                           **tol)
        if runs["dense"]["accuracy"] != runs["relational"]["accuracy"]:
            raise AssertionError(f"{name}: the engines' accuracies differ: "
                                 f"{runs['dense']['accuracy']} and "
                                 f"{runs['relational']['accuracy']}")
        return {f"dense vs relational {n}": d for n, d in diffs.items()}

    if name == "quickstart":
        rows = 150 * out["iters"]
        # not held at phase 3's bound (see QUICKSTART_BIND_ITERS), only
        # below QUICKSTART_DRIFT_LIMIT
        drift = engines_agree(out["runs"], None)
        if max(drift.values()) > QUICKSTART_DRIFT_LIMIT:
            raise AssertionError(f"quickstart: the engines drift apart: "
                                 f"{drift} beyond {QUICKSTART_DRIFT_LIMIT}")
        return dict(
            checks=drift | {
                f"at {QUICKSTART_BIND_ITERS} iterations": quickstart_bind(
                    card)},
            rates={f"{k} training tuples/s": rows / r["seconds"]
                   for k, r in out["runs"].items()})
    if name == "mnist_e2e":
        for r in out["runs"].values():
            if r["probs"].shape != (out["batch"], 10) or \
                    not torch.isfinite(r["probs"]).all():
                raise AssertionError("mnist_e2e: probabilities not finite "
                                     f"or shaped {tuple(r['probs'].shape)}")
        rates = {}
        for k, r in out["runs"].items():
            rates[f"{k} training tuples/s"] = r["train_tuples_per_s"]
            rates[f"{k} inference tuples/s"] = r["infer_tuples_per_s"]
        return dict(checks=engines_agree(out["runs"], TRAIN_TOL), rates=rates)
    if name == "train_in_db":
        checks = {"in-DB vs card weights": out["max_diff_weights"],
                  "in-DB vs card probabilities": out["max_diff_probs"]}
        if max(checks.values()) > DB_TOL:
            raise AssertionError(f"train_in_db: {checks} beyond {DB_TOL}")
        return dict(checks=checks, rates={
            "in-DB training tuples/s over the wall":
                out["rows"] * out["n_iters"] / wall})
    if name == "observe_in_db":
        from repro_torch.obs import report
        capture = report.load_capture(out["trace_path"])
        if not out["spans"] or not capture:
            raise AssertionError("observe_in_db: no spans traced")
        return dict(checks={"spans written": out["spans"],
                            "metric points": out["metric_points"]},
                    rates={"in-DB training tuples/s over the wall":
                           out["rows"] * out["n_iters"] / wall})
    if name == "zoo_in_db":
        checks = {k: out[k] for k in ("moe", "rwkv_o", "rwkv_s",
                                      "channel_mix")}
        if max(checks.values()) > ZOO_TOL or not out["grad_tables"] or \
                not np.isfinite(out["router_max"]):
            raise AssertionError(f"zoo_in_db: {checks}, "
                                 f"{out['grad_tables']} gradient tables, "
                                 f"max|d router| {out['router_max']}")
        return dict(checks=checks | {"gradient tables": out["grad_tables"]},
                    rates={})
    if name == "serve_lm":
        n_req = int(argv[argv.index("--requests") + 1])
        if out["requests"] != n_req or any(
                len(g) != out["max_new"] for g in out["generated"].values()):
            raise AssertionError(f"serve_lm: {out['generated']}")
        return dict(checks={"requests served": out["requests"]},
                    rates={"tokens/s": out["tokens_per_s"]})
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if not np.isfinite(losses).all():
        raise AssertionError(f"train_lm {argv}: losses {losses}")
    checks = {"first loss": losses[0], "last loss": losses[-1]}
    if "--preset" in argv:
        steps = int(argv[argv.index("--steps") + 1])
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train_lm {argv}: loss {losses[0]} -> "
                                 f"{losses[-1]}")
        # every 100 steps and at the end; the checkpointer keeps three
        want = sorted({*range(100, steps + 1, 100), steps})[-3:]
        if out["checkpoints"] != want:
            raise AssertionError(f"train_lm {argv}: checkpoints "
                                 f"{out['checkpoints']}, expected {want}")
        checks["checkpoints"] = out["checkpoints"]
    seconds = sorted(h["seconds"] for h in hist)
    return dict(checks=checks, rates={
        "tokens/s": out["tokens_per_step"] * len(hist) / sum(seconds),
        "median step ms": seconds[len(seconds) // 2] * 1e3})


def examples_path(counters, mods, result):
    """Phase 16: each example's ``main`` on the card with its command line,
    every count zeroed just before and read just after; then each kernel
    held against its plain version at the shapes that example gave it."""
    import importlib
    import tempfile

    from repro_torch.kernels import ops

    card = result["card"]
    t0 = time.perf_counter()
    out_all = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp, \
            ShapeLog(ops) as shapes:
        for name, argv in EXAMPLES:
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            argv = list(argv)
            if name == "train_lm":
                argv += ["--ckpt-dir", tempfile.mkdtemp(dir=tmp)]
            here = os.getcwd()
            if name == "observe_in_db":
                os.chdir(tmp)
            log(f"phase 16: python -m repro_torch.examples.{name} "
                f"{' '.join(argv)}")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                for fn in counters.values():
                    fn.launches = 0
                out, wall = timed(lambda: mod.main(argv))
                launches = {n: fn.launches for n, fn in counters.items()}
            finally:
                os.chdir(here)
            peak = torch.cuda.max_memory_allocated()
            expected = {n: 0 for n in counters} | example_launches(name, out)
            log(f"phase 16 {name} launches on {card}: {launches}")
            if launches != expected:
                raise AssertionError(f"{name}: launches {launches}, "
                                     f"expected {expected}")
            row = dict(name=name, argv=argv, wall_s=wall, peak_bytes=peak,
                       launches=launches)
            row |= example_checks(name, argv, out, wall, card)
            rates = ", ".join(f"{k} {v:.1f}" for k, v in row["rates"].items())
            log(f"phase 16 {name} on {card}: wall {wall:.3f} s, "
                f"{rates or 'no rate (four checks of 12-16 rows)'}, peak "
                f"device "
                f"memory {peak / 2**20:.1f} MiB")
            for what, v in row["checks"].items():
                log(f"  {what}: {v}")
            row["kernels"] = [check_at_shape(n, a, kw, mods)
                              for n, a, kw in shapes.take()]
            for k in row["kernels"]:
                log(f"  kernel {k['name']} at {k['shape']} on {card}: "
                    f"{k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
                    f"library {k['library_ms']:.4f} ms, bound "
                    f"{k['bound_ms']:.4f} ms "
                    f"({k['bound_by']}), max |err| {k['max_abs_err']:.3e}")
            out_all.append(row)
            del out
            gc.collect()
    wall = time.perf_counter() - t0
    log(f"phase 16 in {wall:.1f} s on {card}")
    result["examples"] = dict(runs=out_all, wall_s=wall)
    return out_all


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # phase 9's rendered-SQL plan cache keeps its store inside the checkout
    OUT_DIR.mkdir(exist_ok=True)
    os.environ.setdefault("REPRO_PLAN_CACHE", str(OUT_DIR / "plan_cache.db"))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print(f"chip_smoke: repro_torch from {repro_torch.__file__}, not this "
              "checkout", file=sys.stderr)
        return 2
    from repro_torch import core
    from repro_torch.core import nn2sql
    from repro_torch.core.relational import RelTensor
    from repro_torch import data as data_mod
    from repro_torch.kernels import build, flash_attention, moe_dispatch
    from repro_torch.kernels import fused_sigmoid_matmul, onehot_embed
    from repro_torch.kernels import relational_matmul, rwkv6_scan, tuple_dot
    from repro_torch.kernels import adamw as optim_kernels

    card = gpu_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False (float32 stays IEEE)")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # the backward kernel's source (the largest) in a thread of its own
    # beside the rest, so that its own seconds are read
    with ThreadPoolExecutor(2) as pool:
        t_bwd = pool.submit(build.build, ["flash_attention_bwd"])
        t_rest = pool.submit(build.build, [n for n in build.SOURCES
                                           if n != "flash_attention_bwd"])
        t_bwd, t_rest = t_bwd.result(), t_rest.result()
    t_build = max(t_bwd, t_rest)
    log(f"build: {len(build.SOURCES)} kernels for sm_90a in {t_build:.1f} s "
        f"(flash_attention_bwd.cu {t_bwd:.1f} s, the other "
        f"{len(build.SOURCES) - 1} {t_rest:.1f} s, in parallel)")
    for name in build.SOURCES:
        for line in build.build_log.get(name, "").splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    if sys.argv[1:2] == ["--flash-margin"]:
        unknown = set(sys.argv[2:]) - set(FLASH_MARGIN)
        if unknown:
            print(f"chip_smoke: --flash-margin takes names from "
                  f"{sorted(FLASH_MARGIN)}", file=sys.stderr)
            return 2
        out = flash_margin(card, sys.argv[2:])
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_flash_margin.json").write_text(
            json.dumps(out, indent=1))
        return 0
    if sys.argv[1:] == ["--rwkv-margin"]:
        out = rwkv_gradients(card, margin_split=True)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_margin.json").write_text(
            json.dumps(out, indent=1))
        return 0
    x, y = data_mod.make_mnist_like(N_ROWS)
    w = nn2sql.init_weights(nn2sql.MLPSpec(N_ROWS, N_FEAT, N_HID, N_CLS))
    data = dict(img=x, labels=y, **w)
    report = {}
    checks = {
        "relational_matmul": lambda: (
            check_relational(relational_matmul, RelTensor, data, report),
            check_relmm_long(relational_matmul, RelTensor, data, report),
            check_relmm_combine(relational_matmul, report),
            check_relmm_backward(relational_matmul, report)),
        "fused_sigmoid_matmul": lambda: check_fused(fused_sigmoid_matmul,
                                                    data, report),
        "onehot_embed": lambda: check_onehot(onehot_embed, data, report),
        "moe_dispatch": lambda: check_moe_dispatch(moe_dispatch, report),
        "flash_attention": lambda: check_flash(flash_attention, report),
        "flash_attention_bwd": lambda: check_flash_bwd(flash_attention,
                                                       report),
        "rwkv6_scan": lambda: check_rwkv6(rwkv6_scan, report),
        "rwkv6_scan_bwd": lambda: check_rwkv6_bwd(rwkv6_scan, report),
        "tuple_dot": lambda: check_tuple_dot(tuple_dot, report),
        "adamw": lambda: check_optimizer(optim_kernels, report)}
    kernels_only = sys.argv[1:2] == ["--kernels"]
    unknown = set(sys.argv[2:]) - set(checks)
    if sys.argv[1:] and not kernels_only or unknown:
        print(f"chip_smoke: usage: chip_smoke.py [--kernels [name ...] | "
              f"--flash-margin [name ...] | "
              f"--rwkv-margin], "
              f"names from {sorted(checks)}", file=sys.stderr)
        return 2
    for name, check in checks.items():
        if name in sys.argv[2:] or len(sys.argv) <= 2:
            check()
    torch.cuda.synchronize()
    for r in report.values():
        lib = r["library_ms"]
        lib = "none" if lib is None else f"{lib:.4f} ms"
        log(f"kernel {r['name']} at {r['shape']}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |err| "
            f"{r['max_abs_err']:.3e}")

    result = {"card": card, "build_s": t_build, "build_bwd_s": t_bwd,
              "kernels": report, "profiler_retries": PROFILER_RETRIES}
    if kernels_only:
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_kernels.json").write_text(
            json.dumps(result, indent=1))
        return 0
    counters = {"relational_matmul": relational_matmul.relational_matmul,
                "fused_sigmoid_matmul":
                    fused_sigmoid_matmul.fused_sigmoid_matmul,
                "onehot_embed": onehot_embed.onehot_embed,
                "moe_dispatch": moe_dispatch.moe_dispatch,
                "flash_attention": flash_attention.flash_attention,
                "flash_attention_bwd": flash_attention.flash_attention_bwd,
                "rwkv6_scan": rwkv6_scan.rwkv6_scan,
                "rwkv6_scan_bwd": rwkv6_scan.rwkv6_scan_bwd,
                "tuple_dot": tuple_dot.tuple_dot}
    launches = main_path(counters, core, nn2sql, data_mod, result)
    profile_step(counters, core, nn2sql, data_mod, result)
    # each kernel's launches on the path that runs it: kernels 1-3 on the
    # paper's pipeline (phase 3), flash_attention on Yi-6B's serving path
    # (phase 5), rwkv6_scan on RWKV-6's (phase 6), moe_dispatch on
    # DeepSeek-V2-Lite's (phase 7), flash_attention_bwd on Yi-6B's training
    # path (phase 11), tuple_dot on DeepSeek-V2-Lite's (phase 12),
    # rwkv6_scan_bwd on RWKV-6's (phase 13)
    launches["flash_attention"] = serve_path(counters, result)[
        "flash_attention"]
    launches["rwkv6_scan"] = serve_rwkv(counters, result)["rwkv6_scan"]
    launches["moe_dispatch"] = serve_deepseek(counters, result)[
        "moe_dispatch"]
    serve_zamba(counters, result)
    in_database(counters, core, nn2sql, data_mod, result)
    db_tier(counters, core, nn2sql, data_mod, result)
    launches["flash_attention_bwd"] = train_path(counters, result)[
        "flash_attention_bwd"]
    launches["tuple_dot"] = moe_train_path(counters, result)["tuple_dot"]
    launches |= result["train_moe"]["trainer"]["optim_launches"]
    launches["rwkv6_scan_bwd"] = rwkv_train_path(counters, result)[
        "rwkv6_scan_bwd"]
    zamba_train_path(counters, result)
    moe_shard_path(counters, result)
    examples_path(counters, {
        "fused_sigmoid_matmul": fused_sigmoid_matmul,
        "relational_matmul": relational_matmul, "onehot_embed": onehot_embed,
        "flash_attention": flash_attention,
        "flash_attention_bwd": flash_attention}, result)

    line = {"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": launches[r["name"]]}
        | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}
        for r in report.values()]}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
