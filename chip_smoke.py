#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on past):

1. build   every CUDA kernel from ``src/repro_torch/kernels/csrc`` for
           sm_90a (one nvcc per source, in parallel) and print ptxas's report;
2. kernels each kernel against its plain PyTorch version on the card, over
           the ``tests/test_kernels.py`` sweeps and the main paths' shapes
           (flash at Yi-6B's, at MLA's and at Zamba2's (4, 32, 2048, 80) as
           head-split views, bf16 also against the bf16-scores plain
           version), with the reference's tolerances;
           then its time beside the plain version's, one PyTorch library
           call's (a yardstick only) and the card's bound for the same work
           (flash: also its achieved TFLOP/s, share of the bound, ratio to
           SDPA, the float32 kernel's time beside its two bounds, float32
           FFMA and 3xTF32 on the tensor cores, and float32 SDPA's, and the
           HGMMA instructions in the SASS of both libraries, neither of
           which may be 0; rwkv6_scan: also at the decode shape, 256 rows
           of one step; relational_matmul: each of the MLP step's five
           products timed with the schedule it takes, by events and by the
           profiler, beside torch.sparse.mm, every phase-2 case also with
           b in bf16, bit for bit the result for its float32 widening, and
           DeepSeek-V2-Lite's MoE combine, 48,000 tuples into 8000 x 2048,
           with b in float32 and in bf16, beside the bf16 -> float32 copy
           the MoE layer no longer makes; moe_dispatch: the profiler's
           device events of a call on the random slot layout and on the
           bucket-sorted one the MoE layer builds, a good call after a bad
           one, and the card's rate for writing the output alone (a
           zero fill of the same bytes); fused_sigmoid_matmul:
           both layers of the main path, each also by the profiler's
           device time, two calls equal bit for bit, and no tensor-core
           instruction in its SASS; onehot_embed: the profiler's device
           events of a call, which must be one kernel and no memset or
           memcpy, and the C launcher's launch-and-wait alone);
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
           prefill and one decode step;
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
           nudge; (d) a profile of one prefill and one decode step.

``python3 chip_smoke.py --kernels [name ...]`` runs phases 1 and 2 alone,
for the named kernels (all six without a name), and prints no result line:
two trees are compared on one card by running it in each, in turns.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists the kernels as JSON.  Details also go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.  It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
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


def profiled(fn, calls: int = 1, sessions: int = 3) -> list:
    """The device events of ``calls`` calls of ``fn`` under torch.profiler,
    in order.  The session runs ``fn`` once first, then three marker
    kernels (``torch.cuda._sleep``), and keeps only the events after the
    last marker it holds: on an H100 a session's first one or two device
    events were at times missing from it (after an idle spell, or many
    launches), and where ``fn`` is one kernel those can take the first
    marker with them.  A session that holds none of its markers (seen
    once, in the first session of a process) is run again, up to
    ``sessions`` in all."""
    from torch.profiler import ProfilerActivity, profile

    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            for _ in range(3):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        if marks:
            return events[marks[-1] + 1:]
        log(f"profiler session {session} of {sessions} held none of its "
            f"marker kernels ({len(events)} device events)")
    raise AssertionError("the profiler's events lack the marker kernel")


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


def sass_opcodes(name: str) -> list[str]:
    """The opcode of each instruction (``FFMA``, ``HFMA2.MMA``,
    ``HGMMA.64x128x16.F32.BF16``, ...) in the SASS of the library built
    from ``csrc/<name>.cu``."""
    from repro_torch.kernels import build
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(build.target(name))], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops = (re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                    line) for line in sass.splitlines())
    return [m.group(1) for m in ops if m]


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
# S, D = Dv = 80, which both kernels pad on chip to whole slabs
FLASH_ZAMBA2 = (4, 32, 2048, 80)
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
        hgmma=hgmma, hgmma_f32=hgmma_f32, mla=mla, zamba2=zamba2)
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


def summary(events: dict) -> str:
    """Each device event's name (cut short) and milliseconds a call."""
    return ", ".join(f"{name[:40]} {e['ms']:.4f} ms"
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


def check_flash_zamba2(mod, sdpa):
    """Zamba2's shared attention, (D, Dv) = (80, 80), at its prefill shape
    as the model hands it over (head-split views of (B, S, 2560)
    projections, read in place): float32 at the tests' tolerance, bf16 at
    the Yi shape's and against the bf16-scores plain version; each timed
    beside the plain version, SDPA and the bound."""
    b, h, s, d = FLASH_ZAMBA2
    rng = np.random.RandomState(80)
    q, k, v = (torch.tensor(rng.randn(b, s, h, d), dtype=torch.float32,
                            device="cuda").transpose(1, 2) for _ in range(3))
    if not all(mod.takes(t) for t in (q, k, v)):
        raise AssertionError("flash Zamba2: the head-split views need a copy")
    causal_sdpa = lambda q, k, v: sdpa(q, k, v, is_causal=True)
    err32 = max_err(mod.flash_attention(q, k, v), mod.plain(q, k, v),
                    F32_TOL, f"flash Zamba2 {FLASH_ZAMBA2} float32 causal")
    f32_ms = time_ms(lambda: mod.flash_attention(q, k, v), iters=10)
    f32_device = device_events(lambda: mod.flash_attention(q, k, v), 5)
    f32_plain_ms = time_ms(lambda: mod.plain(q, k, v), iters=5)
    f32_bound, f32_by = flash_bound(b, h, h, s, d, torch.float32)
    f32_tf32_bound, _ = flash_bound_tf32(b, h, h, s, d)
    f32_library_ms = time_ms(lambda: causal_sdpa(q, k, v), iters=5)
    f32_library_kernels = top_kernels(lambda: causal_sdpa(q, k, v))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    err = max_err(mod.flash_attention(q, k, v), mod.plain(q, k, v),
                  FLASH_MAIN_BF16_TOL, f"flash Zamba2 {FLASH_ZAMBA2} bf16 "
                  "causal")
    err_scores = max_err(mod.flash_attention(q, k, v),
                         mod.plain(q, k, v, bf16_scores=True),
                         FLASH_MAIN_BF16_TOL,
                         f"flash Zamba2 {FLASH_ZAMBA2} bf16 vs bf16 scores")
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
    log(f"flash Zamba2 {FLASH_ZAMBA2} vs plain, max |err|: float32 "
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


RWKV_MAIN = (4, 64, 2000, 64)      # RWKV-6 7B prefill: B, H, S, N
SCAN_TOL = dict(rtol=3e-4, atol=3e-4)         # tests/test_kernels.py


def rwkv6_bound(rows, s, n):
    """Bytes of r, k, v, w read and o written once, u read, s0 read and
    s_fin written; operations: what the recurrence needs, 5 FLOPs for each
    (t, i, j) (S <- w S + k v, a multiply and an FMA; o += r S, an FMA),
    since the u term factors, sum_i r_i u_i k_i v_j = v_j sum_i r_i u_i k_i,
    and costs O(N) a step, not O(N^2)."""
    n_bytes = 4 * (5 * rows * s * n + rows * n + 2 * rows * n * n)
    return bound_ms(n_bytes, 5 * rows * s * n * n)


def check_rwkv6(mod, report):
    rng = np.random.RandomState(46)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")

    def inputs(lead, s, n):
        """tests/test_kernels.py's inputs: w uniform in [0.4, 0.9), s0 =
        0.1·randn."""
        r, k, v = (f32(rng.randn(*lead, s, n)) for _ in range(3))
        return (r, k, v, f32(rng.rand(*lead, s, n) * 0.5 + 0.4),
                f32(rng.randn(*lead, n)), f32(rng.randn(*lead, n, n) * 0.1))

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
    bshn = inputs((b, s), h, n)[:4]
    args = (*(t.transpose(1, 2) for t in bshn),
            f32(rng.randn(h, n)).expand(b, h, n),
            f32(rng.randn(b, h, n, n) * 0.1))
    err = max(err, compare(args, f"rwkv6 main layer views {RWKV_MAIN}"))
    # the decode shape: the same 256 rows of state, one step each, as the
    # layer's head-split views of (B, 1, H, N) projections
    dec = (*(t.transpose(1, 2) for t in inputs((b, 1), h, n)[:4]),
           f32(rng.randn(h, n)).expand(b, h, n),
           f32(rng.randn(b, h, n, n) * 0.1))
    err = max(err, compare(dec, f"rwkv6 decode views {(b, h, 1, n)}"))
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
        decode=decode)
    log(f"rwkv6_scan vs plain, max |err| over the sweep, S in {{1, 7, 77}}, "
        f"the main shape and the decode shape (o and s_fin): {err:.3e} (held "
        f"at {SCAN_TOL}); decode shape {decode['ms']:.4f} ms a call "
        f"(events), device {device_ms(decode['device']):.5f} ms, bound "
        f"{dec_bound:.5f} ms ({dec_by})")


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
    expected = {"onehot_embed": 1,
                "fused_sigmoid_matmul": 2 * ITERS + 2,
                "relational_matmul": 5 * ITERS + 2,
                "moe_dispatch": 0, "flash_attention": 0, "rwkv6_scan": 0}
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

def device_profile(fn, wall_ms: float, what: str, card: str) -> dict:
    """One run of ``fn`` under torch.profiler (``profiled``): device time
    by kernel name, summed, over ``wall_ms`` (the same work timed without
    the profiler) as the device's busy share."""
    by_name, counts = {}, {}
    for e in profiled(fn):
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
    if flash_ms:
        log(f"  flash_attention kernels: {flash_ms:.4f} ms, "
            f"{flash_ms / device:.4f} of device time")
    # copies and casts: PyTorch's copy kernels (a type conversion is one)
    # and the runtime's memcpys
    copies = {name: ms for name, ms in by_name.items()
              if "copy" in name.lower()}
    copies_ms = sum(copies.values())
    if n_events:
        log(f"  copies and casts: {copies_ms:.4f} ms in "
            f"{sum(counts[name] for name in copies)} events")
    return dict(wall_ms=wall_ms, device_ms=device,
                busy_share=device / wall_ms, device_events=n_events,
                top_ms=top, flash_ms=flash_ms, copies_ms=copies_ms,
                counts=counts)


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
    result["serve"] = out
    return launches


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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
    from repro_torch.kernels import relational_matmul, rwkv6_scan

    card = gpu_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False (float32 stays IEEE)")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t_build = build.build()
    log(f"build: {len(build.SOURCES)} kernels for sm_90a in {t_build:.1f} s")
    for name in build.SOURCES:
        for line in build.build_log.get(name, "").splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    x, y = data_mod.make_mnist_like(N_ROWS)
    w = nn2sql.init_weights(nn2sql.MLPSpec(N_ROWS, N_FEAT, N_HID, N_CLS))
    data = dict(img=x, labels=y, **w)
    report = {}
    checks = {
        "relational_matmul": lambda: (
            check_relational(relational_matmul, RelTensor, data, report),
            check_relmm_combine(relational_matmul, report)),
        "fused_sigmoid_matmul": lambda: check_fused(fused_sigmoid_matmul,
                                                    data, report),
        "onehot_embed": lambda: check_onehot(onehot_embed, data, report),
        "moe_dispatch": lambda: check_moe_dispatch(moe_dispatch, report),
        "flash_attention": lambda: check_flash(flash_attention, report),
        "rwkv6_scan": lambda: check_rwkv6(rwkv6_scan, report)}
    kernels_only = sys.argv[1:2] == ["--kernels"]
    unknown = set(sys.argv[2:]) - set(checks)
    if sys.argv[1:] and not kernels_only or unknown:
        print(f"chip_smoke: usage: chip_smoke.py [--kernels [name ...]], "
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

    result = {"card": card, "build_s": t_build, "kernels": report}
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
                "rwkv6_scan": rwkv6_scan.rwkv6_scan}
    launches = main_path(counters, core, nn2sql, data_mod, result)
    profile_step(counters, core, nn2sql, data_mod, result)
    # each kernel's launches on the path that runs it: kernels 1-3 on the
    # paper's pipeline (phase 3), flash_attention on Yi-6B's serving path
    # (phase 5), rwkv6_scan on RWKV-6's (phase 6), moe_dispatch on
    # DeepSeek-V2-Lite's (phase 7)
    launches["flash_attention"] = serve_path(counters, result)[
        "flash_attention"]
    launches["rwkv6_scan"] = serve_rwkv(counters, result)["rwkv6_scan"]
    launches["moe_dispatch"] = serve_deepseek(counters, result)[
        "moe_dispatch"]
    serve_zamba(counters, result)

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
