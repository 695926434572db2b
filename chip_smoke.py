#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on past):

1. build   every CUDA kernel from ``src/repro_torch/kernels/csrc`` for
           sm_90a (one nvcc per source, in parallel) and print ptxas's report;
2. kernels each kernel against its plain PyTorch version on the card, over
           the ``tests/test_kernels.py`` sweeps and the main path's shapes,
           with the reference's tolerances; then its time beside the plain
           version's, one PyTorch library call's (a yardstick only) and the
           card's bound for the same work;
3. main    the paper's pipeline at the full width of Fig. 10 (2000 rows,
           784 → 200 → 10, random weights from Listing 2's seed): one-hot
           labels, 5 training steps and inference on Engine("dense") and
           Engine("relational"), with the launch counters zeroed just before
           and read just after; the weights are held against Listing 2's
           numpy training in float64 and the engines against each other;
4. profile one training step of each engine: wall time, device time by
           kernel (torch.profiler) and the device's busy share.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists the kernels as JSON.  Details also go to
``chiprun_out/chip_smoke.json``.  Without a CUDA device, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.  It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
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


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, from CUDA events over ``iters`` calls
    after a warm-up (inputs stay warm in the 50 MB L2)."""
    for _ in range(3):
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


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS * 1e3
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
    rng = np.random.RandomState(42)
    dev = "cuda"
    err = 0.0

    def run(rel, b, what):
        args = (rel.i, rel.j, rel.v, b, rel.shape[0])
        return max_err(mod.relational_matmul(*args), mod.plain(*args),
                       F32_TOL, what)

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

    # what the kernel refuses (the plain version takes any relation)
    rel, b = cases["z_xh = img.w_xh"]
    expect_raise(ValueError, lambda: mod.relational_matmul(
        rel.i.flip(0).contiguous(), rel.j, rel.v, b, N_ROWS), "unsorted rows")
    expect_raise(ValueError, lambda: mod.relational_matmul(
        rel.i, rel.j + N_FEAT, rel.v, b, N_ROWS), "col out of range")

    rel, b = cases["z_xh = img.w_xh"]
    args = (rel.i, rel.j, rel.v, b, N_ROWS)
    nnz, (k, n) = rel.capacity, b.shape
    coo = torch.sparse_coo_tensor(torch.stack([rel.i.long(), rel.j.long()]),
                                  rel.v, (N_ROWS, k),
                                  check_invariants=True).coalesce()
    bms, by = bound_ms(12 * nnz + 4 * k * n + 4 * N_ROWS * n, 2 * nnz * n)
    report["relational_matmul"] = dict(
        name="relational_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/relational_matmul.cu",
        replaces="src/repro/kernels/relational_matmul.py:61",
        max_abs_err=err,
        ms=time_ms(lambda: mod.relational_matmul(*args)),
        plain_ms=time_ms(lambda: mod.plain(*args), iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.sparse.mm(coo, b)),
        shape=f"({N_ROWS}x{k}).({k}x{n}) as {nnz} tuples")


def check_fused(mod, data, report):
    rng = np.random.RandomState(43)
    err = 0.0
    sweep = [(128, 128, 128), (256, 384, 256), (128, 512, 384),
             (150, 4, 8), (150, 8, 3)]
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
    for what, (x, w) in {"a_xh": (img, w_xh), "a_ho": (a_xh, w_ho)}.items():
        err = max(err, max_err(mod.fused_sigmoid_matmul(x, w), mod.plain(x, w),
                               F32_TOL, f"fused {what}"))
    (m, k), n = img.shape, w_xh.shape[1]
    bms, by = bound_ms(4 * (m * k + k * n + m * n), 2 * m * k * n)
    report["fused_sigmoid_matmul"] = dict(
        name="fused_sigmoid_matmul", route="cuda",
        source="src/repro_torch/kernels/csrc/fused_sigmoid_matmul.cu",
        replaces="src/repro/kernels/fused_sigmoid_matmul.py:41",
        max_abs_err=err,
        ms=time_ms(lambda: mod.fused_sigmoid_matmul(img, w_xh)),
        plain_ms=time_ms(lambda: mod.plain(img, w_xh)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: torch.sigmoid(img @ w_xh)),
        shape=f"({m}x{k}).({k}x{n}) float32")


def check_onehot(mod, data, report):
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
    t, d = labels.shape[0], N_CLS
    bms, by = bound_ms(4 * t + 4 * N_CLS * d + 4 * t * d, 0)
    long_ids = labels.long()
    report["onehot_embed"] = dict(
        name="onehot_embed", route="cuda",
        source="src/repro_torch/kernels/csrc/onehot_embed.cu",
        replaces="src/repro/kernels/onehot_embed.py:28",
        max_abs_err=err,
        ms=time_ms(lambda: mod.onehot_embed(labels, eye)),
        plain_ms=time_ms(lambda: mod.plain(labels, eye)),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(
            lambda: torch.nn.functional.embedding(long_ids, eye)),
        shape=f"({t},) ids into eye({N_CLS})")


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

def profile_step(core, nn2sql, data_mod, result):
    """One training step of each engine at full width, after the main path
    (its counts are read already): the step's wall time, then the same step
    under torch.profiler for the device time by kernel name.  The kernels
    run on one stream and never overlap, so their sum over the unprofiled
    wall time is the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            timed(step)
        by_name, n_events = {}, 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n_events += 1
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3)
        device = sum(by_name.values())
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
        out[kind] = dict(step_ms=wall, device_ms=device,
                         busy_share=device / wall, device_events=n_events,
                         top_ms=top)
        log(f"profile {kind} step on {result['card']}: wall {wall:.4f} ms, "
            f"device {device:.4f} ms in {n_events} events, busy share "
            f"{device / wall:.4f}" if n_events else
            f"profile {kind} step: wall {wall:.4f} ms; the profiler saw no "
            "device events (device time not measured)")
        for name, ms in top.items():
            log(f"  {ms:9.4f} ms  {name[:100]}")
    result["profile"] = out


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
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_sigmoid_matmul, onehot_embed
    from repro_torch.kernels import relational_matmul

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
    check_relational(relational_matmul, RelTensor, data, report)
    check_fused(fused_sigmoid_matmul, data, report)
    check_onehot(onehot_embed, data, report)
    torch.cuda.synchronize()
    for r in report.values():
        lib = r["library_ms"]
        log(f"kernel {r['name']} at {r['shape']}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max |err| "
            f"{r['max_abs_err']:.3e}")

    result = {"card": card, "build_s": t_build, "kernels": report}
    counters = {"relational_matmul": relational_matmul.relational_matmul,
                "fused_sigmoid_matmul":
                    fused_sigmoid_matmul.fused_sigmoid_matmul,
                "onehot_embed": onehot_embed.onehot_embed}
    launches = main_path(counters, core, nn2sql, data_mod, result)
    profile_step(core, nn2sql, data_mod, result)

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
