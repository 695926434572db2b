"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone into ``build/repro_torch_kernels/lib<name>-<hash>.so`` at the root of
the checkout (the hash covers the source, the ``csrc/*.cuh`` headers and
the flags, so an edited source never loads a stale library).  Sources that
are not built yet are compiled in parallel, one ``nvcc`` each, all started
together.  Nothing here runs at import: the CPU tests import every module
and this host may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("relational_matmul", "fused_sigmoid_matmul", "onehot_embed",
           "moe_dispatch", "flash_attention", "flash_attention_tc",
           "flash_attention_bwd", "rwkv6_scan", "rwkv6_scan_bwd", "tuple_dot")
#: sm_90a (not sm_90) keeps wgmma/setmaxnreg available to later kernels;
#: no --use_fast_math: the sigmoid and the softmax keep full-precision expf.
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ptxas's report (registers, shared memory, spills) of each build made by
#: this process, by source name.
build_log: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):      # what a source includes
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every named source whose library is missing, in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    todo = [n for n in names if not target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode:
            os.unlink(tmp)
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, target(name))    # atomic: racing builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed,
    with ``argtypes`` set from ``signatures`` (C function → argument types,
    or (argument types, result type); a launcher returns its
    ``cudaGetLastError()`` as an int, the default result type)."""
    if name not in _libs:
        build([name])
        lib = ctypes.CDLL(str(target(name)))
        for fn, argtypes in signatures.items():
            argtypes, restype = (argtypes if isinstance(argtypes, tuple)
                                 else (argtypes, ctypes.c_int))
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return _libs[name]


def device_and_stream(t: torch.Tensor) -> tuple[int, int]:
    """The device index and PyTorch's current stream (as an int handle) a
    kernel launched for ``t`` runs on."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, kernel: str) -> None:
    """Raise if CUDA refused a launch (a refused launch never runs, and a
    later synchronize would not report it)."""
    if rc:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")
