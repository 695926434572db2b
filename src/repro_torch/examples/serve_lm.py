"""Batched serving with continuous batching (deliverable b).

Model inference inside the system "avoids data extraction" (paper §6.3.2);
this driver serves a small LM with a continuously-batched decode loop:
requests of different lengths share fixed decode slots, finished sequences
immediately release their slot to the queue.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --requests 8 --slots 4
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

The weights are random, from ``LM.init`` with a ``torch.Generator``
seeded 0 (the reference script seeds JAX's key 0: other numbers).  Each
request's prompt is fed through ``decode_step``, so on the card the
reduced Yi-6B's attention runs the ``flash_attention`` kernel once a
layer for each step.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs.base import get_config
from ..device import resolve
from ..nn.model import LM
from ..serving import Request, ServingEngine
from . import timed


def serve(lm: LM, params: dict, n_requests: int, slots: int, max_new: int,
          max_len: int, temperature: float) -> dict:
    """``n_requests`` requests of 2–9 prompt tokens from
    ``RandomState(0)`` through a ``ServingEngine`` over ``params``: the
    finished requests and the seconds to serve them all."""
    eng = ServingEngine(lm, params, max_len=max_len, batch_slots=slots,
                        temperature=temperature)
    rng = np.random.RandomState(0)
    for uid in range(n_requests):
        plen = int(rng.randint(2, 10))
        eng.submit(Request(uid, rng.randint(0, lm.cfg.vocab, plen)
                           .astype(np.int32), max_new_tokens=max_new))
    done, seconds = timed(eng.run_to_completion, lm.device)
    return dict(done=sorted(done, key=lambda r: r.uid), seconds=seconds)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = get_config(args.arch, reduced=True)
    lm = LM(cfg, device=dev)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    out = serve(lm, params, args.requests, args.slots, args.max_new,
                args.max_len, args.temperature)
    done, dt = out["done"], out["seconds"]
    total = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, {args.slots} slots)")
    for r in done[:4]:
        print(f"  req {r.uid}: prompt {r.prompt.tolist()} → {r.generated}")
    return dict(arch=cfg.name, requests=len(done), tokens=total, seconds=dt,
                tokens_per_s=total / dt, slots=args.slots,
                max_new=args.max_new,
                generated={r.uid: list(r.generated) for r in done})


if __name__ == "__main__":
    main()
