"""Serving launcher of the port: random weights from a seeded generator,
a batch of random prompts through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b --reduced --device cpu

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import time

import numpy as np
import torch

from ..configs.base import get_config
from ..device import resolve
from ..nn.model import LM
from ..serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=64)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    dev = resolve(args.device)
    lm = LM(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(gen)
    eng = ServingEngine(lm, params, max_len=args.max_len,
                        batch_slots=args.slots)
    rng = np.random.RandomState(0)
    for uid in range(args.requests):
        eng.submit(Request(uid,
                           rng.randint(0, cfg.vocab,
                                       int(rng.randint(2, 8)))
                           .astype(np.int32),
                           max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    done = eng.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total = sum(len(r.generated) for r in done)
    print(f"{cfg.name} on {dev}: {len(done)} requests, {total} tokens, "
          f"{total / dt:.1f} tok/s")
    return done


if __name__ == "__main__":
    main()
