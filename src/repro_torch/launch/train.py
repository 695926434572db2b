"""Training launcher of the port: random weights from a seeded generator,
the synthetic token stream (or the stub frontend's embeddings), AdamW
through the checkpointed ``Trainer``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --reduced \\
        --steps 50 --seq 128 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b --reduced \\
        --device cpu --steps 3

Runs on the card unless ``--device cpu`` is given.  The flags are the JAX
launcher's (``repro.launch.train``) and ``--device``.
"""
import argparse

import torch

from ..configs.base import get_config
from ..data import TokenPipeline, stub_frontend_batch
from ..device import resolve
from ..nn.model import LM
from ..optim import adamw
from ..train import Trainer


class StubPipeline:
    """Frontend-stub data source ([audio]/[vlm] archs)."""

    def __init__(self, cfg, seq_len, global_batch, device="cuda"):
        self.cfg, self.seq, self.batch = cfg, seq_len, global_batch
        self.device = device

    def batch_at(self, step: int):
        return stub_frontend_batch(self.cfg.stub_frontend, self.batch,
                                   self.seq, self.cfg.d_model,
                                   self.cfg.vocab, seed=step,
                                   device=self.device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    dev = resolve(args.device)
    lm = LM(cfg, device=dev)
    if cfg.stub_frontend:
        data = StubPipeline(cfg, args.seq, args.batch, device=dev)
    else:
        data = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                             global_batch=args.batch, device=dev)
    trainer = Trainer(lm, adamw(args.lr), data,
                      checkpoint_dir=args.ckpt_dir,
                      grad_accum=args.grad_accum)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = trainer.run(gen, args.steps, log_every=10)
    h = out["history"]
    print(f"done: loss {h[0]['loss']:.4f} → {h[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
