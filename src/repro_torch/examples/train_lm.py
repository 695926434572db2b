"""End-to-end LM training driver (deliverable b).

Trains a reduced-width decoder LM with the full production substrate:
token pipeline → model (its layers under remat) → AdamW → grad clip →
async checkpointing → straggler monitoring → crash-safe restart.

    PYTHONPATH=src python -m repro_torch.examples.train_lm                  # ~2M params
    PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch dbrx_132b # reduced MoE
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 20

The 100m preset is the "train a ~100M model for a few hundred steps"
configuration.  On the card every layer's attention runs the
``flash_attention`` kernel forward (and again in remat's recompute) and
``flash_attention_bwd`` backward; ``--arch dbrx_132b`` is the reduced MoE
with the config's ``impl="einsum"``, which reaches no MoE kernel.

Checkpoints go to ``--ckpt-dir``, and a run resumes from the latest one
found there.  Unless it is given, that is ``repro_torch_lm_ckpt/<arch>``
in the process's temporary directory (which follows ``TMPDIR``): one
directory a model, so a preset never restores another's shapes, and not
the reference script's, since the port's checkpoints are not the JAX
package's.  A run that resumes at or past ``--steps`` trains no step and
says so.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs.base import ArchConfig, get_config
from ..data import TokenPipeline
from ..device import resolve
from ..nn.model import LM
from ..optim import adamw
from ..train import Trainer

PRESETS = {
    "tiny": dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                 d_head=32, d_ff=512, vocab=2048),
    "20m": dict(n_layers=8, d_model=256, n_heads=8, n_kv_heads=4,
                d_head=32, d_ff=1024, vocab=8192),
    "100m": dict(n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
                 d_head=64, d_ff=2048, vocab=16384),
}
CHECKPOINT_EVERY = 100


def config(preset: str, arch: str | None) -> ArchConfig:
    """The reduced ``arch``, or the preset's dense decoder."""
    if arch:
        return get_config(arch, reduced=True)
    return ArchConfig(name=f"lm-{preset}", family="dense", **PRESETS[preset])


def default_ckpt_dir(cfg: ArchConfig) -> str:
    """``cfg``'s checkpoint directory when ``--ckpt-dir`` is not given."""
    return os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt",
                        cfg.name)


def make_trainer(cfg: ArchConfig, data, lr: float, grad_accum: int,
                 ckpt_dir: str | None, device) -> Trainer:
    """The checkpointed AdamW ``Trainer`` of ``LM(cfg)`` on ``data``."""
    return Trainer(LM(cfg, device=device), adamw(lr), data,
                   checkpoint_dir=ckpt_dir, checkpoint_every=CHECKPOINT_EVERY,
                   grad_accum=grad_accum)


def train(trainer: Trainer, steps: int) -> dict:
    """``steps`` steps of ``trainer`` from its ``init_state`` with a
    generator seeded 0 (or the latest checkpoint in its directory): the
    trainer's history and the checkpointed steps."""
    gen = torch.Generator(device=trainer.model.device).manual_seed(0)
    out = trainer.run(gen, steps, log_every=10)
    return dict(history=out["history"],
                checkpoints=trainer.ckpt.list_steps() if trainer.ckpt else [])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--arch", default=None,
                    help="train a reduced assigned arch instead of a preset")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_lm_ckpt/<arch> in the "
                         "temporary directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = config(args.preset, args.arch)
    n = cfg.n_params
    print(f"arch={cfg.name} params≈{n / 1e6:.1f}M "
          f"tokens/step={args.batch * args.seq}")
    data = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, device=dev)
    ckpt_dir = args.ckpt_dir or default_ckpt_dir(cfg)
    out = train(make_trainer(cfg, data, args.lr, args.grad_accum,
                             ckpt_dir, dev), args.steps)
    hist = out["history"]
    stragglers = sum(h["straggler"] for h in hist)
    if hist:
        print(f"\nloss {hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f} over "
              f"{len(hist)} steps; stragglers flagged: {stragglers}")
    else:
        print(f"\nresumed from {ckpt_dir} at or past step {args.steps}; "
              "no step trained")
    return dict(arch=cfg.name, params=n, layers=cfg.n_layers,
                tokens_per_step=args.batch * args.seq, stragglers=stragglers,
                ckpt_dir=ckpt_dir,
                **out)


if __name__ == "__main__":
    main()
