"""Training launcher CLI: the counterpart of ``src/repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-medium-14b \\
        --reduced --device cpu --steps 20 --batch 8 --seq 256 \\
        --ckpt-dir "$TMPDIR"/ck

Trains on the card (``--device cuda``, the default; without one it raises)
or, with ``--device cpu``, on the CPU.  The params are float32, drawn from
``--seed`` as the JAX launcher draws its own (not the same numbers); the
batches are the JAX pipeline's (``SyntheticLM``), bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from .. import tree as tr
from ..configs import registry
from ..data.pipeline import SyntheticLM
from ..models import transformer as T
from ..optim import adamw
from ..optim.compression import CompressionConfig
from ..train.trainer import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="phi3-medium-14b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep only the first N layers, at full width "
                         "(a quick run of a large arch)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default), 'cuda:N', or 'cpu'")
    return ap


def main(argv=None, out=None):
    """Run the CLI; returns 0.  When ``out`` is a dict it receives the
    trainer's log (``log``), its final params (``params``), the step it
    resumed from (``resumed``) and the ``Trainer`` itself (``trainer``)."""
    args = build_parser().parse_args(argv)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = T.init_params(cfg, seed=args.seed, dtype=torch.float32,
                           device=args.device)
    n_params = sum(p.numel() for p in tr.leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"device={params['embed'].device}")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, microbatch=args.microbatch,
                         seq_chunk=min(512, args.seq))
    trainer = Trainer(tcfg, cfg, params, data,
                      opt_cfg=adamw.AdamWConfig(
                          lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5)),
                      comp_cfg=CompressionConfig(kind=args.compress),
                      device=args.device)
    del params
    trainer.install_signal_handler()
    try:
        r = None
        if args.resume:
            r = trainer.maybe_resume()
            print(f"resumed from step {r}" if r is not None else "fresh start")
        log = trainer.run()
    finally:
        trainer.remove_signal_handler()
    if log:
        print(f"final loss {log[-1]['loss']:.4f} "
              f"(first {log[0]['loss']:.4f}); "
              f"stragglers={trainer.n_stragglers}")
    if out is not None:
        out.update(log=log, params=trainer.params, resumed=r,
                   trainer=trainer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
