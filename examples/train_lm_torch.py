"""End-to-end training on the PyTorch/CUDA port: train a ~100M-param
phi3-family model on the synthetic pipeline, with checkpointing.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \
        [--device cuda|cpu]

The port of ``examples/train_lm.py``: the same topology, data, optimizer
and trainer settings, through ``repro_torch.train.trainer.Trainer`` on the
card (``--device cpu`` for the CPU).  The weights are drawn by the port
(``init_params(seed=0)``), not the JAX package's numbers.
"""
import argparse
import math

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm_torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    # ~100M params: phi3 family topology, scaled down
    cfg = ArchConfig(name="phi3-100m", family="dense", n_layers=6,
                     d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
                     d_ff=2048, vocab=32000, act="swiglu", rope_type="std")
    params = T.init_params(cfg, seed=0, dtype=torch.float32,
                           device=args.device)
    n_params = sum(p.numel() for p in tr.leaves(params))
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, device={args.device}")

    data = SyntheticLM(vocab=cfg.vocab, seq_len=128, global_batch=8, seed=0)
    tr_ = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_every=100,
                      ckpt_dir=args.ckpt_dir, log_every=20,
                      seq_chunk=128),
        cfg, params, data,
        opt_cfg=adamw.AdamWConfig(lr=1e-3, warmup_steps=20,
                                  total_steps=args.steps),
        device=args.device)
    tr_.install_signal_handler()
    resumed = tr_.maybe_resume()
    if resumed:
        print(f"resumed from step {resumed}")
    log = tr_.run()
    tr_.remove_signal_handler()
    print(f"loss: {log[0]['loss']:.3f} → {log[-1]['loss']:.3f} "
          f"over {len(log)} steps; stragglers={tr_.n_stragglers}")
    assert all(math.isfinite(r["loss"]) for r in log)
    assert log[-1]["loss"] < log[0]["loss"]
    print("OK")


if __name__ == "__main__":
    main()
