"""Trainer: the fault-tolerant training loop, the counterpart of
``src/repro/train/trainer.py``.

  checkpoint/restart   — atomic async checkpoints every ``ckpt_every`` steps;
                         on (re)start the trainer resumes from the newest
                         committed step, replaying the deterministic data
                         stream (batch = f(seed, step), no iterator state).
  preemption safety    — SIGTERM triggers a final blocking checkpoint
                         before exit.
  straggler mitigation — per-step wall-time EWMA; steps slower than
                         ``straggler_factor``× the EWMA are counted.
  loss-spike guard     — optional rollback-on-NaN: restore the last
                         checkpoint and skip the bad data window.

It runs on the card unless the caller passes ``device="cpu"``.  The params
and the optimizer state are updated in place, where the JAX trainer
donates them to its jitted step.  As in the reference, a checkpoint holds
the params and the optimizer state but not the compression error state,
so a resumed run with compression restarts its error feedback at zero.
"""
from __future__ import annotations

import dataclasses
import signal
import time

import numpy as np
import torch

from .. import tree as tr
from ..checkpoint.checkpointer import Checkpointer
from ..core.options import resolve_device
from ..optim import adamw
from ..optim.compression import CompressionConfig, init_error_state
from .train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    rollback_on_nan: bool = True
    microbatch: int = 1
    seq_chunk: int = 512


class Trainer:
    def __init__(self, cfg, arch_cfg, params, dataset, opt_cfg=None,
                 comp_cfg=None, step_fn=None, device="cuda"):
        self.cfg = cfg
        self.arch = arch_cfg
        self.device = resolve_device(device)
        self.params = tr.map_leaves(lambda p: p.to(self.device), params)
        self.dataset = dataset
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=cfg.total_steps)
        self.comp_cfg = comp_cfg or CompressionConfig()
        self.opt_state = adamw.init_state(self.params)
        self.err_state = init_error_state(self.params, self.comp_cfg)
        self.ckpt = Checkpointer(cfg.ckpt_dir, keep=cfg.keep_ckpts)
        self.step = 0
        self.metrics_log: list = []
        self.n_stragglers = 0
        self._ewma = None
        self._stop = False
        self._prev_handler = None
        self._step_fn = step_fn or make_train_step(
            self.arch, self.opt_cfg, self.comp_cfg,
            microbatch=cfg.microbatch, seq_chunk=cfg.seq_chunk)

    # ------------------------------------------------------------- lifecycle
    def install_signal_handler(self):
        def _handler(signum, frame):
            self._stop = True
        self._prev_handler = signal.signal(signal.SIGTERM, _handler)

    def remove_signal_handler(self):
        """Put back the SIGTERM handler that was there before (the handler
        holds the trainer, and with it the params, alive)."""
        if self._prev_handler is not None:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._prev_handler = None

    def maybe_resume(self):
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(
                latest, dict(params=self.params, opt=self.opt_state))
            self.params, self.opt_state = state["params"], state["opt"]
            self.step = latest
            return latest
        return None

    def save(self, blocking=False):
        self.ckpt.save(self.step, dict(params=self.params, opt=self.opt_state),
                       blocking=blocking)

    def _batch(self, step):
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in self.dataset.batch(step).items()}

    # ------------------------------------------------------------------ run
    def run(self, n_steps=None):
        target = self.step + n_steps if n_steps else self.cfg.total_steps
        while self.step < target and not self._stop:
            batch = self._batch(self.step)
            t0 = time.perf_counter()
            self.params, self.opt_state, self.err_state, metrics = \
                self._step_fn(self.params, self.opt_state, self.err_state,
                              batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            # straggler detection (EWMA over steady-state step times)
            if self.step > 1:
                if self._ewma is None:
                    self._ewma = dt
                elif dt > self.cfg.straggler_factor * self._ewma:
                    self.n_stragglers += 1
                else:
                    self._ewma = 0.9 * self._ewma + 0.1 * dt
            # NaN rollback
            if self.cfg.rollback_on_nan and not np.isfinite(loss):
                latest = self.ckpt.latest_step()
                if latest is not None:
                    self.maybe_resume()
                    self.step += 1          # skip the offending window
                    continue
            self.step += 1
            self.metrics_log.append(
                dict(step=self.step, loss=loss, dt=dt,
                     grad_norm=float(metrics.get("grad_norm", 0.0))))
            if self.step % self.cfg.log_every == 0:
                print(f"step {self.step:6d}  loss {loss:.4f}  "
                      f"{dt*1000:.0f} ms", flush=True)
            if self.step % self.cfg.ckpt_every == 0:
                self.save()
        if self._stop:                       # preemption: final checkpoint
            self.save(blocking=True)
        self.ckpt.wait()
        return self.metrics_log
