"""Fault-tolerant training loop: checkpoint and restart, straggler
telemetry, failure injection, deterministic resume.

``Trainer.run()`` first restores the latest checkpoint (params, optimizer
state, EF buffers; the data cursor is the step, since the data pipeline is
a pure function of it).  A crash loses at most ``ckpt_every`` steps;
``run_with_restarts`` rebuilds the trainer and resumes after each one
(``fault_hook`` injects failures).  Per-step wall times feed an EMA, and
steps slower than ``straggler_factor`` times it are counted and logged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer, restore
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)


@dataclasses.dataclass
class TrainerConfig:
    """Train config, checkpoint directory and cadence, run length."""
    train: TrainConfig
    ckpt_dir: str
    max_steps: int = 100
    ckpt_every: int = 20
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    seed: int = 0


class Trainer:
    """Restore-or-init, then step until ``max_steps``, saving
    asynchronously every ``ckpt_every`` steps and at the last one."""

    def __init__(self, model, tcfg: TrainerConfig, dataset, *,
                 device="cuda",
                 fault_hook: Optional[Callable[[int], None]] = None,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.tcfg = tcfg
        self.dataset = dataset
        self.device = resolve_device(device)
        self.fault_hook = fault_hook
        self.log = log_fn
        self.ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.keep)
        self.step_fn = make_train_step(model, tcfg.train)
        self.step_times: list = []
        self.straggler_steps: list = []

    def _init_or_restore(self):
        state = init_train_state(self.model, self.tcfg.seed, self.tcfg.train,
                                 device=self.device)
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0, state
        state = restore(self.tcfg.ckpt_dir, latest, state)
        self.log(f"[trainer] restored step {latest}")
        return int(latest), state

    def _place_batch(self, batch):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def run(self) -> dict:
        """Train until max_steps, resuming from the latest checkpoint."""
        start, state = self._init_or_restore()
        ema = None
        losses = []
        for step in range(start, self.tcfg.max_steps):
            if self.fault_hook is not None:
                self.fault_hook(step)          # may raise (injected failure)
            batch = self._place_batch(self.dataset[step])
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            losses.append(loss)
            if step > start + 1:               # skip the warm-up step
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
                if dt > self.tcfg.straggler_factor * ema:
                    self.straggler_steps.append(step)
                    self.log(f"[trainer] straggler step {step}: "
                             f"{dt:.3f}s vs ema {ema:.3f}s")
            if (step + 1) % self.tcfg.log_every == 0:
                self.log(f"[trainer] step {step + 1} "
                         f"loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            if ((step + 1) % self.tcfg.ckpt_every == 0
                    or step + 1 == self.tcfg.max_steps):
                self.ckpt.save_async(step + 1, state)
        self.ckpt.wait()
        return {"state": state, "losses": losses,
                "stragglers": self.straggler_steps}


def run_with_restarts(make_trainer: Callable[[], Trainer],
                      max_restarts: int = 3) -> dict:
    """Rebuild the trainer (a fresh 'process') and resume from the latest
    checkpoint after each crash, up to ``max_restarts`` times."""
    last_exc: Optional[BaseException] = None
    for attempt in range(max_restarts + 1):
        trainer = make_trainer()
        try:
            out = trainer.run()
            out["restarts"] = attempt
            return out
        except Exception as e:                 # noqa: BLE001 (restart loop)
            last_exc = e
            trainer.log(f"[trainer] crash (attempt {attempt}): {e!r}; "
                        f"restarting from the latest checkpoint")
    raise RuntimeError(f"exceeded {max_restarts} restarts") from last_exc
