"""The train step: loss -> grads -> (optional EF compression) -> AdamW.

``make_train_step(model, tcfg)`` returns ``step_fn(state, batch) ->
(state, metrics)``; it updates the parameters and the optimizer state in
place.  A train state is

    {"params": nn.Module, "opt": {"m": {name: t}, "v": {name: t},
     "step": int32}, "ef": {name: bf16 t} (with compress_grads="int8_ef")}

Gradient accumulation: with ``microbatches > 1`` each slice of the batch
gets its own ``torch.autograd.grad``, summed into f32 buffers (never into
bf16 ``.grad``), as the reference's scan does.  The metrics are the mean
loss and the last microbatch's metrics.  A parameter that the loss does
not reach (the router's projections under hard Top-k routing) gets a zero
gradient, as under ``jax.grad``.

Error-feedback INT8 gradient compression (``compress_grads='int8_ef'``):
g' = g + ef;  q = Q8(g');  ef' = g' - q;  the optimizer consumes q.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quant import true_div
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule, gradient accumulation and compression."""
    optimizer: AdamWConfig = AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 10_000
    microbatches: int = 1
    compress_grads: str = "none"      # none | int8_ef


def init_train_state(model, seed, tcfg: TrainConfig, device="cuda") -> dict:
    """Fresh params from ``seed`` on ``device``, zero AdamW moments and,
    with EF compression, zero bf16 error buffers."""
    params = model.init(seed, device=device)
    state = {"params": params, "opt": adamw_init(params, tcfg.optimizer)}
    if tcfg.compress_grads == "int8_ef":
        state["ef"] = {n: torch.zeros(p.shape, dtype=torch.bfloat16,
                                      device=p.device)
                       for n, p in params.named_parameters()}
    return state


def _ef_compress(grads: dict, ef: dict):
    """Error-feedback INT8 fake compression (per-tensor scale); returns
    (compressed grads in f32, new bf16 error buffers)."""
    out, new_ef = {}, {}
    for name, g in grads.items():
        g32 = g.to(torch.float32) + ef[name].to(torch.float32)
        s = true_div(torch.clamp(torch.amax(torch.abs(g32)), min=1e-12),
                     127.0)
        q = torch.round(g32 / s) * s
        out[name] = q
        new_ef[name] = (g32 - q).to(torch.bfloat16)
    return out, new_ef


def make_train_step(model, tcfg: TrainConfig):
    """Build ``step_fn(state, batch) -> (state, metrics)`` for ``model``
    (a ``models.api.Model``); ``batch`` holds tensors on the params'
    device."""

    def loss_and_grads(params, batch):
        names, leaves = zip(*params.named_parameters())
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(names, leaves, grads)}
        return grads, loss.detach(), {k: v.detach()
                                      for k, v in metrics.items()}

    def grads_and_metrics(params, batch):
        mb = tcfg.microbatches
        if mb <= 1:
            return loss_and_grads(params, batch)
        g_sum, l_sum, metrics = None, 0.0, None
        for i in range(mb):
            mbatch = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                      for k, v in batch.items()}
            g, loss, metrics = loss_and_grads(params, mbatch)
            if g_sum is None:
                g_sum = {n: t.to(torch.float32) for n, t in g.items()}
            else:
                for n, t in g.items():
                    g_sum[n].add_(t)
            del g
            l_sum = l_sum + loss
        for t in g_sum.values():
            t.div_(mb)
        return g_sum, l_sum / mb, metrics

    def step_fn(state, batch):
        params = state["params"]
        grads, loss, metrics = grads_and_metrics(params, batch)
        if tcfg.compress_grads == "int8_ef":
            grads, state["ef"] = _ef_compress(grads, state["ef"])
        # the schedule reads the step before adamw_update increments it
        lr_scale = cosine_schedule(state["opt"]["step"], tcfg.warmup_steps,
                                   tcfg.total_steps)
        _, state["opt"], om = adamw_update(params, grads, state["opt"],
                                           tcfg.optimizer, lr_scale)
        return state, {"loss": loss, **metrics, **om}

    return step_fn
