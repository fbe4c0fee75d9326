"""Stage-1 training (paper Algorithm 1, lines 1-4): fit the router R and
the mixing ratio alpha before end-to-end fine-tuning.

    sample (Q, K, V) from the attention layers;
    L = MSE(FullAttn(Q, K, V), SLA2(Q, K, V, k%, R, alpha));
    train R and alpha under each k% with SoftTop-k routing.

Q/K/V come from a synthetic generator with the paper's structure (a
shared low-rank subspace in Q and K).  The soft path is the O(N^2) ref
path, so stage 1 runs at a few thousand tokens, never at 32k.  Stage 2
(end-to-end fine-tuning with hard Top-k) is the normal trainer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import masks as masklib
from repro_torch.core import router as routerlib
from repro_torch.core import sla2 as sla2lib
from repro_torch.core.sla2 import SLA2Config, SLA2Params
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    """k% ladder, steps, optimizer and the SoftTop-k temperature anneal
    (a geometric ladder of ``tau_stages`` temperatures)."""
    k_fracs: tuple = (0.05, 0.04, 0.03)   # the paper trains 5%, 4%, 3%
    steps_per_k: int = 100
    optimizer: AdamWConfig = AdamWConfig(lr=1e-3, weight_decay=0.0)
    log_every: int = 25
    tau_start: float = 0.1
    tau_end: float = 0.01
    tau_stages: int = 4


def synthetic_qkv(generator: torch.Generator, *, batch: int, heads: int,
                  seq: int, dim: int, structure: float = 0.7):
    """(B, H, N, D) q, k, v: Gaussians with a shared low-rank subspace
    blended into q and k (weight ``structure``), on the generator's
    device."""
    dev = generator.device
    randn = lambda *shape: torch.randn(shape, generator=generator,
                                       device=dev)
    q = randn(batch, heads, seq, dim)
    k = randn(batch, heads, seq, dim)
    v = randn(batch, heads, seq, dim)
    rank = max(1, dim // 8)
    sub = randn(heads, rank, dim)
    coef_q = randn(batch, heads, seq, rank)
    coef_k = randn(batch, heads, seq, rank)
    q = (1 - structure) * q + structure * torch.einsum(
        "bhsr,hrd->bhsd", coef_q, sub)
    k = (1 - structure) * k + structure * torch.einsum(
        "bhsr,hrd->bhsd", coef_k, sub)
    return q, k, v


@torch.no_grad()
def init_alpha_from_data(params: SLA2Params, q, k,
                         cfg: SLA2Config) -> SLA2Params:
    """Set alpha from the measured probability mass that the hard router
    mask selects (Eq. 7: alpha = P1.1) instead of a constant; in place on
    ``params.alpha_logit``, which is returned."""
    rcfg = cfg.router
    mask_c = routerlib.route(params.router, q, k, rcfg)
    m = masklib.expand_mask(mask_c, rcfg.block_q, rcfg.block_k)
    d = q.shape[-1]
    s = torch.einsum("bhnd,bhmd->bhnm", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(d)
    if rcfg.causal:
        cm = masklib.token_causal_mask(q.shape[-2], k.shape[-2], 0,
                                       rcfg.prefix_len, device=q.device)
        s = torch.where(cm, s, masklib.NEG_INF)
    mass = (torch.softmax(s, dim=-1) * m).sum(-1)        # (B, H, N)
    h = mass.shape[1]
    t_m = mass.shape[-1] // rcfg.block_q
    mm = mass.mean(0).reshape(h, t_m, rcfg.block_q).mean(-1)
    mm = torch.clamp(mm, 1e-3, 1 - 1e-3)
    logit = torch.log(mm / (1 - mm))
    stored = params.alpha_logit
    if stored.shape == logit.shape:
        stored.copy_(logit)
    elif stored.shape[-1] >= t_m:              # alpha table longer than data
        stored[..., :t_m] = logit.to(stored.dtype)
    else:
        stored.copy_(logit.mean(-1, keepdim=True).expand(stored.shape))
    return params


def run_stage1(seed, qkv_stream: Iterator, cfg: SLA2Config, s1: Stage1Config,
               *, head_dim: int, num_heads: int, n_q_blocks: int,
               device="cuda", log_fn: Callable[[str], None] = print,
               data_driven_alpha: bool = True):
    """Train (R, alpha) to minimise the SLA2-vs-full-attention MSE.

    ``qkv_stream`` yields (q, k, v), each (B, H, N, D) on ``device``.
    Returns (params, history): the loss per step and the hard-Top-k MSE
    before and after, per k%."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    params = sla2lib.init_sla2_params(
        g, head_dim=head_dim, num_heads=num_heads, n_q_blocks=n_q_blocks,
        cfg=cfg, device=dev)
    names, leaves = zip(*params.named_parameters())
    opt = adamw_init(params, s1.optimizer)
    history = {"loss": [], "per_k": {}}
    taus = np.geomspace(s1.tau_start, s1.tau_end, s1.tau_stages)

    for k_frac in s1.k_fracs:
        c = dataclasses.replace(
            cfg, router=dataclasses.replace(cfg.router, k_frac=k_frac))

        def mse_hard(q, k, v, _c=c):
            with torch.no_grad():
                return float(sla2lib.sla2_mse_loss(params, q, k, v, _c,
                                                   soft=False))

        q0, k0, v0 = next(qkv_stream)
        mse_before = mse_hard(q0, k0, v0)
        if data_driven_alpha:
            init_alpha_from_data(params, q0, k0, c)
            log_fn(f"[stage1 k={k_frac:.2f}] data-driven alpha init: "
                   f"{mse_before:.5f} -> {mse_hard(q0, k0, v0):.5f}")
        per_stage = max(1, s1.steps_per_k // s1.tau_stages)
        i = 0
        for tau in taus:
            ct = dataclasses.replace(
                c, router=dataclasses.replace(c.router, tau=float(tau)))
            for _ in range(per_stage):
                q, k, v = next(qkv_stream)
                loss = sla2lib.sla2_mse_loss(params, q, k, v, ct, soft=True)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                grads = {n: torch.zeros_like(p) if gr is None else gr
                         for n, p, gr in zip(names, leaves, grads)}
                adamw_update(params, grads, opt, s1.optimizer)
                history["loss"].append(float(loss.detach()))
                i += 1
                if i % s1.log_every == 0:
                    log_fn(f"[stage1 k={k_frac:.2f} tau={tau:.3f}] "
                           f"step {i} soft-mse {history['loss'][-1]:.5f}")
        mse_after = mse_hard(q0, k0, v0)
        history["per_k"][k_frac] = {"before": mse_before,
                                    "after": mse_after}
        log_fn(f"[stage1 k={k_frac:.2f}] hard-topk MSE "
               f"{mse_before:.5f} -> {mse_after:.5f}")
    return params, history


def capture_qkv_stream(seed: int, *, batch: int, heads: int, seq: int,
                       dim: int, device="cuda"):
    """Endless synthetic q/k/v, deterministic per (seed, step)."""
    dev = resolve_device(device)
    step = 0
    while True:
        g = torch.Generator(device=dev)
        g.manual_seed(int(np.random.SeedSequence([seed, step])
                          .generate_state(1)[0]))
        yield synthetic_qkv(g, batch=batch, heads=heads, seq=seq, dim=dim)
        step += 1
