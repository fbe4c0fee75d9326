"""The SLA2 learnable router R (paper Sec. 4).

    Qbar = pool(Q);  Kbar = pool(K)                       (Eq. 15)
    P_c  = softmax( proj_q(Qbar) proj_k(Kbar)^T / sqrt(d) )
    M_c  = Top-k(k%, P_c)                                 (Eq. 16)

Hard Top-k at inference and in stage 2; SoftTop-k (``soft_topk.py``) in
stage-1 training.  Causal routing is restricted to visible blocks and
forces the diagonal block into the sparse branch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core import masks
from repro_torch.core.soft_topk import soft_topk


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Routing geometry: tile sizes, k% of blocks kept, causal/prefix-LM
    and sliding-window restrictions, learnable projections or not, and
    the SoftTop-k temperature ``tau``."""
    block_q: int = 128
    block_k: int = 64
    k_frac: float = 0.05
    tau: float = 0.1
    learnable: bool = True
    causal: bool = False
    prefix_len: int = 0
    force_diagonal: bool = True
    sliding_window: Optional[int] = None


class RouterParams(nn.Module):
    """proj_q / proj_k as bias-free linear maps (weight is (out, in): the
    transpose of the JAX ``(d, d)`` matrix applied as ``x @ proj``)."""

    def __init__(self, head_dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.proj_q = nn.Linear(head_dim, head_dim, bias=False,
                                dtype=dtype, device=device)
        self.proj_k = nn.Linear(head_dim, head_dim, bias=False,
                                dtype=dtype, device=device)


def init_router_params(generator: torch.Generator, head_dim: int,
                       cfg: RouterConfig, dtype=torch.float32,
                       device=None) -> Optional[RouterParams]:
    """Projections near identity (eye + N(0, (0.02/sqrt(d))^2)), so training
    starts at SLA's heuristic router; None when ``learnable`` is False."""
    if not cfg.learnable:
        return None
    p = RouterParams(head_dim, dtype, device)
    noise = 0.02 / math.sqrt(head_dim)
    with torch.no_grad():
        for lin in (p.proj_q, p.proj_k):
            w = torch.randn(head_dim, head_dim, generator=generator,
                            device=device, dtype=torch.float32)
            eye = torch.eye(head_dim, device=device, dtype=torch.float32)
            lin.weight.copy_((eye + noise * w).T)
    return p


def pool_blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """Mean-pool over non-overlapping token windows: (..., N, d) -> (..., N/b, d)."""
    *lead, n, d = x.shape
    if n % block:
        raise ValueError(f"seq {n} not divisible by block {block}")
    return x.reshape(*lead, n // block, block, d).mean(dim=-2)


def router_scores(params: Optional[RouterParams], q: torch.Tensor,
                  k: torch.Tensor, cfg: RouterConfig, *,
                  normalize: bool = True) -> torch.Tensor:
    """Compressed routing scores P_c (..., T_m, T_n) from (..., N, d) q/k."""
    d = q.shape[-1]
    qb = pool_blocks(q.to(torch.float32), cfg.block_q)
    kb = pool_blocks(k.to(torch.float32), cfg.block_k)
    if cfg.learnable and params is not None:
        qb = qb @ params.proj_q.weight.to(torch.float32).T
        kb = kb @ params.proj_k.weight.to(torch.float32).T
    s = torch.einsum("...md,...nd->...mn", qb, kb) / math.sqrt(d)
    if cfg.causal:
        allowed = masks.block_causal_mask(s.shape[-2], s.shape[-1],
                                          cfg.block_q, cfg.block_k,
                                          cfg.prefix_len, device=s.device)
        s = torch.where(allowed, s, torch.full_like(s, masks.NEG_INF))
    return torch.softmax(s, dim=-1) if normalize else s


def _allowed_and_forced(t_m: int, t_n: int, cfg: RouterConfig, device=None):
    allowed = None
    force = None
    if cfg.causal:
        allowed = masks.block_causal_mask(t_m, t_n, cfg.block_q, cfg.block_k,
                                          cfg.prefix_len, device=device)
        if cfg.force_diagonal:
            force = masks.block_diagonal_mask(t_m, t_n, cfg.block_q,
                                              cfg.block_k, cfg.prefix_len,
                                              device=device)
    if cfg.sliding_window is not None:
        swa = masks.sliding_window_block_mask(
            t_m, t_n, cfg.block_q, cfg.block_k, cfg.sliding_window,
            device=device)
        allowed = swa if allowed is None else (allowed & swa)
    return allowed, force


def route(params: Optional[RouterParams], q: torch.Tensor, k: torch.Tensor,
          cfg: RouterConfig, *, soft: bool = False) -> torch.Tensor:
    """Block mask M_c (..., T_m, T_n): hard {0, 1} Top-k, or with ``soft``
    the SoftTop-k relaxation in (0, 1) over the un-normalised scores (the
    softmaxed ones are O(1/T_n), far below any usable temperature)."""
    p_c = router_scores(params, q, k, cfg, normalize=not soft)
    t_m, t_n = p_c.shape[-2], p_c.shape[-1]
    allowed, force = _allowed_and_forced(t_m, t_n, cfg, device=p_c.device)
    if soft:
        m = soft_topk(p_c, cfg.k_frac, cfg.tau, allowed)
        if force is not None:
            m = torch.maximum(m, force.to(m.dtype))
        return m
    k_sel = max(1, round(cfg.k_frac * t_n))
    return masks.topk_block_mask(p_c, k_sel, allowed=allowed, force=force)


def route_indices(params: Optional[RouterParams], q: torch.Tensor,
                  k: torch.Tensor, cfg: RouterConfig,
                  k_sel: Optional[int] = None):
    """Hard routing as indices for the kernels: ``idx`` int32
    (..., T_m, K_sel) kv-block ids sorted ascending per row, and ``valid``
    bool (..., T_m, K_sel).  Padding entries repeat the row's best index
    and are flagged invalid."""
    p_c = router_scores(params, q, k, cfg)
    t_m, t_n = p_c.shape[-2], p_c.shape[-1]
    if k_sel is None:
        k_sel = max(1, round(cfg.k_frac * t_n))
    k_sel = min(k_sel, t_n)
    allowed, force = _allowed_and_forced(t_m, t_n, cfg, device=p_c.device)
    s = p_c
    if force is not None:
        s = torch.where(force, torch.full_like(s, float("inf")), s)
    if allowed is not None:
        s = torch.where(allowed, s, torch.full_like(s, 2.0 * masks.NEG_INF))
    top_vals, idx = masks.top_k(s, k_sel)
    valid = top_vals > 1.5 * masks.NEG_INF
    idx = torch.where(valid, idx, idx[..., :1])
    idx, order = torch.sort(idx, dim=-1, stable=True)
    valid = torch.gather(valid, -1, order)
    return idx.to(torch.int32), valid
