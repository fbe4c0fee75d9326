"""Block-mask utilities for sparse-linear attention.

All masks here are block-level: a compressed mask ``M_c`` of shape
``(..., T_m, T_n)`` with ``T_m = N_q / b_q`` query blocks and
``T_n = N_kv / b_k`` key/value blocks.  ``expand_mask`` turns a block mask
into a token-level ``(..., N_q, N_kv)`` mask for reference computations;
the kernels never materialise the expanded mask.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def expand_mask(mask_c: torch.Tensor, b_q: int, b_k: int) -> torch.Tensor:
    """Expand a block mask (..., T_m, T_n) to token level (..., N_q, N_kv)."""
    m = torch.repeat_interleave(mask_c, b_q, dim=-2)
    return torch.repeat_interleave(m, b_k, dim=-1)


def block_causal_mask(t_m: int, t_n: int, b_q: int, b_k: int,
                      prefix_len: int = 0, device=None) -> torch.Tensor:
    """Block (i, j) is visible iff the last query of block i may see the
    first key of block j; ``prefix_len`` tokens are visible to everyone.
    Returns bool (t_m, t_n)."""
    qi = (torch.arange(t_m, device=device) + 1) * b_q - 1
    kj = torch.arange(t_n, device=device) * b_k
    vis = qi[:, None] >= kj[None, :]
    if prefix_len:
        vis = vis | (kj[None, :] < prefix_len)
    return vis


def block_diagonal_mask(t_m: int, t_n: int, b_q: int, b_k: int,
                        prefix_len: int = 0, device=None) -> torch.Tensor:
    """Blocks that straddle the causal boundary: causally visible but not
    fully visible (and not fully inside the always-visible prefix)."""
    vis = block_causal_mask(t_m, t_n, b_q, b_k, prefix_len, device)
    qi0 = torch.arange(t_m, device=device) * b_q
    kj1 = (torch.arange(t_n, device=device) + 1) * b_k - 1
    full = kj1[None, :] <= qi0[:, None]
    if prefix_len:
        full = full | (kj1[None, :] < prefix_len)
    return vis & ~full


def token_causal_mask(n_q: int, n_kv: int, q_offset: int = 0,
                      prefix_len: int = 0, device=None) -> torch.Tensor:
    """Token-level causal mask; ``q_offset`` is the absolute position of
    query 0, ``prefix_len`` leading tokens are visible to everyone."""
    qi = torch.arange(n_q, device=device) + q_offset
    kj = torch.arange(n_kv, device=device)
    vis = qi[:, None] >= kj[None, :]
    if prefix_len:
        vis = vis | (kj[None, :] < prefix_len)
    return vis


def sliding_window_block_mask(t_m: int, t_n: int, b_q: int, b_k: int,
                              window: int, device=None) -> torch.Tensor:
    """Blocks possibly inside a sliding attention window of ``window``."""
    qi_last = (torch.arange(t_m, device=device) + 1) * b_q - 1
    qi_first = torch.arange(t_m, device=device) * b_q
    kj_first = torch.arange(t_n, device=device) * b_k
    kj_last = (torch.arange(t_n, device=device) + 1) * b_k - 1
    causal = qi_last[:, None] >= kj_first[None, :]
    inside = kj_last[None, :] >= (qi_first[:, None] - window + 1)
    return causal & inside


def top_k(s: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, in
    descending order, ties broken towards the lower index, as
    ``jax.lax.top_k`` breaks them (``torch.topk`` leaves the order of
    equal values open): causal rows with block_q > block_k force several
    diagonal blocks to the same +inf score."""
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_block_mask(scores: torch.Tensor, k_sel: int, *,
                    allowed: Optional[torch.Tensor] = None,
                    force: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hard row-wise Top-k over block scores (..., T_m, T_n).

    ``allowed`` entries outside are never selected; ``force`` entries are
    always selected (boosted to +inf, counted inside k_sel).  Returns a
    float {0, 1} mask; ties go to the lower index (``top_k``)."""
    s = scores
    if force is not None:
        s = torch.where(force, torch.full_like(s, float("inf")), s)
    if allowed is not None:
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    t_n = s.shape[-1]
    k_sel = max(1, min(int(k_sel), t_n))
    idx = top_k(s, k_sel)[1]
    m = torch.zeros_like(s, dtype=torch.float32).scatter_(-1, idx, 1.0)
    if allowed is not None:
        m = m * allowed.to(m.dtype)
    if force is not None:
        m = torch.maximum(m, force.to(m.dtype))
    return m


def mask_sparsity(mask_c: torch.Tensor,
                  allowed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fraction of (allowed) blocks NOT routed to the sparse branch."""
    if allowed is None:
        total = mask_c.shape[-1] * mask_c.shape[-2]
        return 1.0 - mask_c.sum(dim=(-1, -2)) / total
    a = allowed.to(mask_c.dtype)
    return 1.0 - (mask_c * a).sum(dim=(-1, -2)) / torch.clamp(
        a.sum(dim=(-1, -2)), min=1.0)
