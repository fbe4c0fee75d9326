"""Differentiable SoftTop-k used by the SLA2 router in stage-1 training.

    SoftTopk(k%, P)_ij = sigmoid(P_ij / tau + lambda_i)

with the per-row bias ``lambda_i`` found by bisection so that each row sums
to the block budget ``c = k% * T_n``.  The gradient takes both the explicit
``P_ij / tau`` term and the implicit dependence of ``lambda_i`` on the row
(implicit function theorem on ``sum_j sigmoid(P_ij/tau + lam_i) = c``):

    dL/dP_ik = (sig'_ik / tau) * (gbar_ik - sum_j gbar_ij sig'_ij / sum_j sig'_ij)

which the ``torch.autograd.Function`` below applies in closed form.

Rows may carry an ``allowed`` mask (causal routing): disallowed entries
are left out of the constraint and are 0 in the output.
"""
from __future__ import annotations

from typing import Optional

import torch

_BISECT_ITERS = 60


def _row_budget(allowed: Optional[torch.Tensor], t_n: int, k_frac: float,
                dtype, device) -> torch.Tensor:
    if allowed is None:
        return torch.tensor(k_frac * t_n, dtype=dtype, device=device)
    n_allowed = allowed.sum(dim=-1).to(dtype)
    budget = k_frac * n_allowed
    # at least one block, at most every allowed block
    return torch.minimum(torch.clamp(budget, min=1.0),
                         torch.clamp(n_allowed, min=1.0))


def _solve_lambda(scores: torch.Tensor, tau: float, budget: torch.Tensor,
                  allowed: Optional[torch.Tensor]) -> torch.Tensor:
    """Bisection for lambda_i with sum_j sigmoid(s_ij/tau + lam_i) = budget_i."""
    x = scores / tau
    if allowed is not None:
        x = torch.where(allowed, x, torch.full_like(x, -1e9))
    finite = torch.isfinite(x) & (x > -1e8)
    hi = -torch.amin(torch.where(finite, x, torch.full_like(x, float("inf"))),
                     dim=-1) + 30.0
    lo = -torch.amax(x, dim=-1) - 30.0
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        too_big = torch.sigmoid(x + mid[..., None]).sum(dim=-1) > budget
        hi = torch.where(too_big, mid, hi)
        lo = torch.where(too_big, lo, mid)
    return 0.5 * (lo + hi)


class _SoftTopk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, k_frac, tau, allowed):
        dtype = torch.promote_types(scores.dtype, torch.float32)
        s = scores.to(dtype)
        budget = _row_budget(allowed, s.shape[-1], k_frac, dtype, s.device)
        lam = _solve_lambda(s, tau, budget, allowed)
        logits = s / tau + lam[..., None]
        if allowed is not None:
            logits = torch.where(allowed, logits,
                                 torch.full_like(logits, -1e9))
        m = torch.sigmoid(logits)
        if allowed is not None:
            m = m * allowed.to(m.dtype)
        ctx.tau = tau
        ctx.save_for_backward(m, allowed)
        return m.to(scores.dtype)

    @staticmethod
    def backward(ctx, g):
        m, allowed = ctx.saved_tensors
        in_dtype = g.dtype
        g = g.to(m.dtype)
        sig_p = m * (1.0 - m)                  # sigmoid'
        if allowed is not None:
            sig_p = sig_p * allowed.to(sig_p.dtype)
        denom = torch.clamp(sig_p.sum(dim=-1, keepdim=True), min=1e-20)
        weighted = (g * sig_p).sum(dim=-1, keepdim=True) / denom
        grad = (sig_p / ctx.tau) * (g - weighted)
        return grad.to(in_dtype), None, None, None


def soft_topk(scores: torch.Tensor, k_frac: float, tau: float,
              allowed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft row-wise top-k mask in (0, 1); rows sum to ``k_frac * n_allowed``.

    scores (..., T_m, T_n) router scores; ``k_frac`` the share of blocks
    kept; ``tau`` the temperature (the paper uses 0.1); ``allowed`` an
    optional bool mask of selectable entries."""
    return _SoftTopk.apply(scores, k_frac, tau, allowed)
