"""Mixture-of-Experts FFN: token-choice top-k routing with capacity-based
scatter dispatch, as the reference computes it step for step.

    router logits (f32) -> softmax -> top-k (gates, expert ids)
    rank-within-expert by an exclusive cumsum of the one-hot    (T*k, E)
    scatter the kept (token, slot) pairs into a buffer          (E, C, d)
    batched gated MLP with the expert weights                   (E, d, 2ff)
    gather the results back, weighted by their gates (f32)

The capacity is ``C = max(1, round(T * k / E * capacity_factor))`` with
Python's ``round`` (half to even).  The (token, slot) pairs are ranked
token-major, so earlier tokens take an expert's places first; a pair
beyond its expert's capacity is dropped (gate weight 0).  Every row of
``x`` counts, padding and inactive serving slots included: the callers
pass the reference's whole batch.  Shared experts (``num_shared``) run as
one dense gated MLP of width ``num_shared * d_ff_expert`` beside the
routed ones.

``w_in`` (E, d, 2 ff) and ``w_out`` (E, ff, d) keep the reference's
layout: they are the batched operands of ``torch.bmm``, which multiplies
every expert's slice of the buffer whether or not a token reached it, as
the reference's einsum does.  The reference's expert-parallel sharding
(``ep_axis``) waits for the mesh (ROADMAP).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.masks import top_k
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Experts, top-k, per-expert hidden width, always-on shared experts,
    the capacity factor and the load-balance loss weight."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_dtype: str = "float32"


class MoEParams(nn.Module):
    """``router`` (d, E) f32, ``w_in`` (E, d, 2 ff) with the gate half
    first, ``w_out`` (E, ff, d) and, with shared experts, ``shared`` (a
    gated MLP)."""

    def __init__(self, router, w_in, w_out, shared=None):
        super().__init__()
        self.router = nn.Parameter(router)
        self.w_in = nn.Parameter(w_in)
        self.w_out = nn.Parameter(w_out)
        self.shared = shared


def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.float32, device=None) -> MoEParams:
    """Random MoE params (std d_model^-1/2 in, d_ff_expert^-1/2 out).  The
    expert tensors are drawn one expert at a time: a draw of the whole
    (E, d, 2 ff) tensor would take an f32 temporary of its size."""
    e, ff = cfg.num_experts, cfg.d_ff_expert
    std = d_model ** -0.5
    router = L.truncated_normal(generator, (d_model, e), torch.float32, std,
                                device)
    w_in = torch.empty((e, d_model, 2 * ff), dtype=dtype, device=device)
    w_out = torch.empty((e, ff, d_model), dtype=dtype, device=device)
    for i in range(e):
        w_in[i] = L.truncated_normal(generator, (d_model, 2 * ff), dtype,
                                     std, device)
    for i in range(e):
        w_out[i] = L.truncated_normal(generator, (ff, d_model), dtype,
                                      ff ** -0.5, device)
    shared = None
    if cfg.num_shared:
        shared = L.init_gated_mlp(generator, d_model, cfg.num_shared * ff,
                                  dtype=dtype, device=device)
    return MoEParams(router, w_in, w_out, shared)


def route(params: MoEParams, xt: torch.Tensor, cfg: MoEConfig):
    """Routing of the token rows xt (T, d): (gates (T, k) f32, expert ids
    (T, k), softmax probabilities (T, E) f32, capacity, keep (T*k,) bool,
    buffer row of every (token, slot) pair (T*k,))."""
    t = xt.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    probs = torch.softmax(xt.to(torch.float32) @ params.router, dim=-1)
    gates, ids = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    cap = int(max(1, round(t * k / e * cfg.capacity_factor)))
    flat = ids.reshape(t * k)
    oh = F.one_hot(flat, e)
    ranks = torch.cumsum(oh, dim=0) - oh                     # exclusive
    rank = torch.gather(ranks, 1, flat[:, None])[:, 0]
    keep = rank < cap
    slot = flat * cap + torch.clamp(rank, max=cap - 1)
    return gates, ids, probs, cap, keep, slot


def moe_ffn(params: MoEParams, x: torch.Tensor, cfg: MoEConfig):
    """x (B, S, d) -> (y (B, S, d), aux load-balance loss (f32 scalar))."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    xt = x.reshape(t, d)
    gates, ids, probs, cap, keep, slot = route(params, xt, cfg)

    # Switch load balance: E * sum_e f_e * p_e over all T rows
    f = F.one_hot(ids[:, 0], e).to(torch.float32).mean(0)
    aux = cfg.aux_loss_weight * e * torch.sum(f * probs.mean(0))

    # dispatch: a dropped pair adds zeros to the last buffer row
    xk = torch.repeat_interleave(xt, k, dim=0)
    src = torch.where(keep[:, None], xk, torch.zeros_like(xk))
    buf = xt.new_zeros((e * cap, d)).index_add(
        0, torch.where(keep, slot, torch.full_like(slot, e * cap - 1)), src)

    hin = torch.bmm(buf.reshape(e, cap, d), params.w_in)     # (E, C, 2ff)
    gate_h, up_h = hin.chunk(2, dim=-1)
    act = F.silu(gate_h.to(torch.float32)).to(up_h.dtype) * up_h
    out = torch.bmm(act, params.w_out).reshape(e * cap, d)

    w = gates.reshape(t * k) * keep.to(torch.float32)
    y = (out[slot].to(torch.float32) * w[:, None]).reshape(t, k, d).sum(1)
    y = y.to(x.dtype).reshape(b, s, d)
    if params.shared is not None:
        y = y + L.gated_mlp(params.shared, x)
    return y, aux
