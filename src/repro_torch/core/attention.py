"""Reference attention math for SLA2: the O(N^2) oracles (tests and tiny
models only, never at 32k).  Shapes follow (B, H, N, D); block masks are
(B, H, T_m, T_n) and are expanded internally.

Unselected entries of the sparse branch do not take part in the row
softmax (the NEG_INF interpretation of ``S (.) M``, what Algorithm 2
computes by skipping blocks); the linear branch runs over the complement.
Soft (stage-1) masks wait for the training slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import masks as masklib
from repro_torch.core.quant import fake_quant, smooth_k

_EPS = 1e-12


def phi(x: torch.Tensor) -> torch.Tensor:
    """Linear-attention feature map: softmax over the head dim, in f32."""
    return torch.softmax(x.to(torch.float32), dim=-1)


def _blockwise_fake_quant(x: torch.Tensor, block: int,
                          bits: str) -> torch.Tensor:
    """Per-(token-block, d) fake-quant: Algorithm 2's per-tile scales."""
    *lead, n, d = x.shape
    if n % block:
        return fake_quant(x, bits)
    xb = x.reshape(*lead, n // block, block, d)
    return fake_quant(xb, bits, (-2, -1)).reshape(*lead, n, d)


def _scaled_scores(q, k):
    d = q.shape[-1]
    return torch.einsum("...nd,...md->...nm", q.to(torch.float32),
                        k.to(torch.float32)) / math.sqrt(d)


def full_attention(q, k, v, *, causal: bool = False, q_offset: int = 0,
                   prefix_len: int = 0):
    """O = softmax(QK^T / sqrt(d)) V."""
    s = _scaled_scores(q, k)
    if causal:
        cm = masklib.token_causal_mask(q.shape[-2], k.shape[-2], q_offset,
                                       prefix_len, device=q.device)
        s = torch.where(cm, s, torch.full_like(s, masklib.NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...nm,...md->...nd", p,
                        v.to(torch.float32)).to(q.dtype)


def sparse_attention(q, k, v, mask_c, *, block_q: int, block_k: int,
                     causal: bool = False, quant_bits: str = "none",
                     prefix_len: int = 0):
    """Block-masked softmax attention (paper Eq. 2, the O_s branch) with a
    hard {0, 1} block mask; ``quant_bits`` applies QAT fake-quant (Q/K per
    tile before QK^T, P per row and V per tensor before PV)."""
    n_q, n_k = q.shape[-2], k.shape[-2]
    qq, kk = q, k
    if quant_bits != "none":
        kk = smooth_k(kk)
        qq = _blockwise_fake_quant(qq, block_q, quant_bits)
        kk = _blockwise_fake_quant(kk, block_k, quant_bits)
    s = _scaled_scores(qq, kk)
    m = masklib.expand_mask(mask_c.to(torch.float32), block_q, block_k)
    neg = torch.full_like(s, masklib.NEG_INF)
    s = torch.where(m > 0.5, s, neg)
    if causal:
        cm = masklib.token_causal_mask(n_q, n_k, 0, prefix_len,
                                       device=q.device)
        s = torch.where(cm, s, neg)
    s_max = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=-1e20)
    p = torch.exp(s - s_max)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=_EPS)
    vv = v
    if quant_bits != "none":
        p = fake_quant(p, quant_bits, (-1,))
        vv = fake_quant(v, quant_bits)
    return torch.einsum("...nm,...md->...nd", p,
                        vv.to(torch.float32)).to(q.dtype)


def linear_attention(q, k, v, mask_c, *, block_q: int, block_k: int,
                     causal: bool = False, prefix_len: int = 0):
    """The O_l branch (paper Eq. 3): row-normalised linear attention
    ``norm(phi(Q) phi(K)^T (.) (1 - M)) V`` over the block complement."""
    p = torch.einsum("...nd,...md->...nm", phi(q), phi(k))
    m = masklib.expand_mask(mask_c.to(torch.float32), block_q, block_k)
    p = p * (m <= 0.5).to(torch.float32)
    if causal:
        cm = masklib.token_causal_mask(q.shape[-2], k.shape[-2], 0,
                                       prefix_len, device=q.device)
        p = p * cm.to(p.dtype)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=_EPS)
    return torch.einsum("...nm,...md->...nd", p,
                        v.to(torch.float32)).to(q.dtype)


def block_kv_states(k, v, *, block_k: int):
    """Per-block linear states h_j = phi(K_j)^T V_j (d x d) and
    z_j = colsum(phi(K_j)) (d,): (..., N, d) -> (..., T_n, d, d), (..., T_n, d)."""
    kf = phi(k)
    *lead, n, d = k.shape
    t_n = n // block_k
    kb = kf.reshape(*lead, t_n, block_k, d)
    vb = v.to(torch.float32).reshape(*lead, t_n, block_k, v.shape[-1])
    h = torch.einsum("...jbd,...jbe->...jde", kb, vb)
    return h, kb.sum(dim=-2)
