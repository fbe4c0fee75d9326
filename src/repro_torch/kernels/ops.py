"""The SLA2 operator in kernel mode, and the tile helpers of the plain
kernel versions.

``sparse_attention_op`` is the sparse branch as a ``torch.autograd.Function``:
K-smoothing when quantised, then ``sparse_flash_fwd`` (the CUDA kernel on
a CUDA tensor, its plain version on a CPU tensor); its backward is
``sparse_flash_bwd`` in full precision (the QAT backward).

``sla2_block_sparse`` is the full operator:

    router indices -> sparse branch (kernel) -> linear branch over the
    complement (plain PyTorch, complement trick) -> alpha combine.
"""
from __future__ import annotations

import torch

from repro_torch.core import router as routerlib
from repro_torch.core import sla2 as sla2lib
from repro_torch.core.block_sparse import linear_branch
from repro_torch.core.quant import smooth_k, true_div

_EPS = 1e-12

NEG_INF = -1e30
INT8_MAX = 127.0
FP8_MAX = 448.0


def quantize_tile(x: torch.Tensor, bits: str):
    """Per-tile symmetric quantisation over the last two dims (every
    leading index is its own tile); returns (codes, scale) with the scale
    shaped (..., 1, 1) in f32.  int8 codes are ``clip(round(x / s))``,
    half to even; fp8 codes are e4m3, round to nearest even."""
    ax = torch.amax(torch.abs(x), dim=(-2, -1), keepdim=True)
    if bits == "int8":
        s = torch.clamp(true_div(ax, INT8_MAX), min=1e-8)
        q = torch.clamp(torch.round(x / s), -INT8_MAX, INT8_MAX)
        return q.to(torch.int8), s
    if bits == "fp8":
        s = torch.clamp(true_div(ax, FP8_MAX), min=1e-12)
        return (x / s).to(torch.float8_e4m3fn), s
    raise ValueError(bits)


def qdot(a, a_s, b, b_s, *, transpose_b: bool):
    """Batched low-bit tile product with an f32 dequantised result:
    ``(a @ b[^T]) * (a_s * b_s)``.  int8 codes are multiplied as f32
    integers: every partial sum of two int8 products over d <= 1024 stays
    below 2^24, so the f32 sum is the exact int32 product."""
    bm = b.to(torch.float32)
    if transpose_b:
        bm = bm.transpose(-1, -2)
    out = torch.matmul(a.to(torch.float32), bm)
    return out * (a_s * b_s)


# ---------------------------------------------------------------------------
# Page-pool storage quantisation (the serving ``kv_quant`` knob)
# ---------------------------------------------------------------------------
# The paged K/V pool may hold int8 or fp8-e4m3 codes with one f32 scale per
# token row (page, kv head, row).  A row is quantised once, when it is
# written, and never again, so swapping pages out and back is exact.  The
# gather reference and the CUDA kernels dequantise with the same formula,
# ``codes * scale``.

KV_QUANT_MODES = ("none", "int8", "fp8")


def kv_pool_dtype(kv_quant: str) -> torch.dtype:
    """Storage dtype of the K/V (and SLA2 pooled-key) page arrays."""
    if kv_quant == "int8":
        return torch.int8
    if kv_quant == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(kv_quant)


def quantize_rows(x: torch.Tensor, kv_quant: str):
    """Per-row symmetric quantisation over the last axis; returns (codes,
    scale) with ``scale.shape == x.shape[:-1]`` in f32.  The scale is a
    true division (``true_div``), as the reference computes it."""
    x = x.to(torch.float32)
    ax = torch.amax(torch.abs(x), dim=-1)
    if kv_quant == "int8":
        s = torch.clamp(true_div(ax, INT8_MAX), min=1e-8)
        q = torch.clamp(torch.round(x / s[..., None]), -INT8_MAX, INT8_MAX)
        return q.to(torch.int8), s
    if kv_quant == "fp8":
        s = torch.clamp(true_div(ax, FP8_MAX), min=1e-12)
        return (x / s[..., None]).to(torch.float8_e4m3fn), s
    raise ValueError(kv_quant)


def dequant_rows(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_rows``: ``codes * scale`` in f32."""
    return codes.to(torch.float32) * scale[..., None].to(torch.float32)


class _SparseAttention(torch.autograd.Function):
    """Forward: the sparse-branch kernel.  Backward: ``sparse_flash_bwd``
    on the saved (q, k_used, v, idx, valid, o, lse).  The gradient of
    ``k_used`` is returned as that of ``k``, an identity through the
    smoothing, as the reference does: each row of dS sums to 0 when the
    forward is full precision, so the colmean shift has no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, idx, valid, block_q, block_k, causal,
                quant_bits, prefix_len):
        from repro_torch.kernels.sla2_fwd import sparse_flash_fwd
        k_used = (smooth_k(k) if quant_bits != "none" else k).contiguous()
        q, v = q.contiguous(), v.contiguous()
        valid = valid.to(torch.int32)
        o, lse = sparse_flash_fwd(
            q, k_used, v, idx, valid, block_q=block_q, block_k=block_k,
            causal=causal, prefix_len=prefix_len, quant_bits=quant_bits)
        ctx.save_for_backward(q, k_used, v, idx, valid, o, lse)
        ctx.geometry = (block_q, block_k, causal, prefix_len)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        from repro_torch.kernels.sla2_bwd import sparse_flash_bwd
        q, k_used, v, idx, valid, o, lse = ctx.saved_tensors
        block_q, block_k, causal, prefix_len = ctx.geometry
        dq, dk, dv = sparse_flash_bwd(
            q, k_used, v, idx, valid, o, lse, do.contiguous(),
            block_q=block_q, block_k=block_k, causal=causal,
            prefix_len=prefix_len)
        return dq, dk, dv, None, None, None, None, None, None, None


def sparse_attention_op(q, k, v, idx, valid, block_q: int, block_k: int,
                        causal: bool, quant_bits: str, prefix_len: int = 0):
    """Sparse branch O_s + LSE, differentiable in q, k, v.  q/k/v
    (BH, N, d); idx/valid (BH, T_m, K_sel).  In quant mode K is smoothed
    first (softmax-invariant colmean shift)."""
    return _SparseAttention.apply(q, k, v, idx, valid, block_q, block_k,
                                  causal, quant_bits, prefix_len)


def sla2_block_sparse(params, q, k, v, cfg):
    """SLA2 Eq. 13 with the kernel sparse branch.  q/k/v (B, H, N, D);
    returns (o, aux) with aux holding idx, valid and the LSE."""
    b, h_num, n, d = q.shape
    rcfg = cfg.router
    qf, kf, vf = (x.reshape(b * h_num, n, x.shape[-1]) for x in (q, k, v))
    idx, valid = routerlib.route_indices(params.router, qf, kf, rcfg)
    o_s, lse = sparse_attention_op(
        qf, kf, vf, idx, valid, rcfg.block_q, rcfg.block_k, rcfg.causal,
        cfg.quant_bits, rcfg.prefix_len)
    o_l, den = linear_branch(
        qf, kf, vf, idx, valid, block_q=rcfg.block_q, block_k=rcfg.block_k,
        causal=rcfg.causal, prefix_len=rcfg.prefix_len)
    t_m = n // rcfg.block_q
    a_blocks = sla2lib.alpha_for_blocks(params, t_m, h_num)      # (H, T_m)
    a_tok = torch.repeat_interleave(a_blocks, rcfg.block_q, dim=-1)
    a_tok = a_tok[None].expand(b, h_num, n).reshape(b * h_num, n, 1)
    a_eff = torch.where(den > _EPS, a_tok, 1.0)
    o = (a_eff * o_s.to(torch.float32)
         + (1.0 - a_eff) * o_l.to(torch.float32)).to(q.dtype)
    aux = {"idx": idx, "valid": valid, "lse": lse.reshape(b, h_num, n)}
    return o.reshape(b, h_num, n, d), aux
