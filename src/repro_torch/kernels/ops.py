"""The SLA2 operator in kernel mode, and the tile helpers of the plain
kernel versions.

``sparse_attention_op`` is the sparse branch: K-smoothing when quantised,
then ``sparse_flash_fwd`` (the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor).  It is the forward only: the backward kernel
arrives with the training slice.

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


def sparse_attention_op(q, k, v, idx, valid, block_q: int, block_k: int,
                        causal: bool, quant_bits: str, prefix_len: int = 0):
    """Sparse branch O_s + LSE.  q/k/v (BH, N, d); idx/valid (BH, T_m, K_sel).
    In quant mode K is smoothed first (softmax-invariant colmean shift)."""
    from repro_torch.kernels.sla2_fwd import sparse_flash_fwd
    k_used = smooth_k(k) if quant_bits != "none" else k
    return sparse_flash_fwd(
        q.contiguous(), k_used.contiguous(), v.contiguous(), idx,
        valid.to(torch.int32), block_q=block_q, block_k=block_k,
        causal=causal, prefix_len=prefix_len, quant_bits=quant_bits)


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
