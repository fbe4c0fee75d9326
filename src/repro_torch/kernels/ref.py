"""O(N^2) oracles for the SLA2 kernels (tests only).

The kernels consume routing indices (``idx``/``valid`` from
``router.route_indices``); the oracles rebuild the dense block mask from
them and evaluate the same math with dense einsums.  ``manual_backward``
is the dense oracle of the sparse branch's backward (Algorithm 3).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import masks as masklib
from repro_torch.core.attention import phi
from repro_torch.core.quant import fake_quant, smooth_k

_EPS = 1e-12


def mask_from_indices(idx: torch.Tensor, valid: torch.Tensor,
                      t_n: int) -> torch.Tensor:
    """(..., T_m, K_sel) indices -> dense {0, 1} float mask (..., T_m, T_n)."""
    m = torch.zeros(*idx.shape[:-1], t_n, device=idx.device,
                    dtype=torch.float32)
    m.scatter_add_(-1, idx.long(), valid.to(torch.float32))
    return (m > 0).to(torch.float32)


def _scores(q, k, *, quant_bits: str):
    qq, kk = q, k
    if quant_bits != "none":
        kk = smooth_k(kk)
        qq = fake_quant(qq, quant_bits)
        kk = fake_quant(kk, quant_bits)
    return torch.einsum("...nd,...md->...nm", qq.to(torch.float32),
                        kk.to(torch.float32)) / math.sqrt(q.shape[-1])


def sparse_flash_ref(q, k, v, idx, valid, *, block_q: int, block_k: int,
                     causal: bool, quant_bits: str = "none",
                     kv_len: int = 0):
    """Dense oracle of the sparse-branch forward: returns (o_s, lse),
    o_s (..., N, d) and lse (..., N).  Key positions >= ``kv_len`` are
    padding when 0 < kv_len < N_kv."""
    n_q, n_kv = q.shape[-2], k.shape[-2]
    mask_c = mask_from_indices(idx, valid, n_kv // block_k)
    m = masklib.expand_mask(mask_c, block_q, block_k)
    s = _scores(q, k, quant_bits=quant_bits)
    neg = torch.full_like(s, masklib.NEG_INF)
    s = torch.where(m > 0.5, s, neg)
    if causal:
        s = torch.where(masklib.token_causal_mask(n_q, n_kv,
                                                  device=q.device), s, neg)
    if kv_len and kv_len < n_kv:
        s = torch.where(torch.arange(n_kv, device=q.device) < kv_len, s, neg)
    s_max = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=-1e20)
    p = torch.exp(s - s_max)
    l = p.sum(dim=-1, keepdim=True)
    lse = (s_max + torch.log(torch.clamp(l, min=_EPS)))[..., 0]
    p_norm = p / torch.clamp(l, min=_EPS)
    if quant_bits != "none":
        p_norm = fake_quant(p_norm, quant_bits, (-1,))
        v = fake_quant(v, quant_bits)
    o = torch.einsum("...nm,...md->...nd", p_norm, v.to(torch.float32))
    return o.to(q.dtype), lse


def linear_branch_ref(q, k, v, idx, valid, *, block_q: int, block_k: int,
                      causal: bool):
    """Dense oracle of the linear branch over the routed complement;
    causal rows use only the kv blocks fully visible to the whole query
    block.  Returns (o_l, den), den zero where the complement is empty."""
    n_q, n_kv = q.shape[-2], k.shape[-2]
    t_m, t_n = n_q // block_q, n_kv // block_k
    comp = 1.0 - mask_from_indices(idx, valid, t_n)
    if causal:
        n_full = (torch.arange(t_m, device=q.device) * block_q + 1) // block_k
        fully = torch.arange(t_n, device=q.device)[None, :] < n_full[:, None]
        comp = comp * fully.to(comp.dtype)
    qf, kf = phi(q), phi(k)
    *lead, _, d = q.shape
    kb = kf.reshape(*lead, t_n, block_k, d)
    vb = v.to(torch.float32).reshape(*lead, t_n, block_k, d)
    h = torch.einsum("...jbd,...jbe->...jde", kb, vb)
    z = kb.sum(dim=-2)
    h_i = torch.einsum("...ij,...jde->...ide", comp, h)
    z_i = torch.einsum("...ij,...jd->...id", comp, z)
    qb = qf.reshape(*lead, t_m, block_q, d)
    num = torch.einsum("...ibd,...ide->...ibe", qb, h_i)
    den = torch.einsum("...ibd,...id->...ib", qb, z_i)[..., None]
    o = (num / torch.clamp(den, min=_EPS)).reshape(*lead, n_q, d)
    return o.to(q.dtype), den.reshape(*lead, n_q, 1)


def combine_ref(o_s, o_l, den_l, alpha_tok):
    """O = alpha O_s + (1 - alpha) O_l, alpha forced to 1 where den == 0."""
    a = torch.where(den_l > _EPS, alpha_tok, 1.0)
    return (a * o_s.to(torch.float32)
            + (1.0 - a) * o_l.to(torch.float32)).to(o_s.dtype)


def manual_backward(q, k, v, idx, valid, o_s, lse, do_s, *, block_q: int,
                    block_k: int, causal: bool):
    """Paper Algorithm 3 for the sparse branch, in dense math.

    Always full precision (the QAT backward): P is recomputed from Q, K
    and the saved LSE; D = rowsum(dO . O) uses the forward output, so a
    quantised forward enters only through ``lse`` and ``o_s``.  Returns
    (dq, dk, dv) in the dtypes of q, k, v."""
    n_q, n_kv = q.shape[-2], k.shape[-2]
    d = q.shape[-1]
    mask_c = mask_from_indices(idx, valid, n_kv // block_k)
    m = masklib.expand_mask(mask_c, block_q, block_k)
    if causal:
        m = m * masklib.token_causal_mask(n_q, n_kv,
                                          device=q.device).to(m.dtype)
    sqrt_d = math.sqrt(d)
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    s = torch.einsum("...nd,...md->...nm", qf, kf) / sqrt_d
    p = torch.exp(s - lse[..., None]) * m    # empty rows: lse = -inf -> 0
    p = torch.where(torch.isfinite(p), p, 0.0)
    do = do_s.to(torch.float32)
    dv = torch.einsum("...nm,...nd->...md", p, do)
    dp = torch.einsum("...nd,...md->...nm", do, v.to(torch.float32))
    dd = torch.sum(do * o_s.to(torch.float32), dim=-1, keepdim=True)
    ds = p * (dp - dd)
    dq = torch.einsum("...nm,...md->...nd", ds, kf) / sqrt_d
    dk = torch.einsum("...nm,...nd->...md", ds, qf) / sqrt_d
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
