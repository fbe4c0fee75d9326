"""Gather-based block-sparse SLA2: the plain-PyTorch execution path.

Per query block, gather the K_sel routed K/V tiles, so compute and memory
are O(k% * N^2) with no dense score matrix.  The linear branch uses the
complement trick: a (prefix-)total of the per-block linear states minus
the routed blocks' share, O(k%) subtractions instead of O(1-k%) additions.

Memory is bounded by chunking the query-block axis (``q_chunk`` query
blocks at a time), so the transient score tensor is
(BH, q_chunk, b_q, K_sel*b_k) whatever N is.  The single-pass variant
(``fuse_branches``) gathers each routed K/V tile once for both branches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.attention import phi
from repro_torch.core.quant import fake_quant, smooth_k

_EPS = 1e-12
NEG_INF = -1e30


def _gather_tiles(blocks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """blocks (BH, T, b, d), idx (BH, C, K) -> (BH, C, K, b, d)."""
    bh, c, k = idx.shape
    rows = torch.arange(bh, device=idx.device)[:, None]
    return blocks[rows, idx.reshape(bh, c * k).long()].reshape(
        bh, c, k, *blocks.shape[2:])


def _chunks(t_m: int, q_chunk: int):
    q_chunk = max(1, min(q_chunk, t_m))
    for i0 in range(0, t_m, q_chunk):
        yield i0, min(i0 + q_chunk, t_m)


def linear_branch(q, k, v, idx, valid, *, block_q: int, block_k: int,
                  causal: bool, prefix_len: int = 0, q_chunk: int = 16):
    """O_l over the complement of the routed blocks; (BH, N, d) inputs.

    Returns (o_l, den), den the row normaliser (0 => empty complement).
    For query block i the complement state is
        causal:     H_i = Hpre[n_full(i)] - sum_{sel, j < n_full(i)} h_j
        non-causal: H_i = H_total        - sum_{sel} h_j
    and the routed blocks' share is taken from the gathered tiles as an
    attention-like contraction, never as per-block (d x d) states."""
    bh, n_q, d = q.shape
    n_kv, d_v = k.shape[1], v.shape[-1]
    t_m, t_n = n_q // block_q, n_kv // block_k
    valid = valid.bool()

    qf = phi(q).reshape(bh, t_m, block_q, d)
    kf = phi(k)
    kfb = kf.reshape(bh, t_n, block_k, d)
    vf = v.to(torch.float32)
    vb = vf.reshape(bh, t_n, block_k, d_v)
    if causal:
        h = torch.einsum("bjkd,bjke->bjde", kfb, vb)
        hpre = torch.cumsum(h, dim=1)
        zpre = torch.cumsum(kfb.sum(dim=-2), dim=1)
        n_full = (torch.arange(t_m, device=q.device) * block_q + 1) // block_k
        if prefix_len:
            n_full = torch.clamp(n_full, min=prefix_len // block_k)
        sel_pre = torch.clamp(n_full - 1, min=0)
    else:
        h_tot = torch.einsum("bnd,bne->bde", kf, vf)     # (BH, d, d_v)
        z_tot = kf.sum(dim=1)                            # (BH, d)

    o_out = torch.empty(bh, t_m, block_q, d_v, device=q.device,
                        dtype=torch.float32)
    den_out = torch.empty(bh, t_m, block_q, 1, device=q.device,
                          dtype=torch.float32)
    for i0, i1 in _chunks(t_m, q_chunk):
        qc, idxc, validc = qf[:, i0:i1], idx[:, i0:i1], valid[:, i0:i1]
        if causal:
            nf, sp = n_full[i0:i1], sel_pre[i0:i1]
            hb = torch.where((nf > 0)[None, :, None, None], hpre[:, sp], 0.0)
            zb = torch.where((nf > 0)[None, :, None], zpre[:, sp], 0.0)
            in_lin = idxc < nf[None, :, None]
        else:
            hb = h_tot[:, None]
            zb = z_tot[:, None]
            in_lin = torch.ones_like(validc)
        w = (validc & in_lin).to(torch.float32)            # (BH, C, K)
        kg = _gather_tiles(kfb, idxc)
        vg = _gather_tiles(vb, idxc)
        ls = torch.einsum("bcqd,bcjkd->bcqjk", qc, kg)
        ls = ls * w[:, :, None, :, None]
        sub_num = torch.einsum("bcqjk,bcjke->bcqe", ls, vg)
        sub_den = ls.sum(dim=(-1, -2))
        den_tot = torch.einsum("bcqd,bcd->bcq", qc, zb.expand(
            -1, qc.shape[1], -1))
        num = torch.einsum("bcqd,bcde->bcqe", qc, hb.expand(
            -1, qc.shape[1], -1, -1)) - sub_num
        den = den_tot - sub_den
        # relative empty-complement test: with every block routed sparse,
        # den is a cancellation residual, not a clean zero
        den = torch.where(den > 1e-4 * den_tot + _EPS, den, 0.0)[..., None]
        o_out[:, i0:i1] = torch.where(
            den > 0, num / torch.clamp(den, min=_EPS), 0.0)
        den_out[:, i0:i1] = den
    return (o_out.reshape(bh, n_q, d_v).to(q.dtype),
            den_out.reshape(bh, n_q, 1))


def gather_sparse_attention(q, k, v, idx, valid, *, block_q: int,
                            block_k: int, causal: bool,
                            quant_bits: str = "none", prefix_len: int = 0,
                            q_chunk: int = 32):
    """Block-sparse softmax attention by gathering the routed K/V tiles.

    q (BH, N_q, d); k, v (BH, N_kv, d); idx/valid (BH, T_m, K_sel).
    Each query row softmaxes over exactly the gathered positions.  QAT
    mode quantises Q/K per tile, un-normalised P at a fixed 1/127 (int8)
    or per tile (fp8), and V per gathered tile."""
    bh, n_q, d = q.shape
    n_kv, d_v = k.shape[1], v.shape[-1]
    t_m, t_n = n_q // block_q, n_kv // block_k
    k_sel = idx.shape[-1]
    scale = 1.0 / math.sqrt(d)
    valid = valid.bool()

    if quant_bits != "none":
        k = smooth_k(k)
        q = fake_quant(q.reshape(bh, t_m, block_q, d), quant_bits,
                       (-2, -1)).reshape(bh, n_q, d)
        k = fake_quant(k.reshape(bh, t_n, block_k, d), quant_bits,
                       (-2, -1)).reshape(bh, n_kv, d)
    kb = k.reshape(bh, t_n, block_k, d)
    vb = v.reshape(bh, t_n, block_k, d_v)
    qb = q.reshape(bh, t_m, block_q, d)
    ar_k = torch.arange(block_k, device=q.device)
    ar_q = torch.arange(block_q, device=q.device)

    out = torch.empty(bh, t_m, block_q, d_v, device=q.device,
                      dtype=torch.float32)
    for i0, i1 in _chunks(t_m, q_chunk):
        qc, idxc, validc = qb[:, i0:i1], idx[:, i0:i1], valid[:, i0:i1]
        c = i1 - i0
        kg = _gather_tiles(kb, idxc)
        vg = _gather_tiles(vb, idxc)
        s = torch.einsum("bcqd,bcjkd->bcqjk", qc.to(torch.float32),
                         kg.to(torch.float32)) * scale
        kpos = idxc[..., None].long() * block_k + ar_k       # (BH,C,K,bk)
        mask = validc[..., None]
        if causal:
            qpos = ((i0 + torch.arange(c, device=q.device))[:, None]
                    * block_q + ar_q)                          # (C, bq)
            vis = qpos[None, :, :, None, None] >= kpos[:, :, None, :, :]
            if prefix_len:
                vis = vis | (kpos[:, :, None, :, :] < prefix_len)
            mask = mask[:, :, None] & vis
        else:
            mask = mask[:, :, None]
        s = torch.where(mask, s, NEG_INF)
        sf = s.reshape(bh, c, block_q, k_sel * block_k)
        m = torch.clamp(torch.amax(sf, dim=-1, keepdim=True), min=-1e20)
        p = torch.exp(sf - m)
        if quant_bits == "int8":
            p_q = torch.round(p * 127.0) / 127.0
            p = p + (p_q - p).detach()
        elif quant_bits == "fp8":
            p = fake_quant(p.reshape(bh, c, block_q, k_sel, block_k),
                           quant_bits, (-2, -1)).reshape(p.shape)
        if quant_bits != "none":
            vg = fake_quant(vg, quant_bits, (-2, -1))
        den = torch.clamp(p.sum(-1, keepdim=True), min=_EPS)
        out[:, i0:i1] = torch.einsum(
            "bcqjk,bcjke->bcqe",
            (p / den).reshape(bh, c, block_q, k_sel, block_k),
            vg.to(torch.float32))
    return out.reshape(bh, n_q, d_v).to(q.dtype)


def sla2_gather(alpha_tok, q, k, v, idx, valid, *, block_q: int,
                block_k: int, causal: bool, quant_bits: str = "none",
                prefix_len: int = 0, q_chunk: int = 32,
                fuse_branches: bool = False):
    """SLA2 Eq. 13 with the gather-based sparse branch.

    alpha_tok (BH, N, 1) in (0, 1); q/k/v (BH, N, d); idx/valid from
    ``router.route_indices``.  Alpha is forced to 1 where the linear
    complement is empty.  Two passes (each routed tile gathered by the
    sparse and again by the linear branch), or with ``fuse_branches`` one
    (``_sla2_gather_fused``)."""
    if fuse_branches:
        return _sla2_gather_fused(
            alpha_tok, q, k, v, idx, valid, block_q=block_q,
            block_k=block_k, causal=causal, quant_bits=quant_bits,
            prefix_len=prefix_len, q_chunk=q_chunk)
    o_s = gather_sparse_attention(
        q, k, v, idx, valid, block_q=block_q, block_k=block_k,
        causal=causal, quant_bits=quant_bits, prefix_len=prefix_len,
        q_chunk=q_chunk)
    o_l, den = linear_branch(
        q, k, v, idx, valid, block_q=block_q, block_k=block_k,
        causal=causal, prefix_len=prefix_len)
    a_eff = torch.where(den > _EPS, alpha_tok, 1.0)
    o = (a_eff * o_s.to(torch.float32)
         + (1.0 - a_eff) * o_l.to(torch.float32))
    return o.to(q.dtype)


def _sla2_gather_fused(alpha_tok, q, k, v, idx, valid, *, block_q: int,
                       block_k: int, causal: bool, quant_bits: str,
                       prefix_len: int, q_chunk: int):
    """Both branches in one chunked pass over the routed K/V tiles.

    With quantisation on, phi(K) of the linear branch's subtraction is
    taken over the gathered tiles as the sparse branch sees them (smoothed
    and fake-quantised): the reference's deliberate single-gather
    approximation, inside the QAT forward's noise."""
    bh, n_q, d = q.shape
    n_kv, d_v = k.shape[1], v.shape[-1]
    t_m, t_n = n_q // block_q, n_kv // block_k
    k_sel = idx.shape[-1]
    scale = 1.0 / math.sqrt(d)
    valid = valid.bool()

    # complement base states: one pass over K/V
    kfb_f = phi(k).reshape(bh, t_n, block_k, d)
    vb_f = v.to(torch.float32).reshape(bh, t_n, block_k, d_v)
    h = torch.einsum("bjkd,bjke->bjde", kfb_f, vb_f)
    z = kfb_f.sum(dim=-2)
    if causal:
        hpre, zpre = torch.cumsum(h, dim=1), torch.cumsum(z, dim=1)
        n_full = (torch.arange(t_m, device=q.device) * block_q + 1) // block_k
        if prefix_len:
            n_full = torch.clamp(n_full, min=prefix_len // block_k)
        sel_pre = torch.clamp(n_full - 1, min=0)
    else:
        h_tot, z_tot = h.sum(dim=1), z.sum(dim=1)

    q_s, k_s = q, k
    if quant_bits != "none":
        k_s = fake_quant(smooth_k(k).reshape(bh, t_n, block_k, d),
                         quant_bits, (-2, -1)).reshape(bh, n_kv, d)
        q_s = fake_quant(q.reshape(bh, t_m, block_q, d), quant_bits,
                         (-2, -1)).reshape(bh, n_q, d)
    kb = k_s.reshape(bh, t_n, block_k, d)
    vb = v.reshape(bh, t_n, block_k, d_v)
    qb = q_s.reshape(bh, t_m, block_q, d)
    qfb = phi(q).reshape(bh, t_m, block_q, d)
    ab = alpha_tok.reshape(bh, t_m, block_q, 1)
    ar_k = torch.arange(block_k, device=q.device)
    ar_q = torch.arange(block_q, device=q.device)

    out = torch.empty(bh, t_m, block_q, d_v, device=q.device,
                      dtype=torch.float32)
    for i0, i1 in _chunks(t_m, q_chunk):
        qc, qfc, ac = qb[:, i0:i1], qfb[:, i0:i1], ab[:, i0:i1]
        idxc, validc = idx[:, i0:i1], valid[:, i0:i1]
        c = i1 - i0
        kg = _gather_tiles(kb, idxc)
        vg = _gather_tiles(vb, idxc)
        # sparse branch
        s = torch.einsum("bcqd,bcjkd->bcqjk", qc.to(torch.float32),
                         kg.to(torch.float32)) * scale
        kpos = idxc[..., None].long() * block_k + ar_k
        mask = validc[..., None]
        if causal:
            qpos = ((i0 + torch.arange(c, device=q.device))[:, None]
                    * block_q + ar_q)
            vis = qpos[None, :, :, None, None] >= kpos[:, :, None, :, :]
            if prefix_len:
                vis = vis | (kpos[:, :, None, :, :] < prefix_len)
            mask = mask[:, :, None] & vis
        else:
            mask = mask[:, :, None]
        s = torch.where(mask, s, NEG_INF)
        sf = s.reshape(bh, c, block_q, k_sel * block_k)
        m = torch.clamp(torch.amax(sf, dim=-1, keepdim=True), min=-1e20)
        p = torch.exp(sf - m)
        if quant_bits == "int8":
            p_q = torch.round(p * 127.0) / 127.0
            p = p + (p_q - p).detach()
        elif quant_bits == "fp8":
            p = fake_quant(p.reshape(bh, c, block_q, k_sel, block_k),
                           quant_bits, (-2, -1)).reshape(p.shape)
        vq = (fake_quant(vg, quant_bits, (-2, -1)) if quant_bits != "none"
              else vg)
        den_s = torch.clamp(p.sum(-1, keepdim=True), min=_EPS)
        o_s = torch.einsum("bcqjk,bcjke->bcqe",
                           (p / den_s).reshape(bh, c, block_q, k_sel,
                                               block_k),
                           vq.to(torch.float32))
        # linear branch over the same tiles
        if causal:
            nf, sp = n_full[i0:i1], sel_pre[i0:i1]
            hb = torch.where((nf > 0)[None, :, None, None], hpre[:, sp], 0.0)
            zb = torch.where((nf > 0)[None, :, None], zpre[:, sp], 0.0)
            in_lin = idxc < nf[None, :, None]
        else:
            hb = h_tot[:, None].expand(-1, c, -1, -1)
            zb = z_tot[:, None].expand(-1, c, -1)
            in_lin = torch.ones_like(validc)
        w = (validc & in_lin).to(torch.float32)
        ls = torch.einsum("bcqd,bcjkd->bcqjk", qfc,
                          phi(kg.to(torch.float32)))
        ls = ls * w[:, :, None, :, None]
        sub_num = torch.einsum("bcqjk,bcjke->bcqe", ls,
                               vg.to(torch.float32))
        sub_den = ls.sum(dim=(-1, -2))
        den_tot = torch.einsum("bcqd,bcd->bcq", qfc, zb)
        num = torch.einsum("bcqd,bcde->bcqe", qfc, hb) - sub_num
        den = den_tot - sub_den
        den = torch.where(den > 1e-4 * den_tot + _EPS, den, 0.0)[..., None]
        o_l = torch.where(den > 0, num / torch.clamp(den, min=_EPS), 0.0)
        a_eff = torch.where(den > 0, ac.to(torch.float32), 1.0)
        out[:, i0:i1] = a_eff * o_s + (1.0 - a_eff) * o_l
    return out.reshape(bh, n_q, d_v).to(q.dtype)
