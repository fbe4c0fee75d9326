"""Paged-attention kernels of LM serving: SLA2 decode (and its multi-row
verify window), dense decode (and its verify window) and chunked-prefill
flash attention over the page pool.

The K/V cache lives in a pool of physical pages ``(P, Hkv, bk, Dh)``; a
host-side page table maps each slot's logical blocks to pages (page 0 is
a trash page for masked writes).  The kernels read pages where they lie.

``sla2_decode_verify`` (and ``sla2_decode_fused``, its W = 1 case) is the
SLA2 decode step over the pages the router selected: an online softmax
over the routed pages, the linear complement (``h_tot``/``z_tot`` minus
the selected complete blocks) from the same resident tiles, and the
sigmoid-alpha combine.  Optional QAT tiles (``quant_bits``) and low-bit
pools (``kv_quant``, codes with per-row f32 scales).  On a CUDA tensor it
launches ``sla2_decode`` in ``csrc/sla2_decode_paged.cu``; on a CPU tensor
it runs ``sla2_decode_verify_plain``, the PyTorch transcription of the
same loop.  ``sla2_decode_verify.launches`` counts kernel launches of
both entries.  Without QAT tiles the kernel cuts each row's routed
entries into splits across blocks (``decode_split_shape``: entries per
split from the grid's size) and a combine adds the partials: f32 scratch
from ``torch.empty``, (acc, lnum) and (m, l, lden, count) per row, split
and query head.  ``sla2_decode_split_plain`` is the plain version of that
arithmetic; with one split it is the unsplit loop, bit for bit.

``dense_decode_verify`` (and ``dense_decode_fused``, its W = 1 case) is
the decode step of stacks without a router (``mechanism="full"``): every
page a row can see, by its length, the sliding window and the prefix,
streams through one online softmax, with the same optional QAT tiles and
low-bit pools.  On a CUDA tensor it launches ``dense_decode`` from the
same source (counted in ``dense_decode_verify.launches``); on a CPU
tensor it runs ``dense_decode_verify_plain``.  Without QAT tiles the
kernel splits each (slot, KV head)'s pages across blocks and combines the
partials (``dense_split_shape``, ``dense_split_pages``);
``dense_decode_split_plain`` is the plain version of that arithmetic, for
the tests.

``paged_flash_prefill`` is exact causal flash attention of one slot's
prefill chunk over its paged history, the GQA group stacked into one
query tile per KV head, with sliding-window and prefix-LM masks.  On a
CUDA tensor it launches ``paged_prefill`` from ``csrc/paged_prefill.cu``
(counted in ``paged_flash_prefill.launches``); on a CPU tensor it runs
``paged_flash_prefill_plain``.

There is no fallback from one to the other.  The kernels take ``block_k``
a multiple of 16 up to 64, ``Dh`` 64 or 128, bf16 or f32 pools or int8 /
e4m3 codes (16-byte aligned), and up to 16 query heads per KV head;
anything else raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.attention import phi
from repro_torch.kernels.ops import INT8_MAX, NEG_INF, qdot, quantize_tile

QUANT_CODES = {"none": 0, "int8": 1, "fp8": 2}
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
_Q_DTYPES = (torch.float32, torch.bfloat16)
_KV_DTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
_HALF_NEG = NEG_INF * 0.5


def _check_pool(k_pages, v_pages, kv_quant, k_scale, v_scale):
    if kv_quant not in QUANT_CODES:
        raise ValueError(f"kv_quant must be one of {tuple(QUANT_CODES)}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages must be (P, Hkv, bk, Dh) of "
                         "one shape")
    if kv_quant == "none":
        if k_pages.dtype not in _Q_DTYPES or v_pages.dtype != k_pages.dtype:
            raise ValueError(f"an unquantised pool must be one dtype of "
                             f"{_Q_DTYPES}")
        return
    want = _KV_DTYPE[kv_quant]
    if k_pages.dtype != want or v_pages.dtype != want:
        raise ValueError(f"kv_quant={kv_quant!r} needs {want} pages")
    if k_scale is None or v_scale is None:
        raise ValueError(f"kv_quant={kv_quant!r} needs k_scale and v_scale")
    if (tuple(k_scale.shape) != tuple(k_pages.shape[:3])
            or k_scale.shape != v_scale.shape
            or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32):
        raise ValueError("k_scale/v_scale must be f32 (P, Hkv, bk)")


def _dequant(tile, scale):
    tile = tile.to(torch.float32)
    return tile if scale is None else tile * scale[..., None]


def _tree_sum(p):
    """Sum over the last axis (at most 64) in the kernel's order: keys kk
    and kk + 32 first, then a butterfly over the 32 lanes of a warp
    (halves of 16, 8, 4, 2, 1)."""
    n = p.shape[-1]
    if n < 64:
        p = torch.nn.functional.pad(p, (0, 64 - n))
    v = p[..., :32] + p[..., 32:]
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


# ---------------------------------------------------------------------------
# SLA2 paged decode / verify
# ---------------------------------------------------------------------------

def _decode_partials(qf32, qf, q_code, k_pages, v_pages, phys, jlog, valid,
                     complete, t, jjs, *, block_k, quant_bits, k_scale,
                     v_scale):
    """The kernel's loop over the routed entries ``jjs`` (ascending) of
    every row, from m = -1e30, l = 0, acc = lnum = lden = 0.  Returns
    (acc, m, l, lnum, lden, has): the online-softmax state, the linear
    correction of the complete entries, and whether a row had a valid
    entry."""
    b, hkv, wdw, n_rep, dh = qf32.shape
    dev = qf32.device
    sm_scale = 1.0 / (dh ** 0.5)
    h_ix = torch.arange(hkv, device=dev)[None, :, None]
    shape = (b, hkv, wdw, n_rep)
    acc = torch.zeros(*shape, dh, device=dev)
    lnum = torch.zeros(*shape, dh, device=dev)
    m_i = torch.full(shape, NEG_INF, device=dev)
    l_i = torch.zeros(shape, device=dev)
    lden = torch.zeros(shape, device=dev)
    has = torch.zeros(b, hkv, wdw, 1, dtype=torch.bool, device=dev)
    offs = torch.arange(block_k, device=dev)
    for jj in jjs:
        ph = phys[..., jj].long()                             # (B, Hkv, W)
        ok = (valid[..., jj] == 1)[..., None]
        has = has | ok
        k = _dequant(k_pages[ph, h_ix],
                     None if k_scale is None else k_scale[ph, h_ix])
        v = _dequant(v_pages[ph, h_ix],
                     None if v_scale is None else v_scale[ph, h_ix])
        if quant_bits == "none":
            s = torch.matmul(qf32, k.transpose(-1, -2)) * sm_scale
        else:
            k_c, k_s = quantize_tile(k, quant_bits)
            s = qdot(*q_code, k_c, k_s, transpose_b=True) * sm_scale
        cols = jlog[..., jj].long()[..., None] * block_k + offs
        s = torch.where((cols < t)[..., None, :], s, NEG_INF)
        m_new = torch.maximum(m_i, torch.amax(s, dim=-1))
        m_safe = torch.where(m_new > _HALF_NEG, m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(s > _HALF_NEG, p, 0.0)
        corr = torch.exp(torch.where(m_i > _HALF_NEG, m_i, m_safe) - m_safe)
        l_new = l_i * corr + _tree_sum(p)
        if quant_bits == "none":
            o_tmp = torch.matmul(p, v)
        elif quant_bits == "int8":
            p_c = torch.round(p * INT8_MAX)
            v_c, v_s = quantize_tile(v, "int8")
            o_tmp = qdot(p_c, 1.0 / INT8_MAX, v_c, v_s, transpose_b=False)
        else:
            p_c, p_s = quantize_tile(p, "fp8")
            v_c, v_s = quantize_tile(v, "fp8")
            o_tmp = qdot(p_c, p_s, v_c, v_s, transpose_b=False)
        acc = torch.where(ok[..., None], acc * corr[..., None] + o_tmp, acc)
        m_i = torch.where(ok, m_new, m_i)
        l_i = torch.where(ok, l_new, l_i)
        # linear-branch correction from the same tiles, f32 always
        sub = ok & (complete[..., jj] == 1)[..., None]
        ls = torch.matmul(qf, phi(k).transpose(-1, -2))       # (.., n_rep, bk)
        lnum = torch.where(sub[..., None], lnum + torch.matmul(ls, v), lnum)
        lden = torch.where(sub, lden + _tree_sum(ls), lden)
    return acc, m_i, l_i, lnum, lden, has


def sla2_decode_split_plain(q, k_pages, v_pages, phys, jlog, valid,
                            complete, t_new, h_tot, z_tot, alpha, *,
                            block_k: int, entries_per_split: int,
                            quant_bits: str = "none",
                            kv_quant: str = "none", k_scale=None,
                            v_scale=None):
    """Plain PyTorch version of the split decode kernel: each row's K_sel
    routed entries cut into splits of ``entries_per_split`` consecutive
    entries; each split runs the kernel's loop into partials (acc, m, l,
    lnum, lden); the combine skips splits without a valid entry, rescales
    the softmax partials (M = max m_s, w_s = exp(m_s' - M') with the corr
    guards, m > -5e29), sums acc_s w_s, l_s w_s, lnum_s and lden_s in
    ascending split order, and the finalize takes o_s = acc / max(l,
    1e-20), the linear complement from h_tot / z_tot minus (lnum, lden)
    and the sigmoid-alpha combine.  Shapes as ``sla2_decode_verify``;
    returns o (B, Hkv, W, n_rep, Dh) f32."""
    dh = q.shape[-1]
    k_sel = phys.shape[-1]
    eps = max(1, int(entries_per_split))
    qf32 = q.to(torch.float32)
    qf = phi(qf32)
    q_code = quantize_tile(qf32, quant_bits) if quant_bits != "none" else None
    t = t_new.to(torch.int64)[:, None, :, None]              # (B, 1, W, 1)
    parts = [_decode_partials(qf32, qf, q_code, k_pages, v_pages, phys, jlog,
                              valid, complete, t,
                              range(j0, min(j0 + eps, k_sel)),
                              block_k=block_k, quant_bits=quant_bits,
                              k_scale=k_scale, v_scale=v_scale)
             for j0 in range(0, k_sel, eps)]
    m_all = torch.stack([torch.where(has, m, NEG_INF)
                         for _, m, _, _, _, has in parts]).amax(dim=0)
    m_safe = torch.where(m_all > _HALF_NEG, m_all, 0.0)
    acc = torch.zeros_like(parts[0][0])
    lnum = torch.zeros_like(parts[0][3])
    l_i = torch.zeros_like(parts[0][2])
    lden = torch.zeros_like(parts[0][4])
    for acc_s, m_s, l_s, lnum_s, lden_s, has in parts:
        w = torch.exp(torch.where(m_s > _HALF_NEG, m_s, m_safe) - m_safe)
        acc = torch.where(has[..., None], acc + acc_s * w[..., None], acc)
        l_i = torch.where(has, l_i + l_s * w, l_i)
        lnum = torch.where(has[..., None], lnum + lnum_s, lnum)
        lden = torch.where(has, lden + lden_s, lden)
    l_safe = torch.clamp(l_i, min=1e-20)
    o_s = acc / l_safe[..., None]
    den_tot = (qf * z_tot[..., None, :]).sum(dim=-1)
    num = torch.matmul(qf, h_tot) - lnum
    den = den_tot - lden
    den = torch.where(den > 1e-4 * den_tot + 1e-12, den, 0.0)
    o_l = torch.where(den[..., None] > 0,
                      num / torch.clamp(den[..., None], min=1e-12), 0.0)
    a = torch.sigmoid(alpha.to(torch.float32))[:, :, None, :, None]
    a_eff = torch.where(den[..., None] > 0, a, 1.0)
    return a_eff * o_s + (1.0 - a_eff) * o_l


def sla2_decode_verify_plain(q, k_pages, v_pages, phys, jlog, valid,
                             complete, t_new, h_tot, z_tot, alpha, *,
                             block_k: int, quant_bits: str = "none",
                             kv_quant: str = "none", k_scale=None,
                             v_scale=None):
    """Plain PyTorch version of the decode kernel, vectorised over
    (B, Hkv, W): the same ascending loop over the K_sel routed entries.
    It is ``sla2_decode_split_plain`` with one split, whose combine is
    exact (w = exp(0) = 1).  Shapes as ``sla2_decode_verify``; returns o
    (B, Hkv, W, n_rep, Dh) f32."""
    return sla2_decode_split_plain(
        q, k_pages, v_pages, phys, jlog, valid, complete, t_new, h_tot,
        z_tot, alpha, block_k=block_k, entries_per_split=phys.shape[-1],
        quant_bits=quant_bits, kv_quant=kv_quant, k_scale=k_scale,
        v_scale=v_scale)


def sla2_decode_fused_plain(q, k_pages, v_pages, phys, jlog, valid,
                            complete, t_new, h_tot, z_tot, alpha, **kw):
    """``sla2_decode_verify_plain`` at W = 1 (shapes of
    ``sla2_decode_fused``)."""
    return sla2_decode_verify_plain(
        q[:, :, None], k_pages, v_pages, phys[:, :, None], jlog[:, :, None],
        valid[:, :, None], complete[:, :, None], t_new[:, None],
        h_tot[:, :, None], z_tot[:, :, None], alpha, **kw)[:, :, 0]


def _check_decode(q, k_pages, v_pages, phys, jlog, valid, complete, t_new,
                  h_tot, z_tot, alpha, block_k, quant_bits, kv_quant,
                  k_scale, v_scale):
    if quant_bits not in QUANT_CODES:
        raise ValueError(f"quant_bits must be one of {tuple(QUANT_CODES)}")
    _check_pool(k_pages, v_pages, kv_quant, k_scale, v_scale)
    if q.dim() != 5 or q.dtype not in _Q_DTYPES:
        raise ValueError("q must be (B, Hkv, W, n_rep, Dh) in f32 or bf16")
    b, hkv, wdw, n_rep, dh = q.shape
    if k_pages.shape[1] != hkv or k_pages.shape[2] != block_k \
            or k_pages.shape[3] != dh:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not fit q "
                         f"{tuple(q.shape)} and block_k {block_k}")
    lead = (b, hkv, wdw)
    for name, t in (("phys", phys), ("jlog", jlog), ("valid", valid),
                    ("complete", complete)):
        if t.dim() != 4 or tuple(t.shape[:3]) != lead \
                or t.shape != phys.shape or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 (B, Hkv, W, K_sel)")
    if tuple(t_new.shape) != (b, wdw) or t_new.dtype != torch.int32:
        raise ValueError("t_new must be int32 (B, W)")
    if tuple(h_tot.shape) != lead + (dh, dh) \
            or tuple(z_tot.shape) != lead + (dh,) \
            or tuple(alpha.shape) != (b, hkv, n_rep):
        raise ValueError("h_tot (B, Hkv, W, Dh, Dh), z_tot (B, Hkv, W, Dh) "
                         "and alpha (B, Hkv, n_rep) do not fit q")
    for t in (h_tot, z_tot, alpha):
        if t.dtype != torch.float32:
            raise ValueError("h_tot, z_tot and alpha must be f32")
    tensors = [q, k_pages, v_pages, phys, jlog, valid, complete, t_new,
               h_tot, z_tot, alpha] + [t for t in (k_scale, v_scale)
                                       if t is not None]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def sla2_decode_verify(q, k_pages, v_pages, phys, jlog, valid, complete,
                       t_new, h_tot, z_tot, alpha, *, block_k: int,
                       quant_bits: str = "none", kv_quant: str = "none",
                       k_scale=None, v_scale=None):
    """SLA2 paged decode over a window of W query rows per slot.

    q        (B, Hkv, W, n_rep, Dh) f32/bf16, queries grouped by KV head
    k_pages  (P, Hkv, bk, Dh) page pool (f32/bf16, or int8/e4m3 codes with
             k_scale/v_scale (P, Hkv, bk) f32 when ``kv_quant`` is set)
    phys     (B, Hkv, W, K_sel) int32 routed physical pages (0 = invalid)
    jlog     (B, Hkv, W, K_sel) int32 routed logical blocks (positions)
    valid    (B, Hkv, W, K_sel) int32 {0, 1}; invalid entries are skipped
    complete (B, Hkv, W, K_sel) int32 {0, 1}: the block is inside h_tot
    t_new    (B, W) int32 tokens visible to each row, its own included
    h_tot    (B, Hkv, W, Dh, Dh), z_tot (B, Hkv, W, Dh) f32 linear totals
    alpha    (B, Hkv, n_rep) f32 alpha logits
    returns  o (B, Hkv, W, n_rep, Dh) f32, the combined output."""
    _check_decode(q, k_pages, v_pages, phys, jlog, valid, complete, t_new,
                  h_tot, z_tot, alpha, block_k, quant_bits, kv_quant,
                  k_scale, v_scale)
    kw = dict(block_k=block_k, quant_bits=quant_bits, kv_quant=kv_quant,
              k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return sla2_decode_verify_plain(q, k_pages, v_pages, phys, jlog,
                                        valid, complete, t_new, h_tot,
                                        z_tot, alpha, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch_decode(q, k_pages, v_pages, phys, jlog, valid, complete,
                          t_new, h_tot, z_tot, alpha, **kw)


sla2_decode_verify.launches = 0


def sla2_decode_fused(q, k_pages, v_pages, phys, jlog, valid, complete,
                      t_new, h_tot, z_tot, alpha, **kw):
    """Single-token SLA2 paged decode: ``sla2_decode_verify`` at W = 1.
    q (B, Hkv, n_rep, Dh); phys/jlog/valid/complete (B, Hkv, K_sel);
    t_new (B,); h_tot (B, Hkv, Dh, Dh); z_tot (B, Hkv, Dh); alpha
    (B, Hkv, n_rep).  Returns o (B, Hkv, n_rep, Dh) f32."""
    return sla2_decode_verify(
        q[:, :, None], k_pages, v_pages, phys[:, :, None], jlog[:, :, None],
        valid[:, :, None], complete[:, :, None], t_new[:, None].contiguous(),
        h_tot[:, :, None], z_tot[:, :, None], alpha, **kw)[:, :, 0]


def _kernel_shape_check(name, dh, block_k, n_rep):
    if not (dh in (64, 128) and block_k % 16 == 0 and 16 <= block_k <= 64
            and 1 <= n_rep <= 16):
        raise ValueError(
            f"{name} kernel takes Dh in (64, 128), block_k a multiple of 16 "
            f"up to 64 and n_rep <= 16; got Dh={dh}, block_k={block_k}, "
            f"n_rep={n_rep}")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _check_aligned(name, *tensors):
    """The kernels copy pages (and sla2_decode's combine h_tot) with
    16-byte cp.async."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs 16-byte aligned pools")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# The split kernels' grid size and the split dense kernel's limits
# (csrc/sla2_decode_paged.cu).
SPLIT_ROWS, PPS_MIN, PPS_MAX = 64, 2, 64
SPLIT_PER_SM = 8                # blocks per SM the grid aims at
SPLIT_MAX = 128                 # splits the grid size asks for, at most


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# The split SLA2 decode's limits.  At one entry a split the combine reads
# a partial per routed entry; two a split halve that for fewer blocks and
# measured fastest at qwen3-14b's 4 slots, W 1 and 4 (device time of both
# kernels 0.0412 ms against 0.0456 at one entry, W 1; 0.1175 against
# 0.1229, W 4; tools/fwd_decode_variants.py on an H100).
EPS_MIN = 2                     # routed entries of a split, at least
EPS_MAX = 64                    # routed entries of a split, at most


def decode_split_shape(b, hkv, k_sel, n_sm):
    """(entries_per_split, n_split) of the split SLA2 decode kernel on a
    card of ``n_sm`` SMs: enough splits of each (slot x KV head, window
    row)'s K_sel routed entries for about SPLIT_PER_SM blocks per SM at one
    window row (at most SPLIT_MAX and K_sel), a split holding at least
    EPS_MIN entries (or K_sel, if fewer), at most EPS_MAX, and none
    empty.  The window width does not enter: a
    row's arithmetic depends on its splits, and a verify pass must compute
    each row as the decode step does, bit for bit (greedy speculative
    tokens are held to the plain decode's)."""
    want = min(-(-SPLIT_PER_SM * n_sm // (b * hkv)), SPLIT_MAX, k_sel)
    eps = min(EPS_MAX, max(EPS_MIN, -(-k_sel // max(1, want))),
              max(1, k_sel))
    return eps, -(-k_sel // eps)


def _launch_decode(q, k_pages, v_pages, phys, jlog, valid, complete, t_new,
                   h_tot, z_tot, alpha, *, block_k, quant_bits, kv_quant,
                   k_scale, v_scale):
    from repro_torch.kernels.build import load_library
    b, hkv, wdw, n_rep, dh = q.shape
    k_sel = phys.shape[-1]
    _kernel_shape_check("sla2_decode", dh, block_k, n_rep)
    args = [t.contiguous() for t in (q, phys, jlog, valid, complete, t_new,
                                     h_tot, z_tot, alpha)]
    for t in (k_pages, v_pages, k_scale, v_scale):
        if t is not None and not t.is_contiguous():
            raise ValueError("sla2_decode kernel needs contiguous pools")
    q, phys, jlog, valid, complete, t_new, h_tot, z_tot, alpha = args
    o = torch.empty(b, hkv, wdw, n_rep, dh, device=q.device,
                    dtype=torch.float32)
    eps, n_split = decode_split_shape(b, hkv, k_sel, sm_count(q.device))
    part_o = part_s = None
    if quant_bits == "none":                   # the split kernel's partials
        _check_aligned("sla2_decode", k_pages, v_pages, k_scale, v_scale,
                       h_tot)
        rows = b * hkv * wdw * n_split
        part_o = torch.empty(rows * 2 * n_rep * dh, device=q.device,
                             dtype=torch.float32)
        part_s = torch.empty(rows * (3 * n_rep + 1), device=q.device,
                             dtype=torch.float32)
    fn = load_library("sla2_decode_paged").sla2_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 13
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 _ptr(k_scale), _ptr(v_scale), phys.data_ptr(),
                 jlog.data_ptr(), valid.data_ptr(), complete.data_ptr(),
                 t_new.data_ptr(), h_tot.data_ptr(), z_tot.data_ptr(),
                 alpha.data_ptr(), o.data_ptr(), _ptr(part_o), _ptr(part_s),
                 b, wdw, hkv, n_rep, dh, block_k, k_sel,
                 QUANT_CODES[quant_bits], int(q.dtype == torch.bfloat16),
                 _POOL_CODES[k_pages.dtype], k_pages.shape[0], n_split, eps,
                 1.0 / (dh ** 0.5), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"sla2_decode kernel launch failed: CUDA error "
                           f"{err}")
    sla2_decode_verify.launches += 1
    return o


# ---------------------------------------------------------------------------
# Dense paged decode / verify
# ---------------------------------------------------------------------------

def _dense_visible(p, t, block_k, window, prefix_len):
    """Rows (of ``t``, their lengths) that see any position of logical page
    ``p``: below the length and, with a window, not wholly below the window
    start unless inside the prefix."""
    vis = p * block_k < t
    if window is not None:
        w_ok = (p + 1) * block_k > t - window
        if prefix_len:
            w_ok = w_ok | (p * block_k < prefix_len)
        vis = vis & w_ok
    return vis


def dense_decode_verify_plain(q, k_pages, v_pages, page_table, t_new, *,
                              block_k: int, window=None, prefix_len: int = 0,
                              quant_bits: str = "none",
                              kv_quant: str = "none", k_scale=None,
                              v_scale=None):
    """Plain PyTorch version of the dense decode kernel, vectorised over
    (B, Hkv, W): the same ascending online softmax over the logical pages,
    each row updated only on the pages it can see.  Shapes as
    ``dense_decode_verify``; returns o (B, Hkv, W, n_rep, Dh) f32."""
    b, hkv, wdw, n_rep, dh = q.shape
    dev = q.device
    sm_scale = 1.0 / (dh ** 0.5)
    qf32 = q.to(torch.float32)
    if quant_bits != "none":
        q_c, q_s = quantize_tile(qf32, quant_bits)
    t = t_new.to(torch.int64)[:, None, :, None]              # (B, 1, W, 1)
    shape = (b, hkv, wdw, n_rep)
    acc = torch.zeros(*shape, dh, device=dev)
    m_i = torch.full(shape, NEG_INF, device=dev)
    l_i = torch.zeros(shape, device=dev)
    offs = torch.arange(block_k, device=dev)
    n_pages = min(page_table.shape[1],
                  -(-int(t_new.max()) // block_k) if t_new.numel() else 0)
    for p in range(n_pages):
        ok = _dense_visible(p, t, block_k, window, prefix_len)  # (B,1,W,1)
        if not bool(ok.any()):
            continue
        ph = page_table[:, p].long()
        k = _dequant(k_pages[ph], None if k_scale is None else k_scale[ph])
        v = _dequant(v_pages[ph], None if v_scale is None else v_scale[ph])
        k, v = k[:, :, None], v[:, :, None]                 # (B,Hkv,1,bk,Dh)
        if quant_bits == "none":
            s = torch.matmul(qf32, k.transpose(-1, -2)) * sm_scale
        else:
            k_c, k_s = quantize_tile(k, quant_bits)
            s = qdot(q_c, q_s, k_c, k_s, transpose_b=True) * sm_scale
        cols = p * block_k + offs
        vis = cols < t
        if window is not None:
            vis = vis & ((cols >= t - window) | (cols < prefix_len))
        s = torch.where(vis[..., None, :], s, NEG_INF)
        m_new = torch.maximum(m_i, torch.amax(s, dim=-1))
        m_safe = torch.where(m_new > _HALF_NEG, m_new, 0.0)
        pr = torch.exp(s - m_safe[..., None])
        pr = torch.where(s > _HALF_NEG, pr, 0.0)
        corr = torch.exp(torch.where(m_i > _HALF_NEG, m_i, m_safe) - m_safe)
        l_new = l_i * corr + _tree_sum(pr)
        if quant_bits == "none":
            o_tmp = torch.matmul(pr, v)
        elif quant_bits == "int8":
            p_c = torch.round(pr * INT8_MAX)
            v_c, v_s = quantize_tile(v, "int8")
            o_tmp = qdot(p_c, 1.0 / INT8_MAX, v_c, v_s, transpose_b=False)
        else:
            p_c, p_s = quantize_tile(pr, "fp8")
            v_c, v_s = quantize_tile(v, "fp8")
            o_tmp = qdot(p_c, p_s, v_c, v_s, transpose_b=False)
        acc = torch.where(ok[..., None], acc * corr[..., None] + o_tmp, acc)
        m_i = torch.where(ok, m_new, m_i)
        l_i = torch.where(ok, l_new, l_i)
    return acc / torch.clamp(l_i, min=1e-20)[..., None]


def dense_decode_fused_plain(q, k_pages, v_pages, page_table, t_new, **kw):
    """``dense_decode_verify_plain`` at W = 1 (shapes of
    ``dense_decode_fused``)."""
    return dense_decode_verify_plain(q[:, :, None], k_pages, v_pages,
                                     page_table, t_new[:, None],
                                     **kw)[:, :, 0]


def dense_decode_verify(q, k_pages, v_pages, page_table, t_new, *,
                        block_k: int, window=None, prefix_len: int = 0,
                        quant_bits: str = "none", kv_quant: str = "none",
                        k_scale=None, v_scale=None):
    """Dense paged decode over a window of W query rows per slot: every
    page a row can see streams through one online softmax.

    q          (B, Hkv, W, n_rep, Dh) f32/bf16, queries grouped by KV head
    k_pages    (P, Hkv, bk, Dh) page pool (f32/bf16, or int8/e4m3 codes
               with k_scale/v_scale (P, Hkv, bk) f32 under ``kv_quant``)
    page_table (B, maxP) int32, logical block -> physical page per slot
    t_new      (B, W) int32 tokens visible to each row, its own included:
               the position mask cols < t_new is also the causal mask
               inside the window
    window     sliding-window size (cols >= t_new - window) or None;
               prefix_len prefix-LM tokens kept visible through the window
    returns    o (B, Hkv, W, n_rep, Dh) f32."""
    if quant_bits not in QUANT_CODES:
        raise ValueError(f"quant_bits must be one of {tuple(QUANT_CODES)}")
    _check_pool(k_pages, v_pages, kv_quant, k_scale, v_scale)
    if q.dim() != 5 or q.dtype not in _Q_DTYPES:
        raise ValueError("q must be (B, Hkv, W, n_rep, Dh) in f32 or bf16")
    b, hkv, wdw, n_rep, dh = q.shape
    if k_pages.shape[1] != hkv or k_pages.shape[2] != block_k \
            or k_pages.shape[3] != dh:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not fit q "
                         f"{tuple(q.shape)} and block_k {block_k}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.dtype != torch.int32:
        raise ValueError("page_table must be int32 (B, maxP)")
    if tuple(t_new.shape) != (b, wdw) or t_new.dtype != torch.int32:
        raise ValueError("t_new must be int32 (B, W)")
    tensors = [q, k_pages, v_pages, page_table, t_new] + [
        t for t in (k_scale, v_scale) if t is not None]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")
    kw = dict(block_k=block_k, window=window, prefix_len=int(prefix_len),
              quant_bits=quant_bits, kv_quant=kv_quant, k_scale=k_scale,
              v_scale=v_scale)
    if q.device.type == "cpu":
        return dense_decode_verify_plain(q, k_pages, v_pages, page_table,
                                         t_new, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch_dense(q, k_pages, v_pages, page_table, t_new, **kw)


dense_decode_verify.launches = 0


def dense_decode_fused(q, k_pages, v_pages, page_table, t_new, **kw):
    """Single-token dense paged decode: ``dense_decode_verify`` at W = 1.
    q (B, Hkv, n_rep, Dh); t_new (B,) int32.  Returns o (B, Hkv, n_rep,
    Dh) f32."""
    return dense_decode_verify(q[:, :, None], k_pages, v_pages, page_table,
                               t_new[:, None].contiguous(), **kw)[:, :, 0]


def dense_split_shape(b, hkv, wdw, n_rep, max_p, n_sm):
    """(wg, n_split) of the split dense kernel on a card of ``n_sm`` SMs:
    wg window rows per block (wg * n_rep <= 64), and n_split splits per
    (slot x KV head, row group) for about SPLIT_PER_SM blocks per SM in all
    (at most SPLIT_MAX, and max_p / 2) but at least max_p / 64 (a split
    holds at most 64 pages)."""
    wg = min(wdw, max(1, SPLIT_ROWS // n_rep))
    nz = -(-wdw // wg)
    want = min(-(-SPLIT_PER_SM * n_sm // (b * hkv * nz)),
               -(-max_p // PPS_MIN), SPLIT_MAX)
    return wg, max(1, -(-max_p // PPS_MAX), want)


def _visible_union(ts, block_k, max_p, window, prefix_len):
    """(n_pref, lo2, n_vis): the pages rows of lengths ``ts`` see, as the
    split kernel lists them, ascending: [0, n_pref), then [lo2, lo2 + n_vis
    - n_pref)."""
    hi = min(max_p, -(-max(ts) // block_k))
    n_pref = lo = 0
    if window is not None:
        lo = max(min(ts) - window, 0) // block_k
        n_pref = min(hi, -(-prefix_len // block_k))
    lo2 = max(lo, n_pref)
    return n_pref, lo2, n_pref + max(0, hi - lo2)


def dense_split_pages(t_new, block_k, max_p, n_split, window=None,
                      prefix_len=0):
    """pages_per_split the split kernel takes for each slot of ``t_new``
    (B, W) (its W rows in one group): max(2, ceil(visible / n_split))."""
    return [max(PPS_MIN, -(-_visible_union(ts, block_k, max_p, window,
                                           prefix_len)[2] // n_split))
            for ts in t_new.tolist()]


def dense_decode_split_plain(q, k_pages, v_pages, page_table, t_new, *,
                             block_k: int, pages_per_split, window=None,
                             prefix_len: int = 0, kv_quant: str = "none",
                             k_scale=None, v_scale=None):
    """Plain PyTorch version of the split dense kernel (f32 tiles, for the
    tests): each slot's visible pages (the union over its W rows) are cut
    into splits of ``pages_per_split`` consecutive pages (an int, or one
    per slot); each split runs the online softmax of
    ``dense_decode_verify_plain`` from m = -1e30, l = 0, acc = 0, each row
    masked by its own length; then the combine over the splits: M = max
    m_s, w_s = exp(m_s' - M') with the corr guards (m > -5e29), o = sum
    acc_s w_s / max(sum l_s w_s, 1e-20).  Returns o (B, Hkv, W,
    n_rep, Dh) f32."""
    b, hkv, wdw, n_rep, dh = q.shape
    dev = q.device
    sm_scale = 1.0 / (dh ** 0.5)
    qf32 = q.to(torch.float32)
    max_p, n_pool = page_table.shape[1], k_pages.shape[0]
    pps = ([pages_per_split] * b if isinstance(pages_per_split, int)
           else list(pages_per_split))
    offs = torch.arange(block_k, device=dev)
    out = torch.zeros(b, hkv, wdw, n_rep, dh, device=dev)
    for s in range(b):
        n_pref, lo2, n_vis = _visible_union(t_new[s].tolist(), block_k,
                                            max_p, window, prefix_len)
        pages = [i if i < n_pref else lo2 + i - n_pref for i in range(n_vis)]
        t = t_new[s].to(torch.int64)[None, :, None, None]   # (1, W, 1, 1)
        parts = []
        for start in range(0, n_vis, pps[s]):
            shape = (hkv, wdw, n_rep)
            acc = torch.zeros(*shape, dh, device=dev)
            m_i = torch.full(shape, NEG_INF, device=dev)
            l_i = torch.zeros(shape, device=dev)
            for p in pages[start:start + pps[s]]:
                ph = int(page_table[s, p])
                if not 0 <= ph < n_pool:
                    continue                    # unmapped: the kernel skips
                k = _dequant(k_pages[ph], None if k_scale is None
                             else k_scale[ph])[:, None]     # (Hkv,1,bk,Dh)
                v = _dequant(v_pages[ph], None if v_scale is None
                             else v_scale[ph])[:, None]
                sc = torch.matmul(qf32[s], k.transpose(-1, -2)) * sm_scale
                cols = p * block_k + offs
                vis = cols < t
                if window is not None:
                    vis = vis & ((cols >= t - window) | (cols < prefix_len))
                sc = torch.where(vis, sc, NEG_INF)
                m_new = torch.maximum(m_i, torch.amax(sc, dim=-1))
                m_safe = torch.where(m_new > _HALF_NEG, m_new, 0.0)
                pr = torch.exp(sc - m_safe[..., None])
                pr = torch.where(sc > _HALF_NEG, pr, 0.0)
                corr = torch.exp(torch.where(m_i > _HALF_NEG, m_i, m_safe)
                                 - m_safe)
                l_i = l_i * corr + _tree_sum(pr)
                acc = acc * corr[..., None] + torch.matmul(pr, v)
                m_i = m_new
            parts.append((acc, m_i, l_i))
        if not parts:
            continue                            # a slot that sees nothing
        m_all = torch.stack([m for _, m, _ in parts]).amax(dim=0)
        m_safe = torch.where(m_all > _HALF_NEG, m_all, 0.0)
        num = torch.zeros_like(parts[0][0])
        den = torch.zeros_like(parts[0][2])
        for acc, m_s, l_s in parts:
            w = torch.exp(torch.where(m_s > _HALF_NEG, m_s, m_safe) - m_safe)
            den = den + l_s * w
            num = num + acc * w[..., None]
        out[s] = num / torch.clamp(den, min=1e-20)[..., None]
    return out


def _launch_dense(q, k_pages, v_pages, page_table, t_new, *, block_k,
                  window, prefix_len, quant_bits, kv_quant, k_scale,
                  v_scale):
    from repro_torch.kernels.build import load_library
    b, hkv, wdw, n_rep, dh = q.shape
    _kernel_shape_check("dense_decode", dh, block_k, n_rep)
    q, page_table, t_new = (t.contiguous() for t in (q, page_table, t_new))
    for t in (k_pages, v_pages, k_scale, v_scale):
        if t is not None and not t.is_contiguous():
            raise ValueError("dense_decode kernel needs contiguous pools")
    _check_aligned("dense_decode", k_pages, v_pages, k_scale, v_scale)
    o = torch.empty(b, hkv, wdw, n_rep, dh, device=q.device,
                    dtype=torch.float32)
    wg, n_split = dense_split_shape(b, hkv, wdw, n_rep, page_table.shape[1],
                                    sm_count(q.device))
    part_acc = part_ml = None
    if quant_bits == "none":                   # the split kernel's partials
        rows = b * hkv * wdw * n_rep * n_split
        part_acc = torch.empty(rows * dh, device=q.device,
                               dtype=torch.float32)
        part_ml = torch.empty(rows * 2, device=q.device, dtype=torch.float32)
    fn = load_library("sla2_decode_paged").dense_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 15
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 _ptr(k_scale), _ptr(v_scale), page_table.data_ptr(),
                 t_new.data_ptr(), o.data_ptr(), _ptr(part_acc),
                 _ptr(part_ml), b, wdw, hkv, n_rep, dh, block_k,
                 page_table.shape[1],
                 -1 if window is None else int(window), prefix_len,
                 QUANT_CODES[quant_bits], int(q.dtype == torch.bfloat16),
                 _POOL_CODES[k_pages.dtype], k_pages.shape[0], n_split, wg,
                 1.0 / (dh ** 0.5), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"dense_decode kernel launch failed: CUDA error "
                           f"{err}")
    dense_decode_verify.launches += 1
    return o


# ---------------------------------------------------------------------------
# Paged chunked-prefill flash attention
# ---------------------------------------------------------------------------

def visible_pages(offset: int, chunk: int, max_p: int, block_k: int,
                  window=None, prefix_len: int = 0) -> list:
    """Logical pages any query of the chunk at [offset, offset + chunk) can
    see: below the chunk's end, and with a sliding window not wholly below
    the first query's window start unless the prefix keeps them live."""
    out = []
    for p in range(max_p):
        if p * block_k >= offset + chunk:
            break
        if (window is not None and (p + 1) * block_k <= offset - window + 1
                and not p * block_k < prefix_len):
            continue
        out.append(p)
    return out


def paged_flash_prefill_plain(q, k_pages, v_pages, page_row, *, offset: int,
                              block_k: int, n_rep: int, window=None,
                              prefix_len: int = 0, kv_quant: str = "none",
                              k_scale=None, v_scale=None):
    """Plain PyTorch version of the prefill kernel: the GQA group stacked
    into one (n_rep * C, Dh) query tile per KV head, an ascending online
    softmax over the visible pages.  Returns o (H, C, Dh) f32."""
    h, c, dh = q.shape
    hkv = h // n_rep
    dev = q.device
    sm_scale = 1.0 / (dh ** 0.5)
    qg = q.to(torch.float32).reshape(hkv, n_rep * c, dh)
    rows = (offset + torch.arange(n_rep * c, device=dev) % c)[:, None]
    acc = torch.zeros(hkv, n_rep * c, dh, device=dev)
    m_i = torch.full((hkv, n_rep * c), NEG_INF, device=dev)
    l_i = torch.zeros(hkv, n_rep * c, device=dev)
    offs = torch.arange(block_k, device=dev)
    for p in visible_pages(offset, c, page_row.shape[0], block_k, window,
                           prefix_len):
        ph = page_row[p:p + 1].long()
        k = _dequant(k_pages[ph][0],
                     None if k_scale is None else k_scale[ph][0])
        v = _dequant(v_pages[ph][0],
                     None if v_scale is None else v_scale[ph][0])
        s = torch.matmul(qg, k.transpose(-1, -2)) * sm_scale
        cols = (p * block_k + offs)[None, :]
        vis = rows >= cols
        if window is not None:
            vis = vis & (cols >= rows - window + 1)
        if prefix_len:
            vis = vis | (cols < prefix_len)
        s = torch.where(vis, s, NEG_INF)
        m_new = torch.maximum(m_i, torch.amax(s, dim=-1))
        m_safe = torch.where(m_new > _HALF_NEG, m_new, 0.0)
        pr = torch.exp(s - m_safe[..., None])
        pr = torch.where(s > _HALF_NEG, pr, 0.0)
        corr = torch.exp(torch.where(m_i > _HALF_NEG, m_i, m_safe) - m_safe)
        l_i = l_i * corr + pr.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(pr, v)
        m_i = m_new
    l_safe = torch.clamp(l_i, min=1e-20)
    return (acc / l_safe[..., None]).reshape(h, c, dh)


def paged_flash_prefill(q, k_pages, v_pages, page_row, *, offset,
                        block_k: int, n_rep: int, window=None,
                        prefix_len: int = 0, kv_quant: str = "none",
                        k_scale=None, v_scale=None):
    """Causal flash attention of one slot's prefill chunk over its paged
    history.

    q        (H, C, Dh) f32/bf16, the chunk's queries (all query heads)
    k_pages  (P, Hkv, bk, Dh) page pool, Hkv = H // n_rep (codes with
             per-row scales under ``kv_quant``)
    page_row (maxP,) int32, the slot's page-table row
    offset   tokens of the slot already cached (a multiple of block_k);
             the chunk's queries sit at [offset, offset + C)
    window   sliding-window size or None; prefix_len prefix-LM tokens
    returns  o (H, C, Dh) f32.  Rows past the chunk's valid tokens see
             whatever the slot's pages hold; callers discard them."""
    offset = int(offset)
    _check_pool(k_pages, v_pages, kv_quant, k_scale, v_scale)
    if q.dim() != 3 or q.dtype not in _Q_DTYPES:
        raise ValueError("q must be (H, C, Dh) in f32 or bf16")
    h, c, dh = q.shape
    if h % n_rep or k_pages.shape[1] != h // n_rep \
            or k_pages.shape[2] != block_k or k_pages.shape[3] != dh:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}, n_rep {n_rep}, block_k "
                         f"{block_k}")
    if page_row.dim() != 1 or page_row.dtype != torch.int32:
        raise ValueError("page_row must be int32 (maxP,)")
    if offset % block_k:
        raise ValueError(f"offset {offset} is not a multiple of block_k "
                         f"{block_k}")
    devs = {t.device for t in (q, k_pages, v_pages, page_row)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")
    kw = dict(offset=offset, block_k=block_k, n_rep=n_rep, window=window,
              prefix_len=prefix_len, kv_quant=kv_quant, k_scale=k_scale,
              v_scale=v_scale)
    if q.device.type == "cpu":
        return paged_flash_prefill_plain(q, k_pages, v_pages, page_row, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch_prefill(q, k_pages, v_pages, page_row, **kw)


paged_flash_prefill.launches = 0


def _launch_prefill(q, k_pages, v_pages, page_row, *, offset, block_k, n_rep,
                    window, prefix_len, kv_quant, k_scale, v_scale):
    from repro_torch.kernels.build import load_library
    h, c, dh = q.shape
    _kernel_shape_check("paged_prefill", dh, block_k, n_rep)
    q, page_row = q.contiguous(), page_row.contiguous()
    for t in (k_pages, v_pages, k_scale, v_scale):
        if t is not None and not t.is_contiguous():
            raise ValueError("paged_prefill kernel needs contiguous pools")
    _check_aligned("paged_prefill", k_pages, v_pages, k_scale, v_scale)
    o = torch.empty(h, c, dh, device=q.device, dtype=torch.float32)
    fn = load_library("paged_prefill").paged_prefill
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 _ptr(k_scale), _ptr(v_scale), page_row.data_ptr(),
                 o.data_ptr(), h, c, n_rep, dh, block_k, page_row.shape[0],
                 offset, -1 if window is None else int(window),
                 int(prefix_len), int(q.dtype == torch.bfloat16),
                 _POOL_CODES[k_pages.dtype], k_pages.shape[0],
                 k_pages.shape[1], 1.0 / (dh ** 0.5), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"paged_prefill kernel launch failed: CUDA error "
                           f"{err}")
    paged_flash_prefill.launches += 1
    return o
