"""Backward of the SLA2 sparse branch (paper Algorithm 3).

``sparse_flash_bwd`` is the wrapper.  On CUDA tensors it launches the two
hand-written ``sm_90a`` kernels in ``csrc/sla2_bwd.cu``; on CPU tensors it
runs ``sparse_flash_bwd_plain``, the PyTorch transcription of the same
arithmetic.  There is no fallback from one to the other.

The backward is always full precision, even after an int8 forward: P is
recomputed from Q, the (smoothed) K the forward saw and the forward's LSE.
In f32 from the upcast tiles, for query block i and routed kv block j:

    s  = q k^T * sm_scale          NEG_INF where causal hides (rows >= cols,
                                   OR cols < prefix_len)
    p  = exp(s - lse_safe)         0 where s or lse is masked
    dp = dO v^T;  ds = p (dp - dd) sm_scale,  dd = rowsum(dO . O) in f32
    dQ_i += ds k_j                 (kernel ``sla2_bwd_dq``: one block per
                                   (bh, query rows), ascending over jj)
    dV_j += p^T dO_i;  dK_j += ds^T q_i
                                   (kernel ``sla2_bwd_dkv``: along the pairs
                                   sorted by j, ascending in i)

dQ is written in q's dtype; dK and dV accumulate in f32 and are cast to
q's dtype.  A kv block that no valid pair visits gets zeros.

bf16 operands run the tensor-core kernels, f32 operands the CUDA-core
ones.  On bf16 the dK/dV runs are cut into work items of at most
``DKV_ITEM`` pairs (``dkv_split_plan``, derived on the device from the run
offsets): a kv block that many query blocks route would otherwise hold one
block for its whole run while the rest of the card idles.  A run of one
item writes dK, dV; the items of a longer run write f32 partials that a
combine kernel adds in item order (``sparse_flash_dkv_split_plain``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ops import NEG_INF

_DTYPES = (torch.float32, torch.bfloat16)
DKV_ITEM = 32           # pairs of a dK/dV work item, at most (csrc/sla2_bwd.cu)


def sort_pairs(idx: torch.Tensor, valid: torch.Tensor):
    """Stable sort of the routed (i, jj) pairs by kv block id.

    idx, valid (BH, T_m, K_sel).  Returns (js, is_, vs), each (BH, P) int32
    with P = T_m * K_sel, ascending in j and, within one j, in i.  Invalid
    pairs keep their j (a real selected block of the same row) and are
    skipped by the kernels."""
    bh, t_m, k_sel = idx.shape
    p = t_m * k_sel
    js = idx.reshape(bh, p).to(torch.int32)
    is_ = torch.arange(t_m, dtype=torch.int32, device=idx.device)
    is_ = is_[:, None].expand(t_m, k_sel).reshape(1, p).expand(bh, p)
    vs = valid.reshape(bh, p).to(torch.int32)
    js_sorted, order = torch.sort(js, dim=-1, stable=True)
    return (js_sorted, torch.gather(is_, -1, order),
            torch.gather(vs, -1, order))


def segment_offsets(js: torch.Tensor, t_n: int) -> torch.Tensor:
    """(BH, T_n + 1) int32 start of each kv block's run in the sorted pair
    list ``js`` (BH, P): block j owns pairs [off[j], off[j + 1])."""
    bh = js.shape[0]
    counts = torch.zeros(bh, t_n, dtype=torch.int32, device=js.device)
    counts.scatter_add_(1, js.long(), torch.ones_like(js))
    off = torch.zeros(bh, t_n + 1, dtype=torch.int32, device=js.device)
    off[:, 1:] = torch.cumsum(counts, dim=1)
    return off


def _check(q, k, v, idx, valid, o, lse, do, block_q, block_k):
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError("q, k, v must be (BH, N, d) with k.shape == v.shape")
    bh, n_q, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("o and do must have q's shape")
    if tuple(lse.shape) != (bh, n_q):
        raise ValueError(f"lse must be {(bh, n_q)}, got {tuple(lse.shape)}")
    if n_q % block_q or k.shape[1] % block_k:
        raise ValueError("sequence lengths must be multiples of the blocks")
    want = (bh, n_q // block_q)
    if tuple(idx.shape[:2]) != want or idx.shape != valid.shape:
        raise ValueError(f"idx/valid must be {want + ('K_sel',)}, got "
                         f"{tuple(idx.shape)} / {tuple(valid.shape)}")
    if idx.dtype != torch.int32 or valid.dtype != torch.int32:
        raise ValueError("idx and valid must be int32")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v)):
        raise ValueError(f"q/k/v must share a dtype in {_DTYPES}")
    if lse.dtype != torch.float32:
        raise ValueError("lse must be float32")
    devs = {t.device for t in (q, k, v, idx, valid, o, lse, do)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def _probs(q_t, k_t, lse_t, rows, cols, *, sm_scale, causal, prefix_len):
    """p = exp(s - lse_safe) on f32 tiles, masked as the kernels mask it.
    q_t (..., bq, d), k_t (..., bk, d), lse_t (..., bq); rows (..., bq),
    cols (..., bk) absolute positions."""
    s = torch.matmul(q_t, k_t.transpose(-1, -2)) * sm_scale
    if causal:
        vis = rows[..., :, None] >= cols[..., None, :]
        if prefix_len:
            vis = vis | (cols[..., None, :] < prefix_len)
        s = torch.where(vis, s, NEG_INF)
    half_neg = NEG_INF * 0.5
    lse_ok = lse_t > half_neg
    lse_safe = torch.where(lse_ok, lse_t, 0.0)
    p = torch.exp(s - lse_safe[..., None])
    return torch.where((s > half_neg) & lse_ok[..., None], p, 0.0)


def _tiles(q, k, v, o, lse, do, block_q, block_k):
    """f32 tiles and per-row terms shared by the two plain versions."""
    bh, n_q, d = q.shape
    t_m, t_n = n_q // block_q, k.shape[1] // block_k
    f32 = torch.float32
    dd = torch.sum(do.to(f32) * o.to(f32), dim=-1)
    return (q.to(f32).reshape(bh, t_m, block_q, d),
            do.to(f32).reshape(bh, t_m, block_q, d),
            k.to(f32).reshape(bh, t_n, block_k, d),
            v.to(f32).reshape(bh, t_n, block_k, d),
            lse.reshape(bh, t_m, block_q), dd.reshape(bh, t_m, block_q))


def sparse_flash_dq_plain(q, k, v, idx, valid, o, lse, do, *, block_q: int,
                          block_k: int, causal: bool, prefix_len: int = 0):
    """Plain version of ``sla2_bwd_dq``: a loop over jj, vectorised over
    (BH, T_m); returns dq in q's dtype."""
    bh, n_q, d = q.shape
    t_m = n_q // block_q
    sm_scale = 1.0 / (d ** 0.5)
    dev = q.device
    qb, dob, kb, vb, lse_b, dd_b = _tiles(q, k, v, o, lse, do, block_q,
                                          block_k)
    rows = (torch.arange(t_m, device=dev)[:, None] * block_q
            + torch.arange(block_q, device=dev))               # (T_m, bq)
    ar_k = torch.arange(block_k, device=dev)
    bh_ix = torch.arange(bh, device=dev)[:, None]
    dq = torch.zeros(bh, t_m, block_q, d, device=dev, dtype=torch.float32)
    for jj in range(idx.shape[-1]):
        j = idx[..., jj].long()                                # (BH, T_m)
        ok = (valid[..., jj] == 1)[..., None, None]
        kt, vt = kb[bh_ix, j], vb[bh_ix, j]                    # (BH,T_m,bk,d)
        p = _probs(qb, kt, lse_b, rows, j[..., None] * block_k + ar_k,
                   sm_scale=sm_scale, causal=causal, prefix_len=prefix_len)
        dp = torch.matmul(dob, vt.transpose(-1, -2))
        ds = p * (dp - dd_b[..., None]) * sm_scale
        dq = torch.where(ok, dq + torch.matmul(ds, kt), dq)
    return dq.reshape(bh, n_q, d).to(q.dtype)


def sparse_flash_dkv_plain(q, k, v, idx, valid, o, lse, do, *, block_q: int,
                           block_k: int, causal: bool, prefix_len: int = 0):
    """Plain version of ``sla2_bwd_dkv``: a loop over query blocks i in
    ascending order (the kernel's order along each j), each adding its
    routed tiles with ``index_add_``.  The valid entries of one row never
    repeat a j, and invalid ones go to a discarded extra block.  Returns
    (dk, dv) in q's dtype."""
    bh, n_q, d = q.shape
    n_kv = k.shape[1]
    t_m, t_n = n_q // block_q, n_kv // block_k
    sm_scale = 1.0 / (d ** 0.5)
    dev = q.device
    qb, dob, kb, vb, lse_b, dd_b = _tiles(q, k, v, o, lse, do, block_q,
                                          block_k)
    ar_k = torch.arange(block_k, device=dev)
    bh_ix = torch.arange(bh, device=dev)[:, None]
    dk = torch.zeros(bh * (t_n + 1), block_k, d, device=dev,
                     dtype=torch.float32)
    dv = torch.zeros_like(dk)
    for i in range(t_m):
        j = idx[:, i].long()                                   # (BH, K_sel)
        kt, vt = kb[bh_ix, j], vb[bh_ix, j]                    # (BH,K,bk,d)
        q_i, do_i = qb[:, i, None], dob[:, i, None]            # (BH,1,bq,d)
        rows = i * block_q + torch.arange(block_q, device=dev)
        p = _probs(q_i, kt, lse_b[:, i, None], rows,
                   j[..., None] * block_k + ar_k, sm_scale=sm_scale,
                   causal=causal, prefix_len=prefix_len)       # (BH,K,bq,bk)
        dp = torch.matmul(do_i, vt.transpose(-1, -2))
        ds = p * (dp - dd_b[:, i, None, :, None]) * sm_scale
        dst = torch.where(valid[:, i] == 1, j, t_n)
        dst = (dst + bh_ix * (t_n + 1)).reshape(-1)
        dv.index_add_(0, dst, torch.matmul(p.transpose(-1, -2), do_i)
                      .reshape(-1, block_k, d))
        dk.index_add_(0, dst, torch.matmul(ds.transpose(-1, -2), q_i)
                      .reshape(-1, block_k, d))
    dk = dk.reshape(bh, t_n + 1, block_k, d)[:, :t_n].reshape(bh, n_kv, d)
    dv = dv.reshape(bh, t_n + 1, block_k, d)[:, :t_n].reshape(bh, n_kv, d)
    return dk.to(q.dtype), dv.to(q.dtype)


def dkv_split_bounds(bh: int, t_n: int, n_pairs: int,
                     item: int = DKV_ITEM):
    """(work items, partial slots) at most, for BH x T_n runs over n_pairs
    sorted pairs per head: each run is max(1, ceil(len / item)) items, and
    only runs longer than ``item`` take slots, fewer than 2 len / item."""
    return (bh * t_n + -(-bh * n_pairs // item),
            max(1, 2 * bh * n_pairs // item))


def dkv_split_plan(off, n_items: int, item: int = DKV_ITEM):
    """The dK/dV work items, derived on ``off``'s device without a host
    sync.  off (BH, T_n + 1) int32 run offsets.  A run (bh, j) of len pairs
    is cut into max(1, ceil(len / item)) items of consecutive pairs, item s
    holding [off + s item, off + (s + 1) item).  Returns (plan, part_base):
    plan (n_items, 2) int32, each row (run bh * T_n + j, s) in run order,
    (-1, 0) past the last item; part_base (BH * T_n,) int32, the first
    partial slot of a run of several items and -1 for a run of one."""
    dev = off.device
    lens = (off[:, 1:] - off[:, :-1]).reshape(-1).to(torch.int64)
    n = torch.where(lens > item, (lens + item - 1) // item, 1)
    ends = torch.cumsum(n, 0)
    w = torch.arange(n_items, device=dev)
    run = torch.searchsorted(ends, w, right=True)
    last = lens.numel() - 1
    s = w - (ends - n)[run.clamp(max=last)]
    past = run > last
    plan = torch.stack([torch.where(past, -1, run),
                        torch.where(past, 0, s)], dim=-1).to(torch.int32)
    slots = torch.where(n > 1, n, 0)
    part_base = torch.where(n > 1, torch.cumsum(slots, 0) - slots, -1)
    return plan.contiguous(), part_base.to(torch.int32)


def sparse_flash_dkv_split_plain(q, k, v, idx, valid, o, lse, do, *,
                                 block_q: int, block_k: int, causal: bool,
                                 prefix_len: int = 0, item: int = DKV_ITEM):
    """Plain version of the bf16 dK/dV kernels' work split: every item of
    ``dkv_split_plan`` sums p^T dO and ds^T q over its pairs in ascending
    order (f32); a run of one item is its dK, dV; the partials of a longer
    run are added in item order.  Returns (dk, dv) in q's dtype."""
    bh, _, d = q.shape
    n_kv = k.shape[1]
    t_n = n_kv // block_k
    sm_scale = 1.0 / (d ** 0.5)
    qb, dob, kb, vb, lse_b, dd_b = _tiles(q, k, v, o, lse, do, block_q,
                                          block_k)
    _, is_, vs, off = kernel_inputs(o, do, idx, valid, t_n)
    n_items, _ = dkv_split_bounds(bh, t_n, vs.shape[-1], item)
    plan, part_base = dkv_split_plan(off, n_items, item)
    ar_q = torch.arange(block_q, device=q.device)
    ar_k = torch.arange(block_k, device=q.device)
    dk = torch.zeros(bh, t_n, block_k, d, device=q.device)
    dv = torch.zeros_like(dk)
    for run, s in plan.tolist():        # runs in order, items in order
        if run < 0:
            break
        b, j = divmod(run, t_n)
        p0 = int(off[b, j]) + s * item
        p1 = min(int(off[b, j + 1]), p0 + item)
        pk = torch.zeros(block_k, d, device=q.device)
        pv = torch.zeros_like(pk)
        for p in range(p0, p1):
            if int(vs[b, p]) != 1:
                continue
            i = int(is_[b, p])
            pr = _probs(qb[b, i], kb[b, j], lse_b[b, i], i * block_q + ar_q,
                        j * block_k + ar_k, sm_scale=sm_scale, causal=causal,
                        prefix_len=prefix_len)
            dp = dob[b, i] @ vb[b, j].T
            ds = pr * (dp - dd_b[b, i][:, None]) * sm_scale
            pv = pv + pr.T @ dob[b, i]
            pk = pk + ds.T @ qb[b, i]
        dk[b, j] += pk                  # the combine's order
        dv[b, j] += pv
    return (dk.reshape(bh, n_kv, d).to(q.dtype),
            dv.reshape(bh, n_kv, d).to(q.dtype))


def sparse_flash_bwd_plain(q, k, v, idx, valid, o, lse, do, **kw):
    """Plain PyTorch version of the two kernels: (dq, dk, dv)."""
    return (sparse_flash_dq_plain(q, k, v, idx, valid, o, lse, do, **kw),
            *sparse_flash_dkv_plain(q, k, v, idx, valid, o, lse, do, **kw))


def sparse_flash_bwd(q, k, v, idx, valid, o, lse, do, *, block_q: int,
                     block_k: int, causal: bool, prefix_len: int = 0):
    """Backward of the sparse branch: returns (dq, dk, dv) in q's dtype.

    q, o, do (BH, N_q, d); k, v (BH, N_kv, d), k the (smoothed) tensor the
    forward saw; idx/valid (BH, T_m, K_sel) int32; lse (BH, N_q) f32 from
    the forward.  CPU tensors take ``sparse_flash_bwd_plain``; CUDA tensors
    launch the ``sm_90a`` kernels (counted in ``sparse_flash_bwd.launches_dq``
    and ``.launches_dkv``) or raise."""
    _check(q, k, v, idx, valid, o, lse, do, block_q, block_k)
    kw = dict(block_q=block_q, block_k=block_k, causal=causal,
              prefix_len=prefix_len)
    if q.device.type == "cpu":
        return sparse_flash_bwd_plain(q, k, v, idx, valid, o, lse, do, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_kernel_shapes(q, k, v, idx, valid, o, lse, do, block_q, block_k)
    dd, is_, vs, off = kernel_inputs(o, do, idx, valid, k.shape[1] // block_k)
    dq = launch_dq(q, k, v, do, lse, dd, idx, valid, **kw)
    dk, dv = launch_dkv(q, k, v, do, lse, dd, is_, vs, off, **kw)
    return dq, dk, dv


sparse_flash_bwd.launches_dq = 0
sparse_flash_bwd.launches_dkv = 0


def _check_kernel_shapes(q, k, v, idx, valid, o, lse, do, block_q, block_k):
    d = q.shape[-1]
    rows = min(block_q, 64)
    if not (d % 16 == 0 and d <= 128 and block_k % 16 == 0
            and block_k <= 64 and block_q % 16 == 0 and block_q <= 128
            and block_q % rows == 0):
        raise ValueError(
            f"sla2_bwd kernels take d % 16 == 0 and d <= 128, block_k % 16 "
            f"== 0 and block_k <= 64, block_q % 16 == 0 and block_q <= 64 "
            f"or == 128; got d={d}, block_q={block_q}, block_k={block_k}")
    for t in (q, k, v, idx, valid, o, lse, do):
        if not t.is_contiguous():
            raise ValueError("sla2_bwd kernels need contiguous inputs")


def kernel_inputs(o, do, idx, valid, t_n: int):
    """What the kernels read besides the tiles: dd = rowsum(dO . O) in f32
    (BH, N_q), the sorted pairs' rows and valid flags (BH, T_m * K_sel) and
    each kv block's run offsets (BH, T_n + 1)."""
    dd = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
    js, is_, vs = sort_pairs(idx, valid)
    return dd, is_, vs, segment_offsets(js, t_n)


def _fn(lib, name, n_ptr, n_int=10):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _sizes(q, k, k_sel, block_q, block_k, causal, prefix_len):
    bh, n_q, d = q.shape
    return (bh, n_q, k.shape[1], d, block_q, block_k, k_sel, int(causal),
            prefix_len, int(q.dtype == torch.bfloat16))


def launch_dq(q, k, v, do, lse, dd, idx, valid, *, block_q, block_k, causal,
              prefix_len):
    """Launch ``sla2_bwd_dq`` on the current stream; returns dq."""
    from repro_torch.kernels.build import load_library
    dq = torch.empty_like(q)
    fn = _fn(load_library("sla2_bwd"), "sla2_sparse_bwd_dq", 9)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dd.data_ptr(), idx.data_ptr(),
                 valid.data_ptr(), dq.data_ptr(),
                 *_sizes(q, k, idx.shape[-1], block_q, block_k, causal,
                         prefix_len),
                 1.0 / (q.shape[-1] ** 0.5),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sla2_bwd_dq launch failed: CUDA error {err}")
    sparse_flash_bwd.launches_dq += 1
    return dq


def launch_dkv(q, k, v, do, lse, dd, is_, vs, off, *, block_q, block_k,
               causal, prefix_len):
    """Launch the dK/dV kernels on the current stream; returns (dk, dv).
    On bf16 the work-item plan and the partials come first, on the device
    (no host sync)."""
    from repro_torch.kernels.build import load_library
    bh, n_q, d = q.shape
    t_n = k.shape[1] // block_k
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    plan = part_base = part = None
    n_items = 0
    if q.dtype == torch.bfloat16:
        n_items, n_slots = dkv_split_bounds(bh, t_n, vs.shape[-1])
        plan, part_base = dkv_split_plan(off, n_items)
        part = torch.empty(n_slots * 2 * block_k * d, device=q.device,
                           dtype=torch.float32)
    fn = _fn(load_library("sla2_bwd"), "sla2_sparse_bwd_dkv", 14, 11)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dd.data_ptr(), is_.data_ptr(),
                 vs.data_ptr(), off.data_ptr(), _ptr(plan), _ptr(part_base),
                 _ptr(part), dk.data_ptr(), dv.data_ptr(),
                 *_sizes(q, k, vs.shape[-1] * block_q // n_q, block_q,
                         block_k, causal, prefix_len), n_items,
                 1.0 / (d ** 0.5),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sla2_bwd_dkv launch failed: CUDA error {err}")
    sparse_flash_bwd.launches_dkv += 1
    return dk, dv


def _ptr(t):
    return 0 if t is None else t.data_ptr()
