"""Block-sparse flash forward of the SLA2 sparse branch (paper Algorithm 2).

``sparse_flash_fwd`` is the wrapper.  On a CUDA tensor it launches the
hand-written ``sm_90a`` kernels in ``csrc/sla2_fwd.cu`` (built on first use
by ``kernels/build.py``); on a CPU tensor it runs ``sparse_flash_fwd_plain``,
the PyTorch transcription of the same online-softmax loop.  There is no
fallback from one to the other.

Both follow the reference Pallas kernel's order exactly: per (bh, query
block i) an ascending loop over the K_sel routed kv blocks, invalid
entries skipped; scores in f32 from the upcast tiles (int8: per-tile
scales, exact int32 product; fp8: per-tile e4m3); NEG_INF masks for
causal / prefix-LM / ragged ``kv_len``; the ``m_safe``/``corr`` online
softmax; P quantised at a fixed 1/127 (int8) or per tile (fp8); and
``acc = acc * corr + o_tmp``.

The int8 plan on the card is two launches per call: a pre-pass
quantises every K and V tile once into scratch the wrapper allocates
(``torch.empty``: the K codes (BH, T_n, bk, d), the V^T codes (BH, T_n, d,
vt_keys(bk)) with the keys of each 32 permuted as the tensor cores read
them, and the two f32 scales per tile, 2 x BH x N x d bytes and a little
at bk 64: 201 MB at BH 24), then the main kernel streams each query
block's routed code tiles through a ``cp.async`` ring onto ``mma.sync``.
``quantize_kv_tiles_plain`` is the pre-pass in PyTorch, the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ops import INT8_MAX, NEG_INF, qdot, quantize_tile

QUANT_CODES = {"none": 0, "int8": 1, "fp8": 2}
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, idx, valid, block_q, block_k, quant_bits):
    if quant_bits not in QUANT_CODES:
        raise ValueError(f"quant_bits must be one of {tuple(QUANT_CODES)}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError("q, k, v must be (BH, N, d) with k.shape == v.shape")
    bh, n_q, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if n_q % block_q or k.shape[1] % block_k:
        raise ValueError("sequence lengths must be multiples of the blocks")
    if block_k % 8:
        raise ValueError("block_k must be a multiple of 8")
    want = (bh, n_q // block_q)
    if tuple(idx.shape[:2]) != want or idx.shape != valid.shape:
        raise ValueError(f"idx/valid must be {want + ('K_sel',)}, got "
                         f"{tuple(idx.shape)} / {tuple(valid.shape)}")
    if idx.dtype != torch.int32 or valid.dtype != torch.int32:
        raise ValueError("idx and valid must be int32")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share a dtype in {_DTYPES}")
    devs = {t.device for t in (q, k, v, idx, valid)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")


def _row_sum(p):
    """Sum over the last axis in the kernel's order: s_t is the sequential
    sum of keys 8n + 2t + e (n, then e), and the row sum is
    (s_0 + s_1) + (s_2 + s_3), as the four threads of a row combine it."""
    pg = p.reshape(*p.shape[:-1], p.shape[-1] // 8, 4, 2)
    part = pg[..., 0, :, 0]
    for n in range(pg.shape[-3]):
        for e in range(2):
            if n or e:
                part = part + pg[..., n, :, e]
    return (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])


def vt_keys(block_k: int) -> int:
    """Keys of a V^T code row: block_k rounded up to 32 (a P.V k-step)."""
    return -(-block_k // 32) * 32


def vperm(k: int) -> int:
    """Position of key k (< 32) in the permuted V^T code row: key 8n + 2t
    + e sits at 16 (n // 2) + 4 t + 2 (n % 2) + e, where the S accumulator
    of the tensor cores leaves it in the P operand."""
    n, r = k >> 3, k & 7
    return 16 * (n >> 1) + 4 * (r >> 1) + 2 * (n & 1) + (r & 1)


def quantize_kv_tiles_plain(k, v, block_k: int):
    """Plain version of the int8 pre-pass: every (bh, kv block) tile of k
    and v quantised once, the whole tile (padding keys included).  k, v
    (BH, N, d).  Returns K codes (BH, T_n, bk, d) int8, V^T codes (BH, T_n,
    d, vt_keys(bk)) int8 with each 32 keys permuted by ``vperm`` (padding
    keys 0), and the scales k_s, v_s (BH, T_n) f32."""
    bh, n, d = k.shape
    t_n = n // block_k
    kc, ks = quantize_tile(k.to(torch.float32).reshape(bh, t_n, block_k, d),
                           "int8")
    vc, vs = quantize_tile(v.to(torch.float32).reshape(bh, t_n, block_k, d),
                           "int8")
    bkp = vt_keys(block_k)
    pos = torch.tensor([32 * (kk // 32) + vperm(kk % 32)
                        for kk in range(block_k)], device=k.device)
    vt = torch.zeros(bh, t_n, d, bkp, dtype=torch.int8, device=k.device)
    vt[..., pos] = vc.transpose(-1, -2)
    return kc, vt, ks[..., 0, 0], vs[..., 0, 0]


def sparse_flash_fwd_plain(q, k, v, idx, valid, *, block_q: int,
                           block_k: int, causal: bool, prefix_len: int = 0,
                           quant_bits: str = "none", kv_len: int = 0):
    """Plain PyTorch version of the kernel: the same online loop over jj,
    vectorised over (BH, T_m).  Returns (o (BH, N_q, d) in q's dtype,
    lse (BH, N_q) f32)."""
    bh, n_q, d = q.shape
    n_kv = k.shape[1]
    t_m, t_n = n_q // block_q, n_kv // block_k
    sm_scale = 1.0 / (d ** 0.5)
    if kv_len and kv_len >= n_kv:
        kv_len = 0
    dev = q.device
    qb = q.to(torch.float32).reshape(bh, t_m, block_q, d)
    kb = k.to(torch.float32).reshape(bh, t_n, block_k, d)
    vb = v.to(torch.float32).reshape(bh, t_n, block_k, d)
    if quant_bits != "none":
        q_c, q_s = quantize_tile(qb, quant_bits)
    acc = torch.zeros(bh, t_m, block_q, d, device=dev, dtype=torch.float32)
    m_i = torch.full((bh, t_m, block_q), NEG_INF, device=dev,
                     dtype=torch.float32)
    l_i = torch.zeros(bh, t_m, block_q, device=dev, dtype=torch.float32)
    rows = (torch.arange(t_m, device=dev)[:, None] * block_q
            + torch.arange(block_q, device=dev))            # (T_m, bq)
    bh_ix = torch.arange(bh, device=dev)[:, None]
    half_neg = NEG_INF * 0.5
    for jj in range(idx.shape[-1]):
        j = idx[..., jj].long()                              # (BH, T_m)
        ok = valid[..., jj] == 1
        kt, vt = kb[bh_ix, j], vb[bh_ix, j]                  # (BH,T_m,bk,d)
        if quant_bits == "none":
            s = torch.matmul(qb, kt.transpose(-1, -2)) * sm_scale
        else:
            k_c, k_s = quantize_tile(kt, quant_bits)
            s = qdot(q_c, q_s, k_c, k_s, transpose_b=True) * sm_scale
        cols = (j[..., None] * block_k
                + torch.arange(block_k, device=dev))         # (BH,T_m,bk)
        if causal:
            vis = rows[None, :, :, None] >= cols[:, :, None, :]
            if prefix_len:
                vis = vis | (cols[:, :, None, :] < prefix_len)
            s = torch.where(vis, s, NEG_INF)
        if kv_len:
            s = torch.where(cols[:, :, None, :] < kv_len, s, NEG_INF)
        m_new = torch.maximum(m_i, torch.amax(s, dim=-1))
        m_safe = torch.where(m_new > half_neg, m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(s > half_neg, p, 0.0)
        corr = torch.exp(torch.where(m_i > half_neg, m_i, m_safe) - m_safe)
        l_new = l_i * corr + _row_sum(p)
        if quant_bits == "none":
            o_tmp = torch.matmul(p, vt)
        elif quant_bits == "int8":
            p_c = torch.round(p * INT8_MAX)
            v_c, v_s = quantize_tile(vt, "int8")
            o_tmp = qdot(p_c, 1.0 / INT8_MAX, v_c, v_s, transpose_b=False)
        else:
            p_c, p_s = quantize_tile(p, "fp8")
            v_c, v_s = quantize_tile(vt, "fp8")
            o_tmp = qdot(p_c, p_s, v_c, v_s, transpose_b=False)
        acc_new = acc * corr[..., None] + o_tmp
        acc = torch.where(ok[..., None, None], acc_new, acc)
        m_i = torch.where(ok[..., None], m_new, m_i)
        l_i = torch.where(ok[..., None], l_new, l_i)
    l_safe = torch.clamp(l_i, min=1e-20)
    o = (acc / l_safe[..., None]).to(q.dtype).reshape(bh, n_q, d)
    lse = torch.where(m_i > half_neg, m_i + torch.log(l_safe), NEG_INF)
    return o, lse.reshape(bh, n_q)


def sparse_flash_fwd(q, k, v, idx, valid, *, block_q: int, block_k: int,
                     causal: bool, prefix_len: int = 0,
                     quant_bits: str = "none", kv_len: int = 0):
    """Block-sparse flash attention forward.

    q (BH, N_q, d); k, v (BH, N_kv, d) in f32 or bf16; idx (BH, T_m, K_sel)
    int32 routed kv-block ids (ascending); valid (BH, T_m, K_sel) int32
    {0, 1}; ``kv_len`` masks key positions >= kv_len (0: all keys real).
    Returns o (BH, N_q, d) in q's dtype and lse (BH, N_q) f32.

    CPU tensors take ``sparse_flash_fwd_plain``; CUDA tensors launch the
    ``sm_90a`` kernel (counted in ``sparse_flash_fwd.launches``) or raise."""
    _check(q, k, v, idx, valid, block_q, block_k, quant_bits)
    kw = dict(block_q=block_q, block_k=block_k, causal=causal,
              prefix_len=prefix_len, quant_bits=quant_bits, kv_len=kv_len)
    if q.device.type == "cpu":
        return sparse_flash_fwd_plain(q, k, v, idx, valid, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, idx, valid, **kw)


sparse_flash_fwd.launches = 0


def quantize_kv_tiles(k, v, block_k: int):
    """The int8 pre-pass on the card (``sla2_fwd_quant_kv``): the codes and
    scales of ``quantize_kv_tiles_plain``, in scratch from ``torch.empty``.
    Part of a ``sparse_flash_fwd`` launch; not counted on its own."""
    from repro_torch.kernels.build import load_library
    bh, n_kv, d = k.shape
    t_n, bkp = n_kv // block_k, vt_keys(block_k)
    codes = torch.empty(bh * t_n * (block_k + bkp) * d, device=k.device,
                        dtype=torch.int8)
    kc = codes[:bh * n_kv * d].view(bh, t_n, block_k, d)
    vt = codes[bh * n_kv * d:].view(bh, t_n, d, bkp)
    scales = torch.empty(2, bh, t_n, device=k.device, dtype=torch.float32)
    fn = load_library("sla2_fwd").sla2_fwd_quantize_kv
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(k.device):
        err = fn(k.data_ptr(), v.data_ptr(), kc.data_ptr(), vt.data_ptr(),
                 scales[0].data_ptr(), scales[1].data_ptr(), bh, n_kv, d,
                 block_k, int(k.dtype == torch.bfloat16),
                 torch.cuda.current_stream(k.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sla2_fwd pre-pass launch failed: CUDA error "
                           f"{err}")
    return kc, vt, scales[0], scales[1]


def _launch(q, k, v, idx, valid, *, block_q, block_k, causal, prefix_len,
            quant_bits, kv_len):
    from repro_torch.kernels.build import load_library
    bh, n_q, d = q.shape
    n_kv = k.shape[1]
    k_sel = idx.shape[-1]
    if not (d % 32 == 0 and d <= 128 and block_k % 16 == 0
            and block_k <= 64 and block_q % 16 == 0 and block_q <= 128):
        raise ValueError(
            f"sla2_fwd kernel takes d % 32 == 0 and d <= 128, block_k % 16 "
            f"== 0 and block_k <= 64, block_q % 16 == 0 and block_q <= 128; "
            f"got d={d}, block_q={block_q}, block_k={block_k}")
    for t in (q, k, v, idx, valid):
        if not t.is_contiguous():
            raise ValueError("sla2_fwd kernel needs contiguous inputs")
    if kv_len and kv_len >= n_kv:
        kv_len = 0
    codes = (quantize_kv_tiles(k, v, block_k) if quant_bits == "int8"
             else (None,) * 4)
    o = torch.empty_like(q)
    lse = torch.empty(bh, n_q, device=q.device, dtype=torch.float32)
    fn = load_library("sla2_fwd").sla2_sparse_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
                 valid.data_ptr(), *(0 if t is None else t.data_ptr()
                                     for t in codes),
                 o.data_ptr(), lse.data_ptr(), bh, n_q, n_kv, d, block_q,
                 block_k, k_sel, int(causal), prefix_len, kv_len,
                 QUANT_CODES[quant_bits], int(q.dtype == torch.bfloat16),
                 1.0 / (d ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"sla2_fwd kernel launch failed: CUDA error {err}")
    sparse_flash_fwd.launches += 1
    return o, lse
