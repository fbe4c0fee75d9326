"""The port's CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor the reference package, so it runs on a
machine with a card and PyTorch alone (``--noconftest`` skips
tests/conftest.py, which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Every test needs an NVIDIA card (the kernels have no CPU mode) and skips
without one.  Bounds: 1e-4 relative max error in f32 and 2^-7 (two bf16
ulps) in bf16 for the backward, whose sums run in another order than the
plain version's; the int8 forward equals its plain version bit for bit on
the card (PERF.md), bounded here by 1e-3 (fp8 1e-2).  The paged kernels
(sla2_decode_paged.cu: sla2_decode, dense_decode; paged_prefill.cu) are
held to 2e-5 with f32 tiles, 1e-3 with int8 and 1e-2 with fp8 QAT tiles
(an exp that differs by an ulp can flip one rounded P code).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import router as R
from repro_torch.core.quant import smooth_k
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sla2_decode_paged as KP
from repro_torch.kernels.sla2_bwd import sparse_flash_bwd, sparse_flash_bwd_plain
from repro_torch.kernels.sla2_fwd import (quantize_kv_tiles,
                                          quantize_kv_tiles_plain,
                                          sparse_flash_fwd,
                                          sparse_flash_fwd_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _case(g, shape, dtype, causal, prefix_len, k_frac):
    bh, n, d, bq, bk = shape
    q, k, v, do = ((torch.randn(bh, n, d, generator=g, device="cuda") * 0.5)
                   .to(dtype) for _ in range(4))
    idx, valid = R.route_indices(None, q, k, R.RouterConfig(
        block_q=bq, block_k=bk, k_frac=k_frac, causal=causal,
        prefix_len=prefix_len))
    return q, k, v, do, idx, valid.to(torch.int32)


def _force_hot(idx, valid, hot):
    """Every query block routes kv block ``hot`` (in its last entry if it
    did not already)."""
    has = ((idx == hot) & (valid == 1)).any(-1)
    idx, valid = idx.clone(), valid.clone()
    idx[..., -1] = torch.where(has, idx[..., -1], hot)
    valid[..., -1] = torch.where(has, valid[..., -1], 1)
    return idx, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,prefix_len,k_frac,hot", [
    ((2, 256, 64, 32, 16), True, 48, 0.5, None),
    ((3, 1024, 128, 128, 64), False, 0, 0.1, None),
    ((2, 512, 64, 64, 32), True, 0, 0.5, None),
    ((2, 4096, 128, 128, 64), False, 0, 0.05, None),    # the main tiling
    ((2, 8192, 128, 128, 64), False, 0, 0.05, 7),       # a hot kv block
    ((2, 1024, 64, 64, 32), True, 0, 0.25, 3),
    ((10, 2048, 128, 128, 64), True, 0, 0.05, 0)])   # LM: hot early block
def test_bwd_kernels_match_plain(card, shape, causal, prefix_len, k_frac,
                                 hot, dtype):
    q, k, v, do, idx, valid = _case(card, shape, getattr(torch, dtype),
                                    causal, prefix_len, k_frac)
    if hot is not None:
        idx, valid = _force_hot(idx, valid, hot)
    kw = dict(block_q=shape[3], block_k=shape[4], causal=causal,
              prefix_len=prefix_len)
    o, lse = sparse_flash_fwd(q, k, v, idx, valid, **kw)
    before = (sparse_flash_bwd.launches_dq, sparse_flash_bwd.launches_dkv)
    got = sparse_flash_bwd(q, k, v, idx, valid, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (sparse_flash_bwd.launches_dq, sparse_flash_bwd.launches_dkv) == (
        before[0] + 1, before[1] + 1)
    want = sparse_flash_bwd_plain(q, k, v, idx, valid, o, lse, do, **kw)
    bound = 1e-4 if dtype == "float32" else 2 ** -7
    for g, w in zip(got, want):
        assert g.dtype == q.dtype and _rel(g, w) <= bound


def test_bwd_rejects_what_the_kernels_do_not_take(card):
    q, k, v, do, idx, valid = _case(card, (1, 256, 192, 64, 32),
                                    torch.float32, False, 0, 0.25)
    kw = dict(block_q=64, block_k=32, causal=False)
    o, lse = sparse_flash_fwd_plain(q, k, v, idx, valid, **kw)
    with pytest.raises(ValueError, match="d <= 128"):
        sparse_flash_bwd(q, k, v, idx, valid, o, lse, do, **kw)


def test_autograd_op_matches_dense_oracle(card):
    xs = [torch.randn(2, 256, 64, generator=card, device="cuda") * 0.5
          for _ in range(4)]
    idx, valid = R.route_indices(None, xs[0], xs[1], R.RouterConfig(
        block_q=32, block_k=16, k_frac=0.3))
    grads = []
    for kernel in (True, False):
        q, k, v = (x.clone().requires_grad_() for x in xs[:3])
        if kernel:
            o, _ = ops.sparse_attention_op(q, k, v, idx, valid, 32, 16, False,
                                           "none")
        else:
            o, _ = ref.sparse_flash_ref(q, k, v, idx, valid, block_q=32,
                                        block_k=16, causal=False)
        torch.sum(o * xs[3]).backward()
        grads.append((q.grad, k.grad, v.grad))
    for a, b in zip(*grads):
        assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_fwd_kernel_matches_plain(card, quant):
    q, k, v, _, idx, valid = _case(card, (3, 1024, 128, 128, 64),
                                   torch.bfloat16, False, 0, 0.1)
    if quant != "none":
        k = smooth_k(k).contiguous()
    kw = dict(block_q=128, block_k=64, causal=False, quant_bits=quant)
    o, lse = sparse_flash_fwd(q, k, v, idx, valid, **kw)
    torch.cuda.synchronize()
    po, pl = sparse_flash_fwd_plain(q, k, v, idx, valid, **kw)
    assert _rel(o, po) <= max(1e-3, 2 ** -7)
    assert float((lse - pl).abs().max()) < 1e-3


@pytest.mark.parametrize("shape,hot", [
    ((2, 4096, 128, 128, 64), None),          # the main tiling
    ((2, 4096, 128, 128, 64), 5),             # ... with a hot kv block
    ((3, 1024, 64, 64, 32), 2),               # run-time sizes
    ((2, 768, 96, 32, 48), 1)])               # bk 48: padded V^T keys
def test_fwd_int8_prepass_and_ring_match_plain(card, shape, hot):
    """The int8 forward as the pre-pass (codes and scales bit-equal to
    quantize_kv_tiles_plain) and the main kernel over a ring of routed
    code tiles, with a kv block that every query block routes."""
    bh, n, d, bq, bk = shape
    q, k, v, _, idx, valid = _case(card, shape, torch.bfloat16, False, 0,
                                   0.1)
    if hot is not None:
        idx, valid = _force_hot(idx, valid, hot)
    k = smooth_k(k).contiguous()
    got = quantize_kv_tiles(k, v, bk)
    torch.cuda.synchronize()
    for g, w in zip(got, quantize_kv_tiles_plain(k, v, bk)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    kw = dict(block_q=bq, block_k=bk, causal=False, quant_bits="int8")
    before = sparse_flash_fwd.launches
    o, lse = sparse_flash_fwd(q, k, v, idx, valid, **kw)
    torch.cuda.synchronize()
    assert sparse_flash_fwd.launches == before + 1
    po, pl = sparse_flash_fwd_plain(q, k, v, idx, valid, **kw)
    assert _rel(o, po) < 1e-3 and float((lse - pl).abs().max()) < 1e-3


BOUND = {"none": 2e-5, "int8": 1e-3, "fp8": 1e-2}


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_causal_gqa_fwd_at_the_lm_tiling(card, quant):
    """The causal forward as the LM runs it: K/V of 2 KV heads repeated to
    10 query heads (BH 10, each K/V tile 5 times over), bq 128 / bk 64,
    routed with the forced diagonal (two kv blocks per query block)."""
    n, d = 2048, 128
    q = (torch.randn(1, 10, n, d, generator=card, device="cuda") * 0.5
         ).to(torch.bfloat16)
    k, v = ((torch.randn(1, 2, n, d, generator=card, device="cuda") * 0.5)
            .to(torch.bfloat16).repeat_interleave(5, dim=1) for _ in range(2))
    q, k, v = (x.reshape(10, n, d).contiguous() for x in (q, k, v))
    idx, valid = R.route_indices(None, q, k, R.RouterConfig(
        block_q=128, block_k=64, k_frac=0.05, causal=True))
    valid = valid.to(torch.int32)
    # query block 0 sees kv blocks 0 and 1 alone, both forced in
    assert idx.shape[-1] == 2 and idx[:, 0].tolist() == [[0, 1]] * 10
    if quant != "none":
        k = smooth_k(k).contiguous()
    kw = dict(block_q=128, block_k=64, causal=True, quant_bits=quant)
    o, lse = sparse_flash_fwd(q, k, v, idx, valid, **kw)
    torch.cuda.synchronize()
    po, pl = sparse_flash_fwd_plain(q, k, v, idx, valid, **kw)
    assert bool(torch.isfinite(o).all())
    assert _rel(o, po) <= max(BOUND[quant], 2 ** -7)
    assert float((lse - pl).abs().max()) < 1e-3


@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
def test_cuda_kernel_matches_plain(card, quant):
    """The forward kernel on a causal case with prefix_len and kv_len."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy((rng.standard_normal((2, 256, 64)) * 0.5)
                                .astype(np.float32)).cuda() for _ in range(3))
    idx, valid = R.route_indices(None, q, k, R.RouterConfig(
        block_q=32, block_k=16, k_frac=0.3, causal=True))
    valid = valid.to(torch.int32)
    if quant != "none":
        k = smooth_k(k).contiguous()
    kw = dict(block_q=32, block_k=16, causal=True, quant_bits=quant,
              prefix_len=16, kv_len=250)
    before = sparse_flash_fwd.launches
    o, lse = sparse_flash_fwd(q, k, v, idx, valid, **kw)
    torch.cuda.synchronize()
    assert sparse_flash_fwd.launches == before + 1
    po, pl = sparse_flash_fwd_plain(q, k, v, idx, valid, **kw)
    assert _rel(o, po) < BOUND[quant]
    assert float((lse - pl).abs().max()) < 1e-4


def _pool(g, n_pages, hkv, bk, dh, kv_quant, dtype):
    k, v = (torch.randn(n_pages, hkv, bk, dh, generator=g, device="cuda")
            for _ in range(2))
    if kv_quant == "none":
        return k.to(dtype), v.to(dtype), None, None
    (kc, ks), (vc, vs) = (ops.quantize_rows(t, kv_quant) for t in (k, v))
    return kc, vc, ks, vs


@pytest.mark.parametrize("quant,kv_quant,n_rep,w,dtype", [
    ("none", "none", 5, 1, "bfloat16"), ("none", "none", 2, 3, "float32"),
    ("int8", "int8", 5, 1, "bfloat16"), ("fp8", "fp8", 1, 4, "bfloat16"),
    ("int8", "fp8", 2, 1, "float32"), ("none", "int8", 5, 4, "bfloat16")])
def test_decode_kernel_matches_plain(card, quant, kv_quant, n_rep, w, dtype):
    g, dt = card, getattr(torch, dtype)
    b, hkv, dh, bk, k_sel, n_pages = 3, 4, 128, 64, 26, 300
    kp, vp, ks, vs = _pool(g, n_pages, hkv, bk, dh, kv_quant, dt)
    ints = lambda lo, hi, shape: torch.randint(
        lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)
    rnd = lambda *shape: torch.rand(*shape, generator=g, device="cuda")
    q = torch.randn(b, hkv, w, n_rep, dh, generator=g, device="cuda").to(dt)
    phys = ints(1, n_pages, (b, hkv, w, k_sel))
    jlog = ints(0, 100, (b, hkv, w, k_sel))
    valid = (rnd(b, hkv, w, k_sel) > 0.2).to(torch.int32)
    valid[0, 0] = 0                                   # a row with none
    comp = (rnd(b, hkv, w, k_sel) > 0.3).to(torch.int32) * valid
    t_new = ints(50 * bk, 100 * bk, (b, w))
    h = rnd(b, hkv, w, dh, dh) * 50
    z = rnd(b, hkv, w, dh) * 1000 + 200
    alpha = torch.randn(b, hkv, n_rep, generator=g, device="cuda")
    args = (q, kp, vp, phys, jlog, valid, comp, t_new, h, z, alpha)
    kw = dict(block_k=bk, quant_bits=quant, kv_quant=kv_quant, k_scale=ks,
              v_scale=vs)
    before = KP.sla2_decode_verify.launches
    o = KP.sla2_decode_verify(*args, **kw)
    torch.cuda.synchronize()
    assert KP.sla2_decode_verify.launches == before + 1
    want = KP.sla2_decode_verify_plain(*args, **kw)
    assert torch.isfinite(o).all() and _rel(o, want) < BOUND[quant]


@pytest.mark.parametrize("kv_quant,n_rep,w,eps,dtype,comp", [
    ("none", 5, 1, 1, "bfloat16", "some"),
    ("none", 5, 4, 3, "bfloat16", "some"),
    ("none", 1, 1, 26, "float32", "all"),      # one split: the unsplit loop
    ("none", 5, 4, 7, "float32", "none"),
    ("int8", 5, 1, 2, "bfloat16", "some"),
    ("fp8", 2, 4, 5, "float32", "all"),
    ("none", 16, 2, 4, "bfloat16", "some")])
def test_split_decode_matches_plain(card, monkeypatch, kv_quant, n_rep, w,
                                    eps, dtype, comp):
    """The split SLA2 decode (f32 tiles) at the splits each case sets in
    place of the wrapper's choice, against the unsplit plain version and
    the split one: a row
    with no valid entry, a split whose entries are all invalid (entries
    0..eps-1 of row (1, 1)), complete flags on some, none or all
    entries."""
    g, dt = card, getattr(torch, dtype)
    b, hkv, dh, bk, k_sel, n_pages = 3, 4, 128, 64, 26, 300
    kp, vp, ks, vs = _pool(g, n_pages, hkv, bk, dh, kv_quant, dt)
    ints = lambda lo, hi, shape: torch.randint(
        lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)
    rnd = lambda *shape: torch.rand(*shape, generator=g, device="cuda")
    q = torch.randn(b, hkv, w, n_rep, dh, generator=g, device="cuda").to(dt)
    phys = ints(1, n_pages, (b, hkv, w, k_sel))
    jlog = ints(0, 100, (b, hkv, w, k_sel))
    valid = (rnd(b, hkv, w, k_sel) > 0.2).to(torch.int32)
    valid[0, 0] = 0                                   # a row with none
    valid[1, 1, :, :eps] = 0                          # an empty split
    flags = {"some": (rnd(b, hkv, w, k_sel) > 0.3).to(torch.int32),
             "none": torch.zeros_like(valid), "all": torch.ones_like(valid)}
    complete = flags[comp] * valid
    t_new = ints(50 * bk, 100 * bk, (b, w))
    h = rnd(b, hkv, w, dh, dh) * 50
    z = rnd(b, hkv, w, dh) * 1000 + 200
    alpha = torch.randn(b, hkv, n_rep, generator=g, device="cuda")
    args = (q, kp, vp, phys, jlog, valid, complete, t_new, h, z, alpha)
    kw = dict(block_k=bk, kv_quant=kv_quant, k_scale=ks, v_scale=vs)
    monkeypatch.setattr(KP, "decode_split_shape",
                        lambda *_: (eps, -(-k_sel // eps)))
    before = KP.sla2_decode_verify.launches
    o = KP.sla2_decode_verify(*args, **kw)
    torch.cuda.synchronize()
    assert KP.sla2_decode_verify.launches == before + 1
    assert torch.isfinite(o).all()
    assert _rel(o, KP.sla2_decode_verify_plain(*args, **kw)) < 2e-5
    assert _rel(o, KP.sla2_decode_split_plain(
        *args, entries_per_split=eps, **kw)) < 2e-5


def test_split_decode_rows_do_not_depend_on_the_window(card):
    """A verify window computes each row bit for bit as a single-row decode
    of the same inputs: the split size does not depend on W."""
    g = card
    b, hkv, n_rep, dh, bk, k_sel, n_pages, w = 4, 8, 5, 128, 64, 26, 400, 4
    kp, vp, _, _ = _pool(g, n_pages, hkv, bk, dh, "none", torch.bfloat16)
    ints = lambda lo, hi, shape: torch.randint(
        lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)
    rnd = lambda *shape: torch.rand(*shape, generator=g, device="cuda")
    q = torch.randn(b, hkv, w, n_rep, dh, generator=g,
                    device="cuda").bfloat16()
    phys = ints(1, n_pages, (b, hkv, w, k_sel))
    jlog = ints(0, 100, (b, hkv, w, k_sel))
    valid = (rnd(b, hkv, w, k_sel) > 0.1).to(torch.int32)
    complete = (rnd(b, hkv, w, k_sel) > 0.2).to(torch.int32) * valid
    t_new = ints(90 * bk, 100 * bk, (b, w))
    h = rnd(b, hkv, w, dh, dh) * 50
    z = rnd(b, hkv, w, dh) * 1000 + 200
    alpha = torch.randn(b, hkv, n_rep, generator=g, device="cuda")
    o = KP.sla2_decode_verify(q, kp, vp, phys, jlog, valid, complete, t_new,
                              h, z, alpha, block_k=bk)
    for r in range(w):
        o1 = KP.sla2_decode_fused(
            q[:, :, r], kp, vp, phys[:, :, r], jlog[:, :, r],
            valid[:, :, r], complete[:, :, r], t_new[:, r].contiguous(),
            h[:, :, r], z[:, :, r], alpha, block_k=bk)
        torch.cuda.synchronize()
        assert torch.equal(o1, o[:, :, r])


@pytest.mark.parametrize("c,offset,window,prefix_len,kv_quant,dh,dtype", [
    (256, 0, None, 0, "none", 128, "bfloat16"),
    (256, 1024, None, 0, "int8", 128, "bfloat16"),
    (256, 512, 256, 48, "fp8", 128, "bfloat16"),
    (256, 192, 100, 0, "none", 64, "bfloat16"),
    (512, 0, None, 0, "none", 128, "bfloat16"),
    (512, 1024, None, 0, "none", 128, "bfloat16"),
    (512, 7680, None, 0, "none", 128, "bfloat16"),   # the ring wraps often
    (440, 640, None, 0, "none", 128, "bfloat16"),    # tiles straddle heads
    (256, 512, 256, 48, "int8", 128, "bfloat16"),
    (200, 320, 100, 16, "none", 64, "float32")])     # f32 q and pool
def test_prefill_kernel_matches_plain(card, c, offset, window, prefix_len,
                                      kv_quant, dh, dtype):
    g, dt = card, getattr(torch, dtype)
    hkv, n_rep, bk = 4, 5, 64
    used = -(-(offset + c) // bk)
    max_p, n_pages = used + 8, used + 40
    kp, vp, ks, vs = _pool(g, n_pages, hkv, bk, dh, kv_quant, dt)
    q = torch.randn(hkv * n_rep, c, dh, generator=g, device="cuda").to(dt)
    row = torch.zeros(max_p, dtype=torch.int32, device="cuda")
    row[:used] = (torch.randperm(n_pages - 1, generator=g,
                                 device="cuda")[:used] + 1).int()
    kw = dict(offset=offset, block_k=bk, n_rep=n_rep, window=window,
              prefix_len=prefix_len, kv_quant=kv_quant, k_scale=ks,
              v_scale=vs)
    before = KP.paged_flash_prefill.launches
    o = KP.paged_flash_prefill(q, kp, vp, row, **kw)
    torch.cuda.synchronize()
    assert KP.paged_flash_prefill.launches == before + 1
    assert _rel(o, KP.paged_flash_prefill_plain(q, kp, vp, row, **kw)) < 2e-5


_BASE = (3000, 700, 1, None)            # None: the table's last position
_RAGGED = ((3000, 2500, 3100, 2999), (700, 1, 65, 640), (0, 0, 0, 0),
           (4000, 4001, 3000, 3999))
_PAGES = ((2560, 2560, 2624, 2624), (640, 704, 640, 768), (0, 0, 0, 0),
          (64, 128, 192, 256))


@pytest.mark.parametrize(
    "quant,kv_quant,n_rep,w,window,prefix_len,dtype,lengths", [
        ("none", "none", 5, 1, None, 0, "bfloat16", _BASE),
        ("none", "none", 5, 4, None, 0, "bfloat16", _BASE),
        ("none", "none", 2, 3, 256, 64, "float32", _BASE),
        ("int8", "int8", 5, 1, None, 0, "bfloat16", _BASE),
        ("int8", "fp8", 1, 4, 256, 0, "bfloat16", _BASE),
        ("fp8", "fp8", 5, 4, None, 0, "bfloat16", _BASE),
        ("fp8", "none", 2, 1, 256, 64, "float32", _BASE),
        ("none", "int8", 5, 4, 256, 64, "bfloat16", _BASE),
        # lengths at exact page multiples
        ("none", "none", 5, 1, None, 0, "bfloat16", (2560, 640, 0, 192)),
        ("none", "none", 5, 4, None, 0, "bfloat16", _PAGES),
        ("fp8", "int8", 2, 1, None, 0, "bfloat16", (2560, 640, 0, 192)),
        # rows of one page
        ("none", "none", 2, 1, 256, 64, "bfloat16", (64, 1, 0, 30)),
        # more splits than any row has pages
        ("none", "none", 5, 4, None, 0, "bfloat16", (500, 300, 0, 10)),
        # W = 4 with ragged lengths
        ("none", "int8", 5, 4, 256, 64, "bfloat16", _RAGGED),
        ("int8", "none", 5, 4, None, 0, "bfloat16", _RAGGED)])
def test_dense_decode_kernel_matches_plain(card, quant, kv_quant, n_rep, w,
                                           window, prefix_len, dtype,
                                           lengths):
    """Slot 2 sees nothing and must write exactly 0."""
    g, dt = card, getattr(torch, dtype)
    b, hkv, dh, bk, max_p, n_pages = 4, 4, 128, 64, 64, 200
    kp, vp, ks, vs = _pool(g, n_pages, hkv, bk, dh, kv_quant, dt)
    q = torch.randn(b, hkv, w, n_rep, dh, generator=g, device="cuda").to(dt)
    table = torch.zeros(b, max_p, dtype=torch.int32, device="cuda")
    for s in range(b):
        table[s] = (torch.randperm(n_pages - 1, generator=g,
                                   device="cuda")[:max_p] + 1).int()
    if isinstance(lengths[0], tuple):
        t_new = torch.tensor([row[:w] for row in lengths], device="cuda")
    else:
        base = torch.tensor([bk * max_p - w if n is None else n
                             for n in lengths], device="cuda")
        t_new = base[:, None] + torch.arange(w, device="cuda")
    t_new = t_new.int()
    t_new[2] = 0                                     # a row that sees nothing
    kw = dict(block_k=bk, window=window, prefix_len=prefix_len,
              quant_bits=quant, kv_quant=kv_quant, k_scale=ks, v_scale=vs)
    before = KP.dense_decode_verify.launches
    o = KP.dense_decode_verify(q, kp, vp, table, t_new, **kw)
    torch.cuda.synchronize()
    assert KP.dense_decode_verify.launches == before + 1
    want = KP.dense_decode_verify_plain(q, kp, vp, table, t_new, **kw)
    assert torch.isfinite(o).all() and _rel(o, want) < BOUND[quant]
    assert float(o[2].abs().max()) == 0.0
    o1 = KP.dense_decode_fused(q[:, :, 0], kp, vp, table, t_new[:, 0], **kw)
    torch.cuda.synchronize()
    assert _rel(o1, want[:, :, 0]) < BOUND[quant]


def test_paged_kernels_reject_what_they_do_not_take(card):
    kp = torch.zeros(4, 2, 64, 80, device="cuda", dtype=torch.bfloat16)
    q = torch.zeros(4, 64, 80, device="cuda", dtype=torch.bfloat16)
    row = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="Dh in"):
        KP.paged_flash_prefill(q, kp, kp, row, offset=0, block_k=64, n_rep=2)
    dq = torch.zeros(1, 2, 1, 2, 80, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh in"):
        KP.dense_decode_verify(dq, kp, kp, row[None],
                               torch.ones(1, 1, dtype=torch.int32,
                                          device="cuda"), block_k=64)


# ---------------------------------------------------------------------------
# GQA ratio 6 (internlm2-20b: 48 query heads over 8 KV heads) and pages
# shared between page-table rows (the prefix cache)
# ---------------------------------------------------------------------------

def _routing(g, b, hkv, w, k_sel, n_pages, bk, lo, hi):
    ints = lambda a, z, shape: torch.randint(
        a, z, shape, generator=g, device="cuda", dtype=torch.int32)
    rnd = lambda *shape: torch.rand(*shape, generator=g, device="cuda")
    phys = ints(1, n_pages, (b, hkv, w, k_sel))
    jlog = ints(0, 100, (b, hkv, w, k_sel))
    valid = (rnd(b, hkv, w, k_sel) > 0.2).to(torch.int32)
    comp = (rnd(b, hkv, w, k_sel) > 0.3).to(torch.int32) * valid
    t_new = ints(lo * bk, hi * bk, (b, w))
    return phys, jlog, valid, comp, t_new


@pytest.mark.parametrize("quant,kv_quant,w", [
    ("none", "none", 1), ("none", "none", 4), ("int8", "int8", 1),
    ("none", "fp8", 4)])
def test_sla2_decode_at_gqa_ratio_6(card, quant, kv_quant, w):
    """internlm2-20b's decode shape: B 4, Hkv 8, n_rep 6, Dh 128, K_sel
    26; the split kernel (f32 tiles) and the QAT kernel."""
    g = card
    b, hkv, n_rep, dh, bk, k_sel, n_pages = 4, 8, 6, 128, 64, 26, 400
    kp, vp, ks, vs = _pool(g, n_pages, hkv, bk, dh, kv_quant, torch.bfloat16)
    q = torch.randn(b, hkv, w, n_rep, dh, generator=g,
                    device="cuda").bfloat16()
    phys, jlog, valid, comp, t_new = _routing(g, b, hkv, w, k_sel, n_pages,
                                              bk, 50, 200)
    rnd = lambda *shape: torch.rand(*shape, generator=g, device="cuda")
    h = rnd(b, hkv, w, dh, dh) * 50
    z = rnd(b, hkv, w, dh) * 1000 + 200
    alpha = torch.randn(b, hkv, n_rep, generator=g, device="cuda")
    args = (q, kp, vp, phys, jlog, valid, comp, t_new, h, z, alpha)
    kw = dict(block_k=bk, quant_bits=quant, kv_quant=kv_quant, k_scale=ks,
              v_scale=vs)
    o = KP.sla2_decode_verify(*args, **kw)
    torch.cuda.synchronize()
    want = KP.sla2_decode_verify_plain(*args, **kw)
    assert torch.isfinite(o).all() and _rel(o, want) < BOUND[quant]


@pytest.mark.parametrize("w,window,prefix_len,kv_quant", [
    (1, None, 0, "none"), (4, None, 0, "none"), (4, 256, 64, "int8"),
    (1, 256, 0, "fp8")])
def test_dense_decode_at_gqa_ratio_6(card, w, window, prefix_len, kv_quant):
    """dense_decode at n_rep 6: a W 4 window puts 24 rows in a block."""
    g = card
    b, hkv, n_rep, dh, bk, max_p, n_pages = 4, 8, 6, 128, 64, 64, 300
    kp, vp, ks, vs = _pool(g, n_pages, hkv, bk, dh, kv_quant, torch.bfloat16)
    q = torch.randn(b, hkv, w, n_rep, dh, generator=g,
                    device="cuda").bfloat16()
    table = torch.stack([(torch.randperm(n_pages - 1, generator=g,
                                         device="cuda")[:max_p] + 1).int()
                         for _ in range(b)])
    lens = torch.tensor([4000, 1500, 65, 700], device="cuda")
    t_new = (lens[:, None] + torch.arange(w, device="cuda") + 1).int()
    kw = dict(block_k=bk, window=window, prefix_len=prefix_len,
              kv_quant=kv_quant, k_scale=ks, v_scale=vs)
    o = KP.dense_decode_verify(q, kp, vp, table, t_new, **kw)
    torch.cuda.synchronize()
    want = KP.dense_decode_verify_plain(q, kp, vp, table, t_new, **kw)
    assert torch.isfinite(o).all() and _rel(o, want) < 2e-5


@pytest.mark.parametrize("offset,kv_quant", [
    (0, "none"), (1024, "none"), (7680, "none"), (3584, "int8")])
def test_prefill_at_gqa_ratio_6(card, offset, kv_quant):
    g = card
    hkv, n_rep, dh, bk, c = 8, 6, 128, 64, 512
    used = (offset + c) // bk
    n_pages = used + 40
    kp, vp, ks, vs = _pool(g, n_pages, hkv, bk, dh, kv_quant, torch.bfloat16)
    q = torch.randn(hkv * n_rep, c, dh, generator=g, device="cuda").bfloat16()
    row = torch.zeros(used + 8, dtype=torch.int32, device="cuda")
    row[:used] = (torch.randperm(n_pages - 1, generator=g,
                                 device="cuda")[:used] + 1).int()
    kw = dict(offset=offset, block_k=bk, n_rep=n_rep, kv_quant=kv_quant,
              k_scale=ks, v_scale=vs)
    o = KP.paged_flash_prefill(q, kp, vp, row, **kw)
    torch.cuda.synchronize()
    assert _rel(o, KP.paged_flash_prefill_plain(q, kp, vp, row, **kw)) < 2e-5


@pytest.mark.parametrize("n_rep", [5, 6])
def test_paged_kernels_over_shared_and_copied_pages(card, n_rep):
    """A prefix cache hit maps one physical prefix into several page-table
    rows, and copy-on-write moves a page to another physical id: the
    kernels' outputs depend on the pages' contents, never on their ids or
    on who else maps them (bit for bit)."""
    g = card
    hkv, dh, bk, c, n_pages = 8, 128, 64, 512, 300
    kp, vp, _, _ = _pool(g, n_pages, hkv, bk, dh, "none", torch.bfloat16)
    offset = 3584                                # a whole-prompt hit's rerun
    used = (offset + c) // bk
    base = (torch.randperm(n_pages // 2 - 1, generator=g, device="cuda")
            [:used] + 1).int()
    moved = base.clone()
    moved[offset // bk:] += n_pages // 2         # the copied last chunk
    kp[moved.long()], vp[moved.long()] = kp[base.long()], vp[base.long()]
    q = torch.randn(hkv * n_rep, c, dh, generator=g, device="cuda").bfloat16()
    kw = dict(offset=offset, block_k=bk, n_rep=n_rep)
    o1 = KP.paged_flash_prefill(q, kp, vp, base, **kw)
    o2 = KP.paged_flash_prefill(q, kp, vp, moved, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    assert _rel(o1, KP.paged_flash_prefill_plain(q, kp, vp, base, **kw)) \
        < 2e-5
    # decode: four slots, two of them on the same physical prefix
    b, w, t = 4, 4, offset + c
    table = torch.stack([base, base, moved, base]).contiguous()
    qd = torch.randn(1, hkv, w, n_rep, dh, generator=g,
                     device="cuda").bfloat16().expand(b, -1, -1, -1, -1)
    qd = qd.contiguous()
    t_new = (t + torch.arange(w, device="cuda") + 1 - w).int()
    t_new = t_new[None].expand(b, -1).contiguous()
    o = KP.dense_decode_verify(qd, kp, vp, table, t_new, block_k=bk)
    torch.cuda.synchronize()
    assert torch.equal(o[0], o[1]) and torch.equal(o[0], o[2])
    k_sel = 26
    phys, jlog, valid, comp, _ = _routing(g, 1, hkv, w, k_sel, used, bk, 1, 2)
    jlog = torch.randint(0, used, jlog.shape, generator=g, device="cuda",
                         dtype=torch.int32)
    phys_b = base.long()[jlog.long()].int()
    phys_m = moved.long()[jlog.long()].int()
    rnd = lambda *shape: torch.rand(*shape, generator=g, device="cuda")
    h = rnd(1, hkv, w, dh, dh) * 50
    z = rnd(1, hkv, w, dh) * 1000 + 200
    alpha = torch.randn(1, hkv, n_rep, generator=g, device="cuda")
    tn = t_new[:1]
    args = (qd[:1], kp, vp)
    rest = (jlog, valid, comp, tn, h, z, alpha)
    o1 = KP.sla2_decode_verify(*args, phys_b, *rest, block_k=bk)
    o2 = KP.sla2_decode_verify(*args, phys_m, *rest, block_k=bk)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
