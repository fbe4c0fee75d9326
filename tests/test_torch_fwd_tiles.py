"""The int8 forward's pre-pass layout against the JAX package.

On the card the int8 ``sparse_flash_fwd`` quantises every K and V tile
once (csrc/sla2_fwd.cu, ``sla2_fwd_quant_kv``) instead of once per routed
pair.  ``quantize_kv_tiles_plain`` is that pre-pass in PyTorch: its codes
and scales are held bit for bit to JAX's ``quantize_tile``
(``repro.kernels.ops``), which the Pallas kernel applies to each whole
tile, padding keys past ``kv_len`` included, on the upcast f32 values of
f32 and bf16 inputs; its V^T codes, un-permuted, give back each tile's V
codes, and the keys that pad a row to 32 hold 0; and the plain forward's per-pair codes
are the pre-pass's codes of the routed tile, so quantising once per tile
changes no bit.  The kernel's codes are held bit for bit to this function
on the card (tests/test_torch_cuda.py).  ``sparse_flash_fwd_plain`` on the
CPU still matches the Pallas ``sparse_flash_fwd`` in interpret mode on
the int8 cases of tests/test_torch_kernels.py (1e-3; lse 2e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as jrouter
from repro.core.quant import smooth_k as jsmooth_k
from repro.kernels import ops as jops
from repro.kernels.sla2_fwd import sparse_flash_fwd as jfwd
from repro_torch.kernels import ops as tops
from repro_torch.kernels.sla2_fwd import (quantize_kv_tiles_plain,
                                          sparse_flash_fwd_plain, vperm,
                                          vt_keys)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _kv(seed, bh, n, d, kv_len, dtype):
    """k, v (BH, N, d) as numpy f32 holding values of ``dtype``; the keys
    at >= kv_len are the padding of a ragged sequence (large, so that the
    tile's absmax and scale come from them)."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((bh, n, d)).astype(np.float32)
            for _ in range(2))
    if kv_len:
        k[:, kv_len:] *= 6.0
        v[:, kv_len:] = 0.0
    t = [torch.from_numpy(x).to(dtype) for x in (k, v)]
    return t, [x.to(torch.float32).numpy() for x in t]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,bk,kv_len", [
    (256, 64, 64, 0), (256, 64, 64, 200), (192, 32, 48, 170),
    (128, 128, 16, 120), (96, 96, 32, 0)])
def test_prepass_codes_are_the_reference_tiles(n, d, bk, kv_len, dtype):
    (k, v), (kn, vn) = _kv(n + d + bk, 2, n, d, kv_len, dtype)
    kc, vt, ks, vs = quantize_kv_tiles_plain(k, v, bk)
    t_n, bkp = n // bk, vt_keys(bk)
    assert kc.shape == (2, t_n, bk, d) and vt.shape == (2, t_n, d, bkp)
    assert kc.dtype == vt.dtype == torch.int8
    assert ks.shape == vs.shape == (2, t_n) and ks.dtype == torch.float32
    pos = [32 * (kk // 32) + vperm(kk % 32) for kk in range(bk)]
    pad = sorted(set(range(bkp)) - set(pos))
    for b in range(2):
        for j in range(t_n):
            for x, codes, scale in ((kn, kc, ks), (vn, None, vs)):
                jc, js = jops.quantize_tile(
                    jnp.asarray(x[b, j * bk:(j + 1) * bk]), "int8")
                assert float(scale[b, j]) == float(js)
                want = np.asarray(jc)
                if codes is not None:
                    np.testing.assert_array_equal(codes[b, j].numpy(), want)
                else:               # un-permute the V^T row: the V codes
                    np.testing.assert_array_equal(
                        vt[b, j][:, pos].numpy().T, want)
            assert not vt[b, :, :, pad].any()


def test_vperm_is_the_fragment_order():
    """Key 8n + 2t + e of a 32-key chunk (S tile n, thread t, element e)
    sits at k-index 4t + j of the P operand: 16 (n // 2) + 4 t + 2 (n % 2)
    + e, a permutation of the chunk."""
    assert sorted(vperm(k) for k in range(32)) == list(range(32))
    for n in range(4):
        for t in range(4):
            for e in range(2):
                assert vperm(8 * n + 2 * t + e) == (
                    16 * (n // 2) + 4 * t + 2 * (n % 2) + e)
    assert [vt_keys(b) for b in (16, 32, 48, 64)] == [32, 32, 64, 64]


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape,kv_len", [  # tests/test_torch_kernels.py's
    ((2, 256, 64, 32, 16, 0.3), 0), ((2, 256, 64, 32, 16, 0.3), 251),
    ((1, 256, 128, 64, 32, 0.2), 0), ((3, 128, 32, 16, 16, 0.5), 0)])
def test_plain_forward_still_matches_the_reference(shape, kv_len):
    """The int8 cases of tests/test_torch_kernels.py (same seeds): the
    plain forward, per routed pair, is unchanged."""
    bh, n, d, bq, bk, kf = shape
    q, k, v = (_rand((bh, n, d), i) for i in range(3))
    idx, valid = jrouter.route_indices(
        {}, jnp.asarray(q), jnp.asarray(k),
        jrouter.RouterConfig(block_q=bq, block_k=bk, k_frac=kf))
    k = np.asarray(jsmooth_k(jnp.asarray(k)))
    idx, valid = np.asarray(idx), np.asarray(valid).astype(np.int32)
    kw = dict(block_q=bq, block_k=bk, causal=False, quant_bits="int8",
              kv_len=kv_len)
    jo, jl = jfwd(*(jnp.asarray(a) for a in (q, k, v, idx, valid)),
                  interpret=True, **kw)
    to, tl = sparse_flash_fwd_plain(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, idx, valid)),
        **kw)
    jo = np.asarray(jo)
    assert float(np.abs(to.numpy() - jo).max() / np.abs(jo).max()) < 1e-3
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=2e-5)


def test_prepass_codes_are_the_plain_forwards_per_pair_codes():
    """The codes and scales the plain forward makes for each routed pair
    (``quantize_tile`` of the gathered K and V tile) are the pre-pass's
    codes of that tile: quantising once per tile changes no bit."""
    bh, n, d, bq, bk = 2, 256, 64, 32, 16
    q, k, v = (torch.from_numpy(_rand((bh, n, d), 10 + i))
               for i in range(3))
    kc, vt, ks, vs = quantize_kv_tiles_plain(k, v, bk)
    idx = torch.randint(0, n // bk, (bh, n // bq, 5),
                        generator=torch.Generator().manual_seed(0))
    pos = [32 * (kk // 32) + vperm(kk % 32) for kk in range(bk)]
    bh_ix = torch.arange(bh)[:, None]
    for jj in range(idx.shape[-1]):
        j = idx[..., jj]
        for x, codes, scales in ((k, kc, ks), (v, None, vs)):
            tile = x.reshape(bh, n // bk, bk, d)[bh_ix, j]
            c, s = tops.quantize_tile(tile, "int8")
            assert torch.equal(s[..., 0, 0], scales[bh_ix, j])
            if codes is not None:
                assert torch.equal(c, codes[bh_ix, j])
            else:
                assert torch.equal(c, vt[bh_ix, j][..., pos].transpose(-1,
                                                                       -2))
