"""The port's sparse-branch kernel module against the JAX reference.

``sparse_flash_fwd_plain`` (the PyTorch version of the CUDA kernel, and
what the wrapper runs on a CPU tensor) is held to the Pallas kernel run in
interpret mode, over the reference's kernel-test shapes x causal x
none/int8/fp8, plus ``kv_len`` and ``prefix_len``.  Bounds: 2e-5 for
'none' (tests/test_kernels.py:46); a relative max error of 1e-3 for int8
and 1e-2 for fp8.  Both versions follow the same online loop, so the
error is ~3e-7 until a 1-ulp difference between torch's and XLA's exp
flips one rounded P code: that moves one p of one row by 1/127 (int8) or
by up to one e4m3 step, 1/16 of it (fp8; 4.1e-3 seen at prefix_len=48).
The CUDA kernel itself runs only on a card: the ``cuda``-marked tests
skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as jrouter
from repro.core.quant import smooth_k as jsmooth_k
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sla2_fwd import sparse_flash_fwd as jfwd
from repro_torch.core import router as trouter
from repro_torch.core.quant import smooth_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.sla2_fwd import (sparse_flash_fwd,
                                          sparse_flash_fwd_plain)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [  # (bh, n, d, bq, bk, k_frac), as in tests/test_kernels.py
    (2, 256, 64, 32, 16, 0.3),
    (1, 256, 128, 64, 32, 0.2),
    (3, 128, 32, 16, 16, 0.5),
]
BOUND = {"none": 2e-5, "int8": 1e-3, "fp8": 1e-2}   # relative max error


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _case(shape, causal, seed=0):
    bh, n, d, bq, bk, kf = shape
    q, k, v = (_rand((bh, n, d), seed + i) for i in range(3))
    idx, valid = jrouter.route_indices(
        {}, jnp.asarray(q), jnp.asarray(k),
        jrouter.RouterConfig(block_q=bq, block_k=bk, k_frac=kf,
                             causal=causal))
    return q, k, v, np.array(idx), np.array(valid).astype(np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _check(shape, causal, quant, **extra):
    q, k, v, idx, valid = _case(shape, causal)
    if quant != "none":
        k = np.array(jsmooth_k(jnp.asarray(k)))
    bq, bk = shape[3], shape[4]
    kw = dict(block_q=bq, block_k=bk, causal=causal, quant_bits=quant,
              **extra)
    jo, jl = jfwd(*(jnp.asarray(a) for a in (q, k, v, idx, valid)),
                  interpret=True, **kw)
    to, tl = sparse_flash_fwd_plain(*_torch(q, k, v, idx, valid), **kw)
    jo, jl = np.asarray(jo), np.asarray(jl)
    if quant == "none":
        np.testing.assert_allclose(to.numpy(), jo, atol=2e-5, rtol=2e-5)
    else:
        assert _rel(to.numpy(), jo) < BOUND[quant]
    np.testing.assert_allclose(tl.numpy(), jl, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:5])))
def test_plain_matches_pallas(shape, causal, quant):
    _check(shape, causal, quant)


@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
@pytest.mark.parametrize("extra", [{"kv_len": 251}, {"prefix_len": 48}],
                         ids=["kv_len", "prefix_len"])
def test_plain_matches_pallas_ragged_and_prefix(extra, quant):
    _check(SHAPES[0], "prefix_len" in extra, quant, **extra)


def test_plain_bf16_matches_pallas():
    q, k, v, idx, valid = _case(SHAPES[0], False)
    kw = dict(block_q=32, block_k=16, causal=False, quant_bits="int8")
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    jo, _ = jfwd(*jb, jnp.asarray(idx), jnp.asarray(valid), interpret=True,
                 **kw)
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
          for a in jb]
    to, _ = sparse_flash_fwd_plain(*tb, *_torch(idx, valid), **kw)
    assert to.dtype == torch.bfloat16
    # outputs round to bf16: allow two bf16 ulps (2 * 2^-8) relative
    assert _rel(to.float().numpy(), np.asarray(jo, np.float32)) < 2 ** -7


def test_wrapper_on_cpu_takes_plain_and_checks_inputs():
    q, k, v, idx, valid = _torch(*_case(SHAPES[2], False))
    before = sparse_flash_fwd.launches
    kw = dict(block_q=16, block_k=16, causal=False)
    o, lse = sparse_flash_fwd(q, k, v, idx, valid, **kw)
    po, pl = sparse_flash_fwd_plain(q, k, v, idx, valid, **kw)
    assert torch.equal(o, po) and torch.equal(lse, pl)
    assert sparse_flash_fwd.launches == before
    with pytest.raises(ValueError, match="int32"):
        sparse_flash_fwd(q, k, v, idx.long(), valid, **kw)
    with pytest.raises(ValueError, match="multiples"):
        sparse_flash_fwd(q, k, v, idx, valid, block_q=24, block_k=16,
                         causal=False)
    with pytest.raises(ValueError, match="dtype"):
        sparse_flash_fwd(q.double(), k, v, idx, valid, **kw)


# ---------------------------------------------------------------------------
# dense oracles and tile helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("causal", [False, True])
def test_sparse_flash_ref_matches_jax_and_plain(causal, quant):
    q, k, v, idx, valid = _case(SHAPES[0], causal)
    kw = dict(block_q=32, block_k=16, causal=causal, quant_bits=quant,
              kv_len=250)
    jo, jl = jref.sparse_flash_ref(*(jnp.asarray(a) for a in
                                     (q, k, v, idx, valid)), **kw)
    tq, tk, tv, ti, tvl = _torch(q, k, v, idx, valid)
    to, tl = tref.sparse_flash_ref(tq, tk, tv, ti, tvl, **kw)
    assert _rel(to.numpy(), np.asarray(jo)) < (2e-5 if quant == "none"
                                               else 1e-3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)
    if quant == "none":   # the kernel's loop and the dense oracle agree
        po, pl = sparse_flash_fwd_plain(tq, tk, tv, ti, tvl, **kw)
        np.testing.assert_allclose(po.numpy(), to.numpy(), atol=2e-5)
        np.testing.assert_allclose(pl.numpy(), tl.numpy(), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_linear_branch_ref_and_combine_match_jax(causal):
    q, k, v, idx, valid = _case(SHAPES[0], causal)
    kw = dict(block_q=32, block_k=16, causal=causal)
    j = [jnp.asarray(a) for a in (q, k, v, idx, valid)]
    t = _torch(q, k, v, idx, valid)
    np.testing.assert_array_equal(
        np.asarray(jref.mask_from_indices(j[3], j[4], 16)),
        tref.mask_from_indices(t[3], t[4], 16).numpy())
    jo, jd = jref.linear_branch_ref(*j, **kw)
    to, td = tref.linear_branch_ref(*t, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=5e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=5e-5,
                               rtol=5e-5)
    alpha = np.random.default_rng(3).random((2, 256, 1)).astype(np.float32)
    np.testing.assert_allclose(
        tref.combine_ref(t[2], to, td, torch.from_numpy(alpha)).numpy(),
        np.asarray(jref.combine_ref(j[2], jo, jd, jnp.asarray(alpha))),
        atol=5e-5)


@pytest.mark.parametrize("bits", ["int8", "fp8"])
def test_quantize_tile_and_qdot_match_jax(bits):
    a, b = _rand((32, 16), 1), _rand((8, 16), 2)
    ja, jas = jops.quantize_tile(jnp.asarray(a), bits)
    jb, jbs = jops.quantize_tile(jnp.asarray(b), bits)
    ta, tas = tops.quantize_tile(torch.from_numpy(a), bits)
    tb, tbs = tops.quantize_tile(torch.from_numpy(b), bits)
    np.testing.assert_array_equal(np.asarray(ja.astype(jnp.float32)),
                                  ta.float().numpy())
    np.testing.assert_array_equal(float(jas), float(tas))
    jout = jops.qdot(ja, jas, jb, jbs, transpose_b=True)
    tout = tops.qdot(ta, tas, tb, tbs, transpose_b=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_sla2_block_sparse_matches_jax(quant):
    """The kernel-mode operator (router -> sparse kernel -> linear branch
    -> alpha combine), including the LSE it returns in aux."""
    from repro.core.sla2 import SLA2Config as JCfg
    from repro_torch.convert import sla2_params_from_numpy
    from repro_torch.core.sla2 import SLA2Config as TCfg
    b, h, n, d = 2, 2, 128, 32
    q, k, v = (_rand((b, h, n, d), s) for s in range(3))
    tree = {"alpha_logit": _rand((h, 4), 7, 1.0)}
    kw = dict(block_q=32, block_k=16, k_frac=0.3)
    jo, jaux = jops.sla2_block_sparse(
        {"alpha_logit": jnp.asarray(tree["alpha_logit"])},
        *(jnp.asarray(a) for a in (q, k, v)),
        JCfg(router=jrouter.RouterConfig(learnable=False, **kw),
             quant_bits=quant, impl="kernel"))
    tp = sla2_params_from_numpy(tree, device="cpu")
    with torch.no_grad():
        to, taux = tops.sla2_block_sparse(
            tp, *_torch(q, k, v),
            TCfg(router=trouter.RouterConfig(learnable=False, **kw),
                 quant_bits=quant, impl="kernel"))
    np.testing.assert_array_equal(taux["idx"].numpy(), np.asarray(jaux["idx"]))
    if quant == "none":
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=5e-5)
    else:
        assert _rel(to.numpy(), np.asarray(jo)) < 1e-3
    np.testing.assert_allclose(taux["lse"].numpy(), np.asarray(jaux["lse"]),
                               atol=2e-5)


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
def test_cuda_kernel_matches_plain(quant):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    q, k, v, idx, valid = (t.cuda() for t in _torch(*_case(SHAPES[0], True)))
    if quant != "none":
        k = smooth_k(k).contiguous()
    kw = dict(block_q=32, block_k=16, causal=True, quant_bits=quant,
              prefix_len=16, kv_len=250)
    before = sparse_flash_fwd.launches
    o, lse = sparse_flash_fwd(q, k, v, idx, valid, **kw)
    torch.cuda.synchronize()
    assert sparse_flash_fwd.launches == before + 1
    po, pl = sparse_flash_fwd_plain(q, k, v, idx, valid, **kw)
    assert _rel(o.cpu().numpy(), po.cpu().numpy()) < BOUND[quant]
    np.testing.assert_allclose(lse.cpu().numpy(), pl.cpu().numpy(), atol=1e-4)
