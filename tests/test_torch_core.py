"""Parity of the port's core SLA2 math (repro_torch.core) with the JAX
reference (repro.core) on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
torch branch tests take JAX's ``idx``/``valid``; routing itself is held to
exact equality on tie-free inputs.  Tolerances: 5e-5 for the fp32 branches
(the reference's gather/kernel bound, tests/test_kernels.py), exact for
masks and integer codes, and a relative max error of 1e-3 where an int8 or
fp8 code can flip on a 1-ulp difference in float order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jattn
from repro.core import block_sparse as jbs
from repro.core import masks as jmasks
from repro.core import quant as jquant
from repro.core import router as jrouter
from repro.core import sla2 as jsla2
from repro_torch.convert import sla2_params_from_numpy
from repro_torch.core import attention as tattn
from repro_torch.core import block_sparse as tbs
from repro_torch.core import masks as tmasks
from repro_torch.core import quant as tquant
from repro_torch.core import router as trouter
from repro_torch.core import sla2 as tsla2
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(a, b):
    a, b = _np(a).astype(np.float32), _np(b).astype(np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


def _rc(mod, **kw):
    return mod.RouterConfig(**kw)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,args", [
    ("block_causal_mask", (8, 16, 32, 16)),
    ("block_causal_mask", (8, 16, 32, 16, 40)),
    ("block_diagonal_mask", (8, 16, 32, 16)),
    ("block_diagonal_mask", (8, 16, 32, 16, 40)),
    ("token_causal_mask", (24, 40, 5, 7)),
    ("sliding_window_block_mask", (8, 16, 32, 16, 70)),
])
def test_structural_masks_equal(fn, args):
    np.testing.assert_array_equal(_np(getattr(jmasks, fn)(*args)),
                                  _np(getattr(tmasks, fn)(*args)))


def test_expand_mask_and_sparsity_equal():
    m = (np.random.default_rng(0).random((2, 4, 8)) > 0.6).astype(np.float32)
    (jm,), (tm,) = _both(m)
    np.testing.assert_array_equal(_np(jmasks.expand_mask(jm, 4, 2)),
                                  _np(tmasks.expand_mask(tm, 4, 2)))
    allowed = np.tril(np.ones((4, 8), bool), 3)
    (ja,), (ta,) = _both(allowed)
    np.testing.assert_allclose(_np(jmasks.mask_sparsity(jm)),
                               _np(tmasks.mask_sparsity(tm)), atol=1e-7)
    np.testing.assert_allclose(_np(jmasks.mask_sparsity(jm, ja)),
                               _np(tmasks.mask_sparsity(tm, ta)), atol=1e-7)


@pytest.mark.parametrize("causal", [False, True])
def test_topk_block_mask_equal_tie_free(causal):
    scores = _rand((2, 8, 16), 3)            # continuous: no ties
    allowed = force = None
    if causal:
        allowed = np.array(jmasks.block_causal_mask(8, 16, 32, 16))
        force = np.array(jmasks.block_diagonal_mask(8, 16, 32, 16))
    jm = jmasks.topk_block_mask(
        jnp.asarray(scores), 5,
        allowed=None if allowed is None else jnp.asarray(allowed),
        force=None if force is None else jnp.asarray(force))
    tm = tmasks.topk_block_mask(
        torch.from_numpy(scores), 5,
        allowed=None if allowed is None else torch.from_numpy(allowed),
        force=None if force is None else torch.from_numpy(force))
    np.testing.assert_array_equal(_np(jm), _np(tm))


# ---------------------------------------------------------------------------
# quantisation
# ---------------------------------------------------------------------------

def test_smooth_k_and_int8_codes_equal():
    x = _rand((3, 4, 16, 8), 1)
    (jx,), (tx,) = _both(x)
    np.testing.assert_allclose(_np(jquant.smooth_k(jx)),
                               _np(tquant.smooth_k(tx)), atol=1e-7)
    jq, tq = jquant.quant_int8(jx), tquant.quant_int8(tx)
    np.testing.assert_array_equal(_np(jq.values), _np(tq.values))
    np.testing.assert_array_equal(_np(jq.scale), _np(tq.scale))
    np.testing.assert_array_equal(_np(jquant.dequant(jq)),
                                  _np(tquant.dequant(tq)))


def test_fp8_codes_equal():
    x = _rand((3, 16, 8), 2)
    (jx,), (tx,) = _both(x)
    jq, tq = jquant.quant_fp8(jx), tquant.quant_fp8(tx)
    np.testing.assert_array_equal(_np(jq.values.astype(jnp.float32)),
                                  _np(tq.values.to(torch.float32)))
    np.testing.assert_array_equal(_np(jq.scale), _np(tq.scale))


@pytest.mark.parametrize("bits", ["none", "int8", "fp8"])
def test_fake_quant_forward_equal_backward_identity(bits):
    x = _rand((2, 16, 8), 4)
    (jx,), (tx,) = _both(x)
    np.testing.assert_array_equal(_np(jquant.fake_quant(jx, bits)),
                                  _np(tquant.fake_quant(tx, bits)))
    tx.requires_grad_(True)
    g = torch.from_numpy(_rand((2, 16, 8), 5))
    tquant.fake_quant(tx, bits).backward(g)
    np.testing.assert_array_equal(_np(tx.grad), _np(g))


# ---------------------------------------------------------------------------
# O(N^2) attention oracles
# ---------------------------------------------------------------------------

def _qkv(b=2, h=2, n=64, d=16, seed=0):
    return [_rand((b, h, n, d), seed + i) for i in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_equal(causal):
    (jq, jk, jv), (tq, tk, tv) = _both(*_qkv())
    np.testing.assert_allclose(
        _np(jattn.full_attention(jq, jk, jv, causal=causal, prefix_len=8)),
        _np(tattn.full_attention(tq, tk, tv, causal=causal, prefix_len=8)),
        atol=5e-6)


@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
@pytest.mark.parametrize("causal", [False, True])
def test_sparse_and_linear_attention_equal(quant, causal):
    q, k, v = _qkv()
    mask = (np.random.default_rng(9).random((2, 2, 4, 8)) > 0.5).astype(
        np.float32)
    mask[..., 0] = 1.0
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(q, k, v, mask)
    kw = dict(block_q=16, block_k=8, causal=causal)
    js = jattn.sparse_attention(jq, jk, jv, jm, quant_bits=quant, **kw)
    ts = tattn.sparse_attention(tq, tk, tv, tm, quant_bits=quant, **kw)
    assert _rel(ts, js) < (5e-5 if quant == "none" else 1e-3)
    np.testing.assert_allclose(
        _np(jattn.linear_attention(jq, jk, jv, jm, **kw)),
        _np(tattn.linear_attention(tq, tk, tv, tm, **kw)), atol=5e-6)


def test_phi_and_block_kv_states_equal():
    q, k, v = _qkv()
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    np.testing.assert_allclose(_np(jattn.phi(jq)), _np(tattn.phi(tq)),
                               atol=1e-7)
    jh, jz = jattn.block_kv_states(jk, jv, block_k=8)
    th, tz = tattn.block_kv_states(tk, tv, block_k=8)
    np.testing.assert_allclose(_np(jh), _np(th), atol=5e-6)
    np.testing.assert_allclose(_np(jz), _np(tz), atol=5e-6)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

def _router_tree(d, seed=11):
    eye = np.eye(d, dtype=np.float32)
    return {"proj_q": eye + _rand((d, d), seed, 0.05),
            "proj_k": eye + _rand((d, d), seed + 1, 0.05)}


def _sla2_pair(h, t_m, d, seed=11):
    tree = {"router": _router_tree(d, seed),
            "alpha_logit": _rand((h, t_m), seed + 2, 1.0)}
    jp = {"router": {k: jnp.asarray(v) for k, v in tree["router"].items()},
          "alpha_logit": jnp.asarray(tree["alpha_logit"])}
    return jp, sla2_params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("causal,bq,bk", [
    (False, 32, 16), (True, 16, 16), (True, 32, 16)])
def test_route_indices(causal, bq, bk):
    """Exact idx/valid wherever the inputs are tie-free.  With causal
    bq > bk a row forces several diagonal blocks to +inf, a tie whose
    order (and so the index padding entries repeat) differs between
    jax.lax.top_k and torch.topk; there the routed SET must agree."""
    bh, n, d = 3, 128, 16
    q, k = _rand((bh, n, d), 0), _rand((bh, n, d), 1)
    jp, tp = _sla2_pair(1, 1, d)
    (jq, jk), (tq, tk) = _both(q, k)
    kw = dict(block_q=bq, block_k=bk, k_frac=0.3, causal=causal)
    jidx, jval = jrouter.route_indices(jp["router"], jq, jk,
                                       _rc(jrouter, **kw))
    tidx, tval = trouter.route_indices(tp.router, tq, tk, _rc(trouter, **kw))
    assert tidx.dtype == torch.int32 and tval.dtype == torch.bool
    from repro.kernels.ref import mask_from_indices
    t_n = n // bk
    np.testing.assert_array_equal(
        _np(mask_from_indices(jidx, jval, t_n)),
        _np(mask_from_indices(jnp.asarray(_np(tidx)),
                              jnp.asarray(_np(tval)), t_n)))
    if not (causal and bq > bk):
        np.testing.assert_array_equal(_np(jidx), _np(tidx))
        np.testing.assert_array_equal(_np(jval), _np(tval))
    np.testing.assert_array_equal(_np(jrouter.route(
        jp["router"], jq, jk, _rc(jrouter, **kw))), _np(trouter.route(
            tp.router, tq, tk, _rc(trouter, **kw))))


def test_router_scores_and_pool_equal():
    q, k = _rand((2, 64, 16), 0), _rand((2, 64, 16), 1)
    jp, tp = _sla2_pair(1, 1, 16)
    (jq, jk), (tq, tk) = _both(q, k)
    np.testing.assert_allclose(_np(jrouter.pool_blocks(jq, 16)),
                               _np(trouter.pool_blocks(tq, 16)), atol=1e-7)
    for causal in (False, True):
        kw = dict(block_q=16, block_k=8, causal=causal)
        np.testing.assert_allclose(
            _np(jrouter.router_scores(jp["router"], jq, jk,
                                      _rc(jrouter, **kw))),
            _np(trouter.router_scores(tp.router, tq, tk,
                                      _rc(trouter, **kw))), atol=1e-6)


# ---------------------------------------------------------------------------
# gather path (JAX's idx/valid fed to both)
# ---------------------------------------------------------------------------

def _routed(bh=4, n=128, d=32, bq=32, bk=16, k_frac=0.3, causal=False):
    q, k, v = (_rand((bh, n, d), s) for s in range(3))
    jidx, jval = jrouter.route_indices(
        {}, jnp.asarray(q), jnp.asarray(k),
        jrouter.RouterConfig(block_q=bq, block_k=bk, k_frac=k_frac,
                             causal=causal))
    return q, k, v, np.asarray(jidx), np.asarray(jval)


@pytest.mark.parametrize("causal", [False, True])
def test_linear_branch_equal(causal):
    q, k, v, idx, valid = _routed(causal=causal)
    (jq, jk, jv, ji, jvl), (tq, tk, tv, ti, tvl) = _both(q, k, v, idx, valid)
    kw = dict(block_q=32, block_k=16, causal=causal, prefix_len=0)
    jo, jd = jbs.linear_branch(jq, jk, jv, ji, jvl, **kw)
    to, td = tbs.linear_branch(tq, tk, tv, ti, tvl, **kw)
    np.testing.assert_allclose(_np(jo), _np(to), atol=5e-5)
    np.testing.assert_allclose(_np(jd), _np(td), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
@pytest.mark.parametrize("causal", [False, True])
def test_gather_sparse_attention_equal(quant, causal):
    q, k, v, idx, valid = _routed(causal=causal)
    (jq, jk, jv, ji, jvl), (tq, tk, tv, ti, tvl) = _both(q, k, v, idx, valid)
    kw = dict(block_q=32, block_k=16, causal=causal, quant_bits=quant,
              q_chunk=3)
    jo = jbs.gather_sparse_attention(jq, jk, jv, ji, jvl, **kw)
    to = tbs.gather_sparse_attention(tq, tk, tv, ti, tvl, **kw)
    assert _rel(to, jo) < (5e-5 if quant == "none" else 1e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_sla2_gather_equal(causal):
    q, k, v, idx, valid = _routed(causal=causal)
    alpha = np.random.default_rng(5).random((4, 128, 1)).astype(np.float32)
    (jq, jk, jv, ji, jvl, ja), (tq, tk, tv, ti, tvl, ta) = _both(
        q, k, v, idx, valid, alpha)
    kw = dict(block_q=32, block_k=16, causal=causal, quant_bits="none")
    np.testing.assert_allclose(
        _np(jbs.sla2_gather(ja, jq, jk, jv, ji, jvl, **kw)),
        _np(tbs.sla2_gather(ta, tq, tk, tv, ti, tvl, **kw)), atol=5e-5)


# ---------------------------------------------------------------------------
# the SLA2 operator, three implementations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "gather", "kernel"])
@pytest.mark.parametrize("causal", [False, True])
def test_sla2_attention_equal(impl, causal):
    b, h, n, d, bq, bk = 2, 2, 128, 32, 32, 16
    q, k, v = (_rand((b, h, n, d), s) for s in range(3))
    jp, tp = _sla2_pair(h, n // bq, d)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    kw = dict(block_q=bq, block_k=bk, k_frac=0.3, causal=causal)
    jo = jsla2.sla2_attention(jp, jq, jk, jv, jsla2.SLA2Config(
        router=_rc(jrouter, **kw), quant_bits="none", impl=impl, q_chunk=3))
    with torch.no_grad():
        to = tsla2.sla2_attention(tp, tq, tk, tv, tsla2.SLA2Config(
            router=_rc(trouter, **kw), quant_bits="none", impl=impl,
            q_chunk=3))
    np.testing.assert_allclose(_np(jo), _np(to), atol=5e-5)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_sla2_attention_int8_close(impl):
    b, h, n, d = 2, 2, 128, 32
    q, k, v = (_rand((b, h, n, d), s) for s in range(3))
    jp, tp = _sla2_pair(h, 4, d)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    kw = dict(block_q=32, block_k=16, k_frac=0.3)
    jo = jsla2.sla2_attention(jp, jq, jk, jv, jsla2.SLA2Config(
        router=_rc(jrouter, **kw), quant_bits="int8", impl=impl))
    with torch.no_grad():
        to, aux = tsla2.sla2_attention(tp, tq, tk, tv, tsla2.SLA2Config(
            router=_rc(trouter, **kw), quant_bits="int8", impl=impl),
            return_aux=True)
    assert _rel(to, jo) < 1e-3
    assert aux["mask_c"].shape == (b, h, 4, 8)
    assert float(aux["sparsity"].mean()) == pytest.approx(1 - 2 / 8)
