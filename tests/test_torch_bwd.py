"""The port's sparse-branch backward against the JAX reference.

``sparse_flash_bwd_plain`` (the PyTorch version of the two CUDA kernels,
and what the wrapper runs on a CPU tensor) is held to the Pallas backward
run in interpret mode, on the same q, k, v, dO and the same forward o and
LSE: atol 5e-5, rtol 5e-4, the reference's own bound between its kernel
and its oracle (tests/test_kernels.py:117).  ``manual_backward`` is held
to its JAX twin, ``sort_pairs`` must be equal, and autograd through the
port's ``sparse_attention_op`` is held to ``jax.grad`` through the
reference's custom VJP: 5e-5 for quant 'none'; for int8 a relative max
error of 1e-3, since one flipped P code moves the forward's LSE.  The
CUDA kernels run only on a card: their tests are in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as jrouter
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sla2_bwd import sort_pairs as jsort_pairs
from repro.kernels.sla2_bwd import sparse_flash_bwd as jbwd
from repro.kernels.sla2_fwd import sparse_flash_fwd as jfwd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.sla2_bwd import (segment_offsets, sort_pairs,
                                          sparse_flash_bwd,
                                          sparse_flash_bwd_plain)
from repro_torch.kernels.sla2_fwd import sparse_flash_fwd_plain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [  # (bh, n, d, bq, bk, k_frac), as in tests/test_kernels.py
    (2, 256, 64, 32, 16, 0.3),
    (1, 256, 128, 64, 32, 0.2),
    (3, 128, 32, 16, 16, 0.5),
]


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _case(shape, causal, prefix_len=0, seed=0):
    """q, k, v, dO, idx, valid, and the reference forward's o and lse."""
    bh, n, d, bq, bk, kf = shape
    q, k, v, do = (_rand((bh, n, d), seed + i) for i in range(4))
    idx, valid = jrouter.route_indices(
        {}, jnp.asarray(q), jnp.asarray(k),
        jrouter.RouterConfig(block_q=bq, block_k=bk, k_frac=kf,
                             causal=causal, prefix_len=prefix_len))
    idx, valid = np.array(idx), np.array(valid).astype(np.int32)
    o, lse = jfwd(*(jnp.asarray(a) for a in (q, k, v, idx, valid)),
                  block_q=bq, block_k=bk, causal=causal,
                  prefix_len=prefix_len, interpret=True)
    return q, k, v, do, idx, valid, np.asarray(o), np.asarray(lse)


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


BWD_CASES = ([(s, c, 0) for s in SHAPES for c in (False, True)]
             + [(SHAPES[0], True, 48)])


@pytest.mark.parametrize(
    "shape,causal,prefix_len", BWD_CASES,
    ids=lambda x: "x".join(map(str, x[:5])) if isinstance(x, tuple) else str(x))
def test_plain_matches_pallas(shape, causal, prefix_len):
    case = _case(shape, causal, prefix_len)
    kw = dict(block_q=shape[3], block_k=shape[4], causal=causal,
              prefix_len=prefix_len)
    want = jbwd(*(jnp.asarray(a) for a in (case[0], case[1], case[2],
                                            case[4], case[5], case[6],
                                            case[7], case[3])),
                interpret=True, **kw)
    q, k, v, do, idx, valid, o, lse = _torch(*case)
    got = sparse_flash_bwd_plain(q, k, v, idx, valid, o, lse, do, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=5e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_manual_backward_matches_jax_and_plain(causal):
    case = _case(SHAPES[0], causal)
    q, k, v, do, idx, valid, o, lse = case
    kw = dict(block_q=32, block_k=16, causal=causal)
    want = jref.manual_backward(*(jnp.asarray(a) for a in
                                  (q, k, v, idx, valid, o, lse, do)), **kw)
    t = _torch(q, k, v, idx, valid, o, lse, do)
    got = tref.manual_backward(*t, **kw)
    plain = sparse_flash_bwd_plain(*t, **kw)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=5e-4)
        np.testing.assert_allclose(p.numpy(), g.numpy(), atol=5e-5,
                                   rtol=5e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_sort_pairs_and_offsets(causal):
    _, _, _, _, idx, valid, _, _ = _case(SHAPES[2], causal)
    want = jsort_pairs(jnp.asarray(idx), jnp.asarray(valid))
    got = sort_pairs(*_torch(idx, valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    js = got[0]
    off = segment_offsets(js, 128 // 16)
    for b in range(js.shape[0]):
        for j in range(8):
            run = js[b, off[b, j]:off[b, j + 1]]
            assert (run == j).all()
            assert int((js[b] == j).sum()) == len(run)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_autograd_op_matches_jax_grad(quant):
    """d/d(q, k, v) of sum(O_s * W) through the kernel-mode op."""
    bh, n, d, bq, bk, kf = SHAPES[0]
    q, k, v, w = (_rand((bh, n, d), s) for s in range(4))
    idx, valid = jrouter.route_indices(
        {}, jnp.asarray(q), jnp.asarray(k),
        jrouter.RouterConfig(block_q=bq, block_k=bk, k_frac=kf))
    idx, valid = np.array(idx), np.array(valid)

    def jloss(q_, k_, v_):
        o, _ = jops.sparse_attention_op(q_, k_, v_, jnp.asarray(idx),
                                        jnp.asarray(valid), bq, bk, False,
                                        quant)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(jloss, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    o, lse = tops.sparse_attention_op(tq, tk, tv, *_torch(idx, valid), bq, bk,
                                      False, quant)
    assert not lse.requires_grad
    torch.sum(o * torch.from_numpy(w)).backward()
    for g, want_g in zip((tq.grad, tk.grad, tv.grad), want):
        if quant == "none":
            np.testing.assert_allclose(g.numpy(), np.asarray(want_g),
                                       atol=5e-5, rtol=5e-4)
        else:
            assert _rel(g.numpy(), want_g) < 1e-3


def test_wrapper_on_cpu_takes_plain_and_checks_inputs():
    case = _torch(*_case(SHAPES[2], False))
    q, k, v, do, idx, valid, o, lse = case
    before = (sparse_flash_bwd.launches_dq, sparse_flash_bwd.launches_dkv)
    kw = dict(block_q=16, block_k=16, causal=False)
    got = sparse_flash_bwd(q, k, v, idx, valid, o, lse, do, **kw)
    want = sparse_flash_bwd_plain(q, k, v, idx, valid, o, lse, do, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (sparse_flash_bwd.launches_dq,
            sparse_flash_bwd.launches_dkv) == before
    with pytest.raises(ValueError, match="int32"):
        sparse_flash_bwd(q, k, v, idx.long(), valid, o, lse, do, **kw)
    with pytest.raises(ValueError, match="lse"):
        sparse_flash_bwd(q, k, v, idx, valid, o, lse[:, :-1], do, **kw)
    with pytest.raises(ValueError, match="dtype"):
        sparse_flash_bwd(q.double(), k, v, idx, valid, o, lse, do, **kw)


def test_bf16_plain_rounds_outputs_once():
    """bf16 in, bf16 out: the plain version's f32 sums agree with the f32
    run on the same bf16 values to within one rounding (2^-8 relative)."""
    q, k, v, do, idx, valid, _, _ = _torch(*_case(SHAPES[0], False))
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    kw = dict(block_q=32, block_k=16, causal=False)
    o, lse = sparse_flash_fwd_plain(q, k, v, idx, valid, **kw)
    got = sparse_flash_bwd_plain(q, k, v, idx, valid, o, lse, do, **kw)
    ref = sparse_flash_bwd_plain(q.float(), k.float(), v.float(), idx, valid,
                                 o.float(), lse, do.float(), **kw)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float().numpy(), r.numpy()) <= 2 ** -8
