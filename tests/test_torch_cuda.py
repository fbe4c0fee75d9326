"""The port's CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor the reference package, so it runs on a
machine with a card and PyTorch alone (``--noconftest`` skips
tests/conftest.py, which imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Every test needs an NVIDIA card (the kernels have no CPU mode) and skips
without one.  Bounds: 1e-4 relative max error in f32 and 2^-7 (two bf16
ulps) in bf16 for the backward, whose sums run in another order than the
plain version's; the int8 forward equals its plain version bit for bit on
the card (PERF.md), bounded here by 1e-3.
"""
import pytest
import torch

from repro_torch.core import router as R
from repro_torch.core.quant import smooth_k
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sla2_bwd import sparse_flash_bwd, sparse_flash_bwd_plain
from repro_torch.kernels.sla2_fwd import sparse_flash_fwd, sparse_flash_fwd_plain

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,prefix_len,k_frac", [
    ((2, 256, 64, 32, 16), True, 48, 0.5),
    ((3, 1024, 128, 128, 64), False, 0, 0.1),
    ((2, 512, 64, 64, 32), True, 0, 0.5)])
def test_bwd_kernels_match_plain(card, shape, causal, prefix_len, k_frac,
                                 dtype):
    q, k, v, do, idx, valid = _case(card, shape, getattr(torch, dtype),
                                    causal, prefix_len, k_frac)
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
