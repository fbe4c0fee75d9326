"""The arithmetic of the port's bf16 tensor-core backward against the JAX
reference.

On bf16 operands ``sla2_bwd_dq_tc`` and ``sla2_bwd_dkv_tc``
(csrc/sla2_bwd.cu) form S = Q K^T and dP = dO V^T from the bf16 tiles with
f32 sums, P and dS in f32, and take P and dS into dQ += dS K,
dV += P^T dO and dK += dS^T Q as bf16 terms (hi = bf16(x),
lo = bf16(x - hi)), each multiplied by its bf16 partner.  bf16 x bf16
products are exact in f32, so ``emulated_bwd`` below, the plain backward
with P and dS cut to those terms, computes what the kernels compute up to
the order of f32 sums.  It is held here to JAX's ``sparse_flash_bwd`` (the
Pallas kernels in interpret mode) on bf16 inputs made from a numpy seed,
within 2^-7 relative max error on the bf16 outputs (two bf16 ulps, the
card's bound between kernel and plain version), over causal and prefix
masks, invalid padding entries, kv blocks no valid pair visits and a hot kv
block that every query block routes.  The card runs the kernels themselves
(tests/test_torch_cuda.py).

Before the outputs' rounding, against the same backward in f32
(``test_two_terms_hold_f32``), the largest relative error of these cases
was 2.502e-3 with one term and 5.026e-6 with two (the worst of dQ, dK,
dV).  One term alone (the usual GPU practice) rounds P and dS to bf16, an
error of the size of the outputs' own rounding, which the reference's
full-precision backward does not have.  Two terms are what the kernels
ship.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as jrouter
from repro.kernels.sla2_bwd import sparse_flash_bwd as jbwd
from repro.kernels.sla2_fwd import sparse_flash_fwd as jfwd
from repro_torch.kernels import sla2_bwd as B
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TERMS = 2                                   # as csrc/sla2_bwd.cu


def bf16_terms(x: torch.Tensor, n: int) -> torch.Tensor:
    """x as the f32 sum of n bf16 terms: bf16(x), bf16(x - t0), ..."""
    out, r = torch.zeros_like(x), x
    for _ in range(n):
        t = r.to(torch.bfloat16).to(torch.float32)
        out, r = out + t, r - t
    return out


def emulated_bwd(q, k, v, idx, valid, o, lse, do, *, block_q, block_k,
                 causal, prefix_len=0, terms=TERMS, out_dtype=None):
    """(dq, dk, dv) as the tensor-core kernels compute them, in
    ``out_dtype`` (q's dtype by default)."""
    bh, n_q, d = q.shape
    n_kv = k.shape[1]
    t_m, t_n = n_q // block_q, n_kv // block_k
    scale = 1.0 / d ** 0.5
    qb, dob, kb, vb, lse_b, dd_b = B._tiles(q, k, v, o, lse, do, block_q,
                                            block_k)
    dq = torch.zeros(bh, t_m, block_q, d)
    dk = torch.zeros(bh, t_n, block_k, d)
    dv = torch.zeros_like(dk)
    for b in range(bh):
        for i in range(t_m):
            rows = i * block_q + torch.arange(block_q)
            for jj in range(idx.shape[-1]):
                if int(valid[b, i, jj]) != 1:
                    continue
                j = int(idx[b, i, jj])
                cols = j * block_k + torch.arange(block_k)
                p = B._probs(qb[b, i], kb[b, j], lse_b[b, i], rows, cols,
                             sm_scale=scale, causal=causal,
                             prefix_len=prefix_len)
                dp = dob[b, i] @ vb[b, j].T
                ds = p * (dp - dd_b[b, i][:, None]) * scale
                p_t, ds_t = bf16_terms(p, terms), bf16_terms(ds, terms)
                dq[b, i] += ds_t @ kb[b, j]
                dv[b, j] += p_t.T @ dob[b, i]
                dk[b, j] += ds_t.T @ qb[b, i]
    out = out_dtype or q.dtype
    return (dq.reshape(bh, n_q, d).to(out), dk.reshape(bh, n_kv, d).to(out),
            dv.reshape(bh, n_kv, d).to(out))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _rand(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape) * 0.5
    return torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))


@functools.lru_cache(maxsize=None)
def _case(shape, causal, prefix_len, k_frac, hot, dtype="bfloat16", seed=0):
    """q, k, v, dO in ``dtype``; routing (with kv block ``hot`` forced into
    every row); the reference forward's o (in ``dtype``) and lse."""
    bh, n, d, bq, bk = shape
    q, k, v, do = (_rand(seed + s, (bh, n, d), dtype) for s in range(4))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), getattr(jnp, dtype))
                  for t in (q, k, v))
    idx, valid = jrouter.route_indices(
        {}, jq.astype(jnp.float32), jk.astype(jnp.float32),
        jrouter.RouterConfig(block_q=bq, block_k=bk, k_frac=k_frac,
                             causal=causal, prefix_len=prefix_len))
    idx, valid = np.array(idx), np.array(valid).astype(np.int32)
    if hot is not None:
        has = ((idx == hot) & (valid == 1)).any(-1)
        idx[..., -1] = np.where(has, idx[..., -1], hot)
        valid[..., -1] = np.where(has, valid[..., -1], 1)
    o, lse = jfwd(jq, jk, jv, jnp.asarray(idx), jnp.asarray(valid),
                  block_q=bq, block_k=bk, causal=causal,
                  prefix_len=prefix_len, interpret=True)
    o = torch.from_numpy(np.array(o.astype(jnp.float32))).to(q.dtype)
    return (q, k, v, do, torch.from_numpy(idx), torch.from_numpy(valid), o,
            torch.from_numpy(np.array(lse)))


CASES = {  # shape (bh, n, d, bq, bk), causal, prefix_len, k_frac, hot
    "causal": ((2, 256, 64, 32, 16), True, 0, 0.3, None),
    "prefix": ((2, 256, 64, 32, 16), True, 48, 0.3, None),
    "main_tiling": ((1, 512, 128, 128, 64), False, 0, 0.25, None),
    "hot_block": ((1, 1024, 32, 64, 32), False, 0, 0.1, 5),
    "hot_causal": ((1, 512, 32, 32, 16), True, 0, 0.2, 2),
}


def _kw_of(case):
    shape, causal, prefix_len, _, _ = case
    return dict(block_q=shape[3], block_k=shape[4], causal=causal,
                prefix_len=prefix_len)


def _kw(name):
    return _kw_of(CASES[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_matches_pallas(name):
    q, k, v, do, idx, valid, o, lse = _case(*CASES[name])
    kw = _kw(name)
    want = jbwd(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v)), jnp.asarray(idx.numpy()),
                jnp.asarray(valid.numpy()),
                jnp.asarray(o.float().numpy(), jnp.bfloat16),
                jnp.asarray(lse.numpy()),
                jnp.asarray(do.float().numpy(), jnp.bfloat16),
                interpret=True, **kw)
    got = emulated_bwd(q, k, v, idx, valid, o, lse, do, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32))) \
            <= 2 ** -7


def test_cases_cover_padding_unvisited_and_hot_blocks():
    seen = {"invalid": 0, "unvisited": 0, "hot": 0}
    for name, (shape, _, _, _, hot) in CASES.items():
        _, _, _, _, idx, valid, _, _ = _case(*CASES[name])
        runs = torch.zeros(shape[0], shape[1] // shape[4], dtype=torch.int32)
        runs.scatter_add_(1, idx.reshape(shape[0], -1).long(),
                          valid.reshape(shape[0], -1))
        seen["invalid"] += int((valid == 0).sum())
        seen["unvisited"] += int((runs == 0).sum())
        if hot is not None:
            assert (runs[:, hot] == shape[1] // shape[3]).all()
            seen["hot"] += 1
    assert all(seen.values()), seen


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_terms_hold_f32(name):
    """Before the outputs' rounding: two terms within 2^-14 of the plain
    f32 backward on the same bf16 values, one term no closer than that."""
    q, k, v, do, idx, valid, o, lse = _case(*CASES[name])
    kw = _kw(name)
    f = [t.float() for t in (q, k, v)]
    want = B.sparse_flash_bwd_plain(*f, idx, valid, o.float(), lse,
                                    do.float(), **kw)
    errs = {n: max(_rel(g.numpy(), w.numpy()) for g, w in zip(
        emulated_bwd(q, k, v, idx, valid, o, lse, do, terms=n,
                     out_dtype=torch.float32, **kw), want))
        for n in (1, 2)}
    assert errs[2] <= 2 ** -14 < errs[1], errs


SPLIT_CASES = {  # runs longer than a work item: hot blocks, long routing
    "hot_block": ((1, 2560, 32, 64, 32), False, 0, 0.1, 5),
    "causal_prefix": ((2, 1024, 32, 32, 16), True, 64, 0.25, 1),
}


@pytest.mark.parametrize("item", [4, B.DKV_ITEM])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_plan_covers_every_pair_once(name, item):
    """Each pair of a run lies in exactly one work item, the items of a run
    in order and consecutive, so the pairs keep their ascending i; runs of
    several items own consecutive partial slots."""
    shape = SPLIT_CASES[name][0]
    _, _, _, _, idx, valid, _, _ = _case(*SPLIT_CASES[name])
    t_n = shape[1] // shape[4]
    js, is_, vs = B.sort_pairs(idx, valid)
    off = B.segment_offsets(js, t_n)
    n_items, n_slots = B.dkv_split_bounds(shape[0], t_n, js.shape[-1], item)
    plan, part_base = B.dkv_split_plan(off, n_items, item)
    got, slots = [], 0
    for run, s in plan.tolist():
        if run < 0:
            continue
        b, j = divmod(run, t_n)
        p0 = int(off[b, j]) + s * item
        got += [(b, p) for p in range(p0, min(int(off[b, j + 1]), p0 + item))]
    want = [(b, p) for b in range(shape[0]) for p in range(js.shape[-1])]
    assert got == want                  # each pair once, in run order
    lens = (off[:, 1:] - off[:, :-1]).reshape(-1)
    n = torch.where(lens > item, -(-lens // item), 1)
    assert int(n.sum()) <= n_items
    assert int((plan[:, 0] >= 0).sum()) == int(n.sum())
    for r in range(lens.numel()):
        if int(n[r]) > 1:
            assert int(part_base[r]) == slots
            slots += int(n[r])
        else:
            assert int(part_base[r]) == -1
    assert 0 < slots <= n_slots
    assert int(lens.max()) > 4 * float(lens.float().mean())
    for b in range(shape[0]):           # ascending i within each run
        for j in range(t_n):
            run_i = is_[b, off[b, j]:off[b, j + 1]]
            assert bool((run_i[1:] >= run_i[:-1]).all())


@pytest.mark.parametrize("item", [4, B.DKV_ITEM])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_plain_matches_pallas(name, item):
    """``sparse_flash_dkv_split_plain`` against the Pallas dK/dV in
    interpret mode on f32 inputs: atol 5e-5, rtol 5e-4 (the bound of
    tests/test_torch_bwd.py)."""
    case = SPLIT_CASES[name]
    q, k, v, do, idx, valid, o, lse = _case(*case, dtype="float32")
    kw = _kw_of(case)
    _, want_dk, want_dv = jbwd(*(jnp.asarray(t.numpy()) for t in
                                 (q, k, v, idx, valid, o, lse, do)),
                               interpret=True, **kw)
    dk, dv = B.sparse_flash_dkv_split_plain(q, k, v, idx, valid, o, lse, do,
                                            item=item, **kw)
    for g, w in ((dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5,
                                   rtol=5e-4)
