"""The SLA baselines (``core/sla.py``) and the single-pass fused gather
against the JAX package, on the same numpy inputs.

``sla_attention``, ``sparse_only_attention`` and ``moba_attention`` run
the dense-masked O(N^2) math in both packages; the fused gather
(``block_sparse._sla2_gather_fused``) is held to the reference's and to
the port's own two-pass gather, with the routing computed once and fed
to both sides.

Bounds: f32 with quant none, relative max error 1e-4; int8 / fp8,
relative norm error 1e-2 (one e4m3 or int8 code can flip on a one-ulp
difference of an ``exp``).  The fused and two-pass gathers differ by
design under quantisation (phi(K) over the smoothed, quantised gathered
tiles): bidirectionally they are held to 0.05, the bound the reference's
own QAT paths keep to each other; causally the reference's fused pass
departs from its two-pass gather by 0.6 to 2.6 in relative norm on these
inputs, and the port's is held to depart by the same amount.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import block_sparse as JB
from repro.core import router as JR
from repro.core import sla as JS
from repro_torch.core import block_sparse as TB
from repro_torch.core import router as TR
from repro_torch.core import sla as TS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, H, N, D, BQ, BK = 2, 2, 128, 32, 32, 16
MASKS = [(False, 0), (True, 0), (True, 40)]


def _qkv(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, H, n, D)) * 0.7).astype(np.float32)
            for _ in range(3)]


def _rel_max(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check(got, want, quant):
    if quant == "none":
        assert _rel_max(got, want) < 1e-4
    else:
        assert _rel_norm(got, want) < 1e-2


def _configs(causal, prefix_len, quant):
    kw = dict(block_q=BQ, block_k=BK, k_frac=0.3, causal=causal,
              prefix_len=prefix_len, learnable=False)
    return (JS.SLAConfig(router=JR.RouterConfig(**kw), quant_bits=quant),
            TS.SLAConfig(router=TR.RouterConfig(**kw), quant_bits=quant))


@pytest.mark.parametrize("causal,prefix_len", MASKS)
@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
def test_baselines_match_the_reference(causal, prefix_len, quant):
    q, k, v = _qkv()
    jcfg, tcfg = _configs(causal, prefix_len, quant)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    proj = (np.random.default_rng(9).standard_normal((D, D)) * 0.3
            ).astype(np.float32)
    want, jaux = JS.sla_attention({"proj_l": jnp.asarray(proj)}, jq, jk, jv,
                                  jcfg, return_aux=True)
    got, taux = TS.sla_attention(TS.SLAParams(torch.from_numpy(proj)), tq,
                                 tk, tv, tcfg, return_aux=True)
    assert np.array_equal(taux["mask_c"].numpy(), np.asarray(jaux["mask_c"]))
    _check(got.detach(), want, quant)
    want = JS.sparse_only_attention(jq, jk, jv, jcfg)
    _check(TS.sparse_only_attention(tq, tk, tv, tcfg), want, quant)
    _check(TS.moba_attention(tq, tk, tv, tcfg), JS.moba_attention(
        jq, jk, jv, jcfg), quant)


def test_sla_params_and_soft_routing():
    """proj_l is (d, d) near zero; a soft mask goes through both
    branches as the reference's does."""
    g = torch.Generator().manual_seed(0)
    p = TS.init_sla_params(g, head_dim=D)
    assert p.proj_l.shape == (D, D) and float(p.proj_l.abs().max()) < 0.05
    q, k, v = _qkv(seed=3)
    jcfg, tcfg = _configs(False, 0, "none")
    proj = p.proj_l.detach().numpy()
    want = JS.sla_attention({"proj_l": jnp.asarray(proj)}, *map(
        jnp.asarray, (q, k, v)), jcfg, soft=True)
    got = TS.sla_attention(p, *map(torch.from_numpy, (q, k, v)), tcfg,
                           soft=True)
    _check(got.detach(), want, "none")


def _routed(q, k, causal, prefix_len, n):
    """(BH, N, D) q/k and the reference's routing of them, as numpy."""
    rc = JR.RouterConfig(block_q=BQ, block_k=BK, k_frac=0.3, causal=causal,
                         prefix_len=prefix_len)
    qf, kf = (x.reshape(B * H, n, D) for x in (q, k))
    idx, valid = JR.route_indices({}, jnp.asarray(qf), jnp.asarray(kf), rc)
    return qf, kf, np.asarray(idx), np.asarray(valid)


@pytest.mark.parametrize("causal,prefix_len", MASKS)
@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
@pytest.mark.parametrize("q_chunk", [1, 3])
def test_fused_gather_matches_the_reference(causal, prefix_len, quant,
                                            q_chunk):
    n = N + 2 * BQ                    # 6 query blocks: a ragged last chunk
    q, k, v = _qkv(seed=1, n=n)
    qf, kf, idx, valid = _routed(q, k, causal, prefix_len, n)
    vf = v.reshape(B * H, n, D)
    alpha = np.random.default_rng(2).uniform(
        0.1, 0.9, (B * H, n, 1)).astype(np.float32)
    kw = dict(block_q=BQ, block_k=BK, causal=causal, quant_bits=quant,
              prefix_len=prefix_len, q_chunk=q_chunk)
    want = JB._sla2_gather_fused(*map(jnp.asarray, (alpha, qf, kf, vf, idx,
                                                    valid)), **kw)
    t_in = [torch.from_numpy(x) for x in (alpha, qf, kf, vf, idx, valid)]
    got = TB.sla2_gather(*t_in, fuse_branches=True, **kw)
    _check(got, want, quant)
    two = TB.sla2_gather(*t_in, **kw)
    if quant == "none":
        assert _rel_max(got, two) < 1e-4
    elif not causal:
        assert _rel_norm(got, two) < 0.05
    else:
        # causal QAT: the subtraction's phi over smoothed, quantised tiles
        # no longer matches the prefix totals' phi over raw K, and rows
        # whose complement is nearly all routed amplify it; the reference
        # departs from its own two-pass gather as far, and the port
        # departs as the reference does
        jtwo = JB.sla2_gather(*map(jnp.asarray, (alpha, qf, kf, vf, idx,
                                                 valid)), **kw)
        gap, jgap = _rel_norm(got, two), _rel_norm(want, jtwo)
        assert gap > 0.1 and abs(gap - jgap) < 1e-2 * jgap


def test_fused_gather_gradient_matches_the_two_pass_gather():
    """Autograd through the fused pass gives the two-pass gradients
    (quant none, f32)."""
    q, k, v = _qkv(seed=5)
    qf, kf, idx, valid = _routed(q, k, True, 0, N)
    vf = v.reshape(B * H, N, D)
    alpha = torch.full((B * H, N, 1), 0.7)
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B * H, N, D)).astype(np.float32))
    grads = []
    for fuse in (False, True):
        xs = [torch.from_numpy(x).requires_grad_() for x in (qf, kf, vf)]
        o = TB.sla2_gather(alpha, *xs, torch.from_numpy(idx),
                           torch.from_numpy(valid), block_q=BQ, block_k=BK,
                           causal=True, q_chunk=2, fuse_branches=fuse)
        torch.sum(o * w).backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        assert _rel_max(a, b) < 1e-4


def test_sla2_config_carries_fuse_branches(monkeypatch):
    """SLA2Config.fuse_branches reaches the gather path: the fused pass
    runs (once per call) and agrees with the ref operator."""
    from repro.core.sla2 import SLA2Config as JC
    from repro_torch.core import sla2 as TS2
    fields = {f.name: f.default for f in dataclasses.fields(JC)}
    assert fields["fuse_branches"] is False
    assert TS2.SLA2Config().fuse_branches is False
    q, k, v = map(torch.from_numpy, _qkv(seed=7))
    rc = TR.RouterConfig(block_q=BQ, block_k=BK, k_frac=0.3, causal=True)
    cfg = TS2.SLA2Config(router=rc, quant_bits="none", impl="gather",
                         q_chunk=2)
    p = TS2.init_sla2_params(torch.Generator().manual_seed(0), head_dim=D,
                             num_heads=H, n_q_blocks=N // BQ, cfg=cfg)
    calls = []
    fused_fn = TB._sla2_gather_fused
    monkeypatch.setattr(TB, "_sla2_gather_fused",
                        lambda *a, **kw: calls.append(1) or fused_fn(*a, **kw))
    with torch.no_grad():
        two = TS2.sla2_attention(p, q, k, v, cfg)
        assert not calls
        fused = TS2.sla2_attention(
            p, q, k, v, dataclasses.replace(cfg, fuse_branches=True))
        ref = TS2.sla2_attention(p, q, k, v,
                                 dataclasses.replace(cfg, impl="ref"))
    assert calls == [1]
    assert _rel_max(fused, ref) < 1e-4 and _rel_max(two, ref) < 1e-4
