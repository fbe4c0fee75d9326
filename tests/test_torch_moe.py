"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe.moe_ffn``) on the CPU, and the AdamW update of its
expert tensors one slice at a time.

The same seeded numpy inputs and the reference's params (``init_moe`` at a
fixed key) go through both.  The reference's keep mask of the (token,
slot) pairs is read from its own computation: the first ``jnp.where`` it
evaluates on a (T*k,) boolean condition is ``keep``.

Bounds: y 1e-5 relative max error and aux 1e-5 relative (f32); the keep
mask identical; gradients against ``jax.grad`` (x, router, w_in, w_out and
the shared expert) 1e-4 relative max error; the sliced AdamW update bit
for bit equal to the unsliced one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as TM
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

D, E, FF = 32, 8, 16


def _params(cfg: TM.MoEConfig, seed=0):
    """(reference params, the same values as the port's MoEParams)."""
    jcfg = JM.MoEConfig(**dataclasses.asdict(cfg))
    jp = JM.init_moe(jax.random.PRNGKey(seed), D, jcfg)
    tp = TM.init_moe(torch.Generator().manual_seed(seed), D, cfg)
    with torch.no_grad():
        for name in ("router", "w_in", "w_out"):
            getattr(tp, name).copy_(torch.tensor(np.asarray(jp[name])))
        if cfg.num_shared:
            for name in ("w_up", "w_down", "w_gate"):
                getattr(tp.shared, name).weight.copy_(
                    torch.tensor(np.asarray(jp["shared"][name]).T))
    return jcfg, jp, tp


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _reference(jp, x, jcfg, monkeypatch):
    """The reference's (y, aux, keep mask)."""
    t_k = x.shape[0] * x.shape[1] * jcfg.top_k
    conds = []
    where = jnp.where

    def recording(cond, *args, **kw):
        c = np.asarray(cond)
        if c.dtype == bool and c.shape == (t_k,):
            conds.append(c)
        return where(cond, *args, **kw)

    monkeypatch.setattr(JM.jnp, "where", recording)
    y, aux = JM.moe_ffn(jp, jnp.asarray(x), jcfg)
    monkeypatch.setattr(JM.jnp, "where", where)
    return np.asarray(y), float(aux), conds[0]


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _padded_chunk():
    """A prefill chunk of 32 rows, the last 12 padding (one repeated
    row, as token 0's embedding is)."""
    x = _x((1, 32, D), seed=2)
    x[0, 20:] = x[0, 0] * 0.5
    return x


def _inactive_first_slot():
    """A 4-slot decode batch whose inactive slot 0 carries slot 1's row:
    at top-1 the capacity is max(1, round(4 / 8 * 1.25)) = 1, so slot 0
    takes the expert's only place and slot 1 is dropped."""
    x = _x((4, 1, D), seed=3)
    x[0] = x[1]
    return x


CASES = [dict(top_k=k, num_shared=s, capacity_factor=cf, x=(2, 11, D))
         for k in (1, 2) for s in (0, 1, 2) for cf in (1.25, float(E))]
CASES += [
    # 16 * 1 / 8 * 1.25 = 2.5: round gives 2 (half to even), ceil 3
    dict(top_k=1, num_shared=0, capacity_factor=1.25, x=(2, 8, D),
         cap=2),
    dict(top_k=2, num_shared=1, capacity_factor=1.25, x="padded", cap=10),
    dict(top_k=1, num_shared=1, capacity_factor=1.25, x="inactive", cap=1)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}{v if not isinstance(v, tuple) else 'x'.join(map(str, v))}"
    for k, v in c.items()))
def test_moe_ffn_matches_the_reference(case, monkeypatch):
    case = dict(case)
    shape, want_cap = case.pop("x"), case.pop("cap", None)
    x = {"padded": _padded_chunk, "inactive": _inactive_first_slot}.get(
        shape, lambda: _x(shape))()
    cfg = TM.MoEConfig(num_experts=E, d_ff_expert=FF, **case)
    jcfg, jp, tp = _params(cfg)
    want_y, want_aux, want_keep = _reference(jp, x, jcfg, monkeypatch)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y, aux = TM.moe_ffn(tp, xt, cfg)
        _, ids, _, cap, keep, _ = TM.route(tp, xt.reshape(-1, D), cfg)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert _rel(y, want_y) < 1e-5
    assert abs(float(aux) - want_aux) <= 1e-5 * abs(want_aux)
    assert np.array_equal(keep.numpy(), want_keep)
    if want_cap is not None:
        assert cap == want_cap
    if cfg.capacity_factor == E:
        assert keep.all()                       # dropless
    if shape == "inactive":
        assert ids[0, 0] == ids[1, 0] and keep[0] and not keep[1]
    if shape == (2, 8, D):
        assert int(torch.bincount(ids[:, 0], minlength=E).max()) > cap


@pytest.mark.parametrize("num_shared", [0, 1])
def test_moe_gradients_match_jax(num_shared):
    """d(sum(y * r) + aux) for x, router, w_in, w_out and the shared
    expert, with pairs dropped (capacity factor 1: 6 places an expert
    for 48 pairs)."""
    cfg = TM.MoEConfig(num_experts=E, top_k=2, d_ff_expert=FF,
                       num_shared=num_shared, capacity_factor=1.0)
    jcfg, jp, tp = _params(cfg, seed=4)
    x = _x((2, 12, D), seed=5)
    r = _x((2, 12, D), seed=6)

    def loss(p, xx):
        y, aux = JM.moe_ffn(p, xx, jcfg)
        return jnp.sum(y * r) + aux

    jg, jgx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = TM.moe_ffn(tp, xt, cfg)
    (y * torch.from_numpy(r)).sum().add(aux).backward()
    assert not TM.route(tp, xt.detach().reshape(-1, D), cfg)[4].all()
    assert _rel(xt.grad, jgx) < 1e-4
    for name in ("router", "w_in", "w_out"):
        assert _rel(getattr(tp, name).grad, jg[name]) < 1e-4, name
    if num_shared:
        for name in ("w_up", "w_down", "w_gate"):
            got = getattr(tp.shared, name).weight.grad.T
            assert _rel(got, jg["shared"][name]) < 1e-4, name


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_sliced_update_is_bit_equal(state_dtype):
    """layerwise_threshold updates the (E, d, 2 ff) expert tensor one
    expert at a time; the result is the unsliced update's, bit for bit,
    over three steps (the moments carried between them)."""
    g = torch.Generator().manual_seed(7)
    shapes = {"w_in": (E, D, 2 * FF), "w_out": (E, FF, D), "router": (D, E)}
    out = {}
    for threshold in (0, 1):
        cfg = AdamWConfig(lr=1e-2, state_dtype=state_dtype,
                          layerwise_threshold=threshold)
        g.manual_seed(7)
        params = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
        state = adamw_init(params, cfg)
        for _ in range(3):
            grads = {n: torch.randn(s, generator=g)
                     for n, s in shapes.items()}
            params, state, metrics = adamw_update(params, grads, state, cfg)
        out[threshold] = (params, state, metrics)
    (p0, s0, m0), (p1, s1, m1) = out[0], out[1]
    for n in shapes:
        assert torch.equal(p0[n], p1[n]), n
        assert torch.equal(s0["m"][n], s1["m"][n])
        assert torch.equal(s0["v"][n], s1["v"][n])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert AdamWConfig().layerwise_threshold == 1 << 24
