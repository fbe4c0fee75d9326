"""The port's dense paged decode (kernel 5) and the speculative verify
window against the JAX package.

``dense_decode_verify_plain`` / ``dense_decode_fused_plain`` (the PyTorch
versions of the CUDA kernel, and what the wrappers run on a CPU tensor)
are held to the Pallas entries run in interpret mode on the same numpy
inputs, across quant_bits x kv_quant x window x prefix_len x W: relative
max error 2e-5 with f32 tiles, 1e-3 with int8 and 1e-2 with fp8 QAT tiles
(both versions run the same loop; a 1-ulp difference between torch's and
XLA's exp can flip one rounded P code).

One attention layer (``repro.serve.scenario.make_paged_attention_state``:
three slots prefilled chunk by chunk into a shared f32 pool) is carried
across, and the dense ``decode_step_paged``, both branches of
``decode_window_paged`` (fused and gather), ``commit_paged_window``,
``linear_draft_state`` and ``linear_draft_attention`` are compared with
the reference on the same inputs: 1e-5 for the dense paths and the
commit / draft functions, 1e-3 for the SLA2 window, whose linear
complement subtracts nearly equal f32 sums (the bound the decode step has
in tests/test_torch_lm.py).  Rows past a slot's window length write to the
trash page and are not compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sla2_decode_paged as JK
from repro.models import attention as JA
from repro.serve.scenario import make_paged_attention_state
from repro_torch.convert import sla2_params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sla2_decode_paged as TK
from repro_torch.models import attention as TA
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BOUND = {"none": 2e-5, "int8": 1e-3, "fp8": 1e-2}
_JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
LENGTHS = (37, 16, 70)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas entries
# ---------------------------------------------------------------------------

def _pool(rng, shape, kv_quant):
    x = rng.standard_normal(shape).astype(np.float32)
    if kv_quant == "none":
        return torch.from_numpy(x), jnp.asarray(x), None, None
    codes, scale = tops.quantize_rows(torch.from_numpy(x), kv_quant)
    return (codes, jnp.asarray(codes.to(torch.float32).numpy()).astype(
        _JDT[kv_quant]), scale, jnp.asarray(scale.numpy()))


def _kernel_case(seed, w, n_rep, kv_quant, bk=16, dh=32):
    rng = np.random.default_rng(seed)
    b, hkv, n_pages, max_p = 3, 2, 14, 8
    kt, kj, kst, ksj = _pool(rng, (n_pages, hkv, bk, dh), kv_quant)
    vt, vj, vst, vsj = _pool(rng, (n_pages, hkv, bk, dh), kv_quant)
    q = rng.standard_normal((b, hkv, w, n_rep, dh)).astype(np.float32)
    pt = np.zeros((b, max_p), np.int32)
    pt[0, :6] = rng.permutation(np.arange(1, 7))
    pt[1, :8] = rng.permutation(np.arange(6, 14))
    pt[2, :3] = [13, 2, 9]
    # ragged rows, one ending mid-page, and an inactive slot's row (t = 1,
    # the trash page)
    t = np.stack([np.arange(w) + 83, np.arange(w) + 120,
                  np.arange(w) + 1]).astype(np.int32)
    return ((torch.from_numpy(q), kt, vt, torch.from_numpy(pt),
             torch.from_numpy(t)), dict(k_scale=kst, v_scale=vst),
            (jnp.asarray(q), kj, vj, jnp.asarray(pt), jnp.asarray(t)),
            dict(k_scale=ksj, v_scale=vsj))


@pytest.mark.parametrize("quant,kv_quant,window,prefix_len,w,n_rep", [
    ("none", "none", None, 0, 1, 1), ("none", "none", None, 0, 4, 5),
    ("none", "none", 40, 0, 3, 2), ("none", "none", 40, 24, 4, 5),
    ("none", "int8", 24, 16, 1, 2), ("none", "fp8", None, 0, 2, 5),
    ("int8", "none", None, 0, 1, 5), ("int8", "int8", 40, 24, 4, 2),
    ("int8", "fp8", None, 0, 3, 1), ("fp8", "none", 24, 0, 1, 2),
    ("fp8", "int8", None, 0, 4, 5), ("fp8", "fp8", 40, 16, 2, 2)])
def test_dense_plain_matches_pallas(quant, kv_quant, window, prefix_len, w,
                                    n_rep):
    t_args, t_kw, j_args, j_kw = _kernel_case(w + 7 * n_rep, w, n_rep,
                                              kv_quant)
    kw = dict(block_k=16, window=window, prefix_len=prefix_len,
              quant_bits=quant, kv_quant=kv_quant)
    if w == 1:
        one = lambda a: (a[0][:, :, 0],) + tuple(a[1:4]) + (a[4][:, 0],)
        jo = JK.dense_decode_fused(*one(j_args), interpret=True, **kw,
                                   **j_kw)
        to = TK.dense_decode_fused(*one(t_args), **kw, **t_kw)
    else:
        jo = JK.dense_decode_verify(*j_args, interpret=True, **kw, **j_kw)
        to = TK.dense_decode_verify(*t_args, **kw, **t_kw)
    assert to.shape == jo.shape and to.dtype == torch.float32
    assert _rel(to, jo) < BOUND[quant]


def test_dense_row_that_sees_nothing_writes_zero():
    t_args, t_kw, j_args, j_kw = _kernel_case(4, 2, 2, "none")
    t_args = list(t_args)
    t_args[4] = t_args[4].clone()
    t_args[4][1] = 0                                   # length 0: no page
    j_args = list(j_args)
    j_args[4] = jnp.asarray(t_args[4].numpy())
    jo = JK.dense_decode_verify(*j_args, block_k=16, interpret=True)
    to = TK.dense_decode_verify(*t_args, block_k=16)
    assert torch.equal(to[1], torch.zeros_like(to[1]))
    assert _rel(to, jo) < BOUND["none"]


def test_dense_wrapper_rejects_and_takes_the_plain_version_on_cpu():
    t_args, t_kw, _, _ = _kernel_case(5, 2, 2, "none")
    bad = list(t_args)
    bad[3] = bad[3].to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        TK.dense_decode_verify(*bad, block_k=16)
    with pytest.raises(ValueError, match="block_k"):
        TK.dense_decode_verify(*t_args, block_k=32)
    with pytest.raises(ValueError, match="needs"):
        TK.dense_decode_verify(*t_args, block_k=16, kv_quant="int8")
    before = TK.dense_decode_verify.launches
    assert torch.equal(TK.dense_decode_verify(*t_args, block_k=16),
                       TK.dense_decode_verify_plain(*t_args, block_k=16))
    assert TK.dense_decode_verify.launches == before


# ---------------------------------------------------------------------------
# one attention layer carried across
# ---------------------------------------------------------------------------

def _tensor(x):
    x = np.asarray(x)
    if x.dtype.name.startswith("float8"):
        return torch.from_numpy(x.astype(np.float32)).to(torch.float8_e4m3fn)
    return torch.from_numpy(x.copy())


def _layer(mechanism, kv_quant="none", window=None, seed=0):
    """(jax cfg, jax params, jax cache, page table, x_t, port cfg, port
    params, port cache): one prefilled layer in both packages."""
    jcfg, jp, jcache, pt, x_t = make_paged_attention_state(
        mechanism=mechanism, kv_quant=kv_quant, sliding_window=window,
        seed=seed)
    fields = {f.name for f in dataclasses.fields(TA.AttentionConfig)}
    tcfg = TA.AttentionConfig(**{k: getattr(jcfg, k) for k in fields})
    tp = TA.init_attention(torch.Generator().manual_seed(0), tcfg)
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(tp, name).weight.copy_(_tensor(jp[name]).T)
    if mechanism == "sla2":
        tp.sla2 = sla2_params_from_numpy(
            jax.tree.map(np.asarray, jp["sla2"]), device="cpu")
    tcache = {k: _tensor(v) for k, v in jcache.items()}
    return jcfg, jp, jcache, pt, x_t, tcfg, tp, tcache


def _impl(cfg, impl):
    return dataclasses.replace(cfg, paged_impl=impl)


def test_full_layer_has_only_a_kv_pool():
    *_, tcfg, tp, tcache = _layer("full", kv_quant="int8")
    assert tp.sla2 is None
    assert sorted(tcache) == ["k_pages", "k_scale", "v_pages", "v_scale"]
    fresh = TA.init_paged_cache(tcfg, 5, 2)
    assert sorted(fresh) == sorted(tcache)
    for mech in ("sla", "sparse_only"):       # the dense pool
        pool = TA.init_paged_cache(dataclasses.replace(tcfg, mechanism=mech),
                                   5, 2)
        assert {k: v.shape for k, v in pool.items()} == {
            k: v.shape for k, v in fresh.items()}


@pytest.mark.parametrize("impl,window,kv_quant", [
    ("fused", None, "none"), ("gather", None, "none"),
    ("fused", 24, "none"), ("gather", 24, "int8")])
def test_dense_decode_step_matches_the_reference(impl, window, kv_quant):
    jcfg, jp, jcache, pt, x_t, tcfg, tp, tcache = _layer(
        "full", kv_quant=kv_quant, window=window)
    lens = np.asarray(LENGTHS, np.int32)
    act = np.ones(3, bool)
    jo, jc = JA.decode_step_paged(jp, _impl(jcfg, impl), x_t, dict(jcache),
                                  page_table=pt, lengths=jnp.asarray(lens),
                                  active=jnp.asarray(act))
    with torch.no_grad():
        to, tc = TA.decode_step_paged(
            tp, _impl(tcfg, impl), _tensor(x_t), tcache,
            page_table=_tensor(pt), lengths=torch.from_numpy(lens),
            active=torch.from_numpy(act))
    assert _rel(to, jo) < 1e-5
    for key in jc:
        assert _rel(tc[key].to(torch.float32), np.asarray(
            jc[key]).astype(np.float32)) < 1e-5, key


@pytest.mark.parametrize("quant_bits,kv_quant", [
    ("int8", "int8"), ("int8", "fp8"), ("fp8", "int8"), ("fp8", "fp8")])
def test_dense_qat_tiles_match_the_reference(quant_bits, kv_quant):
    """The counterpart of tests/test_quant_pool.py::test_dense_decode_qat_
    tiles: the port's fused dense decode and verify with QAT tiles on a
    low-bit pool are held to the reference's outputs on the same inputs
    (int8 1e-3, fp8 1e-2), not to the reference's noise-budget property,
    which its [int8-fp8] case does not meet."""
    jcfg, jp, jcache, pt, x_t, tcfg, tp, tcache = _layer(
        "full", kv_quant=kv_quant)
    jq = dataclasses.replace(jcfg, paged_impl="fused",
                             decode_quant_bits=quant_bits)
    tq = dataclasses.replace(tcfg, paged_impl="fused",
                             decode_quant_bits=quant_bits)
    lens, act = np.asarray(LENGTHS, np.int32), np.ones(3, bool)
    jo, _ = JA.decode_step_paged(jp, jq, x_t, dict(jcache), page_table=pt,
                                 lengths=jnp.asarray(lens),
                                 active=jnp.asarray(act))
    with torch.no_grad():
        to, _ = TA.decode_step_paged(
            tp, tq, _tensor(x_t), {k: v.clone() for k, v in tcache.items()},
            page_table=_tensor(pt), lengths=torch.from_numpy(lens),
            active=torch.from_numpy(act))
    assert _rel(to, jo) < BOUND[quant_bits]
    x_w = np.random.default_rng(9).standard_normal((3, 4, 64)).astype(
        np.float32) * 0.3
    wl = np.asarray([4, 3, 4], np.int32)
    jo, _ = JA.decode_window_paged(
        jp, jq, jnp.asarray(x_w), dict(jcache), page_table=pt,
        lengths=jnp.asarray(lens), active=jnp.asarray(act),
        window_len=jnp.asarray(wl))
    with torch.no_grad():
        to, _ = TA.decode_window_paged(
            tp, tq, torch.from_numpy(x_w), tcache, page_table=_tensor(pt),
            lengths=torch.from_numpy(lens), active=torch.from_numpy(act),
            window_len=torch.from_numpy(wl))
    jo = np.asarray(jo)
    for s, n in enumerate(wl):
        assert _rel(to[s, :n], jo[s, :n]) < BOUND[quant_bits]


def _window(mechanism, impl, window=None, active=(True, True, False)):
    jcfg, jp, jcache, pt, _, tcfg, tp, tcache = _layer(mechanism,
                                                       window=window)
    lens = np.asarray(LENGTHS, np.int32)
    act = np.asarray(active)
    wl = np.asarray([4, 2, 3], np.int32)
    x_w = np.random.default_rng(3).standard_normal((3, 4, 64)).astype(
        np.float32) * 0.3
    jo, jc = JA.decode_window_paged(
        jp, _impl(jcfg, impl), jnp.asarray(x_w), dict(jcache),
        page_table=pt, lengths=jnp.asarray(lens), active=jnp.asarray(act),
        window_len=jnp.asarray(wl))
    with torch.no_grad():
        to, tc = TA.decode_window_paged(
            tp, _impl(tcfg, impl), torch.from_numpy(x_w), tcache,
            page_table=_tensor(pt), lengths=torch.from_numpy(lens),
            active=torch.from_numpy(act), window_len=torch.from_numpy(wl))
    rows = [(s, int(wl[s])) for s in range(3) if act[s]]
    return np.asarray(jo), to, jc, tc, rows, (jcfg, tcfg, pt, lens, act)


@pytest.mark.parametrize("mechanism,impl,window", [
    ("full", "fused", None), ("full", "gather", None),
    ("full", "fused", 24), ("sla2", "fused", None),
    ("sla2", "gather", None)])
def test_decode_window_matches_the_reference(mechanism, impl, window):
    jo, to, jc, tc, rows, _ = _window(mechanism, impl, window)
    bound = 1e-5 if mechanism == "full" else 1e-3
    for s, n in rows:
        assert _rel(to[s, :n], jo[s, :n]) < bound, s
    # the window's K/V rows landed where the reference put them; the
    # verify pass commits no SLA2 block state
    for key in ("k_pages", "v_pages"):
        want = np.asarray(jc[key])
        assert _rel(tc[key][1:], want[1:]) < 1e-5, key
    for key in ("pooled_pages", "h_tot", "z_tot"):
        if key in jc:
            assert _rel(tc[key], jc[key]) < 1e-5, key


def test_commit_window_matches_the_reference():
    _, _, jc, tc, _, (jcfg, tcfg, pt, lens, act) = _window("sla2", "gather")
    acc = np.asarray([3, 2, 0], np.int32)
    jc = JA.commit_paged_window(jcfg, dict(jc), page_table=pt,
                                lengths=jnp.asarray(lens),
                                accepted=jnp.asarray(acc),
                                active=jnp.asarray(act), window=4)
    with torch.no_grad():
        tc = TA.commit_paged_window(
            tcfg, tc, page_table=_tensor(pt), lengths=torch.from_numpy(lens),
            accepted=torch.from_numpy(acc), active=torch.from_numpy(act),
            window=4)
    for key in ("pooled_pages", "h_tot", "z_tot"):
        assert _rel(tc[key], jc[key]) < 1e-5, key
    full = TA.AttentionConfig(**dict(dataclasses.asdict(tcfg),
                                     mechanism="full"))
    assert TA.commit_paged_window(full, tc, page_table=None, lengths=None,
                                  accepted=None, active=None,
                                  window=4) is tc


def test_linear_draft_state_and_attention_match_the_reference():
    jcfg, jp, jcache, pt, x_t, tcfg, tp, tcache = _layer("sla2")
    lens = np.asarray(LENGTHS, np.int32)
    act = np.asarray([True, False, True])
    jst = JA.linear_draft_state(jcfg, jcache, page_table=pt,
                                lengths=jnp.asarray(lens),
                                active=jnp.asarray(act))
    with torch.no_grad():
        tst = TA.linear_draft_state(tcfg, tcache, page_table=_tensor(pt),
                                    lengths=torch.from_numpy(lens),
                                    active=torch.from_numpy(act))
    for key in ("h", "z"):
        assert _rel(tst[key], jst[key]) < 1e-5, key
    for step in range(3):
        pos = lens + step
        jy, jst = JA.linear_draft_attention(
            jp, jcfg, x_t, jst, positions=jnp.asarray(pos),
            active=jnp.asarray(act))
        with torch.no_grad():
            ty, tst = TA.linear_draft_attention(
                tp, tcfg, _tensor(x_t), tst, positions=torch.from_numpy(pos),
                active=torch.from_numpy(act))
        assert _rel(ty, jy) < 1e-5, step
        for key in ("h", "z"):
            assert _rel(tst[key], jst[key]) < 1e-5, (step, key)
    full = dataclasses.replace(tcfg, mechanism="full")
    with pytest.raises(ValueError, match="sla2"):
        TA.linear_draft_state(full, tcache, page_table=_tensor(pt),
                              lengths=torch.from_numpy(lens),
                              active=torch.from_numpy(act))


def test_window_span_is_the_reference():
    for w in range(1, 9):
        for bk in (16, 64):
            assert TA.window_span(w, bk) == JA.window_span(w, bk)
