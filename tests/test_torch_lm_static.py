"""The LM's full-sequence attention and static cache path against the JAX
package: ``attention_forward`` for every mechanism, the static cache
(``init_cache`` / ``prefill_cache`` / ``decode_step``, SLA2's
``_sla2_decode``) over steps that cross block boundaries, the model's
``prefill`` / ``decode_step``, ``generate_sequential`` and
``StaticWaveEngine``, and the port's paged engine against its own
static oracle.

The JAX side runs ``sla2_impl="gather"`` (never Pallas in interpret
mode); the port runs ``"gather"`` and ``"kernel"`` (the kernels' plain
versions on the CPU).  Params are the reference's, carried across.

Bounds: f32 with quant none, relative max error 1e-4; int8 / fp8,
relative norm error 1e-2.  SLA2 decode takes its linear complement as
``(phi(q) h_tot - lnum) / (phi(q) z_tot - lden)``, a subtraction that
amplifies f32 sum-order differences: its outputs and the model's logits
over several decode steps are held to 1e-3, as the paged tests hold
them.  Greedy tokens at 2 layers in f32: identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import attention as JA
from repro.models.api import build_model as jbuild
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import StaticWaveEngine as JStatic
from repro.serve import generate_sequential as jgenerate
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.convert import lm_params_from_numpy, sla2_params_from_numpy
from repro_torch.core.sla import SLAParams
from repro_torch.models import attention as TA
from repro_torch.models.api import build_model
from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                               StaticWaveEngine, generate_sequential)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MECHS = ("full", "sla2", "sla", "sparse_only")


def _rel_max(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _layer(mechanism, quant="none", impl="gather", seed=0):
    """(jax cfg, jax params, port cfg, port params) of one qwen3-like
    attention layer (GQA 4 / 2 heads, qk-norm, blocks 32 / 16)."""
    jcfg = JA.AttentionConfig(
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        mechanism=mechanism, qk_norm=True, rope_theta=1e6, block_q=32,
        block_k=16, k_frac=0.25, quant_bits=quant, sla2_impl="gather",
        n_q_blocks=8)
    fields = {f.name for f in dataclasses.fields(TA.AttentionConfig)}
    tcfg = TA.AttentionConfig(**{k: getattr(jcfg, k) for k in fields})
    tcfg = dataclasses.replace(tcfg, sla2_impl=impl)
    jp = JA.init_attention(jax.random.PRNGKey(seed), jcfg)
    tp = TA.init_attention(torch.Generator().manual_seed(0), tcfg)
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(tp, name).weight.copy_(
                torch.from_numpy(np.asarray(jp[name])).T)
        for name in ("q_norm", "k_norm"):
            getattr(tp, name).scale.copy_(
                torch.from_numpy(np.asarray(jp[name]["scale"])))
    if mechanism == "sla2":
        tp.sla2 = sla2_params_from_numpy(jax.tree.map(np.asarray, jp["sla2"]),
                                         device="cpu")
    if mechanism == "sla":
        tp.sla = SLAParams(torch.from_numpy(np.asarray(jp["sla"]["proj_l"])))
    return jcfg, jp, tcfg, tp


def _x(shape, seed=1):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5
            ).astype(np.float32)


@pytest.mark.parametrize("mechanism", MECHS)
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_attention_forward_matches_the_reference(mechanism, quant):
    x = _x((2, 96, 64))
    impls = ("gather", "kernel") if mechanism == "sla2" else ("gather",)
    for impl in impls:
        jcfg, jp, tcfg, tp = _layer(mechanism, quant, impl)
        want = JA.attention_forward(jp, jcfg, jnp.asarray(x))
        with torch.no_grad():
            got = TA.attention_forward(tp, tcfg, torch.from_numpy(x))
        if quant == "none" or mechanism == "full":
            assert _rel_max(got, want) < 1e-4, impl
        else:
            assert _rel_norm(got, want) < 1e-2, impl


def test_attention_forward_gqa_and_positions():
    """K/V reach the operator repeated to the query heads (each KV head
    serves n_rep adjacent query heads), and explicit positions shift the
    RoPE as in the reference."""
    jcfg, jp, tcfg, tp = _layer("full")
    x = _x((1, 48, 64), seed=2)
    pos = np.arange(48, dtype=np.int32)[None] + 7
    want = JA.attention_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        got = TA.attention_forward(tp, tcfg, torch.from_numpy(x),
                                   torch.from_numpy(pos))
    assert _rel_max(got, want) < 1e-4
    k = torch.arange(2 * 3).reshape(1, 2, 3, 1)
    assert TA._repeat_kv(k, 2)[0, :, :, 0].tolist() == [
        [0, 1, 2], [0, 1, 2], [3, 4, 5], [3, 4, 5]]


def _tree(cache):
    return {k: np.asarray(v, np.float32) for k, v in cache.items()
            if k != "length"}


@pytest.mark.parametrize("mechanism", ["sla2", "full", "sla"])
def test_static_cache_prefill_and_decode_match_the_reference(mechanism):
    """Prefill 32 tokens, then 2 * block_k + 3 decode steps (t 33..67),
    through block boundaries at 48 and 64, where SLA2 folds the completed
    block into its totals; outputs every step and the cache leaves at the
    end against JAX."""
    jcfg, jp, tcfg, tp = _layer(mechanism)
    b, n0, max_len, steps = 2, 32, 96, 2 * 16 + 3
    x = _x((b, n0 + steps, 64), seed=3)
    jc = JA.init_cache(jcfg, b, max_len, dtype=jnp.float32)
    tc = TA.init_cache(tcfg, b, max_len, dtype=torch.float32)
    assert sorted(k for k in jc) == sorted(tc)
    want, jc = JA.prefill_cache(jp, jcfg, jnp.asarray(x[:, :n0]), jc)
    with torch.no_grad():
        got, tc = TA.prefill_cache(tp, tcfg, torch.from_numpy(x[:, :n0]), tc)
    assert tc["length"] == int(jc["length"]) == n0
    assert _rel_max(got, want) < 1e-4
    for key, val in _tree(jc).items():
        assert _rel_max(tc[key], val) < 1e-5, key
    bound = 1e-3 if mechanism == "sla2" else 1e-4
    for i in range(steps):
        xt = x[:, n0 + i:n0 + i + 1]
        want, jc = JA.decode_step(jp, jcfg, jnp.asarray(xt), jc)
        with torch.no_grad():
            got, tc = TA.decode_step(tp, tcfg, torch.from_numpy(xt), tc)
        assert isinstance(tc["length"], int)
        assert tc["length"] == int(jc["length"]) == n0 + i + 1
        assert _rel_max(got, want) < bound, (i, _rel_max(got, want))
    for key, val in _tree(jc).items():
        assert _rel_max(tc[key], val) < bound, key


def test_static_sla2_decode_early_and_forced_block():
    """Decode after a 32-token prefill with K_sel equal to every block of
    the cache: fewer allowed blocks than K_sel (the leftover top-k slots
    are NEG_INF ties, hidden by ``valid``) and the current block forced
    in, at every step through the block boundary at 48."""
    jcfg, jp, tcfg, tp = _layer("sla2")
    jcfg = dataclasses.replace(jcfg, k_frac=1.0)
    tcfg = dataclasses.replace(tcfg, k_frac=1.0)
    x = _x((1, 32 + 17, 64), seed=4)
    jc = JA.init_cache(jcfg, 1, 64, dtype=jnp.float32)
    tc = TA.init_cache(tcfg, 1, 64, dtype=torch.float32)
    _, jc = JA.prefill_cache(jp, jcfg, jnp.asarray(x[:, :32]), jc)
    with torch.no_grad():
        _, tc = TA.prefill_cache(tp, tcfg, torch.from_numpy(x[:, :32]), tc)
        for i in range(17):
            xt = x[:, 32 + i:33 + i]
            want, jc = JA.decode_step(jp, jcfg, jnp.asarray(xt), jc)
            got, tc = TA.decode_step(tp, tcfg, torch.from_numpy(xt), tc)
            assert torch.isfinite(got).all()
            assert _rel_max(got, want) < 1e-3, i
    with pytest.raises(ValueError, match="multiple of block_k"):
        TA.init_cache(tcfg, 1, 40)


@pytest.fixture(scope="module")
def lm():
    """(jax model, jax params, port model, port params) of the qwen3 smoke
    config, the reference's params carried across."""
    jm = jbuild(get_smoke_config("qwen3_14b"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tsmoke("qwen3_14b"))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tm.cfg,
                              device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_model_prefill_and_decode_logits_match_the_reference(lm, impl):
    jm, jp, tm, tp = lm
    tm = tm.with_overrides(sla2_impl=impl, quant_bits="none")
    jm = jm.with_overrides(quant_bits="none")
    toks = np.random.default_rng(5).integers(1, 256, (2, 64)).astype(
        np.int32)
    jc = jm.init_caches(2, 128, dtype=jnp.float32)
    tc = tm.init_caches(2, 128, dtype=torch.float32, device="cpu")
    want, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    with torch.no_grad():
        got, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    assert _rel_max(got, want) < 1e-4
    tok = np.argmax(np.asarray(want), -1).astype(np.int32)
    for i in range(20):
        want, jc = jm.decode(jp, {"token": jnp.asarray(tok)}, jc)
        with torch.no_grad():
            got, tc = tm.decode(tp, {"token": torch.from_numpy(tok)}, tc)
        assert _rel_max(got, want) < 1e-3, i
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)


@pytest.mark.parametrize("mechanism", ["sla2", "full"])
def test_generate_sequential_and_static_wave_match_the_reference(
        lm, mechanism):
    jm, jp, tm, tp = lm
    if mechanism == "full":
        jm = jbuild(get_smoke_config("qwen3_14b", mechanism="full"))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(tsmoke("qwen3_14b", mechanism="full"))
        tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tm.cfg,
                                  device="cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (40, 64, 9)]
    for p in prompts[:2]:
        n = -(-len(p) // 32) * 32                 # SLA2 prefill: whole blocks
        pp = np.concatenate([np.zeros(n - len(p), np.int32), p])
        want = jgenerate(jm, jp, pp, max_new_tokens=8, max_len=128)
        got = generate_sequential(tm, tp, pp, max_new_tokens=8, max_len=128,
                                  device="cpu")
        assert got == want
    jeng = JStatic(jm, JEngineConfig(max_slots=2, max_len=128))
    teng = StaticWaveEngine(tm, EngineConfig(max_slots=2, max_len=128),
                            device="cpu")
    jeng.load(jp)
    teng.load(tp)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(uid=i, prompt=p, max_new_tokens=6 + i))
        teng.submit(Request(uid=i, prompt=p, max_new_tokens=6 + i))
    want = {r.uid: r.output for r in jeng.run_to_completion()}
    got = {r.uid: r.output for r in teng.run_to_completion()}
    assert got == want
    assert teng.stats == jeng.stats
    with pytest.raises(ValueError, match="exceed max_len"):
        teng.submit(Request(uid=9, prompt=prompts[0], max_new_tokens=100))


def test_paged_engine_matches_generate_sequential_for_full(lm):
    """The port's paged ServeEngine (mechanism full, f32 pages, ragged
    prompts, a late joiner, chunked prefill) gives the static oracle's
    greedy tokens, as the reference's serving test holds its engine."""
    tm = build_model(tsmoke("qwen3_14b", mechanism="full"))
    tp = tm.init(0, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, n).astype(np.int32)
               for n in (5, 37, 90, 17)]
    with torch.no_grad():
        ref = [generate_sequential(tm, tp, p, max_new_tokens=8, max_len=192,
                                   cache_dtype="float32", device="cpu")
               for p in prompts]
    eng = ServeEngine(tm, EngineConfig(max_slots=2, max_len=192,
                                       prefill_chunk=32, num_pages=25,
                                       page_dtype="float32"), device="cpu")
    eng.load(tp)
    for i, p in enumerate(prompts[:3]):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=8))
    for _ in range(3):
        eng.step()
    eng.submit(Request(uid=3, prompt=prompts[3], max_new_tokens=8))
    out = {r.uid: r.output for r in eng.run_to_completion()}
    assert [out[i] for i in range(4)] == ref


def test_scenario_builders():
    """serve/scenario.py: the overcommitted work list equals the
    reference's, and the paged state it builds decodes alike through the
    fused entries (their plain versions here) and the gather reference."""
    from repro.serve import scenario as JSC
    from repro_torch.serve import scenario as TSC
    for kw in (dict(max_slots=3, page_size=16), dict(
            max_slots=2, page_size=64, overcommit=3.0, n_requests=7,
            seed=4)):
        assert TSC.overcommit_workload(**kw) == JSC.overcommit_workload(**kw)
    for mech in ("sla2", "full"):
        cfg, params, cache, pt, x_t = TSC.make_paged_attention_state(
            mechanism=mech, device="cpu")
        lengths = torch.tensor([37, 16, 70], dtype=torch.int32)
        active = torch.ones(3, dtype=torch.bool)
        outs = []
        for impl in ("fused", "gather"):
            c = {k: v.clone() for k, v in cache.items()}
            with torch.no_grad():
                o, _ = TA.decode_step_paged(
                    params, dataclasses.replace(cfg, paged_impl=impl), x_t,
                    c, page_table=pt, lengths=lengths, active=active)
            outs.append(o)
        assert torch.isfinite(outs[0]).all()
        assert _rel_max(outs[0], outs[1]) < 1e-4
