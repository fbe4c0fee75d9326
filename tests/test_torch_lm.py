"""The port's LM (qwen3-14b smoke config) against the JAX package.

The reference's params (``model.init(PRNGKey(0))``) are carried across with
``convert.lm_params_from_numpy``; both packages then prefill the same
prompts chunk by chunk into the same page table and decode the same
tokens, under ``paged_impl="gather"`` and ``"fused"`` (the Pallas kernels
in interpret mode on one side, the kernels' plain versions on the other).
The pools are f32, so the cache leaves compare without bf16 rounding.

Bounds: prefill logits 1e-5 relative max error; decode logits 1e-3 and
the cache leaves after the decode steps 1e-3.  Decode runs the linear
complement, ``(phi(q) h_tot - lnum) / (phi(q) z_tot - lden)``, whose
subtraction amplifies f32 differences in the sums (the reference's own
fused and gather paths differ by ~2e-4 on one layer); the errors then
carry into the next layer's K/V.  Layers are held to their reference at
1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.api import build_model as jbuild
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config as tsmoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

C, B, N_PAGES, MAX_P = 32, 2, 24, 8


@pytest.fixture(scope="module")
def ref():
    """(jax model, jax params as numpy, port model, port params)."""
    jm = jbuild(get_smoke_config("qwen3_14b"))
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tm = build_model(tsmoke("qwen3_14b"))
    return jm, jp, tm, lm_params_from_numpy(tree, tm.cfg, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_config_is_the_reference_config():
    from repro.configs import get_config as jget
    assert "qwen3_14b" in ARCH_NAMES
    for name in ("config", "smoke"):
        j = (jget if name == "config" else get_smoke_config)("qwen3_14b")
        t = (get_config if name == "config" else tsmoke)("qwen3_14b")
        for f in dataclasses.fields(t):
            if hasattr(j, f.name):
                assert getattr(t, f.name) == getattr(j, f.name), f.name


def test_layers_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 40000, (2, 5)).astype(np.int32)
    scale = rng.standard_normal(16).astype(np.float32)
    norm = TL.init_rmsnorm(16)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        got = TL.rmsnorm(norm, torch.from_numpy(x))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    assert _rel(got, want) < 1e-6
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        theta=1e6)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6)
    assert _rel(got, want) < 1e-5          # cos / sin of angles up to 4e4
    cos, sin = TL.rope_frequencies(16, 64, 1e4)
    jcos, jsin = JL.rope_frequencies(16, 64, 1e4)
    assert _rel(cos, jcos) < 1e-5 and _rel(sin, jsin) < 1e-5
    g = torch.Generator().manual_seed(0)
    mlp = TL.init_gated_mlp(g, 16, 24)
    tree = {k: getattr(mlp, k).weight.detach().numpy().T
            for k in ("w_up", "w_down", "w_gate")}
    got = TL.gated_mlp(mlp, torch.from_numpy(x)).detach()
    want = JL.mlp({k: jnp.asarray(v) for k, v in tree.items()},
                  jnp.asarray(x))
    assert _rel(got, want) < 1e-6
    table = rng.standard_normal((11, 16)).astype(np.float32)
    ids = np.array([[3, 0, 10]], np.int32)
    assert np.array_equal(TL.embed(torch.from_numpy(table),
                                   torch.from_numpy(ids)).numpy(),
                          np.asarray(JL.embed({"table": table}, ids)))
    assert _rel(TL.unembed(torch.from_numpy(table), torch.from_numpy(x)),
                JL.unembed({"table": table}, jnp.asarray(x))) < 1e-6


def test_converted_params_give_the_reference_logits(ref):
    """Carry-across: every leaf of the reference lands in the port (the
    untied head transposed), so one f32 head product agrees."""
    jm, jp, tm, tp = ref
    h = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32)
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    got = TT.logits_from_hidden(tp, tm.cfg, torch.from_numpy(h))
    want = JT.logits_from_hidden(jp, jm.cfg, jnp.asarray(h))
    assert _rel(got, want) < 1e-6
    n_ref = sum(np.asarray(x).size for x in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref


def _serve_both(ref, impl, kv_quant="none", quant="none"):
    """Prefill two prompts (40 and 23 tokens, chunks of 32) and decode 10
    steps in both packages; returns the per-call logits and final caches."""
    jm, jp, tm, tp = ref
    over = dict(paged_impl=impl, kv_quant=kv_quant, decode_quant_bits=quant)
    jm, tm = jm.with_overrides(**over), tm.with_overrides(**over)
    j_prefill, j_decode = jax.jit(jm.prefill_chunk), jax.jit(jm.decode_paged)
    jc = jm.init_paged_caches(B, N_PAGES, dtype=jnp.float32)
    tc = tm.init_paged_caches(B, N_PAGES, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (40, 23)]
    pt = np.zeros((B, MAX_P), np.int32)
    pt[0, :3], pt[1, :2] = [3, 7, 1], [2, 5]
    logits = []
    for s, p in enumerate(prompts):
        for pos in range(0, len(p), C):
            n = min(C, len(p) - pos)
            toks = np.zeros((1, C), np.int32)
            toks[0, :n] = p[pos:pos + n]
            jl, jc = j_prefill(jp, {
                "tokens": jnp.asarray(toks), "page_row": jnp.asarray(pt[s]),
                "offset": jnp.asarray(pos, jnp.int32),
                "chunk_len": jnp.asarray(n, jnp.int32),
                "slot": jnp.asarray(s, jnp.int32)}, jc)
            with torch.no_grad():
                tl, tc = tm.prefill_chunk(tp, {
                    "tokens": torch.from_numpy(toks),
                    "page_row": torch.from_numpy(pt[s]), "offset": pos,
                    "chunk_len": n, "slot": s}, tc)
            logits.append(("prefill", tl.numpy(), np.asarray(jl)))
    lengths = np.array([40, 23], np.int32)
    tok = np.array([5, 9], np.int32)
    active = np.array([True, True])
    fresh = iter(range(10, N_PAGES))
    for _ in range(10):
        for s in range(B):
            if pt[s, lengths[s] // 16] == 0:
                pt[s, lengths[s] // 16] = next(fresh)
        jl, jc = j_decode(jp, {
            "token": jnp.asarray(tok), "page_table": jnp.asarray(pt),
            "lengths": jnp.asarray(lengths), "active": jnp.asarray(active)},
            jc)
        with torch.no_grad():
            tl, tc = tm.decode_paged(tp, {
                "token": torch.from_numpy(tok),
                "page_table": torch.from_numpy(pt),
                "lengths": torch.from_numpy(lengths),
                "active": torch.from_numpy(active)}, tc)
        logits.append(("decode", tl.numpy(), np.asarray(jl)))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        assert np.array_equal(tok, tl.numpy().argmax(-1))
        lengths += 1
    return logits, tc, jc


@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_prefill_and_decode_match_the_reference(ref, impl):
    logits, tc, jc = _serve_both(ref, impl)
    for phase, t, j in logits:
        assert t.shape == j.shape
        assert _rel(t, j) < (1e-5 if phase == "prefill" else 1e-3), phase
    for li, lc in enumerate(tc["layers"]):
        for key in ("k_pages", "pooled_pages", "h_tot", "z_tot"):
            want = np.asarray(jc["groups"]["l0"]["attn"][key][li])
            assert _rel(lc[key], want) < 1e-3, (li, key)


def test_quantised_pool_and_qat_decode_match_the_reference(ref):
    logits, tc, jc = _serve_both(ref, "fused", kv_quant="int8", quant="int8")
    for phase, t, j in logits:
        assert _rel(t, j) < (1e-5 if phase == "prefill" else 1e-3), phase
    lc = tc["layers"][0]
    jl0 = jax.tree.map(lambda x: np.asarray(x[0]),
                       jc["groups"]["l0"]["attn"])
    assert lc["k_pages"].dtype == torch.int8
    assert _rel(lc["k_scale"], jl0["k_scale"]) < 1e-3


def test_decode_step_matches_on_random_pools(ref):
    """One layer's decode on a random pool: output, written rows, pooled
    keys and totals.  Raw routed ids are not compared: torch.topk and
    lax.top_k may order the NEG_INF padding entries differently, and no
    output depends on them."""
    jm, jp, tm, tp = ref
    rng = np.random.default_rng(3)
    jcfg, tcfg = jm.cfg.attention_config(), tm.cfg.attention_config()
    jcache = JA.init_paged_cache(jcfg, 12, 2, jnp.float32)
    tcache = TA.init_paged_cache(tcfg, 12, 2, torch.float32)
    for key in jcache:
        a = np.abs(rng.standard_normal(jcache[key].shape)).astype(np.float32)
        jcache[key] = jnp.asarray(a)
        tcache[key] = torch.from_numpy(a.copy())
    lp = jax.tree.map(lambda x: x[0], jp["groups"]["l0"]["attn"])
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    pt = np.array([[3, 7, 1, 9, 0, 0, 0, 0], [2, 5, 11, 4, 0, 0, 0, 0]],
                  np.int32)
    lengths, active = np.array([47, 23], np.int32), np.array([True, True])
    jo, jc2 = jax.jit(lambda c, *a: JA.decode_step_paged(
        lp, jcfg, a[0], c, page_table=a[1], lengths=a[2], active=a[3]))(
        jcache, *(jnp.asarray(a) for a in (x, pt, lengths, active)))
    with torch.no_grad():
        to, tc2 = TA.decode_step_paged(
            tp.layers[0].attn, tcfg, torch.from_numpy(x), tcache,
            page_table=torch.from_numpy(pt),
            lengths=torch.from_numpy(lengths),
            active=torch.from_numpy(active))
    assert _rel(to, jo) < 1e-5
    for key in ("k_pages", "v_pages", "pooled_pages", "h_tot", "z_tot"):
        assert _rel(tc2[key], jc2[key]) < 1e-5, key


def test_swap_state_round_trips(ref):
    _, _, tm, tp = ref
    caches = tm.init_paged_caches(2, 10, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    for lc in caches["layers"]:
        for t in lc.values():
            t.copy_(torch.randn(t.shape, generator=g))
    state = tm.swap_out(caches, np.array([4, 2, 7]), 1)
    before = [{k: v.clone() for k, v in lc.items()}
              for lc in caches["layers"]]
    caches = tm.swap_in(caches, np.array([8, 9, 3]), 0, state)
    back = tm.swap_out(caches, np.array([8, 9, 3]), 0)
    for a, b in zip(state["layers"], back["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    untouched = [i for i in range(10) if i not in (8, 9, 3)]
    for lc, old in zip(caches["layers"], before):
        assert torch.equal(lc["k_pages"][untouched], old["k_pages"][untouched])
        assert torch.equal(lc["h_tot"][1], old["h_tot"][1])
    with pytest.raises(ValueError, match="does not exist"):
        TA.insert_paged_state(caches["layers"][0], [1], 0,
                              {"s_state": torch.zeros(1)})


def test_dispatch_and_what_is_not_ported(ref):
    _, _, tm, _ = ref
    acfg = tm.cfg.attention_config()
    assert TA.resolve_paged_impl(acfg, "cpu") == "gather"
    assert TA.resolve_paged_impl(acfg, "cuda") == "fused"
    assert TA.use_fused(dataclasses.replace(acfg, paged_impl="fused"),
                        "decode", "cpu")
    assert set(TA.PAGED_DISPATCH) == set(JA.PAGED_DISPATCH)
    assert {k: v[0] for k, v in TA.PAGED_DISPATCH.items()} == {
        k: v[0] for k, v in JA.PAGED_DISPATCH.items()}
    assert set(TA.PORTED_ENTRIES) == {v[0] for v in JA.PAGED_DISPATCH.values()}
    assert TA.fused_entry_fn("dense_decode_fused") is not None
    with pytest.raises(NotImplementedError, match="not a paged kernel"):
        TA.fused_entry_fn("dense_decode_gather")
    for mech in ("sla", "sparse_only"):
        p = TA.init_attention(torch.Generator(), dataclasses.replace(
            acfg, mechanism=mech))
        assert p.sla2 is None
        if mech == "sla":
            assert p.sla.proj_l.shape == (acfg.head_dim, acfg.head_dim)
        else:
            assert p.sla is None
    with pytest.raises(ValueError, match="unknown mechanism"):
        TA.init_attention(torch.Generator(), dataclasses.replace(
            acfg, mechanism="moba"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(tsmoke("qwen3_14b", layer_kinds=("moe",)))


# ---------------------------------------------------------------------------
# internlm2-20b: 6 query heads a KV head, no qk-norm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def internlm2():
    """(jax model, jax params, port model, port params) of the internlm2
    smoke config, the reference's params carried across."""
    jm = jbuild(get_smoke_config("internlm2_20b"))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(tsmoke("internlm2_20b"))
    tree = jax.tree.map(np.asarray, jp)
    return jm, jp, tm, lm_params_from_numpy(tree, tm.cfg, device="cpu")


def test_internlm2_config_is_the_reference_config():
    from repro.configs import get_config as jget
    assert "internlm2_20b" in ARCH_NAMES
    for j, t in ((jget("internlm2_20b"), get_config("internlm2_20b")),
                 (get_smoke_config("internlm2_20b"),
                  tsmoke("internlm2_20b"))):
        for f in dataclasses.fields(t):
            if hasattr(j, f.name):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
    cfg = get_config("internlm2_20b")
    assert cfg.num_heads // cfg.num_kv_heads == 6 and not cfg.qk_norm
    build_model(cfg)                         # the port takes the config


def test_internlm2_forward_logits_match_the_reference(internlm2):
    """Full-sequence forward (quant none), logits of every position."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    jm, jp, tm, tp = internlm2
    jcfg = dataclasses.replace(jm.cfg, quant_bits="none")
    tcfg = dataclasses.replace(tm.cfg, quant_bits="none")
    toks = np.random.default_rng(4).integers(1, 256, (2, 64)).astype(
        np.int32)
    hidden, _ = JT.forward(jp, jcfg, jnp.asarray(toks))
    want = JT.logits_from_hidden(jp, jcfg, hidden)
    with torch.no_grad():
        h, _ = TT.forward(tp, tcfg, torch.from_numpy(toks))
        got = TT.logits_from_hidden(tp, tcfg, h)
    assert got.shape == want.shape and _rel(got, want) < 1e-5


@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_internlm2_prefill_and_decode_match_the_reference(internlm2, impl):
    logits, tc, jc = _serve_both(internlm2, impl)
    for phase, t, j in logits:
        assert t.shape == j.shape
        assert _rel(t, j) < (1e-5 if phase == "prefill" else 1e-3), phase
    for li, lc in enumerate(tc["layers"]):
        for key in ("k_pages", "pooled_pages", "h_tot", "z_tot"):
            want = np.asarray(jc["groups"]["l0"]["attn"][key][li])
            assert _rel(lc[key], want) < 1e-3, (li, key)


@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_internlm2_engine_tokens_match_the_reference(internlm2, impl):
    """Greedy tokens of the paged engines, mixed lengths and a late
    joiner, with a whole-prompt prefix hit on the second wave."""
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    jm, jp, tm, tp = internlm2
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, n).astype(np.int32)
               for n in (7, 45, 64, 21)]
    outs = []
    for eng, req in (
            (JServeEngine(jm, JEngineConfig(
                max_slots=3, max_len=160, prefill_chunk=32,
                paged_impl="gather", prefix_cache=True)), JRequest),
            (ServeEngine(tm, EngineConfig(
                max_slots=3, max_len=160, prefill_chunk=32, paged_impl=impl,
                prefix_cache=True), device="cpu"), Request)):
        eng.load(jp if req is JRequest else tp)
        for i, p in enumerate(prompts[:3]):
            eng.submit(req(uid=i, prompt=p, max_new_tokens=8))
        for _ in range(3):
            eng.step()
        eng.submit(req(uid=3, prompt=prompts[3], max_new_tokens=8))
        eng.run_to_completion(max_steps=2000)
        eng.submit(req(uid=4, prompt=prompts[2].copy(), max_new_tokens=8))
        eng.run_to_completion(max_steps=2000)
        outs.append(({r.uid: r.output for r in eng.completed},
                     eng.stats["prefix_hits"], eng.stats["cow_copies"]))
    assert outs[0] == outs[1]
    assert outs[1][0][4] == outs[1][0][2] and outs[1][1:] == (1, 2)
