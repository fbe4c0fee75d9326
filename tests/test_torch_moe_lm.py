"""The MoE layer kind in the port's LM, and llama3-405b, against the JAX
package on the CPU.

The llama4-maverick smoke config (a (dense, moe) group: 8 experts, top-1,
one shared expert, default capacity 1.25) and the llama3-405b smoke config
(8 query / 2 KV heads) take the reference's params, carried across by
``convert.lm_params_from_numpy``.  Both packages then run the same calls:
the full-sequence forward, the loss and its gradients, paged prefill and
decode (gather and fused), the paged ``ServeEngine`` (with a late joiner,
the linear drafter, the prefix cache), ``generate_sequential`` and
``StaticWaveEngine``.  The MoE capacity depends on the rows of each call,
so the engines must give the MoE every row the reference gives it
(inactive slots and padding included) for the tokens to match.
``first_kinds`` layers (the reference's ``prefix_layers``) are carried
across to their place in the stack.

Bounds: forward logits and aux 1e-5 relative; loss 1e-5 and gradients
1e-4 (relative max error over all leaves); paged prefill logits 1e-5,
decode logits and cache leaves 1e-3 (as tests/test_torch_lm.py);
tokens and the engine stats both engines keep identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import get_smoke_config
from repro.models import transformer as JT
from repro.models.api import build_model as jbuild
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import StaticWaveEngine as JStatic
from repro.serve import generate_sequential as jgenerate
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config as tsmoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.models.api import build_model
from repro_torch.serve.engine import (EngineConfig, Request, ServeEngine,
                                      StaticWaveEngine, generate_sequential)
from test_torch_lm import _serve_both
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LLAMA4, LLAMA3 = "llama4_maverick_400b", "llama3_405b"


def _models(name, **over):
    """(jax model, jax params, port model, port params) of a smoke
    config, the reference's params carried across."""
    jm = jbuild(get_smoke_config(name, **over))
    jp = jm.init(jax.random.PRNGKey(3))
    tm = build_model(tsmoke(name, **over))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tm.cfg,
                              device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _models(name)
        return cache[name]
    return get


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", [LLAMA4, LLAMA3])
def test_configs_are_the_reference_configs(name):
    """Every field the reference sets away from its ModelConfig default
    is the port's, but ``family`` and ``ep_axis``; the MoE config field
    for field."""
    assert name in ARCH_NAMES
    ref_default = type(jget(name))()
    for j, t in ((jget(name), get_config(name)),
                 (get_smoke_config(name), tsmoke(name))):
        port_fields = {f.name for f in dataclasses.fields(t)}
        for f in dataclasses.fields(j):
            val = getattr(j, f.name)
            if f.name not in port_fields:
                assert f.name in ("family", "ep_axis") or \
                    val == getattr(ref_default, f.name), f.name
            elif f.name == "moe" and val is not None:
                assert dataclasses.asdict(t.moe) == dataclasses.asdict(val)
            else:
                assert getattr(t, f.name) == val, f.name
        build_model(t)
    cfg = get_config(name)
    if name == LLAMA3:
        assert cfg.num_heads // cfg.num_kv_heads == 16
    else:
        assert TT.layer_kinds(cfg)[:4] == ["dense", "moe", "dense", "moe"]


@pytest.mark.parametrize("name", [LLAMA4, LLAMA3])
def test_forward_logits_and_aux_match_the_reference(models, name):
    jm, jp, tm, tp = models(name)
    jcfg = dataclasses.replace(jm.cfg, quant_bits="none")
    tcfg = dataclasses.replace(tm.cfg, quant_bits="none")
    toks = np.random.default_rng(4).integers(1, 256, (2, 64)).astype(
        np.int32)
    hidden, jaux = JT.forward(jp, jcfg, jnp.asarray(toks))
    want = JT.logits_from_hidden(jp, jcfg, hidden)
    with torch.no_grad():
        h, taux = TT.forward(tp, tcfg, torch.from_numpy(toks))
        got = TT.logits_from_hidden(tp, tcfg, h)
    assert got.shape == want.shape and _rel(got, want) < 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-5 * max(abs(float(jaux)),
                                                        1e-30)
    assert (float(jaux) > 0) == (name == LLAMA4)


def test_moe_loss_and_grads_match_jax(models):
    """lm_loss (CE + z-loss + aux) and its gradient on every leaf, the
    port through the kernel-mode sparse branch (plain versions here)."""
    jm, jp, _, _ = models(LLAMA4)
    over = dict(quant_bits="none", loss_chunk=40, z_loss=1e-3)
    jcfg = get_smoke_config(LLAMA4, **over)
    tcfg = tsmoke(LLAMA4, sla2_impl="kernel", **over)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :5] = -1
    (jl, jmet), jg = jax.value_and_grad(JT.lm_loss, has_aux=True)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    loss, met = TT.lm_loss(params, tcfg, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(met["aux"]) - float(jmet["aux"])) <= 1e-5 * float(
        jmet["aux"])
    want = {n: p.detach().numpy() for n, p in lm_params_from_numpy(
        jax.tree.map(np.asarray, jg), tcfg, device="cpu").named_parameters()}
    got = {n: np.zeros(want[n].shape, np.float32) if g is None
           else g.numpy() for n, g in zip(names, grads)}
    assert set(got) == set(want)
    assert np.any(got["layers.1.moe.w_in"]) and np.any(
        got["layers.1.moe.router"])
    num = max(float(np.abs(got[n] - want[n]).max()) for n in want)
    assert num / max(float(np.abs(w).max()) for w in want.values()) < 1e-4


@pytest.mark.parametrize("name", [LLAMA4, LLAMA3])
@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_paged_prefill_and_decode_match_the_reference(models, name, impl):
    logits, tc, jc = _serve_both(models(name), impl)
    for phase, t, j in logits:
        assert t.shape == j.shape
        assert _rel(t, j) < (1e-5 if phase == "prefill" else 1e-3), phase
    cfg = models(name)[2].cfg
    for lc, (_, place) in zip(tc["layers"], TT.layer_layout(cfg)):
        for key in ("k_pages", "pooled_pages", "h_tot", "z_tot"):
            want = np.asarray(jc[place[0]][place[1]]["attn"][key][place[2]])
            assert _rel(lc[key], want) < 1e-3, (place, key)


def _serve(model, params, prompts, *, jax_engine, waves=1, **kw):
    """Serve ``prompts`` (the last joining three steps late) through a
    fresh engine; with ``waves`` 2 the 64-token third prompt is served
    again after the drain.  Returns ({uid: tokens}, stats)."""
    cfg = dict(max_slots=3, max_len=160, prefill_chunk=32, **kw)
    if jax_engine:
        eng, req = JServeEngine(model, JEngineConfig(**cfg)), JRequest
    else:
        eng, req = ServeEngine(model, EngineConfig(**cfg),
                               device="cpu"), Request
    eng.load(params)
    for i, p in enumerate(prompts[:-1]):
        eng.submit(req(uid=i, prompt=p, max_new_tokens=8))
    for _ in range(3):
        eng.step()
    eng.submit(req(uid=len(prompts) - 1, prompt=prompts[-1],
                   max_new_tokens=8))
    eng.run_to_completion(max_steps=2000)
    if waves == 2:
        eng.submit(req(uid=len(prompts), prompt=prompts[2].copy(),
                       max_new_tokens=8))
        eng.run_to_completion(max_steps=2000)
    return {r.uid: r.output for r in eng.completed}, dict(eng.stats)


@pytest.mark.parametrize("name,impl,extra", [
    (LLAMA4, "gather", {}), (LLAMA4, "fused", {}),
    (LLAMA3, "gather", {}), (LLAMA3, "fused", {}),
    (LLAMA4, "fused", {"speculative": "linear", "draft_len": 3}),
    (LLAMA4, "fused", {"prefix_cache": True})])
def test_engine_tokens_and_stats_match_the_reference(models, name, impl,
                                                     extra):
    """Default capacity, mixed lengths, a late joiner; with the prefix
    cache, a second wave that hits the first prompt's pages."""
    jm, jp, tm, tp = models(name)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, n).astype(np.int32)
               for n in (7, 45, 64, 21)]
    waves = 2 if extra.get("prefix_cache") else 1
    want, jstats = _serve(jm, jp, prompts, jax_engine=True, waves=waves,
                          paged_impl="gather", **extra)
    got, stats = _serve(tm, tp, prompts, jax_engine=False, waves=waves,
                        paged_impl=impl, **extra)
    assert got == want
    shared = sorted(set(stats) & set(jstats))
    assert {"engine_steps", "prefill_tokens", "spec_steps", "prefix_hits",
            "cow_copies", "pool_peak_pages"} <= set(shared)
    assert {k: stats[k] for k in shared} == {k: jstats[k] for k in shared}
    if extra.get("speculative"):
        assert stats["spec_steps"] > 0 and stats["spec_accepted"] > 0
    if waves == 2:
        assert stats["prefix_hits"] == 1 and stats["cow_copies"] > 0


def test_generate_sequential_and_static_wave_match_the_reference(models):
    """The static cache path: the MoE sees the whole left-padded wave."""
    jm, jp, tm, tp = models(LLAMA4)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (40, 64, 9)]
    pp = np.concatenate([np.zeros(24, np.int32), prompts[0]])
    want = jgenerate(jm, jp, pp, max_new_tokens=8, max_len=128)
    assert generate_sequential(tm, tp, pp, max_new_tokens=8, max_len=128,
                               device="cpu") == want
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


@pytest.mark.parametrize("name,over", [
    ("qwen3_14b", dict(first_kinds=("dense",), n_layers=3)),
    (LLAMA4, dict(first_kinds=("dense",), n_layers=3))])
def test_first_kinds_layers_take_their_reference_place(name, over):
    """The reference's prefix layers run first: carried across, the
    stack's forward gives the reference's logits (a tree with a prefix
    layer used to be read shifted by one layer)."""
    jm, jp, tm, tp = _models(name, **over)
    assert [p for _, p in TT.layer_layout(tm.cfg)][:2] == [
        ("prefix_layers", 0), ("groups", "l0", 0)]
    jcfg = dataclasses.replace(jm.cfg, quant_bits="none")
    tcfg = dataclasses.replace(tm.cfg, quant_bits="none")
    toks = np.random.default_rng(9).integers(1, 256, (2, 64)).astype(
        np.int32)
    hidden, jaux = JT.forward(jp, jcfg, jnp.asarray(toks))
    want = JT.logits_from_hidden(jp, jcfg, hidden)
    with torch.no_grad():
        h, taux = TT.forward(tp, tcfg, torch.from_numpy(toks))
        got = TT.logits_from_hidden(tp, tcfg, h)
    assert _rel(got, want) < 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-5 * max(abs(float(jaux)),
                                                        1e-30)
    with pytest.raises(ValueError, match="whole number of groups"):
        build_model(tsmoke(name, first_kinds=("dense",), n_layers=4,
                           layer_kinds=("dense", "dense")))


def test_moe_train_step_continues_from_a_jax_state(models):
    """Step 2 from the reference's step-1 llama4 train state (the AdamW
    moments of the expert tensors in their JAX layout), carried across by
    train_state_from_numpy, matches the reference's step 2: loss 1e-5,
    params within 2 lr."""
    from repro.data import make_dataset as jmake_dataset
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import adamw_init as jadamw_init
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import make_train_step as jmake_train_step
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, make_train_step
    lr = 1e-3
    jm, jp, _, _ = models(LLAMA4)
    jcfg = get_smoke_config(LLAMA4, quant_bits="none")
    tcfg = tsmoke(LLAMA4, quant_bits="none", sla2_impl="kernel")
    jtc = JTrainConfig(optimizer=JAdamW(lr=lr), warmup_steps=1,
                       total_steps=10)
    jstep = jmake_train_step(jbuild(jcfg), jtc, donate=False)
    ds = jmake_dataset(jcfg, seq_len=64, global_batch=2, seed=5)
    jst, _ = jstep({"params": jp, "opt": jadamw_init(jp, jtc.optimizer)},
                   {k: jnp.asarray(v) for k, v in ds[0].items()})
    tst = train_state_from_numpy(jax.tree.map(np.asarray, jst), tcfg,
                                 device="cpu")
    m_w_in = np.asarray(jst["opt"]["m"]["groups"]["l1"]["moe"]["w_in"][0])
    assert np.array_equal(tst["opt"]["m"]["layers.1.moe.w_in"].numpy(),
                          m_w_in)
    jst2, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in ds[1].items()})
    ttc = TrainConfig(optimizer=AdamWConfig(lr=lr), warmup_steps=1,
                      total_steps=10)
    tst2, tmet = make_train_step(build_model(tcfg), ttc)(
        tst, {k: torch.from_numpy(v) for k, v in ds[1].items()})
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-5 * float(
        jmet["loss"])
    assert abs(float(tmet["aux"]) - float(jmet["aux"])) <= 1e-5 * float(
        jmet["aux"])
    want = lm_params_from_numpy(jax.tree.map(np.asarray, jst2["params"]),
                                tcfg, device="cpu")
    for (n, p), w in zip(tst2["params"].named_parameters(),
                         want.parameters()):
        assert float((p.detach() - w.detach()).abs().max()) <= 2 * lr, n
