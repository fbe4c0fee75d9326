"""The port's speculative decoding against the JAX ServeEngine (qwen3-14b
smoke config, the reference's params carried across), a mirror of
tests/test_speculative.py.

Greedy speculative serving, with the SLA2 linear drafter and with the
n-gram drafter on a ``mechanism="full"`` stack, emits the tokens of
``speculative="off"`` and of the reference engine run the same way, with
the same ``spec_*`` stats, on the fused (plain kernel versions on the
CPU) and gather paths; so it does under drafts that are always rejected,
and when a pool too small for all slots preempts slots mid-draft, by swap
and by recompute.  Sampled speculation (temperature > 0) makes the
reference's draws from the same numpy generator and emits its tokens.
The acceptance units, ``ngram_propose`` and the engine's gating are
checked on the same inputs as the reference's.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.models.api import build_model as jbuild
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import speculative as JS
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.api import build_model
from repro_torch.serve import speculative as TS
from repro_torch.serve.engine import (EngineConfig, Request, ServeEngine,
                                      _Slot)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MAX_LEN, MAX_NEW = 192, 8


def _models(mechanism):
    jm = jbuild(get_smoke_config("qwen3_14b", mechanism=mechanism))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tsmoke("qwen3_14b", mechanism=mechanism))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tm.cfg,
                              device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def sla2():
    return _models("sla2")


@pytest.fixture(scope="module")
def full():
    return _models("full")


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).astype(np.int32) for n in lengths]


def _serve(models, prompts, *, jax_engine=False, late_idx=None,
           max_new=MAX_NEW, **kw):
    """Serve ``prompts`` (one joining three steps late) through a fresh
    engine of the port, or of the reference; ({uid: tokens}, engine)."""
    jm, jp, tm, tp = models
    if jax_engine:
        eng = JServeEngine(jm, JEngineConfig(max_len=MAX_LEN,
                                             prefill_chunk=32, **kw))
        eng.load(jp)
        req = JRequest
    else:
        eng = ServeEngine(tm, EngineConfig(max_len=MAX_LEN, prefill_chunk=32,
                                           **kw), device="cpu")
        eng.load(tp)
        req = Request
    for i, p in enumerate(prompts):
        if i != late_idx:
            eng.submit(req(uid=i, prompt=p, max_new_tokens=max_new))
    if late_idx is not None:
        for _ in range(3):
            eng.step()
        eng.submit(req(uid=late_idx, prompt=prompts[late_idx],
                       max_new_tokens=max_new))
    done = eng.run_to_completion(max_steps=4000)
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    return {r.uid: r.output for r in done}, eng


SPEC_STATS = ("spec_steps", "spec_drafted", "spec_accepted", "engine_steps")


@pytest.mark.parametrize("mech,spec,prompt_lens,slots", [
    ("sla2", "linear", (7, 45, 80, 21), 3),
    ("full", "ngram", (7, 45, 21), 2)])
def test_greedy_speculation_matches_off_and_the_reference(
        sla2, full, mech, spec, prompt_lens, slots):
    models = sla2 if mech == "sla2" else full
    prompts = _prompts(prompt_lens, seed=11)
    late = len(prompts) - 1
    off, _ = _serve(models, prompts, late_idx=late, max_slots=slots)
    want, jeng = _serve(models, prompts, jax_engine=True, late_idx=late,
                        max_slots=slots, speculative=spec, draft_len=3,
                        paged_impl="gather")
    assert want == off
    for impl in ("fused", "gather"):
        got, eng = _serve(models, prompts, late_idx=late, max_slots=slots,
                          speculative=spec, draft_len=3, paged_impl=impl)
        assert got == off, impl
        assert {k: eng.stats[k] for k in SPEC_STATS} == {
            k: jeng.stats[k] for k in SPEC_STATS}, impl
        assert eng.stats["spec_steps"] > 0 and eng.stats["spec_drafted"] > 0
        assert eng.allocator.available == eng.allocator.num_pages - 1
    if spec == "linear":
        assert eng.stats["spec_accepted"] > 0


def test_forced_all_reject_still_exact(sla2, monkeypatch):
    prompts = _prompts([7, 45, 21], seed=12)
    ref, _ = _serve(sla2, prompts, max_slots=3)
    bad = max(t for out in ref.values() for t in out) + 1   # never emitted
    assert bad < 256

    def wrong_draft(self, tokens0, active):
        k = self.cfg.draft_len
        return np.full((self.cfg.max_slots, k), bad, np.int32), None

    monkeypatch.setattr(ServeEngine, "_draft", wrong_draft)
    out, eng = _serve(sla2, prompts, max_slots=3, speculative="linear",
                      draft_len=3)
    assert eng.stats["spec_accepted"] == 0 and eng.stats["spec_drafted"] > 0
    assert out == ref


@pytest.mark.parametrize("mech,spec,swap_pages", [
    ("sla2", "linear", None), ("sla2", "linear", 0),
    ("full", "ngram", None), ("full", "ngram", 0)])
def test_preemption_mid_speculation_is_exact(sla2, full, mech, spec,
                                             swap_pages):
    """A pool below demand preempts slots mid-draft (the uncommitted window
    is discarded); swap-resume and recompute (the teacher-forced replay
    rides the verify window) both give the undisturbed tokens."""
    models = sla2 if mech == "sla2" else full
    prompts = _prompts([20, 35, 28, 40], seed=13)
    ref, _ = _serve(models, prompts, late_idx=3, max_slots=3)
    out, eng = _serve(models, prompts, late_idx=3, max_slots=3,
                      speculative=spec, draft_len=3, num_pages=8,
                      swap_pages=swap_pages)
    assert eng.stats["preemptions"] > 0
    if swap_pages == 0:
        assert eng.stats["recomputes"] > 0 and eng.stats["swap_outs"] == 0
    else:
        assert eng.stats["swap_outs"] > 0 and eng.swap.used == 0
    assert out == ref
    assert eng.allocator.available == eng.allocator.num_pages - 1


@pytest.mark.parametrize("mech,spec", [("sla2", "linear"),
                                       ("full", "ngram")])
def test_sampled_speculation_matches_the_reference(sla2, full, mech, spec):
    models = sla2 if mech == "sla2" else full
    prompts = _prompts([9, 33], seed=15)
    kw = dict(max_slots=2, max_new=10, speculative=spec, draft_len=3,
              temperature=0.8, seed=4, paged_impl="gather")
    want, jeng = _serve(models, prompts, jax_engine=True, **kw)
    got, eng = _serve(models, prompts, **kw)
    assert got == want
    assert {k: eng.stats[k] for k in SPEC_STATS} == {
        k: jeng.stats[k] for k in SPEC_STATS}
    assert all(len(v) == 10 for v in got.values())


def test_window_len_and_gating(sla2, full):
    _, _, tm, _ = sla2
    eng = ServeEngine(tm, EngineConfig(speculative="linear", draft_len=3),
                      device="cpu")
    mk = lambda **kw: _Slot(req=Request(uid=0, prompt=np.ones(4, np.int32)),
                            tokens=np.ones(4, np.int32), **kw)
    assert [eng._window_len(mk(budget=b)) for b in (1, 2, 99)] == [1, 2, 4]
    assert eng._window_len(mk(budget=99, replay=[7])) == 2
    assert eng._window_len(mk(budget=99, replay=[7] * 10)) == 4
    _, _, fm, _ = full
    assert fm.draft_init is None and tm.draft_init is not None
    assert ServeEngine(fm, EngineConfig(speculative="ngram"),
                       device="cpu")._spec
    for model, kw in ((fm, dict(speculative="linear")),
                      (tm, dict(speculative="nonsense")),
                      (tm, dict(speculative="ngram", draft_len=0))):
        with pytest.raises(ValueError):
            ServeEngine(model, EngineConfig(**kw), device="cpu")


# ---------------------------------------------------------------------------
# acceptance and drafting units, on the reference's inputs
# ---------------------------------------------------------------------------

def test_greedy_accept_and_greedy_rejection_sample():
    for draft, target in (([3, 5, 7], [3, 5, 7, 9]), ([3, 5, 7], [3, 4, 7]),
                          ([2], [9, 9]), ([], [4])):
        d, t = np.asarray(draft, np.int32), np.asarray(target)
        assert TS.greedy_accept(d, t) == JS.greedy_accept(d, t)
    tgt = np.zeros((4, 16), np.float32)
    for i, t in enumerate((3, 5, 7, 9)):
        tgt[i, t] = 10.0
    for draft, want in (([3, 5, 2], ([3, 5, 7], 2)),
                        ([3, 5, 7], ([3, 5, 7, 9], 3))):
        got = TS.rejection_sample(np.array(draft), None, tgt,
                                  temperature=0.0,
                                  rng=np.random.default_rng(0))
        assert got == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampled_rejection_makes_the_reference_draws(seed):
    rng = np.random.default_rng(100 + seed)
    k, v = 3, 12
    draft = rng.integers(0, v, k)
    d_logits = rng.standard_normal((k, v)) * 2
    t_logits = rng.standard_normal((k + 1, v)) * 2
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    got = TS.rejection_sample(draft, d_logits, t_logits, temperature=0.7,
                              rng=a)
    want = JS.rejection_sample(draft, d_logits, t_logits, temperature=0.7,
                               rng=b)
    assert got == want and a.random() == b.random()


def test_ngram_propose_units():
    cases = [([5, 1, 2, 3, 9, 1, 2, 3], 3, 3), ([1, 2, 7, 1, 2, 8, 1, 2], 1, 2),
             ([4, 4, 9, 4], 2, 3), ([3, 7, 3], 4, 1), ([6], 2, 3)]
    for ctx, k, n in cases:
        ctx = np.asarray(ctx, np.int32)
        got = TS.ngram_propose(ctx, k, n)
        assert got.dtype == np.int32
        assert got.tolist() == JS.ngram_propose(ctx, k, n).tolist()
    assert TS.ngram_propose(np.array([5, 1, 2, 3, 9, 1, 2, 3]), 3,
                            3).tolist() == [9, 1, 2]


def test_ngram_drafter_q_stays_one_hot_at_high_temperature():
    d = TS.NGramDrafter(vocab_size=50_000, temperature=5.0)
    kw = dict(page_table=None, lengths=None, active=[True, False],
              tokens0=np.zeros((2,), np.int32), k=2,
              history=[np.array([1, 2, 3, 1, 2], np.int32), None])
    toks, logits = d.propose(None, None, **kw)
    assert toks[0].tolist() == [3, 1] and toks[1].tolist() == [0, 0]
    assert TS._softmax(logits[0, 0], 5.0)[toks[0, 0]] > 0.999
    jt, jl = JS.NGramDrafter(vocab_size=50_000, temperature=5.0).propose(
        None, None, **kw)
    assert np.array_equal(toks, jt) and np.array_equal(logits, jl)
    toks0, logits0 = TS.NGramDrafter(vocab_size=50_000).propose(None, None,
                                                                **kw)
    assert np.array_equal(toks0, toks) and logits0 is None


def test_linear_drafter_needs_a_linear_branch(full):
    _, _, fm, _ = full
    with pytest.raises(ValueError, match="SLA2"):
        TS.LinearDrafter(fm)
