"""The port's ServeEngine against the JAX ServeEngine (qwen3-14b smoke
config, the reference's params carried across).

Greedy tokens must be identical to the reference engine's for
mixed-length requests with a late joiner, under the port's fused (plain
kernel versions on the CPU) and gather paths; Gumbel sampling at
temperature > 0 draws the same tokens from the same numpy generator.
Within the port: batching invariance (a mixed 3-slot engine against one
request at a time, as tests/test_serving.py:43 does for the reference),
forced preemption by swap and by recompute give the tokens of an
undisturbed run (as tests/test_preemption.py:57 and :80), the allocator,
admission, and the refusals (an oversized or empty prompt, the options
that are not ported).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models.api import build_model as jbuild
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.api import build_model
from repro_torch.serve.engine import (EngineConfig, PageAllocator, Request,
                                      ServeEngine, SwapPool,
                                      _pool_page_bytes)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MAX_LEN, MAX_NEW = 192, 8


@pytest.fixture(scope="module")
def ref():
    jm = jbuild(get_smoke_config("qwen3_14b"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tsmoke("qwen3_14b"))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tm.cfg,
                              device="cpu")
    return jm, jp, tm, tp


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).astype(np.int32) for n in lengths]


def _serve(engine_cls, cfg_cls, req_cls, model, params, prompts, *,
           late_idx=None, max_new=MAX_NEW, **kw):
    """Serve ``prompts`` through a fresh engine, one request joining three
    steps late; returns ({uid: tokens}, engine)."""
    extra = {"device": "cpu"} if engine_cls is ServeEngine else {}
    eng = engine_cls(model, cfg_cls(max_len=MAX_LEN, prefill_chunk=32, **kw),
                     **extra)
    eng.load(params)
    for i, p in enumerate(prompts):
        if i != late_idx:
            eng.submit(req_cls(uid=i, prompt=p, max_new_tokens=max_new))
    if late_idx is not None:
        for _ in range(3):
            eng.step()
        eng.submit(req_cls(uid=late_idx, prompt=prompts[late_idx],
                           max_new_tokens=max_new))
    done = eng.run_to_completion(max_steps=4000)
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    return {r.uid: r.output for r in done}, eng


def _port(ref, prompts, **kw):
    _, _, tm, tp = ref
    return _serve(ServeEngine, EngineConfig, Request, tm, tp, prompts, **kw)


@pytest.fixture(scope="module")
def mixed(ref):
    """The reference engine's tokens for mixed-length requests."""
    jm, jp, _, _ = ref
    prompts = _prompts([7, 45, 80, 21], seed=1)
    out, _ = _serve(JServeEngine, JEngineConfig, JRequest, jm, jp, prompts,
                    late_idx=3, max_slots=3, paged_impl="gather")
    return prompts, out


@pytest.mark.parametrize("impl", ["fused", "gather"])
def test_greedy_tokens_match_the_reference_engine(ref, mixed, impl):
    prompts, want = mixed
    got, eng = _port(ref, prompts, late_idx=3, max_slots=3, paged_impl=impl)
    assert got == want
    assert eng.allocator.available == eng.allocator.num_pages - 1
    assert eng.stats["prefill_chunks"] == sum(-(-len(p) // 32)
                                              for p in prompts)


def test_sampling_matches_the_reference_engine(ref):
    jm, jp, _, _ = ref
    prompts = _prompts([30, 12, 50], seed=4)
    kw = dict(max_slots=3, temperature=0.8, seed=3, paged_impl="gather")
    want, _ = _serve(JServeEngine, JEngineConfig, JRequest, jm, jp, prompts,
                     **kw)
    got, _ = _port(ref, prompts, **kw)
    assert got == want


@pytest.mark.parametrize("kw", [
    dict(paged_impl="gather", kv_quant="int8"),
    dict(paged_impl="fused", kv_quant="fp8", decode_quant_bits="int8")])
def test_quantised_pool_and_qat_decode_match_the_reference_engine(ref, kw):
    """The engine's model overrides: a low-bit page pool (codes and per-row
    scales written once) and the decode kernel's QAT tiles."""
    jm, jp, _, _ = ref
    prompts = _prompts([33, 50, 18], seed=8)
    want, _ = _serve(JServeEngine, JEngineConfig, JRequest, jm, jp, prompts,
                     max_slots=3, max_new=6, **kw)
    got, eng = _port(ref, prompts, max_slots=3, max_new=6, **kw)
    assert got == want
    assert eng.caches["layers"][0]["k_pages"].dtype != torch.bfloat16


def test_batching_is_output_invariant(ref, mixed):
    prompts, _ = mixed
    _, _, tm, tp = ref
    eng = ServeEngine(tm, EngineConfig(max_slots=1, max_len=MAX_LEN,
                                       prefill_chunk=32), device="cpu")
    eng.load(tp)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=MAX_NEW))
        eng.run_to_completion(max_steps=2000)
    seq = {r.uid: r.output for r in eng.completed}
    mix, _ = _port(ref, prompts, late_idx=3, max_slots=3)
    assert mix == seq


@pytest.mark.parametrize("impl", ["fused", "gather"])
def test_forced_swap_gives_the_undisturbed_tokens(ref, impl):
    prompts = _prompts([20, 35, 28, 40], seed=2)
    want, _ = _port(ref, prompts, late_idx=3, max_slots=3, paged_impl=impl)
    got, eng = _port(ref, prompts, late_idx=3, max_slots=3, num_pages=8,
                     paged_impl=impl)
    assert eng.stats["preemptions"] > 0 and eng.stats["swap_outs"] > 0
    assert eng.stats["swap_ins"] == eng.stats["swap_outs"]
    assert got == want
    assert eng.allocator.available == eng.allocator.num_pages - 1
    assert eng.swap.used == 0 and eng.swap.n_swapped == 0


def test_forced_recompute_gives_the_undisturbed_tokens(ref):
    prompts = _prompts([20, 35, 28, 40], seed=3)
    want, _ = _port(ref, prompts, late_idx=3, max_slots=3)
    got, eng = _port(ref, prompts, late_idx=3, max_slots=3, num_pages=8,
                     swap_pages=0)
    assert eng.stats["recomputes"] > 0 and eng.stats["swap_outs"] == 0
    assert got == want
    assert eng.allocator.available == eng.allocator.num_pages - 1


def test_conservative_admission_waits_instead_of_preempting(ref):
    prompts = _prompts([20, 30, 25, 40], seed=5)
    want, _ = _port(ref, prompts, max_slots=4)
    got, eng = _port(ref, prompts, max_slots=4, num_pages=8,
                     admission="conservative")
    assert eng.stats["preemptions"] == 0 and got == want
    assert eng.allocator.available == 7


def test_mid_chunk_self_preemption_resumes(ref):
    """A slot that self-preempts while mapping a chunk is re-admitted once
    the pool frees (the gate takes the larger of saved and needed pages)."""
    _, _, tm, tp = ref
    prompts = _prompts([8, 56], seed=6)
    eng = ServeEngine(tm, EngineConfig(max_slots=2, max_len=64,
                                       prefill_chunk=32, num_pages=5),
                      device="cpu")
    eng.load(tp)
    eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=4))
    eng.submit(Request(uid=1, prompt=prompts[1], max_new_tokens=8))
    done = eng.run_to_completion(max_steps=500)
    assert sorted(r.uid for r in done) == [0, 1]
    assert eng.stats["preemptions"] > 0


def test_eos_frees_the_slot_early(ref):
    _, _, tm, tp = ref
    prompt = _prompts([17], seed=7)[0]
    first, _ = _port(ref, [prompt], max_slots=1)
    eos = first[0][2]
    eng = ServeEngine(tm, EngineConfig(max_slots=1, max_len=MAX_LEN,
                                       prefill_chunk=32), device="cpu")
    eng.load(tp)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=MAX_NEW,
                       eos_id=eos))
    (req,) = eng.run_to_completion()
    assert req.output == first[0][:first[0].index(eos) + 1]
    assert eng.allocator.available == eng.allocator.num_pages - 1


def test_page_allocator_and_swap_accounting(ref):
    a = PageAllocator(5)                    # pages 1..4, 0 = trash
    got = [a.alloc() for _ in range(4)]
    assert sorted(got) == [1, 2, 3, 4] and a.available == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        a.alloc()
    a.free([2, 4])
    assert a.available == 2 and a.alloc() in (2, 4)
    with pytest.raises(RuntimeError, match="double free"):
        a.free([2, 2, 4])
    _, _, tm, _ = ref
    caches = {q: tm.with_overrides(kv_quant=q).init_paged_caches(
        2, 6, device="cpu") for q in ("none", "int8")}
    full = _pool_page_bytes(caches["none"])
    assert _pool_page_bytes(caches["none"], reference=True) == full
    pool = SwapPool(10)
    pool.configure_bytes(_pool_page_bytes(caches["int8"]),
                         _pool_page_bytes(caches["int8"], reference=True))
    assert pool.capacity > 10               # 1-byte codes pack more pages


def test_engine_refuses_what_it_cannot_serve(ref):
    _, _, tm, tp = ref
    eng = ServeEngine(tm, EngineConfig(max_slots=1, max_len=64),
                      device="cpu")
    eng.load(tp)
    with pytest.raises(ValueError, match="exceed max_len"):
        eng.submit(Request(uid=0, prompt=np.arange(60, dtype=np.int32),
                           max_new_tokens=16))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(uid=1, prompt=np.zeros(0, np.int32)))
    small = ServeEngine(tm, EngineConfig(max_slots=1, max_len=64,
                                         num_pages=3), device="cpu")
    with pytest.raises(ValueError, match="more pages"):
        small.submit(Request(uid=2, prompt=np.arange(1, 40, dtype=np.int32),
                             max_new_tokens=8))
    for kw in (dict(speculative="nonsense"), dict(prefix_cache=True),
               dict(mesh=object()), dict(admission="eager")):
        with pytest.raises(ValueError):
            ServeEngine(tm, EngineConfig(**kw), device="cpu")
    from repro_torch.configs import get_smoke_config as dit_smoke
    dit = build_model(dit_smoke("wan_dit_1_3b"))
    with pytest.raises(ValueError, match="no paged serving path"):
        ServeEngine(dit, EngineConfig(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServeEngine(tm, EngineConfig())
