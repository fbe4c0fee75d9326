"""The port's copy-on-write prefix cache against the JAX package, a mirror
of tests/test_prefix_cache.py (qwen3-14b smoke configs, the reference's
params carried across).

The refcounted allocator and the trie run the same operations in both
packages and hold the same pages, references and LRU order.  At engine
level a cache hit must be invisible in the outputs: cache-on tokens equal
cache-off tokens and the JAX engine's, with equal ``prefix_*`` and
``cow_copies`` stats, for dense and SLA2 stacks on the fused (plain kernel
versions on the CPU) and gather paths; the SLA2 totals after a hit equal
a cold prefill's bit for bit, whichever order hits and misses take a
recycled slot in; a whole-prompt hit copies its last chunk's pages; slots
holding shared pages survive swap and recompute preemption; verify
windows never write a shared page.

The reference's pool-invariant property test does not drain its shrunk
example (seed 30, 10 pages, swap None, spec 'off', share True): the JAX
engine livelocks there.  The port's copy of the property test is marked
``xfail(strict=False)`` for that reason, and a deterministic test holds
the port to the reference engine step for step on that example.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.models.api import build_model as jbuild
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import PageAllocator as JPageAllocator
from repro.serve import PrefixCache as JPrefixCache
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.api import build_model
from repro_torch.serve.engine import (EngineConfig, PageAllocator, Request,
                                      ServeEngine)
from repro_torch.serve.prefix_cache import PrefixCache
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MAX_LEN, MAX_NEW = 192, 8
PREFIX_STATS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
                "prefix_inserts", "prefix_evictions", "cow_copies")


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


def _engine(models, jax_engine=False, **kw):
    jm, jp, tm, tp = models
    if jax_engine:
        eng = JServeEngine(jm, JEngineConfig(max_len=MAX_LEN,
                                             prefill_chunk=32, **kw))
        eng.load(jp)
        return eng, JRequest
    eng = ServeEngine(tm, EngineConfig(max_len=MAX_LEN, prefill_chunk=32,
                                       **kw), device="cpu")
    eng.load(tp)
    return eng, Request


def _serve_sequential(models, prompts, *, jax_engine=False, max_new=MAX_NEW,
                      **kw):
    """One engine; the requests submitted and drained one at a time, so
    later prompts can hit what earlier ones left in the cache."""
    eng, req = _engine(models, jax_engine, **kw)
    for i, p in enumerate(prompts):
        eng.submit(req(uid=i, prompt=p, max_new_tokens=max_new))
        eng.run_to_completion(max_steps=4000)
    return {r.uid: r.output for r in eng.completed}, eng


def _shared_prefix_prompts(n_sys=96, suffixes=(13, 22, 7), seed=0):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, 256, n_sys).astype(np.int32)
    return sys_p, [np.concatenate(
        [sys_p, rng.integers(1, 256, n).astype(np.int32)]) for n in suffixes]


def _stats(eng, keys=PREFIX_STATS):
    return {k: eng.stats[k] for k in keys}


def _check_pool_invariants(eng):
    """Every page's refcount equals its page-table occurrences plus its
    cache references; the free list holds exactly the pages at refcount 0,
    once each."""
    alloc = eng.allocator
    counts = np.zeros(alloc.num_pages, np.int64)
    vals, occ = np.unique(eng._page_table, return_counts=True)
    for p, c in zip(vals, occ):
        if p > 0:
            counts[p] = c
    if eng._pcache is not None:
        for p, c in eng._pcache.page_refs().items():
            counts[p] += c
    free = set(alloc._free)
    assert len(free) == len(alloc._free), "free list holds duplicates"
    for p in range(1, alloc.num_pages):
        assert alloc.refcount(p) == counts[p], f"page {p} refcount drift"
        assert (p in free) == (counts[p] == 0), f"page {p} free-list drift"
    assert alloc.available + int((counts[1:] > 0).sum()) \
        == alloc.num_pages - 1


# ===========================================================================
# The refcounted allocator, operation for operation against the reference
# ===========================================================================

def _pools(a):
    return list(a._free), [a.refcount(p) for p in range(a.num_pages)]


def test_allocator_double_free_rejected():
    for cls in (PageAllocator, JPageAllocator):
        a = cls(5)
        p = a.alloc()
        a.free([p])
        with pytest.raises(RuntimeError, match="double free"):
            a.free([p])
        assert sorted(a._free) == sorted(set(a._free))
    t, j = PageAllocator(5), JPageAllocator(5)
    assert [t.alloc() for _ in range(3)] == [j.alloc() for _ in range(3)]


def test_allocator_refcount_sharing():
    got = {}
    for cls in (PageAllocator, JPageAllocator):
        a = cls(6)
        p = a.alloc()
        q = a.alloc()
        a.incref(p)
        assert a.refcount(p) == 2
        a.free([p])
        assert a.refcount(p) == 1 and p not in a._free
        a.free([p, q])
        assert a.refcount(p) == 0 and p in a._free
        with pytest.raises(AssertionError):
            a.incref(p)                      # incref of a free page
        r = a.alloc()                        # LIFO: the last page freed
        got[cls] = (_pools(a), r, a.min_available)
    assert got[PageAllocator] == got[JPageAllocator]


# ===========================================================================
# The trie, operation for operation against the reference
# ===========================================================================

def _toks(n, seed=0):
    return np.random.default_rng(seed).integers(1, 1000, n).astype(np.int32)


def _both(page_size, pages_per_chunk, need_totals, n_pages=20):
    return [(cls(page_size=page_size, pages_per_chunk=pages_per_chunk,
                 need_totals=need_totals), alloc(n_pages))
            for cls, alloc in ((PrefixCache, PageAllocator),
                               (JPrefixCache, JPageAllocator))]


def _nodes(pc):
    return sorted((n.depth, n.page, n.key, n.pins, n.last_used,
                   n.has_totals) for n in pc._iter_nodes())


def test_trie_lookup_truncates_to_chunk_alignment():
    out = []
    for pc, a in _both(4, 2, False):
        toks = _toks(16)                     # 4 full pages, 2 chunks
        row = np.array([a.alloc() for _ in range(4)])
        created, node = pc.insert(toks, row, 4, {2: None, 4: None}, a)
        assert created == 4 and node.depth == 4 and pc.n_nodes == 4
        pages, nd = pc.lookup(toks[:12])     # 3 pages walked, 2 usable
        assert len(pages) == 2 and nd.depth == 2
        assert pages == [int(row[0]), int(row[1])]
        other = toks.copy()
        other[5] += 1                        # breaks page 2 onward
        assert pc.lookup(other)[0] == []     # depth 1 is not chunk-aligned
        assert pc.lookup(_toks(3))[0] == []  # shorter than one page
        out.append((_nodes(pc), _pools(a)))
    assert out[0] == out[1]


def test_trie_need_totals_requires_snapshot():
    out = []
    for pc, a in _both(4, 2, True):
        toks = _toks(16, seed=1)
        row = np.array([a.alloc() for _ in range(4)])
        pc.insert(toks, row, 4, {2: "snap2"}, a)   # none at depth 4
        pages, nd = pc.lookup(toks)
        assert len(pages) == 2                     # falls back to depth 2
        assert pc.totals_at(nd, 2) == "snap2"
        out.append((pages, _nodes(pc)))
    assert out[0] == out[1]


def test_trie_eviction_lru_and_pinning():
    out = []
    for pc, a in _both(4, 1, False):
        t1, t2 = _toks(8, seed=2), _toks(8, seed=3)
        r1 = np.array([a.alloc() for _ in range(2)])
        r2 = np.array([a.alloc() for _ in range(2)])
        pc.insert(t1, r1, 2, {}, a)
        pc.insert(t2, r2, 2, {}, a)
        pc.lookup(t1)                        # t1 is now the most recent
        avail0 = a.available
        assert pc.evict_one(a)               # the LRU leaf: t2's deep page
        assert pc.n_nodes == 3 and a.available == avail0
        _, nd = pc.lookup(t1)
        pc.pin(nd)
        assert pc.evict_one(a)               # t2's remaining page
        assert not pc.evict_one(a)           # only the pinned path is left
        trail = [_nodes(pc)]
        pc.unpin(nd)
        assert pc.evict_one(a) and pc.evict_one(a)
        assert pc.n_nodes == 0
        out.append((trail, _pools(a)))
    assert out[0] == out[1]


def test_trie_evictable_pages_counts_sole_references():
    out = []
    for pc, a in _both(4, 1, False):
        toks = _toks(8, seed=4)
        row = np.array([a.alloc() for _ in range(2)])
        pc.insert(toks, row, 2, {}, a)       # refcount 2 on both pages
        seen = [pc.evictable_pages(a)]
        a.free(row)                          # the slot finished
        seen.append(pc.evictable_pages(a))
        _, nd = pc.lookup(toks)
        pc.pin(nd)
        seen.append(pc.evictable_pages(a))   # pinned leaf and its ancestor
        pc.unpin(nd)
        seen.append(pc.evictable_pages(a))
        assert seen == [0, 2, 0, 2]
        out.append((seen, sorted(pc.page_refs().items())))
    assert out[0] == out[1]


# ===========================================================================
# Engine level: a hit is invisible in the outputs
# ===========================================================================

@pytest.mark.parametrize("mech", ["full", "sla2"])
@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_hit_identical_to_cold_prefill(sla2, full, mech, impl):
    """Cache-on tokens equal cache-off tokens and the JAX engine's, with
    the JAX engine's prefix stats, while actually hitting."""
    models = sla2 if mech == "sla2" else full
    _, prompts = _shared_prefix_prompts(seed=0 if mech == "full" else 1)
    off, _ = _serve_sequential(models, prompts, paged_impl=impl)
    on, eng = _serve_sequential(models, prompts, paged_impl=impl,
                                prefix_cache=True)
    want, jeng = _serve_sequential(models, prompts, jax_engine=True,
                                   paged_impl="gather", prefix_cache=True)
    assert eng.stats["prefix_hits"] >= 2     # prompts 2 and 3 hit prompt 1
    assert eng.stats["prefix_hit_tokens"] >= 2 * 96
    assert _stats(eng) == _stats(jeng)
    for i in range(len(prompts)):
        assert on[i] == off[i] == want[i], f"request {i} diverged"
    _check_pool_invariants(eng)


def _slot_totals(eng, slot=0):
    return [{k: v.clone() for k, v in lc.items()}
            for lc in eng.model.extract_totals(eng.caches, slot)["layers"]]


def test_sla2_totals_restored_bit_exact_after_hit(sla2):
    """After a hit, slot 0's totals equal the same request served cold,
    bit for bit (the token identity above could hide a small drift), and
    the JAX engine's within 1e-5."""
    import jax.numpy as jnp
    jm = sla2[0]
    _, prompts = _shared_prefix_prompts(suffixes=(13, 22), seed=2)

    def totals_after(prefix_cache, jax_engine=False):
        eng, req = _engine(sla2, jax_engine, max_slots=1,
                           prefix_cache=prefix_cache)
        for i, p in enumerate(prompts):
            eng.submit(req(uid=i, prompt=p, max_new_tokens=1))
            eng.run_to_completion(max_steps=2000)
        if jax_engine:
            tot = jax.device_get(jax.jit(jm.extract_totals)(
                eng.caches, jnp.asarray(0, jnp.int32)))
            return tot["groups"]["l0"]["attn"], eng
        return _slot_totals(eng), eng

    cold, _ = totals_after(False)
    warm, eng = totals_after(True)
    jwarm, jeng = totals_after(True, jax_engine=True)
    assert eng.stats["prefix_hits"] >= 1
    assert _stats(eng) == _stats(jeng)
    assert len(cold) == len(warm) == 2
    for li, (c, w) in enumerate(zip(cold, warm)):
        assert set(c) == {"h_tot", "z_tot"}
        for k in c:
            assert c[k].equal(w[k]), (li, k)
            j = np.asarray(jwarm[k][li])
            t = w[k].numpy()
            assert np.abs(t - j).max() <= 1e-5 * np.abs(j).max(), (li, k)


@pytest.mark.parametrize("order", ["hit_then_miss", "miss_then_hit"])
def test_recycled_slot_takes_its_own_totals(sla2, order):
    """One slot serves hits and misses in turn: a miss after a hit starts
    its totals afresh at offset 0, a hit after a miss restores the
    snapshot over the stale totals.  Each request's totals and tokens
    equal a cache-off engine's."""
    sys_p, (a, b, c) = _shared_prefix_prompts(suffixes=(13, 22, 9), seed=5)
    cold = np.random.default_rng(6).integers(1, 256, 70).astype(np.int32)
    seq = [a, b, cold] if order == "hit_then_miss" else [a, cold, b]
    seq.append(c)

    def run(prefix_cache):
        eng, req = _engine(sla2, max_slots=1, prefix_cache=prefix_cache)
        totals = []
        for i, p in enumerate(seq):
            eng.submit(req(uid=i, prompt=p, max_new_tokens=3))
            eng.run_to_completion(max_steps=2000)
            totals.append(_slot_totals(eng))
        return {r.uid: r.output for r in eng.completed}, totals, eng

    off, t_off, _ = run(False)
    on, t_on, eng = run(True)
    jon, jeng = _serve_sequential(sla2, seq, jax_engine=True, max_new=3,
                                  max_slots=1, prefix_cache=True)
    assert eng.stats["prefix_hits"] == 2 and eng.stats["prefix_misses"] == 2
    assert _stats(eng) == _stats(jeng)
    assert on == off == jon
    for i, (x, y) in enumerate(zip(t_off, t_on)):
        for lx, ly in zip(x, y):
            assert all(lx[k].equal(ly[k]) for k in lx), i


def test_full_prompt_hit_triggers_copy_on_write(sla2):
    """An exact copy of a chunk-aligned cached prompt runs only its last
    chunk, over shared pages: both are copied first, and the tokens stay
    the cold run's."""
    p = np.random.default_rng(3).integers(1, 256, 96).astype(np.int32)
    prompts = [p, p.copy()]
    off, _ = _serve_sequential(sla2, prompts)
    on, eng = _serve_sequential(sla2, prompts, prefix_cache=True)
    want, jeng = _serve_sequential(sla2, prompts, jax_engine=True,
                                   paged_impl="gather", prefix_cache=True)
    assert eng.stats["prefix_hits"] == 1
    assert eng.stats["cow_copies"] == 2      # the last chunk's 2 pages
    assert _stats(eng) == _stats(jeng)
    assert on == off == want
    _check_pool_invariants(eng)


@pytest.mark.parametrize("swap_pages", [None, 0])
def test_preemption_of_shared_pages(sla2, swap_pages):
    """Slots holding shared pages are preempted under a tight pool (by
    swap: the shared prefix stays on the device under its pinned node and
    is mapped again on resume; by recompute: the references go and the
    restart looks the trie up again), and every request still decodes the
    tokens of an undisturbed cache-off engine, with the JAX engine's
    stats."""
    _, prompts = _shared_prefix_prompts(n_sys=64, suffixes=(9, 17, 26),
                                        seed=4)
    off, _ = _serve_sequential(sla2, prompts, max_slots=1)
    runs = []
    for jax_engine in (False, True):
        eng, req = _engine(sla2, jax_engine, max_slots=3, num_pages=8,
                           swap_pages=swap_pages, prefix_cache=True)
        eng.submit(req(uid=0, prompt=prompts[0], max_new_tokens=MAX_NEW))
        eng.run_to_completion(max_steps=4000)
        for i in (1, 2):
            eng.submit(req(uid=i, prompt=prompts[i], max_new_tokens=MAX_NEW))
        eng.run_to_completion(max_steps=4000)
        runs.append(({r.uid: r.output for r in eng.completed}, eng))
    (on, eng), (jon, jeng) = runs
    keys = PREFIX_STATS + ("preemptions", "swap_outs", "swap_ins",
                           "recomputes")
    assert eng.stats["prefix_hits"] >= 1
    assert eng.stats["preemptions"] > 0, "pool was not tight enough"
    assert _stats(eng, keys) == _stats(jeng, keys)
    assert on == off == jon
    _check_pool_invariants(eng)
    cached = len(eng._pcache.page_refs())
    assert eng.allocator.available == eng.allocator.num_pages - 1 - cached


@pytest.mark.parametrize("mech,spec", [("sla2", "linear"), ("full", "ngram")])
def test_verify_windows_never_write_shared_pages(sla2, full, mech, spec):
    """Speculative decoding over hits, whole-prompt ones included: no
    row of a verify window, nor of its commit, lands in a page the slot
    shares; tokens and stats equal the JAX engine's."""
    models = sla2 if mech == "sla2" else full
    sys_p, prompts = _shared_prefix_prompts(suffixes=(13, 22, 7), seed=7)
    prompts.append(sys_p.copy())             # a whole-prompt hit
    kw = dict(max_slots=2, speculative=spec, draft_len=3, prefix_cache=True)
    eng, req = _engine(models, **kw)
    checked = []
    verify = eng.model.decode_verify

    def guarded(p, batch, caches):
        lengths = batch["lengths"].numpy()
        wlen = batch["window_len"].numpy()
        for slot, st in eng._slots.items():
            if not bool(batch["active"][slot]):
                continue
            first = int(lengths[slot]) // eng.page_size
            assert first >= st.n_shared, (slot, first, st.n_shared)
            last = (int(lengths[slot]) + int(wlen[slot]) - 1) \
                // eng.page_size
            for lg in range(first, last + 1):
                page = int(eng._page_table[slot, lg])
                assert eng.allocator.refcount(page) == 1, (slot, lg, page)
            checked.append(slot)
        return verify(p, batch, caches)

    import dataclasses
    eng.model = dataclasses.replace(eng.model, decode_verify=guarded)
    eng.submit(req(uid=0, prompt=prompts[0], max_new_tokens=MAX_NEW))
    eng.run_to_completion(max_steps=4000)
    for i, p in enumerate(prompts[1:], start=1):
        eng.submit(req(uid=i, prompt=p, max_new_tokens=MAX_NEW))
    eng.run_to_completion(max_steps=4000)
    got = {r.uid: r.output for r in eng.completed}
    jeng, jreq = _engine(models, jax_engine=True, paged_impl="gather", **kw)
    jeng.submit(jreq(uid=0, prompt=prompts[0], max_new_tokens=MAX_NEW))
    jeng.run_to_completion(max_steps=4000)
    for i, p in enumerate(prompts[1:], start=1):
        jeng.submit(jreq(uid=i, prompt=p, max_new_tokens=MAX_NEW))
    jeng.run_to_completion(max_steps=4000)
    want = {r.uid: r.output for r in jeng.completed}
    keys = PREFIX_STATS + ("spec_steps", "spec_drafted", "spec_accepted")
    assert checked and got == want
    assert eng.stats["prefix_hits"] == 3 and eng.stats["cow_copies"] == 2
    assert _stats(eng, keys) == _stats(jeng, keys)
    _check_pool_invariants(eng)


# ===========================================================================
# The pool invariants under randomized workloads
# ===========================================================================

def _random_workload(seed, share):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(1, 256, 64).astype(np.int32)
    prompts = []
    for _ in range(4):
        tail = rng.integers(1, 256, int(rng.integers(4, 40))).astype(np.int32)
        prompts.append(np.concatenate([sys_p, tail]) if share else tail)
    return prompts


def _pool_state(eng):
    refs = [eng.allocator.refcount(p)
            for p in range(eng.allocator.num_pages)]
    return (eng._page_table.copy(), eng._lengths.copy(), refs,
            list(eng.allocator._free))


def test_shrunk_example_steps_as_the_reference(sla2):
    """The reference's failing example of the property test (seed 30, 10
    pages, swap None, spec 'off', share True): for 200 steps the port's
    page table, lengths, refcounts, free list, stats and tokens equal the
    JAX engine's after every step, and the invariants hold."""
    models = sla2
    prompts = _random_workload(30, True)
    kw = dict(max_slots=3, num_pages=10, swap_pages=None, speculative="off",
              prefix_cache=True)
    eng, req = _engine(models, **kw)
    jeng, jreq = _engine(models, jax_engine=True, **kw)
    for i, p in enumerate(prompts):
        eng.submit(req(uid=i, prompt=p, max_new_tokens=4))
        jeng.submit(jreq(uid=i, prompt=p, max_new_tokens=4))
    keys = sorted(set(eng.stats) & set(jeng.stats))
    assert set(PREFIX_STATS) <= set(keys)
    for step in range(200):
        n, jn = eng.step(), jeng.step()
        _check_pool_invariants(eng)
        assert n == jn, step
        got, want = _pool_state(eng), _pool_state(jeng)
        assert np.array_equal(got[0], want[0]), step
        assert np.array_equal(got[1], want[1]), step
        assert got[2:] == want[2:], step
        assert _stats(eng, keys) == _stats(jeng, keys), step
        outs = lambda e: sorted((s.req.uid, list(s.req.output))
                                for s in e._slots.values())
        assert outs(eng) == outs(jeng), step
        assert [r.uid for r in eng.completed] == \
            [r.uid for r in jeng.completed], step


try:
    from hypothesis import given, settings, strategies as st
    from hypothesis import Phase
except ImportError:                          # optional test dependency
    given = None

if given is not None:
    @pytest.mark.xfail(
        strict=False, reason="the reference engine does not drain this "
        "property's shrunk example (seed 30, 10 pages, share True): "
        "tests/test_prefix_cache.py fails it, and the port mirrors the "
        "reference's scheduling")
    @given(seed=st.integers(0, 2 ** 16),
           num_pages=st.sampled_from([10, 14]),
           swap=st.sampled_from([0, None]),
           spec=st.sampled_from(["off", "ngram"]),
           share=st.booleans())
    @settings(max_examples=8, deadline=None, derandomize=True,
              database=None,
              phases=(Phase.explicit, Phase.reuse, Phase.generate))
    def test_pool_invariants_hold_after_every_step(sla2, seed, num_pages,
                                                   swap, spec, share):
        """Randomized preempt / swap / speculative workloads with the
        cache on: the pool invariants hold after every step, and the
        workload drains."""
        prompts = _random_workload(seed, share)
        eng, req = _engine(sla2, max_slots=3, num_pages=num_pages,
                           swap_pages=swap, speculative=spec,
                           prefix_cache=True)
        for i, p in enumerate(prompts):
            eng.submit(req(uid=i, prompt=p, max_new_tokens=4))
        for _ in range(4000):
            n = eng.step()
            _check_pool_invariants(eng)
            if n == 0 and not eng._queue:
                break
        else:
            raise AssertionError("randomized workload did not drain")
        assert len(eng.completed) == len(prompts)
