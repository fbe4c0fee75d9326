"""The port's step-level diffusion engine (repro_torch.serve.diffusion).

Batched interleaved serving (slot reuse, a late joiner) must equal
per-request sequential denoising exactly (``torch.equal``) on the CPU, as
the reference's engine test does with ``np.array_equal`` - non-trivially
here, because the zero-initialised adaLN / output tensors are filled with
seeded values first.  The engine is also held to the reference's
``denoise_sequential`` on converted weights (atol = rtol = 5e-5, quant
'none').  The scheduler tests mirror tests/test_diffusion_scheduler.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.wan_dit_1_3b import smoke_config as jsmoke
from repro.models.api import build_model as jbuild
from repro.serve import diffusion as JDS
from repro_torch.configs.wan_dit_1_3b import smoke_config
from repro_torch.convert import dit_params_from_numpy
from repro_torch.models.api import build_model
from repro_torch.serve import diffusion as DS
from repro_torch.serve.diffusion import StepScheduler, VideoRequest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_LAT = 64


def _perturbed_tree(params, seed=0, std=0.1):
    """The reference params as numpy, with the zero-initialised ada,
    final_ada and patch_out filled with seeded N(0, std^2)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, params)
    fill = lambda a: (rng.standard_normal(a.shape) * std).astype(a.dtype)
    for group in (tree["blocks"]["ada"], tree["final_ada"],
                  tree["patch_out"]):
        for name in ("w", "b"):
            group[name] = fill(group[name])
    return tree


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, torch model, torch params), quant 'none'."""
    jm = jbuild(jsmoke(quant_bits="none"))
    tree = _perturbed_tree(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(smoke_config(quant_bits="none"))
    return (jm, jax.tree.map(jnp.asarray, tree), tm,
            dit_params_from_numpy(tree, tm.cfg, device="cpu"))


def _ecfg(**kw):
    base = dict(max_slots=3, n_latent=N_LAT, max_steps=8)
    base.update(kw)
    return DS.DiffusionEngineConfig(**base)


@pytest.mark.parametrize("mechanism,attn_impl", [
    ("full", "auto"), ("sla2", "fused"), ("sla2", "gather")])
def test_batched_equals_sequential(models, mechanism, attn_impl):
    _, _, model, params = models
    ecfg = _ecfg(mechanism=mechanism, attn_impl=attn_impl)
    reqs = DS.make_video_requests(5, model.cfg, n_latent=N_LAT,
                                  steps=(3, 5, 2))
    eng = DS.DiffusionEngine(model, params, ecfg, device="cpu")
    finished = []
    for r in reqs[:4]:
        eng.submit(r)
    finished += eng.step()
    finished += eng.step()
    eng.submit(reqs[4])                           # late joiner
    finished += eng.run_to_completion()
    assert sorted(r.uid for r in finished) == [0, 1, 2, 3, 4]
    ref = DS.denoise_sequential(
        model, params, DS.make_video_requests(
            5, model.cfg, n_latent=N_LAT, steps=(3, 5, 2)), ecfg,
        device="cpu")
    for r in finished:
        assert r.output is not None and r.t_finish > r.t_submit
        assert not np.array_equal(r.output, r.latents)   # non-trivial
        assert torch.equal(torch.from_numpy(r.output),
                           torch.from_numpy(ref[r.uid]))
    assert eng.stats["denoise_steps"] == sum(r.n_steps for r in reqs)
    assert eng.stats["engine_steps"] < eng.stats["denoise_steps"]


@pytest.mark.parametrize("attn_impl", ["fused", "gather"])
def test_engine_matches_jax_sequential(models, attn_impl):
    jm, jp, model, params = models
    ecfg = _ecfg(attn_impl=attn_impl)
    eng = DS.DiffusionEngine(model, params, ecfg, device="cpu")
    for r in DS.make_video_requests(3, model.cfg, n_latent=N_LAT,
                                    steps=(3, 2), seed=7):
        eng.submit(r)
    got = {r.uid: r.output for r in eng.run_to_completion()}
    want = JDS.denoise_sequential(
        jm, jp, JDS.make_video_requests(3, jm.cfg, n_latent=N_LAT,
                                        steps=(3, 2), seed=7),
        JDS.DiffusionEngineConfig(max_slots=3, n_latent=N_LAT, max_steps=8,
                                  attn_impl=attn_impl))
    for uid, out in want.items():
        np.testing.assert_allclose(got[uid], out, atol=5e-5, rtol=5e-5)


def test_engine_validation_and_device(models):
    _, _, model, params = models
    eng = DS.DiffusionEngine(model, params, _ecfg(), device="cpu")
    assert eng.model.cfg.sla2_impl == "gather"     # auto on cpu
    reqs = DS.make_video_requests(1, model.cfg, n_latent=N_LAT)
    with pytest.raises(ValueError, match="n_steps"):
        eng.submit(VideoRequest(uid=9, latents=reqs[0].latents,
                                text=reqs[0].text, n_steps=99))
    with pytest.raises(ValueError, match="latents"):
        eng.submit(VideoRequest(uid=9, latents=reqs[0].latents[:-1],
                                text=reqs[0].text, n_steps=2))
    with pytest.raises(ValueError, match="multiple"):
        DS.DiffusionEngine(model, params, _ecfg(n_latent=N_LAT + 1),
                           device="cpu")
    with pytest.raises(ValueError, match="needs the blocks' sla params"):
        DS.DiffusionEngine(model, params, _ecfg(mechanism="sla"),
                           device="cpu")
    sla = build_model(smoke_config(mechanism="sla"))
    eng = DS.DiffusionEngine(sla, sla.init(0, device="cpu"),
                             _ecfg(mechanism="sla"), device="cpu")
    assert eng.model.cfg.mechanism == "sla"


def test_cuda_device_never_falls_back(models, monkeypatch):
    """Asking for cuda on a machine without it raises; 'auto' resolves
    from the engine's device, never from what is installed."""
    _, _, model, params = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DS.DiffusionEngine(model, params, _ecfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(0)
    assert DS.resolve_attn_impl("auto", "cuda") == "fused"
    assert DS.resolve_attn_impl("auto", "cpu") == "gather"
    with pytest.raises(ValueError, match="unknown attn_impl"):
        DS.resolve_attn_impl("pallas", "cpu")


# ---------------------------------------------------------------------------
# scheduler (mirrors tests/test_diffusion_scheduler.py)
# ---------------------------------------------------------------------------

def _req(uid, n_steps):
    return VideoRequest(uid=uid, latents=np.zeros(0), text=np.zeros(0),
                        n_steps=n_steps)


def simulate(arrivals, steps, max_slots, max_ticks=10_000):
    """Tick-level replay of the engine's host loop."""
    sched = StepScheduler(max_slots)
    reqs = [_req(i, s) for i, s in enumerate(steps)]
    order = sorted(range(len(reqs)), key=lambda i: (arrivals[i], i))
    admitted, finish, occupancy = [], {}, []
    tick, last_arrival = 0, max(arrivals)
    while tick <= last_arrival or not sched.idle:
        for i in order:
            if arrivals[i] == tick:
                sched.submit(reqs[i])
        admitted += [r.uid for _, r in sched.admit()]
        slots = sorted(sched.active)
        occupancy.append(len(slots))
        for _, r in sched.advance(slots):
            finish[r.uid] = tick
        tick += 1
        assert tick < max_ticks, "scheduler livelocked"
    return reqs, admitted, finish, occupancy


def test_admission_waits_for_free_slot():
    sched = StepScheduler(2)
    for r in (_req(0, 3), _req(1, 1), _req(2, 2)):
        sched.submit(r)
    assert [r.uid for _, r in sched.admit()] == [0, 1]
    assert sched.admit() == []
    assert [(s, r.uid) for s, r in sched.advance([0, 1])] == [(1, 1)]
    assert [(s, r.uid) for s, r in sched.admit()] == [(1, 2)]


def test_fixed_step_completion_ordering_and_conservation():
    _, admitted, finish, _ = simulate([0, 0, 0, 1, 2], [4] * 5, 2)
    assert admitted == [0, 1, 2, 3, 4]
    assert sorted(finish, key=finish.get) == [0, 1, 2, 3, 4]
    reqs, _, finish, occ = simulate([0, 0, 1, 5, 5, 5], [3, 1, 4, 2, 6, 1], 3)
    assert all(r.steps_done == r.n_steps for r in reqs)
    assert sum(occ) == sum(r.n_steps for r in reqs) and max(occ) <= 3
    with pytest.raises(ValueError):
        StepScheduler(0)


hypothesis = pytest.importorskip(
    "hypothesis", reason="optional test dependency (pip install hypothesis)")
from hypothesis import given, settings, strategies as st  # noqa: E402


@given(max_slots=st.integers(1, 4),
       spec=st.lists(st.tuples(st.integers(0, 12), st.integers(1, 6)),
                     min_size=1, max_size=12))
@settings(max_examples=40, deadline=None, database=None)
def test_scheduler_invariants(max_slots, spec):
    """Exact step counts, no starvation, bounded occupancy, FCFS."""
    arrivals = [a for a, _ in spec]
    steps = [s for _, s in spec]
    reqs, admitted, finish, occupancy = simulate(arrivals, steps, max_slots)
    assert all(r.steps_done == r.n_steps for r in reqs)
    assert sorted(finish) == list(range(len(reqs)))
    assert all(t <= max(arrivals) + sum(steps) for t in finish.values())
    assert max(occupancy) <= max_slots
    assert admitted == sorted(range(len(reqs)),
                              key=lambda i: (arrivals[i], i))
