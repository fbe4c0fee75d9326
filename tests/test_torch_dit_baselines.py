"""The DiT's SLA baselines (``sla``, ``sparse_only``) and
``DiTConfig.fuse_branches`` against the JAX package.

The reference's params (``PRNGKey(0)``) carry across with
``convert.dit_params_from_numpy``, the ``sla`` blocks' ``proj_l`` with
them.  The zero-initialised ``ada``, ``final_ada`` and ``patch_out`` are
first filled with seeded values, as in the other DiT tests: at init the
velocity is 0 and a denoise step returns its input.

Bounds: f32 with quant none, relative max error 1e-4; int8, relative norm
error 1e-2.  The engines' outputs after several Euler steps: atol = rtol
= 5e-5 (quant none), as the other engine tests hold them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.wan_dit_1_3b import smoke_config as jsmoke
from repro.models import dit as JD
from repro.models.api import build_model as jbuild
from repro.serve import diffusion as JDS
from repro_torch.configs.wan_dit_1_3b import smoke_config
from repro_torch.convert import dit_params_from_numpy
from repro_torch.models import dit as TD
from repro_torch.models.api import build_model
from repro_torch.serve import diffusion as DS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_LAT = 64


def _perturbed_tree(params, seed=0, std=0.1):
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, params)
    fill = lambda a: (rng.standard_normal(a.shape) * std).astype(a.dtype)
    for group in (tree["blocks"]["ada"], tree["final_ada"],
                  tree["patch_out"]):
        for name in ("w", "b"):
            group[name] = fill(group[name])
    return tree


def _pair(**over):
    jcfg = jsmoke(**over)
    tree = _perturbed_tree(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    tcfg = smoke_config(**over)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            dit_params_from_numpy(tree, tcfg, device="cpu"))


def _inputs(cfg, b=2, seed=1):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, N_LAT, cfg.c_latent)).astype(np.float32)
    text = rng.standard_normal((b, cfg.n_text, cfg.d_model)).astype(
        np.float32)
    t = rng.uniform(0.1, 0.9, (b,)).astype(np.float32)
    return lat, text, t


def _check(got, want, quant):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(want).max() > 1e-2                  # not the zero init
    if quant == "none":
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-2


@pytest.mark.parametrize("mechanism", ["sla", "sparse_only"])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_dit_forward_matches_jax(mechanism, quant):
    jcfg, jp, tcfg, tp = _pair(mechanism=mechanism, quant_bits=quant)
    assert (tp.blocks[0].sla is not None) == (mechanism == "sla")
    assert tp.blocks[0].sla2 is None
    if mechanism == "sla":
        np.testing.assert_array_equal(
            tp.blocks[1].sla.proj_l.detach().numpy(),
            np.asarray(jp["blocks"]["sla"]["proj_l"][1]))
    lat, text, t = _inputs(tcfg)
    want = JD.dit_forward(jp, jcfg, jnp.asarray(lat), jnp.asarray(text),
                          jnp.asarray(t))
    with torch.no_grad():
        got = TD.dit_forward(tp, tcfg, torch.from_numpy(lat),
                             torch.from_numpy(text), torch.from_numpy(t))
    _check(got, want, quant)


def test_flow_matching_gradient_reaches_proj_l():
    """The SLA baseline trains its linear projection: its gradient
    matches the reference's."""
    jcfg, jp, tcfg, tp = _pair(mechanism="sla", quant_bits="none")
    rng = np.random.default_rng(2)
    batch = {"latents": rng.standard_normal((2, N_LAT, 8)).astype(np.float32),
             "text": rng.standard_normal((2, 16, 64)).astype(np.float32),
             "noise": rng.standard_normal((2, N_LAT, 8)).astype(np.float32),
             "time": np.array([0.3, 0.7], np.float32)}
    (_, _), jg = jax.value_and_grad(jbuild(jcfg).loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _ = build_model(tcfg).loss(tp, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    loss.backward()
    want = np.asarray(jg["blocks"]["sla"]["proj_l"])
    for li, bp in enumerate(tp.blocks):
        got = bp.sla.proj_l.grad.numpy()
        assert np.abs(got - want[li]).max() / np.abs(want[li]).max() < 1e-4


@pytest.mark.parametrize("mechanism", ["sla", "sparse_only"])
def test_engine_matches_the_jax_engine(mechanism):
    """DiffusionEngine(mechanism=...) on the CPU against the JAX engine:
    three requests (3, 2 and 3 steps) over two slots."""
    jcfg, jp, tcfg, tp = _pair(quant_bits="none", mechanism=mechanism)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    kw = dict(max_slots=2, n_latent=N_LAT, max_steps=8, mechanism=mechanism)
    eng = DS.DiffusionEngine(tm, tp, DS.DiffusionEngineConfig(**kw),
                             device="cpu")
    for r in DS.make_video_requests(3, tcfg, n_latent=N_LAT,
                                    steps=(3, 2), seed=7):
        eng.submit(r)
    got = {r.uid: r.output for r in eng.run_to_completion()}
    jeng = JDS.DiffusionEngine(jm, jp, JDS.DiffusionEngineConfig(**kw))
    for r in JDS.make_video_requests(3, jcfg, n_latent=N_LAT, steps=(3, 2),
                                     seed=7):
        jeng.submit(r)
    want = {r.uid: r.output for r in jeng.run_to_completion()}
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for uid, out in want.items():
        assert not np.array_equal(got[uid], out * 0)
        np.testing.assert_allclose(got[uid], out, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_fuse_branches_end_to_end(quant):
    """DiTConfig.fuse_branches reaches the gather operator: the fused
    model against the reference's fused model, and against the port's
    two-pass model (1e-4 at quant none; within the QAT noise, 0.05,
    at int8, where phi(K) is taken over the quantised tiles)."""
    over = dict(quant_bits=quant, sla2_impl="gather", fuse_branches=True)
    jcfg, jp, tcfg, tp = _pair(**over)
    assert tcfg.sla2_config().fuse_branches
    lat, text, t = _inputs(tcfg, seed=3)
    want = JD.dit_forward(jp, jcfg, jnp.asarray(lat), jnp.asarray(text),
                          jnp.asarray(t))
    two_cfg = smoke_config(quant_bits=quant, sla2_impl="gather")
    with torch.no_grad():
        args = (torch.from_numpy(lat), torch.from_numpy(text),
                torch.from_numpy(t))
        got = TD.dit_forward(tp, tcfg, *args)
        two = TD.dit_forward(tp, two_cfg, *args)
    _check(got, want, quant)
    gap = np.linalg.norm(got - two) / np.linalg.norm(two)
    assert gap < (1e-4 if quant == "none" else 0.05)
