"""The port's video DiT (repro_torch.models) against the JAX reference.

The reference zero-initialises the adaLN projections (``blocks.ada``,
``final_ada``) and the output head (``patch_out``), so at init the
predicted velocity is exactly 0 and a denoise step returns its input.
Every model-level comparison here first fills those tensors with seeded
random values (``_perturbed_tree``), so attention, MLP and modulation all
reach the output.  Weights go across through ``repro_torch.convert``.

Bounds: atol = rtol = 5e-5 for quant 'none' (the reference's own
fused-vs-gather bound); a relative max error of 1e-3 for int8 (a 1-ulp
difference may flip one rounded code).  Inside torch the cached-constants
path must equal the in-step path bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.wan_dit_1_3b import smoke_config as jsmoke
from repro.models import dit as JD
from repro.models import layers as JL
from repro.models.api import build_model as jbuild
from repro_torch.configs.wan_dit_1_3b import smoke_config
from repro_torch.convert import dit_params_from_numpy
from repro_torch.models import dit as TD
from repro_torch.models import layers as TL
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


@pytest.fixture(scope="module", params=["none", "int8"])
def pair(request):
    """(jax cfg, jax params, torch cfg, torch params) at one quant mode."""
    quant = request.param
    jcfg = jsmoke(quant_bits=quant)
    tree = _perturbed_tree(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    tcfg = smoke_config(quant_bits=quant)
    return jcfg, jp, tcfg, dit_params_from_numpy(tree, tcfg, device="cpu")


def _inputs(cfg, b=2, seed=1):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, N_LAT, cfg.c_latent)).astype(np.float32)
    text = rng.standard_normal((b, cfg.n_text, cfg.d_model)).astype(
        np.float32)
    t = rng.uniform(0.1, 0.9, (b,)).astype(np.float32)
    dt = np.full((b,), 0.25, np.float32)
    return lat, text, t, dt


def _close(jcfg, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if jcfg.quant_bits == "none":
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-5)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-3


@pytest.mark.parametrize("impl", ["ref", "gather", "kernel"])
def test_dit_forward_matches_jax(pair, impl):
    jcfg, jp, tcfg, tp = pair
    jcfg = JD.DiTConfig(**{**jcfg.__dict__, "sla2_impl": impl})
    tcfg = TD.DiTConfig(**{**tcfg.__dict__, "sla2_impl": impl})
    lat, text, t, _ = _inputs(tcfg)
    want = JD.dit_forward(jp, jcfg, jnp.asarray(lat), jnp.asarray(text),
                          jnp.asarray(t))
    with torch.no_grad():
        got = TD.dit_forward(tp, tcfg, torch.from_numpy(lat),
                             torch.from_numpy(text), torch.from_numpy(t))
    assert got.dtype == torch.float32
    assert np.abs(np.asarray(want)).max() > 1e-2      # not the zero init
    _close(jcfg, got.numpy(), want)


def test_denoise_step_and_constants_match_jax(pair):
    jcfg, jp, tcfg, tp = pair
    lat, text, t, dt = _inputs(tcfg)
    kv_j = JD.precompute_text_kv(jp, jcfg, jnp.asarray(text))
    mods_j = JD.precompute_step_mods(jp, jcfg, jnp.asarray(t))
    want = JD.denoise_step(jp, jcfg, jnp.asarray(lat), None, None,
                           jnp.asarray(dt), text_kv=kv_j, mods=mods_j)
    with torch.no_grad():
        kv_t = TD.precompute_text_kv(tp, tcfg, torch.from_numpy(text))
        mods_t = TD.precompute_step_mods(tp, tcfg, torch.from_numpy(t))
        got = TD.denoise_step(tp, tcfg, torch.from_numpy(lat), None, None,
                              torch.from_numpy(dt), text_kv=kv_t,
                              mods=mods_t)
    for a, b in zip(kv_t, kv_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5,
                                   rtol=5e-5)
    for key in ("blocks", "final"):
        np.testing.assert_allclose(mods_t[key].numpy(),
                                   np.asarray(mods_j[key]), atol=5e-5,
                                   rtol=5e-5)
    assert not np.array_equal(got.numpy(), lat)       # the step moved x_t
    _close(jcfg, got.numpy(), want)


def test_cached_constants_equal_uncached_bitwise(pair):
    """Mirror of the reference's cached-constants test, non-trivial here
    because the modulation and output head are non-zero."""
    _, _, tcfg, tp = pair
    lat, text, _, dt = _inputs(tcfg, b=3, seed=2)
    t = torch.tensor([0.9, 0.5, 0.3])
    lat, text, dt = map(torch.from_numpy, (lat, text, dt))
    with torch.no_grad():
        old = TD.denoise_step(tp, tcfg, lat, text, t, dt)
        tbl = TD.precompute_step_mods(tp, tcfg, t)
        new = TD.denoise_step(tp, tcfg, lat, None, None, dt,
                              text_kv=TD.precompute_text_kv(tp, tcfg, text),
                              mods={"blocks": tbl["blocks"],
                                    "final": tbl["final"]})
    assert not torch.equal(old, lat)
    assert torch.equal(old, new)


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    ln = TL.init_layernorm(32)
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = TL.layernorm(ln, torch.from_numpy(x))
    want = JL.layernorm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    w_up = (rng.standard_normal((32, 64)) * 0.2).astype(np.float32)
    w_down = (rng.standard_normal((64, 32)) * 0.2).astype(np.float32)
    m = TL.init_mlp(torch.Generator().manual_seed(0), 32, 64)
    with torch.no_grad():
        m.w_up.weight.copy_(torch.from_numpy(w_up.T))
        m.w_down.weight.copy_(torch.from_numpy(w_down.T))
        got = TL.mlp(m, torch.from_numpy(x))
    want = JL.mlp({"w_up": jnp.asarray(w_up), "w_down": jnp.asarray(w_down)},
                  jnp.asarray(x), activation="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 0.125, 0.5, 0.999], np.float32)
    np.testing.assert_allclose(
        TD.timestep_embedding(torch.from_numpy(t), 256).numpy(),
        np.asarray(JD.timestep_embedding(jnp.asarray(t), 256)), atol=5e-5)


def test_init_shapes_and_zero_init_match_reference():
    """The port's own init: same tensors (in nn.Linear layout), the same
    zero-initialised adaLN/output tensors, finite truncated normals."""
    jcfg, tcfg = jsmoke(), smoke_config()
    jshapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        jbuild(jcfg).init, jax.random.PRNGKey(0)))
    n_ref = sum(int(np.prod(s)) for s in jax.tree.leaves(
        jshapes, is_leaf=lambda x: isinstance(x, tuple)))
    tp = TD.init_dit(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert sum(p.numel() for p in tp.parameters()) == n_ref
    for lin in (tp.final_ada, tp.patch_out, tp.blocks[0].ada):
        assert not lin.weight.any() and not lin.bias.any()
    w = tp.blocks[1].wq.weight.detach()
    assert w.shape == (tcfg.num_heads * tcfg.head_dim, tcfg.d_model)
    assert float(w.abs().max()) <= 2 * tcfg.d_model ** -0.5 + 1e-6
