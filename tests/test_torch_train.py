"""The port's training path against the JAX reference on the CPU.

SoftTop-k (values and the implicit-function VJP), soft routing, the soft
SLA2 operator and the stage-1 loss; the DiT's flow-matching loss and its
gradients through the kernel-mode operator (the port's autograd Function
around the sparse-branch kernels; the reference's custom VJP around its
Pallas kernels in interpret mode); AdamW and the cosine schedule; EF
compression; the whole train step, with and without microbatches; and the
port continuing from the reference's step-1 state.

Model-level comparisons fill the zero-initialised ``ada``, ``final_ada``
and ``patch_out`` with seeded values first: at init every block gradient
of the DiT is exactly zero.  Bounds, each with its reason:
  * SoftTop-k: atol 1e-6, rtol 1e-5 (60 bisection steps in f32 on both);
  * soft routing / soft SLA2 / stage-1 loss: 1e-4 relative;
  * DiT loss 1e-5 relative; its gradients a relative max error (over all
    leaves) of 1e-4 for quant 'none' and 1e-3 for int8, where one rounded
    P or V code that flips on a 1-ulp difference moves the forward (both
    measured at 3.4e-6 here);
  * AdamW and the schedule: 1e-6;
  * train step: loss and grad_norm 1e-5 relative, params within 2 lr
    (a step-1 Adam update is lr * sign(g), and a near-zero g may flip).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.wan_dit_1_3b import smoke_config as jsmoke
from repro.core import router as jrouter
from repro.core import sla2 as jsla2
from repro.core.soft_topk import soft_topk as jsoft_topk
from repro.data import make_dataset as jmake_dataset
from repro.models.api import build_model as jbuild
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim.schedules import cosine_schedule as jcosine
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro.train.train_step import _ef_compress as jef_compress
from repro_torch.configs.wan_dit_1_3b import smoke_config
from repro_torch.convert import (dit_params_from_numpy, sla2_params_from_numpy,
                                 train_state_from_numpy)
from repro_torch.core import masks as tmasks
from repro_torch.core import router as trouter
from repro_torch.core import sla2 as tsla2
from repro_torch.core.soft_topk import soft_topk
from repro_torch.data import make_dataset
from repro_torch.models.api import build_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.train_step import _ef_compress
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N_LAT = 64
LR = 1e-3


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# SoftTop-k, soft routing, the soft operator and the stage-1 loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_soft_topk_values_and_vjp(causal):
    scores, g = _rand((2, 8, 16), 0, 2.0), _rand((2, 8, 16), 1)
    allowed = (np.asarray(tmasks.block_causal_mask(8, 16, 32, 16))
               if causal else None)
    jfn = lambda s: jsoft_topk(s, 0.25, 0.1, None if allowed is None
                               else jnp.asarray(allowed))
    jm, vjp = jax.vjp(jfn, jnp.asarray(scores))
    (jg,) = vjp(jnp.asarray(g))
    ts = torch.from_numpy(scores).requires_grad_()
    tm = soft_topk(ts, 0.25, 0.1, None if allowed is None
                   else torch.from_numpy(allowed))
    tm.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-5)


def _sla2_pair(h, t_m, d, seed=11):
    eye = np.eye(d, dtype=np.float32)
    tree = {"router": {"proj_q": eye + _rand((d, d), seed, 0.05),
                       "proj_k": eye + _rand((d, d), seed + 1, 0.05)},
            "alpha_logit": _rand((h, t_m), seed + 2, 1.0)}
    return (jax.tree.map(jnp.asarray, tree),
            sla2_params_from_numpy(tree, device="cpu"))


@pytest.mark.parametrize("causal", [False, True])
def test_soft_route_attention_and_stage1_loss(causal):
    b, h, n, d, bq, bk = 2, 2, 128, 32, 32, 16
    q, k, v = (_rand((b, h, n, d), s) for s in range(3))
    jp, tp = _sla2_pair(h, n // bq, d)
    rkw = dict(block_q=bq, block_k=bk, k_frac=0.3, causal=causal, tau=0.2)
    jcfg = jsla2.SLA2Config(router=jrouter.RouterConfig(**rkw),
                            quant_bits="none", impl="kernel")
    tcfg = tsla2.SLA2Config(router=trouter.RouterConfig(**rkw),
                            quant_bits="none", impl="kernel")
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jm = jrouter.route(jp["router"], jq, jk, jcfg.router, soft=True)
    tm = trouter.route(tp.router, tq, tk, tcfg.router, soft=True)
    assert _rel(tm, jm) < 1e-4
    jo = jsla2.sla2_attention(jp, jq, jk, jv, jcfg, soft=True)
    to = tsla2.sla2_attention(tp, tq, tk, tv, tcfg, soft=True)
    assert _rel(to, jo) < 1e-4
    jl, jg = jax.value_and_grad(
        lambda p: jsla2.sla2_mse_loss(p, jq, jk, jv, jcfg, soft=True))(jp)
    tl = tsla2.sla2_mse_loss(tp, tq, tk, tv, tcfg, soft=True)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * abs(float(jl))
    assert _rel(tp.alpha_logit.grad, jg["alpha_logit"]) < 1e-4
    for name in ("proj_q", "proj_k"):      # nn.Linear holds the transpose
        assert _rel(getattr(tp.router, name).weight.grad.T,
                    jg["router"][name]) < 1e-4


# ---------------------------------------------------------------------------
# the DiT's flow-matching loss and its gradients (kernel-mode operator)
# ---------------------------------------------------------------------------

def _perturbed_tree(params, seed=0, std=0.1):
    """The reference params as numpy, with ada, final_ada and patch_out
    filled with seeded N(0, std^2)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, params)
    for group in (tree["blocks"]["ada"], tree["final_ada"],
                  tree["patch_out"]):
        for name in ("w", "b"):
            group[name] = (rng.standard_normal(group[name].shape)
                           * std).astype(group[name].dtype)
    return tree


@pytest.fixture(scope="module")
def tree():
    return _perturbed_tree(jbuild(jsmoke()).init(jax.random.PRNGKey(0)))


def _batch(cfg, seed=1):
    return jmake_dataset(cfg, seq_len=N_LAT, global_batch=2, seed=seed)[0]


def _grads_as_port(jgrads, tcfg):
    """JAX gradient tree -> {port parameter name: f32 array}."""
    mod = dit_params_from_numpy(jax.tree.map(np.asarray, jgrads),
                                dataclasses.replace(tcfg, dtype="float32"),
                                device="cpu")
    return {n: p.detach().numpy() for n, p in mod.named_parameters()}


def _global_rel(got: dict, want: dict):
    num = max(float(np.abs(got[n] - want[n]).max()) for n in want)
    return num / max(float(np.abs(w).max()) for w in want.values())


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_flow_matching_loss_and_grads_match_jax(tree, quant):
    jcfg = jsmoke(quant_bits=quant, sla2_impl="kernel")
    tcfg = smoke_config(quant_bits=quant, sla2_impl="kernel")
    batch = _batch(jcfg)
    (jl, _), jg = jax.value_and_grad(jbuild(jcfg).loss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = dit_params_from_numpy(tree, tcfg, device="cpu")
    tl, metrics = build_model(tcfg).loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    tl.backward()
    assert torch.equal(metrics["mse"], tl)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    got = {n: p.grad.numpy() for n, p in params.named_parameters()
           if p.grad is not None}
    want = _grads_as_port(jg, tcfg)
    # hard Top-k routing has no gradient: the router projections get none
    assert all("router" in n for n in set(want) - set(got))
    assert all(not np.any(want[n]) for n in set(want) - set(got))
    assert np.any(got["blocks.0.wq.weight"])
    got.update({n: np.zeros_like(want[n]) for n in set(want) - set(got)})
    assert _global_rel(got, want) < (1e-4 if quant == "none" else 1e-3)


# ---------------------------------------------------------------------------
# optimizer, schedule, EF compression
# ---------------------------------------------------------------------------

def test_adamw_and_cosine_schedule_match_jax():
    shapes = {"a": (4, 8), "b": (8,), "c": (3, 5, 2)}
    params = {n: _rand(s, i, 1.0) for i, (n, s) in enumerate(shapes.items())}
    jcfg = JAdamW(lr=1e-2, weight_decay=0.1, grad_clip=0.5)
    tcfg = AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=0.5)
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    tp = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    jst, tst = jadamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for step in range(4):
        grads = {n: _rand(s, 10 * step + i) for i, (n, s)
                 in enumerate(shapes.items())}
        js, ts = jcosine(step, 2, 6), cosine_schedule(step, 2, 6)
        np.testing.assert_allclose(float(ts), float(js), atol=1e-6)
        jp, jst, jm = jadamw_update(
            jp, {n: jnp.asarray(g) for n, g in grads.items()}, jst, jcfg, js)
        _, tst, tm = adamw_update(
            tp, {n: torch.from_numpy(g) for n, g in grads.items()}, tst, tcfg,
            ts)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       atol=1e-6)
            np.testing.assert_allclose(tst["m"][n].numpy(),
                                       np.asarray(jst["m"][n]), atol=1e-6)
            np.testing.assert_allclose(tst["v"][n].numpy(),
                                       np.asarray(jst["v"][n]), atol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 4


def test_ef_compress_matches_jax():
    grads = {"a": _rand((16, 8), 0), "b": _rand((5,), 1, 1e-3)}
    ef = {n: (0.01 * _rand(g.shape, 7)) for n, g in grads.items()}
    jq, jef = jef_compress({n: jnp.asarray(g) for n, g in grads.items()},
                           {n: jnp.asarray(e, jnp.bfloat16)
                            for n, e in ef.items()})
    tq, tef = _ef_compress({n: torch.from_numpy(g) for n, g in grads.items()},
                           {n: torch.from_numpy(e).to(torch.bfloat16)
                            for n, e in ef.items()})
    for n in grads:
        np.testing.assert_allclose(tq[n].numpy(), np.asarray(jq[n]),
                                   rtol=1e-6, atol=1e-9)
        assert tef[n].dtype == torch.bfloat16
        np.testing.assert_allclose(tef[n].float().numpy(),
                                   np.asarray(jef[n], np.float32),
                                   rtol=1e-2, atol=1e-9)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _jax_state(tree, opt):
    p = jax.tree.map(jnp.asarray, tree)
    return {"params": p, "opt": jadamw_init(p, opt)}


def _assert_params_close(jparams, tparams, tcfg, bound):
    want = _grads_as_port(jparams, tcfg)
    for n, p in tparams.named_parameters():
        assert float(np.abs(p.detach().numpy() - want[n]).max()) <= bound, n


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(tree, microbatches):
    jcfg = jsmoke(quant_bits="none", sla2_impl="kernel")
    tcfg = smoke_config(quant_bits="none", sla2_impl="kernel")
    batch = _batch(jcfg, seed=2)
    assert all(np.array_equal(batch[k], v) for k, v in make_dataset(
        tcfg, seq_len=N_LAT, global_batch=2, seed=2)[0].items())
    jtc = JTrainConfig(optimizer=JAdamW(lr=LR), warmup_steps=1,
                       total_steps=10, microbatches=microbatches)
    ttc = TrainConfig(optimizer=AdamWConfig(lr=LR), warmup_steps=1,
                      total_steps=10, microbatches=microbatches)
    jst, jm = jmake_train_step(jbuild(jcfg), jtc, donate=False)(
        _jax_state(tree, jtc.optimizer),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = dit_params_from_numpy(tree, tcfg, device="cpu")
    tst, tm = make_train_step(build_model(tcfg), ttc)(
        {"params": params, "opt": adamw_init(params, ttc.optimizer)},
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * abs(
            float(jm[key])), key
    assert set(tm) == set(jm)
    _assert_params_close(jst["params"], tst["params"], tcfg, 2 * LR)


def test_port_continues_from_jax_step_one_state(tree):
    """Step 2 from the reference's step-1 state (with EF buffers), carried
    across by train_state_from_numpy, matches the reference's step 2."""
    jcfg = jsmoke(quant_bits="none", sla2_impl="kernel")
    tcfg = smoke_config(quant_bits="none", sla2_impl="kernel")
    jtc = JTrainConfig(optimizer=JAdamW(lr=LR), warmup_steps=1,
                       total_steps=10, compress_grads="int8_ef")
    ttc = TrainConfig(optimizer=AdamWConfig(lr=LR), warmup_steps=1,
                      total_steps=10, compress_grads="int8_ef")
    jstep = jmake_train_step(jbuild(jcfg), jtc, donate=False)
    jst = _jax_state(tree, jtc.optimizer)
    jst["ef"] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.bfloat16),
                             jst["params"])
    jst, _ = jstep(jst, {k: jnp.asarray(v)
                         for k, v in _batch(jcfg, seed=3).items()})
    tst = train_state_from_numpy(jax.tree.map(np.asarray, jst), tcfg,
                                 device="cpu")
    assert int(tst["opt"]["step"]) == 1
    assert tst["ef"]["blocks.0.wq.weight"].dtype == torch.bfloat16
    batch = _batch(jcfg, seed=4)
    jst2, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
    tst2, tm = make_train_step(build_model(tcfg), ttc)(
        tst, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * float(
        jm["loss"])
    assert int(tst2["opt"]["step"]) == 2
    _assert_params_close(jst2["params"], tst2["params"], tcfg, 2 * LR)
