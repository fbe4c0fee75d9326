"""LM training in the port against the JAX package on the CPU: the
next-token loss and its gradients, remat, the ``lm`` data stream, the
train step and the Trainer, and a JAX LM train state carried across.

The qwen3 smoke config's params are the reference's (``PRNGKey(0)``),
carried across with ``convert.lm_params_from_numpy``; gradients come back
the same way.  The JAX side runs ``sla2_impl="gather"``; the port runs
``"kernel"`` (the autograd Function around the sparse-branch kernels,
their plain versions on the CPU) and ``"gather"``.

Bounds: loss 1e-5 relative at quant none, 1e-3 at int8; gradients, as a
relative max error over all leaves, 1e-4 at quant none and 1e-2 at int8
(one code that flips on a one-ulp difference moves the forward, and the
port's kernel quantises per tile where the JAX gather path fake-quantises
the same tiles in another order); the train step's params within 2
lr (a step-1 Adam update is lr * sign(g), and a near-zero g may flip).
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.data import make_dataset as jmake_dataset
from repro.models import transformer as JT
from repro.models.api import build_model as jbuild
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jadamw_init
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as jmake_train_step
from repro_torch.checkpoint import all_steps
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data import make_dataset
from repro_torch.models import transformer as TT
from repro_torch.models.api import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import (TrainConfig, Trainer, TrainerConfig,
                               make_train_step)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, LR = 96, 1e-3


@pytest.fixture(scope="module")
def tree():
    """The reference's qwen3 smoke params, as numpy."""
    jm = jbuild(get_smoke_config("qwen3_14b"))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _batch(seed=1, n=N, ignore=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (2, n + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if ignore:
        labels[0, :5] = -1
        labels[1, rng.random(n) < 0.2] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _as_port(jtree, tcfg) -> dict:
    """A JAX params-shaped tree -> {port parameter name: f32 array}."""
    mod = lm_params_from_numpy(jax.tree.map(np.asarray, jtree),
                               dataclasses.replace(tcfg, dtype="float32"),
                               device="cpu")
    return {n: p.detach().numpy() for n, p in mod.named_parameters()}


def _global_rel(got: dict, want: dict):
    num = max(float(np.abs(got[n] - want[n]).max()) for n in want)
    return num / max(float(np.abs(w).max()) for w in want.values())


def _port_grads(params, tcfg, batch):
    loss, metrics = TT.lm_loss(params, tcfg,
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, metrics, {n: (np.zeros(p.shape, np.float32) if g is None
                               else g.numpy())
                           for n, p, g in zip(names, leaves, grads)}


@pytest.mark.parametrize("impl", ["kernel", "gather"])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_lm_loss_and_grads_match_jax(tree, impl, quant):
    """Chunks of 40 over 96 positions (the last one padded), -1 labels,
    z-loss 1e-3."""
    over = dict(quant_bits=quant, loss_chunk=40, z_loss=1e-3)
    jcfg = get_smoke_config("qwen3_14b", **over)
    tcfg = tsmoke("qwen3_14b", sla2_impl=impl, **over)
    batch = _batch()
    (jl, jm), jg = jax.value_and_grad(JT.lm_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = lm_params_from_numpy(tree, tcfg, device="cpu")
    tl, tm, got = _port_grads(params, tcfg, batch)
    bound = 1e-5 if quant == "none" else 1e-3
    assert abs(float(tl) - float(jl)) <= bound * abs(float(jl))
    assert float(tm["tokens"]) == float(jm["tokens"]) == float(
        (batch["labels"] >= 0).sum())
    assert abs(float(tm["ce"]) - float(jm["ce"])) <= bound * float(jm["ce"])
    want = _as_port(jg, tcfg)
    assert set(got) == set(want)
    # hard Top-k routing: the router projections get no gradient
    for n in want:
        if ".router." in n:
            assert not np.any(want[n]) and not np.any(got[n])
    assert np.any(got["layers.0.attn.wq.weight"])
    assert _global_rel(got, want) < (1e-4 if quant == "none" else 1e-2)


def test_remat_gives_the_same_gradients(tree):
    """remat 'full' (every layer and loss chunk under checkpoint) and
    'none' give equal losses and gradients."""
    out = {}
    for remat in ("none", "full"):
        tcfg = tsmoke("qwen3_14b", quant_bits="none", sla2_impl="kernel",
                      remat=remat, loss_chunk=40)
        params = lm_params_from_numpy(tree, tcfg, device="cpu")
        out[remat] = _port_grads(params, tcfg, _batch(seed=2))
    assert torch.equal(out["none"][0], out["full"][0])
    for n, g in out["none"][2].items():
        np.testing.assert_allclose(out["full"][2][n], g, rtol=1e-5,
                                   atol=1e-7)


def test_lm_loss_without_valid_labels_and_mechanisms(tree):
    """Every label ignored gives loss 0 over one (clamped) token; the
    dense, SLA and sparse-only stacks have their own losses against
    JAX."""
    tcfg = tsmoke("qwen3_14b")
    params = lm_params_from_numpy(tree, tcfg, device="cpu")
    batch = _batch(seed=3)
    batch["labels"][:] = -1
    loss, m = TT.lm_loss(params, tcfg, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    assert float(loss) == 0.0 and float(m["tokens"]) == 1.0
    for mech in ("full", "sla", "sparse_only"):
        jm = jbuild(get_smoke_config("qwen3_14b", mechanism=mech))
        jp = jm.init(jax.random.PRNGKey(1))
        tm = build_model(tsmoke("qwen3_14b", mechanism=mech))
        tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), tm.cfg,
                                  device="cpu")
        batch = _batch(seed=4)
        jl, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad():
            tl, _ = tm.loss(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl)), mech


@pytest.mark.parametrize("step", [0, 5])
def test_lm_stream_equals_jax(step):
    jds = jmake_dataset(get_smoke_config("qwen3_14b"), seq_len=N,
                        global_batch=4, seed=3, host_index=1, host_count=2)
    tds = make_dataset(tsmoke("qwen3_14b"), seq_len=N, global_batch=4,
                       seed=3, host_index=1, host_count=2)
    a, b = tds[step], jds[step]
    assert sorted(a) == sorted(b) == ["labels", "tokens"]
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def _jax_state(tree, opt):
    p = jax.tree.map(jnp.asarray, tree)
    return {"params": p, "opt": jadamw_init(p, opt)}


def _assert_params_close(jparams, tparams, tcfg, bound):
    want = _as_port(jparams, tcfg)
    for n, p in tparams.named_parameters():
        assert float(np.abs(p.detach().numpy() - want[n]).max()) <= bound, n


@pytest.mark.parametrize("microbatches", [1, 2])
def test_lm_train_step_matches_jax(tree, microbatches):
    jcfg = get_smoke_config("qwen3_14b", quant_bits="none")
    tcfg = tsmoke("qwen3_14b", quant_bits="none", sla2_impl="kernel")
    batch = jmake_dataset(jcfg, seq_len=N, global_batch=2, seed=2)[0]
    jtc = JTrainConfig(optimizer=JAdamW(lr=LR), warmup_steps=1,
                       total_steps=10, microbatches=microbatches)
    ttc = TrainConfig(optimizer=AdamWConfig(lr=LR), warmup_steps=1,
                      total_steps=10, microbatches=microbatches)
    jst, jm = jmake_train_step(jbuild(jcfg), jtc, donate=False)(
        _jax_state(tree, jtc.optimizer),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = lm_params_from_numpy(tree, tcfg, device="cpu")
    tst, tm = make_train_step(build_model(tcfg), ttc)(
        {"params": params, "opt": adamw_init(params, ttc.optimizer)},
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * abs(
            float(jm[key])), key
    assert set(tm) == set(jm)
    _assert_params_close(jst["params"], tst["params"], tcfg, 2 * LR)


def test_lm_trainer_checkpoints_and_restores_bitwise():
    model = build_model(tsmoke("qwen3_14b", sla2_impl="kernel"))
    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(
            train=TrainConfig(optimizer=AdamWConfig(lr=LR), warmup_steps=1,
                              total_steps=2),
            ckpt_dir=d, max_steps=2, ckpt_every=1, keep=1, log_every=1,
            seed=3)
        ds = make_dataset(model.cfg, seq_len=64, global_batch=2, seed=4)
        out = Trainer(model, tc, ds, device="cpu", log_fn=lambda s: None).run()
        assert all_steps(d) == [2] and len(out["losses"]) == 2
        assert all(np.isfinite(out["losses"]))
        back = Trainer(model, tc, ds, device="cpu",
                       log_fn=lambda s: None).run()
        assert back["losses"] == []
        a, b = out["state"], back["state"]
        for x, y in zip(a["params"].parameters(), b["params"].parameters()):
            assert torch.equal(x, y)
        for key in ("m", "v"):
            for name, t in a["opt"][key].items():
                assert torch.equal(t, b["opt"][key][name])
        assert int(b["opt"]["step"]) == 2


def test_port_continues_from_a_jax_lm_state(tree):
    """Step 2 from the reference's step-1 LM state, carried across by
    train_state_from_numpy, matches the reference's step 2."""
    jcfg = get_smoke_config("qwen3_14b", quant_bits="none")
    tcfg = tsmoke("qwen3_14b", quant_bits="none", sla2_impl="kernel")
    jtc = JTrainConfig(optimizer=JAdamW(lr=LR), warmup_steps=1,
                       total_steps=10)
    ttc = TrainConfig(optimizer=AdamWConfig(lr=LR), warmup_steps=1,
                      total_steps=10)
    jstep = jmake_train_step(jbuild(jcfg), jtc, donate=False)
    ds = jmake_dataset(jcfg, seq_len=N, global_batch=2, seed=5)
    jst, _ = jstep(_jax_state(tree, jtc.optimizer),
                   {k: jnp.asarray(v) for k, v in ds[0].items()})
    tst = train_state_from_numpy(jax.tree.map(np.asarray, jst), tcfg,
                                 device="cpu")
    assert int(tst["opt"]["step"]) == 1
    assert tst["opt"]["m"]["layers.1.mlp.w_gate.weight"].shape == (128, 64)
    jst2, jm = jstep(jst, {k: jnp.asarray(v) for k, v in ds[1].items()})
    tst2, tm = make_train_step(build_model(tcfg), ttc)(
        tst, {k: torch.from_numpy(v) for k, v in ds[1].items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * float(
        jm["loss"])
    assert int(tst2["opt"]["step"]) == 2
    _assert_params_close(jst2["params"], tst2["params"], tcfg, 2 * LR)
