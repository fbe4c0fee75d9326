"""Stage-1 router training in the port.

A port version of the reference's two-stage test: fitting (R, alpha) with
SoftTop-k must beat the SLA-style heuristic start on hard-Top-k MSE by at
least 30% (tests/test_integration.py:91).  The port draws its own q/k/v
from a ``torch.Generator``, so its numbers are not the reference's; the
bound is the same.  ``init_alpha_from_data`` is held to the reference on
the same numpy q/k and params (1e-5: softmax mass, mean, logit in f32).
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import router as jrouter
from repro.core import sla2 as jsla2
from repro.train.stage1 import init_alpha_from_data as jinit_alpha
from repro_torch.convert import sla2_params_from_numpy
from repro_torch.core import router as trouter
from repro_torch.core import sla2 as tsla2
from repro_torch.optim import AdamWConfig
from repro_torch.train.stage1 import (Stage1Config, capture_qkv_stream,
                                      init_alpha_from_data, run_stage1,
                                      synthetic_qkv)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_two_stage_training_improves_over_heuristic():
    cfg = tsla2.SLA2Config(router=trouter.RouterConfig(
        block_q=32, block_k=16, k_frac=0.1, causal=False),
        quant_bits="none", impl="ref")
    stream = capture_qkv_stream(0, batch=2, heads=2, seq=256, dim=32,
                                device="cpu")
    params, hist = run_stage1(
        0, stream, cfg,
        Stage1Config(k_fracs=(0.1,), steps_per_k=40,
                     optimizer=AdamWConfig(lr=3e-3, weight_decay=0.0),
                     tau_start=0.5, tau_end=0.02),
        head_dim=32, num_heads=2, n_q_blocks=8, device="cpu",
        log_fn=lambda s: None)
    pk = hist["per_k"][0.1]
    assert len(hist["loss"]) == 40 and np.isfinite(hist["loss"]).all()
    assert pk["after"] < pk["before"] * 0.7
    assert params.router is not None


def test_init_alpha_from_data_matches_jax():
    b, h, n, d = 2, 2, 128, 16
    q, k = _rand((b, h, n, d), 0), _rand((b, h, n, d), 1)
    eye = np.eye(d, dtype=np.float32)
    tree = {"router": {"proj_q": eye + _rand((d, d), 2, 0.05),
                       "proj_k": eye + _rand((d, d), 3, 0.05)},
            "alpha_logit": np.zeros((h, 8), np.float32)}
    for causal in (False, True):
        rkw = dict(block_q=32, block_k=16, k_frac=0.3, causal=causal)
        jp = jinit_alpha(
            {"router": {kk: jnp.asarray(v) for kk, v in
                        tree["router"].items()},
             "alpha_logit": jnp.asarray(tree["alpha_logit"])},
            jnp.asarray(q), jnp.asarray(k),
            jsla2.SLA2Config(router=jrouter.RouterConfig(**rkw)))
        tp = init_alpha_from_data(
            sla2_params_from_numpy(tree, device="cpu"), torch.from_numpy(q),
            torch.from_numpy(k),
            tsla2.SLA2Config(router=trouter.RouterConfig(**rkw)))
        got = tp.alpha_logit.detach().numpy()
        np.testing.assert_allclose(got, np.asarray(jp["alpha_logit"]),
                                   atol=1e-5, rtol=1e-5)
        # the table is longer than the data's 4 blocks: the rest stays
        assert np.all(got[:, :4] != 0) and not np.any(got[:, 4:])


def test_synthetic_qkv_is_seeded_and_structured():
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    a = synthetic_qkv(g1, batch=1, heads=2, seq=64, dim=16)
    b = synthetic_qkv(g2, batch=1, heads=2, seq=64, dim=16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (1, 2, 64, 16)
    s1 = capture_qkv_stream(7, batch=1, heads=1, seq=32, dim=8, device="cpu")
    s2 = capture_qkv_stream(7, batch=1, heads=1, seq=32, dim=8, device="cpu")
    first, second = next(s1), next(s1)
    assert all(torch.equal(x, y) for x, y in zip(first, next(s2)))
    assert not torch.equal(first[0], second[0])
