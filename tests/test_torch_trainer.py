"""The port's data pipeline, checkpointer and trainer.

The synthetic batches must be byte-equal to the reference's (the same
numpy generator from (seed, step, host)).  The checkpoint tests mirror the
reference's (tests/test_integration.py) plus a bf16 round trip and the
host copy that ``save_async`` takes before it returns.  A crash mid-run
must resume to a final state that equals an uninterrupted run bit for bit
(``torch.equal``) on the CPU.
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from repro.configs.wan_dit_1_3b import smoke_config as jsmoke
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JDataset
from repro.data import make_dataset as jmake_dataset
from repro_torch.checkpoint import (Checkpointer, all_steps, latest_step,
                                    restore, save)
from repro_torch.configs.wan_dit_1_3b import smoke_config
from repro_torch.data import (DataConfig, Prefetcher, SyntheticDataset,
                              make_dataset)
from repro_torch.models.api import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer, TrainerConfig
from repro_torch.train.trainer import run_with_restarts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _assert_batches_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
        assert a[key].tobytes() == b[key].tobytes(), key


def test_dit_batches_byte_equal_to_jax():
    jds = jmake_dataset(jsmoke(), seq_len=64, global_batch=4, seed=5)
    tds = make_dataset(smoke_config(), seq_len=64, global_batch=4, seed=5)
    for step in (0, 1, 7):
        _assert_batches_equal(tds[step], jds[step])


@pytest.mark.parametrize("kind", ["lm", "vlm", "audio"])
def test_token_batches_byte_equal_to_jax(kind):
    kw = dict(seed=2, global_batch=4, seq_len=32, vocab_size=97, kind=kind,
              n_image_tokens=8, d_model=16, n_frames=6, host_index=1,
              host_count=2)
    jds, tds = JDataset(JDataConfig(**kw)), SyntheticDataset(DataConfig(**kw))
    for step in (0, 3):
        _assert_batches_equal(tds[step], jds[step])


def test_prefetcher_yields_in_order():
    ds = make_dataset(smoke_config(), seq_len=16, global_batch=2)
    pf = Prefetcher(ds.iterate(3), depth=2)
    for step in (3, 4, 5):
        _assert_batches_equal(next(pf), ds[step])
    pf.close()


def test_make_dataset_takes_only_ported_configs():
    with pytest.raises(TypeError, match="not ported"):
        make_dataset(object(), seq_len=16, global_batch=2)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_atomic_keep_and_elastic_dtype():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.arange(12.0).reshape(3, 4),
                "b": {"c": torch.ones(2, dtype=torch.int32)}}
        for s in (1, 2, 3, 4):
            save(d, s, tree, keep=2)
        assert latest_step(d) == 4 and all_steps(d) == [3, 4]
        assert len(os.listdir(d)) == 2            # keep-k GC
        like = {"a": torch.zeros(3, 4, dtype=torch.float64),
                "b": {"c": torch.zeros(2, dtype=torch.int32)}}
        back = restore(d, 4, like)
        assert back["a"].dtype == torch.float64
        np.testing.assert_array_equal(back["a"].numpy(), tree["a"].numpy())
        assert torch.equal(back["b"]["c"], tree["b"]["c"])
        # a stale .tmp directory is invisible to restore
        os.makedirs(os.path.join(d, "step_00000009.tmp"))
        assert latest_step(d) == 4


def test_checkpointer_async_roundtrip_copies_before_returning():
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=1)
        w = torch.full((4, 4), 3.0)
        ck.save_async(7, {"w": w, "step": 7})
        w.add_(1.0)              # an in-place update after the save began
        ck.wait()
        step, got = ck.restore_latest({"w": torch.zeros(4, 4), "step": 0})
        assert step == 7 and got["step"] == 7
        assert torch.equal(got["w"], torch.full((4, 4), 3.0))


def test_checkpoint_bf16_roundtrip_and_modules():
    model = build_model(smoke_config(dtype="bfloat16"))
    params = model.init(0, device="cpu")
    state = {"params": params, "m": {"x": torch.randn(
        5, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)}}
    with tempfile.TemporaryDirectory() as d:
        path = save(d, 1, state)
        manifest = json.load(open(os.path.join(path, "manifest.json")))
        assert {e["dtype"] for e in manifest["leaves"]} == {"bfloat16"}
        like = {"params": model.init(9, device="cpu"),
                "m": {"x": torch.zeros(5, dtype=torch.bfloat16)}}
        back = restore(d, 1, like)
        assert back["params"] is like["params"]
        for (n, a), (_, b) in zip(params.named_parameters(),
                                  back["params"].named_parameters()):
            assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b), n
        assert torch.equal(back["m"]["x"], state["m"]["x"])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_crash_restart_resumes_deterministically():
    """A crash mid-run restarts from the checkpoint, and the final state is
    identical to an uninterrupted run (the data is a function of the step)."""
    cfg = smoke_config(sla2_impl="kernel")
    model = build_model(cfg)
    ds = make_dataset(cfg, seq_len=64, global_batch=2, seed=3)

    def make(ckpt_dir, fault):
        return Trainer(model, TrainerConfig(
            train=TrainConfig(optimizer=AdamWConfig(lr=1e-3),
                              warmup_steps=2, total_steps=8, microbatches=2),
            ckpt_dir=ckpt_dir, max_steps=6, ckpt_every=2, log_every=100),
            ds, device="cpu", fault_hook=fault, log_fn=lambda s: None)

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        out_clean = make(d1, None).run()
        crashed = {"done": False}

        def fault(step):
            if step == 3 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("injected")

        out_crash = run_with_restarts(lambda: make(d2, fault))
        assert out_crash["restarts"] == 1
        assert latest_step(d2) == 6
        assert len(out_clean["losses"]) == 6 and len(out_crash["losses"]) == 4
        a, b = out_clean["state"], out_crash["state"]
        for (n, p), (_, q) in zip(a["params"].named_parameters(),
                                  b["params"].named_parameters()):
            assert torch.equal(p, q), n
        for key in ("m", "v"):
            for n, t in a["opt"][key].items():
                assert torch.equal(t, b["opt"][key][n]), (key, n)
        assert int(a["opt"]["step"]) == int(b["opt"]["step"]) == 6


def test_trainer_asks_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is valid")
    cfg = smoke_config()
    with tempfile.TemporaryDirectory() as d, \
            pytest.raises(RuntimeError, match="CUDA"):
        Trainer(build_model(cfg), TrainerConfig(
            train=TrainConfig(), ckpt_dir=d),
            make_dataset(cfg, seq_len=64, global_batch=2))
