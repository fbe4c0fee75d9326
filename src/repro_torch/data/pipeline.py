"""Deterministic synthetic data pipeline, host-side numpy.

Every batch is a pure function of (seed, step, host): the generator is
``np.random.default_rng(SeedSequence([seed, step, host_index]))``, the
same formula as the reference's, so the port's batches are byte-equal to
the reference's.  Restoring a checkpoint restores the data cursor (the
step), and skip-ahead is O(1).

Token streams are Zipf-distributed over the vocab with a first-order
Markov flavour (the next token depends on the previous one's residue).
Video-latent, frame and patch fields are unit Gaussians.

``Prefetcher`` wraps an iterator with a background thread double buffer.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Stream geometry, host sharding and the modality's extra widths."""
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    vocab_size: int = 1024
    host_index: int = 0
    host_count: int = 1
    kind: str = "lm"                # lm | vlm | audio | dit
    n_image_tokens: int = 0
    d_model: int = 0
    n_frames: int = 0
    c_latent: int = 0
    n_text: int = 0


def _tokens_for(step: int, cfg: DataConfig, rng: np.random.Generator,
                batch: int, seq: int) -> np.ndarray:
    """Zipf marginals plus first-order structure (learnable)."""
    v = cfg.vocab_size
    base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    toks = (base - 1) % v
    # with p = 0.5 the next token is prev * 7 + 3 mod v
    coin = rng.random((batch, seq)) < 0.5
    for_shift = (toks * 7 + 3) % v
    toks[:, 1:] = np.where(coin[:, 1:], for_shift[:, :-1], toks[:, 1:])
    return toks.astype(np.int32)


class SyntheticDataset:
    """Map-style deterministic dataset: ``ds[step]`` -> host batch (numpy)."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.host_count:
            raise ValueError("global batch must divide across hosts")
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.host_count

    def __getitem__(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
        b, n = self.host_batch, cfg.seq_len
        if cfg.kind == "lm":
            toks = _tokens_for(step, cfg, rng, b, n + 1)
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.kind == "vlm":
            n_txt = n - cfg.n_image_tokens
            toks = _tokens_for(step, cfg, rng, b, n_txt + 1)
            img = rng.standard_normal(
                (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
            return {"image_embeds": img, "tokens": toks[:, :-1],
                    "labels": toks[:, 1:]}
        if cfg.kind == "audio":
            toks = _tokens_for(step, cfg, rng, b, n + 1)
            frames = rng.standard_normal(
                (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
            return {"frames": frames, "tokens": toks[:, :-1],
                    "labels": toks[:, 1:]}
        if cfg.kind == "dit":
            lat = rng.standard_normal((b, n, cfg.c_latent)).astype(np.float32)
            txt = rng.standard_normal(
                (b, cfg.n_text, cfg.d_model)).astype(np.float32)
            noise = rng.standard_normal(
                (b, n, cfg.c_latent)).astype(np.float32)
            t = rng.random((b,)).astype(np.float32)
            return {"latents": lat, "text": txt, "noise": noise, "time": t}
        raise ValueError(cfg.kind)

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        """Endless batches from ``start_step`` on."""
        step = start_step
        while True:
            yield self[step]
            step += 1


class Prefetcher:
    """Background-thread double buffering around a batch iterator."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        """Ask the background thread to stop after its current item."""
        self._stop.set()


def make_dataset(model_cfg, seq_len: int, global_batch: int, *,
                 seed: int = 0, host_index: int = 0,
                 host_count: int = 1) -> SyntheticDataset:
    """The synthetic stream for a model config: ``dit`` for the DiT,
    ``lm`` for the decoder-only LM (the ported families)."""
    from repro_torch.models import dit as D
    from repro_torch.models import transformer as T
    if isinstance(model_cfg, D.DiTConfig):
        cfg = DataConfig(seed=seed, global_batch=global_batch,
                         seq_len=seq_len, kind="dit",
                         d_model=model_cfg.d_model,
                         c_latent=model_cfg.c_latent,
                         n_text=model_cfg.n_text, host_index=host_index,
                         host_count=host_count)
    elif isinstance(model_cfg, T.ModelConfig):
        cfg = DataConfig(seed=seed, global_batch=global_batch,
                         seq_len=seq_len, kind="lm",
                         vocab_size=model_cfg.vocab_size,
                         host_index=host_index, host_count=host_count)
    else:
        raise TypeError(f"config type {type(model_cfg).__name__} is not "
                        "ported")
    return SyntheticDataset(cfg)
