"""Model handle: ``build_model(cfg)`` returns a ``Model`` with the surface
the engines use: the video DiT (diffusion serving and training) and the
dense decoder-only LM (training, static and paged serving).

    model.init(seed, device="cuda")             -> params
    model.loss(params, batch)                   -> (loss, metrics)      DiT
    model.denoise(params, batch, caches)        -> (latents, caches)    DiT
    model.precompute_text_kv(params, text)      -> (k, v) per layer     DiT
    model.precompute_step_mods(params, t)       -> modulation tables    DiT
    model.loss(params, batch)                   -> (loss, metrics)      LM
    model.init_caches(batch, max_len)           -> static caches        LM
    model.prefill(params, batch, caches)        -> (logits, caches)     LM
    model.decode(params, batch, caches)         -> (logits, caches)     LM
    model.init_paged_caches(batch, num_pages)   -> page pools           LM
    model.prefill_chunk(params, batch, caches)  -> (logits, caches)     LM
    model.decode_paged(params, batch, caches)   -> (logits, caches)     LM
    model.swap_out(caches, page_row, slot)      -> slot state           LM
    model.swap_in(caches, page_row, slot, st)   -> caches               LM
    model.decode_verify(params, batch, caches)  -> (logits, caches)     LM
    model.commit_window(caches, page_table, lengths, accepted, active,
                        window)                 -> caches               LM
    model.draft_init(caches, batch)             -> draft states    LM, SLA2
    model.draft_step(params, batch, states)     -> (logits, states) LM, SLA2
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import dit as D
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Model:
    """The per-architecture handle ``build_model`` returns: config plus
    callables.  Optional fields are None where the architecture lacks
    that path."""
    kind: str                     # dit | lm
    cfg: Any
    init: Callable
    loss: Optional[Callable] = None
    denoise: Optional[Callable] = None
    precompute_text_kv: Optional[Callable] = None
    precompute_step_mods: Optional[Callable] = None
    # the static cache path (serve/engine.StaticWaveEngine,
    # generate_sequential)
    init_caches: Optional[Callable] = None
    prefill: Optional[Callable] = None
    decode: Optional[Callable] = None
    # paged LM serving (serve/engine.ServeEngine)
    init_paged_caches: Optional[Callable] = None
    prefill_chunk: Optional[Callable] = None
    decode_paged: Optional[Callable] = None
    swap_out: Optional[Callable] = None
    swap_in: Optional[Callable] = None
    has_slot_state: bool = False
    # speculative decoding: the verify window and its commit; the linear
    # drafter's handles exist for SLA2 stacks only
    decode_verify: Optional[Callable] = None
    commit_window: Optional[Callable] = None
    draft_init: Optional[Callable] = None
    draft_step: Optional[Callable] = None
    # not ported yet (ROADMAP): the prefix cache
    extract_totals: Optional[Callable] = None
    insert_totals: Optional[Callable] = None
    copy_page: Optional[Callable] = None

    def with_overrides(self, **overrides) -> "Model":
        """Rebuild this model with config fields replaced, e.g.
        ``model.with_overrides(sla2_impl='gather')`` or, for the LM,
        ``paged_impl``, ``decode_quant_bits`` and ``kv_quant``."""
        return build_model(dataclasses.replace(self.cfg, **overrides))


def _generator(seed, dev) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    return g


def _dit_model(cfg: D.DiTConfig) -> Model:
    def init(seed, device="cuda"):
        dev = resolve_device(device)
        return D.init_dit(_generator(seed, dev), cfg, dev)

    def denoise(p, b, caches):
        x = D.denoise_step(p, cfg, b["latents"], b.get("text"),
                           b.get("time"), b["dt"],
                           text_kv=b.get("text_kv"), mods=b.get("mods"))
        return x, caches

    return Model(
        kind="dit", cfg=cfg, init=init, denoise=denoise,
        loss=lambda p, b: D.flow_matching_loss(p, cfg, b),
        precompute_text_kv=lambda p, text: D.precompute_text_kv(p, cfg, text),
        precompute_step_mods=lambda p, t: D.precompute_step_mods(p, cfg, t))


def _lm_model(cfg: T.ModelConfig) -> Model:
    T.check_ported(cfg)

    def init(seed, device="cuda"):
        dev = resolve_device(device)
        return T.init_model(_generator(seed, dev), cfg, dev)

    def init_paged_caches(batch, num_pages, *, dtype=torch.bfloat16,
                          device="cuda"):
        return T.init_paged_caches(cfg, batch, num_pages, dtype=dtype,
                                   device=resolve_device(device))

    def init_caches(batch, max_len, *, dtype=torch.bfloat16, device="cuda"):
        return T.init_caches(cfg, batch, max_len, dtype=dtype,
                             device=resolve_device(device))

    draft = {}
    if cfg.mechanism == "sla2":
        draft = dict(
            draft_init=lambda c, b: T.draft_init(
                cfg, c, b["page_table"], b["lengths"], b["active"]),
            draft_step=lambda p, b, st: T.draft_step(
                p, cfg, b["token"], st, positions=b["positions"],
                active=b["active"]))
    return Model(
        kind="lm", cfg=cfg, init=init,
        loss=lambda p, b: T.lm_loss(p, cfg, b),
        init_caches=init_caches,
        prefill=lambda p, b, c: T.prefill(p, cfg, b["tokens"], c),
        decode=lambda p, b, c: T.decode_step(p, cfg, b["token"], c),
        init_paged_caches=init_paged_caches,
        prefill_chunk=lambda p, b, c: T.prefill_chunk(
            p, cfg, b["tokens"], c, page_row=b["page_row"],
            offset=b["offset"], chunk_len=b["chunk_len"], slot=b["slot"]),
        decode_paged=lambda p, b, c: T.decode_paged(
            p, cfg, b["token"], c, page_table=b["page_table"],
            lengths=b["lengths"], active=b["active"]),
        swap_out=lambda c, page_row, slot: T.swap_out_slot(
            cfg, c, page_row, slot),
        swap_in=lambda c, page_row, slot, state: T.swap_in_slot(
            cfg, c, page_row, slot, state),
        decode_verify=lambda p, b, c: T.decode_verify(
            p, cfg, b["tokens"], c, page_table=b["page_table"],
            lengths=b["lengths"], active=b["active"],
            window_len=b["window_len"]),
        commit_window=lambda c, page_table, lengths, accepted, active,
        window: T.commit_window(cfg, c, page_table, lengths, accepted,
                                active, window),
        has_slot_state=T.has_slot_state(cfg), **draft)


def build_model(cfg) -> Model:
    """Dispatch a config dataclass to its Model handle."""
    if isinstance(cfg, D.DiTConfig):
        return _dit_model(cfg)
    if isinstance(cfg, T.ModelConfig):
        return _lm_model(cfg)
    raise TypeError(f"config type {type(cfg).__name__} is not ported")
