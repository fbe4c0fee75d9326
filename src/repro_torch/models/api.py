"""Model handle: ``build_model(cfg)`` returns a ``Model`` with the surface
the diffusion engine uses.  Only the DiT is ported so far.

    model.init(seed, device="cuda")             -> params (DiTParams)
    model.denoise(params, batch, caches)        -> (latents, caches)
    model.precompute_text_kv(params, text)      -> (k, v) per layer
    model.precompute_step_mods(params, t)       -> modulation tables
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import dit as D


@dataclasses.dataclass
class Model:
    """The per-architecture handle ``build_model`` returns: config plus
    callables.  Optional fields are None where the architecture lacks
    that path."""
    kind: str                     # dit
    cfg: Any
    init: Callable
    denoise: Optional[Callable] = None
    precompute_text_kv: Optional[Callable] = None
    precompute_step_mods: Optional[Callable] = None

    def with_overrides(self, **overrides) -> "Model":
        """Rebuild this model with config fields replaced, e.g.
        ``model.with_overrides(sla2_impl='gather')``."""
        return build_model(dataclasses.replace(self.cfg, **overrides))


def _dit_model(cfg: D.DiTConfig) -> Model:
    def init(seed, device="cuda"):
        dev = resolve_device(device)
        if isinstance(seed, torch.Generator):
            g = seed
        else:
            g = torch.Generator(device=dev)
            g.manual_seed(int(seed))
        return D.init_dit(g, cfg, dev)

    def denoise(p, b, caches):
        x = D.denoise_step(p, cfg, b["latents"], b.get("text"),
                           b.get("time"), b["dt"],
                           text_kv=b.get("text_kv"), mods=b.get("mods"))
        return x, caches

    return Model(
        kind="dit", cfg=cfg, init=init, denoise=denoise,
        precompute_text_kv=lambda p, text: D.precompute_text_kv(p, cfg, text),
        precompute_step_mods=lambda p, t: D.precompute_step_mods(p, cfg, t))


def build_model(cfg) -> Model:
    """Dispatch a config dataclass to its Model handle."""
    if isinstance(cfg, D.DiTConfig):
        return _dit_model(cfg)
    raise TypeError(f"config type {type(cfg).__name__} is not ported")
