"""Serving of the port: step-level diffusion serving (``diffusion.py``),
continuous-batching paged LM serving (``engine.py``: ``ServeEngine``, with
the copy-on-write prefix cache of ``prefix_cache.py``) and its
static-cache baseline and oracle (``StaticWaveEngine``,
``generate_sequential``)."""
from repro_torch.serve.engine import (EngineConfig, PageAllocator, Request,
                                      ServeEngine, StaticWaveEngine,
                                      generate_sequential)
from repro_torch.serve.prefix_cache import PrefixCache, PrefixNode

__all__ = ["EngineConfig", "PageAllocator", "PrefixCache", "PrefixNode",
           "Request", "ServeEngine", "StaticWaveEngine",
           "generate_sequential"]
