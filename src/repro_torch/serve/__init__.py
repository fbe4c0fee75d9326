"""Serving of the port: step-level diffusion serving (``diffusion.py``),
continuous-batching paged LM serving (``engine.py``: ``ServeEngine``)
and its static-cache baseline and oracle (``StaticWaveEngine``,
``generate_sequential``)."""
from repro_torch.serve.engine import (EngineConfig, PageAllocator, Request,
                                      ServeEngine, StaticWaveEngine,
                                      generate_sequential)

__all__ = ["EngineConfig", "PageAllocator", "Request", "ServeEngine",
           "StaticWaveEngine", "generate_sequential"]
