"""Serving of the port: step-level diffusion serving (``diffusion.py``) and
continuous-batching paged LM serving (``engine.py``)."""
