"""Serving of the port: step-level diffusion serving (``diffusion.py``)."""
