"""PyTorch + CUDA port of the SLA2 reproduction (``repro`` is the JAX reference).

The subpackages mirror ``repro``: ``core/`` (masks, quantisation, the
router and the SLA2 operator), ``kernels/`` (the hand-written Hopper
kernels, their plain PyTorch versions and the build), ``models/`` (the
video DiT), ``configs/`` and ``serve/`` (step-level diffusion serving).
``csrc/`` holds the CUDA sources; ``convert.py`` carries a JAX param
pytree (as numpy arrays) across.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Importing this package builds nothing and never needs ``nvcc``.
"""
import torch


def resolve_device(device) -> torch.device:
    """Turn a device argument into a ``torch.device``; raise when CUDA is
    asked for on a machine that has none (never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' explicitly")
    return dev
