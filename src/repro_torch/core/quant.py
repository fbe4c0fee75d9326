"""Low-bit quantisation for the SLA2 sparse branch (paper Sec. 5).

K-smoothing (``K - colmean(K)``, softmax-invariant), symmetric per-block
INT8 (``round(x / s)`` with ``s = max|x| / 127``, half to even) and FP8
e4m3 with per-block scales.  ``fake_quant`` is the QAT primitive: real
quantise->dequantise in the forward, identity in the backward.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INT8_MAX = 127.0
FP8_MAX = 448.0  # e4m3 max normal


class Quantized(NamedTuple):
    """Codes (int8 or float8_e4m3fn) and a broadcastable f32 scale."""
    values: torch.Tensor
    scale: torch.Tensor


def smooth_k(k: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """SageAttention K-smoothing: subtract the per-channel mean over tokens."""
    return k - k.mean(dim=dim, keepdim=True)


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division.  PyTorch's CUDA kernels divide by a
    Python scalar as a multiplication by its reciprocal, which can differ
    from the reference's division by an ulp (and so move a scale and flip
    a code); a tensor divisor keeps the true division."""
    return x / torch.full_like(x, c)


def _absmax(x: torch.Tensor, dims) -> torch.Tensor:
    return torch.amax(torch.abs(x), dim=dims, keepdim=True)


def quant_int8(x: torch.Tensor, dims=(-2, -1)) -> Quantized:
    """Symmetric INT8 with a per-block scale over ``dims``."""
    xf = x.to(torch.float32)
    s = torch.clamp(true_div(_absmax(xf, dims), INT8_MAX), min=1e-8)
    q = torch.clamp(torch.round(xf / s), -INT8_MAX, INT8_MAX)
    return Quantized(q.to(torch.int8), s)


def quant_fp8(x: torch.Tensor, dims=(-2, -1)) -> Quantized:
    """FP8 e4m3 with a per-block scale over ``dims``."""
    xf = x.to(torch.float32)
    s = torch.clamp(true_div(_absmax(xf, dims), FP8_MAX), min=1e-12)
    return Quantized((xf / s).to(torch.float8_e4m3fn), s)


def dequant(q: Quantized) -> torch.Tensor:
    """Codes times scale, in f32."""
    return q.values.to(torch.float32) * q.scale


def _fake_quant_fwd(x: torch.Tensor, bits: str, dims) -> torch.Tensor:
    if bits == "int8":
        q = quant_int8(x, dims)
    elif bits == "fp8":
        q = quant_fp8(x, dims)
    elif bits == "none":
        return x
    else:
        raise ValueError(f"unknown bits: {bits}")
    return dequant(q).to(x.dtype)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits, dims):
        return _fake_quant_fwd(x, bits, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quant(x: torch.Tensor, bits: str = "int8",
               dims=(-2, -1)) -> torch.Tensor:
    """Quantise->dequantise in the forward, straight-through (identity)
    gradient in the backward."""
    return _FakeQuant.apply(x, bits, tuple(dims))
