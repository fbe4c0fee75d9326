"""Shared model layers: truncated-normal init, LayerNorm, the MLP.

Weights of ``x @ w`` products are ``nn.Linear`` modules: (out, in), the
transpose of the JAX layout.  Norms compute in f32 and cast back, as the
reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def truncated_normal(generator: torch.Generator, shape, dtype, stddev: float,
                     device=None) -> torch.Tensor:
    """``stddev * N(0, 1)`` truncated to [-2, 2], drawn in f32, cast to
    ``dtype`` before the scaling (as the reference does)."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x.to(dtype) * stddev


def linear(generator, d_in: int, d_out: int, dtype, stddev: float,
           device=None, bias: bool = False) -> nn.Linear:
    """Bias-free (or zero-bias) linear map with a truncated-normal weight,
    drawn in the JAX (in, out) shape and stored transposed."""
    lin = nn.Linear(d_in, d_out, bias=bias, dtype=dtype, device=device)
    with torch.no_grad():
        lin.weight.copy_(truncated_normal(generator, (d_in, d_out), dtype,
                                          stddev, device).T)
        if bias:
            lin.bias.zero_()
    return lin


def zero_linear(d_in: int, d_out: int, dtype, device=None) -> nn.Linear:
    """Linear map with zero weight and bias (adaLN-zero, output head)."""
    lin = nn.Linear(d_in, d_out, bias=True, dtype=dtype, device=device)
    with torch.no_grad():
        lin.weight.zero_()
        lin.bias.zero_()
    return lin


class LayerNormParams(nn.Module):
    """LayerNorm scale (ones) and bias (zeros)."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))


def init_layernorm(dim: int, dtype=torch.float32, device=None):
    """LayerNorm params (scale ones, bias zeros)."""
    return LayerNormParams(dim, dtype, device)


def layernorm(params: LayerNormParams, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (biased variance), cast back to x's dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params.scale + params.bias).to(x.dtype)


class MLPParams(nn.Module):
    """Ungated MLP: ``w_up`` (d_model -> d_ff) and ``w_down`` back."""

    def __init__(self, w_up: nn.Linear, w_down: nn.Linear):
        super().__init__()
        self.w_up = w_up
        self.w_down = w_down


def init_mlp(generator, d_model: int, d_ff: int, *, dtype=torch.float32,
             device=None) -> MLPParams:
    """Ungated MLP with std d_model^-1/2 in and d_ff^-1/2 out."""
    return MLPParams(
        linear(generator, d_model, d_ff, dtype, d_model ** -0.5, device),
        linear(generator, d_ff, d_model, dtype, d_ff ** -0.5, device))


def mlp(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """``gelu(x @ w_up) @ w_down`` with the tanh approximation of gelu,
    which is what ``jax.nn.gelu`` computes by default."""
    h = F.gelu(F.linear(x, params.w_up.weight), approximate="tanh")
    return F.linear(h, params.w_down.weight)
