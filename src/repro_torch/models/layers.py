"""Shared model layers: truncated-normal init, LayerNorm and RMSNorm, RoPE,
the MLPs (ungated GELU for the DiT, gated SiLU for the LM), embeddings.

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


class RMSNormParams(nn.Module):
    """RMSNorm scale (ones)."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))


def init_rmsnorm(dim: int, dtype=torch.float32, device=None):
    """RMSNorm params (scale ones)."""
    return RMSNormParams(dim, dtype, device)


def rmsnorm(params: RMSNormParams, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in f32, cast back to x's
    dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params.scale.to(torch.float32)).to(x.dtype)


_ROPE_INV: dict = {}


def _rope_inv(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """1 / theta^(2i / head_dim) in f32, made once per device (a scalar
    base, so no host-to-device copy stalls the stream)."""
    key = (head_dim, theta, str(device))
    if key not in _ROPE_INV:
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
        _ROPE_INV[key] = 1.0 / torch.pow(theta, exps)
    return _ROPE_INV[key]


def rope_frequencies(head_dim: int, max_pos: int, theta: float = 10000.0,
                     device=None):
    """(max_pos, head_dim / 2) cos and sin tables."""
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, _rope_inv(head_dim, theta, device))
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate interleaved pairs (x[2i], x[2i+1]).  x is (..., N, H, Dh) or
    (..., N, Dh); positions (..., N) integers."""
    dh = x.shape[-1]
    inv = _rope_inv(dh, theta, x.device)
    ang = positions.to(torch.float32)[..., None] * inv       # (..., N, Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == positions.dim() + 2:                      # head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1 = x[..., ::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    y = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.reshape(x.shape).to(x.dtype)


class GatedMLPParams(nn.Module):
    """Gated MLP: ``w_gate`` and ``w_up`` (d_model -> d_ff), ``w_down``."""

    def __init__(self, w_up: nn.Linear, w_down: nn.Linear,
                 w_gate: nn.Linear):
        super().__init__()
        self.w_up = w_up
        self.w_down = w_down
        self.w_gate = w_gate


def init_gated_mlp(generator, d_model: int, d_ff: int, *,
                   dtype=torch.float32, device=None) -> GatedMLPParams:
    """Gated MLP with std d_model^-1/2 in and d_ff^-1/2 out."""
    return GatedMLPParams(
        linear(generator, d_model, d_ff, dtype, d_model ** -0.5, device),
        linear(generator, d_ff, d_model, dtype, d_ff ** -0.5, device),
        linear(generator, d_model, d_ff, dtype, d_model ** -0.5, device))


def gated_mlp(params: GatedMLPParams, x: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down``."""
    up = F.linear(x, params.w_up.weight)
    up = F.silu(F.linear(x, params.w_gate.weight)) * up
    return F.linear(up, params.w_down.weight)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the (vocab, d_model) table."""
    return table[ids.long()]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding in f32: ``x @ table^T``."""
    return torch.matmul(x.to(torch.float32), table.to(torch.float32).T)
