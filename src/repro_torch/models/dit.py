"""Wan2.1-style video Diffusion Transformer: the paper's target model.

Block = adaLN-zero(self-attn) + cross-attn(text) + adaLN-zero(MLP), looped
over an ``nn.ModuleList`` of layers.  Self-attention is bidirectional SLA2
(causal=False).  Latents arrive pre-patchified as (B, N, c_latent); text
conditioning is a (B, n_text, d_model) embedding.

Serving (serve/diffusion.DiffusionEngine) precomputes two per-request
constants once at admission: ``precompute_text_kv`` (every layer's text
cross-attention K/V) and ``precompute_step_mods`` (the adaLN modulation
table over the request's whole timestep schedule).  ``dit_forward`` and
``denoise_step`` take them by keyword; ``None`` recomputes in-step with the
same ops, so cached and uncached outputs are bitwise equal.

Training objective: rectified-flow matching (``flow_matching_loss``),
    x_t = (1 - t) x0 + t eps,  target v = eps - x0,  L = mean (v_hat - v)^2.
With ``remat == "full"`` and grad enabled, every block runs under
``torch.utils.checkpoint``: only its input is kept, and the backward
re-runs the block's forward (so the sparse-branch forward kernel runs
twice per layer and step, as under ``jax.checkpoint``).

The ``sla`` / ``sparse_only`` mechanisms wait for ``core/sla.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import sla2 as sla2lib
from repro_torch.core.router import RouterConfig
from repro_torch.core.sla2 import SLA2Config
from repro_torch.models import layers as L

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Video DiT geometry plus the SLA2 routing/impl knobs.  ``mechanism``
    picks the self-attention math (see MECHANISM_ATTENTION); ``sla2_impl``
    the SLA2 implementation ('kernel' = the CUDA sparse-branch kernel,
    'gather' = plain PyTorch gathered tiles, 'ref' = the O(N^2) oracle)."""
    name: str = "wan_dit"
    n_layers: int = 30
    d_model: int = 1536
    num_heads: int = 12
    head_dim: int = 128
    d_ff: int = 8960
    c_latent: int = 16
    n_text: int = 77
    mechanism: str = "sla2"         # sla2 | full
    block_q: int = 128
    block_k: int = 64
    k_frac: float = 0.05
    quant_bits: str = "int8"
    sla2_impl: str = "gather"
    q_chunk: int = 16
    t_emb_dim: int = 256
    remat: str = "full"             # full | none (training only)
    dtype: str = "bfloat16"
    max_target_len: int = 32768

    @property
    def param_dtype(self) -> torch.dtype:
        """Parameter/activation dtype as a torch dtype."""
        return _DTYPES[self.dtype]

    def router_config(self) -> RouterConfig:
        """Bidirectional routing geometry (video tokens)."""
        return RouterConfig(block_q=self.block_q, block_k=self.block_k,
                            k_frac=self.k_frac, causal=False)

    def sla2_config(self) -> SLA2Config:
        """SLA2Config carrying this model's routing, impl and QAT bits."""
        return SLA2Config(router=self.router_config(),
                          quant_bits=self.quant_bits, impl=self.sla2_impl,
                          q_chunk=self.q_chunk)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class DiTBlock(nn.Module):
    """One transformer block's parameters."""

    def __init__(self, g: torch.Generator, cfg: DiTConfig, device=None):
        super().__init__()
        d, h, dh, dt = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.param_dtype
        std, std_o = d ** -0.5, (h * dh) ** -0.5
        self.ln1 = L.init_layernorm(d, dt, device)
        self.wq = L.linear(g, d, h * dh, dt, std, device)
        self.wk = L.linear(g, d, h * dh, dt, std, device)
        self.wv = L.linear(g, d, h * dh, dt, std, device)
        self.wo = L.linear(g, h * dh, d, dt, std_o, device)
        self.ln_x = L.init_layernorm(d, dt, device)
        self.xq = L.linear(g, d, h * dh, dt, std, device)
        self.xk = L.linear(g, d, h * dh, dt, std, device)
        self.xv = L.linear(g, d, h * dh, dt, std, device)
        self.xo = L.linear(g, h * dh, d, dt, std_o, device)
        self.ln2 = L.init_layernorm(d, dt, device)
        self.mlp = L.init_mlp(g, d, cfg.d_ff, dtype=dt, device=device)
        # adaLN-zero: 6 modulation vectors from the t-embedding, zero init
        self.ada = L.zero_linear(cfg.t_emb_dim, 6 * d, dt, device)
        self.sla2 = None
        if cfg.mechanism == "sla2":
            self.sla2 = sla2lib.init_sla2_params(
                g, head_dim=dh, num_heads=h,
                n_q_blocks=max(1, cfg.max_target_len // cfg.block_q),
                cfg=cfg.sla2_config(), dtype=dt, device=device)


class DiTParams(nn.Module):
    """All DiT parameters; ``blocks`` is an ``nn.ModuleList`` of DiTBlock."""

    def __init__(self, g: torch.Generator, cfg: DiTConfig, device=None):
        super().__init__()
        d, dt, e = cfg.d_model, cfg.param_dtype, cfg.t_emb_dim
        self.blocks = nn.ModuleList(DiTBlock(g, cfg, device)
                                    for _ in range(cfg.n_layers))
        self.patch_in = L.linear(g, cfg.c_latent, d, dt,
                                 cfg.c_latent ** -0.5, device, bias=True)
        self.t_mlp_w1 = L.linear(g, e, e, dt, e ** -0.5, device)
        self.t_mlp_w2 = L.linear(g, e, e, dt, e ** -0.5, device)
        self.final_ln = L.init_layernorm(d, dt, device)
        self.final_ada = L.zero_linear(e, 2 * d, dt, device)
        self.patch_out = L.zero_linear(d, cfg.c_latent, dt, device)


def init_dit(generator: torch.Generator, cfg: DiTConfig,
             device=None) -> DiTParams:
    """Init the DiT parameters with the reference's distributions and
    zeros (adaLN ``ada``, ``final_ada`` and ``patch_out`` start at 0)."""
    with torch.no_grad():
        return DiTParams(generator, cfg, device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of t in [0, 1]: (B,) -> (B, dim) f32."""
    half = dim // 2
    log10k = torch.log(torch.tensor(10000.0, device=t.device))
    freqs = torch.exp(-log10k * torch.arange(half, device=t.device,
                                             dtype=torch.float32) / half)
    ang = t[:, None].to(torch.float32) * freqs[None] * 1000.0
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _attn_sla2(bp: DiTBlock, cfg: DiTConfig, q, k, v):
    """SLA2, re-routed from this step's Q/K (cfg.sla2_impl picks the path)."""
    return sla2lib.sla2_attention(bp.sla2, q, k, v, cfg.sla2_config())


def _attn_full(bp: DiTBlock, cfg: DiTConfig, q, k, v):
    """Dense bidirectional softmax attention (the O(N^2) baseline)."""
    s = torch.einsum("bhnd,bhmd->bhnm", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p,
                        v.to(torch.float32)).to(q.dtype)


# mechanism -> self-attention math over (B, H, N, Dh) q/k/v
MECHANISM_ATTENTION = {"sla2": _attn_sla2, "full": _attn_full}


def _heads(x, w, h, dh):
    b, n, _ = x.shape
    return F.linear(x, w).reshape(b, n, h, dh).transpose(1, 2)


def _self_attention(bp: DiTBlock, cfg: DiTConfig, x):
    b, n, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    q = _heads(x, bp.wq.weight, h, dh)
    k = _heads(x, bp.wk.weight, h, dh)
    v = _heads(x, bp.wv.weight, h, dh)
    o = MECHANISM_ATTENTION[cfg.mechanism](bp, cfg, q, k, v)
    return F.linear(o.transpose(1, 2).reshape(b, n, h * dh), bp.wo.weight)


def _text_kv(bp: DiTBlock, cfg: DiTConfig, text):
    return (_heads(text, bp.xk.weight, cfg.num_heads, cfg.head_dim),
            _heads(text, bp.xv.weight, cfg.num_heads, cfg.head_dim))


def _cross_attention(bp: DiTBlock, cfg: DiTConfig, x, text,
                     kv: Optional[tuple] = None):
    """Dense cross-attention to the text; ``kv`` is an optional precomputed
    (k, v) pair, each (B, H, n_text, Dh)."""
    b, n, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    q = _heads(x, bp.xq.weight, h, dh)
    k, v = _text_kv(bp, cfg, text) if kv is None else kv
    s = torch.einsum("bhnd,bhmd->bhnm", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(dh)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhnm,bhmd->bhnd", p, v.to(torch.float32))
    o = o.to(x.dtype).transpose(1, 2).reshape(b, n, h * dh)
    return F.linear(o, bp.xo.weight)


def _t_emb(params: DiTParams, cfg: DiTConfig, t):
    e = timestep_embedding(t, cfg.t_emb_dim)
    e = F.silu(F.linear(e, params.t_mlp_w1.weight.to(torch.float32)))
    return F.linear(e, params.t_mlp_w2.weight.to(torch.float32))


def _ada(lin: nn.Linear, t_emb):
    return (F.linear(t_emb, lin.weight.to(torch.float32))
            + lin.bias.to(torch.float32))


# ---------------------------------------------------------------------------
# per-request constants (serving)
# ---------------------------------------------------------------------------

def precompute_text_kv(params: DiTParams, cfg: DiTConfig, text):
    """Every layer's cross-attention K/V of the text: (B, n_text, d_model)
    -> (k, v), each (n_layers, B, H, n_text, Dh), with the in-step ops."""
    text = text.to(cfg.param_dtype)
    kvs = [_text_kv(bp, cfg, text) for bp in params.blocks]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def precompute_step_mods(params: DiTParams, cfg: DiTConfig, t):
    """adaLN-zero modulation tables for a timestep schedule t (S,):
    {"blocks": (n_layers, S, 6*d_model), "final": (S, 2*d_model)}, f32."""
    t_emb = _t_emb(params, cfg, t)
    return {"blocks": torch.stack([_ada(bp.ada, t_emb)
                                   for bp in params.blocks]),
            "final": _ada(params.final_ada, t_emb)}


def _block_forward(bp: DiTBlock, cfg: DiTConfig, x, text, t_emb,
                   kv: Optional[tuple] = None, mod=None):
    if mod is None:
        mod = _ada(bp.ada, t_emb)
    sh1, sc1, g1, sh2, sc2, g2 = mod.to(x.dtype).chunk(6, dim=-1)
    h = _modulate(L.layernorm(bp.ln1, x), sh1, sc1)
    x = x + g1[:, None, :] * _self_attention(bp, cfg, h)
    x = x + _cross_attention(bp, cfg, L.layernorm(bp.ln_x, x), text, kv)
    h2 = _modulate(L.layernorm(bp.ln2, x), sh2, sc2)
    return x + g2[:, None, :] * L.mlp(bp.mlp, h2)


def dit_forward(params: DiTParams, cfg: DiTConfig, latents, text, t, *,
                text_kv: Optional[tuple] = None, mods: Optional[dict] = None):
    """latents (B, N, c_latent), text (B, n_text, d_model), t (B,) ->
    predicted velocity (B, N, c_latent) f32.  ``text_kv`` comes from
    ``precompute_text_kv``; ``mods`` holds this step's rows,
    {"blocks": (n_layers, B, 6*d_model), "final": (B, 2*d_model)}; with
    both set, ``text`` and ``t`` may be None."""
    x = (F.linear(latents.to(cfg.param_dtype), params.patch_in.weight)
         + params.patch_in.bias)
    t_emb = _t_emb(params, cfg, t) if mods is None else None
    if text is not None:
        text = text.to(cfg.param_dtype)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for li, bp in enumerate(params.blocks):
        kv = None if text_kv is None else (text_kv[0][li], text_kv[1][li])
        mod = None if mods is None else mods["blocks"][li]
        if remat:
            x = checkpoint(_block_forward, bp, cfg, x, text, t_emb, kv, mod,
                           use_reentrant=False)
        else:
            x = _block_forward(bp, cfg, x, text, t_emb, kv=kv, mod=mod)
    mod = _ada(params.final_ada, t_emb) if mods is None else mods["final"]
    sh, sc = mod.to(x.dtype).chunk(2, dim=-1)
    x = _modulate(L.layernorm(params.final_ln, x), sh, sc)
    return (F.linear(x, params.patch_out.weight)
            + params.patch_out.bias).to(torch.float32)


def flow_matching_loss(params: DiTParams, cfg: DiTConfig, batch: dict):
    """batch: latents x0 (B, N, c), text (B, n_text, d), noise eps
    (B, N, c), time t (B,) in (0, 1).  Returns (loss, {"mse": loss})."""
    x0 = batch["latents"].to(torch.float32)
    eps = batch["noise"].to(torch.float32)
    t = batch["time"].to(torch.float32)
    x_t = (1.0 - t[:, None, None]) * x0 + t[:, None, None] * eps
    v_hat = dit_forward(params, cfg, x_t, batch["text"], t)
    loss = torch.mean((v_hat - (eps - x0)) ** 2)
    return loss, {"mse": loss}


def denoise_step(params: DiTParams, cfg: DiTConfig, x_t, text, t, dt, *,
                 text_kv: Optional[tuple] = None, mods: Optional[dict] = None):
    """One Euler step of the rectified-flow ODE; dt (B,) per-request step."""
    v = dit_forward(params, cfg, x_t, text, t, text_kv=text_kv, mods=mods)
    return x_t - dt[:, None, None] * v
