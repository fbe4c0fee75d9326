"""The baselines the paper compares SLA2 with, on the same substrate.

* ``sla_attention``: SLA (heuristic pooled-QK Top-k router with identity
  projections), output ``O = O_s + O_l @ proj_l`` (paper Eq. 4), the
  method SLA2 improves upon;
* ``sparse_only_attention``: VSA-like block-sparse attention, the sparse
  branch alone with no linear compensation;
* ``moba_attention``: VMoBA-like mixture-of-block attention (hard top-k
  block gating renormalised over the selected blocks, which here is
  sparse-only with the heuristic router; kept apart for labelling).

All three run the dense-masked O(N^2) math of ``core/attention.py``
whatever ``impl`` a caller's SLA2 config names: their QAT quantises P per
row and V per tensor, which the per-tile kernels do not compute.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.core import attention as attn
from repro_torch.core import router as routerlib
from repro_torch.core.router import RouterConfig


@dataclasses.dataclass(frozen=True)
class SLAConfig:
    """Routing geometry (the router is not learnable) and QAT bits."""
    router: RouterConfig = RouterConfig(learnable=False)
    quant_bits: str = "none"


class SLAParams(nn.Module):
    """SLA's linear-branch projection ``proj_l`` (d, d), applied as
    ``o_l @ proj_l``: the reference's layout, not transposed."""

    def __init__(self, proj_l: torch.Tensor):
        super().__init__()
        self.proj_l = nn.Parameter(proj_l)


def init_sla_params(generator: torch.Generator, *, head_dim: int,
                    dtype=torch.float32, device=None) -> SLAParams:
    """``proj_l`` drawn N(0, (0.02/sqrt(d))^2), near zero, so training
    starts at the pure sparse branch."""
    w = torch.randn(head_dim, head_dim, generator=generator, device=device,
                    dtype=torch.float32).to(dtype)
    return SLAParams(w * (0.02 / math.sqrt(head_dim)))


def sla_attention(params: SLAParams, q, k, v, cfg: SLAConfig, *,
                  soft: bool = False, return_aux: bool = False):
    """SLA on (B, H, N, D) q/k/v: ``O_s + O_l @ proj_l`` in f32, cast to
    q's dtype; with ``return_aux`` also {"mask_c": the block mask}."""
    rcfg = cfg.router
    mask_c = routerlib.route(None, q, k, rcfg, soft=soft)
    o_s = attn.sparse_attention(
        q, k, v, mask_c, block_q=rcfg.block_q, block_k=rcfg.block_k,
        causal=rcfg.causal, soft=soft, quant_bits=cfg.quant_bits)
    o_l = attn.linear_attention(
        q, k, v, mask_c, block_q=rcfg.block_q, block_k=rcfg.block_k,
        causal=rcfg.causal, soft=soft)
    o = (o_s.to(torch.float32)
         + o_l.to(torch.float32) @ params.proj_l.to(torch.float32))
    o = o.to(q.dtype)
    return (o, {"mask_c": mask_c}) if return_aux else o


def sparse_only_attention(q, k, v, cfg: SLAConfig, *,
                          return_aux: bool = False):
    """The sparse branch alone over the heuristic router's hard mask."""
    rcfg = cfg.router
    mask_c = routerlib.route(None, q, k, rcfg, soft=False)
    o = attn.sparse_attention(
        q, k, v, mask_c, block_q=rcfg.block_q, block_k=rcfg.block_k,
        causal=rcfg.causal, quant_bits=cfg.quant_bits)
    return (o, {"mask_c": mask_c}) if return_aux else o


def moba_attention(q, k, v, cfg: SLAConfig, **kw):
    """VMoBA-like gating: ``sparse_only_attention`` under its own name."""
    return sparse_only_attention(q, k, v, cfg, **kw)
