"""SLA2 as a PyTorch module.

    O = alpha (.) O_s + (1 - alpha) (.) O_l          (Eq. 13)
    O_s = softmax(Q K^T / sqrt(d) (.) M) V
    O_l = norm(phi(Q) phi(K)^T (.) (1 - M)) V
    M   = R(Q, K)                                    (Eq. 14/16)

``alpha`` is a learnable per-(head, query-block) ratio in (0, 1), stored as
a logit.  Three interchangeable implementations:
  * impl='ref'    - dense O(N^2) oracle (tests, small models);
  * impl='gather' - plain PyTorch gathered tiles (core/block_sparse.py);
  * impl='kernel' - the CUDA sparse-branch kernels (kernels/ops.py).
``soft=True`` (stage-1 training: SoftTop-k routing) always takes the ref
path, whatever ``impl`` says.  ``sla2_mse_loss`` is the stage-1 objective.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.core import attention as attn
from repro_torch.core import router as routerlib
from repro_torch.core.router import RouterConfig


@dataclasses.dataclass(frozen=True)
class SLA2Config:
    """Routing geometry, QAT bits, alpha granularity and implementation."""
    router: RouterConfig = RouterConfig()
    quant_bits: str = "int8"        # 'none' | 'int8' | 'fp8' (QAT, fwd only)
    alpha_granularity: str = "per_block"  # 'per_block' | 'per_head' | 'scalar'
    alpha_init: float = 0.9
    impl: str = "ref"               # 'ref' | 'gather' | 'kernel'
    q_chunk: int = 32               # gather mode: query blocks per step
    fuse_branches: bool = False     # gather mode: one pass for both branches

    @property
    def block_q(self) -> int:
        """Query tile size."""
        return self.router.block_q

    @property
    def block_k(self) -> int:
        """Key/value tile size."""
        return self.router.block_k


class SLA2Params(nn.Module):
    """Per-layer SLA2 parameters: the router projections and alpha logits."""

    def __init__(self, router: Optional[routerlib.RouterParams],
                 alpha_logit: torch.Tensor):
        super().__init__()
        self.router = router
        self.alpha_logit = nn.Parameter(alpha_logit)


def init_sla2_params(generator: torch.Generator, *, head_dim: int,
                     num_heads: int, n_q_blocks: int, cfg: SLA2Config,
                     dtype=torch.float32, device=None) -> SLA2Params:
    """Router near identity and alpha logits at ``logit(alpha_init)``."""
    logit = math.log(cfg.alpha_init / (1.0 - cfg.alpha_init))
    shape = {"per_block": (num_heads, n_q_blocks),
             "per_head": (num_heads, 1), "scalar": (1, 1)}
    if cfg.alpha_granularity not in shape:
        raise ValueError(cfg.alpha_granularity)
    alpha = torch.full(shape[cfg.alpha_granularity], logit,
                       dtype=torch.float32, device=device).to(dtype)
    router = routerlib.init_router_params(generator, head_dim, cfg.router,
                                          dtype, device)
    return SLA2Params(router, alpha)


def alpha_for_blocks(params: SLA2Params, t_m: int,
                     num_heads: int) -> torch.Tensor:
    """alpha as (H, T_m) in (0, 1): broadcasts the stored granularity,
    repeats the last block for longer sequences, truncates shorter."""
    a = torch.sigmoid(params.alpha_logit.to(torch.float32))
    if a.shape[0] == 1 and num_heads > 1:
        a = a.expand(num_heads, a.shape[1])
    if a.shape[1] == 1:
        a = a.expand(num_heads, t_m)
    elif a.shape[1] < t_m:
        pad = a[:, -1:].expand(a.shape[0], t_m - a.shape[1])
        a = torch.cat([a, pad], dim=1)
    elif a.shape[1] > t_m:
        a = a[:, :t_m]
    return a


def _expand_alpha(a_blocks: torch.Tensor, block_q: int, n: int) -> torch.Tensor:
    """(H, T_m) -> (H, N, 1) token-level alpha."""
    return torch.repeat_interleave(a_blocks, block_q, dim=-1)[..., :n, None]


def sla2_attention(params: SLA2Params, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, cfg: SLA2Config, *, soft: bool = False,
                   mask_override: Optional[torch.Tensor] = None,
                   return_aux: bool = False):
    """Apply SLA2 to (B, H, N, D) q/k/v; returns O (B, H, N, D) and, with
    ``return_aux``, a dict holding the block mask and its sparsity.  The
    kernel and gather paths route by indices and compute the dense mask
    only when ``return_aux`` asks for it; ``soft`` routes with SoftTop-k
    through the ref path."""
    b, h, n, d = q.shape
    rcfg = cfg.router
    impl = "ref" if soft else cfg.impl
    mask_c = mask_override
    if mask_c is None and (impl == "ref" or return_aux):
        mask_c = routerlib.route(params.router, q, k, rcfg, soft=soft)

    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        o, aux = kops.sla2_block_sparse(params, q, k, v, cfg)
    elif impl == "gather":
        from repro_torch.core import block_sparse
        qf, kf, vf = (x.reshape(b * h, n, x.shape[-1]) for x in (q, k, v))
        idx, valid = routerlib.route_indices(params.router, qf, kf, rcfg)
        t_m = n // rcfg.block_q
        a = _expand_alpha(alpha_for_blocks(params, t_m, h), rcfg.block_q, n)
        a_tok = a[None].expand(b, h, n, 1).reshape(b * h, n, 1)
        o = block_sparse.sla2_gather(
            a_tok, qf, kf, vf, idx, valid, block_q=rcfg.block_q,
            block_k=rcfg.block_k, causal=rcfg.causal,
            quant_bits=cfg.quant_bits, prefix_len=rcfg.prefix_len,
            q_chunk=cfg.q_chunk, fuse_branches=cfg.fuse_branches)
        o = o.reshape(b, h, n, vf.shape[-1])
        aux = {"idx": idx, "valid": valid}
    elif impl == "ref":
        o = _sla2_ref(params, q, k, v, mask_c, cfg, soft)
        aux = {}
    else:
        raise ValueError(f"unknown impl {cfg.impl!r}")
    if return_aux:
        from repro_torch.core import masks as masklib
        allowed, _ = routerlib._allowed_and_forced(
            mask_c.shape[-2], mask_c.shape[-1], rcfg, device=mask_c.device)
        aux = dict(aux)
        aux["mask_c"] = mask_c
        aux["sparsity"] = masklib.mask_sparsity(
            (mask_c > 0.5).to(torch.float32), allowed)
        return o, aux
    return o


def _sla2_ref(params, q, k, v, mask_c, cfg: SLA2Config, soft: bool):
    b, h, n, d = q.shape
    rcfg = cfg.router
    o_s = attn.sparse_attention(
        q, k, v, mask_c, block_q=rcfg.block_q, block_k=rcfg.block_k,
        causal=rcfg.causal, soft=soft, quant_bits=cfg.quant_bits,
        prefix_len=rcfg.prefix_len)
    o_l = attn.linear_attention(
        q, k, v, mask_c, block_q=rcfg.block_q, block_k=rcfg.block_k,
        causal=rcfg.causal, soft=soft, prefix_len=rcfg.prefix_len)
    t_m = n // rcfg.block_q
    a = _expand_alpha(alpha_for_blocks(params, t_m, h), rcfg.block_q, n)
    # an empty routed complement makes the row fully sparse: alpha = 1
    comp = 1.0 - mask_c.to(torch.float32)
    if rcfg.causal:
        n_full = (torch.arange(t_m, device=q.device) * rcfg.block_q
                  + 1) // rcfg.block_k
        if rcfg.prefix_len:
            n_full = torch.clamp(n_full, min=rcfg.prefix_len // rcfg.block_k)
        fully = (torch.arange(mask_c.shape[-1], device=q.device)[None, :]
                 < n_full[:, None])
        comp = comp * fully.to(comp.dtype)
    nonempty = comp.sum(-1) > 1e-6
    nonempty = torch.repeat_interleave(nonempty, rcfg.block_q, dim=-1)[..., None]
    a = torch.where(nonempty, a, 1.0)
    return (a * o_s.to(torch.float32)
            + (1.0 - a) * o_l.to(torch.float32)).to(q.dtype)


def sla2_mse_loss(params: SLA2Params, q, k, v, cfg: SLA2Config, *,
                  soft: bool = True,
                  causal: Optional[bool] = None) -> torch.Tensor:
    """Stage-1 objective (Algorithm 1, line 3):
    L = MSE(FullAttn(Q, K, V), SLA2(Q, K, V, k%, R, alpha))."""
    causal = cfg.router.causal if causal is None else causal
    target = attn.full_attention(q, k, v, causal=causal,
                                 prefix_len=cfg.router.prefix_len)
    pred = sla2_attention(params, q, k, v, cfg, soft=soft)
    return torch.mean((pred.to(torch.float32)
                       - target.to(torch.float32)) ** 2)
