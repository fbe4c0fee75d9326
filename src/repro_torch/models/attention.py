"""Model-level attention of the LM: projections with qk-norm and RoPE,
GQA, the mechanism dispatch, the static decode cache, and paged serving
(the page pool, chunked prefill, single-token decode and the speculative
verify window with its commit and linear drafting).

Mechanisms: ``full`` (dense softmax), ``sla2`` (the paper's operator,
``core/sla2.py``), ``sla`` (the SLA baseline, ``O_s + O_l @ proj_l``) and
``sparse_only`` (the sparse branch alone), the last two from
``core/sla.py``.  ``attention_forward`` is the full-sequence path
(training, static prefill): K/V are repeated to the query heads before
the operator.  The static cache (``init_cache`` / ``prefill_cache`` /
``decode_step``) keeps one shared length, a host int, for the whole
batch; an SLA2 layer adds the pooled router key of every block and the
linear totals over complete blocks, and its decode routes once per KV
head (``_sla2_decode``).

The K/V cache lives in a pool of physical pages of ``block_k`` tokens
(``init_paged_cache``); a host-side page table maps (slot, logical block)
to a page, and page 0 is a trash page that takes masked writes.  For SLA2
the pool also keeps one pooled router key per page and per-slot linear
totals (``h_tot``, ``z_tot``) over the slot's complete blocks.  Every
function here updates the cache in place and returns it.

Prefill is exact attention of the chunk over the slot's paged history.
SLA2 decode routes each (slot, KV head) to its K_sel best pages and runs
the sparse branch over the routed pages, the linear complement from the
totals and the alpha combine; ``mechanism="full"`` decodes densely over
every page a row can see.  ``paged_impl`` picks the path: 'fused' runs
the CUDA kernels of ``kernels/sla2_decode_paged`` (their plain versions
on a CPU tensor), 'gather' the reference that gathers pages into
contiguous copies (the parity oracle), 'auto' fused on a CUDA tensor and
gather on the CPU.

Speculative decoding verifies a window of W tokens per slot in one pass
(``decode_window_paged``): it writes the window's K/V but commits no SLA2
block state, which ``commit_paged_window`` folds in for the accepted
prefix only.  ``linear_draft_state`` / ``linear_draft_attention`` draft
through the linear branch alone, from a state that never enters the cache.

The paged pool of an 'sla' or 'sparse_only' layer is the dense one, and
it serves through the dense entries (``PAGED_DISPATCH``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import masks as masklib
from repro_torch.core import sla as slalib
from repro_torch.core import sla2 as sla2lib
from repro_torch.core.attention import phi
from repro_torch.core.quant import true_div
from repro_torch.core.router import RouterConfig
from repro_torch.core.sla2 import SLA2Config
from repro_torch.kernels import ops
from repro_torch.kernels import sla2_decode_paged as KP
from repro_torch.models import layers as L

PORTED_MECHANISMS = ("full", "sla2", "sla", "sparse_only")


def _check_mechanism(cfg) -> None:
    if cfg.mechanism not in PORTED_MECHANISMS:
        raise ValueError(f"unknown mechanism {cfg.mechanism!r}; one of "
                         f"{PORTED_MECHANISMS}")


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    """Per-layer attention hyperparameters: projection geometry, masks, the
    SLA2 router / QAT knobs and the paged-serving switches."""
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    mechanism: str = "full"            # full | sla2 | sla | sparse_only
    causal: bool = True
    prefix_len: int = 0
    sliding_window: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    block_q: int = 128
    block_k: int = 64
    k_frac: float = 0.05
    quant_bits: str = "int8"           # QAT of the full-sequence forward
    sla2_impl: str = "kernel"          # kernel | gather | ref
    n_q_blocks: int = 32               # alpha table size at init
    paged_impl: str = "auto"           # fused | gather | auto
    decode_quant_bits: str = "none"    # QAT tiles of the decode kernel
    kv_quant: str = "none"             # page-pool storage: none|int8|fp8

    def router_config(self) -> RouterConfig:
        """The router view: block sizes, top-k fraction, masks."""
        return RouterConfig(
            block_q=self.block_q, block_k=self.block_k, k_frac=self.k_frac,
            causal=self.causal, prefix_len=self.prefix_len,
            sliding_window=self.sliding_window)

    def sla2_config(self) -> SLA2Config:
        """The core SLA2 config view (router, QAT bits, impl); chunking and
        branch fusion keep SLA2Config's defaults, as in the reference."""
        return SLA2Config(router=self.router_config(),
                          quant_bits=self.quant_bits, impl=self.sla2_impl)


class AttentionParams(nn.Module):
    """Projections (``nn.Linear``, weight (out, in)), qk-norms, the SLA2
    router and alpha table (``mechanism="sla2"``) and the SLA baseline's
    ``proj_l`` (``mechanism="sla"``); None where the mechanism has none."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None, sla2=None,
                 sla=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.q_norm, self.k_norm = q_norm, k_norm
        self.sla2 = sla2
        self.sla = sla


def init_attention(generator: torch.Generator, cfg: AttentionConfig,
                   dtype=torch.float32, device=None) -> AttentionParams:
    """One attention layer's params: QKV/output projections, the optional
    qk-norms and the mechanism's own (SLA2: router and alpha table; SLA:
    the linear branch's output projection)."""
    _check_mechanism(cfg)
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    std = d ** -0.5
    lin = lambda i, o, s: L.linear(generator, i, o, dtype, s, device)
    p = AttentionParams(lin(d, h * dh, std), lin(d, hkv * dh, std),
                        lin(d, hkv * dh, std),
                        lin(h * dh, d, (h * dh) ** -0.5))
    if cfg.qk_norm:
        p.q_norm = L.init_rmsnorm(dh, dtype, device)
        p.k_norm = L.init_rmsnorm(dh, dtype, device)
    if cfg.mechanism == "sla2":
        p.sla2 = sla2lib.init_sla2_params(
            generator, head_dim=dh, num_heads=h, n_q_blocks=cfg.n_q_blocks,
            cfg=cfg.sla2_config(), dtype=dtype, device=device)
    elif cfg.mechanism == "sla":
        p.sla = slalib.init_sla_params(generator, head_dim=dh, dtype=dtype,
                                       device=device)
    return p


def _project_qkv(params: AttentionParams, cfg: AttentionConfig, x,
                 positions):
    b, n, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = F.linear(x, params.wq.weight).reshape(b, n, h, dh)
    k = F.linear(x, params.wk.weight).reshape(b, n, hkv, dh)
    v = F.linear(x, params.wv.weight).reshape(b, n, hkv, dh)
    if cfg.qk_norm:
        q = L.rmsnorm(params.q_norm, q)
        k = L.rmsnorm(params.k_norm, k)
    q = L.apply_rope(q, positions, theta=cfg.rope_theta)
    k = L.apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _repeat_kv(x, n_rep: int):
    return x if n_rep == 1 else torch.repeat_interleave(x, n_rep, dim=1)


# ---------------------------------------------------------------------------
# Full-sequence attention
# ---------------------------------------------------------------------------

def _dense_masked_attention(q, k, v, cfg: AttentionConfig):
    """Dense attention with causal / prefix-LM / sliding-window masks over
    (B, H, N, D) q/k/v, in f32, cast to q's dtype."""
    s = torch.einsum("bhnd,bhmd->bhnm", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(q.shape[-1])
    n_q, n_kv = q.shape[-2], k.shape[-2]
    mask = None
    if cfg.causal:
        mask = masklib.token_causal_mask(n_q, n_kv, 0, cfg.prefix_len,
                                         device=q.device)
    if cfg.sliding_window is not None:
        qi = torch.arange(n_q, device=q.device)
        kj = torch.arange(n_kv, device=q.device)
        sw = kj[None, :] >= (qi[:, None] - cfg.sliding_window + 1)
        if cfg.prefix_len:
            sw = sw | (kj[None, :] < cfg.prefix_len)
        mask = sw if mask is None else (mask & sw)
    if mask is not None:
        s = torch.where(mask, s, masklib.NEG_INF)
    p = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("bhnm,bhmd->bhnd", p,
                        v.to(torch.float32)).to(q.dtype)


def _baseline_config(cfg: AttentionConfig) -> slalib.SLAConfig:
    """The SLA baselines' config: the heuristic router, QAT bits of
    ``sparse_only`` (``sla`` runs without QAT, as in the reference)."""
    bits = cfg.quant_bits if cfg.mechanism == "sparse_only" else "none"
    return slalib.SLAConfig(router=dataclasses.replace(
        cfg.router_config(), learnable=False), quant_bits=bits)


def _attend(params: AttentionParams, cfg: AttentionConfig, q, k, v):
    """The mechanism over projected (B, N, H|Hkv, Dh) q/k/v: K/V repeated
    to the query heads, then (B, N, H * Dh) through ``wo``."""
    b, n = q.shape[:2]
    n_rep = cfg.num_heads // cfg.num_kv_heads
    q = q.transpose(1, 2)
    k = _repeat_kv(k.transpose(1, 2), n_rep)
    v = _repeat_kv(v.transpose(1, 2), n_rep)
    if cfg.mechanism == "full":
        o = _dense_masked_attention(q, k, v, cfg)
    elif cfg.mechanism == "sla2":
        o = sla2lib.sla2_attention(params.sla2, q, k, v, cfg.sla2_config())
    elif cfg.mechanism == "sla":
        o = slalib.sla_attention(params.sla, q, k, v, _baseline_config(cfg))
    elif cfg.mechanism == "sparse_only":
        o = slalib.sparse_only_attention(q, k, v, _baseline_config(cfg))
    else:
        raise ValueError(f"unknown mechanism {cfg.mechanism!r}")
    return F.linear(o.transpose(1, 2).reshape(b, n, -1), params.wo.weight)


def _positions(b: int, n: int, start: int, device) -> torch.Tensor:
    return (torch.arange(n, device=device) + start)[None].expand(b, n)


def attention_forward(params: AttentionParams, cfg: AttentionConfig, x,
                      positions=None):
    """Training / prefill full-sequence attention; x (B, N, d_model),
    positions (B, N) (default 0..N-1)."""
    b, n, _ = x.shape
    if positions is None:
        positions = _positions(b, n, 0, x.device)
    q, k, v = _project_qkv(params, cfg, x, positions)
    return _attend(params, cfg, q, k, v)


# ---------------------------------------------------------------------------
# The static decode cache
# ---------------------------------------------------------------------------

def init_cache(cfg: AttentionConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Block K/V cache of one layer, (B, Hkv, max_len, Dh) each, with the
    shared ``length`` (a host int); SLA2 adds the pooled router key of
    every block and the linear totals over complete blocks (the routed
    blocks' own states are recomputed from the tiles the sparse branch
    reads); its ``max_len`` must be a multiple of ``block_k``."""
    _check_mechanism(cfg)
    hkv, dh, bk = cfg.num_kv_heads, cfg.head_dim, cfg.block_k
    if cfg.mechanism == "sla2" and max_len % bk:
        raise ValueError(f"max_len {max_len} is not a multiple of "
                         f"block_k {bk}")
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    cache = {"k": z((batch, hkv, max_len, dh), dtype),
             "v": z((batch, hkv, max_len, dh), dtype), "length": 0}
    if cfg.mechanism == "sla2":
        cache.update(pooled_k=z((batch, hkv, max_len // bk, dh),
                                torch.float32),
                     h_tot=z((batch, hkv, dh, dh), torch.float32),
                     z_tot=z((batch, hkv, dh), torch.float32))
    return cache


def prefill_cache(params: AttentionParams, cfg: AttentionConfig, x,
                  cache: dict):
    """Full-sequence attention over x (B, N, d_model) that also fills the
    cache with its K/V (and the SLA2 block states; there N must be a
    multiple of block_k).  Returns (out (B, N, d_model), cache), updated
    in place."""
    b, n, _ = x.shape
    if (cfg.mechanism == "sla2" and n % cfg.block_k) \
            or n > cache["k"].shape[2]:
        raise ValueError(f"prefill of {n} tokens does not fit the cache "
                         f"(blocks of {cfg.block_k}, "
                         f"{cache['k'].shape[2]} positions)")
    q, k, v = _project_qkv(params, cfg, x, _positions(b, n, 0, x.device))
    out = _attend(params, cfg, q, k, v)
    k_t, v_t = k.transpose(1, 2), v.transpose(1, 2)     # (B, Hkv, N, Dh)
    cache["k"][:, :, :n] = k_t.to(cache["k"].dtype)
    cache["v"][:, :, :n] = v_t.to(cache["v"].dtype)
    cache["length"] = n
    if cfg.mechanism == "sla2":
        bk, hkv, dh = cfg.block_k, cfg.num_kv_heads, cfg.head_dim
        kb = k_t.reshape(b, hkv, n // bk, bk, dh)
        vb = v_t.reshape(b, hkv, n // bk, bk, dh)
        kf = phi(kb)
        h = torch.einsum("bhjkd,bhjke->bhjde", kf, vb.to(torch.float32))
        cache["pooled_k"][:, :, :n // bk] = kb.to(torch.float32).mean(dim=-2)
        cache["h_tot"] = h.sum(dim=2)
        cache["z_tot"] = kf.sum(dim=-2).sum(dim=2)
    return out, cache


def decode_step(params: AttentionParams, cfg: AttentionConfig, x_t,
                cache: dict):
    """One-token decode for the whole batch at the shared length;
    x_t (B, 1, d_model).  Returns (out (B, 1, d_model), cache), updated
    in place."""
    b = x_t.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t = int(cache["length"])
    max_len = cache["k"].shape[2]
    if t >= max_len:
        raise ValueError(f"the static cache is full ({max_len} positions)")
    q, k_new, v_new = _project_qkv(params, cfg, x_t,
                                   _positions(b, 1, t, x_t.device))
    q = q.transpose(1, 2)                              # (B, H, 1, Dh)
    cache["k"][:, :, t] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, :, t] = v_new[:, 0].to(cache["v"].dtype)
    t_new = t + 1
    cache["length"] = t_new
    if cfg.mechanism == "sla2":
        o = _sla2_decode(params, cfg, q, cache, t_new)
    else:
        n_rep = h // hkv
        k_all = _repeat_kv(cache["k"], n_rep).to(q.dtype)
        v_all = _repeat_kv(cache["v"], n_rep).to(q.dtype)
        s = torch.einsum("bhqd,bhmd->bhqm", q.to(torch.float32),
                         k_all.to(torch.float32)) / math.sqrt(dh)
        pos_k = torch.arange(max_len, device=q.device)
        vis = pos_k < t_new
        if cfg.sliding_window is not None:
            sw = pos_k >= (t_new - cfg.sliding_window)
            if cfg.prefix_len:
                sw = sw | (pos_k < cfg.prefix_len)
            vis = vis & sw
        s = torch.where(vis, s, masklib.NEG_INF)
        o = torch.einsum("bhqm,bhmd->bhqd", torch.softmax(s, dim=-1),
                         v_all.to(torch.float32))
    o = o.to(x_t.dtype).transpose(1, 2).reshape(b, 1, h * dh)
    return F.linear(o, params.wo.weight), cache


def _sla2_decode(params: AttentionParams, cfg: AttentionConfig, q, cache,
                 t_new: int):
    """SLA2 decode over the static cache: the stats of the block holding
    the new token, group-shared routing (one block set per KV head from
    the mean of its query heads' scores over the pooled keys; the current
    block forced), the sparse branch over the K_sel routed blocks and the
    linear complement from the totals minus the routed complete blocks.
    q (B, H, 1, Dh) -> (B, H, 1, Dh) f32."""
    sp = params.sla2
    b, h, _, dh = q.shape
    hkv, bk = cfg.num_kv_heads, cfg.block_k
    n_rep = h // hkv
    t_n = cache["k"].shape[2] // bk
    sq = math.sqrt(dh)

    # the block holding the new token: its pooled key, and its linear
    # state into the totals once it is complete
    cur = (t_new - 1) // bk
    kblk = cache["k"][:, :, cur * bk:(cur + 1) * bk].to(torch.float32)
    vblk = cache["v"][:, :, cur * bk:(cur + 1) * bk].to(torch.float32)
    w = ((cur * bk + torch.arange(bk, device=q.device)) < t_new).to(
        torch.float32)[None, None, :, None]
    cache["pooled_k"][:, :, cur] = ((kblk * w).sum(dim=-2)
                                    / torch.clamp(w.sum(dim=-2), min=1.0))
    completed = t_new % bk == 0
    if completed:
        kf_cur = phi(kblk) * w
        cache["h_tot"] = cache["h_tot"] + torch.einsum(
            "bhkd,bhke->bhde", kf_cur, vblk * w)
        cache["z_tot"] = cache["z_tot"] + kf_cur.sum(dim=-2)

    # group-shared routing: one block set per KV head
    qr = q[:, :, 0].to(torch.float32)                  # (B, H, Dh)
    pk = cache["pooled_k"].to(torch.float32)           # (B, Hkv, T_n, Dh)
    if sp.router is not None:
        qr = qr @ sp.router.proj_q.weight.to(torch.float32).T
        pk = pk @ sp.router.proj_k.weight.to(torch.float32).T
    qr_g = qr.reshape(b, hkv, n_rep, dh).mean(dim=2)
    scores = torch.einsum("bhd,bhtd->bht", qr_g, pk) / sq
    blk = torch.arange(t_n, device=q.device)
    scores = torch.where(blk <= cur, scores, masklib.NEG_INF)
    scores = torch.where(blk == cur, float("inf"), scores)
    k_sel = max(1, round(cfg.k_frac * t_n))
    top_vals, idx = torch.topk(scores, k_sel, dim=-1)  # (B, Hkv, K_sel)
    valid = top_vals > masklib.NEG_INF * 0.5

    # sparse branch over the routed blocks, at KV-head width
    gather = lambda c: torch.gather(
        c.reshape(b, hkv, t_n, bk, dh), 2,
        idx[..., None, None].expand(-1, -1, -1, bk, dh)).to(torch.float32)
    k_sel_b, v_sel_b = gather(cache["k"]), gather(cache["v"])
    q_g = q[:, :, 0].to(torch.float32).reshape(b, hkv, n_rep, dh)
    s = torch.einsum("bhgd,bhjkd->bhgjk", q_g, k_sel_b) / sq
    pos = idx[..., None] * bk + torch.arange(bk, device=q.device)
    vis = (pos < t_new) & valid[..., None]             # (B, Hkv, K_sel, bk)
    s = torch.where(vis[:, :, None], s, masklib.NEG_INF)
    p = torch.softmax(s.reshape(b, hkv, n_rep, -1), dim=-1).reshape(s.shape)
    o_s = torch.einsum("bhgjk,bhjkd->bhgd", p, v_sel_b)

    # linear branch: the totals minus the routed complete blocks
    sel_complete = valid & (idx < cur + int(completed))
    qfeat = phi(q[:, :, 0]).reshape(b, hkv, n_rep, dh)
    ls = torch.einsum("bhgd,bhjkd->bhgjk", qfeat, phi(k_sel_b))
    ls = ls * sel_complete[:, :, None, :, None].to(torch.float32)
    sub_num = torch.einsum("bhgjk,bhjkd->bhgd", ls, v_sel_b)
    den_tot = torch.einsum("bhgd,bhd->bhg", qfeat, cache["z_tot"])
    num = torch.einsum("bhgd,bhde->bhge", qfeat, cache["h_tot"]) - sub_num
    den = den_tot - ls.sum(dim=(-1, -2))
    den = torch.where(den > 1e-4 * den_tot + 1e-12, den, 0.0)[..., None]
    o_l = torch.where(den > 0, num / torch.clamp(den, min=1e-12), 0.0)

    a_last = torch.sigmoid(_alpha_last(sp, h)).reshape(1, hkv, n_rep, 1)
    a_eff = torch.where(den > 0, a_last, 1.0)
    o = a_eff * o_s + (1.0 - a_eff) * o_l              # (B, Hkv, n_rep, Dh)
    return o.reshape(b, h, dh)[:, :, None, :]


# ---------------------------------------------------------------------------
# The page pool
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: AttentionConfig, num_pages: int, batch: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    """Page pool of one layer: K/V pages (codes with per-row f32 scales
    under ``kv_quant``) and, for SLA2, the pooled router key of every page
    (codes and one scale per (page, KV head) under ``kv_quant``) and the
    per-slot linear totals."""
    _check_mechanism(cfg)
    hkv, dh, bk = cfg.num_kv_heads, cfg.head_dim, cfg.block_k
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    sla2 = cfg.mechanism == "sla2"
    if cfg.kv_quant != "none":
        qdt = ops.kv_pool_dtype(cfg.kv_quant)
        cache = {"k_pages": z((num_pages, hkv, bk, dh), qdt),
                 "v_pages": z((num_pages, hkv, bk, dh), qdt),
                 "k_scale": z((num_pages, hkv, bk), torch.float32),
                 "v_scale": z((num_pages, hkv, bk), torch.float32)}
        if sla2:
            cache["pooled_pages"] = z((num_pages, hkv, dh), qdt)
            cache["pooled_scale"] = z((num_pages, hkv), torch.float32)
    else:
        cache = {"k_pages": z((num_pages, hkv, bk, dh), dtype),
                 "v_pages": z((num_pages, hkv, bk, dh), dtype)}
        if sla2:
            cache["pooled_pages"] = z((num_pages, hkv, dh), torch.float32)
    if sla2:
        cache["h_tot"] = z((batch, hkv, dh, dh), torch.float32)
        cache["z_tot"] = z((batch, hkv, dh), torch.float32)
    return cache


# A slot's state in one layer is its pages (addressed by its page-table
# row) and its per-slot totals (addressed by the slot id).
PAGE_KEYS = ("k_pages", "v_pages", "pooled_pages",
             "k_scale", "v_scale", "pooled_scale")
SLOT_KEYS = ("h_tot", "z_tot")
_SCALE_OF = {"k_pages": "k_scale", "v_pages": "v_scale",
             "pooled_pages": "pooled_scale"}


def extract_paged_state(cache: dict, page_row, slot: int) -> dict:
    """Copies of one slot's pages (rows ``page_row``) and totals."""
    idx = torch.as_tensor(page_row, device=cache["k_pages"].device).long()
    st = {k: cache[k][idx].clone() for k in PAGE_KEYS if k in cache}
    st.update({k: cache[k][slot].clone() for k in SLOT_KEYS if k in cache})
    return st


def insert_paged_state(cache: dict, page_row, slot: int, state: dict) -> dict:
    """Write an extracted state back at (possibly other) pages and slot.
    Raises ValueError for a leaf the cache does not have."""
    idx = torch.as_tensor(page_row, device=cache["k_pages"].device).long()
    for k, v in state.items():
        if k not in cache:
            raise ValueError(
                f"state leaf {k!r} does not exist in the target cache "
                f"(has {sorted(cache)}): wrong cache kind for this insert")
        v = v.to(device=cache[k].device, dtype=cache[k].dtype)
        if k in PAGE_KEYS:
            cache[k][idx] = v
        else:
            cache[k][slot] = v
    return cache


def extract_slot_state(cache: dict, slot: int) -> dict:
    """Copies of one slot's per-slot leaves only (the SLA2 totals): the
    prefix summary a prefix-cache node snapshots.  Empty for a cache
    without per-slot state."""
    return {k: cache[k][slot].clone() for k in SLOT_KEYS if k in cache}


def insert_slot_state(cache: dict, slot: int, state: dict) -> dict:
    """Write an ``extract_slot_state`` snapshot back at ``slot``, in
    place: the totals restore of a prefix-cache hit.  Raises ValueError
    for a leaf the cache does not have."""
    for k, v in state.items():
        if k not in cache:
            raise ValueError(
                f"slot-state leaf {k!r} does not exist in the target cache "
                f"(has {sorted(cache)}): wrong cache kind for this insert")
        cache[k][slot] = v.to(device=cache[k].device, dtype=cache[k].dtype)
    return cache


def copy_paged_page(cache: dict, src: int, dst: int) -> dict:
    """Copy physical page ``src`` onto ``dst`` in every page leaf (K/V,
    the SLA2 pooled key, and the scales of a quantised pool), in place:
    the device half of the engine's copy-on-write."""
    for k in PAGE_KEYS:
        if k in cache:
            cache[k][dst] = cache[k][src]
    return cache


# ---------------------------------------------------------------------------
# Dispatch between the fused kernels and the gather reference
# ---------------------------------------------------------------------------

# Device types where paged_impl='auto' takes the gather reference.
AUTO_GATHER_BACKENDS = ("cpu",)
PAGED_PHASES = ("prefill", "decode", "verify")
_DENSE_PATHS = {
    "prefill": ("paged_flash_prefill", "_gather_pages + dense chunk attn"),
    "decode": ("dense_decode_fused", "_gather_pages + dense masked decode"),
    "verify": ("dense_decode_verify", "_gather_pages + dense window decode"),
}
# (mechanism, phase) -> (fused entry, gather reference), as in the JAX
# package.  The port holds every entry ('sla' and 'sparse_only' raise
# earlier, at init).
PAGED_DISPATCH = {
    ("sla2", "prefill"): _DENSE_PATHS["prefill"],
    ("sla2", "decode"): ("sla2_decode_fused", "_sla2_decode_paged gather"),
    ("sla2", "verify"): ("sla2_decode_verify", "_sla2_decode_window gather"),
    **{(m, ph): _DENSE_PATHS[ph]
       for m in ("full", "sla", "sparse_only") for ph in PAGED_PHASES},
}
PORTED_ENTRIES = tuple(sorted({entry for entry, _ in
                               PAGED_DISPATCH.values()}))


def resolve_paged_impl(cfg: AttentionConfig, device) -> str:
    """cfg.paged_impl, with 'auto' resolved for tensors on ``device``:
    'gather' on the AUTO_GATHER_BACKENDS (the CPU), 'fused' elsewhere."""
    if cfg.paged_impl not in ("auto", "fused", "gather"):
        raise ValueError(f"unknown paged_impl {cfg.paged_impl!r}")
    if cfg.paged_impl != "auto":
        return cfg.paged_impl
    return ("gather" if torch.device(device).type in AUTO_GATHER_BACKENDS
            else "fused")


def fused_paged_entry(mechanism: str, phase: str):
    """Name of the fused entry serving (mechanism, phase), or None."""
    entry = PAGED_DISPATCH.get((mechanism, phase))
    return entry[0] if entry else None


def use_fused(cfg: AttentionConfig, phase: str, device) -> bool:
    """True when ``phase`` runs the fused entry for this config."""
    return (resolve_paged_impl(cfg, device) == "fused"
            and fused_paged_entry(cfg.mechanism, phase) is not None)


def fused_entry_fn(name: str):
    """The port's fused entry ``name``; raises for a name that is not one
    of ``PORTED_ENTRIES`` (never a substitute)."""
    if name not in PORTED_ENTRIES:
        raise NotImplementedError(f"fused entry {name!r} is not a paged "
                                  f"kernel entry of the port")
    return getattr(KP, name)


# ---------------------------------------------------------------------------
# Pool reads and writes (dequantising under kv_quant)
# ---------------------------------------------------------------------------

def _kv_read(cache: dict, name: str, idx) -> torch.Tensor:
    """``cache[name][idx]`` dequantised to f32."""
    out = cache[name][idx]
    sk = _SCALE_OF[name]
    if sk in cache:
        return ops.dequant_rows(out, cache[sk][idx])
    return out.to(torch.float32)


def _kv_gather_pages(cache: dict, name: str, page_table) -> torch.Tensor:
    """Contiguous (B, Hkv, maxP * bk, Dh) f32 per-slot view of a page
    array in logical order."""
    g = _kv_read(cache, name, page_table.long())    # (B, maxP, Hkv, bk, Dh)
    b, mp, hkv, bk, dh = g.shape
    return g.transpose(1, 2).reshape(b, hkv, mp * bk, dh)


def _kv_gather_blocks(cache: dict, name: str, phys) -> torch.Tensor:
    """(B, Hkv, K, bk, Dh) f32 from per-KV-head physical page ids
    (B, Hkv, K)."""
    hkv = phys.shape[1]
    h_ix = torch.arange(hkv, device=phys.device)[None, :, None]
    ph = phys.long()
    out = cache[name][ph, h_ix].to(torch.float32)
    sk = _SCALE_OF[name]
    if sk in cache:
        out = out * cache[sk][ph, h_ix][..., None]
    return out


def _store_kv_rows(cache: dict, cfg: AttentionConfig, phys, rows, k_new,
                   v_new):
    """Write token rows at ``[phys, :, rows]``, the one point where a row is
    quantised (under ``kv_quant``).  Returns (cache, k_eff, v_eff): the
    values a later page read observes."""
    phys, rows = phys.long(), rows.long()
    if cfg.kv_quant == "none":
        cache["k_pages"][phys, :, rows] = k_new.to(cache["k_pages"].dtype)
        cache["v_pages"][phys, :, rows] = v_new.to(cache["v_pages"].dtype)
        return cache, k_new, v_new
    k_c, k_s = ops.quantize_rows(k_new, cfg.kv_quant)
    v_c, v_s = ops.quantize_rows(v_new, cfg.kv_quant)
    cache["k_pages"][phys, :, rows] = k_c
    cache["v_pages"][phys, :, rows] = v_c
    cache["k_scale"][phys, :, rows] = k_s
    cache["v_scale"][phys, :, rows] = v_s
    return cache, ops.dequant_rows(k_c, k_s), ops.dequant_rows(v_c, v_s)


def _store_pooled(cache: dict, cfg: AttentionConfig, phys, pooled, keep):
    """Write pooled router keys (f32 (..., Hkv, Dh)) at pages ``phys``
    where ``keep``; the other rows keep what the page holds."""
    phys = phys.long()
    if cfg.kv_quant == "none":
        old = cache["pooled_pages"][phys]
        cache["pooled_pages"][phys] = torch.where(
            keep[..., None, None], pooled.to(old.dtype), old)
        return cache
    codes, scale = ops.quantize_rows(pooled, cfg.kv_quant)
    old_c, old_s = cache["pooled_pages"][phys], cache["pooled_scale"][phys]
    cache["pooled_pages"][phys] = torch.where(keep[..., None, None], codes,
                                              old_c)
    cache["pooled_scale"][phys] = torch.where(keep[..., None], scale, old_s)
    return cache


def _sqrt(dh: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), math.sqrt(dh), dtype=torch.float32,
                      device=like.device)


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------

def chunk_prefill_paged(params: AttentionParams, cfg: AttentionConfig, x,
                        cache: dict, *, page_row, offset: int,
                        chunk_len: int, slot: int):
    """Prefill one chunk of ONE slot's prompt into the page pool.

    x (1, C, d_model) chunk embeddings, padded to the chunk size;
    page_row (maxP,) int32, the slot's page-table row; offset tokens of the
    slot already cached (a multiple of block_k); chunk_len valid tokens
    (<= C); slot the batch row of the per-slot totals.  Attention is exact
    (softmax over the cached history and the chunk, causal in the chunk).
    Returns (y (1, C, d_model), cache)."""
    offset, chunk_len, slot = int(offset), int(chunk_len), int(slot)
    _, c, _ = x.shape
    h, hkv, dh, bk = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.block_k)
    n_rep = h // hkv
    max_p = page_row.shape[0]
    dev = x.device
    ar = torch.arange(c, device=dev)
    q, k_new, v_new = _project_qkv(params, cfg, x, (offset + ar)[None])

    # ---- the chunk's K/V into the slot's pages (padding -> trash) ----
    tok_pos = offset + ar
    valid_t = ar < chunk_len
    logical = torch.clamp(tok_pos // bk, max=max_p - 1)
    phys = torch.where(valid_t, page_row.long()[logical], 0)
    cache, k_eff, v_eff = _store_kv_rows(cache, cfg, phys, tok_pos % bk,
                                         k_new[0], v_new[0])

    # ---- exact attention: chunk queries over history + chunk ----
    if use_fused(cfg, "prefill", dev):
        o = fused_entry_fn("paged_flash_prefill")(
            q.transpose(1, 2)[0].contiguous(), cache["k_pages"],
            cache["v_pages"], page_row, offset=offset, block_k=bk,
            n_rep=n_rep, window=cfg.sliding_window,
            prefix_len=cfg.prefix_len, kv_quant=cfg.kv_quant,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
        o = o.to(x.dtype).transpose(0, 1).reshape(1, c, h * dh)
    else:
        k_all = _repeat_kv(_kv_gather_pages(cache, "k_pages",
                                            page_row[None]), n_rep)
        v_all = _repeat_kv(_kv_gather_pages(cache, "v_pages",
                                            page_row[None]), n_rep)
        q_t = q.transpose(1, 2).to(torch.float32)         # (1, H, C, Dh)
        s = true_div(torch.einsum("bhnd,bhmd->bhnm", q_t, k_all),
                     math.sqrt(dh))
        n_kv = k_all.shape[2]
        vis = masklib.token_causal_mask(c, n_kv, offset, cfg.prefix_len,
                                        device=dev)
        if cfg.sliding_window is not None:
            qi = ar + offset
            kj = torch.arange(n_kv, device=dev)
            sw = kj[None, :] >= (qi[:, None] - cfg.sliding_window + 1)
            if cfg.prefix_len:
                sw = sw | (kj[None, :] < cfg.prefix_len)
            vis = vis & sw
        s = torch.where(vis, s, masklib.NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhnm,bhmd->bhnd", p, v_all)
        o = o.to(x.dtype).transpose(1, 2).reshape(1, c, h * dh)

    if cfg.mechanism != "sla2":
        return F.linear(o, params.wo.weight), cache

    # ---- SLA2 block states of the chunk's blocks, from the page values ----
    t_c = c // bk
    kb = k_eff.to(torch.float32).reshape(t_c, bk, hkv, dh).transpose(1, 2)
    vb = v_eff.to(torch.float32).reshape(t_c, bk, hkv, dh).transpose(1, 2)
    w = valid_t.reshape(t_c, bk).to(torch.float32)
    wb = w[:, None, :, None]
    pooled = (kb * wb).sum(-2) / torch.clamp(wb.sum(-2), min=1.0)
    blk_ids = torch.clamp(offset // bk + torch.arange(t_c, device=dev),
                          max=max_p - 1)
    has_tok = w.sum(-1) > 0
    phys_blk = torch.where(has_tok, page_row.long()[blk_ids], 0)
    cache = _store_pooled(cache, cfg, phys_blk, pooled, has_tok)
    complete = (w.sum(-1) == bk)[:, None, None, None]
    kf = phi(kb) * wb
    h_add = (torch.einsum("thkd,thke->thde", kf, vb * wb) * complete).sum(0)
    z_add = (kf.sum(-2) * complete[..., 0]).sum(0)
    if offset == 0:          # first chunk of a (possibly recycled) slot
        cache["h_tot"][slot] = h_add
        cache["z_tot"][slot] = z_add
    else:
        cache["h_tot"][slot] += h_add
        cache["z_tot"][slot] += z_add
    return F.linear(o, params.wo.weight), cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_step_paged(params: AttentionParams, cfg: AttentionConfig, x_t,
                      cache: dict, *, page_table, lengths, active):
    """Batched one-token decode with per-slot offsets over the page pool.

    x_t (B, 1, d_model); page_table (B, maxP) int32; lengths (B,) tokens
    already cached per slot (the new token lands at lengths[b]); active
    (B,) bool.  Inactive rows write to the trash page and give outputs the
    engine ignores.  Returns (o (B, 1, d_model), cache)."""
    _check_mechanism(cfg)
    b = x_t.shape[0]
    h, hkv, dh, bk = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.block_k)
    lengths = lengths.long()
    q, k_new, v_new = _project_qkv(params, cfg, x_t, lengths[:, None])
    q = q.transpose(1, 2)                                # (B, H, 1, Dh)
    cur_blk = lengths // bk
    phys_w = torch.where(
        active, page_table.long().gather(1, cur_blk[:, None])[:, 0], 0)
    cache, _, _ = _store_kv_rows(cache, cfg, phys_w, lengths % bk,
                                 k_new[:, 0], v_new[:, 0])
    t_new = lengths + 1
    if cfg.mechanism == "sla2":
        o = _sla2_decode_paged(params, cfg, q, cache, page_table, phys_w,
                               t_new, active)
    elif use_fused(cfg, "decode", x_t.device):
        o = fused_entry_fn("dense_decode_fused")(
            q[:, :, 0].reshape(b, hkv, h // hkv, dh), cache["k_pages"],
            cache["v_pages"], page_table.to(torch.int32),
            t_new.to(torch.int32), block_k=bk, window=cfg.sliding_window,
            prefix_len=cfg.prefix_len, quant_bits=cfg.decode_quant_bits,
            kv_quant=cfg.kv_quant, k_scale=cache.get("k_scale"),
            v_scale=cache.get("v_scale"))
        o = o.reshape(b, h, dh)[:, :, None, :]
    else:
        o = _dense_gather_attention(cfg, q, cache, page_table, t_new[:, None])
    o = o.to(x_t.dtype).transpose(1, 2).reshape(b, 1, h * dh)
    return F.linear(o, params.wo.weight), cache


def _dense_gather_attention(cfg: AttentionConfig, q, cache, page_table,
                            t_new):
    """The gather reference of dense paged decode / verify: dense masked
    attention of q (B, H, W, Dh) over the slot's gathered pages, row w
    seeing the positions below t_new[:, w] (and, with a sliding window,
    not below t_new - window unless inside the prefix).  Returns
    (B, H, W, Dh) f32."""
    n_rep = cfg.num_heads // cfg.num_kv_heads
    k_all = _repeat_kv(_kv_gather_pages(cache, "k_pages", page_table), n_rep)
    v_all = _repeat_kv(_kv_gather_pages(cache, "v_pages", page_table), n_rep)
    s = true_div(torch.einsum("bhwd,bhmd->bhwm", q.to(torch.float32), k_all),
                 math.sqrt(cfg.head_dim))
    pos_k = torch.arange(k_all.shape[2], device=q.device)
    t = t_new.long()[:, :, None]
    vis = pos_k[None, None, :] < t                       # (B, W, S)
    if cfg.sliding_window is not None:
        sw = pos_k[None, None, :] >= t - cfg.sliding_window
        if cfg.prefix_len:
            sw = sw | (pos_k[None, None, :] < cfg.prefix_len)
        vis = vis & sw
    s = torch.where(vis[:, None], s, masklib.NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhwm,bhmd->bhwd", p, v_all)


def _alpha_last(sla2_p, h: int) -> torch.Tensor:
    logit = sla2_p.alpha_logit[:, -1].to(torch.float32)
    if logit.shape[0] == 1 and h > 1:
        logit = logit.expand(h)
    return logit


def _sla2_decode_paged(params: AttentionParams, cfg: AttentionConfig, q,
                       cache, page_table, phys_w, t_new, active):
    """SLA2 decode with per-slot lengths: update the current block's pooled
    key and (on completion) the linear totals, route over the pooled keys,
    then the fused kernel or the gather reference."""
    sla2_p = params.sla2
    b, h, _, dh = q.shape
    hkv = cfg.num_kv_heads
    n_rep = h // hkv
    bk = cfg.block_k
    t_n = page_table.shape[1]
    dev = q.device

    # ---- the current block's stats (trash page if inactive) ----
    cur_blk = (t_new - 1) // bk
    kblk = _kv_read(cache, "k_pages", phys_w)            # (B, Hkv, bk, Dh)
    vblk = _kv_read(cache, "v_pages", phys_w)
    in_blk = (cur_blk[:, None] * bk + torch.arange(bk, device=dev)[None, :]
              ) < t_new[:, None]
    w = in_blk.to(torch.float32)[:, None, :, None]
    pooled_cur = (kblk * w).sum(-2) / torch.clamp(w.sum(-2), min=1.0)
    cache = _store_pooled(cache, cfg, phys_w, pooled_cur, active)
    completed = (t_new % bk) == 0
    kf_cur = phi(kblk) * w
    h_cur = torch.einsum("bhkd,bhke->bhde", kf_cur, vblk * w)
    z_cur = kf_cur.sum(-2)
    upd = (completed & active)[:, None]
    cache["h_tot"] += torch.where(upd[..., None, None], h_cur, 0.0)
    cache["z_tot"] += torch.where(upd[..., None], z_cur, 0.0)

    # ---- route: group-shared over the slot's logical blocks ----
    rp = sla2_p.router
    qr = q[:, :, 0].to(torch.float32)                    # (B, H, Dh)
    pk = _kv_read(cache, "pooled_pages", page_table.long()).transpose(1, 2)
    if rp is not None:
        qr = F.linear(qr, rp.proj_q.weight.to(torch.float32))
        pk = F.linear(pk, rp.proj_k.weight.to(torch.float32))
    qr_g = qr.reshape(b, hkv, n_rep, dh).mean(dim=2)
    scores = torch.einsum("bhd,bhtd->bht", qr_g, pk) / _sqrt(dh, qr)
    blk_ids = torch.arange(t_n, device=dev)
    scores = torch.where(blk_ids[None, None, :] <= cur_blk[:, None, None],
                         scores, masklib.NEG_INF)
    scores = torch.where(blk_ids[None, None, :] == cur_blk[:, None, None],
                         math.inf, scores)
    k_sel = max(1, round(cfg.k_frac * t_n))
    top_vals, idx = torch.topk(scores, k_sel, dim=-1)    # (B, Hkv, K_sel)
    valid = top_vals > masklib.NEG_INF * 0.5
    pt = page_table.long()[:, None, :].expand(b, hkv, t_n)
    phys_sel = torch.where(valid, pt.gather(2, idx), 0)
    complete_bound = cur_blk + completed.long()
    sel_complete = valid & (idx < complete_bound[:, None, None])

    if use_fused(cfg, "decode", dev):
        alpha = _alpha_last(sla2_p, h).reshape(1, hkv, n_rep).expand(
            b, hkv, n_rep).contiguous()
        i32 = lambda t: t.to(torch.int32)
        o = fused_entry_fn("sla2_decode_fused")(
            q[:, :, 0].reshape(b, hkv, n_rep, dh), cache["k_pages"],
            cache["v_pages"], i32(phys_sel), i32(idx), i32(valid),
            i32(sel_complete), i32(t_new), cache["h_tot"], cache["z_tot"],
            alpha, block_k=bk, quant_bits=cfg.decode_quant_bits,
            kv_quant=cfg.kv_quant, k_scale=cache.get("k_scale"),
            v_scale=cache.get("v_scale"))
        return o.reshape(b, h, dh)[:, :, None, :]

    # ---- gather reference: gather the routed pages, flash, linear ----
    k_sel_blocks = _kv_gather_blocks(cache, "k_pages", phys_sel)
    v_sel_blocks = _kv_gather_blocks(cache, "v_pages", phys_sel)
    q_g = q[:, :, 0].to(torch.float32).reshape(b, hkv, n_rep, dh)
    s = torch.einsum("bhgd,bhjkd->bhgjk", q_g, k_sel_blocks) / _sqrt(dh, q_g)
    pos = idx[..., None] * bk + torch.arange(bk, device=dev)
    vis = (pos < t_new[:, None, None, None]) & valid[..., None]
    s = torch.where(vis[:, :, None], s, masklib.NEG_INF)
    p = torch.softmax(s.reshape(b, hkv, n_rep, -1), dim=-1).reshape(s.shape)
    o_s = torch.einsum("bhgjk,bhjkd->bhgd", p, v_sel_blocks)

    qfeat = phi(q[:, :, 0]).reshape(b, hkv, n_rep, dh)
    ls = torch.einsum("bhgd,bhjkd->bhgjk", qfeat, phi(k_sel_blocks))
    ls = ls * sel_complete[:, :, None, :, None].to(torch.float32)
    sub_num = torch.einsum("bhgjk,bhjkd->bhgd", ls, v_sel_blocks)
    sub_den = ls.sum(dim=(-1, -2))
    den_tot = torch.einsum("bhgd,bhd->bhg", qfeat, cache["z_tot"])
    num = torch.einsum("bhgd,bhde->bhge", qfeat, cache["h_tot"]) - sub_num
    den = den_tot - sub_den
    den = torch.where(den > 1e-4 * den_tot + 1e-12, den, 0.0)[..., None]
    o_l = torch.where(den > 0, num / torch.clamp(den, min=1e-12), 0.0)
    a_last = torch.sigmoid(_alpha_last(sla2_p, h)).reshape(1, hkv, n_rep, 1)
    a_eff = torch.where(den > 0, a_last, 1.0)
    o = a_eff * o_s + (1.0 - a_eff) * o_l
    return o.reshape(b, h, dh)[:, :, None, :]


# ---------------------------------------------------------------------------
# Multi-token verify window and linear-branch drafting (speculative decoding)
# ---------------------------------------------------------------------------

def window_span(window: int, block_k: int) -> int:
    """Most logical blocks a ``window``-token run starting at any offset can
    touch."""
    return (window + block_k - 2) // block_k + 1


def _span(page_table, lengths, n_span: int, bk: int):
    """The logical blocks a window starting at ``lengths`` can touch:
    (span_ids (B, S) clamped to the table, genuine (B, S) not clamped,
    span_phys (B, S))."""
    t_n = page_table.shape[1]
    raw = (lengths.long() // bk)[:, None] + torch.arange(
        n_span, device=page_table.device)[None, :]
    genuine = raw < t_n
    span_ids = torch.clamp(raw, max=t_n - 1)
    return span_ids, genuine, page_table.long().gather(1, span_ids)


def decode_window_paged(params: AttentionParams, cfg: AttentionConfig, x_w,
                        cache: dict, *, page_table, lengths, active,
                        window_len):
    """Verify pass of speculative decoding: W query rows per slot, one call.

    x_w (B, W, d_model) window embeddings: row 0 is the last accepted
    token, rows 1.. the draft; lengths (B,) tokens already cached (row w
    lands at position lengths + w); active (B,) bool; window_len (B,)
    valid rows per slot (rows >= window_len write to the trash page and
    give outputs the engine ignores).  Writes the whole window's K/V into
    the slot's pages but commits no SLA2 block state (``commit_paged_window``
    does, for the accepted prefix).  Returns (y (B, W, d_model), cache)."""
    _check_mechanism(cfg)
    b, wdw, _ = x_w.shape
    h, hkv, dh, bk = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.block_k)
    n_rep = h // hkv
    max_p = page_table.shape[1]
    dev = x_w.device
    lengths = lengths.long()
    tok_pos = lengths[:, None] + torch.arange(wdw, device=dev)   # (B, W)
    q, k_new, v_new = _project_qkv(params, cfg, x_w, tok_pos)
    q = q.transpose(1, 2)                                # (B, H, W, Dh)

    valid_w = (torch.arange(wdw, device=dev)[None, :]
               < window_len.long()[:, None]) & active[:, None]
    logical = torch.clamp(tok_pos // bk, max=max_p - 1)
    phys_w = torch.where(valid_w, page_table.long().gather(1, logical), 0)
    cache, _, _ = _store_kv_rows(cache, cfg, phys_w, tok_pos % bk, k_new,
                                 v_new)
    t_new = tok_pos + 1                                  # (B, W)

    if cfg.mechanism == "sla2":
        o = _sla2_decode_window(params, cfg, q, cache, page_table, t_new,
                                lengths)
        o = o.to(x_w.dtype).reshape(b, wdw, h * dh)
    elif use_fused(cfg, "verify", dev):
        o = fused_entry_fn("dense_decode_verify")(
            q.reshape(b, hkv, n_rep, wdw, dh).transpose(2, 3),
            cache["k_pages"], cache["v_pages"], page_table.to(torch.int32),
            t_new.to(torch.int32), block_k=bk, window=cfg.sliding_window,
            prefix_len=cfg.prefix_len, quant_bits=cfg.decode_quant_bits,
            kv_quant=cfg.kv_quant, k_scale=cache.get("k_scale"),
            v_scale=cache.get("v_scale"))
        o = o.transpose(1, 2).to(x_w.dtype).reshape(b, wdw, h * dh)
    else:
        o = _dense_gather_attention(cfg, q, cache, page_table, t_new)
        o = o.to(x_w.dtype).transpose(1, 2).reshape(b, wdw, h * dh)
    return F.linear(o, params.wo.weight), cache


def _sla2_decode_window(params: AttentionParams, cfg: AttentionConfig, q,
                        cache, page_table, t_new, lengths):
    """Per-row SLA2 routing and sparse + linear attention over a W-token
    window with all block state transient (nothing committed):

      * the pooled router keys of the blocks the window touches are made
        per row from the page content below the row's length, the value
        sequential decode would have had in ``pooled_pages`` at that step;
      * each row's linear totals are the cache totals plus the (h, z) of
        span blocks that complete earlier in the window;
      * the position mask ``pos < t_new[row]`` is also the causal mask
        inside the window.

    q (B, H, W, Dh); t_new (B, W).  Returns (B, W, Hkv, n_rep, Dh) f32."""
    sla2_p = params.sla2
    b, h, wdw, dh = q.shape
    hkv = cfg.num_kv_heads
    n_rep = h // hkv
    bk = cfg.block_k
    t_n = page_table.shape[1]
    dev = q.device
    n_span = window_span(wdw, bk)
    ar_bk = torch.arange(bk, device=dev)

    # ---- transient stats of the blocks the window can touch ----
    span_ids, genuine, span_phys = _span(page_table, lengths, n_span, bk)
    kblk = _kv_read(cache, "k_pages", span_phys)         # (B,S,Hkv,bk,Dh)
    vblk = _kv_read(cache, "v_pages", span_phys)
    pos_blk = span_ids[:, :, None] * bk + ar_bk          # (B, S, bk)
    msk = (pos_blk[:, None] < t_new[:, :, None, None]).to(torch.float32)
    pooled_ws = torch.einsum("bwsk,bshkd->bwshd", msk, kblk) / torch.clamp(
        msk.sum(-1), min=1.0)[..., None, None]
    kf_span = phi(kblk)
    h_span = torch.einsum("bshkd,bshke->bshde", kf_span, vblk)
    z_span = kf_span.sum(-2)                             # (B, S, Hkv, Dh)
    cmplt = (genuine[:, None]
             & ((span_ids[:, None] + 1) * bk <= t_new[:, :, None])
             ).to(torch.float32)                         # (B, W, S)
    h_eff = cache["h_tot"][:, None] + torch.einsum("bws,bshde->bwhde",
                                                   cmplt, h_span)
    z_eff = cache["z_tot"][:, None] + torch.einsum("bws,bshd->bwhd",
                                                   cmplt, z_span)

    # ---- route per row: group-shared, transient keys for the span ----
    rp = sla2_p.router
    qr = q.to(torch.float32)                             # (B, H, W, Dh)
    pk = _kv_read(cache, "pooled_pages", page_table.long()).transpose(1, 2)
    pw = pooled_ws
    if rp is not None:
        wq, wk = (rp.proj_q.weight.to(torch.float32),
                  rp.proj_k.weight.to(torch.float32))
        qr, pk, pw = F.linear(qr, wq), F.linear(pk, wk), F.linear(pw, wk)
    qr_g = qr.reshape(b, hkv, n_rep, wdw, dh).mean(dim=2)   # (B,Hkv,W,Dh)
    sq = _sqrt(dh, qr)
    scores = torch.einsum("bhwd,bhtd->bwht", qr_g, pk) / sq
    s_span = torch.einsum("bhwd,bwshd->bwhs", qr_g, pw) / sq
    blk_ids = torch.arange(t_n, device=dev)
    for s_i in range(n_span):
        m = ((blk_ids[None, None, None, :]
              == span_ids[:, s_i, None, None, None])
             & genuine[:, s_i, None, None, None])
        scores = torch.where(m, s_span[:, :, :, s_i:s_i + 1], scores)
    cur_blk = (t_new - 1) // bk                          # (B, W)
    scores = torch.where(
        blk_ids[None, None, None, :] <= cur_blk[:, :, None, None], scores,
        masklib.NEG_INF)
    scores = torch.where(
        blk_ids[None, None, None, :] == cur_blk[:, :, None, None], math.inf,
        scores)
    k_sel = max(1, round(cfg.k_frac * t_n))
    top_vals, idx = torch.topk(scores, k_sel, dim=-1)    # (B, W, Hkv, K)
    valid = top_vals > masklib.NEG_INF * 0.5
    pt = page_table.long()[:, None, None, :].expand(b, wdw, hkv, t_n)
    phys_sel = torch.where(valid, pt.gather(3, idx), 0)
    completed = (t_new % bk) == 0
    complete_bound = cur_blk + completed.long()
    sel_complete = valid & (idx < complete_bound[:, :, None, None])

    if use_fused(cfg, "verify", dev):
        alpha = _alpha_last(sla2_p, h).reshape(1, hkv, n_rep).expand(
            b, hkv, n_rep).contiguous()
        to_k = lambda x: x.transpose(1, 2).to(torch.int32).contiguous()
        o = fused_entry_fn("sla2_decode_verify")(
            q.reshape(b, hkv, n_rep, wdw, dh).transpose(2, 3),
            cache["k_pages"], cache["v_pages"], to_k(phys_sel), to_k(idx),
            to_k(valid), to_k(sel_complete), t_new.to(torch.int32),
            h_eff.transpose(1, 2), z_eff.transpose(1, 2), alpha,
            block_k=bk, quant_bits=cfg.decode_quant_bits,
            kv_quant=cfg.kv_quant, k_scale=cache.get("k_scale"),
            v_scale=cache.get("v_scale"))
        return o.transpose(1, 2)                         # (B,W,Hkv,n_rep,Dh)

    # ---- gather reference ----
    phys_f = phys_sel.reshape(b * wdw, hkv, k_sel)
    k_sb = _kv_gather_blocks(cache, "k_pages", phys_f).reshape(
        b, wdw, hkv, k_sel, bk, dh)
    v_sb = _kv_gather_blocks(cache, "v_pages", phys_f).reshape(
        b, wdw, hkv, k_sel, bk, dh)
    q_g = q.to(torch.float32).reshape(b, hkv, n_rep, wdw, dh).permute(
        0, 3, 1, 2, 4)                                   # (B, W, Hkv, g, Dh)
    s = torch.einsum("bwhgd,bwhjkd->bwhgjk", q_g, k_sb) / _sqrt(dh, q_g)
    pos = idx[..., None] * bk + ar_bk                    # (B, W, Hkv, K, bk)
    vis = (pos < t_new[:, :, None, None, None]) & valid[..., None]
    s = torch.where(vis[:, :, :, None], s, masklib.NEG_INF)
    p = torch.softmax(s.reshape(b, wdw, hkv, n_rep, -1), dim=-1).reshape(
        s.shape)
    o_s = torch.einsum("bwhgjk,bwhjkd->bwhgd", p, v_sb)

    qfeat = phi(q).reshape(b, hkv, n_rep, wdw, dh).permute(0, 3, 1, 2, 4)
    ls = torch.einsum("bwhgd,bwhjkd->bwhgjk", qfeat, phi(k_sb))
    ls = ls * sel_complete[:, :, :, None, :, None].to(torch.float32)
    sub_num = torch.einsum("bwhgjk,bwhjkd->bwhgd", ls, v_sb)
    sub_den = ls.sum(dim=(-1, -2))
    den_tot = torch.einsum("bwhgd,bwhd->bwhg", qfeat, z_eff)
    num = torch.einsum("bwhgd,bwhde->bwhge", qfeat, h_eff) - sub_num
    den = den_tot - sub_den
    den = torch.where(den > 1e-4 * den_tot + 1e-12, den, 0.0)[..., None]
    o_l = torch.where(den > 0, num / torch.clamp(den, min=1e-12), 0.0)
    a_last = torch.sigmoid(_alpha_last(sla2_p, h)).reshape(1, 1, hkv, n_rep,
                                                           1)
    a_eff = torch.where(den > 0, a_last, 1.0)
    return a_eff * o_s + (1.0 - a_eff) * o_l


def commit_paged_window(cfg: AttentionConfig, cache: dict, *, page_table,
                        lengths, accepted, active, window: int) -> dict:
    """Commit the accepted prefix of a verify window into the SLA2 block
    state: rewrite the pooled router keys of every block the prefix
    touches (masked to the new length) and fold newly completed blocks
    into the per-slot linear totals.  The verify pass already wrote K/V;
    ``mechanism="full"`` keeps no block state and commits nothing.

    lengths (B,) committed tokens before the window; accepted (B,) rows
    being committed (0 for slots that sat out); window the window size W
    the verify ran with."""
    if cfg.mechanism != "sla2":
        return cache
    bk = cfg.block_k
    lengths, accepted = lengths.long(), accepted.long()
    new_len = lengths + accepted
    span_ids, genuine, span_phys = _span(page_table, lengths,
                                         window_span(window, bk), bk)
    kblk = _kv_read(cache, "k_pages", span_phys)         # (B,S,Hkv,bk,Dh)
    vblk = _kv_read(cache, "v_pages", span_phys)
    pos_blk = span_ids[:, :, None] * bk + torch.arange(bk,
                                                       device=kblk.device)
    msk = (pos_blk < new_len[:, None, None]).to(torch.float32)
    live = genuine & active[:, None] & (accepted > 0)[:, None]
    has_tok = (msk.sum(-1) > 0) & live                   # (B, S)
    pooled = torch.einsum("bsk,bshkd->bshd", msk, kblk) / torch.clamp(
        msk.sum(-1), min=1.0)[..., None, None]
    upd_phys = torch.where(has_tok, span_phys, 0)
    cache = _store_pooled(cache, cfg, upd_phys, pooled, has_tok)
    newc = (live & ((span_ids + 1) * bk <= new_len[:, None])
            & ((span_ids + 1) * bk > lengths[:, None])).to(torch.float32)
    kf = phi(kblk)
    cache["h_tot"] += torch.einsum("bs,bshkd,bshke->bhde", newc, kf, vblk)
    cache["z_tot"] += torch.einsum("bs,bshkd->bhd", newc, kf)
    return cache


def linear_draft_state(cfg: AttentionConfig, cache: dict, *, page_table,
                       lengths, active) -> dict:
    """Draft state of one SLA2 layer: linear-branch totals over everything
    cached so far, the committed complete-block totals plus the current
    partial block read from its page.  Kept apart from the cache, so a
    rejected draft needs no rollback.  Returns {"h": (B, Hkv, Dh, Dh),
    "z": (B, Hkv, Dh)} f32."""
    if cfg.mechanism != "sla2":
        raise ValueError("linear drafting requires mechanism='sla2'")
    bk = cfg.block_k
    t_n = page_table.shape[1]
    lengths = lengths.long()
    blk0 = torch.clamp(lengths // bk, max=t_n - 1)
    phys = torch.where(active, page_table.long().gather(1, blk0[:, None])[:, 0],
                       0)
    kblk = _kv_read(cache, "k_pages", phys)              # (B, Hkv, bk, Dh)
    vblk = _kv_read(cache, "v_pages", phys)
    pos = blk0[:, None] * bk + torch.arange(bk, device=kblk.device)
    w = ((pos < lengths[:, None]) & active[:, None]).to(
        torch.float32)[:, None, :, None]
    kf = phi(kblk) * w
    return {"h": cache["h_tot"] + torch.einsum("bhkd,bhke->bhde", kf,
                                               vblk * w),
            "z": cache["z_tot"] + kf.sum(-2)}


def linear_draft_attention(params: AttentionParams, cfg: AttentionConfig,
                           x_t, state: dict, *, positions, active):
    """One draft token through the linear branch alone: no page reads and
    no routing, O(Dh^2) per token against the running totals.  The new
    token's own phi(k) v joins the state first.  x_t (B, 1, d_model);
    positions (B,).  Returns (y (B, 1, d_model), new state)."""
    b = x_t.shape[0]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k_new, v_new = _project_qkv(params, cfg, x_t, positions[:, None])
    kf = phi(k_new[:, 0])                                # (B, Hkv, Dh)
    v0 = v_new[:, 0].to(torch.float32)
    gate = active[:, None, None]
    state = {"h": state["h"] + torch.where(
                 gate[..., None], torch.einsum("bhd,bhe->bhde", kf, v0), 0.0),
             "z": state["z"] + torch.where(gate, kf, 0.0)}
    qfeat = phi(q[:, 0]).reshape(b, hkv, h // hkv, dh)
    num = torch.einsum("bhgd,bhde->bhge", qfeat, state["h"])
    den = torch.einsum("bhgd,bhd->bhg", qfeat, state["z"])[..., None]
    o = torch.where(den > 0, num / torch.clamp(den, min=1e-12), 0.0)
    o = o.reshape(b, 1, h * dh).to(x_t.dtype)
    return F.linear(o, params.wo.weight), state
