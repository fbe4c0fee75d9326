"""The decoder-only LM of the port: the ``dense`` layer kind (pre-norm
attention + gated SiLU MLP) in an ``nn.ModuleList``, with the
full-sequence forward and the next-token loss (training), the static
cache path (``prefill`` / ``decode_step``: one shared length for the
batch), its paged serving path (chunked prefill, per-slot decode, swap of
one slot's state, the prefix cache's totals snapshot and page copy) and
speculative decoding (the verify window, its commit, and the SLA2 linear
drafter's state and step).  The reference
stacks its layers into scanned ``groups``; ``convert.lm_params_from_numpy``
unstacks them.

With ``remat == "full"`` and grad enabled, every layer and every loss
chunk runs under ``torch.utils.checkpoint``: the backward re-runs the
layer's forward, so the sparse-branch forward kernel runs twice per
layer and microbatch, as under ``jax.checkpoint``.

MoE, MLA and recurrent layers (``moe``, ``mla``, ``ssm``, other
``layer_kinds``) are not ported yet (ROADMAP) and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One decoder-only architecture: geometry, attention mechanism
    ('full', 'sla2', 'sla', 'sparse_only') and masks, SLA2 knobs, the
    paged-serving switches and the training knobs (the fields of the
    reference's ModelConfig that a stack of dense layers reads; those of
    other families wait for their slices)."""
    name: str = "model"
    n_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024
    layer_kinds: tuple = ("dense",)
    first_kinds: tuple = ()
    mechanism: str = "sla2"
    causal: bool = True
    sliding_window: Optional[int] = None
    qk_norm: bool = False
    prefix_len: int = 0
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    block_q: int = 128
    block_k: int = 64
    k_frac: float = 0.05
    quant_bits: str = "int8"           # QAT of the full-sequence forward
    sla2_impl: str = "gather"          # kernel | gather | ref
    q_chunk: int = 16                  # gather mode: query blocks per step
    fuse_branches: bool = False        # gather mode: one pass, both branches
    paged_impl: str = "auto"           # fused | gather | auto
    decode_quant_bits: str = "none"    # QAT tiles of the decode kernel
    kv_quant: str = "none"             # page-pool storage: none|int8|fp8
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    ssm: Optional[Any] = None
    remat: str = "full"                # full | none (training only)
    dtype: str = "bfloat16"
    max_target_len: int = 8192         # sizes the alpha table at init
    loss_chunk: int = 1024             # CE computed per sequence chunk
    z_loss: float = 1e-4

    @property
    def param_dtype(self) -> torch.dtype:
        """Parameter/activation dtype as a torch dtype."""
        return _DTYPES[self.dtype]

    def attention_config(self) -> A.AttentionConfig:
        """The per-layer attention view of this config."""
        return A.AttentionConfig(
            d_model=self.d_model, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            mechanism=self.mechanism, causal=self.causal,
            prefix_len=self.prefix_len,
            sliding_window=self.sliding_window, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta, block_q=self.block_q,
            block_k=self.block_k, k_frac=self.k_frac,
            quant_bits=self.quant_bits, sla2_impl=self.sla2_impl,
            n_q_blocks=max(1, self.max_target_len // self.block_q),
            paged_impl=self.paged_impl,
            decode_quant_bits=self.decode_quant_bits, kv_quant=self.kv_quant)

    def sla2_config(self):
        """The core SLA2 config view, with the model-level chunking and
        branch-fusion knobs applied.  (As in the reference, the attention
        layers run ``attention_config().sla2_config()``, which keeps
        SLA2Config's defaults for both.)"""
        return dataclasses.replace(self.attention_config().sla2_config(),
                                   q_chunk=self.q_chunk,
                                   fuse_branches=self.fuse_branches)


def check_ported(cfg: ModelConfig) -> None:
    """Raise for the parts of the reference's ModelConfig the port lacks."""
    kinds = tuple(cfg.first_kinds) + tuple(cfg.layer_kinds)
    if any(k != "dense" for k in kinds) or cfg.moe or cfg.mla or cfg.ssm:
        raise NotImplementedError(
            f"{cfg.name}: only the 'dense' layer kind is ported (layer kinds "
            f"{kinds}, moe/mla/ssm set: {bool(cfg.moe or cfg.mla or cfg.ssm)})"
            "; the other families are in ROADMAP")


class LayerParams(nn.Module):
    """One dense layer: ln1, attention, ln2, gated MLP."""

    def __init__(self, ln1, attn, ln2, mlp):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class LMParams(nn.Module):
    """Embedding table (vocab, d_model), the layers, the final norm and,
    when untied, ``lm_head`` as an ``nn.Linear`` weight (vocab, d_model)."""

    def __init__(self, embed, layers, final_norm, lm_head=None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = lm_head
        self._head_f32 = None

    def head_f32(self) -> torch.Tensor:
        """A resident f32 copy of the unembedding matrix (vocab, d_model),
        made once and again only when the weight changes; the reference
        multiplies in f32 at every step."""
        w = self.embed if self.lm_head is None else self.lm_head.weight
        key = (w.data_ptr(), w._version)
        if self._head_f32 is None or self._head_f32[0] != key:
            self._head_f32 = (key, w.detach().to(torch.float32))
        return self._head_f32[1]


def init_model(generator: torch.Generator, cfg: ModelConfig,
               device=None) -> LMParams:
    """Random params: embeddings N(0, 1) truncated, layers, final norm and
    the untied head (std d_model^-1/2)."""
    check_ported(cfg)
    dt = cfg.param_dtype
    d = cfg.d_model
    acfg = cfg.attention_config()
    embed = L.truncated_normal(generator, (cfg.vocab_size, d), dt, 1.0,
                               device)
    layers = [LayerParams(
        L.init_rmsnorm(d, dt, device),
        A.init_attention(generator, acfg, dt, device),
        L.init_rmsnorm(d, dt, device),
        L.init_gated_mlp(generator, d, cfg.d_ff, dtype=dt, device=device))
        for _ in range(cfg.n_layers)]
    head = None
    if not cfg.tie_embeddings:
        head = L.linear(generator, d, cfg.vocab_size, dt, d ** -0.5, device)
    return LMParams(embed, layers, L.init_rmsnorm(d, dt, device), head)


def logits_from_hidden(params: LMParams, cfg: ModelConfig, hidden):
    """Vocab logits in f32, ``hidden @ head`` with the f32 head (TF32 is
    off for f32 matmuls).  The f32 copy of the head stays resident (3.1 GB
    at qwen3-14b) instead of being made anew at every step."""
    return torch.matmul(hidden.to(torch.float32), params.head_f32().T)


def _embed(params: LMParams, cfg: ModelConfig, tokens):
    return L.embed(params.embed, tokens).to(cfg.param_dtype)


# ---------------------------------------------------------------------------
# Full-sequence forward and the next-token loss
# ---------------------------------------------------------------------------

def _layer_forward(lp: LayerParams, acfg: A.AttentionConfig, x, positions):
    x = x + A.attention_forward(lp.attn, acfg, L.rmsnorm(lp.ln1, x),
                                positions)
    return x + L.gated_mlp(lp.mlp, L.rmsnorm(lp.ln2, x))


def forward(params: LMParams, cfg: ModelConfig, tokens):
    """Full-sequence forward of tokens (B, N).  Returns (final-normed
    hidden (B, N, d_model), aux loss 0: dense layers have none)."""
    acfg = cfg.attention_config()
    x = _embed(params, cfg, tokens)
    b, n, _ = x.shape
    positions = torch.arange(n, device=x.device)[None].expand(b, n)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for lp in params.layers:
        if remat:
            x = checkpoint(_layer_forward, lp, acfg, x, positions,
                           use_reentrant=False)
        else:
            x = _layer_forward(lp, acfg, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rmsnorm(params.final_norm, x), aux


def _chunk_loss(h, lab, head, z_loss: float):
    """(CE + z-loss summed over the valid labels, their count) of one
    chunk; head is the f32 (vocab, d_model) unembedding."""
    lg = torch.matmul(h.to(torch.float32), head.T)
    lse = torch.logsumexp(lg, dim=-1)
    tgt = torch.gather(lg, -1, torch.clamp(lab, min=0).long()[..., None])
    valid = (lab >= 0).to(torch.float32)
    ce = (lse - tgt[..., 0]) * valid
    zl = z_loss * lse ** 2 * valid
    return (ce + zl).sum(), valid.sum()


def lm_loss(params: LMParams, cfg: ModelConfig, batch: dict):
    """Next-token cross-entropy with z-loss, computed over chunks of
    ``loss_chunk`` positions (the last one padded with ignored labels).
    batch: tokens (B, N), labels (B, N) with -1 = ignore.  Returns (loss,
    {"ce", "aux", "tokens"})."""
    hidden, aux = forward(params, cfg, batch["tokens"])
    labels = batch["labels"]
    b, n, _ = hidden.shape
    c = min(cfg.loss_chunk, n)
    pad = (-n) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    w = params.embed if params.lm_head is None else params.lm_head.weight
    head = w.to(torch.float32)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    sums, counts = [], []
    for i in range(0, n + pad, c):
        args = (hidden[:, i:i + c], labels[:, i:i + c], head, cfg.z_loss)
        s, k = (checkpoint(_chunk_loss, *args, use_reentrant=False)
                if remat else _chunk_loss(*args))
        sums.append(s)
        counts.append(k)
    total = torch.stack(sums).sum()
    n_valid = torch.clamp(torch.stack(counts).sum(), min=1.0)
    ce = total / n_valid
    return ce + aux, {"ce": ce, "aux": aux, "tokens": n_valid}


# ---------------------------------------------------------------------------
# The static cache: one shared length for the batch
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                dtype=torch.bfloat16, device=None) -> dict:
    """Static decode caches of every layer: ``{"layers": [cache of layer
    i]}`` (``attention.init_cache``); max_len a multiple of block_k."""
    check_ported(cfg)
    acfg = cfg.attention_config()
    return {"layers": [A.init_cache(acfg, batch, max_len, dtype, device)
                       for _ in range(cfg.n_layers)]}


def prefill(params: LMParams, cfg: ModelConfig, tokens, caches):
    """Run the prompts (B, N) through the model, filling every cache
    (N a multiple of block_k).  Returns (logits of the last position
    (B, V), caches)."""
    acfg = cfg.attention_config()
    x = _embed(params, cfg, tokens)

    def mix_fn(ap, h, lc):
        return A.prefill_cache(ap, acfg, h, lc)

    x, caches = _stack(params, cfg, x, caches, mix_fn)
    return logits_from_hidden(params, cfg, x[:, -1]), caches


def decode_step(params: LMParams, cfg: ModelConfig, token_t, caches):
    """One decode step of the batch at the caches' shared length; token_t
    (B,) int.  Returns (logits (B, V), caches)."""
    acfg = cfg.attention_config()
    x = _embed(params, cfg, token_t[:, None])

    def mix_fn(ap, h, lc):
        return A.decode_step(ap, acfg, h, lc)

    x, caches = _stack(params, cfg, x, caches, mix_fn)
    return logits_from_hidden(params, cfg, x)[:, 0], caches


# ---------------------------------------------------------------------------
# Paged caches, chunked prefill, per-slot decode
# ---------------------------------------------------------------------------

def supports_paged(cfg: ModelConfig) -> bool:
    """The port serves stacks of 'dense' layers."""
    return all(k == "dense"
               for k in tuple(cfg.first_kinds) + tuple(cfg.layer_kinds))


def has_slot_state(cfg: ModelConfig) -> bool:
    """True when a layer keeps per-slot state (the SLA2 linear totals)."""
    return cfg.mechanism == "sla2"


def init_paged_caches(cfg: ModelConfig, batch: int, num_pages: int, *,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Per-layer page pools sharing one page table (kept by the engine):
    ``{"layers": [cache of layer i]}``; page size == cfg.block_k."""
    if not supports_paged(cfg):
        raise ValueError(f"paged serving unsupported for {cfg.layer_kinds}")
    acfg = cfg.attention_config()
    return {"layers": [A.init_paged_cache(acfg, num_pages, batch, dtype,
                                          device)
                       for _ in range(cfg.n_layers)]}


def swap_out_slot(cfg: ModelConfig, caches: dict, page_row, slot: int):
    """One slot's state in every layer: its pages at ``page_row`` and its
    totals at ``slot`` (device copies; the engine moves them to the
    host)."""
    return {"layers": [A.extract_paged_state(lc, page_row, slot)
                       for lc in caches["layers"]]}


def swap_in_slot(cfg: ModelConfig, caches: dict, page_row, slot: int,
                 state: dict) -> dict:
    """Write a swapped-out state back at fresh pages / slot, in place."""
    if len(state.get("layers", ())) != len(caches["layers"]):
        raise ValueError("swap state does not have one entry per layer")
    for lc, st in zip(caches["layers"], state["layers"]):
        A.insert_paged_state(lc, page_row, slot, st)
    return caches


def extract_linear_totals(cfg: ModelConfig, caches: dict, slot: int) -> dict:
    """Every layer's per-slot state of one slot (device copies of the
    SLA2 totals; empty dicts for a dense stack): the snapshot a
    prefix-cache node keeps, so that a hit restores the slot without
    prefilling its prefix again."""
    return {"layers": [A.extract_slot_state(lc, slot)
                       for lc in caches["layers"]]}


def insert_linear_totals(cfg: ModelConfig, caches: dict, slot: int,
                         totals: dict) -> dict:
    """Write an ``extract_linear_totals`` snapshot back at ``slot`` in
    every layer, in place: the restore of a prefix-cache hit before
    chunked prefill resumes at the first uncached page."""
    layers = totals.get("layers", ())
    if len(layers) != len(caches["layers"]):
        raise ValueError("slot totals do not have one entry per layer")
    for lc, st in zip(caches["layers"], layers):
        missing = [k for k in A.SLOT_KEYS if k in lc and k not in st]
        if missing:
            raise ValueError(
                f"slot totals for a 'dense' layer must carry {missing} "
                f"leaves, got {sorted(st)}: snapshot taken from a "
                "different layer kind?")
        A.insert_slot_state(lc, slot, st)
    return caches


def copy_kv_page(cfg: ModelConfig, caches: dict, src: int, dst: int) -> dict:
    """Copy physical page ``src`` onto ``dst`` in every layer, in place:
    the engine's copy-on-write of a page shared through the prefix
    cache."""
    for lc in caches["layers"]:
        A.copy_paged_page(lc, src, dst)
    return caches


def _stack(params: LMParams, cfg: ModelConfig, x, caches, mix_fn):
    """Run the layers with ``mix_fn(layer_params, h, layer_state)`` ->
    (y, layer_state) as the attention body; returns (final-normed hidden,
    {"layers": the returned states})."""
    layers = []
    for lp, lc in zip(params.layers, caches["layers"]):
        y, lc = mix_fn(lp.attn, L.rmsnorm(lp.ln1, x), lc)
        layers.append(lc)
        x = x + y
        x = x + L.gated_mlp(lp.mlp, L.rmsnorm(lp.ln2, x))
    return L.rmsnorm(params.final_norm, x), {**caches, "layers": layers}


def prefill_chunk(params: LMParams, cfg: ModelConfig, tokens, caches, *,
                  page_row, offset: int, chunk_len: int, slot: int):
    """Prefill one chunk of one slot's prompt (tokens (1, C), padded).
    Returns (logits (1, V) at the last valid token, caches)."""
    acfg = cfg.attention_config()
    x = _embed(params, cfg, tokens)

    def mix_fn(ap, h, lc):
        return A.chunk_prefill_paged(ap, acfg, h, lc, page_row=page_row,
                                     offset=offset, chunk_len=chunk_len,
                                     slot=slot)

    x, caches = _stack(params, cfg, x, caches, mix_fn)
    last = x[:, int(chunk_len) - 1]
    return logits_from_hidden(params, cfg, last), caches


def decode_paged(params: LMParams, cfg: ModelConfig, token_t, caches, *,
                 page_table, lengths, active):
    """One decode step for the slot batch with per-slot offsets.
    token_t (B,) int; lengths (B,) tokens already cached per slot; active
    (B,) bool.  Returns (logits (B, V), caches)."""
    acfg = cfg.attention_config()
    x = _embed(params, cfg, token_t[:, None])

    def mix_fn(ap, h, lc):
        return A.decode_step_paged(ap, acfg, h, lc, page_table=page_table,
                                   lengths=lengths, active=active)

    x, caches = _stack(params, cfg, x, caches, mix_fn)
    return logits_from_hidden(params, cfg, x)[:, 0], caches


# ---------------------------------------------------------------------------
# Speculative decoding: verify window, commit, linear drafting
# ---------------------------------------------------------------------------

def decode_verify(params: LMParams, cfg: ModelConfig, tokens_w, caches, *,
                  page_table, lengths, active, window_len):
    """Decode a W-token window for the whole slot batch in one pass.
    tokens_w (B, W) int: row 0 is the last accepted token, rows 1.. the
    draft; window_len (B,) valid rows per slot.  Writes the window's K/V;
    the SLA2 block state waits for ``commit_window``.  Returns (logits
    (B, W, V), caches)."""
    acfg = cfg.attention_config()
    x = _embed(params, cfg, tokens_w)

    def mix_fn(ap, h, lc):
        return A.decode_window_paged(ap, acfg, h, lc, page_table=page_table,
                                     lengths=lengths, active=active,
                                     window_len=window_len)

    x, caches = _stack(params, cfg, x, caches, mix_fn)
    return logits_from_hidden(params, cfg, x), caches


def commit_window(cfg: ModelConfig, caches, page_table, lengths, accepted,
                  active, window: int):
    """Commit the accepted prefix of a verify window into every layer's
    block state (nothing to commit for ``mechanism="full"``)."""
    acfg = cfg.attention_config()
    for lc in caches["layers"]:
        A.commit_paged_window(acfg, lc, page_table=page_table,
                              lengths=lengths, accepted=accepted,
                              active=active, window=window)
    return caches


def draft_init(cfg: ModelConfig, caches, page_table, lengths, active):
    """Per-layer linear draft states (running phi(k) v totals over the
    whole cached prefix): ``{"layers": [{"h", "z"} of layer i]}``."""
    acfg = cfg.attention_config()
    return {"layers": [A.linear_draft_state(acfg, lc, page_table=page_table,
                                            lengths=lengths, active=active)
                       for lc in caches["layers"]]}


def draft_step(params: LMParams, cfg: ModelConfig, token_t, states, *,
               positions, active):
    """One draft decode step through the linear branch only (no page
    reads).  token_t (B,) int; positions (B,) the draft token's position.
    Returns (logits (B, V), states)."""
    acfg = cfg.attention_config()
    x = _embed(params, cfg, token_t[:, None])

    def mix_fn(ap, h, st):
        return A.linear_draft_attention(ap, acfg, h, st, positions=positions,
                                        active=active)

    x, states = _stack(params, cfg, x, states, mix_fn)
    return logits_from_hidden(params, cfg, x)[:, 0], states
