"""Small paged-attention states and serving scenarios shared by tests and
benchmarks.

``make_paged_attention_state`` drives the real chunked-prefill path
(``models/attention.chunk_prefill_paged``) to fill a multi-slot page pool
with ragged per-slot lengths: the fixture of fused-against-gather parity
checks, so that they all exercise one state layout.

``overcommit_workload`` builds the forced-preemption serving scenario: a
mixed-length (prompt, max_new) work list and a page-pool size below the
workload's worst-case concurrent page demand by an ``overcommit`` factor.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import attention as A


def overcommit_workload(*, max_slots: int, page_size: int,
                        overcommit: float = 2.0, n_requests: int = 12,
                        seed: int = 0) -> tuple:
    """A mixed-length work list whose concurrent worst-case page demand
    exceeds the returned pool size by about ``overcommit`` times.

    Returns ``(work, num_pages)``: (prompt_len, max_new_tokens) pairs (for
    ``make_mixed_requests``) and a pool size, the trash page included, at
    which ``max_slots`` concurrent requests need about ``overcommit`` times
    the usable pages, so the optimistic scheduler preempts and the
    conservative one serialises admission."""
    rng = np.random.default_rng(seed)
    work = []
    for _ in range(n_requests):
        # decode-heavy: sub-page prompts and 2-4 pages of decode, so page
        # demand grows during decode
        n_prompt = int(rng.integers(6, page_size))
        max_new = int(rng.integers(2, 5)) * page_size
        work.append((n_prompt, max_new))
    pages_per = [-(-(n + m) // page_size) for n, m in work]
    demand = sum(sorted(pages_per, reverse=True)[:max_slots])
    usable = max(max(pages_per), int(round(demand / overcommit)))
    return work, usable + 1


def make_paged_attention_state(hkv: int = 2, lengths=(37, 16, 70), *,
                               num_heads: int = 4, d_model: int = 64,
                               head_dim: int = 16, max_p: int = 8,
                               seed: int = 0, mechanism: str = "sla2",
                               sliding_window=None, kv_quant: str = "none",
                               device="cuda"):
    """(cfg, params, cache, page_table, x_t) for one attention layer on
    ``device``: per-slot prompts of ``lengths`` tokens prefilled in chunks
    of 32 into one f32 pool (trash page 0, pages handed out densely per
    slot) and a random decode-step input x_t (B, 1, d_model).
    ``mechanism`` 'full' builds the dense layer (optionally
    sliding-windowed); ``kv_quant`` the pool's storage ('none' | 'int8' |
    'fp8', codes with per-row scales)."""
    dev = resolve_device(device)
    cfg = A.AttentionConfig(
        d_model=d_model, num_heads=num_heads, num_kv_heads=hkv,
        head_dim=head_dim, mechanism=mechanism, block_q=32, block_k=16,
        k_frac=0.25, n_q_blocks=8, sliding_window=sliding_window,
        kv_quant=kv_quant)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params = A.init_attention(g, cfg, device=dev)
    b = len(lengths)
    pt = np.zeros((b, max_p), np.int32)
    alloc = 1
    for s, n in enumerate(lengths):
        for lg in range(n // cfg.block_k + 1):
            pt[s, lg] = alloc
            alloc += 1
    page_table = torch.as_tensor(pt, device=dev)
    cache = A.init_paged_cache(cfg, alloc + 2, b, dtype=torch.float32,
                               device=dev)
    x = torch.randn(b, 96, d_model, generator=g, device=dev) * 0.3
    with torch.no_grad():
        for s, n in enumerate(lengths):
            for off in range(0, n, 32):
                c = min(32, n - off)
                xi = torch.zeros(1, 32, d_model, device=dev)
                xi[:, :c] = x[s, off:off + c]
                _, cache = A.chunk_prefill_paged(
                    params, cfg, xi, cache, page_row=page_table[s],
                    offset=off, chunk_len=c, slot=s)
    x_t = torch.randn(b, 1, d_model, generator=g, device=dev) * 0.3
    return cfg, params, cache, page_table, x_t
