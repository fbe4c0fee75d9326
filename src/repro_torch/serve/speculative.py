"""Speculative-decoding drafters and rejection sampling.

Two drafters share one interface (``propose``) and one verify / commit
machinery in the engine (``Model.decode_verify`` over the multi-token
paged kernels or their gather references):

  * ``LinearDrafter``: self-speculative drafting for SLA2 stacks.  The
    linear branch keeps running ``phi(k) v`` totals per slot, so a pass
    through the linear branch alone reads no pages and costs O(Dh^2) per
    token and layer.  The drafter seeds per-layer totals from the
    committed cache (``Model.draft_init``) and advances a private copy
    token by token (``Model.draft_step``, an eager loop over the draft
    length).  The cache is never touched, so a rejected draft needs no
    rollback.
  * ``NGramDrafter``: model-free prompt lookup for stacks without a linear
    branch (``mechanism="full"``): the longest suffix n-gram of a slot's
    token history is matched against its most recent earlier occurrence,
    and the tokens that followed are proposed.  No device work per draft
    token; the dense verify window does all the model compute.

Acceptance is standard speculative rejection sampling
(``rejection_sample``); under greedy decoding it is exact argmax matching,
which keeps speculative serving token-identical to plain decode.  The
sampled paths draw from the engine's numpy generator in the reference's
order, so both packages make the same draws.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.quant import true_div


def greedy_accept(draft: np.ndarray, target: np.ndarray) -> int:
    """Length of the accepted draft prefix under greedy decoding: the
    leading draft tokens equal to the target's argmax at their position.
    draft (k,); target (>= k,) greedy target tokens per window row."""
    n = 0
    for d, t in zip(draft, target):
        if int(d) != int(t):
            break
        n += 1
    return n


def _softmax(logits: np.ndarray, temperature: float) -> np.ndarray:
    z = logits.astype(np.float64) / max(temperature, 1e-8)
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def rejection_sample(draft_tokens, draft_logits, target_logits, *,
                     temperature: float, rng: np.random.Generator):
    """Speculative acceptance for one slot's verify window.

    draft_tokens  (k,) proposed tokens
    draft_logits  (k, V) draft logits (None at temperature <= 0: greedy
                  acceptance never reads them)
    target_logits (k + 1, V); row i conditions on the prefix and the draft
                  tokens < i
    Returns ``(emitted, n_accepted)``: the tokens to emit, ending with one
    non-draft token (the resampled correction at the first rejection, or
    the bonus token of the last row when the whole draft is accepted).

    Greedy: accept while the draft token is the target's argmax.  Sampled:
    accept d_i with probability min(1, p_i(d_i) / q_i(d_i)); on rejection
    resample from normalize(max(p_i - q_i, 0))."""
    k = len(draft_tokens)
    if temperature <= 0:
        tgt = np.argmax(target_logits, axis=-1)
        n = greedy_accept(draft_tokens, tgt[:k])
        return [int(t) for t in draft_tokens[:n]] + [int(tgt[n])], n
    emitted = []
    for i in range(k):
        p = _softmax(target_logits[i], temperature)
        q = _softmax(draft_logits[i], temperature)
        d = int(draft_tokens[i])
        if rng.random() < min(1.0, p[d] / max(q[d], 1e-20)):
            emitted.append(d)
            continue
        res = np.maximum(p - q, 0.0)
        tot = res.sum()
        if tot <= 0.0:                  # p == q exactly: resample from p
            res, tot = p, p.sum()
        emitted.append(int(rng.choice(len(res), p=res / tot)))
        return emitted, i
    p = _softmax(target_logits[k], temperature)
    emitted.append(int(rng.choice(len(p), p=p)))
    return emitted, k


class LinearDrafter:
    """Batched linear-branch drafter over a ServeEngine's paged caches.

    ``propose`` seeds per-layer totals from the committed cache and rolls
    the model forward ``k`` tokens through the linear branch only.  The
    draft states live for one call."""

    def __init__(self, model, temperature: float = 0.0):
        if model.draft_init is None:
            raise ValueError(
                f"{model.cfg.name}: linear drafting requires an SLA2 "
                "attention stack (mechanism='sla2')")
        self.model = model
        self.temperature = float(temperature)

    def propose(self, params, caches, *, page_table, lengths, active,
                tokens0, k: int, rng: Optional[np.random.Generator] = None,
                history=None):
        """Draft ``k`` tokens for every active slot from its last accepted
        token (``tokens0``, at position ``lengths``; draft token i sits at
        ``lengths + i + 1``), on the device of the caches.  Returns numpy
        ``(draft_tokens (B, k), draft_logits (B, k, V))``; the logits are
        None at temperature 0, where acceptance never reads them.
        ``history`` belongs to the shared interface and is unused."""
        dev = caches["layers"][0]["k_pages"].device
        as_t = lambda x, dt: torch.as_tensor(np.asarray(x)).to(dtype=dt,
                                                               device=dev)
        lengths_t = as_t(lengths, torch.int64)
        active_t = as_t(active, torch.bool)
        b = int(np.asarray(tokens0).shape[0])
        gumbel = None
        if self.temperature > 0:
            if rng is None:
                raise ValueError("sampled drafting needs the engine's rng")
            gumbel = torch.from_numpy(rng.gumbel(
                size=(k, b, self.model.cfg.vocab_size))).to(
                    dtype=torch.float32, device=dev)
        toks, logits_all = [], []
        with torch.no_grad():
            st = self.model.draft_init(caches, {
                "page_table": as_t(page_table, torch.int32),
                "lengths": lengths_t, "active": active_t})
            tok = as_t(tokens0, torch.int64)
            for i in range(k):
                lg, st = self.model.draft_step(params, {
                    "token": tok, "positions": lengths_t + i,
                    "active": active_t}, st)
                if gumbel is not None:
                    tok = torch.argmax(true_div(lg, self.temperature)
                                       + gumbel[i], dim=-1)
                    logits_all.append(lg)
                else:
                    tok = torch.argmax(lg, dim=-1)
                toks.append(tok)
        d_toks = torch.stack(toks, 1).to(torch.int32).cpu().numpy()
        if gumbel is None:
            return d_toks, None
        return d_toks, torch.stack(logits_all, 1).cpu().numpy()


def ngram_propose(ctx, k: int, max_ngram: int) -> np.ndarray:
    """Propose ``k`` continuation tokens for a token history ``ctx`` by
    prompt lookup: match the longest suffix n-gram (n from ``max_ngram``
    down to 1) against its most recent earlier occurrence in ``ctx`` and
    return the tokens that followed it, padded by repeating the last
    token.  With no match the last token is repeated ``k`` times.
    Returns (k,) int32."""
    ctx = np.asarray(ctx, np.int32)
    out = np.full((k,), int(ctx[-1]), np.int32)
    for n in range(min(max_ngram, len(ctx) - 1), 0, -1):
        pat = ctx[-n:]
        wins = np.lib.stride_tricks.sliding_window_view(ctx, n)[:-1]
        hits = np.nonzero((wins == pat).all(axis=1))[0]
        if hits.size:
            start = int(hits[-1]) + n        # token right after the match
            cont = ctx[start:start + k]
            out[:len(cont)] = cont
            break
    return out


class NGramDrafter:
    """Model-free prompt-lookup drafter (``EngineConfig.speculative=
    'ngram'``), on the drafter interface of ``LinearDrafter``.  The draft
    logits are a near-one-hot distribution on the proposed token (the
    right ``q`` for a deterministic drafter), pre-scaled by
    ``max(1, temperature)`` since ``rejection_sample`` divides by the
    temperature; at temperature 0 they are None."""

    needs_history = True

    def __init__(self, vocab_size: int, max_ngram: int = 3,
                 temperature: float = 0.0, draft_logit: float = 50.0):
        self.vocab_size = int(vocab_size)
        self.max_ngram = int(max_ngram)
        self.temperature = float(temperature)
        self.draft_logit = float(draft_logit) * max(1.0, self.temperature)

    def propose(self, params, caches, *, page_table, lengths, active,
                tokens0, k: int, rng: Optional[np.random.Generator] = None,
                history=None):
        """Draft ``k`` tokens per active slot from ``history`` (per-slot
        token arrays, None for inactive slots).  The model and cache
        arguments belong to the shared interface and are unused.  Returns
        numpy ``(draft_tokens (B, k), draft_logits (B, k, V) or None)``."""
        if history is None:
            raise ValueError("NGramDrafter needs the slots' token history")
        b = int(np.asarray(tokens0).shape[0])
        toks = np.zeros((b, k), np.int32)
        logits = (np.zeros((b, k, self.vocab_size), np.float32)
                  if self.temperature > 0 else None)
        for s in range(b):
            if not active[s] or history[s] is None or len(history[s]) == 0:
                continue
            toks[s] = ngram_propose(history[s], k, self.max_ngram)
            if logits is not None:
                logits[s, np.arange(k), toks[s]] = self.draft_logit
        return toks, logits
