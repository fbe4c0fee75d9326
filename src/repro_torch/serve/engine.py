"""Continuous-batching LM serving over a block-paged KV cache.

Requests join and leave mid-flight: every slot carries its own sequence
offset.  K/V lives in a pool of physical pages of ``block_k`` tokens on
the device, handed out by a free list (``PageAllocator``); a host-side
page table maps (slot, logical block) to a page (page 0 is the trash page
of masked writes).  Each engine step runs at most one ``prefill_chunk``
of one joining prompt and one decode dispatch for every decoding slot, so
long prompts interleave with decode.  The dispatch is one token per slot,
or with ``speculative`` a verify window: a drafter proposes ``draft_len``
tokens per slot (``serve/speculative.py``: the SLA2 linear branch, or
prompt lookup over the slot's tokens), one multi-token paged pass
verifies them, and only the accepted prefix is committed.  Greedy outputs
are token-identical to ``speculative="off"``.

Admission is optimistic by default: requests are admitted against the
pages actually outstanding and pages are mapped as sequences grow.  When
the pool runs dry, the ``Scheduler`` preempts the youngest slot: its pages
and SLA2 linear totals are swapped to host memory (``SwapPool``) when they
fit, else dropped and recomputed from the prompt and the tokens generated
so far (re-prefill, then the generated tokens fed back through decode).
Either way the request continues token-identically.  ``admission=
'conservative'`` reserves every request's worst case and never preempts.

The page table and the scheduler stay on the host; the pools, the model
and the sampling run on the device, and only the sampled ids are copied
back.  Greedy sampling is an argmax; with ``temperature > 0`` the Gumbel
noise comes from the engine's numpy generator, as in the reference, so
both engines draw the same tokens.

``StaticWaveEngine`` is the generation-wave baseline over the static
cache (one shared length: a wave is admitted only when every slot is
idle, its prompts left-padded with token 0 to one length, and drained
before the next), and ``generate_sequential`` the unbatched greedy oracle
on the same path.

Not ported yet (ROADMAP): the prefix cache and sharded serving raise
``ValueError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.quant import true_div
from repro_torch.models.attention import PAGE_KEYS
from repro_torch.serve.speculative import (LinearDrafter, NGramDrafter,
                                           greedy_accept, rejection_sample)

_POOL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Request:
    """One generation request: a prompt, a decode budget and the
    engine-filled output / accounting fields that survive preemption."""
    uid: int
    prompt: np.ndarray                 # (n,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    output: Optional[list] = None
    arrival: int = -1                  # FCFS priority (kept across preemption)
    n_preempt: int = 0
    t_submit: Optional[float] = None
    t_finish: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs (the reference's fields that the port serves)."""
    max_slots: int = 4
    max_len: int = 512                 # per-slot logical capacity
    prefill_chunk: int = 64            # tokens prefilled per engine step
    num_pages: Optional[int] = None    # pool size; default: worst case
    temperature: float = 0.0           # 0 => greedy
    seed: int = 0
    # model overrides (None keeps the model config): the paged attention
    # path ('fused' | 'gather' | 'auto'), the decode kernel's QAT tiles
    # ('none' | 'int8' | 'fp8') and the page-pool storage ('none' | 'int8'
    # | 'fp8', codes with per-row f32 scales)
    paged_impl: Optional[str] = None
    decode_quant_bits: Optional[str] = None
    kv_quant: Optional[str] = None
    page_dtype: Optional[str] = None   # unquantised pool dtype (bfloat16)
    admission: str = "optimistic"      # optimistic | conservative
    # host swap capacity in pages; None mirrors the device pool, 0 turns
    # swapping off (preemption then always recomputes)
    swap_pages: Optional[int] = None
    # speculative decoding: 'off' advances each slot by one token per
    # dispatch; 'linear' drafts draft_len tokens through the SLA2 linear
    # branch (mechanism='sla2' only); 'ngram' drafts by prompt lookup over
    # the slot's tokens (any stack).  A dispatch then verifies the window
    # in one pass and advances a slot by 1..draft_len+1 tokens.
    speculative: str = "off"
    draft_len: int = 3
    ngram_max: int = 3                 # longest suffix n-gram matched
    # not ported yet: anything but these defaults raises ValueError
    prefix_cache: bool = False
    mesh: Optional[Any] = None


def _sample_tokens(logits: torch.Tensor, temperature: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Greedy (temperature <= 0) or Gumbel-max sampling over (B, V) device
    logits; the argmax is taken on the device and only the ids come back.
    The Gumbel noise is drawn from the numpy generator, and summed in f64,
    as the reference samples."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
    z = torch.from_numpy(rng.gumbel(size=tuple(logits.shape))).to(
        logits.device)
    scores = true_div(logits.to(torch.float32), temperature).double() + z
    return torch.argmax(scores, dim=-1).to(torch.int32).cpu().numpy()


def make_mixed_requests(vocab_size: int, work, seed: int = 0,
                        uid0: int = 0) -> list:
    """Requests from a (prompt_len, max_new_tokens) work list."""
    rng = np.random.default_rng(seed)
    return [Request(uid=uid0 + i,
                    prompt=rng.integers(1, vocab_size, n).astype(np.int32),
                    max_new_tokens=m) for i, (n, m) in enumerate(work)]


class PageAllocator:
    """Free list over pages 1..num_pages-1 (page 0 is the trash page);
    freeing a page that is not allocated raises.  (The reference counts
    references per page for the prefix cache, which is not ported.)"""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))
        self._used = np.zeros(num_pages, bool)

    @property
    def available(self) -> int:
        """Pages currently free."""
        return len(self._free)

    def alloc(self) -> int:
        """One free page; raises when the pool is dry."""
        if not self._free:
            raise RuntimeError("page pool exhausted")
        page = self._free.pop()
        self._used[page] = True
        return page

    def free(self, pages) -> None:
        """Return pages to the free list; raises on a double free."""
        for p in pages:
            p = int(p)
            if not (0 < p < self.num_pages and self._used[p]):
                raise RuntimeError(f"double free of physical page {p}")
            self._used[p] = False
            self._free.append(p)


@dataclasses.dataclass
class _Slot:
    req: Request
    tokens: np.ndarray                 # prompt tokens to prefill
    pos: int = 0                       # tokens prefilled so far
    budget: int = 0                    # decode tokens still to produce
    last_token: int = 0
    decoding: bool = False
    n_pages: int = 0                   # physical pages currently mapped
    # recompute-resume: sampled tokens to feed back through decode (their
    # sampling is suppressed until the list drains), which rebuilds the
    # dropped cache by repeating the original computation
    replay: Optional[list] = None


@dataclasses.dataclass
class _ResumeState:
    """Where a preempted request left off; the evicted ``_Slot`` rides
    along (reset for replay in recompute mode, untouched in swap mode)."""
    mode: str                          # 'swap' | 'recompute'
    slot: _Slot
    length: int = 0                    # swap: tokens in the saved pages


class SwapPool:
    """Host memory for preempted slots' states, accounted in bytes.  The
    budget is ``capacity_pages`` reference (2-byte, unquantised) pages;
    ``configure_bytes`` sets the actual and reference page sizes, so a
    quantised pool's smaller pages pack more slots into the budget."""

    def __init__(self, capacity_pages: int):
        self.capacity_pages = max(0, int(capacity_pages))
        self.page_bytes = 1
        self.capacity_bytes = self.capacity_pages
        self.used_bytes = 0
        self._store: dict = {}         # arrival -> (n_pages, state)

    def configure_bytes(self, page_bytes: int, ref_page_bytes: int) -> None:
        """Fix the actual and the reference bytes of one page."""
        assert not self._store and self.used_bytes == 0
        self.page_bytes = max(1, int(page_bytes))
        self.capacity_bytes = self.capacity_pages * max(1,
                                                        int(ref_page_bytes))

    @property
    def capacity(self) -> int:
        """Capacity in actual pages."""
        return self.capacity_bytes // self.page_bytes

    @property
    def used(self) -> int:
        """Pages currently held."""
        return self.used_bytes // self.page_bytes

    @property
    def n_swapped(self) -> int:
        """Requests currently held."""
        return len(self._store)

    def can_hold(self, n_pages: int) -> bool:
        """True when n_pages more pages fit."""
        return (self.used_bytes + n_pages * self.page_bytes
                <= self.capacity_bytes)

    def put(self, key: int, n_pages: int, state) -> None:
        """Store one slot's state under the request's arrival id."""
        assert key not in self._store and self.can_hold(n_pages)
        self._store[key] = (n_pages, state)
        self.used_bytes += n_pages * self.page_bytes

    def pop(self, key: int):
        """Remove and return a stored state."""
        n_pages, state = self._store.pop(key)
        self.used_bytes -= n_pages * self.page_bytes
        return state


def _pool_page_bytes(caches: dict, reference: bool = False) -> int:
    """Bytes one physical page takes across every layer's page arrays.
    With ``reference`` the page is sized as an unquantised 2-byte pool
    holds it (scales dropped, 1-byte codes counted as 2 bytes)."""
    total = 0
    for lc in caches["layers"]:
        for name in PAGE_KEYS:
            if name not in lc:
                continue
            val = lc[name]
            item = val.element_size()
            if reference:
                if name.endswith("_scale"):
                    continue
                item = max(item, 2)
            total += val.numel() // val.shape[0] * item
    return total


def _to_host(state):
    if isinstance(state, dict):
        return {k: _to_host(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_to_host(v) for v in state]
    return state.to("cpu")


class Scheduler:
    """FCFS wait queue with preempt-last priority: a preempted request
    re-enters at its original arrival, so it resumes before anything that
    arrived after it.  Resume states wait in a side table keyed by
    arrival."""

    def __init__(self):
        self.waiting: list = []
        self._resume: dict = {}
        self._arrivals = 0

    def enqueue(self, req: Request) -> None:
        """Queue a new request, stamping its arrival."""
        req.arrival = self._arrivals
        self._arrivals += 1
        self.waiting.append(req)

    def requeue(self, req: Request, resume: _ResumeState) -> None:
        """Re-queue a preempted request at its arrival priority."""
        self._resume[req.arrival] = resume
        i = 0
        while i < len(self.waiting) and self.waiting[i].arrival < req.arrival:
            i += 1
        self.waiting.insert(i, req)

    def head(self) -> Optional[Request]:
        """The next request to admit, or None."""
        return self.waiting[0] if self.waiting else None

    def pop_head(self) -> Request:
        """Remove and return the queue head."""
        return self.waiting.pop(0)

    def peek_resume(self, req: Request) -> Optional[_ResumeState]:
        """A request's parked resume state, left in place."""
        return self._resume.get(req.arrival)

    def take_resume(self, req: Request) -> Optional[_ResumeState]:
        """Claim a request's parked resume state."""
        return self._resume.pop(req.arrival, None)

    def victim(self, slots: dict) -> int:
        """Preempt-last: the active slot with the newest arrival."""
        return max(slots, key=lambda s: slots[s].req.arrival)


class ServeEngine:
    """Mixed-length continuous batching over ``Model.prefill_chunk`` and
    ``Model.decode_paged`` on ``device`` (``cuda`` unless the caller asks
    for the CPU).  Call ``load(params)`` before submitting work."""

    def __init__(self, model, ecfg: EngineConfig, device="cuda"):
        if model.decode_paged is None:
            raise ValueError(f"{model.kind} has no paged serving path")
        for name, off in (("prefix_cache", False), ("mesh", None)):
            if getattr(ecfg, name) != off:
                raise ValueError(
                    f"EngineConfig.{name}={getattr(ecfg, name)!r} is not "
                    f"ported yet (ROADMAP); the port serves {name}={off!r}")
        if ecfg.admission not in ("optimistic", "conservative"):
            raise ValueError(f"unknown admission policy {ecfg.admission!r}")
        if ecfg.page_dtype is not None and ecfg.page_dtype not in _POOL_DTYPES:
            raise ValueError(f"page_dtype must be one of {list(_POOL_DTYPES)}")
        self.device = resolve_device(device)
        overrides = {
            k: v for k, v in (("paged_impl", ecfg.paged_impl),
                              ("decode_quant_bits", ecfg.decode_quant_bits),
                              ("kv_quant", ecfg.kv_quant))
            if v is not None and v != getattr(model.cfg, k)}
        if overrides:
            model = model.with_overrides(**overrides)
        self.model = model
        page = self.page_size = model.cfg.block_k
        self.chunk = max(page, (ecfg.prefill_chunk // page) * page)
        self.max_len = -(-ecfg.max_len // page) * page
        self.max_pages = self.max_len // page
        num_pages = ecfg.num_pages or ecfg.max_slots * self.max_pages + 1
        self.cfg = ecfg
        self.params = None
        self.caches = None
        self.allocator = PageAllocator(num_pages)
        self.scheduler = Scheduler()
        self.swap = SwapPool(num_pages - 1 if ecfg.swap_pages is None
                             else ecfg.swap_pages)
        self.stats = {"preemptions": 0, "swap_outs": 0, "swap_ins": 0,
                      "recomputes": 0, "spec_steps": 0, "spec_drafted": 0,
                      "spec_accepted": 0, "engine_steps": 0,
                      "prefill_tokens": 0, "prefill_chunks": 0,
                      "decode_steps": 0}
        self._slots: dict = {}                      # slot -> _Slot
        self._prefill_order: list = []              # FCFS chunked prefill
        self._page_table = np.zeros((ecfg.max_slots, self.max_pages),
                                    np.int32)
        self._lengths = np.zeros((ecfg.max_slots,), np.int32)
        self._rng = np.random.default_rng(ecfg.seed)
        self.completed: list = []
        if ecfg.speculative not in ("off", "linear", "ngram"):
            raise ValueError(f"unknown speculative mode {ecfg.speculative!r}")
        self._spec = ecfg.speculative != "off"
        self._drafter = None
        if self._spec:
            if ecfg.draft_len < 1:
                raise ValueError("draft_len must be >= 1")
            if ecfg.speculative == "linear":
                if model.draft_init is None:
                    raise ValueError(
                        "speculative='linear' requires an SLA2 attention "
                        f"stack (got mechanism={model.cfg.mechanism!r})")
                self._drafter = LinearDrafter(model, ecfg.temperature)
            else:
                self._drafter = NGramDrafter(model.cfg.vocab_size,
                                             max_ngram=ecfg.ngram_max,
                                             temperature=ecfg.temperature)

    # ------------------------------------------------------------------
    @property
    def _queue(self) -> list:
        return self.scheduler.waiting

    def load(self, params) -> None:
        """Install the params and allocate the page pools on the device."""
        self.params = params
        dtype = _POOL_DTYPES[self.cfg.page_dtype or "bfloat16"]
        self.caches = self.model.init_paged_caches(
            self.cfg.max_slots, self.allocator.num_pages, dtype=dtype,
            device=self.device)
        self.swap.configure_bytes(_pool_page_bytes(self.caches),
                                  _pool_page_bytes(self.caches,
                                                   reference=True))

    def submit(self, req: Request) -> None:
        """Validate and queue a request (it takes a slot at admission)."""
        n = len(req.prompt)
        if n == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        if n + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.uid}: {n}+{req.max_new_tokens} tokens exceed "
                f"max_len {self.max_len}")
        if -(-(n + req.max_new_tokens) // self.page_size) \
                > self.allocator.num_pages - 1:
            raise ValueError(
                f"request {req.uid}: needs more pages than the pool holds")
        req.output = []
        req.t_submit = time.perf_counter()
        self.scheduler.enqueue(req)

    # ------------------------------------------------------------------
    def _worst_pages(self, n_prompt: int, max_new: int) -> int:
        return min(self.max_pages,
                   -(-(n_prompt + max_new) // self.page_size))

    def _outstanding_pages(self) -> int:
        return sum(self._worst_pages(len(s.tokens), s.req.max_new_tokens)
                   - s.n_pages for s in self._slots.values())

    def _pages_needed_now(self, req: Request,
                          resume: Optional[_ResumeState]) -> int:
        """Pages a request needs to progress right after admission (the
        optimistic gate)."""
        if resume is not None and resume.mode == "swap":
            s = resume.slot
            if s.decoding and self._spec:
                # a verify step maps pages for its whole window up front
                blocks = (resume.length + self._window_len(s) - 1) \
                    // self.page_size + 1
                return max(s.n_pages, blocks)
            if s.decoding:
                boundary = resume.length % self.page_size == 0
                return s.n_pages + (1 if boundary else 0)
            # mid-prefill: the saved pages may already cover part of the
            # next chunk, so take the larger of the two, never the sum
            nxt = min(self.chunk, len(s.tokens) - s.pos)
            return max(s.n_pages, -(-(s.pos + nxt) // self.page_size))
        tokens = req.prompt if resume is None else resume.slot.tokens
        return -(-min(self.chunk, len(tokens)) // self.page_size)

    def _alloc_page(self, slot: int) -> Optional[int]:
        """One page off the free list, preempting the youngest slot while
        the pool is dry.  None if ``slot`` itself was preempted."""
        while self.allocator.available == 0:
            victim = self.scheduler.victim(self._slots)
            self._preempt(victim)
            if victim == slot:
                return None
        return self.allocator.alloc()

    def _ensure_page(self, slot: int, logical: int) -> bool:
        """Map (slot, logical) to a page; False if ``slot`` got preempted."""
        if self._page_table[slot, logical] != 0:
            return True
        page = self._alloc_page(slot)
        if page is None:
            return False
        self._page_table[slot, logical] = page
        self._slots[slot].n_pages += 1
        return True

    def _preempt(self, slot: int) -> None:
        """Evict a slot: swap its pages and totals to the host pool if they
        fit, else drop them and schedule recompute-from-prompt.  The
        request re-enters the queue at its original priority."""
        s = self._slots.pop(slot)
        if slot in self._prefill_order:
            self._prefill_order.remove(slot)
        row = self._page_table[slot].copy()
        self.stats["preemptions"] += 1
        s.req.n_preempt += 1
        if s.n_pages > 0 and self.swap.can_hold(s.n_pages):
            state = _to_host(self.model.swap_out(
                self.caches, row[:s.n_pages].copy(), slot))
            self.swap.put(s.req.arrival, s.n_pages, state)
            self.stats["swap_outs"] += 1
            resume = _ResumeState(mode="swap", slot=s,
                                  length=int(self._lengths[slot]))
        else:
            if s.n_pages > 0:
                self.stats["recomputes"] += 1
            if s.decoding:
                s.replay = list(s.req.output)
                s.decoding = False
            s.pos = 0
            s.n_pages = 0
            resume = _ResumeState(mode="recompute", slot=s)
        self.allocator.free(row[row > 0])
        self._page_table[slot] = 0
        self._lengths[slot] = 0
        self.scheduler.requeue(s.req, resume)

    def _swap_in(self, slot: int, req: Request,
                 resume: _ResumeState) -> None:
        """Restore a swapped-out request into ``slot`` on fresh pages."""
        s = resume.slot
        state = self.swap.pop(req.arrival)
        row = np.zeros((self.max_pages,), np.int32)
        for i in range(s.n_pages):
            row[i] = self.allocator.alloc()
        self.caches = self.model.swap_in(self.caches, row[:s.n_pages].copy(),
                                         slot, state)
        self.stats["swap_ins"] += 1
        self._page_table[slot] = row
        self._lengths[slot] = resume.length
        self._slots[slot] = s
        if not s.decoding:
            self._prefill_order.append(slot)

    def _start_slot(self, slot: int, req: Request,
                    resume: Optional[_ResumeState]) -> None:
        """Fresh prefill (or recompute replay) into an empty slot."""
        s = (_Slot(req=req, tokens=np.asarray(req.prompt, np.int32))
             if resume is None else resume.slot)
        self._slots[slot] = s
        self._lengths[slot] = 0
        self._prefill_order.append(slot)

    def _admit(self) -> None:
        free = [s for s in range(self.cfg.max_slots) if s not in self._slots]
        conservative = self.cfg.admission == "conservative"
        for slot in free:
            req = self.scheduler.head()
            if req is None:
                break
            if conservative:
                need = self._worst_pages(len(req.prompt), req.max_new_tokens)
                if self.allocator.available - self._outstanding_pages() \
                        < need:
                    break
            elif self.allocator.available < self._pages_needed_now(
                    req, self.scheduler.peek_resume(req)):
                break
            self.scheduler.pop_head()
            resume = self.scheduler.take_resume(req)
            if resume is not None and resume.mode == "swap":
                self._swap_in(slot, req, resume)
            else:
                self._start_slot(slot, req, resume)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return _sample_tokens(logits, self.cfg.temperature, self._rng)

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(dtype=dtype,
                                                 device=self.device)

    # ------------------------------------------------------------------
    def _prefill_step(self) -> None:
        """Run ONE chunk of the oldest joining prompt (if any)."""
        if not self._prefill_order:
            return
        slot = self._prefill_order[0]
        s = self._slots[slot]
        n_chunk = min(self.chunk, len(s.tokens) - s.pos)
        lo = s.pos // self.page_size
        hi = (s.pos + n_chunk - 1) // self.page_size
        for lg in range(lo, hi + 1):
            if not self._ensure_page(slot, lg):
                return                      # self-preempted; resumes later
        tokens = np.zeros((1, self.chunk), np.int32)
        tokens[0, :n_chunk] = s.tokens[s.pos:s.pos + n_chunk]
        batch = {"tokens": self._tensor(tokens),
                 "page_row": self._tensor(self._page_table[slot]),
                 "offset": s.pos, "chunk_len": n_chunk, "slot": slot}
        with torch.no_grad():
            logits, self.caches = self.model.prefill_chunk(
                self.params, batch, self.caches)
        s.pos += n_chunk
        self._lengths[slot] = s.pos
        self.stats["prefill_tokens"] += n_chunk
        self.stats["prefill_chunks"] += 1
        if s.pos == len(s.tokens):          # prompt done: first token
            self._prefill_order.pop(0)
            if s.replay:
                # recompute-resume: feed the already-sampled tokens back
                # through decode (the budget was kept at preemption)
                s.last_token = s.replay.pop(0)
                s.decoding = True
                return
            tok = int(self._sample(logits)[0])
            s.req.output.append(tok)
            s.last_token = tok
            s.budget = s.req.max_new_tokens - 1
            s.decoding = True
            if s.budget <= 0 or (s.req.eos_id is not None
                                 and tok == s.req.eos_id):
                self._finish(slot)

    def _emit(self, slot: int, tok: int) -> bool:
        """Record one generated token; False once the slot finished."""
        s = self._slots[slot]
        s.req.output.append(tok)
        s.last_token = tok
        s.budget -= 1
        if s.budget <= 0 or (s.req.eos_id is not None
                             and tok == s.req.eos_id):
            self._finish(slot)
            return False
        return True

    def _window_len(self, s: _Slot) -> int:
        """Valid rows of a slot's verify window: capped by the remaining
        budget, or in replay by the teacher-forced tokens left."""
        w = self.cfg.draft_len + 1
        if s.replay:
            return min(w, 1 + len(s.replay))
        return max(1, min(w, s.budget))

    def _decode_step(self) -> None:
        """One decode dispatch for every decoding slot: one token each, or a
        verify window with speculative decoding."""
        if self._spec:
            return self._decode_step_speculative()
        return self._decode_step_single()

    def _draft(self, tokens0, active):
        """Draft ``draft_len`` tokens per active slot with the configured
        drafter.  Returns numpy (tokens (B, k), logits (B, k, V) or
        None)."""
        history = None
        if getattr(self._drafter, "needs_history", False):
            history = [None] * self.cfg.max_slots
            for slot, s in self._slots.items():
                if active[slot]:
                    history[slot] = np.concatenate(
                        [s.tokens, np.asarray(s.req.output or [], np.int32)])
        return self._drafter.propose(
            self.params, self.caches, page_table=self._page_table,
            lengths=self._lengths, active=active, tokens0=tokens0,
            k=self.cfg.draft_len, rng=self._rng, history=history)

    def _decode_step_speculative(self) -> None:
        """One multi-token dispatch: draft, verify the window in one paged
        pass, commit only the accepted prefix (rejected rows' K/V lie
        beyond the committed length, where no read sees them).  Pages for
        each slot's whole window are mapped oldest slot first, so a dry
        pool preempts the youngest slots before their window is verified;
        they resume from their last committed state."""
        w = self.cfg.draft_len + 1
        dec = sorted((s for s, st in self._slots.items() if st.decoding),
                     key=lambda s: self._slots[s].req.arrival)
        ready = []
        for slot in dec:
            if slot not in self._slots:     # preempted by an older slot
                continue
            pos0 = int(self._lengths[slot])
            wlen = self._window_len(self._slots[slot])
            if all(self._ensure_page(slot, lg)
                   for lg in range(pos0 // self.page_size,
                                   (pos0 + wlen - 1) // self.page_size + 1)):
                ready.append(slot)
        if not ready:
            return
        tokens = np.zeros((self.cfg.max_slots, w), np.int32)
        wlens = np.zeros((self.cfg.max_slots,), np.int32)
        active = np.zeros((self.cfg.max_slots,), bool)
        draft_slots = []
        for slot in ready:
            s = self._slots[slot]
            wlen = self._window_len(s)
            tokens[slot, 0] = s.last_token
            wlens[slot] = wlen
            active[slot] = True
            if s.replay:
                tokens[slot, 1:wlen] = s.replay[:wlen - 1]
            elif wlen > 1:
                draft_slots.append(slot)
        d_logits = None
        if draft_slots:
            d_toks, d_logits = self._draft(tokens[:, 0], active)
            for slot in draft_slots:
                k_i = int(wlens[slot]) - 1
                tokens[slot, 1:1 + k_i] = d_toks[slot, :k_i]
        batch = {"tokens": self._tensor(tokens),
                 "page_table": self._tensor(self._page_table),
                 "lengths": self._tensor(self._lengths),
                 "active": self._tensor(active, torch.bool),
                 "window_len": self._tensor(wlens)}
        with torch.no_grad():
            logits, self.caches = self.model.decode_verify(
                self.params, batch, self.caches)
        self.stats["spec_steps"] += 1
        greedy = self.cfg.temperature <= 0
        # greedy acceptance needs only the argmax ids; sampled acceptance
        # reads the window's logits on the host
        target = (torch.argmax(logits, dim=-1).cpu().numpy() if greedy
                  else logits.cpu().numpy())

        # ---- acceptance on the host ----
        accepted = np.zeros((self.cfg.max_slots,), np.int32)
        plan = {}
        for slot in ready:
            s = self._slots[slot]
            wlen = int(wlens[slot])
            if s.replay:
                # teacher-forced rows are right by construction
                plan[slot] = ("replay", wlen - 1)
                accepted[slot] = wlen
                continue
            k_i = wlen - 1
            draft = tokens[slot, 1:1 + k_i]
            if greedy:
                n_acc = greedy_accept(draft, target[slot, :k_i])
                emitted = [int(t) for t in draft[:n_acc]] + [
                    int(target[slot, n_acc])]
            else:
                emitted, n_acc = rejection_sample(
                    draft, None if d_logits is None else d_logits[slot, :k_i],
                    target[slot, :k_i + 1], temperature=self.cfg.temperature,
                    rng=self._rng)
            plan[slot] = ("emit", emitted)
            accepted[slot] = n_acc + 1
            self.stats["spec_drafted"] += k_i
            self.stats["spec_accepted"] += n_acc

        # ---- commit the accepted prefixes, then advance the lengths ----
        with torch.no_grad():
            self.caches = self.model.commit_window(
                self.caches, self._tensor(self._page_table),
                self._tensor(self._lengths), self._tensor(accepted),
                self._tensor(active, torch.bool), w)
        for slot in ready:
            self._lengths[slot] += int(accepted[slot])

        # ---- emissions and replay bookkeeping ----
        for slot in ready:
            s = self._slots[slot]
            kind, payload = plan[slot]
            if kind == "replay":
                del s.replay[:payload]
                if s.replay:
                    s.last_token = s.replay.pop(0)
                else:
                    # the replay drained inside the window: the next real
                    # token comes from the last teacher-forced row
                    s.replay = None
                    self._emit(slot, int(self._sample(
                        logits[slot, payload][None])[0]))
            else:
                for t in payload:
                    if not self._emit(slot, t):
                        break

    def _decode_step_single(self) -> None:
        """One token for every decoding slot.  Pages are served oldest slot
        first, so a dry pool preempts the youngest slots, which drop out of
        this step and resume through the scheduler."""
        dec = sorted((s for s, st in self._slots.items() if st.decoding),
                     key=lambda s: self._slots[s].req.arrival)
        ready = []
        for slot in dec:
            if slot not in self._slots:     # preempted by an older slot
                continue
            if self._lengths[slot] % self.page_size == 0 and \
                    not self._ensure_page(
                        slot, int(self._lengths[slot]) // self.page_size):
                continue                    # self-preempted
            ready.append(slot)
        if not ready:
            return
        tokens = np.zeros((self.cfg.max_slots,), np.int32)
        active = np.zeros((self.cfg.max_slots,), bool)
        for slot in ready:
            tokens[slot] = self._slots[slot].last_token
            active[slot] = True
        batch = {"token": self._tensor(tokens),
                 "page_table": self._tensor(self._page_table),
                 "lengths": self._tensor(self._lengths),
                 "active": self._tensor(active, torch.bool)}
        with torch.no_grad():
            logits, self.caches = self.model.decode_paged(
                self.params, batch, self.caches)
        self.stats["decode_steps"] += 1
        tok = self._sample(logits)
        for slot in ready:
            st = self._slots[slot]
            self._lengths[slot] += 1        # the input token is cached
            if st.replay:
                # recompute catch-up: the real token was sampled before
                # preemption and is next in line
                st.last_token = st.replay.pop(0)
                continue
            self._emit(slot, int(tok[slot]))

    def _finish(self, slot: int) -> None:
        self.allocator.free(self._page_table[slot][
            self._page_table[slot] > 0])
        self._page_table[slot] = 0
        self._lengths[slot] = 0
        req = self._slots.pop(slot).req
        req.t_finish = time.perf_counter()
        self.completed.append(req)
        if slot in self._prefill_order:
            self._prefill_order.remove(slot)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine step: admit, one prefill chunk, one decode dispatch.
        Returns the number of occupied slots; steps with work are counted
        in ``stats['engine_steps']``."""
        if self._slots or self._queue:
            self.stats["engine_steps"] += 1
        self._admit()
        self._prefill_step()
        self._decode_step()
        return len(self._slots)

    def run_to_completion(self, max_steps: int = 10_000,
                          livelock_after: int = 50) -> list:
        """Step until every submitted request has drained.  Raises
        RuntimeError when ``max_steps`` runs out with work left, or when
        ``livelock_after`` consecutive steps change nothing observable
        while slots are occupied."""
        stalled, last_sig = 0, None
        for _ in range(max_steps):
            if self.step() == 0 and not self._queue:
                return self.completed
            sig = (len(self.completed), len(self.scheduler.waiting),
                   self.stats["preemptions"], self.stats["swap_ins"],
                   self.stats["prefill_tokens"],
                   tuple(int(x) for x in self._lengths),
                   sum(len(s.req.output or ())
                       for s in self._slots.values()))
            if sig == last_sig and self._slots:
                stalled += 1
                if stalled >= livelock_after:
                    raise RuntimeError(
                        f"engine livelock: {stalled} consecutive steps made "
                        f"no progress with {len(self._slots)} occupied "
                        f"slot(s) and {len(self._queue)} waiting request(s)")
            else:
                stalled, last_sig = 0, sig
        if self._slots or self._queue:
            raise RuntimeError(
                f"run_to_completion: max_steps={max_steps} exhausted with "
                f"{len(self._slots)} active slot(s) and {len(self._queue)} "
                f"waiting request(s)")
        return self.completed


# ===========================================================================
# Static generation-wave engine (the paged engine's baseline)
# ===========================================================================

class StaticWaveEngine:
    """Static-shape batched decode over ``Model.prefill`` / ``Model.decode``
    on ``device`` (``cuda`` unless the caller asks for the CPU).

    All slots share one cache with a single sequence offset, so requests
    join only at sequence start: a wave is admitted when every slot is
    idle, each prompt left-padded with token 0 (the pad tokens stay
    visible to attention, so outputs depend on the wave's composition) to
    one length, a multiple of ``block_q``, and the wave drains before the
    next admission.  The caches are bf16, as the reference's."""

    def __init__(self, model, ecfg: EngineConfig, device="cuda"):
        if model.prefill is None:
            raise ValueError(f"{model.kind} has no static cache path")
        self.model = model
        self.cfg = ecfg
        self.device = resolve_device(device)
        self.params = None
        self._queue: list = []
        self._active: dict = {}                   # slot -> request
        self._tokens = np.zeros((ecfg.max_slots,), np.int32)
        self._budget = np.zeros((ecfg.max_slots,), np.int32)
        self.caches = None
        self._rng = np.random.default_rng(ecfg.seed)
        self.completed: list = []
        self.stats = {"engine_steps": 0}

    def load(self, params) -> None:
        """Install the params (the caches are made anew for every wave)."""
        self.params = params
        self.caches = None

    def _padded(self, n: int) -> int:
        bq = self.model.cfg.block_q
        return max(bq, -(-n // bq) * bq)

    def submit(self, req: Request) -> None:
        """Validate and queue a request for the next wave."""
        n = len(req.prompt)
        if n == 0:
            raise ValueError(f"request {req.uid}: empty prompt")
        n_pad = self._padded(n)
        if n_pad + req.max_new_tokens > self.cfg.max_len:
            raise ValueError(
                f"request {req.uid}: padded prompt {n_pad} + "
                f"{req.max_new_tokens} new tokens exceed max_len "
                f"{self.cfg.max_len}")
        req.output = []
        self._queue.append(req)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return _sample_tokens(logits, self.cfg.temperature, self._rng)

    def _admit(self) -> None:
        """Admit a wave of up to max_slots queued requests, cut FCFS where
        the shared padding would push a member's decode past max_len, and
        prefill it jointly."""
        if self._active or not self._queue:
            return
        wave: list = []
        n_pad = 0
        while self._queue and len(wave) < self.cfg.max_slots:
            cand_pad = max(n_pad, self._padded(len(self._queue[0].prompt)))
            if any(cand_pad + r.max_new_tokens > self.cfg.max_len
                   for r in wave + [self._queue[0]]):
                break
            n_pad = cand_pad
            wave.append(self._queue.pop(0))
        prompt = np.zeros((self.cfg.max_slots, n_pad), np.int32)
        for slot, req in enumerate(wave):
            prompt[slot, n_pad - len(req.prompt):] = req.prompt
        self.caches = None                      # free the last wave's first
        self.caches = self.model.init_caches(
            self.cfg.max_slots, self.cfg.max_len, device=self.device)
        with torch.inference_mode():
            logits, self.caches = self.model.prefill(
                self.params, {"tokens": torch.as_tensor(
                    prompt, device=self.device)}, self.caches)
        tok = self._sample(logits)
        for slot, req in enumerate(wave):
            t = int(tok[slot])
            req.output.append(t)
            if req.max_new_tokens <= 1 or (req.eos_id is not None
                                           and t == req.eos_id):
                self.completed.append(req)
                continue
            self._tokens[slot] = t
            self._budget[slot] = req.max_new_tokens - 1
            self._active[slot] = req

    def step(self) -> int:
        """Admit a wave if idle, then one decode step of every slot.
        Returns the number of active slots."""
        if self._active or self._queue:
            self.stats["engine_steps"] += 1
        self._admit()
        if not self._active:
            return 0
        with torch.inference_mode():
            logits, self.caches = self.model.decode(
                self.params, {"token": torch.as_tensor(
                    self._tokens, device=self.device)}, self.caches)
        tok = self._sample(logits)
        done = []
        for slot, req in self._active.items():
            t = int(tok[slot])
            req.output.append(t)
            self._budget[slot] -= 1
            if self._budget[slot] <= 0 or (req.eos_id is not None
                                           and t == req.eos_id):
                done.append(slot)
            else:
                self._tokens[slot] = t
        for slot in done:
            self.completed.append(self._active.pop(slot))
        return len(self._active)

    def run_to_completion(self, max_steps: int = 10_000) -> list:
        """Step until every submitted request has drained (or max_steps)."""
        for _ in range(max_steps):
            if self.step() == 0 and not self._queue:
                break
        return self.completed


def generate_sequential(model, params, prompt: np.ndarray, *,
                        max_new_tokens: int, max_len: int,
                        eos_id: Optional[int] = None, cache_dtype=None,
                        device="cuda") -> list:
    """Unbatched greedy decode through the static cache: one
    ``model.prefill`` over the whole prompt, then ``model.decode`` a token
    at a time, on ``device``.  ``cache_dtype`` ('float32' | 'bfloat16',
    default bfloat16) sets the cache's element type: pass 'float32' with
    ``EngineConfig(page_dtype='float32')`` so that the paged engine and
    this oracle store the same values."""
    dev = resolve_device(device)
    dtype = _POOL_DTYPES[cache_dtype or "bfloat16"]
    caches = model.init_caches(1, max_len, dtype=dtype, device=dev)
    with torch.inference_mode():
        logits, caches = model.prefill(
            params, {"tokens": torch.as_tensor(prompt[None], device=dev)},
            caches)
        out = [int(torch.argmax(logits[0]))]
        while len(out) < max_new_tokens and out[-1] != eos_id:
            logits, caches = model.decode(
                params, {"token": torch.tensor([out[-1]], dtype=torch.int32,
                                               device=dev)}, caches)
            out.append(int(torch.argmax(logits[0])))
    return out
