"""Step-level diffusion serving: continuous batching of DiT denoise steps.

The unit of scheduling is one denoise step over a request's whole latent;
every request declares ``n_steps`` up front, and its footprint is one
constant batch slot, so the scheduler is pure FCFS admission over free
slots with no preemption.

One ``DiffusionEngine.step()`` = admit into free slots + one batched
denoise dispatch advancing every active request by one Euler step of the
rectified-flow ODE; inactive slots are frozen.  Per-request constants
(text cross-attention K/V, the adaLN modulation table over the request's
schedule) are computed once at admission with batch-1 shapes.

``attn_impl``: ``'fused'`` runs the CUDA sparse-branch kernel, ``'gather'``
the plain PyTorch gathered tiles, ``'reference'`` the O(N^2) oracle, and
``'auto'`` resolves from the engine's own device: fused on cuda, gather on
cpu.  The host-side logic is numpy and Python; the slot arrays live on the
engine's device.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

ATTN_IMPLS = {"fused": "kernel", "gather": "gather", "reference": "ref"}


def resolve_attn_impl(attn_impl: str, device="cuda") -> str:
    """Resolve ``'auto'`` from the device the engine runs on: ``fused`` on
    cuda, ``gather`` on cpu.  Other values are validated and returned."""
    if attn_impl != "auto":
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {attn_impl!r}; one of "
                             f"{('auto', *ATTN_IMPLS)}")
        return attn_impl
    return "fused" if torch.device(device).type == "cuda" else "gather"


@dataclasses.dataclass
class VideoRequest:
    """One denoise request: noise latents (N, c_latent), text embedding
    (n_text, d_model) and a fixed step count.  ``output`` holds the final
    latents after exactly ``n_steps`` Euler steps."""
    uid: int
    latents: np.ndarray
    text: np.ndarray
    n_steps: int
    arrival: int = -1
    steps_done: int = 0
    t_submit: int = -1
    t_admit: int = -1
    t_finish: int = -1
    output: Optional[np.ndarray] = None


class StepScheduler:
    """FCFS admission over a fixed pool of batch slots, no preemption.
    Pure host logic."""

    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = max_slots
        self.waiting: deque = deque()
        self.active: Dict[int, VideoRequest] = {}
        self._clock = 0

    def submit(self, req: VideoRequest) -> None:
        """Stamp FCFS arrival order and enqueue."""
        req.arrival = self._clock
        self._clock += 1
        self.waiting.append(req)

    def admit(self) -> List[Tuple[int, VideoRequest]]:
        """Move waiting requests into free slots (FCFS, lowest slot first);
        returns the newly admitted (slot, request) pairs."""
        admitted = []
        free = [s for s in range(self.max_slots) if s not in self.active]
        while self.waiting and free:
            slot = free.pop(0)
            req = self.waiting.popleft()
            self.active[slot] = req
            admitted.append((slot, req))
        return admitted

    def advance(self, slots) -> List[Tuple[int, VideoRequest]]:
        """Credit one denoise step to each given slot; requests reaching
        ``n_steps`` leave the batch and are returned as (slot, request)."""
        finished = []
        for slot in slots:
            req = self.active[slot]
            req.steps_done += 1
            if req.steps_done >= req.n_steps:
                finished.append((slot, self.active.pop(slot)))
        return finished

    @property
    def idle(self) -> bool:
        """True when nothing is waiting or active."""
        return not self.waiting and not self.active


@dataclasses.dataclass(frozen=True)
class DiffusionEngineConfig:
    """``n_latent``: latent tokens every request carries; ``max_steps``:
    cap on per-request steps (sizes the modulation tables); ``mechanism``:
    self-attention override (None keeps the model's); ``attn_impl``: see
    the module docstring."""
    max_slots: int = 4
    n_latent: int = 64
    max_steps: int = 32
    mechanism: Optional[str] = None
    attn_impl: str = "auto"


def _timestep_schedule(n_steps: int, max_steps: int) -> np.ndarray:
    """t_i = 1 - i/n_steps, zero-padded to the static table length."""
    t = np.zeros((max_steps,), np.float32)
    i = np.arange(n_steps, dtype=np.float32)
    t[:n_steps] = 1.0 - i / n_steps
    return t


def _resolved_model(model, mechanism: Optional[str], attn_impl: str, device):
    """The model serving (mechanism, attn_impl) on ``device``."""
    mech = mechanism or model.cfg.mechanism
    impl = ATTN_IMPLS[resolve_attn_impl(attn_impl, device)]
    if (mech, impl) == (model.cfg.mechanism, model.cfg.sla2_impl):
        return model
    return model.with_overrides(mechanism=mech, sla2_impl=impl)


def _denoise_slots(model, params, lat, kv_k, kv_v, mods_b, mods_f, step_idx,
                   dt, active):
    """One batched Euler step; each row gathers its own modulation row and
    inactive rows keep their latents."""
    bi = torch.arange(lat.shape[0], device=lat.device)
    mods = {"blocks": mods_b[:, bi, step_idx], "final": mods_f[bi, step_idx]}
    x, _ = model.denoise(params, {"latents": lat, "dt": dt,
                                  "text_kv": (kv_k, kv_v), "mods": mods}, None)
    return torch.where(active[:, None, None], x, lat)


def _check_request(req: VideoRequest, mcfg, cfg: DiffusionEngineConfig):
    if req.n_steps < 1 or req.n_steps > cfg.max_steps:
        raise ValueError(f"request {req.uid}: n_steps={req.n_steps} "
                         f"outside [1, max_steps={cfg.max_steps}]")
    want_lat = (cfg.n_latent, mcfg.c_latent)
    want_text = (mcfg.n_text, mcfg.d_model)
    if tuple(req.latents.shape) != want_lat:
        raise ValueError(f"request {req.uid}: latents {req.latents.shape} "
                         f"!= {want_lat}")
    if tuple(req.text.shape) != want_text:
        raise ValueError(f"request {req.uid}: text {req.text.shape} "
                         f"!= {want_text}")


def _check_params(model, params, device):
    mcfg = model.cfg
    need = {"sla2": "sla2", "sla": "sla"}.get(mcfg.mechanism)
    if need and getattr(params.blocks[0], need) is None:
        raise ValueError(f"mechanism={mcfg.mechanism!r} needs the blocks' "
                         f"{need} params; init the model with that mechanism")
    pdev = next(params.parameters()).device
    if pdev != device and not (pdev.type == device.type == "cuda"
                               and device.index is None):
        raise ValueError(f"params live on {pdev}, the engine runs on {device}")


def _request_constants(model, params, req: VideoRequest, max_steps: int,
                       device):
    """Text K/V (batch 1) and the modulation table of one request."""
    text = torch.as_tensor(req.text, device=device)[None]
    kk, vv = model.precompute_text_kv(params, text)
    sched = torch.as_tensor(_timestep_schedule(req.n_steps, max_steps),
                            device=device)
    return kk, vv, model.precompute_step_mods(params, sched)


class DiffusionEngine:
    """Continuous step-level batching of DiT video denoise requests on one
    device.  One ``step()`` = FCFS admission into free slots + one batched
    denoise dispatch (SLA2 re-routes inside it, every step).  Constants
    are computed per request with batch-1 shapes, so batched outputs match
    sequential denoising row for row."""

    def __init__(self, model, params, cfg: DiffusionEngineConfig,
                 device="cuda"):
        if model.kind != "dit":
            raise ValueError(f"DiffusionEngine needs a dit model, got "
                             f"{model.kind!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = _resolved_model(model, cfg.mechanism, cfg.attn_impl,
                                     self.device)
        mcfg = self.model.cfg
        _check_params(self.model, params, self.device)
        if mcfg.mechanism != "full" and cfg.n_latent % mcfg.block_q:
            raise ValueError(f"n_latent={cfg.n_latent} must be a multiple "
                             f"of block_q={mcfg.block_q}")
        self.params = params
        self.scheduler = StepScheduler(cfg.max_slots)
        s, n, li = cfg.max_slots, cfg.n_latent, mcfg.n_layers
        h, dh, m, d = mcfg.num_heads, mcfg.head_dim, mcfg.n_text, mcfg.d_model
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=self.device)
        self._latents = z((s, n, mcfg.c_latent), torch.float32)
        self._kv_k = z((li, s, h, m, dh), mcfg.param_dtype)
        self._kv_v = z((li, s, h, m, dh), mcfg.param_dtype)
        self._mods_b = z((li, s, cfg.max_steps, 6 * d), torch.float32)
        self._mods_f = z((s, cfg.max_steps, 2 * d), torch.float32)
        self._dt = np.zeros((s,), np.float32)
        self._clock = 0
        self.stats = {"engine_steps": 0, "denoise_steps": 0,
                      "admitted": 0, "completed": 0, "occupancy_sum": 0}

    def submit(self, req: VideoRequest) -> None:
        """Validate and enqueue a request (FCFS)."""
        _check_request(req, self.model.cfg, self.cfg)
        req.t_submit = self._clock
        self.scheduler.submit(req)

    def _admit(self) -> None:
        for slot, req in self.scheduler.admit():
            req.t_admit = self._clock
            self._latents[slot] = torch.as_tensor(req.latents,
                                                  dtype=torch.float32)
            kk, vv, mods = _request_constants(
                self.model, self.params, req, self.cfg.max_steps, self.device)
            self._kv_k[:, slot] = kk[:, 0]
            self._kv_v[:, slot] = vv[:, 0]
            self._mods_b[:, slot] = mods["blocks"]
            self._mods_f[slot] = mods["final"]
            self._dt[slot] = 1.0 / req.n_steps
            self.stats["admitted"] += 1

    @torch.inference_mode()
    def step(self) -> List[VideoRequest]:
        """Admit + one batched denoise dispatch.  Returns the requests that
        completed their final step (``output`` filled, slot freed)."""
        self._admit()
        active_slots = sorted(self.scheduler.active)
        if not active_slots:
            return []
        s = self.cfg.max_slots
        active = np.zeros((s,), bool)
        step_idx = np.zeros((s,), np.int64)
        for slot in active_slots:
            active[slot] = True
            step_idx[slot] = self.scheduler.active[slot].steps_done
        dev = self.device
        self._latents = _denoise_slots(
            self.model, self.params, self._latents, self._kv_k, self._kv_v,
            self._mods_b, self._mods_f, torch.as_tensor(step_idx, device=dev),
            torch.as_tensor(self._dt, device=dev),
            torch.as_tensor(active, device=dev))
        self._clock += 1
        self.stats["engine_steps"] += 1
        self.stats["denoise_steps"] += len(active_slots)
        self.stats["occupancy_sum"] += len(active_slots)
        done = []
        finished = self.scheduler.advance(active_slots)
        if finished:
            lat = self._latents.cpu().numpy()     # one device->host copy
            for slot, req in finished:
                req.output = lat[slot].copy()
                req.t_finish = self._clock
                self.stats["completed"] += 1
                done.append(req)
        return done

    def run_to_completion(self, max_steps: int = 100_000,
                          livelock_after: int = 1_000) -> List[VideoRequest]:
        """Step until every submitted request completed; raises on livelock
        or when ``max_steps`` engine steps pass with work left."""
        finished: List[VideoRequest] = []
        stalled = 0
        while not self.scheduler.idle:
            if self.stats["engine_steps"] >= max_steps:
                raise RuntimeError(f"exceeded max_steps={max_steps}")
            done = self.step()
            finished.extend(done)
            progressed = bool(done) or bool(self.scheduler.active)
            stalled = 0 if progressed else stalled + 1
            if stalled > livelock_after:
                raise RuntimeError(
                    f"no progress for {livelock_after} engine steps "
                    f"({len(self.scheduler.waiting)} waiting)")
        return finished


@torch.inference_mode()
def denoise_sequential(model, params, requests,
                       cfg: Optional[DiffusionEngineConfig] = None,
                       device="cuda") -> Dict[int, np.ndarray]:
    """The exactness oracle: denoise each request alone, one batch-1
    dispatch per step, through the engine's cached-constants path.
    Returns {uid: final latents}."""
    cfg = cfg or DiffusionEngineConfig()
    dev = resolve_device(device)
    m = _resolved_model(model, cfg.mechanism, cfg.attn_impl, dev)
    _check_params(m, params, dev)
    out: Dict[int, np.ndarray] = {}
    for req in requests:
        _check_request(req, m.cfg, cfg)
        kk, vv, mods = _request_constants(m, params, req, cfg.max_steps, dev)
        mods_b, mods_f = mods["blocks"][:, None], mods["final"][None]
        lat = torch.as_tensor(req.latents, dtype=torch.float32,
                              device=dev)[None]
        dt = torch.full((1,), 1.0 / req.n_steps, dtype=torch.float32,
                        device=dev)
        active = torch.ones((1,), dtype=torch.bool, device=dev)
        for i in range(req.n_steps):
            lat = _denoise_slots(m, params, lat, kk, vv, mods_b, mods_f,
                                 torch.full((1,), i, device=dev), dt, active)
        out[req.uid] = lat[0].cpu().numpy()
    return out


def make_video_requests(n: int, model_cfg, *, n_latent: int, steps=(4, 8),
                        seed: int = 0) -> List[VideoRequest]:
    """Deterministic workload: ``n`` requests with cycling step counts,
    iid normal noise latents and text embeddings (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    return [VideoRequest(
        uid=i,
        latents=rng.standard_normal(
            (n_latent, model_cfg.c_latent)).astype(np.float32),
        text=rng.standard_normal(
            (model_cfg.n_text, model_cfg.d_model)).astype(np.float32),
        n_steps=int(steps[i % len(steps)])) for i in range(n)]
