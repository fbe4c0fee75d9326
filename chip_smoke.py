#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line when any fails, when no CUDA card is visible, or when it is
run outside a checkout of the repository; each prints its wall time):

 1. device   the card's name and power limit (nvidia-smi);
 2. build    every CUDA source in src/repro_torch/csrc, one nvcc each,
             all started together; registers, spills and shared memory
             of the tensor-core and split kernels (paged prefill, dense
             and SLA2 split decode and their combines, the DiT forward's
             pre-pass and main kernel, the backward's dQ and dK/dV);
 3. kernel   full-width wan-dit-1.3b (random weights from a seed, with the
             zero-initialised adaLN / output tensors filled with seeded
             N(0, 0.02^2)); layer 0's q, k, v of one 32768-token request
             and its routing go through sparse_flash_fwd (CUDA) and its
             plain PyTorch version on the card (int8, bf16, BH = 12); then a
             sweep over quant x causal x prefix_len x kv_len x dtype; then
             CUDA-event timings at BH = 12 and 24 beside the time before
             its redesign, the plain version, the operations bound and the gathered-bytes
             floor (a K and V code tile per valid routed pair, plus the
             int8 pre-pass);
 4. serve    DiffusionEngine(attn_impl="fused", n_latent=32768,
             max_slots=2) at full width serves 3 requests (2, 3, 2 steps,
             the third joining after the first step); every launch count
             of the path is set to 0 just before and read just after;
 5. context  the same config at 2 layers: one request of 2 steps through
             the fused and the gather engine, relative norm error < 0.05;
 6. bwd      the backward kernels (sla2_bwd.cu: dQ, dK/dV; bf16 on
             tensor cores, f32 on CUDA cores) against their plain version
             on layer 0's q, k, v and routing of one 32768-token request,
             with o and lse from the int8 forward kernel and a seeded bf16
             dO (relative max error <= 2^-7), and the distribution of the
             dK/dV run lengths there (valid pairs per kv block); a sweep
             over causal x prefix_len x f32/bf16 with invalid padding
             entries, unselected kv blocks and a hot kv block that every
             query block routes (1e-4 f32, 2^-7 bf16); autograd through
             the kernel-mode op against a dense softmax oracle (f32, 1e-4);
             CUDA-event times at BH = 12 (a loop of 5 launches, as in PRs
             13-16, beside PR 16's times) beside the plain version, the
             bounds on the bf16 tensor-core and f32 CUDA-core peaks and
             the gathered-bytes floor (a tile read per routed pair);
 7. train    make_train_step at full width and depth (int8 QAT forward,
             32768 latents), 3 optimizer steps of 2 microbatches of one
             video (cut from the global batch of 64); every launch count of
             the path is set to 0 just before and read just after; finite
             losses, a finite non-zero gradient on every leaf but the
             router's (hard Top-k routing gives it none);
 8. train-context  the same config at 2 layers, quant none: loss and
             gradient through the kernels against the gather path (relative
             loss error < 1e-2, gradient norm error < 0.05); then Trainer
             for 2 steps with a checkpoint each step, restored bitwise by a
             fresh Trainer;
 9. stage1   run_stage1 at the model's head geometry (12 x 128) on 4096
             synthetic tokens: finite losses, hard-Top-k MSE lowered;
10. lm-kernel qwen3-14b at full width and depth (random weights from a
             seed), once the DiT phases have freed their memory: layer 0's
             decode inputs (routed pages, totals, alpha) and a mid-prompt
             prefill chunk, captured from a short 4-slot prefill, go
             through the paged kernels (sla2_decode_paged.cu: sla2_decode;
             paged_prefill.cu) and their plain versions; then a sweep over
             quant_bits x kv_quant x n_rep x W (decode) and offset x window
             x prefix_len x kv_quant (prefill at offsets 0, 1024 and 7680,
             the largest error logged); CUDA-event times beside the
             plain versions, the bounds and, for prefill at offsets 1024
             and 7680, SDPA over the gathered K/V; sla2_decode timed as a
             loop of calls and from a CUDA graph, beside the time before
             its redesign;
11. lm-serve ServeEngine(max_slots=4, max_len=32768, prefill_chunk=512,
             paged_impl="fused") serves four seeded prompts of 8192, 3000,
             1000 and 200 tokens, 32 new tokens each, the fourth submitted
             after the first decode dispatch; every launch count is set to
             0 just before and read just after (prefill launches = 40 x
             chunks, decode launches = 40 x decode dispatches);
12. lm-context the same config at 2 layers, f32 weights and pages: fused
             and gather engines on the same prompts (the fused engine's
             tokens fed to both): logits within a relative norm error of
             1e-3, greedy tokens identical;
             then a pool too small for all slots, once with swapping and
             once without: a swap-out and a recompute, the same tokens;
13. lm-spec  the lm-serve model, weights and prompts with speculative=
             "linear", draft_len=3 (the SLA2 linear drafter): launches
             sla2_decode = 40 x verify dispatches, prefill 40 x chunks;
             greedy tokens equal lm-serve's (a request may stop being
             compared only where lm-serve's top-2 logit margin is below
             the bf16 resolution of its logit); layer 0's first W = 4
             verify call of a full batch against its plain version, timed
             as a loop of calls and from a CUDA graph;
14. lm-dense-kernel  a mechanism="full" qwen3-14b sharing every tensor of
             the SLA2 weights but the sla2 leaves: layer 0's dense decode
             inputs and a W = 4 verify window (n-gram drafts), captured
             from short 4-slot prefills, through dense_decode
             (sla2_decode_paged.cu) and its plain version; a sweep over
             quant_bits x kv_quant x W x window x prefix_len x n_rep with
             a fully masked slot; CUDA-event times at the lm-serve context
             lengths (B 4, W 1 and 4, with the pages per split of each
             slot; kernel and SDPA timed both as a loop of calls and as
             calls replayed from a CUDA graph, since the wrapper's host
             time per call can exceed the kernel's) beside the plain
             version, the bytes bound and SDPA over the gathered K/V;
15. lm-dense-serve  the dense model through the lm-serve engine and
             prompts, speculative="off" (launches dense_decode = 40 x
             decode dispatches) and then "ngram", draft_len=3 (40 x verify
             dispatches; tokens held to the off run's as in lm-spec);
16. lm-spec-context  2 layers, f32 weights and pages, both mechanisms:
             speculative fused and gather engines (linear for SLA2, ngram
             for full; the gather engine fed the fused drafts): verify
             logits within 1e-3 relative norm error, greedy tokens equal
             to each other and to speculative="off"; a too-small pool with
             and without swap gives the same tokens;
17. lm-static the lm-serve weights (40 layers), sla2_impl="kernel", int8
             QAT, on the static cache: StaticWaveEngine(max_slots=4) serves
             the lm-serve prompts as one wave left-padded to 8192 (32 new
             tokens each; sparse_flash_fwd launches = 40, the wave
             prefill's); layer 0's causal prefill (B 1, N 8192, K/V
             repeated to 40 heads) through sparse_flash_fwd and its plain
             version, timed beside the operations bound over the valid
             routed pairs and the gathered-bytes floor; then the dense
             model on the static cache against lm-dense-serve on the
             8192-token prompt: generate_sequential's tokens and where
             they first depart from lm-dense-serve's are logged, and fed
             lm-dense-serve's tokens, the static path's logits stay within
             a relative norm error of 0.05 at every position and pick
             another token only where lm-dense-serve's top-2 margin is
             below the largest logit difference there (two valid bf16
             attention implementations land about 2% apart through 40
             random layers: compare_tokens' one-ulp allowance cannot hold
             them; the paged gather engine's first logits are logged
             beside, for the same spread);
18. lm-static-context  2 layers, f32 weights and caches: SLA2 prefill
             logits of sla2_impl "kernel" and "gather" (quant none) within
             1e-3 relative norm; the dense model's generate_sequential gives
             the paged ServeEngine's tokens exactly; 'sla' and
             'sparse_only' serve through StaticWaveEngine with finite
             logits;
19. lm-train make_train_step on qwen3-14b at full width, depth cut from 40
             to 2 layers and the global batch to 2 sequences of 8192 tokens
             (to fit the card's 80 GB): int8 QAT forward through the
             kernels, remat "full", 3 AdamW steps of 2 microbatches; every
             launch count set to 0 before and read after (forward 2 x
             layers x microbatches x steps, dQ and dK/dV 1 x); finite
             losses, a finite non-zero gradient on every leaf but the
             router's; layer 0's causal dQ and dK/dV (BH 40, N 8192)
             against their plain version (2^-7), with the dK/dV run
             lengths, timed beside phase 6's bounds;
20. lm-train-context  2 layers, quant none: loss and gradient through the
             kernels against the gather path (loss 1e-2, gradient norm
             0.05); Trainer for 2 steps with a checkpoint each step
             (1024-token sequences, bf16 AdamW moments: 13 GB a
             checkpoint), restored bitwise by a fresh Trainer;
21. dit-baselines wan-dit-1.3b at full width, 2 layers: fuse_branches
             against the two-pass gather at 32768 latents, f32 weights
             (relative norm 1e-4 at quant none, 0.05 at int8) with the ms
             of each engine step; 'sla' and 'sparse_only' (int8) at 4096 latents (cut from
             32768: their dense-masked O(N^2) scores would take 103 GB a
             layer at 2 slots) serve one request of 2 steps, finite and
             within 1e-3 relative norm of the same engine and weights on
             the CPU, f32 on both.
22. lm-prefix qwen3-14b at full width and depth (the lm-serve weights,
             engine and geometry) with prefix_cache off, then on: three
             seeded 4096-token system prompts (64 pages, 8 chunks), 12
             requests round-robin over them with seeded 16-512-token
             suffixes, requests 3, 7 and 11 exact copies of their bare
             system prompt; requests 0-2 served to completion first, then
             the other 9 together, 16 new tokens each.  First-token logits
             bit-equal off / on, greedy tokens under compare_tokens' rule,
             hits 9, cow_copies 24, evictions 0, the prefill tokens the
             prompts give, the pool's refcount invariants after each run,
             every count set to 0 before and read after each run (40
             launches a chunk and a dispatch); time to first token, ms per
             chunk and dispatch, peak pages mapped and allocated, the
             totals snapshots' bytes and copy time, peak memory;
23. lm-prefix-dense  the same traffic with 6 requests (one exact copy) on
             the dense model of phase 14 (no totals snapshots; hits 3,
             cow_copies 8);
24. lm-prefix-context  2 layers, f32 weights and pages, the linear
             drafter on: two 1536-token system prompts cached, then three
             requests on the first under a pool of 57 pages, with and
             without swap: LRU evictions and preemptions of slots holding
             shared pages, the invariants after every step, no verify
             window on a shared page, tokens identical to a cache-off run;
25. lm-internlm2  internlm2-20b at full width and depth (48 layers, 48
             query / 8 KV heads: n_rep 6, random weights from the seed),
             after the qwen3 weights are freed: layer 0's sla2_decode (W 1,
             and W 4 from the linear drafter), dense_decode (W 1, and W 4
             from the n-gram drafter, on the dense model of the same
             tensors) and paged_prefill (offset 1024, and the 8192-token
             prompt's last chunk) against their plain versions and timed
             beside their bounds and SDPA; the lm-serve traffic at max_len
             16384 (cut from 32768 to fit the weights and pool) through
             the fused engine (48 launches a chunk and a dispatch) and the
             gather engine, tokens under compare_tokens' rule.

Phases run in the order 1-4, 6, 5, 7-11, 13-15, 22, 23, 12, 16, 24, 17,
25, 18-21.
The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"
N_LAT = 32768
SEED = 0
PEAK_INT8_OPS = 1979e12     # H100 SXM dense int8, NVIDIA data sheet
PEAK_BF16_OPS = 989e12      # H100 SXM dense bf16 tensor cores
PEAK_F32_OPS = 67e12        # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
TRAIN_STEPS = 3
MICROBATCHES = 2            # one video each: global batch 2, not 64
STAGE1_N = 4096
BOUNDS = {"none": 2e-5, "int8": 1e-3, "fp8": 1e-2}   # relative max error
LM_PROMPTS = (8192, 3000, 1000, 200)    # lm-serve prompt lengths
LM_NEW = 32                 # new tokens per request
LM_MAX_LEN = 32768
LM_CHUNK = 512
LM_SLOTS = 4
LM_CAPTURE = (2048, 1920, 1792, 1664)   # lm-kernel's short prefill
LM_TRAIN_N = 8192           # lm-train sequence length
LM_TRAIN_LAYERS = 2         # lm-train depth: 40 cut to 2 to fit 80 GB
LM_CKPT_N = 1024            # lm-train-context's Trainer sequences
PREFIX_SYS = 4096           # lm-prefix system prompts: 64 pages, 8 chunks
PREFIX_NEW = 16             # lm-prefix new tokens per request
INTERN_MAX_LEN = 16384      # lm-internlm2: cut from 32768 to fit 80 GB
BASELINE_N_LAT = 4096       # sla / sparse_only latents: O(N^2), cut from 32768
BF16_TWO_ULPS = 2 ** -7


def log(*args):
    print(*args, flush=True)


REPORT_KERNELS = ("prefill_tc_kernel", "prefill_f32_kernel",
                  "dense_split_kernel", "dense_combine_kernel",
                  "dense_decode_kernel", "sla2_bwd_dq_tc", "sla2_bwd_dkv_tc",
                  "sla2_fwd_int8_mma", "sla2_fwd_quant_kv",
                  "sla2_decode_split_kernel", "sla2_decode_combine_kernel")
PR16_BWD_MS = {"dq": 23.639, "dkv": 33.421}   # chip_smoke.py, PR 16, H100 700 W
# Times of these kernels before their redesign (the forward quantising K
# and V per routed pair, the SLA2 decode one block per row), chip_smoke.py
# on an H100 80GB HBM3 at 700 W; quoted in the log text only, never in the
# kernels line
PRIOR_MS = {"fwd": {12: 9.036, 24: 17.560}, "decode": 0.4047,
            "decode_w4": 0.4733}


def kernel_resources(report):
    """{kernel: 'N registers, spills, static smem'} from ptxas -v, the
    names demangled by c++filt where the machine has it."""
    import re
    import shutil
    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = []
        elif cur and ("spill" in line or "registers" in line):
            out[cur].append(line.split(":", 1)[-1].strip())
    names = list(out)
    if names and shutil.which("c++filt"):
        shown = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        names = [n.replace("(anonymous namespace)::", "") for n in shown]
    return {n: "; ".join(v) for n, v in zip(names, out.values())}


def log_kernel_smem():
    """Dynamic shared memory per block of the tensor-core and split
    kernels: the paged ones at qwen3-14b's shapes (Dh 128, pages of 64
    rows, a bf16 pool, n_rep 5), the DiT forward and backward at their
    main tiling (d 128, bq 128, bk 64)."""
    import ctypes

    from repro_torch.kernels.build import load_library
    pre = load_library("paged_prefill").paged_prefill_smem
    dense = load_library("sla2_decode_paged").dense_split_smem
    dsplit = load_library("sla2_decode_paged").sla2_decode_split_smem
    bwd = load_library("sla2_bwd")
    for fn in (pre, dense, dsplit):
        fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    fwd = load_library("sla2_fwd").sla2_fwd_int8_smem
    fwd.argtypes, fwd.restype = [ctypes.c_int] * 3, ctypes.c_int
    log(f"[build] sla2_fwd_int8_mma at d 128, bq 128, bk 64: "
        f"{fwd(128, 128, 64)} bytes of dynamic shared memory")
    for name in ("sla2_bwd_dq_smem", "sla2_bwd_dkv_smem"):
        fn = getattr(bwd, name)
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
        log(f"[build] {name[:-5]}_tc at d 128, bq 128, bk 64: "
            f"{fn(128, 128, 64)} bytes of dynamic shared memory")
    log(f"[build] sla2_decode_split_kernel at n_rep 5: "
        f"{dsplit(5, 64, 128, 2)} bytes of dynamic shared memory")
    for off in (2 * LM_CHUNK, LM_PROMPTS[0] - LM_CHUNK):
        n_pg = -(-(off + LM_CHUNK) // 64)
        log(f"[build] prefill_tc_kernel at offset {off}: "
            f"{pre(128, 64, 2, n_pg)} bytes of dynamic shared memory")
    for w in (1, 4):
        log(f"[build] dense_split_kernel at W {w}: "
            f"{dense(5 * w, 64, 128, 2)} bytes of dynamic shared memory")


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps=20, iters=5):
    """Device time of one call of fn: reps calls captured in one CUDA graph
    and replayed, so the host's time to issue a call (a wrapper's Python
    checks and allocations) is not counted where it exceeds the kernel's."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return cuda_ms(g.replay, iters) / reps


def perturb_(params, std=0.02, seed=SEED + 1):
    """Fill the zero-initialised adaLN-zero and output tensors."""
    import torch
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    with torch.no_grad():
        lins = [b.ada for b in params.blocks] + [params.final_ada,
                                                 params.patch_out]
        for lin in lins:
            for t in (lin.weight, lin.bias):
                t.copy_(torch.randn(t.shape, generator=g, device=DEV)
                        * std)


def layer0_qkv(model, params, req):
    """Layer 0's self-attention q, k, v (B*H, N, Dh) and routing for one
    request at its first step, as the engine computes them."""
    import torch
    from repro_torch.core import router as R
    from repro_torch.models import dit as D
    from repro_torch.models import layers as L
    cfg = model.cfg
    lat = torch.as_tensor(req.latents, device=DEV)[None]
    mods = model.precompute_step_mods(params, torch.ones(1, device=DEV))
    x = (torch.nn.functional.linear(lat.to(cfg.param_dtype),
                                    params.patch_in.weight)
         + params.patch_in.bias)
    bp = params.blocks[0]
    sh1, sc1 = mods["blocks"][0].to(x.dtype).chunk(6, dim=-1)[:2]
    h = D._modulate(L.layernorm(bp.ln1, x), sh1, sc1)
    q, k, v = (D._heads(h, w.weight, cfg.num_heads, cfg.head_dim)
               .reshape(cfg.num_heads, N_LAT, cfg.head_dim).contiguous()
               for w in (bp.wq, bp.wk, bp.wv))
    idx, valid = R.route_indices(bp.sla2.router, q, k, cfg.router_config())
    return q, k, v, idx, valid.to(torch.int32)


def bound_ms(q, idx, valid, bq, bk):
    """Least time for this call: the larger of the int8 operations its
    routed (valid) tiles need over the int8 peak, and its bytes (q, k, v,
    idx, valid read once; o, lse written once) over the HBM rate."""
    bh, n, d = q.shape
    ops = int(valid.sum()) * 2 * (2 * bq * bk * d)
    nbytes = (4 * q.numel() * q.element_size() + 2 * idx.numel() * 4
              + bh * n * 4)
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fwd_gather_floor_ms(q, valid, bq, bk):
    """Gathered-bytes floor of the int8 forward: a K and a V code tile
    read per valid routed pair (bk x d and d x vt_keys(bk) int8), plus the
    pre-pass (K and V read once, their codes and scales written once), q
    read, o and lse written, idx and valid read, over the HBM rate."""
    from repro_torch.kernels.sla2_fwd import vt_keys
    bh, n, d = q.shape
    es, t_n, tile = q.element_size(), n // bk, (bk + vt_keys(bk)) * d
    nbytes = (int(valid.sum()) * tile
              + 2 * bh * n * d * es + bh * t_n * tile + 2 * bh * t_n * 4
              + 2 * q.numel() * es + bh * n * 4 + 2 * valid.numel() * 4)
    return nbytes / PEAK_BYTES * 1e3


def phase_kernel(model, params, reqs):
    import torch
    from repro_torch.core.quant import smooth_k
    from repro_torch.core import router as R
    from repro_torch.kernels.sla2_fwd import (sparse_flash_fwd,
                                              sparse_flash_fwd_plain)
    cfg = model.cfg
    bq, bk = cfg.block_q, cfg.block_k
    kw = dict(block_q=bq, block_k=bk, causal=False, quant_bits="int8")
    with torch.inference_mode():
        q, k, v, idx, valid = layer0_qkv(model, params, reqs[0])
        k = smooth_k(k).contiguous()
        o, lse = sparse_flash_fwd(q, k, v, idx, valid, **kw)
        torch.cuda.synchronize()
        po, pl = sparse_flash_fwd_plain(q, k, v, idx, valid, **kw)
        err = rel_err(o, po)
        abs_err = float((o.float() - po.float()).abs().max())
        lse_err = float((lse - pl).abs().max())
        log(f"[kernel] main shape q{tuple(q.shape)} bf16 int8 K_sel="
            f"{idx.shape[-1]}: rel max err {err:.3e} (bound 1e-3), "
            f"max abs err {abs_err:.3e}, lse max abs err {lse_err:.3e}")
        if not (err < BOUNDS["int8"] and lse_err < 1e-3):
            raise AssertionError("kernel disagrees with its plain version")

        g = torch.Generator(device=DEV)
        g.manual_seed(SEED + 2)
        n_cases = 0
        for dtype in (torch.float32, torch.bfloat16):
            for quant in ("none", "int8", "fp8"):
                for causal, prefix_len, kv_len, shape in (
                        (False, 0, 0, (3, 1024, 128, 128, 64)),
                        (False, 0, 1000, (3, 1024, 128, 128, 64)),
                        (True, 0, 0, (3, 1024, 128, 128, 64)),
                        (True, 192, 1000, (3, 1024, 128, 128, 64)),
                        (True, 0, 0, (2, 512, 64, 64, 32)),
                        (False, 0, 500, (4, 256, 32, 32, 16))):
                    bh, n, d, sbq, sbk = shape
                    sq, sk, sv = ((torch.randn(bh, n, d, generator=g,
                                               device=DEV) * 0.5
                                   ).to(dtype) for _ in range(3))
                    rcfg = R.RouterConfig(block_q=sbq, block_k=sbk,
                                          k_frac=0.25, causal=causal,
                                          prefix_len=prefix_len)
                    si, sval = R.route_indices(None, sq, sk, rcfg)
                    sval = sval.to(torch.int32)
                    if quant != "none":
                        sk = smooth_k(sk).contiguous()
                    skw = dict(block_q=sbq, block_k=sbk, causal=causal,
                               prefix_len=prefix_len, kv_len=kv_len,
                               quant_bits=quant)
                    so, sl = sparse_flash_fwd(sq, sk, sv, si, sval, **skw)
                    torch.cuda.synchronize()
                    spo, spl = sparse_flash_fwd_plain(sq, sk, sv, si, sval,
                                                      **skw)
                    e = rel_err(so, spo)
                    bound = BOUNDS[quant]
                    if dtype == torch.bfloat16:
                        bound = max(bound, BF16_TWO_ULPS)
                    le = float((sl - spl).abs().max())
                    if not (e < bound and le < 1e-3):
                        raise AssertionError(
                            f"sweep case {shape} {dtype} {quant} causal="
                            f"{causal} prefix={prefix_len} kv_len={kv_len}:"
                            f" rel err {e:.3e} > {bound:.1e} or lse {le:.3e}")
                    n_cases += 1
        log(f"[kernel] sweep: {n_cases} cases within bounds (f32 none "
            f"2e-5, bf16 2 ulps, int8 1e-3, fp8 1e-2)")

        timings = {}
        for reps in (1, 2):
            tq, tk, tv, ti, tvl = (torch.cat([t] * reps) for t in
                                   (q, k, v, idx, valid))
            ms = cuda_ms(lambda: sparse_flash_fwd(tq, tk, tv, ti, tvl, **kw),
                         iters=20)
            plain = cuda_ms(lambda: sparse_flash_fwd_plain(
                tq, tk, tv, ti, tvl, **kw), iters=2, warmup=1)
            bms, by = bound_ms(tq, ti, tvl, bq, bk)
            floor = fwd_gather_floor_ms(tq, tvl, bq, bk)
            timings[tq.shape[0]] = (ms, plain, bms, by, floor)
            log(f"[kernel] BH={tq.shape[0]}: kernel {ms:.3f} ms (before the "
                f"redesign: {PRIOR_MS['fwd'][tq.shape[0]]:.3f} ms), plain "
                f"{plain:.3f} "
                f"ms, bound {bms:.4f} ms ({by}), {bms / ms:.1%} of bound; "
                f"gathered-bytes floor {floor:.4f} ms, {floor / ms:.1%} of "
                f"it; valid routed pairs {int(tvl.sum())}")
    return {"max_abs_err": abs_err, "rel_err": err, "timings": timings}


def phase_serve(model, params, reqs):
    import torch
    from repro_torch.kernels.sla2_fwd import sparse_flash_fwd
    from repro_torch.serve import diffusion as DS
    ecfg = DS.DiffusionEngineConfig(max_slots=2, n_latent=N_LAT, max_steps=8,
                                    attn_impl="fused")
    eng = DS.DiffusionEngine(model, params, ecfg, device=DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sparse_flash_fwd.launches = 0
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    finished, step_ms = [], []
    t0 = time.perf_counter()
    finished += eng.step()
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - t0) * 1e3)
    eng.submit(reqs[2])                        # joins after the first step
    while not eng.scheduler.idle:
        t0 = time.perf_counter()
        finished += eng.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = sparse_flash_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    steps = eng.stats["engine_steps"]
    log(f"[serve] {len(finished)} requests, {steps} engine steps, "
        f"sparse_flash_fwd launches {launches} (want "
        f"{model.cfg.n_layers} x {steps}); ms per engine step "
        f"{[round(t, 1) for t in step_ms]}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    if sorted(r.uid for r in finished) != [r.uid for r in reqs]:
        raise AssertionError("not every request finished")
    for r in finished:
        import numpy as np
        if r.output.shape != r.latents.shape or not np.isfinite(
                r.output).all() or np.array_equal(r.output, r.latents):
            raise AssertionError(f"request {r.uid}: bad output")
    if launches != model.cfg.n_layers * steps or launches == 0:
        raise AssertionError("the main path did not run the kernel "
                             "once per layer and engine step")
    return {"launches": launches, "step_ms": step_ms, "peak": peak,
            "steps": steps}


def phase_context():
    import numpy as np
    import torch
    from repro_torch.configs.wan_dit_1_3b import config
    from repro_torch.models.api import build_model
    from repro_torch.serve import diffusion as DS
    model = build_model(config(n_layers=2))
    params = model.init(SEED + 3, device=DEV)
    perturb_(params, seed=SEED + 4)
    outs = {}
    for impl in ("fused", "gather"):
        req = DS.make_video_requests(1, model.cfg, n_latent=N_LAT, steps=(2,),
                                     seed=SEED + 5)
        eng = DS.DiffusionEngine(model, params, DS.DiffusionEngineConfig(
            max_slots=1, n_latent=N_LAT, max_steps=2, attn_impl=impl),
            device=DEV)
        eng.submit(req[0])
        outs[impl] = eng.run_to_completion()[0].output
    rel = float(np.linalg.norm(outs["fused"] - outs["gather"])
                / np.linalg.norm(outs["gather"]))
    log(f"[context] 2 layers, full width: fused vs gather relative norm "
        f"error {rel:.3e} (bound 0.05)")
    if not rel < 0.05:
        raise AssertionError("fused and gather engines disagree")
    del params
    torch.cuda.empty_cache()
    return rel


def bwd_bounds(q, idx, valid, bq, bk):
    """Least times of the two backward kernels on this call's routed
    (valid) pairs: {kernel: (ms on the bf16 tensor-core peak, bound_by,
    ms on the f32 CUDA-core peak)}.  Bytes: q, k, v, dO read once (and
    lse, dd, the routing), dQ or dK and dV written once."""
    bh, n, d = q.shape
    pairs = int(valid.sum())
    flop = 2 * bq * bk * d * pairs
    tile = q.numel() * q.element_size()
    rows = 2 * bh * n * 4                          # lse and dd, f32
    routing = 2 * idx.numel() * 4
    out = {}
    for name, products, tiles, extra in (
            ("dq", 3, 5, routing),
            ("dkv", 4, 6, routing + bh * (n // bk + 1) * 4)):
        t_b16 = products * flop / PEAK_BF16_OPS * 1e3
        t_f32 = products * flop / PEAK_F32_OPS * 1e3
        t_bytes = (tiles * tile + rows + extra) / PEAK_BYTES * 1e3
        out[name] = (max(t_b16, t_bytes),
                     "operations" if t_b16 >= t_bytes else "bytes",
                     max(t_f32, t_bytes))
    return out


def gather_floor_ms(q, valid, bq, bk):
    """Least time of a routed backward that reads its tiles once per pair
    (the L2 catching no repeat): dQ gathers a K and a V tile (bk x d) per
    valid pair, dK/dV a Q and a dO tile (bq x d) and their lse and dd rows;
    {kernel: ms at the HBM rate}."""
    pairs = int(valid.sum())
    d, es = q.shape[-1], q.element_size()
    return {"dq": pairs * 2 * bk * d * es / PEAK_BYTES * 1e3,
            "dkv": pairs * (2 * bq * d * es + 2 * bq * 4) / PEAK_BYTES * 1e3}


def run_lengths(idx, valid, t_n):
    """Valid pairs per (bh, kv block j), the length of each dK/dV run."""
    import torch
    counts = torch.zeros(idx.shape[0], t_n, dtype=torch.int32,
                         device=idx.device)
    counts.scatter_add_(1, idx.reshape(idx.shape[0], -1).long(),
                        valid.reshape(idx.shape[0], -1))
    return counts


def force_hot_block(idx, valid, hot):
    """Routing in which every query block reaches kv block ``hot``: a row
    that does not route it yet gets it in its last entry, made valid."""
    import torch
    has = ((idx == hot) & (valid == 1)).any(-1)
    idx, valid = idx.clone(), valid.clone()
    idx[..., -1] = torch.where(has, idx[..., -1], hot)
    valid[..., -1] = torch.where(has, valid[..., -1], 1)
    return idx, valid


def phase_bwd(model, params, reqs):
    import torch
    from repro_torch.core import router as R
    from repro_torch.core.quant import smooth_k
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import sla2_bwd as B
    from repro_torch.kernels.sla2_fwd import sparse_flash_fwd
    cfg = model.cfg
    bq, bk = cfg.block_q, cfg.block_k
    kw = dict(block_q=bq, block_k=bk, causal=False, prefix_len=0)
    g = torch.Generator(device=DEV)
    g.manual_seed(SEED + 6)
    with torch.no_grad():
        q, k, v, idx, valid = layer0_qkv(model, params, reqs[0])
        k = smooth_k(k).contiguous()
        o, lse = sparse_flash_fwd(q, k, v, idx, valid, block_q=bq,
                                  block_k=bk, causal=False, quant_bits="int8")
        do = torch.randn(q.shape, generator=g, device=DEV).to(q.dtype)
        got = B.sparse_flash_bwd(q, k, v, idx, valid, o, lse, do, **kw)
        torch.cuda.synchronize()
        want = B.sparse_flash_bwd_plain(q, k, v, idx, valid, o, lse, do, **kw)
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        abs_errs = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, want)]
        log(f"[bwd] main shape q{tuple(q.shape)} bf16, o/lse from the int8 "
            f"forward, {int(valid.sum())} routed pairs: rel max err dq "
            f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (bound 2^-7), "
            f"max abs err {abs_errs[0]:.3e} / {abs_errs[1]:.3e} / "
            f"{abs_errs[2]:.3e}")
        if not all(e <= BF16_TWO_ULPS for e in errs):
            raise AssertionError("backward kernels disagree with their "
                                 "plain version at the main shape")
        runs = run_lengths(idx, valid, N_LAT // bk).float()
        log(f"[bwd] dK/dV run lengths at the main shape (valid pairs per "
            f"(bh, kv block)): mean {float(runs.mean()):.2f}, p99 "
            f"{float(torch.quantile(runs, 0.99)):.0f}, max "
            f"{int(runs.max())}, empty {int((runs == 0).sum())} of "
            f"{runs.numel()}")

        n_cases = invalid = unvisited = hot_runs = 0
        for dtype in (torch.float32, torch.bfloat16):
            for causal, prefix_len, shape, kf, hot in (
                    (False, 0, (3, 1024, 128, 128, 64), 0.1, None),
                    (True, 0, (3, 1024, 128, 128, 64), 0.5, None),
                    (True, 192, (3, 1024, 128, 128, 64), 0.5, None),
                    (True, 0, (2, 512, 64, 64, 32), 0.5, None),
                    (False, 0, (4, 256, 32, 32, 16), 0.25, None),
                    (True, 48, (4, 256, 32, 32, 16), 0.5, None),
                    (False, 0, (2, 8192, 128, 128, 64), 0.05, 5)):
                bh, n, d, sbq, sbk = shape
                sq, sk, sv, sdo = ((torch.randn(bh, n, d, generator=g,
                                                device=DEV) * 0.5
                                    ).to(dtype) for _ in range(4))
                si, sval = R.route_indices(None, sq, sk, R.RouterConfig(
                    block_q=sbq, block_k=sbk, k_frac=kf, causal=causal,
                    prefix_len=prefix_len))
                sval = sval.to(torch.int32)
                if hot is not None:             # every query block routes it
                    si, sval = force_hot_block(si, sval, hot)
                    hot_runs = int(run_lengths(si, sval, n // sbk)[:, hot]
                                   .min())
                    if hot_runs != n // sbq:
                        raise AssertionError("the hot kv block is not "
                                             "routed by every query block")
                skw = dict(block_q=sbq, block_k=sbk, causal=causal,
                           prefix_len=prefix_len)
                so, sl = sparse_flash_fwd(sq, sk, sv, si, sval, **skw)
                sgot = B.sparse_flash_bwd(sq, sk, sv, si, sval, so, sl, sdo,
                                          **skw)
                torch.cuda.synchronize()
                swant = B.sparse_flash_bwd_plain(sq, sk, sv, si, sval, so,
                                                 sl, sdo, **skw)
                bound = 1e-4 if dtype == torch.float32 else BF16_TWO_ULPS
                e = max(rel_err(a, b) for a, b in zip(sgot, swant))
                if not e <= bound:
                    raise AssertionError(
                        f"bwd sweep case {shape} {dtype} causal={causal} "
                        f"prefix={prefix_len}: rel err {e:.3e} > {bound:.1e}")
                seen = torch.zeros(bh, n // sbk, dtype=torch.bool,
                                   device=DEV)
                seen.scatter_(1, si.reshape(bh, -1).long(),
                              sval.reshape(bh, -1).bool())
                invalid += int((sval == 0).sum())
                unvisited += int((~seen).sum())
                n_cases += 1
        log(f"[bwd] sweep: {n_cases} cases within bounds (f32 1e-4, bf16 "
            f"2^-7), with {invalid} invalid padding entries, {unvisited} "
            f"kv blocks no valid pair visits and a hot kv block routed by "
            f"all {hot_runs} query blocks of its head")
        if not (invalid and unvisited and hot_runs):
            raise AssertionError("the sweep missed padding, unvisited or "
                                 "hot blocks")

    # autograd through the kernel-mode op against a dense softmax oracle
    rcfg = R.RouterConfig(block_q=32, block_k=16, k_frac=0.3)
    xs = [torch.randn(2, 256, 64, generator=g, device=DEV) * 0.5
          for _ in range(4)]
    ai, av = R.route_indices(None, xs[0], xs[1], rcfg)
    grads = {}
    for name in ("kernel", "oracle"):
        aq, ak, avv = (x.clone().requires_grad_() for x in xs[:3])
        if name == "kernel":
            ao, _ = kops.sparse_attention_op(aq, ak, avv, ai, av, 32, 16,
                                             False, "none")
        else:
            ao, _ = kref.sparse_flash_ref(aq, ak, avv, ai, av, block_q=32,
                                          block_k=16, causal=False)
        torch.sum(ao * xs[3]).backward()
        grads[name] = (aq.grad, ak.grad, avv.grad)
    ag = max(rel_err(a, b) for a, b in zip(grads["kernel"], grads["oracle"]))
    log(f"[bwd] autograd through sparse_attention_op (kernels) vs the dense "
        f"oracle, f32: rel max err {ag:.3e} (bound 1e-4)")
    if not ag <= 1e-4:
        raise AssertionError("kernel-mode gradient disagrees with the oracle")

    with torch.no_grad():
        dd, is_, vs, off = B.kernel_inputs(o, do, idx, valid, N_LAT // bk)
        times = {
            "dq": cuda_ms(lambda: B.launch_dq(q, k, v, do, lse, dd, idx,
                                              valid, **kw), iters=5),
            "dkv": cuda_ms(lambda: B.launch_dkv(q, k, v, do, lse, dd, is_,
                                                vs, off, **kw), iters=5)}
        whole = cuda_ms(lambda: B.sparse_flash_bwd(q, k, v, idx, valid, o,
                                                   lse, do, **kw), iters=3)
        plain = {
            "dq": cuda_ms(lambda: B.sparse_flash_dq_plain(
                q, k, v, idx, valid, o, lse, do, **kw), iters=1, warmup=1),
            "dkv": cuda_ms(lambda: B.sparse_flash_dkv_plain(
                q, k, v, idx, valid, o, lse, do, **kw), iters=1, warmup=1)}
    bounds = bwd_bounds(q, idx, valid, bq, bk)
    floors = gather_floor_ms(q, valid, bq, bk)
    for name in ("dq", "dkv"):
        b16, by, f32 = bounds[name]
        log(f"[bwd] BH={q.shape[0]} {name}: kernel {times[name]:.3f} ms "
            f"(PR 16: {PR16_BWD_MS[name]:.3f} ms), plain {plain[name]:.3f} "
            f"ms, bound {b16:.4f} ms ({by}, bf16 tensor cores; {f32:.3f} ms "
            f"on f32 CUDA cores), {b16 / times[name]:.1%} of bound; "
            f"gathered-bytes floor {floors[name]:.4f} ms, "
            f"{floors[name] / times[name]:.1%} of it")
    log(f"[bwd] whole wrapper (dd, pair sort, both kernels): {whole:.3f} ms")
    return {"abs_err": {"dq": abs_errs[0], "dkv": max(abs_errs[1:])},
            "times": times, "plain": plain, "bounds": bounds,
            "gather_floor": floors}


def phase_train():
    import torch
    from repro_torch.configs.wan_dit_1_3b import DIT_SHAPES, config
    from repro_torch.data import make_dataset
    from repro_torch.kernels.sla2_bwd import sparse_flash_bwd
    from repro_torch.kernels.sla2_fwd import sparse_flash_fwd
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    n = DIT_SHAPES["train_32k"]["seq_len"]
    model = build_model(config(sla2_impl="kernel"))
    cfg = model.cfg
    # lr 1e-3 with one warm-up step: at the defaults (1e-4, 100 warm-up
    # steps) the first updates are far below half a bf16 ulp
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=1,
                       total_steps=TRAIN_STEPS, microbatches=MICROBATCHES)
    state = init_train_state(model, SEED + 7, tcfg, device=DEV)
    params = state["params"]
    perturb_(params, seed=SEED + 8)
    before = {name: p.detach().clone() for name, p in params.named_parameters()
              if name.startswith("blocks.")}
    ds = make_dataset(cfg, seq_len=n, global_batch=MICROBATCHES, seed=SEED)
    step_fn = make_train_step(model, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sparse_flash_fwd.launches = 0
    sparse_flash_bwd.launches_dq = sparse_flash_bwd.launches_dkv = 0
    losses, step_ms = [], []
    for step in range(TRAIN_STEPS):
        batch = {key: torch.as_tensor(val, device=DEV)
                 for key, val in ds[step].items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step == 0:
            m = state["opt"]["m"]
            bad = [name for name, t in m.items()
                   if not bool(torch.isfinite(t).all())
                   or (".router." in name) == bool(t.abs().max() > 0)]
            if bad:
                raise AssertionError(
                    f"after step 1, AdamW m is non-finite, zero outside the "
                    f"router or non-zero in it for {bad[:5]}")
    launches = {"sparse_flash_fwd": sparse_flash_fwd.launches,
                "sparse_flash_bwd_dq": sparse_flash_bwd.launches_dq,
                "sparse_flash_bwd_dkv": sparse_flash_bwd.launches_dkv}
    peak = torch.cuda.max_memory_allocated()
    changed = sum(int((p.detach() != before[name]).sum())
                  for name, p in params.named_parameters() if name in before)
    total = sum(t.numel() for t in before.values())
    per = cfg.n_layers * MICROBATCHES * TRAIN_STEPS
    want = {"sparse_flash_fwd": 2 * per, "sparse_flash_bwd_dq": per,
            "sparse_flash_bwd_dkv": per}
    log(f"[train] {cfg.name} {cfg.n_layers} layers, {n} latents, "
        f"{TRAIN_STEPS} steps x {MICROBATCHES} microbatches of one video "
        f"(global batch {MICROBATCHES}, not 64): losses "
        f"{[round(x, 5) for x in losses]}; ms per optimizer step "
        f"{[round(t, 1) for t in step_ms]}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[train] launches {launches} (want {want}: forward twice per layer "
        f"and microbatch, once more under remat); every leaf but the "
        f"router's got a finite non-zero gradient (hard Top-k routing "
        f"gives the router none; it trains in stage 1); block weights "
        f"changed in bf16: {changed / total:.2%}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("a training loss is not finite")
    if launches != want:
        raise AssertionError("the train path did not run every kernel the "
                             "expected number of times")
    del state, params, before
    torch.cuda.empty_cache()
    return launches


def phase_train_context():
    import tempfile

    import torch
    from repro_torch.checkpoint import all_steps
    from repro_torch.configs.wan_dit_1_3b import DIT_SHAPES, config
    from repro_torch.data import make_dataset
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig
    n = DIT_SHAPES["train_32k"]["seq_len"]
    model = build_model(config(n_layers=2, quant_bits="none",
                               sla2_impl="kernel"))
    params = model.init(SEED + 9, device=DEV)
    perturb_(params, seed=SEED + 10)
    batch = {key: torch.as_tensor(val, device=DEV) for key, val in
             make_dataset(model.cfg, seq_len=n, global_batch=1,
                          seed=SEED + 11)[0].items()}
    names, leaves = zip(*params.named_parameters())
    res = {}
    for impl in ("kernel", "gather"):
        loss, _ = model.with_overrides(sla2_impl=impl).loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        res[impl] = (float(loss.detach()),
                     [torch.zeros_like(p, dtype=torch.float32) if gr is None
                      else gr.float() for p, gr in zip(leaves, grads)])
        del grads
    (lk, gk), (lg, gg) = res["kernel"], res["gather"]
    loss_rel = abs(lk - lg) / abs(lg)
    num = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b in zip(gk, gg)))
    den = math.sqrt(sum(float((b ** 2).sum()) for b in gg))
    log(f"[train-context] 2 layers, full width, quant none: loss kernel "
        f"{lk:.6f} gather {lg:.6f} (rel err {loss_rel:.3e}, bound 1e-2); "
        f"gradient rel norm err {num / den:.3e} over {len(names)} leaves "
        f"(bound 0.05)")
    if not (loss_rel < 1e-2 and num / den < 0.05):
        raise AssertionError("kernel and gather gradients disagree")
    del res, gk, gg, params
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(
            train=TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=1,
                              total_steps=2),
            ckpt_dir=d, max_steps=2, ckpt_every=1, keep=1, log_every=1,
            seed=SEED + 12)
        ds = make_dataset(model.cfg, seq_len=n, global_batch=1,
                          seed=SEED + 13)
        out = Trainer(model, tc, ds, device=DEV, log_fn=log).run()
        if all_steps(d) != [2]:
            raise AssertionError(f"checkpoints on disk: {all_steps(d)}")
        back = Trainer(model, tc, ds, device=DEV, log_fn=log).run()
        a, b = out["state"], back["state"]
        pairs = list(zip(a["params"].parameters(), b["params"].parameters()))
        for key in ("m", "v"):
            pairs += [(t, b["opt"][key][name])
                      for name, t in a["opt"][key].items()]
        same = all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in pairs)
        same = same and int(a["opt"]["step"]) == int(b["opt"]["step"]) == 2
        log(f"[train-context] Trainer: losses "
            f"{[round(x, 5) for x in out['losses']]}, a fresh Trainer "
            f"restored step 2 with {len(pairs)} leaves bitwise equal: {same}")
        if back["losses"] or not same:
            raise AssertionError("the restored state differs from the saved")
    torch.cuda.empty_cache()
    return loss_rel, num / den


def phase_stage1():
    import torch
    from repro_torch.core.router import RouterConfig
    from repro_torch.core.sla2 import SLA2Config
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.stage1 import (Stage1Config, capture_qkv_stream,
                                          run_stage1)
    from repro_torch.configs.wan_dit_1_3b import config
    mcfg = config()
    cfg = SLA2Config(router=RouterConfig(block_q=mcfg.block_q,
                                         block_k=mcfg.block_k,
                                         k_frac=mcfg.k_frac),
                     quant_bits="none", impl="ref")
    stream = capture_qkv_stream(SEED, batch=1, heads=mcfg.num_heads,
                                seq=STAGE1_N, dim=mcfg.head_dim, device=DEV)
    _, hist = run_stage1(
        SEED, stream, cfg,
        Stage1Config(k_fracs=(mcfg.k_frac,), steps_per_k=8, tau_stages=2,
                     optimizer=AdamWConfig(lr=3e-3, weight_decay=0.0),
                     log_every=4),
        head_dim=mcfg.head_dim, num_heads=mcfg.num_heads,
        n_q_blocks=STAGE1_N // mcfg.block_q, device=DEV, log_fn=log)
    pk = hist["per_k"][mcfg.k_frac]
    log(f"[stage1] {mcfg.num_heads} x {mcfg.head_dim} heads, {STAGE1_N} "
        f"tokens, k={mcfg.k_frac}: {len(hist['loss'])} steps, hard-Top-k "
        f"MSE {pk['before']:.6f} -> {pk['after']:.6f}")
    if not (all(math.isfinite(x) for x in hist["loss"])
            and pk["after"] < pk["before"]):
        raise AssertionError("stage 1 did not lower the hard-Top-k MSE")
    torch.cuda.empty_cache()
    return pk


def free_cuda():
    """Free the device memory of engines no longer referenced: the hooks
    the LM phases put on an engine refer back to it, so a dropped engine
    is a reference cycle that only the garbage collector frees."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def lm_engine(model, params, **overrides):
    """A fused ServeEngine at the lm-serve geometry, params loaded."""
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    kw = dict(max_slots=LM_SLOTS, max_len=LM_MAX_LEN, prefill_chunk=LM_CHUNK,
              paged_impl="fused")
    kw.update(overrides)
    eng = ServeEngine(model, EngineConfig(**kw), device=DEV)
    eng.load(params)
    return eng


def _clone(x):
    import torch
    return x.clone() if isinstance(x, torch.Tensor) else x


def capture_layer0(model, params, want=None, new_tokens=24, **overrides):
    """Layer 0's inputs to the paged kernels, cloned, as the engine gives
    them, from a short 4-slot prefill at full width (``new_tokens`` a
    request).  ``want`` {entry: predicate(engine, args, kw)} picks the
    call; by default the SLA2 decode call of the first step with all 4
    slots decoding and the prefill call of the first chunk at offset >=
    1024.  Raises when the engine drains before every call was seen."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.serve.engine import make_mixed_requests
    eng = lm_engine(model, params, **overrides)
    full = lambda: sum(s.decoding for s in eng._slots.values()) == LM_SLOTS
    got = {}
    if want is None:
        want = {"sla2_decode_fused": lambda e, a, k: full(),
                "paged_flash_prefill":
                    lambda e, a, k: int(k["offset"]) >= 2 * LM_CHUNK}
    entry = A.fused_entry_fn

    def capturing_entry(name):
        fn = entry(name)

        def run(*args, **kw):
            if name in want and name not in got and want[name](eng, args,
                                                               kw):
                got[name] = ([_clone(a) for a in args],
                             {k: _clone(v) for k, v in kw.items()})
            return fn(*args, **kw)
        return run

    for r in make_mixed_requests(model.cfg.vocab_size,
                                 [(n, new_tokens) for n in LM_CAPTURE],
                                 seed=SEED + 20):
        eng.submit(r)
    A.fused_entry_fn = capturing_entry
    try:
        while len(got) < len(want):
            if not (eng._slots or eng._queue):
                raise AssertionError(f"no call of {sorted(set(want) - set(got))}"
                                     f" matched its predicate")
            eng.step()
    finally:
        A.fused_entry_fn = entry
    torch.cuda.synchronize()
    del eng
    free_cuda()
    return got


def decode_bound_ms(args):
    """Least time of one sla2_decode call, fused (W = 1) or verify
    arguments: the distinct valid routed K/V pages of each (slot, KV head)
    with their scales, h_tot / z_tot of every row, q, the routing, alpha
    and o, over the HBM rate; its operations are a few MFLOP."""
    import torch
    q, kp, _, phys, _, valid, _, _, h, z, alpha = args
    b, hkv = q.shape[:2]
    key = (torch.arange(b * hkv, device=q.device).reshape(
        b, hkv, *[1] * (phys.dim() - 2)) * kp.shape[0] + phys.long())
    n_pages = int(torch.unique(key[valid == 1]).numel())
    page = kp.shape[2] * q.shape[-1] * kp.element_size()
    nbytes = (2 * n_pages * page + h.numel() * 4 + z.numel() * 4
              + q.numel() * q.element_size() + 4 * phys.numel() * 4
              + alpha.numel() * 4 + q.numel() * 4)
    return nbytes / PEAK_BYTES * 1e3


def prefill_work(q, page_row, offset, block_k, n_rep, window, prefix_len):
    """(operations, bytes) of one prefill call: 4 Dh per visible (query,
    key) pair over every query head; q and the visible K/V pages read
    once, o written once."""
    from repro_torch.kernels.sla2_decode_paged import visible_pages
    h, c, dh = q.shape
    pairs = 0
    for r in range(c):
        pos = offset + r
        lo = 0 if window is None else max(0, pos - window + 1)
        seen = pos + 1 - lo
        if prefix_len:
            seen += max(0, min(prefix_len, lo))
        pairs += seen
    pages = len(visible_pages(offset, c, page_row.shape[0], block_k, window,
                              prefix_len))
    ops = 4 * dh * h * pairs
    nbytes = (q.numel() * q.element_size() + h * c * dh * 4
              + 2 * pages * (h // n_rep) * block_k * dh * 2)
    return ops, nbytes


def sdpa_ms(q, k_pages, v_pages, page_row, offset, n_rep):
    """SDPA over the gathered contiguous K/V of the chunk's history with
    the offset-causal mask (the gather itself is not timed)."""
    import torch
    h, c, dh = q.shape
    n_kv = offset + c
    n_pg = -(-n_kv // k_pages.shape[2])
    rows = page_row[:n_pg].long()
    kk, vv = (t[rows].transpose(0, 1).reshape(t.shape[1], -1, dh)[:, :n_kv]
              for t in (k_pages, v_pages))
    kk = torch.repeat_interleave(kk, n_rep, dim=0)[None].to(q.dtype)
    vv = torch.repeat_interleave(vv, n_rep, dim=0)[None].to(q.dtype)
    mask = (torch.arange(c, device=q.device)[:, None] + offset
            >= torch.arange(n_kv, device=q.device)[None, :])
    qq = q[None]
    fn = torch.nn.functional.scaled_dot_product_attention
    return cuda_ms(lambda: fn(qq, kk, vv, attn_mask=mask), iters=10)


def synthetic_pool(g, n_pages, hkv, bk, dh, kv_quant):
    import torch
    from repro_torch.kernels import ops
    k, v = (torch.randn(n_pages, hkv, bk, dh, generator=g, device=DEV)
            for _ in range(2))
    if kv_quant == "none":
        return k.bfloat16(), v.bfloat16(), None, None
    (kc, ks), (vc, vs) = (ops.quantize_rows(t, kv_quant) for t in (k, v))
    return kc, vc, ks, vs


def phase_lm_kernel(model, params):
    import itertools

    import torch
    from repro_torch.kernels import sla2_decode_paged as KP
    cfg = model.cfg
    bk, dh = cfg.block_k, cfg.head_dim
    got = capture_layer0(model, params)
    dargs, dkw = got["sla2_decode_fused"]
    pargs, pkw = got["paged_flash_prefill"]
    with torch.no_grad():
        o = KP.sla2_decode_fused(*dargs, **dkw)
        torch.cuda.synchronize()
        po = KP.sla2_decode_fused_plain(*dargs, **dkw)
        d_err, d_abs = rel_err(o, po), float((o - po).abs().max())
        o = KP.paged_flash_prefill(*pargs, **pkw)
        torch.cuda.synchronize()
        po = KP.paged_flash_prefill_plain(*pargs, **pkw)
        p_err, p_abs = rel_err(o, po), float((o - po).abs().max())
    q = dargs[0]
    log(f"[lm-kernel] layer-0 decode q{tuple(q.shape)} {q.dtype}, pool "
        f"{tuple(dargs[1].shape)}, K_sel={dargs[3].shape[-1]}, valid "
        f"entries {int(dargs[5].sum())}/{dargs[5].numel()}, complete "
        f"{int(dargs[6].sum())}, t_new {dargs[7].tolist()}: rel max err "
        f"{d_err:.3e} (bound 2e-5), max abs err {d_abs:.3e}")
    log(f"[lm-kernel] layer-0 prefill q{tuple(pargs[0].shape)} offset "
        f"{pkw['offset']} maxP {pargs[3].shape[0]}: rel max err {p_err:.3e} "
        f"(bound 2e-5), max abs err {p_abs:.3e}")
    if not (d_err < BOUNDS["none"] and p_err < BOUNDS["none"]):
        raise AssertionError("a paged kernel disagrees with its plain "
                             "version at the main shape")

    g = torch.Generator(device=DEV)
    g.manual_seed(SEED + 21)
    n_cases = 0
    b, hkv, k_sel, n_pages = LM_SLOTS, cfg.num_kv_heads, dargs[3].shape[-1], 600
    with torch.no_grad():
        for quant, kvq, n_rep, w in itertools.product(
                ("none", "int8", "fp8"), ("none", "int8", "fp8"), (1, 5),
                (1, 4)):
            kp, vp, ks, vs = synthetic_pool(g, n_pages, hkv, bk, dh, kvq)
            rnd = lambda *shape: torch.rand(*shape, generator=g, device=DEV)
            sq = torch.randn(b, hkv, w, n_rep, dh, generator=g,
                             device=DEV).bfloat16()
            ints = lambda lo, hi, shape: torch.randint(
                lo, hi, shape, generator=g, device=DEV, dtype=torch.int32)
            phys = ints(1, n_pages, (b, hkv, w, k_sel))
            jlog = ints(0, 200, (b, hkv, w, k_sel))
            valid = (rnd(b, hkv, w, k_sel) > 0.15).to(torch.int32)
            comp = (rnd(b, hkv, w, k_sel) > 0.3).to(torch.int32) * valid
            t_new = ints(150 * bk, 200 * bk, (b, w))       # ragged rows
            h = rnd(b, hkv, w, dh, dh) * 100
            z = rnd(b, hkv, w, dh) * 3000 + 500
            alpha = torch.randn(b, hkv, n_rep, generator=g, device=DEV)
            a = (sq, kp, vp, phys, jlog, valid, comp, t_new, h, z, alpha)
            kw = dict(block_k=bk, quant_bits=quant, kv_quant=kvq,
                      k_scale=ks, v_scale=vs)
            so = KP.sla2_decode_verify(*a, **kw)
            torch.cuda.synchronize()
            e = rel_err(so, KP.sla2_decode_verify_plain(*a, **kw))
            if not e < BOUNDS[quant]:
                raise AssertionError(
                    f"decode sweep quant={quant} kv_quant={kvq} n_rep="
                    f"{n_rep} W={w}: rel err {e:.3e} > {BOUNDS[quant]:.0e}")
            n_cases += 1
        log(f"[lm-kernel] decode sweep: {n_cases} cases (quant_bits x "
            f"kv_quant x n_rep 1/5 x W 1/4, ragged t_new, ~15% invalid "
            f"entries, complete flags) within bounds")
        n_pre, pre_err = 0, 0.0
        c, max_p, n_rep = LM_CHUNK, LM_MAX_LEN // bk, cfg.num_heads // hkv
        for off, window, prefix, kvq in itertools.product(
                (0, 2 * c, 15 * c), (None, 256), (0, 48),
                ("none", "int8", "fp8")):
            kp, vp, ks, vs = synthetic_pool(g, n_pages, hkv, bk, dh, kvq)
            sq = torch.randn(cfg.num_heads, c, dh, generator=g,
                             device=DEV).bfloat16()
            row = torch.zeros(max_p, dtype=torch.int32, device=DEV)
            used = -(-(off + c) // bk)
            row[:used] = (torch.randperm(n_pages - 1, generator=g,
                                         device=DEV)[:used] + 1).int()
            kw = dict(offset=off, block_k=bk, n_rep=n_rep, window=window,
                      prefix_len=prefix, kv_quant=kvq, k_scale=ks,
                      v_scale=vs)
            so = KP.paged_flash_prefill(sq, kp, vp, row, **kw)
            torch.cuda.synchronize()
            po = KP.paged_flash_prefill_plain(sq, kp, vp, row, **kw)
            e = rel_err(so, po)
            if not e < BOUNDS["none"]:
                raise AssertionError(
                    f"prefill sweep offset={off} window={window} prefix="
                    f"{prefix} kv_quant={kvq}: rel err {e:.3e} > 2e-5")
            pre_err = max(pre_err, e)
            n_pre += 1
        log(f"[lm-kernel] prefill sweep: {n_pre} cases (offset 0/1024/7680 "
            f"x window None/256 x prefix_len 0/48 x kv_quant) within 2e-5; "
            f"max rel err {pre_err:.3e}")

        d_ms = cuda_ms(lambda: KP.sla2_decode_fused(*dargs, **dkw), iters=50)
        d_graph = graph_ms(lambda: KP.sla2_decode_fused(*dargs, **dkw))
        d_eps = KP.decode_split_shape(*dargs[0].shape[:2],
                                      dargs[3].shape[-1],
                                      KP.sm_count(dargs[0].device))
        d_plain = cuda_ms(lambda: KP.sla2_decode_fused_plain(*dargs, **dkw),
                          iters=3, warmup=1)
        d_bound = decode_bound_ms(dargs)
        p_ms = cuda_ms(lambda: KP.paged_flash_prefill(*pargs, **pkw),
                       iters=10)
        p_plain = cuda_ms(lambda: KP.paged_flash_prefill_plain(*pargs, **pkw),
                          iters=2, warmup=1)
        ops_, nbytes = prefill_work(pargs[0], pargs[3], pkw["offset"], bk,
                                    pkw["n_rep"], pkw["window"],
                                    pkw["prefix_len"])
        t_b16 = ops_ / PEAK_BF16_OPS * 1e3
        t_f32 = ops_ / PEAK_F32_OPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        p_bound = max(t_b16, t_bytes)
        p_by = "operations" if t_b16 >= t_bytes else "bytes"
        p_lib = sdpa_ms(pargs[0], pargs[1], pargs[2], pargs[3],
                        pkw["offset"], pkw["n_rep"])
        # the last chunk of the 8192-token prompt, on the same pool
        long_off = LM_PROMPTS[0] - c
        lq = torch.randn(cfg.num_heads, c, dh, generator=g,
                         device=DEV).bfloat16()
        lrow = torch.zeros(max_p, dtype=torch.int32, device=DEV)
        n_used = LM_PROMPTS[0] // bk
        lrow[:n_used] = (torch.randperm(pargs[1].shape[0] - 1, generator=g,
                                        device=DEV)[:n_used] + 1).int()
        lkw = dict(pkw, offset=long_off)
        l_ms = cuda_ms(lambda: KP.paged_flash_prefill(lq, pargs[1], pargs[2],
                                                      lrow, **lkw), iters=5)
        l_ops, l_bytes = prefill_work(lq, lrow, long_off, bk, pkw["n_rep"],
                                      None, 0)
        l_bound = max(l_ops / PEAK_BF16_OPS, l_bytes / PEAK_BYTES) * 1e3
        l_lib = sdpa_ms(lq, pargs[1], pargs[2], lrow, long_off, pkw["n_rep"])
    log(f"[lm-kernel] decode: kernel {d_ms:.4f} ms in a loop of calls "
        f"({d_graph:.4f} ms from a CUDA graph; before the redesign "
        f"{PRIOR_MS['decode']:.4f} ms in the loop), {d_eps[1]} splits of "
        f"{d_eps[0]} entries, plain {d_plain:.3f} ms, bound {d_bound:.4f} "
        f"ms (bytes), {d_bound / d_ms:.1%} of bound ({d_bound / d_graph:.1%}"
        f" from the graph); library: none")
    log(f"[lm-kernel] prefill (offset {pkw['offset']}, C {c}): kernel "
        f"{p_ms:.3f} ms, plain {p_plain:.3f} ms, bound {p_bound:.4f} ms "
        f"({p_by}, bf16 tensor cores; {max(t_f32, t_bytes):.3f} ms on f32 "
        f"CUDA cores), {p_bound / p_ms:.1%} of bound; SDPA over the gathered "
        f"K/V {p_lib:.3f} ms")
    log(f"[lm-kernel] prefill at offset {long_off}: kernel {l_ms:.3f} ms, "
        f"bound {l_bound:.4f} ms (bf16 tensor cores; "
        f"{l_ops / PEAK_F32_OPS * 1e3:.3f} ms on f32 CUDA cores), "
        f"{l_bound / l_ms:.1%} of bound; SDPA over the gathered K/V "
        f"{l_lib:.3f} ms")
    del got, dargs, pargs
    free_cuda()
    return {"decode": (d_abs, d_ms, d_plain, d_bound, d_graph, d_eps),
            "prefill": (p_abs, p_ms, p_plain, p_bound, p_by, t_f32, p_lib),
            "prefill_long": (l_ms, l_bound, l_lib), "sweep_err": pre_err}


def bf16_resolution(x: float) -> float:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def record_margins(eng, margins):
    """Wrap ``eng._sample`` so that every greedy sample records, per row,
    the top-2 logit margin and the top logit under (uid, output index)."""
    import torch
    sample = eng._sample

    def hooked(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values.cpu()
        if logits.shape[0] == 1:            # a prefill's first token
            rows = [(0, s) for s, st in eng._slots.items()
                    if not st.decoding and st.pos == len(st.tokens)][:1]
        else:
            rows = [(s, s) for s, st in eng._slots.items() if st.decoding]
        for r, s in rows:
            req = eng._slots[s].req
            margins[(req.uid, len(req.output))] = (
                float(top[r, 0] - top[r, 1]), float(top[r, 0]))
        return sample(logits)
    eng._sample = hooked


def record_rows(eng, uid, rows):
    """Wrap ``eng._sample`` so that every sample of request ``uid``
    appends its logit row (f32, on the host) to ``rows``."""
    sample = eng._sample

    def hooked(logits):
        if logits.shape[0] == 1:            # a prefill's first token
            slots = [s for s, st in eng._slots.items()
                     if not st.decoding and st.pos == len(st.tokens)][:1]
            idx = [0 for s in slots if eng._slots[s].req.uid == uid]
        else:
            idx = [s for s, st in eng._slots.items()
                   if st.decoding and st.req.uid == uid]
        rows.extend(logits[i].float().cpu() for i in idx)
        return sample(logits)
    eng._sample = hooked


def compare_tokens(tag, want, got, margins):
    """Greedy tokens ``got`` against ``want`` ({uid: tokens}).  A request
    may differ only where the ``want`` run's top-2 margin is below the
    bf16 resolution of its top logit; its comparison stops there.
    Returns those stops; raises on any other difference."""
    stops = []
    for uid, ref in sorted(want.items()):
        have = got[uid]
        if len(have) != len(ref):
            raise AssertionError(f"[{tag}] request {uid}: {len(have)} "
                                 f"tokens, want {len(ref)}")
        for i, (a, b) in enumerate(zip(have, ref)):
            if a == b:
                continue
            margin, top = margins[(uid, i)]
            res = bf16_resolution(top)
            if not margin < res:
                raise AssertionError(
                    f"[{tag}] request {uid} differs at token {i} ({a} vs "
                    f"{b}) where the top-2 margin {margin:.4g} is not below "
                    f"the bf16 resolution {res:.4g} of its logit {top:.4g}")
            stops.append({"uid": uid, "pos": i, "margin": margin,
                          "top_logit": top, "bf16_resolution": res})
            break
    return stops


def time_dispatches(eng):
    """Time every prefill chunk and decode dispatch of ``eng`` on the host
    clock around a synchronised call.  Returns the lists they fill: (ms
    per chunk, {decoding slots: [ms per dispatch]})."""
    import torch
    prefill_ms, decode_ms = [], {}
    dispatches = lambda: eng.stats["decode_steps"] + eng.stats["spec_steps"]

    def timed(name, sink):
        fn = getattr(eng, name)

        def run():
            n_dec = sum(s.decoding for s in eng._slots.values())
            before = (eng.stats["prefill_chunks"], dispatches())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if (eng.stats["prefill_chunks"], dispatches()) != before:
                sink(ms, n_dec)
        setattr(eng, name, run)

    timed("_prefill_step", lambda ms, n: prefill_ms.append(ms))
    timed("_decode_step", lambda ms, n: decode_ms.setdefault(n, []).append(ms))
    return prefill_ms, decode_ms


def serve_lm(model, params, counters, margins=None, on_engine=None,
             **overrides):
    """Serve the LM_PROMPTS (LM_NEW new tokens each, the fourth submitted
    after the first decode dispatch) through a fused engine at the
    lm-serve geometry.  ``counters`` {name: wrapper}: every count is set
    to 0 just before the run and read just after.  Returns tokens, stats,
    launches, ms per prefill chunk and per decode dispatch by active
    slots, peak memory and wall time."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import make_mixed_requests
    cfg = model.cfg
    eng = lm_engine(model, params, **overrides)
    reqs = make_mixed_requests(cfg.vocab_size,
                               [(n, LM_NEW) for n in LM_PROMPTS], seed=SEED)
    dispatches = lambda: eng.stats["decode_steps"] + eng.stats["spec_steps"]
    prefill_ms, decode_ms = time_dispatches(eng)
    if margins is not None:
        record_margins(eng, margins)
    if on_engine is not None:
        on_engine(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for r in reqs[:3]:
        eng.submit(r)
    while dispatches() == 0:
        eng.step()
    eng.submit(reqs[3])                        # joins after the first decode
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if sorted(r.uid for r in done) != [r.uid for r in reqs] or any(
            len(r.output) != LM_NEW or min(r.output) < 0
            or max(r.output) >= cfg.vocab_size for r in done):
        raise AssertionError("not every request produced its tokens")
    st = dict(eng.stats)
    del eng
    free_cuda()
    per_slot = {n: (round(float(np.median(v)), 3), len(v))
                for n, v in sorted(decode_ms.items())}
    return {"tokens": {r.uid: list(r.output) for r in done},
            "prompts": {r.uid: len(r.prompt) for r in done}, "stats": st,
            "launches": launches, "prefill_ms": prefill_ms,
            "decode_ms": per_slot, "peak": peak, "wall": wall}


def check_launches(tag, run, n_layers, decode_key, dispatch_stat):
    """The paged kernels ran once per layer and dispatch: ``decode_key``
    n_layers x the ``dispatch_stat`` dispatches, prefill n_layers x the
    chunks of the prompts."""
    st, launches = run["stats"], run["launches"]
    want = {decode_key: n_layers * st[dispatch_stat],
            "paged_flash_prefill": n_layers * st["prefill_chunks"]}
    chunks = sum(-(-n // LM_CHUNK) for n in LM_PROMPTS)
    log(f"[{tag}] {len(run['tokens'])} requests in {st['engine_steps']} "
        f"engine steps, {run['wall']:.1f} s; {st['prefill_chunks']} prefill "
        f"chunks, {st[dispatch_stat]} {dispatch_stat.replace('_', ' ')}; "
        f"launches {launches} (want {want})")
    if launches != want or st["prefill_chunks"] != chunks \
            or 0 in launches.values():
        raise AssertionError(f"[{tag}] the serving path did not run each "
                             f"paged kernel once per layer and dispatch")


def phase_lm_serve(model, params):
    from repro_torch.kernels import sla2_decode_paged as KP
    margins = {}
    run = serve_lm(model, params, {
        "sla2_decode_paged": KP.sla2_decode_verify,
        "paged_flash_prefill": KP.paged_flash_prefill}, margins=margins)
    check_launches("lm-serve", run, model.cfg.n_layers, "sla2_decode_paged",
                   "decode_steps")
    log(f"[lm-serve] ms per prefill chunk "
        f"{[round(t, 1) for t in run['prefill_ms']]}")
    log(f"[lm-serve] ms per decode step by active slots (median, count): "
        f"{run['decode_ms']}; peak memory {run['peak'] / 2**30:.2f} GiB")
    log(f"[lm-serve] tokens: " + "; ".join(
        f"{uid} (prompt {run['prompts'][uid]}): {toks}"
        for uid, toks in sorted(run["tokens"].items())))
    run["margins"] = margins
    return run


def phase_lm_spec(model, params, serve):
    """Speculative decoding with the SLA2 linear drafter at full width:
    the lm-serve prompts, greedy tokens held to lm-serve's, and layer 0's
    W = 4 verify call of the dispatch with the most decoding slots
    captured, checked against its plain version and timed."""
    import torch
    from repro_torch.kernels import sla2_decode_paged as KP
    from repro_torch.models import attention as A
    got = {}
    entry = A.fused_entry_fn

    def capture(eng):
        def capturing(name):
            fn = entry(name)

            def run(*args, **kw):
                n_dec = sum(s.decoding for s in eng._slots.values())
                if (name == "sla2_decode_verify" and args[0].shape[2] == 4
                        and n_dec > got.get("n_dec", 0)):
                    got.update(n_dec=n_dec, verify=(
                        [_clone(a) for a in args],
                        {k: _clone(v) for k, v in kw.items()}))
                return fn(*args, **kw)
            return run
        A.fused_entry_fn = capturing

    try:
        run = serve_lm(model, params, {
            "sla2_decode_paged": KP.sla2_decode_verify,
            "paged_flash_prefill": KP.paged_flash_prefill},
            on_engine=capture, speculative="linear", draft_len=3)
    finally:
        A.fused_entry_fn = entry
    st = run["stats"]
    check_launches("lm-spec", run, model.cfg.n_layers, "sla2_decode_paged",
                   "spec_steps")
    if st["decode_steps"] != 0:
        raise AssertionError("[lm-spec] a single-token decode dispatch ran")
    stops = compare_tokens("lm-spec", serve["tokens"], run["tokens"],
                           serve["margins"])
    rate = st["spec_accepted"] / max(1, st["spec_drafted"])
    log(f"[lm-spec] linear drafter, draft_len 3: {st['spec_steps']} verify "
        f"dispatches, drafted {st['spec_drafted']}, accepted "
        f"{st['spec_accepted']} (rate {rate:.3f}); tokens equal lm-serve's "
        f"up to the stops {stops}")
    log(f"[lm-spec] ms per verify step (draft + verify + commit) by active "
        f"slots (median, count): {run['decode_ms']}; ms per prefill chunk "
        f"median {sorted(run['prefill_ms'])[len(run['prefill_ms']) // 2]:.1f}"
        f"; peak memory {run['peak'] / 2**30:.2f} GiB")
    if "verify" not in got:
        raise AssertionError("[lm-spec] no W = 4 verify call was made")
    args, kw = got.pop("verify")
    with torch.no_grad():
        o = KP.sla2_decode_verify(*args, **kw)
        torch.cuda.synchronize()
        err = rel_err(o, KP.sla2_decode_verify_plain(*args, **kw))
        ms = cuda_ms(lambda: KP.sla2_decode_verify(*args, **kw), iters=50)
        ms_graph = graph_ms(lambda: KP.sla2_decode_verify(*args, **kw))
        plain = cuda_ms(lambda: KP.sla2_decode_verify_plain(*args, **kw),
                        iters=2, warmup=1)
    bound = decode_bound_ms(args)
    eps = KP.decode_split_shape(*args[0].shape[:2], args[3].shape[-1],
                                KP.sm_count(args[0].device))
    log(f"[lm-spec] layer-0 verify window of the dispatch with the most "
        f"decoding slots ({got['n_dec']}): q{tuple(args[0].shape)}, K_sel "
        f"{args[3].shape[-1]}, t_new {args[7].tolist()}: rel max err "
        f"{err:.3e} (bound 2e-5); kernel {ms:.4f} ms in a loop of calls "
        f"({ms_graph:.4f} ms from a CUDA graph; before the redesign "
        f"{PRIOR_MS['decode_w4']:.4f} ms in the loop), {eps[1]} splits of "
        f"{eps[0]} entries, plain {plain:.3f} ms, bound {bound:.4f} ms "
        f"(bytes), {bound / ms:.1%} of bound ({bound / ms_graph:.1%} from the "
        f"graph)")
    if not err < BOUNDS["none"]:
        raise AssertionError("[lm-spec] the verify kernel disagrees with its "
                             "plain version")
    del args, kw
    free_cuda()
    run.update(stops=stops, rate=rate,
               w4=(ms, plain, bound, err, ms_graph, eps))
    return run


def dense_model_params(model, params):
    """The ``mechanism="full"`` qwen3-14b whose params are the SLA2 model's
    tensors, every one but the ``sla2`` leaves (no second 29.5 GB init)."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.models.api import build_model
    fm = build_model(dataclasses.replace(model.cfg, mechanism="full"))
    layers = [T.LayerParams(lp.ln1, A.AttentionParams(
        lp.attn.wq, lp.attn.wk, lp.attn.wv, lp.attn.wo, lp.attn.q_norm,
        lp.attn.k_norm), lp.ln2, lp.mlp) for lp in params.layers]
    return fm, T.LMParams(params.embed, layers, params.final_norm,
                          params.lm_head)


def dense_visible_pages(t, block_k, max_p, window, prefix_len):
    """Logical pages a dense decode row of length t sees."""
    hi = min(max_p, -(-int(t) // block_k))
    if window is None:
        return set(range(hi))
    n_pref = min(hi, -(-prefix_len // block_k))
    return set(range(n_pref)) | set(
        range(max(max(int(t) - window, 0) // block_k, n_pref), hi))


def dense_bound_ms(q, k_pages, table, t_new, block_k, window=None,
                   prefix_len=0, scaled=False):
    """Least time of one dense decode call: every K/V page a slot's rows
    see, read once (with its row scales under kv_quant), q, the table
    entries read, t_new and o, over the HBM rate; its operations are a
    few MFLOP."""
    b, hkv, w, n_rep, dh = q.shape
    n = sum(len(set().union(*(dense_visible_pages(
        t, block_k, table.shape[1], window, prefix_len)
        for t in t_new[s].tolist()))) for s in range(b))
    page = hkv * block_k * (dh * k_pages.element_size() + (4 if scaled
                                                            else 0))
    nbytes = (2 * n * page + q.numel() * q.element_size() + 4 * n
              + t_new.numel() * 4 + q.numel() * 4)
    return nbytes / PEAK_BYTES * 1e3


def dense_sdpa_ms(q, k_pages, v_pages, table, t_new):
    """SDPA over each slot's K/V pages gathered into a contiguous
    (B, H, L, Dh) copy (the gather not timed), row w of slot b masked to
    the positions below t_new[b, w]; timed as the kernel is: (a loop of
    calls, calls replayed from a CUDA graph)."""
    import torch
    b, hkv, w, n_rep, dh = q.shape
    bk = k_pages.shape[2]
    n_kv = int(t_new.max())
    rows = table[:, :-(-n_kv // bk)].long()
    kk, vv = (torch.repeat_interleave(
        t[rows].transpose(1, 2).reshape(b, hkv, -1, dh)[:, :, :n_kv],
        n_rep, dim=1).to(q.dtype) for t in (k_pages, v_pages))
    qq = q.permute(0, 1, 3, 2, 4).reshape(b, hkv * n_rep, w, dh)
    mask = (torch.arange(n_kv, device=q.device)[None, None, :]
            < t_new[:, :, None])[:, None]
    fn = torch.nn.functional.scaled_dot_product_attention
    call = lambda: fn(qq, kk, vv, attn_mask=mask)
    return cuda_ms(call, iters=50), graph_ms(call)


def phase_lm_dense_kernel(model, params):
    """Layer 0's dense decode and W = 4 verify inputs, captured from short
    4-slot prefills of the full-width dense model, through dense_decode
    and its plain version; a sweep; CUDA-event times at the lm-serve
    context lengths beside the plain version, the bound and SDPA."""
    import itertools

    import torch
    from repro_torch.kernels import sla2_decode_paged as KP
    cfg = model.cfg
    bk, dh, hkv = cfg.block_k, cfg.head_dim, cfg.num_kv_heads
    n_rep = cfg.num_heads // hkv
    full = lambda e: sum(s.decoding for s in e._slots.values()) == LM_SLOTS
    cap = capture_layer0(model, params, {
        "dense_decode_fused": lambda e, a, k: full(e)})
    cap.update(capture_layer0(model, params, {
        "dense_decode_verify": lambda e, a, k: full(e)
        and a[0].shape[2] == 4}, speculative="ngram", draft_len=3))
    abs_err = 0.0
    with torch.no_grad():
        for name, plain in (("dense_decode_fused", KP.dense_decode_fused_plain),
                            ("dense_decode_verify",
                             KP.dense_decode_verify_plain)):
            args, kw = cap[name]
            o = getattr(KP, name)(*args, **kw)
            torch.cuda.synchronize()
            po = plain(*args, **kw)
            err = rel_err(o, po)
            abs_err = max(abs_err, float((o - po).abs().max()))
            log(f"[lm-dense-kernel] layer-0 {name} q{tuple(args[0].shape)} "
                f"{args[0].dtype}, pool {tuple(args[1].shape)}, t_new "
                f"{args[4].tolist()}: rel max err {err:.3e} (bound 2e-5)")
            if not err < BOUNDS["none"]:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at the main shape")
    del cap
    free_cuda()

    g = torch.Generator(device=DEV)
    g.manual_seed(SEED + 25)
    n_pages, max_p = 600, LM_MAX_LEN // bk
    pools = {kvq: synthetic_pool(g, n_pages, hkv, bk, dh, kvq)
             for kvq in ("none", "int8", "fp8")}

    def table_for(b, used):
        t = torch.zeros(b, max_p, dtype=torch.int32, device=DEV)
        for s in range(b):
            t[s, :used] = (torch.randperm(n_pages - 1, generator=g,
                                          device=DEV)[:used] + 1).int()
        return t

    n_cases = 0
    with torch.no_grad():
        for quant, kvq, w, window, prefix, nr in itertools.product(
                ("none", "int8", "fp8"), ("none", "int8", "fp8"), (1, 4),
                (None, 256), (0, 64), (1, 5)):
            kp, vp, ks, vs = pools[kvq]
            b = LM_SLOTS
            q = torch.randn(b, hkv, w, nr, dh, generator=g,
                            device=DEV).bfloat16()
            lens = torch.randint(1, 60 * bk, (b,), generator=g, device=DEV)
            t_new = (lens[:, None] + torch.arange(w, device=DEV) + 1).int()
            t_new[-1] = 0                           # a row that sees nothing
            table = table_for(b, 61)
            kw = dict(block_k=bk, window=window, prefix_len=prefix,
                      quant_bits=quant, kv_quant=kvq, k_scale=ks, v_scale=vs)
            o = KP.dense_decode_verify(q, kp, vp, table, t_new, **kw)
            torch.cuda.synchronize()
            e = rel_err(o, KP.dense_decode_verify_plain(q, kp, vp, table,
                                                        t_new, **kw))
            if not (e < BOUNDS[quant] and float(o[-1].abs().max()) == 0.0):
                raise AssertionError(
                    f"dense sweep quant={quant} kv_quant={kvq} W={w} window="
                    f"{window} prefix={prefix} n_rep={nr}: rel err {e:.3e} > "
                    f"{BOUNDS[quant]:.0e} or a masked row is not 0")
            n_cases += 1
        log(f"[lm-dense-kernel] sweep: {n_cases} cases (quant_bits x kv_quant"
            f" x W 1/4 x window None/256 x prefix_len 0/64 x n_rep 1/5, "
            f"ragged lengths, one fully masked slot) within bounds")

        # the lm-serve contexts, mid-generation, on a bf16 pool
        kp, vp, _, _ = pools["none"]
        lens = torch.tensor([n + LM_NEW // 2 for n in LM_PROMPTS],
                            device=DEV)
        table = table_for(LM_SLOTS, -(-(int(lens.max()) + 4) // bk))
        times = {}
        for w in (1, 4):
            q = torch.randn(LM_SLOTS, hkv, w, n_rep, dh, generator=g,
                            device=DEV).bfloat16()
            t_new = (lens[:, None] + torch.arange(w, device=DEV) + 1).int()
            kw = dict(block_k=bk)
            o = KP.dense_decode_verify(q, kp, vp, table, t_new, **kw)
            torch.cuda.synchronize()
            po = KP.dense_decode_verify_plain(q, kp, vp, table, t_new, **kw)
            err = rel_err(o, po)
            abs_err = max(abs_err, float((o - po).abs().max()))
            if not err < BOUNDS["none"]:
                raise AssertionError(f"dense_decode at W={w} disagrees with "
                                     f"its plain version: {err:.3e}")
            call = lambda: KP.dense_decode_verify(q, kp, vp, table, t_new,
                                                  **kw)
            ms, ms_graph = cuda_ms(call, iters=50), graph_ms(call)
            plain = cuda_ms(lambda: KP.dense_decode_verify_plain(
                q, kp, vp, table, t_new, **kw), iters=2, warmup=1)
            bound = dense_bound_ms(q, kp, table, t_new, bk)
            lib, lib_graph = dense_sdpa_ms(q, kp, vp, table, t_new)
            wg, n_split = KP.dense_split_shape(LM_SLOTS, hkv, w, n_rep,
                                               max_p, KP.sm_count(q.device))
            pps = KP.dense_split_pages(t_new, bk, max_p, n_split)
            times[w] = (ms, plain, bound, lib, pps, ms_graph, lib_graph)
            log(f"[lm-dense-kernel] W={w}, B {LM_SLOTS}, t_new "
                f"{t_new[:, 0].tolist()}: kernel {ms:.4f} ms in a loop of "
                f"calls ({ms_graph:.4f} ms from a CUDA graph), plain "
                f"{plain:.3f} ms, bound {bound:.4f} ms (bytes), "
                f"{bound / ms:.1%} of bound ({bound / ms_graph:.1%} from the "
                f"graph); SDPA over the gathered K/V {lib:.4f} ms "
                f"({lib_graph:.4f} ms from a CUDA graph); rel max err "
                f"{err:.3e}; {n_split} splits "
                f"per (slot, KV head), pages per split by slot {pps}, "
                f"{wg} window rows per block")
    del pools
    free_cuda()
    return {"abs_err": abs_err, "times": times}


def phase_lm_dense_serve(model, params):
    """The dense model served with speculative off, then with the n-gram
    drafter; launches and tokens checked, the n-gram tokens held to the
    off run's."""
    from repro_torch.kernels import sla2_decode_paged as KP
    counters = {"dense_decode_paged": KP.dense_decode_verify,
                "paged_flash_prefill": KP.paged_flash_prefill}
    margins, rows = {}, []
    off = serve_lm(model, params, counters, margins=margins,
                   on_engine=lambda eng: record_rows(eng, 0, rows))
    check_launches("lm-dense-serve", off, model.cfg.n_layers,
                   "dense_decode_paged", "decode_steps")
    log(f"[lm-dense-serve] ms per prefill chunk "
        f"{[round(t, 1) for t in off['prefill_ms']]}")
    log(f"[lm-dense-serve] ms per decode step by active slots (median, "
        f"count): {off['decode_ms']}; peak memory "
        f"{off['peak'] / 2**30:.2f} GiB")
    log(f"[lm-dense-serve] tokens: " + "; ".join(
        f"{uid} (prompt {off['prompts'][uid]}): {toks}"
        for uid, toks in sorted(off["tokens"].items())))
    ng = serve_lm(model, params, counters, speculative="ngram", draft_len=3)
    st = ng["stats"]
    check_launches("lm-dense-serve ngram", ng, model.cfg.n_layers,
                   "dense_decode_paged", "spec_steps")
    stops = compare_tokens("lm-dense-serve ngram", off["tokens"],
                           ng["tokens"], margins)
    rate = st["spec_accepted"] / max(1, st["spec_drafted"])
    log(f"[lm-dense-serve] ngram drafter, draft_len 3: {st['spec_steps']} "
        f"verify dispatches, drafted {st['spec_drafted']}, accepted "
        f"{st['spec_accepted']} (rate {rate:.3f}); ms per verify step by "
        f"active slots (median, count): {ng['decode_ms']}; peak memory "
        f"{ng['peak'] / 2**30:.2f} GiB; tokens equal the off run's up to "
        f"the stops {stops}")
    return {"off": off, "ngram": ng, "stops": stops, "rate": rate,
            "margins": margins, "rows": rows}


def phase_lm_spec_context():
    """At 2 layers, f32 weights and pages, both mechanisms: speculative
    fused and gather engines (the gather engine fed the fused engine's
    drafts) give verify-window logits within 1e-3 relative norm error and
    the greedy tokens of speculative="off"; a pool too small for all
    slots, with and without swap, gives the same tokens."""
    import torch
    from repro_torch.configs.qwen3_14b import config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import make_mixed_requests
    work = [(2000, 16), (900, 16), (300, 16)]
    worst = 0.0
    for mech, spec in (("sla2", "linear"), ("full", "ngram")):
        model = build_model(config(n_layers=2, dtype="float32",
                                   mechanism=mech))
        params = model.init(SEED + 24, device=DEV)

        def run(impl, feed=None, **kw):
            eng = lm_engine(model, params, max_slots=3, max_len=4096,
                            paged_impl=impl, page_dtype="float32", **kw)
            drafts, logits = [], []
            if eng._spec:
                draft = eng._draft

                def fed(tokens0, active):
                    out = feed.pop(0) if feed is not None else draft(
                        tokens0, active)
                    drafts.append(out)
                    return out
                eng._draft = fed
                verify = eng.model.decode_verify

                def recorded(p, batch, caches):
                    lg, caches = verify(p, batch, caches)
                    act = batch["active"].tolist()
                    wl = batch["window_len"].tolist()
                    logits.append(torch.cat([lg[s, :wl[s]].float().cpu()
                                             for s in range(len(act))
                                             if act[s]]))
                    return lg, caches
                eng.model = dataclasses.replace(eng.model,
                                                decode_verify=recorded)
            for r in make_mixed_requests(model.cfg.vocab_size, work,
                                         seed=SEED + 23):
                eng.submit(r)
            out = {r.uid: r.output for r in eng.run_to_completion()}
            st = dict(eng.stats)
            del eng
            free_cuda()
            return out, drafts, logits, st

        off, _, _, _ = run("fused")
        kw = dict(speculative=spec, draft_len=3)
        fused, drafts, f_logits, f_st = run("fused", **kw)
        gather, _, g_logits, _ = run("gather", feed=list(drafts), **kw)
        rel = max(float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
                  for a, b in zip(f_logits, g_logits))
        same = fused == gather == off and len(f_logits) == len(g_logits)
        worst = max(worst, rel)
        log(f"[lm-spec-context] {mech} / {spec}, 2 layers, f32: fused vs "
            f"gather over {len(f_logits)} verify windows: logits rel norm "
            f"err {rel:.3e} (bound 1e-3); greedy tokens of fused, gather "
            f"and speculative='off' identical: {same}; accepted "
            f"{f_st['spec_accepted']} of {f_st['spec_drafted']}")
        if not (rel < 1e-3 and same and f_st["spec_steps"] > 0):
            raise AssertionError(f"[lm-spec-context] {mech}: the speculative "
                                 f"engines disagree")
        stats = {}
        for name, extra in (("swap", {}), ("recompute", {"swap_pages": 0})):
            out, _, _, st = run("fused", num_pages=40, **kw, **extra)
            stats[name] = st
            log(f"[lm-spec-context] {mech}, pool of 40 pages, {name}: "
                f"preemptions {st['preemptions']}, swap-outs "
                f"{st['swap_outs']}, recomputes {st['recomputes']}; tokens "
                f"equal the unpreempted run: {out == fused}")
            if out != fused:
                raise AssertionError(f"[lm-spec-context] {mech}: preemption "
                                     f"by {name} changed the tokens")
        if not (stats["swap"]["swap_outs"] >= 1
                and stats["recompute"]["recomputes"] >= 1):
            raise AssertionError("[lm-spec-context] the small pool forced "
                                 "no swap-out or no recompute")
        del params, model
        free_cuda()
    return worst


def phase_lm_context():
    import numpy as np
    import torch
    from repro_torch.configs.qwen3_14b import config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import make_mixed_requests
    # f32 weights and pages: in bf16 the kernels' and the gather path's
    # f32 sums round to different bf16 values now and then, and those
    # flips, not the kernels, would set the logits error
    model = build_model(config(n_layers=2, dtype="float32"))
    params = model.init(SEED + 22, device=DEV)
    work = [(2000, 16), (900, 16), (300, 16)]

    def run(impl, feed=None, **kw):
        """Serve ``work``; returns (tokens, logits and ids of the active
        rows at every sampling point, all ids sampled, stats).  ``feed``
        replaces the sampled ids by those of another run."""
        eng = lm_engine(model, params, max_slots=3, max_len=4096,
                        paged_impl=impl, page_dtype="float32", **kw)
        seen, own, every = [], [], []
        sample = eng._sample

        def hooked(logits):
            # rows of inactive slots read the trash page: compare the rest
            rows = [0] if logits.shape[0] == 1 else [
                s for s in range(logits.shape[0])
                if s in eng._slots and eng._slots[s].decoding]
            ids = sample(logits)
            seen.append(logits[rows].float().clone())
            own.append(ids[rows])
            every.append(ids)
            return feed.pop(0) if feed is not None else ids
        eng._sample = hooked
        for r in make_mixed_requests(model.cfg.vocab_size, work,
                                     seed=SEED + 23):
            eng.submit(r)
        out = {r.uid: r.output for r in eng.run_to_completion()}
        st = dict(eng.stats)
        del eng
        free_cuda()
        return out, seen, own, every, st

    fused, f_logits, f_ids, f_every, _ = run("fused")
    gather, g_logits, g_ids, _, _ = run("gather", feed=list(f_every))
    rel = max(float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
              for a, b in zip(f_logits, g_logits))
    same = len(f_ids) == len(g_ids) and all(
        np.array_equal(a, b) for a, b in zip(f_ids, g_ids))
    log(f"[lm-context] 2 layers, full width: fused vs gather over "
        f"{len(f_logits)} sampling points: logits rel norm err {rel:.3e} "
        f"(bound 1e-3), greedy tokens identical: {same}")
    if not (rel < 1e-3 and same and len(f_logits) == len(g_logits)):
        raise AssertionError("fused and gather LM engines disagree")
    stats = {}
    for name, kw in (("swap", {}), ("recompute", {"swap_pages": 0})):
        out, _, _, _, st = run("fused", num_pages=40, **kw)
        stats[name] = st
        log(f"[lm-context] pool of 40 pages, {name}: preemptions "
            f"{st['preemptions']}, swap-outs {st['swap_outs']}, recomputes "
            f"{st['recomputes']}; tokens equal the unpreempted run: "
            f"{out == fused}")
        if out != fused:
            raise AssertionError(f"preemption by {name} changed the tokens")
    if not (stats["swap"]["swap_outs"] >= 1
            and stats["recompute"]["recomputes"] >= 1):
        raise AssertionError("the small pool forced no swap-out or no "
                             "recompute")
    del params
    free_cuda()
    return rel


# ---------------------------------------------------------------------------
# The prefix cache (lm-prefix, lm-prefix-dense, lm-prefix-context) and
# internlm2-20b (lm-internlm2)
# ---------------------------------------------------------------------------

def check_pool_invariants(eng):
    """Every page's refcount equals its page-table occurrences plus its
    prefix-cache references; the free list holds exactly the pages at
    refcount 0, once each (the reference's ``_check_pool_invariants``)."""
    import numpy as np
    alloc = eng.allocator
    counts = np.zeros(alloc.num_pages, np.int64)
    vals, occ = np.unique(eng._page_table, return_counts=True)
    counts[vals[vals > 0]] = occ[vals > 0]
    if eng._pcache is not None:
        for p, c in eng._pcache.page_refs().items():
            counts[p] += c
    refs = np.array([alloc.refcount(p) for p in range(alloc.num_pages)])
    free = np.zeros(alloc.num_pages, bool)
    free[alloc._free] = True
    if not (len(set(alloc._free)) == len(alloc._free)
            and np.array_equal(refs[1:], counts[1:])
            and np.array_equal(free[1:], counts[1:] == 0)):
        raise AssertionError("page pool invariants broken: a refcount is not "
                             "its page-table occurrences plus its cache "
                             "references, or the free list drifted")


def prefix_requests(vocab, n_reqs, seed):
    """The lm-prefix traffic: three seeded PREFIX_SYS-token system prompts,
    requests round-robin over them, each with a seeded suffix of 16 to 512
    tokens, except requests 3, 7, 11, exact copies of their bare system
    prompt.  Returns (requests, suffix length of each)."""
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(seed)
    sys_p = [rng.integers(1, vocab, PREFIX_SYS).astype(np.int32)
             for _ in range(3)]
    reqs, suffix = [], []
    for i in range(n_reqs):
        n = 0 if i % 4 == 3 else int(rng.integers(16, 513))
        tail = rng.integers(1, vocab, n).astype(np.int32)
        reqs.append(Request(uid=i, prompt=np.concatenate([sys_p[i % 3], tail]),
                            max_new_tokens=PREFIX_NEW))
        suffix.append(n)
    return reqs, suffix


def drive(eng, on_step=None, max_steps=20000):
    """Step ``eng`` until it drains, calling ``on_step()`` after every
    step; raises when it does not drain in ``max_steps``."""
    for _ in range(max_steps):
        if not (eng._slots or eng._queue):
            return
        eng.step()
        if on_step is not None:
            on_step()
    raise AssertionError(f"the engine did not drain in {max_steps} steps")


def serve_prefix(model, params, counters, n_reqs, prefix_cache,
                 margins=None):
    """Serve the lm-prefix traffic through a fused lm-serve engine:
    requests 0-2 (one per system prompt) to completion first, then the
    rest together.  ``counters``: every count set to 0 just before and read
    just after.  Returns tokens, first-token logits, stats, launches, time
    to first token, ms per chunk and dispatch, peak pages mapped by active
    slots, the totals snapshots' bytes and copy time, peak memory."""
    import numpy as np
    import torch
    eng = lm_engine(model, params, prefix_cache=prefix_cache)
    reqs, suffix = prefix_requests(model.cfg.vocab_size, n_reqs,
                                   SEED + 30)
    first, ttft = {}, {}
    snap = {"n": 0, "bytes": 0, "ms": 0.0}
    peak_mapped = [0]
    sample = eng._sample

    def first_logits(logits):
        if logits.shape[0] == 1:            # a prefill's first token
            (s,) = [st for st in eng._slots.values()
                    if not st.decoding and st.pos == len(st.tokens)][:1]
            first[s.req.uid] = logits[0].float().cpu()
        return sample(logits)
    eng._sample = first_logits
    if margins is not None:
        record_margins(eng, margins)
    take = eng._snapshot_totals

    def timed_snapshot(slot):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = take(slot)
        snap["ms"] += (time.perf_counter() - t0) * 1e3
        if out is not None:
            snap["n"] += 1
            snap["bytes"] += sum(t.numel() * t.element_size()
                                 for lc in out["layers"] for t in lc.values())
        return out
    eng._snapshot_totals = timed_snapshot
    prefill_ms, decode_ms = time_dispatches(eng)

    def on_step():
        now = time.perf_counter()
        for r in [s.req for s in eng._slots.values()] + eng.completed:
            if r.output and r.uid not in ttft:
                ttft[r.uid] = (now - r.t_submit) * 1e3
        row = eng._page_table
        peak_mapped[0] = max(peak_mapped[0], len(np.unique(row[row > 0])))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for r in reqs[:3]:
        eng.submit(r)
    drive(eng, on_step)
    for r in reqs[3:]:
        eng.submit(r)
    drive(eng, on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    check_pool_invariants(eng)
    held = 0
    if eng._pcache is not None:
        held = sum(t.numel() * t.element_size()
                   for n in eng._pcache._iter_nodes() if n.totals is not None
                   for lc in n.totals["layers"] for t in lc.values())
    done = eng.completed
    if sorted(r.uid for r in done) != list(range(n_reqs)) or any(
            len(r.output) != PREFIX_NEW for r in done) or len(first) != n_reqs:
        raise AssertionError("not every request produced its tokens")
    out = {"tokens": {r.uid: list(r.output) for r in done}, "first": first,
           "stats": dict(eng.stats), "launches": launches, "ttft": ttft,
           "prefill_ms": prefill_ms, "decode_ms": decode_ms,
           "peak_mapped": peak_mapped[0], "snap": snap, "held": held,
           "peak": torch.cuda.max_memory_allocated(), "wall": wall,
           "prompts": [len(r.prompt) for r in reqs], "suffix": suffix,
           "cached_pages": (eng._pcache.n_nodes if eng._pcache else 0)}
    # the hooks' bound methods hold the engine too: drop them all, so that
    # its pool is freed before the next run allocates one
    del eng, sample, take
    free_cuda()
    return out


def phase_lm_prefix(model, params, tag, n_reqs, decode_key, decode_fn):
    """The lm-prefix traffic cache-off, then cache-on, on the same weights:
    first-token logits bit-equal, greedy tokens under the margin rule,
    the hits, copies and prefill tokens the prompts give, the pool
    invariants after the run, every kernel launched once per layer and
    dispatch."""
    import numpy as np
    import torch
    from repro_torch.kernels import sla2_decode_paged as KP
    counters = {decode_key: decode_fn,
                "paged_flash_prefill": KP.paged_flash_prefill}
    margins = {}
    off = serve_prefix(model, params, counters, n_reqs, False, margins)
    on = serve_prefix(model, params, counters, n_reqs, True)
    n_layers = model.cfg.n_layers
    for name, run in (("off", off), ("on", on)):
        st, launches = run["stats"], run["launches"]
        want = {decode_key: n_layers * st["decode_steps"],
                "paged_flash_prefill": n_layers * st["prefill_chunks"]}
        log(f"[{tag}] cache {name}: {n_reqs} requests in "
            f"{st['engine_steps']} engine steps, {run['wall']:.1f} s; "
            f"prefill_tokens {st['prefill_tokens']}, prefill_chunks "
            f"{st['prefill_chunks']}, {st['decode_steps']} decode steps; "
            f"launches {launches} (want {want}); prefix hits "
            f"{st['prefix_hits']}, misses {st['prefix_misses']}, hit tokens "
            f"{st['prefix_hit_tokens']}, inserts {st['prefix_inserts']}, "
            f"evictions {st['prefix_evictions']}, cow_copies "
            f"{st['cow_copies']}")
        per_slot = {n: (round(float(np.median(v)), 3), len(v))
                    for n, v in sorted(run["decode_ms"].items())}
        log(f"[{tag}] cache {name}: time to first token by request (ms) "
            f"{[round(run['ttft'][u], 1) for u in range(n_reqs)]}; ms per "
            f"prefill chunk median "
            f"{float(np.median(run['prefill_ms'])):.1f} (count "
            f"{len(run['prefill_ms'])}); ms per decode step by active slots "
            f"(median, count) {per_slot}; "
            f"peak pages mapped by active slots {run['peak_mapped']}, peak "
            f"allocated {st['pool_peak_pages']}; totals snapshots "
            f"{run['snap']['n']} copies, {run['snap']['bytes'] / 2**20:.1f} "
            f"MiB copied in {run['snap']['ms']:.1f} ms, "
            f"{run['held'] / 2**20:.1f} MiB held by {run['cached_pages']} "
            f"cached pages; peak memory {run['peak'] / 2**30:.2f} GiB")
        if launches != want or 0 in launches.values():
            raise AssertionError(f"[{tag}] cache {name}: the path did not run "
                                 f"each paged kernel once per layer and "
                                 f"dispatch")
    same = [u for u in range(n_reqs)
            if torch.equal(off["first"][u], on["first"][u])]
    stops = compare_tokens(tag, off["tokens"], on["tokens"], margins)
    n_full = sum(1 for n in on["suffix"][3:] if n == 0)
    want = {"prefix_hits": n_reqs - 3, "cow_copies": n_full * LM_CHUNK //
            model.cfg.block_k, "prefix_evictions": 0,
            "prefill_tokens": sum(on["prompts"][:3]) + sum(on["suffix"][3:])
            + n_full * LM_CHUNK}
    got = {k: on["stats"][k] for k in want}
    log(f"[{tag}] first-token logits bit-equal cache off / on for "
        f"{len(same)} of {n_reqs} requests; greedy tokens equal up to the "
        f"stops {stops}; cache-on stats {got} (want {want}); prefill tokens "
        f"on / off {on['stats']['prefill_tokens']} / "
        f"{off['stats']['prefill_tokens']} = "
        f"{on['stats']['prefill_tokens'] / off['stats']['prefill_tokens']:.3f}"
        f"; pool invariants hold after both runs")
    if len(same) != n_reqs or got != want \
            or off["stats"]["prefill_tokens"] != sum(off["prompts"]):
        raise AssertionError(f"[{tag}] the prefix cache changed the first "
                             f"tokens' logits or missed its hits, copies or "
                             f"prefill tokens")
    return {"off": off, "on": on, "stops": stops}


def phase_lm_prefix_context():
    """qwen3-14b at full width, 2 layers, f32 weights and pages, the linear
    drafter on: two 1536-token system prompts cached, then three requests
    on the first under a pool too small for them, once with swap and once
    without.  Evictions of the other prompt's pages and preemptions of
    slots that hold shared pages; tokens identical to an undisturbed
    cache-off run; the pool invariants after every step; no verify window
    writes a shared page."""
    import numpy as np
    from repro_torch.configs.qwen3_14b import config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Request
    model = build_model(config(n_layers=2, dtype="float32"))
    params = model.init(SEED + 26, device=DEV)
    rng = np.random.default_rng(SEED + 27)
    v = model.cfg.vocab_size
    sys_p = [rng.integers(1, v, 1536).astype(np.int32) for _ in range(2)]
    warm = [np.concatenate([p, rng.integers(1, v, 100).astype(np.int32)])
            for p in sys_p]
    hot = [np.concatenate([sys_p[0], rng.integers(1, v, n).astype(np.int32)])
           for n in (700, 650, 600)]

    def run(prefix_cache, **kw):
        eng = lm_engine(model, params, max_slots=3, max_len=4096,
                        page_dtype="float32", speculative="linear",
                        draft_len=3, prefix_cache=prefix_cache, **kw)
        verify = eng.model.decode_verify
        windows = [0]

        def guarded(p, batch, caches):
            lengths = batch["lengths"].tolist()
            wlen = batch["window_len"].tolist()
            active = batch["active"].tolist()
            for slot, st in eng._slots.items():
                if not active[slot]:
                    continue
                lo = lengths[slot] // eng.page_size
                hi = (lengths[slot] + wlen[slot] - 1) // eng.page_size
                if lo < st.n_shared or any(
                        eng.allocator.refcount(int(eng._page_table[slot, lg]))
                        != 1 for lg in range(lo, hi + 1)):
                    raise AssertionError("a verify window writes a shared "
                                         "page")
                windows[0] += 1
            return verify(p, batch, caches)
        eng.model = dataclasses.replace(eng.model, decode_verify=guarded)
        on_step = (lambda: check_pool_invariants(eng)) if prefix_cache \
            else None
        for i, p in enumerate(warm):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=16))
            drive(eng, on_step)
        for i, p in enumerate(hot, start=len(warm)):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=16))
        drive(eng, on_step)
        out = {r.uid: r.output for r in eng.completed}
        st = dict(eng.stats)
        del eng
        free_cuda()
        return out, st, windows[0]

    want, _, _ = run(False)
    stats = {}
    for name, extra in (("swap", {}), ("recompute", {"swap_pages": 0})):
        out, st, windows = run(True, num_pages=57, **extra)
        stats[name] = st
        log(f"[lm-prefix-context] 2 layers, f32, linear drafter, pool of 57 "
            f"pages, {name}: prefix hits {st['prefix_hits']}, evictions "
            f"{st['prefix_evictions']}, cow_copies {st['cow_copies']}, "
            f"preemptions {st['preemptions']}, swap-outs {st['swap_outs']}, "
            f"recomputes {st['recomputes']}; {windows} verify windows "
            f"checked clear of shared pages; pool invariants after every "
            f"step; tokens identical to the undisturbed cache-off run: "
            f"{out == want}")
        if out != want:
            raise AssertionError(f"[lm-prefix-context] {name}: the prefix "
                                 f"cache under preemption changed the tokens")
        if not (st["prefix_evictions"] > 0 and st["preemptions"] > 0
                and st["prefix_hits"] >= 3 and windows > 0):
            raise AssertionError(f"[lm-prefix-context] {name}: no eviction, "
                                 f"preemption, hit or verify window")
    if not (stats["swap"]["swap_outs"] >= 1
            and stats["recompute"]["recomputes"] >= 1):
        raise AssertionError("[lm-prefix-context] the small pool forced no "
                             "swap-out or no recompute")
    del params
    free_cuda()
    return stats


def kernel_case(tag, fn, plain, args, kw, bound, library=None, iters=50):
    """Hold one captured call of a wrapper against its plain version and
    time it: a loop of calls and, for the decode kernels, calls replayed
    from a CUDA graph.  Returns (max abs err, ms, ms from a graph or None,
    plain ms, bound ms, library ms or None)."""
    import torch
    with torch.no_grad():
        o = fn(*args, **kw)
        torch.cuda.synchronize()
        po = plain(*args, **kw)
        err, abs_err = rel_err(o, po), float((o - po).abs().max())
        if not err < BOUNDS["none"]:
            raise AssertionError(f"[lm-internlm2] {tag} disagrees with its "
                                 f"plain version: rel err {err:.3e}")
        ms = cuda_ms(lambda: fn(*args, **kw), iters=iters)
        ms_graph = (graph_ms(lambda: fn(*args, **kw)) if iters > 10
                    else None)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=2, warmup=1)
    lib = library() if library is not None else None
    log(f"[lm-internlm2] {tag}: rel max err {err:.3e} (bound 2e-5), max abs "
        f"err {abs_err:.3e}; kernel {ms:.4f} ms in a loop of calls"
        + (f" ({ms_graph:.4f} ms from a CUDA graph)" if ms_graph else "")
        + f", plain {plain_ms:.3f} ms, bound {bound:.4f} ms, "
        f"{bound / ms:.1%} of bound; library "
        + ("none" if lib is None else
           f"{lib if isinstance(lib, float) else lib[0]:.4f} ms"))
    return abs_err, ms, ms_graph, plain_ms, bound, lib


def phase_lm_internlm2():
    """internlm2-20b at full width and depth (48 layers, 48 query / 8 KV
    heads: n_rep 6), bf16, random weights: layer 0's paged kernels against
    their plain versions and timed; the lm-serve traffic at max_len
    INTERN_MAX_LEN through the fused engine (48 launches a dispatch and a
    chunk) and the gather engine (tokens under the margin rule)."""
    import torch
    from repro_torch.configs import internlm2_20b
    from repro_torch.kernels import sla2_decode_paged as KP
    from repro_torch.models import attention as A
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import _pool_page_bytes
    model = build_model(internlm2_20b.config())
    cfg = model.cfg
    t0 = time.perf_counter()
    params = model.init(SEED, device=DEV)
    n_params = sum(p.numel() for p in params.parameters())
    bk, hkv = cfg.block_k, cfg.num_kv_heads
    n_rep = cfg.num_heads // hkv
    log(f"[model] {cfg.name}: {n_params / 1e9:.3f} B params "
        f"({n_params * 2 / 1e9:.1f} GB in bf16), {cfg.n_layers} layers, "
        f"{cfg.num_heads} / {hkv} heads (n_rep {n_rep}), init "
        f"{time.perf_counter() - t0:.1f} s")
    over = dict(max_len=INTERN_MAX_LEN)
    full = lambda e: sum(s.decoding for s in e._slots.values()) == LM_SLOTS
    cap = capture_layer0(model, params, **over)
    cap.update(capture_layer0(model, params, {
        "sla2_decode_verify": lambda e, a, k: full(e)
        and a[0].shape[2] == 4}, new_tokens=64, speculative="linear",
        draft_len=3, **over))
    dense_model, dense_p = dense_model_params(model, params)
    cap.update(capture_layer0(dense_model, dense_p, {
        "dense_decode_fused": lambda e, a, k: full(e)}, **over))
    cap.update(capture_layer0(dense_model, dense_p, {
        "dense_decode_verify": lambda e, a, k: full(e)
        and a[0].shape[2] == 4}, speculative="ngram", draft_len=3, **over))

    # the lm-serve traffic, its last 8192-token chunk captured
    last = {}
    entry = A.fused_entry_fn

    def capture_last(eng):
        def capturing(name):
            fn = entry(name)

            def run(*args, **kw):
                if (name == "paged_flash_prefill" and "p" not in last
                        and int(kw["offset"]) == LM_PROMPTS[0] - LM_CHUNK):
                    last["p"] = ([_clone(a) for a in args],
                                 {k: _clone(x) for k, x in kw.items()})
                return fn(*args, **kw)
            return run
        A.fused_entry_fn = capturing
        pool = _pool_page_bytes(eng.caches) * eng.allocator.num_pages
        log(f"[lm-internlm2] engine of {LM_SLOTS} slots at max_len "
            f"{INTERN_MAX_LEN} (cut from {LM_MAX_LEN}): "
            f"{eng.allocator.num_pages} pages, pool {pool / 1e9:.2f} GB")

    margins = {}
    try:
        run = serve_lm(model, params, {
            "sla2_decode_paged": KP.sla2_decode_verify,
            "paged_flash_prefill": KP.paged_flash_prefill}, margins=margins,
            on_engine=capture_last, **over)
    finally:
        A.fused_entry_fn = entry
    check_launches("lm-internlm2", run, cfg.n_layers, "sla2_decode_paged",
                   "decode_steps")
    log(f"[lm-internlm2] ms per prefill chunk "
        f"{[round(t, 1) for t in run['prefill_ms']]}")
    log(f"[lm-internlm2] ms per decode step by active slots (median, "
        f"count): {run['decode_ms']}; peak memory "
        f"{run['peak'] / 2**30:.2f} GiB")
    gather = serve_lm(model, params, {}, paged_impl="gather", **over)
    stops = compare_tokens("lm-internlm2 gather", run["tokens"],
                           gather["tokens"], margins)
    log(f"[lm-internlm2] gather engine: {gather['wall']:.1f} s, peak memory "
        f"{gather['peak'] / 2**30:.2f} GiB; greedy tokens equal the fused "
        f"engine's up to the stops {stops}")

    res = {"launches": run["launches"], "stops": stops}
    args, kw = cap["sla2_decode_fused"]
    res["decode"] = kernel_case(
        f"sla2_decode W 1 q{tuple(args[0].shape)} t_new "
        f"{args[7].tolist()}, valid entries {int(args[5].sum())}/"
        f"{args[5].numel()}, complete {int(args[6].sum())}",
        KP.sla2_decode_fused,
        KP.sla2_decode_fused_plain, args, kw, decode_bound_ms(args))
    args, kw = cap["sla2_decode_verify"]
    res["decode_w4"] = kernel_case(
        f"sla2_decode W 4 q{tuple(args[0].shape)}, valid entries "
        f"{int(args[5].sum())}/{args[5].numel()}", KP.sla2_decode_verify,
        KP.sla2_decode_verify_plain, args, kw, decode_bound_ms(args))
    for key, name in (("dense", "dense_decode_fused"),
                      ("dense_w4", "dense_decode_verify")):
        args, kw = cap[name]
        q, kp, vp, table, t_new = args[:5]
        qv = q if q.dim() == 5 else q[:, :, None]
        tv = t_new if t_new.dim() == 2 else t_new[:, None]
        res[key] = kernel_case(
            f"{name} q{tuple(q.shape)} t_new {t_new.tolist()}",
            getattr(KP, name), getattr(KP, name + "_plain"), args, kw,
            dense_bound_ms(qv, kp, table, tv, bk),
            lambda: dense_sdpa_ms(qv, kp, vp, table, tv))
    for key, (args, kw) in (("prefill", cap["paged_flash_prefill"]),
                            ("prefill_last", last["p"])):
        ops_, nbytes = prefill_work(args[0], args[3], kw["offset"], bk,
                                    kw["n_rep"], kw["window"],
                                    kw["prefix_len"])
        bound = max(ops_ / PEAK_BF16_OPS, nbytes / PEAK_BYTES) * 1e3
        res[key] = kernel_case(
            f"paged_prefill offset {kw['offset']} q{tuple(args[0].shape)}",
            KP.paged_flash_prefill, KP.paged_flash_prefill_plain, args, kw,
            bound, lambda: sdpa_ms(args[0], args[1], args[2], args[3],
                                   kw["offset"], kw["n_rep"]), iters=10)
        res[key + "_offset"] = int(kw["offset"])
    del cap, last, params, dense_p
    free_cuda()
    return res


def lm_layer0_qkv(model, params, tokens):
    """Layer 0's q, k, v (B*H, N, Dh) of the LM on tokens (B, N), K/V
    repeated to the query heads, and its causal routing, as
    ``attention_forward`` gives them to the sparse-branch kernel."""
    import torch
    from repro_torch.core import router as R
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    cfg = model.cfg
    acfg = cfg.attention_config()
    b, n = tokens.shape
    lp = params.layers[0]
    x = L.embed(params.embed, tokens).to(cfg.param_dtype)
    pos = torch.arange(n, device=DEV)[None].expand(b, n)
    q, k, v = A._project_qkv(lp.attn, acfg, L.rmsnorm(lp.ln1, x), pos)
    n_rep = cfg.num_heads // cfg.num_kv_heads
    q = q.transpose(1, 2)
    k, v = (A._repeat_kv(t.transpose(1, 2), n_rep) for t in (k, v))
    q, k, v = (t.reshape(b * cfg.num_heads, n, cfg.head_dim).contiguous()
               for t in (q, k, v))
    idx, valid = R.route_indices(lp.attn.sla2.router, q, k,
                                 acfg.router_config())
    return q, k, v, idx, valid.to(torch.int32)


def phase_lm_static(model, params, dense_model, dense_p, dense_run):
    """qwen3-14b at full width and depth on the static cache: the SLA2
    model (sla2_impl "kernel", int8 QAT) serves the lm-serve prompts as one
    wave through StaticWaveEngine; layer 0's causal prefill goes through
    sparse_flash_fwd and its plain version; the dense model's static path
    is held to lm-dense-serve on the 8192-token prompt (see the module
    docstring, phase 17)."""
    import numpy as np
    import torch
    from repro_torch.core.quant import smooth_k
    from repro_torch.kernels.sla2_fwd import (sparse_flash_fwd,
                                              sparse_flash_fwd_plain)
    from repro_torch.serve.engine import (EngineConfig, Request,
                                          StaticWaveEngine,
                                          generate_sequential,
                                          make_mixed_requests)
    km = model.with_overrides(sla2_impl="kernel", quant_bits="int8")
    cfg = km.cfg
    bq, bk = cfg.block_q, cfg.block_k
    max_len = LM_PROMPTS[0] + bk
    reqs = make_mixed_requests(cfg.vocab_size,
                               [(n, LM_NEW) for n in LM_PROMPTS], seed=SEED)
    eng = StaticWaveEngine(km, EngineConfig(max_slots=LM_SLOTS,
                                            max_len=max_len), device=DEV)
    eng.load(params)
    step_ms = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sparse_flash_fwd.launches = 0
    for r in reqs:
        eng.submit(r)
    while True:
        t0 = time.perf_counter()
        active = eng.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if active == 0 and not eng._queue:
            break
    launches = sparse_flash_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    done = sorted(eng.completed, key=lambda r: r.uid)
    del eng
    free_cuda()
    log(f"[lm-static] StaticWaveEngine(max_slots={LM_SLOTS}, max_len "
        f"{max_len}): one wave of prompts {list(LM_PROMPTS)} left-padded to "
        f"{LM_PROMPTS[0]}, {LM_NEW} new tokens each; sparse_flash_fwd "
        f"launches {launches} (want {cfg.n_layers}: one per layer of the "
        f"wave prefill; decode runs the static SLA2 decode); wave prefill "
        f"{step_ms[0]:.1f} ms, decode steps median "
        f"{float(np.median(step_ms[1:])):.1f} ms over {len(step_ms) - 1}; "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"[lm-static] tokens: " + "; ".join(
        f"{r.uid} (prompt {len(r.prompt)}): {r.output}" for r in done))
    if launches != cfg.n_layers:
        raise AssertionError("[lm-static] the wave prefill did not run "
                             "sparse_flash_fwd once per layer")
    if [r.uid for r in done] != [r.uid for r in reqs] or any(
            len(r.output) != LM_NEW or min(r.output) < 0
            or max(r.output) >= cfg.vocab_size for r in done):
        raise AssertionError("[lm-static] not every request produced its "
                             "tokens")

    kw = dict(block_q=bq, block_k=bk, causal=True, quant_bits="int8")
    with torch.inference_mode():
        tok = torch.as_tensor(reqs[0].prompt, device=DEV)[None]
        q, k, v, idx, valid = lm_layer0_qkv(km, params, tok)
        k = smooth_k(k).contiguous()
        o, lse = sparse_flash_fwd(q, k, v, idx, valid, **kw)
        torch.cuda.synchronize()
        po, pl = sparse_flash_fwd_plain(q, k, v, idx, valid, **kw)
        err, abs_err = rel_err(o, po), float((o.float() - po.float()).abs()
                                             .max())
        lse_err = float((lse - pl).abs().max())
        ms = cuda_ms(lambda: sparse_flash_fwd(q, k, v, idx, valid, **kw),
                     iters=20)
        plain = cuda_ms(lambda: sparse_flash_fwd_plain(q, k, v, idx, valid,
                                                       **kw),
                        iters=2, warmup=1)
    bms, by = bound_ms(q, idx, valid, bq, bk)
    floor = fwd_gather_floor_ms(q, valid, bq, bk)
    log(f"[lm-static] layer-0 causal prefill q{tuple(q.shape)} (B 1, "
        f"{cfg.num_heads} heads, K/V repeated from {cfg.num_kv_heads}) "
        f"{q.dtype} int8 K_sel={idx.shape[-1]}, "
        f"{int(valid.sum())} valid routed pairs: rel max err {err:.3e} "
        f"(bound 1e-3), max abs err {abs_err:.3e}, lse {lse_err:.3e}; "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bms:.4f} ms "
        f"({by}), {bms / ms:.1%} of bound; gathered-bytes floor "
        f"{floor:.4f} ms, {floor / ms:.1%} of it")
    if not (err < BOUNDS["int8"] and lse_err < 1e-3
            and bool(torch.isfinite(o).all())):
        raise AssertionError("[lm-static] the causal forward disagrees with "
                             "its plain version")
    del q, k, v, o, po
    free_cuda()

    # the dense model on the static cache against lm-dense-serve: free
    # running (generate_sequential), then fed lm-dense-serve's tokens
    want = dense_run["tokens"][0]
    t0 = time.perf_counter()
    seq = generate_sequential(dense_model, dense_p, reqs[0].prompt,
                              max_new_tokens=LM_NEW, max_len=max_len,
                              device=DEV)
    seq_s = time.perf_counter() - t0
    first = next((i for i, (a, b) in enumerate(zip(seq, want)) if a != b),
                 None)
    caches = dense_model.init_caches(1, max_len, device=DEV)
    rows = []
    with torch.inference_mode():
        lg, caches = dense_model.prefill(dense_p, {"tokens": torch.as_tensor(
            reqs[0].prompt, device=DEV)[None]}, caches)
        rows.append(lg[0].float().cpu())
        for t in want[:-1]:
            lg, caches = dense_model.decode(dense_p, {"token": torch.tensor(
                [t], dtype=torch.int32, device=DEV)}, caches)
            rows.append(lg[0].float().cpu())
    del caches
    free_cuda()
    rels, flips = [], []
    for i, (a, b) in enumerate(zip(rows, dense_run["rows"])):
        rels.append(float(torch.linalg.norm(a - b) / torch.linalg.norm(b)))
        diff = float((a - b).abs().max())
        margin = dense_run["margins"][(0, i)][0]
        if int(torch.argmax(a)) != want[i]:
            flips.append({"pos": i, "margin": margin, "max_abs_diff": diff})
            if not margin < diff:
                raise AssertionError(
                    f"[lm-static] fed lm-dense-serve's tokens, the static "
                    f"path picks another token at {i} where lm-dense-serve's"
                    f" top-2 margin {margin:.4g} exceeds the largest logit "
                    f"difference {diff:.4g}")
    # the first token's logits of the paged engine's own gather reference
    # (f32 attention over the gathered pages, as the static path computes
    # it) beside its fused kernels: how far two valid attention
    # implementations land apart through 40 bf16 layers
    eng = lm_engine(dense_model, dense_p, paged_impl="gather")
    gather_rows = []
    record_rows(eng, 0, gather_rows)
    eng.submit(Request(uid=0, prompt=reqs[0].prompt, max_new_tokens=1))
    eng.run_to_completion()
    del eng
    free_cuda()
    rel_to = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    noise = rel_to(gather_rows[0], dense_run["rows"][0])
    static_gather = rel_to(rows[0], gather_rows[0])
    log(f"[lm-static] generate_sequential of the dense model on the "
        f"{LM_PROMPTS[0]}-token prompt, {LM_NEW} tokens in {seq_s:.1f} s: "
        f"{seq}; first departure from lm-dense-serve's tokens at "
        f"{first} (lm-dense-serve's top-2 margin there "
        f"{dense_run['margins'][(0, first)][0] if first is not None else 0:.4g})")
    log(f"[lm-static] fed lm-dense-serve's tokens: logits rel norm err per "
        f"position max {max(rels):.3e}, median "
        f"{float(np.median(rels)):.3e} (bound 0.05); argmax differs at "
        f"{flips} (each where lm-dense-serve's margin is below the largest "
        f"logit difference); first-token logits of the paged gather engine "
        f"against the fused one {noise:.3e}, the static path against the "
        f"gather engine {static_gather:.3e}")
    if not max(rels) < 0.05 or len(rels) != LM_NEW:
        raise AssertionError("[lm-static] the static dense path departs from "
                             "the paged engine")
    return {"launches": launches, "err": err, "max_abs_err": abs_err,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "gather_floor_ms": floor, "step_ms": step_ms, "rel": max(rels),
            "gather_vs_fused": noise, "static_vs_gather": static_gather,
            "flips": flips, "first_departure": first}


def phase_lm_static_context():
    """qwen3-14b at 2 layers, f32 weights and caches: SLA2 prefill logits
    of the kernel and gather impls (quant none) within 1e-3; the dense
    model's generate_sequential against the paged ServeEngine, tokens
    identical; 'sla' and 'sparse_only' through StaticWaveEngine."""
    import numpy as np
    import torch
    from repro_torch.configs.qwen3_14b import config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import (EngineConfig, StaticWaveEngine,
                                          generate_sequential,
                                          make_mixed_requests)
    work = [(2000, 16), (900, 16), (300, 16)]
    n_pad, max_len = 2048, 2048 + 64
    model = build_model(config(n_layers=2, dtype="float32",
                               quant_bits="none"))
    params = model.init(SEED + 25, device=DEV)
    reqs = make_mixed_requests(model.cfg.vocab_size, work, seed=SEED + 23)
    toks = np.zeros((len(work), n_pad), np.int32)
    for i, r in enumerate(reqs):
        toks[i, n_pad - len(r.prompt):] = r.prompt
    logits = {}
    for impl in ("kernel", "gather"):
        m = model.with_overrides(sla2_impl=impl)
        caches = m.init_caches(len(work), max_len, dtype=torch.float32,
                               device=DEV)
        with torch.inference_mode():
            logits[impl], _ = m.prefill(
                params, {"tokens": torch.as_tensor(toks, device=DEV)}, caches)
        del caches
        free_cuda()
    rel = float(torch.linalg.norm(logits["kernel"] - logits["gather"])
                / torch.linalg.norm(logits["gather"]))
    log(f"[lm-static-context] 2 layers, f32, quant none: SLA2 prefill "
        f"logits of {len(work)} prompts left-padded to {n_pad}, kernel vs "
        f"gather rel norm err {rel:.3e} (bound 1e-3)")
    if not rel < 1e-3:
        raise AssertionError("[lm-static-context] kernel and gather prefill "
                             "disagree")
    del params, model, logits
    free_cuda()

    dense = build_model(config(n_layers=2, dtype="float32", mechanism="full"))
    dp = dense.init(SEED + 26, device=DEV)
    seq = {r.uid: generate_sequential(dense, dp, r.prompt,
                                      max_new_tokens=r.max_new_tokens,
                                      max_len=max_len,
                                      cache_dtype="float32", device=DEV)
           for r in make_mixed_requests(dense.cfg.vocab_size, work,
                                        seed=SEED + 23)}
    eng = lm_engine(dense, dp, max_slots=3, max_len=4096,
                    page_dtype="float32")
    for r in make_mixed_requests(dense.cfg.vocab_size, work, seed=SEED + 23):
        eng.submit(r)
    paged = {r.uid: r.output for r in eng.run_to_completion()}
    del eng, dp, dense
    free_cuda()
    log(f"[lm-static-context] dense, 2 layers, f32: generate_sequential "
        f"tokens equal the paged ServeEngine's: {seq == paged}")
    if seq != paged:
        raise AssertionError("[lm-static-context] generate_sequential and "
                             "the paged engine disagree")

    for mech in ("sla", "sparse_only"):
        m = build_model(config(n_layers=2, dtype="float32", mechanism=mech))
        mp = m.init(SEED + 27, device=DEV)
        eng = StaticWaveEngine(m, EngineConfig(max_slots=3, max_len=max_len),
                               device=DEV)
        eng.load(mp)
        finite = []
        sample = eng._sample

        def checked(lg):
            finite.append(bool(torch.isfinite(lg).all()))
            return sample(lg)
        eng._sample = checked
        for r in make_mixed_requests(m.cfg.vocab_size, [(n, 8) for n, _ in
                                                        work],
                                     seed=SEED + 23):
            eng.submit(r)
        out = {r.uid: r.output for r in eng.run_to_completion()}
        ok = (all(finite) and sorted(out) == [0, 1, 2]
              and all(len(t) == 8 and 0 <= min(t) and max(t) < m.cfg.vocab_size
                      for t in out.values()))
        log(f"[lm-static-context] {mech} (dense-masked O(N^2) baseline), 2 "
            f"layers, f32: StaticWaveEngine tokens {out}; logits finite at "
            f"{len(finite)} sampling points: {ok}")
        del eng, mp, m
        free_cuda()
        if not ok:
            raise AssertionError(f"[lm-static-context] {mech} gave no finite "
                                 f"tokens")
    return rel


def phase_lm_train():
    """make_train_step on qwen3-14b at full width, depth cut to 2 layers:
    int8 QAT forward through the kernels, remat "full", sequences of
    LM_TRAIN_N tokens, 2 microbatches of one sequence, 3 AdamW steps, with
    exact launch counts; then layer 0's causal dQ and dK/dV against their
    plain version."""
    import torch
    from repro_torch.configs.qwen3_14b import config
    from repro_torch.core.quant import smooth_k
    from repro_torch.data import make_dataset
    from repro_torch.kernels import sla2_bwd as B
    from repro_torch.kernels.sla2_bwd import sparse_flash_bwd
    from repro_torch.kernels.sla2_fwd import sparse_flash_fwd
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    model = build_model(config(n_layers=LM_TRAIN_LAYERS, sla2_impl="kernel",
                               quant_bits="int8", remat="full"))
    cfg = model.cfg
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=1,
                       total_steps=TRAIN_STEPS, microbatches=MICROBATCHES)
    state = init_train_state(model, SEED + 30, tcfg, device=DEV)
    params = state["params"]
    ds = make_dataset(cfg, seq_len=LM_TRAIN_N, global_batch=MICROBATCHES,
                      seed=SEED + 31)
    step_fn = make_train_step(model, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sparse_flash_fwd.launches = 0
    sparse_flash_bwd.launches_dq = sparse_flash_bwd.launches_dkv = 0
    losses, step_ms = [], []
    for step in range(TRAIN_STEPS):
        batch = {key: torch.as_tensor(val, device=DEV)
                 for key, val in ds[step].items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step == 0:
            bad = [name for name, t in state["opt"]["m"].items()
                   if not bool(torch.isfinite(t).all())
                   or (".router." in name) == bool(t.abs().max() > 0)]
            if bad:
                raise AssertionError(
                    f"[lm-train] after step 1, AdamW m is non-finite, zero "
                    f"outside the router or non-zero in it for {bad[:5]}")
    launches = {"sparse_flash_fwd": sparse_flash_fwd.launches,
                "sparse_flash_bwd_dq": sparse_flash_bwd.launches_dq,
                "sparse_flash_bwd_dkv": sparse_flash_bwd.launches_dkv}
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in params.parameters())
    per = cfg.n_layers * MICROBATCHES * TRAIN_STEPS
    want = {"sparse_flash_fwd": 2 * per, "sparse_flash_bwd_dq": per,
            "sparse_flash_bwd_dkv": per}
    log(f"[lm-train] {cfg.name} at full width, {cfg.n_layers} layers "
        f"({n_params / 1e9:.3f} B params), {LM_TRAIN_N}-token sequences, "
        f"{TRAIN_STEPS} steps x {MICROBATCHES} microbatches of one sequence,"
        f" int8 QAT forward, remat full: losses "
        f"{[round(x, 5) for x in losses]}; ms per optimizer step "
        f"{[round(t, 1) for t in step_ms]}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[lm-train] launches {launches} (want {want}: the forward kernel "
        f"2 x layers x microbatches x steps, once in the forward and once "
        f"more when remat re-runs the layer in the backward; dQ and dK/dV "
        f"once each); every leaf but the router's got a finite non-zero "
        f"gradient")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("[lm-train] a training loss is not finite")
    if launches != want:
        raise AssertionError("[lm-train] the train path did not run every "
                             "kernel the expected number of times")

    bq, bk = cfg.block_q, cfg.block_k
    kw = dict(block_q=bq, block_k=bk, causal=True, prefix_len=0)
    g = torch.Generator(device=DEV)
    g.manual_seed(SEED + 32)
    with torch.no_grad():
        tok = torch.as_tensor(ds[0]["tokens"][:1], device=DEV)
        q, k, v, idx, valid = lm_layer0_qkv(model, params, tok)
        k = smooth_k(k).contiguous()
        o, lse = sparse_flash_fwd(q, k, v, idx, valid, quant_bits="int8",
                                  block_q=bq, block_k=bk, causal=True)
        do = torch.randn(q.shape, generator=g, device=DEV).to(q.dtype)
        got = B.sparse_flash_bwd(q, k, v, idx, valid, o, lse, do, **kw)
        torch.cuda.synchronize()
        want_g = B.sparse_flash_bwd_plain(q, k, v, idx, valid, o, lse, do,
                                          **kw)
        errs = [rel_err(a, b) for a, b in zip(got, want_g)]
        abs_errs = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, want_g)]
        runs = run_lengths(idx, valid, LM_TRAIN_N // bk).float()
        dd, is_, vs, off = B.kernel_inputs(o, do, idx, valid,
                                           LM_TRAIN_N // bk)
        times = {
            "dq": cuda_ms(lambda: B.launch_dq(q, k, v, do, lse, dd, idx,
                                              valid, **kw), iters=5),
            "dkv": cuda_ms(lambda: B.launch_dkv(q, k, v, do, lse, dd, is_,
                                                vs, off, **kw), iters=5)}
        plain = {
            "dq": cuda_ms(lambda: B.sparse_flash_dq_plain(
                q, k, v, idx, valid, o, lse, do, **kw), iters=1, warmup=1),
            "dkv": cuda_ms(lambda: B.sparse_flash_dkv_plain(
                q, k, v, idx, valid, o, lse, do, **kw), iters=1, warmup=1)}
    bounds = bwd_bounds(q, idx, valid, bq, bk)
    floors = gather_floor_ms(q, valid, bq, bk)
    log(f"[lm-train] layer-0 causal backward q{tuple(q.shape)} bf16, o/lse "
        f"from the int8 forward, {int(valid.sum())} routed pairs: rel max "
        f"err dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (bound "
        f"2^-7), max abs err {abs_errs[0]:.3e} / {abs_errs[1]:.3e} / "
        f"{abs_errs[2]:.3e}")
    log(f"[lm-train] dK/dV run lengths (valid pairs per (bh, kv block)): "
        f"mean {float(runs.mean()):.2f}, p99 "
        f"{float(torch.quantile(runs, 0.99)):.0f}, max {int(runs.max())} "
        f"(kv block {int(runs.max(dim=0).values.argmax())}), empty "
        f"{int((runs == 0).sum())} of {runs.numel()}")
    for name in ("dq", "dkv"):
        b16, by, f32 = bounds[name]
        log(f"[lm-train] BH={q.shape[0]} causal {name}: kernel "
            f"{times[name]:.3f} ms, plain {plain[name]:.3f} ms, bound "
            f"{b16:.4f} ms ({by}, bf16 tensor cores; {f32:.3f} ms on f32 "
            f"CUDA cores), {b16 / times[name]:.1%} of bound; gathered-bytes "
            f"floor {floors[name]:.4f} ms, "
            f"{floors[name] / times[name]:.1%} of it")
    if not all(e <= BF16_TWO_ULPS for e in errs):
        raise AssertionError("[lm-train] the causal backward kernels "
                             "disagree with their plain version")
    del state, params, q, k, v, o, do, got, want_g
    free_cuda()
    return {"launches": launches, "step_ms": step_ms, "peak": peak,
            "abs_err": {"dq": abs_errs[0], "dkv": max(abs_errs[1:])},
            "times": times, "plain": plain, "bounds": bounds,
            "gather_floor": floors}


def phase_lm_train_context():
    """2 layers, quant none: loss and gradient through the kernels against
    the gather path; then Trainer for 2 steps with a checkpoint each step,
    restored bitwise by a fresh Trainer."""
    import tempfile

    import torch
    from repro_torch.checkpoint import all_steps
    from repro_torch.configs.qwen3_14b import config
    from repro_torch.data import make_dataset
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer, TrainerConfig
    model = build_model(config(n_layers=LM_TRAIN_LAYERS, quant_bits="none",
                               sla2_impl="kernel"))
    params = model.init(SEED + 33, device=DEV)
    batch = {key: torch.as_tensor(val, device=DEV) for key, val in
             make_dataset(model.cfg, seq_len=LM_TRAIN_N, global_batch=1,
                          seed=SEED + 34)[0].items()}
    names, leaves = zip(*params.named_parameters())
    res = {}
    for impl in ("kernel", "gather"):
        loss, _ = model.with_overrides(sla2_impl=impl).loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        res[impl] = (float(loss.detach()),
                     [torch.zeros_like(p, dtype=torch.float32) if gr is None
                      else gr.float() for p, gr in zip(leaves, grads)])
        del grads, loss
    (lk, gk), (lg, gg) = res["kernel"], res["gather"]
    loss_rel = abs(lk - lg) / abs(lg)
    num = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b in zip(gk, gg)))
    den = math.sqrt(sum(float((b ** 2).sum()) for b in gg))
    log(f"[lm-train-context] {LM_TRAIN_LAYERS} layers, full width, "
        f"{LM_TRAIN_N} tokens, quant none: loss kernel {lk:.6f} gather "
        f"{lg:.6f} (rel err {loss_rel:.3e}, bound 1e-2); gradient rel norm "
        f"err {num / den:.3e} over {len(names)} leaves (bound 0.05)")
    if not (loss_rel < 1e-2 and num / den < 0.05):
        raise AssertionError("[lm-train-context] kernel and gather "
                             "gradients disagree")
    del res, gk, gg, params, leaves
    free_cuda()

    with tempfile.TemporaryDirectory() as d:
        tc = TrainerConfig(
            train=TrainConfig(optimizer=AdamWConfig(
                lr=1e-3, state_dtype="bfloat16"), warmup_steps=1,
                total_steps=2),
            ckpt_dir=d, max_steps=2, ckpt_every=1, keep=1, log_every=1,
            seed=SEED + 35)
        ds = make_dataset(model.cfg, seq_len=LM_CKPT_N, global_batch=1,
                          seed=SEED + 36)
        t0 = time.perf_counter()
        out = Trainer(model, tc, ds, device=DEV, log_fn=log).run()
        if all_steps(d) != [2]:
            raise AssertionError(f"checkpoints on disk: {all_steps(d)}")
        a = out.pop("state")
        free_cuda()
        back = Trainer(model, tc, ds, device=DEV, log_fn=log).run()
        b = back["state"]
        pairs = list(zip(a["params"].parameters(), b["params"].parameters()))
        for key in ("m", "v"):
            pairs += [(t, b["opt"][key][name])
                      for name, t in a["opt"][key].items()]
        same = all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in pairs)
        same = same and int(a["opt"]["step"]) == int(b["opt"]["step"]) == 2
        log(f"[lm-train-context] Trainer ({LM_CKPT_N}-token sequences, bf16 "
            f"AdamW moments, a checkpoint per step) {time.perf_counter() - t0:.1f}"
            f" s: losses {[round(x, 5) for x in out['losses']]}, a fresh "
            f"Trainer restored step 2 with {len(pairs)} leaves bitwise "
            f"equal: {same}")
        if back["losses"] or not same:
            raise AssertionError("[lm-train-context] the restored state "
                                 "differs from the saved")
        del a, b, pairs, out, back
    free_cuda()
    return loss_rel, num / den


def phase_dit_baselines():
    """wan-dit-1.3b at full width, 2 layers: fuse_branches against the
    two-pass gather at 32768 latents (quant none and int8), and the SLA
    baselines served at 4096 latents against the same engine and weights
    on the CPU in f32."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs.wan_dit_1_3b import config
    from repro_torch.models.api import build_model
    from repro_torch.serve import diffusion as DS
    out = {}
    for quant in ("none", "int8"):
        # f32 weights: in bf16 the two summation orders round apart by
        # more than the 1e-4 the comparison holds
        model = build_model(config(n_layers=2, quant_bits=quant,
                                   sla2_impl="gather", dtype="float32"))
        params = model.init(SEED + 40, device=DEV)
        perturb_(params, seed=SEED + 41)
        res = {}
        for fuse in (False, True):
            m = model.with_overrides(fuse_branches=fuse)
            eng = DS.DiffusionEngine(m, params, DS.DiffusionEngineConfig(
                max_slots=1, n_latent=N_LAT, max_steps=2,
                attn_impl="gather"), device=DEV)
            eng.submit(DS.make_video_requests(1, m.cfg, n_latent=N_LAT,
                                              steps=(2,), seed=SEED + 42)[0])
            ms = []
            while not eng.scheduler.idle:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fin = eng.step()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            res[fuse] = (fin[0].output, ms)
            del eng
            free_cuda()
        rel = float(np.linalg.norm(res[True][0] - res[False][0])
                    / np.linalg.norm(res[False][0]))
        bound = 1e-4 if quant == "none" else 0.05
        out[quant] = (rel, res[False][1], res[True][1])
        log(f"[dit-baselines] fuse_branches, 2 layers, {N_LAT} latents, "
            f"f32, quant {quant}, gather: fused vs two-pass rel norm err "
            f"{rel:.3e} (bound {bound:g}); ms per engine step two-pass "
            f"{[round(t, 1) for t in res[False][1]]}, fused "
            f"{[round(t, 1) for t in res[True][1]]}")
        if not rel < bound:
            raise AssertionError("[dit-baselines] the fused gather departs "
                                 "from the two-pass gather")
        del params, model, res
        free_cuda()

    for mech in ("sla", "sparse_only"):
        model = build_model(config(n_layers=2, mechanism=mech,
                                   quant_bits="int8", dtype="float32"))
        params = model.init(SEED + 43, device=DEV)
        perturb_(params, seed=SEED + 44)
        outs = {}
        for dev in (DEV, "cpu"):
            p = params if dev == DEV else copy.deepcopy(params).to("cpu")
            eng = DS.DiffusionEngine(model, p, DS.DiffusionEngineConfig(
                max_slots=1, n_latent=BASELINE_N_LAT, max_steps=2), device=dev)
            eng.submit(DS.make_video_requests(
                1, model.cfg, n_latent=BASELINE_N_LAT, steps=(2,),
                seed=SEED + 45)[0])
            t0 = time.perf_counter()
            outs[dev] = (eng.run_to_completion()[0].output,
                         time.perf_counter() - t0)
            del eng, p
        got, want = outs[DEV][0], outs["cpu"][0]
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        ok = bool(np.isfinite(got).all()) and rel < 1e-3
        qat = "int8" if mech == "sparse_only" else "no QAT, as the reference"
        log(f"[dit-baselines] {mech} ({qat}, dense-masked O(N^2)), 2 layers, "
            f"{BASELINE_N_LAT} latents, one request of 2 steps: card "
            f"{outs[DEV][1]:.1f} s, CPU {outs['cpu'][1]:.1f} s (f32 both); "
            f"rel norm err {rel:.3e} (bound 1e-3), finite {ok}")
        out[mech] = rel
        del params, model
        free_cuda()
        if not ok:
            raise AssertionError(f"[dit-baselines] {mech} on the card departs "
                                 f"from the CPU")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.configs.wan_dit_1_3b import DIT_SHAPES, config
    from repro_torch.kernels import build
    from repro_torch.kernels import sla2_decode_paged as KP
    from repro_torch.models.api import build_model
    from repro_torch.serve import diffusion as DS
    assert DIT_SHAPES["denoise_32k"]["seq_len"] == N_LAT

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {sorted(build.sources())} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for kern, res in kernel_resources(rep).items():
            if any(k in kern for k in REPORT_KERNELS):
                log(f"[build] {name}: {kern}: {res}")
    log_kernel_smem()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(config(sla2_impl="kernel"))
    t0 = time.perf_counter()
    params = model.init(SEED, device=DEV)
    perturb_(params)
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[model] {model.cfg.name}: {n_params / 1e9:.3f} B params, "
        f"init {time.perf_counter() - t0:.1f} s")
    reqs = DS.make_video_requests(3, model.cfg, n_latent=N_LAT,
                                  steps=(2, 3, 2), seed=SEED)

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[{name}] phase wall time {time.perf_counter() - t0:.1f} s")
        return out

    kern = timed("kernel", phase_kernel, model, params, reqs)
    serve = timed("serve", phase_serve, model, params, reqs)
    bwd = timed("bwd", phase_bwd, model, params, reqs)
    del params
    free_cuda()
    timed("context", phase_context)
    train = timed("train", phase_train)
    timed("train-context", phase_train_context)
    timed("stage1", phase_stage1)
    dit_heads = model.cfg.num_heads
    del model, reqs
    free_cuda()

    from repro_torch.configs import qwen3_14b
    lm_model = build_model(qwen3_14b.config())
    t0 = time.perf_counter()
    lm_params = lm_model.init(SEED, device=DEV)
    n_params = sum(p.numel() for p in lm_params.parameters())
    log(f"[model] {lm_model.cfg.name}: {n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    lm_kern = timed("lm-kernel", phase_lm_kernel, lm_model, lm_params)
    lm_serve = timed("lm-serve", phase_lm_serve, lm_model, lm_params)
    lm_spec = timed("lm-spec", phase_lm_spec, lm_model, lm_params, lm_serve)
    # the dense model shares every tensor of lm_params but the sla2 leaves,
    # so keeping both alive for lm-static costs no memory
    dense_model, dense_p = dense_model_params(lm_model, lm_params)
    free_cuda()
    lm_dkern = timed("lm-dense-kernel", phase_lm_dense_kernel, dense_model,
                     dense_p)
    lm_dense = timed("lm-dense-serve", phase_lm_dense_serve, dense_model,
                     dense_p)
    free_cuda()
    lm_prefix = timed("lm-prefix", phase_lm_prefix, lm_model, lm_params,
                      "lm-prefix", 12, "sla2_decode_paged",
                      KP.sla2_decode_verify)
    lm_prefix_dense = timed("lm-prefix-dense", phase_lm_prefix, dense_model,
                            dense_p, "lm-prefix-dense", 6,
                            "dense_decode_paged", KP.dense_decode_verify)
    timed("lm-context", phase_lm_context)
    timed("lm-spec-context", phase_lm_spec_context)
    timed("lm-prefix-context", phase_lm_prefix_context)
    lm_static = timed("lm-static", phase_lm_static, lm_model, lm_params,
                      dense_model, dense_p, lm_dense["off"] | {
                          "margins": lm_dense["margins"],
                          "rows": lm_dense["rows"]})
    del lm_params, dense_p
    free_cuda()
    lm_intern = timed("lm-internlm2", phase_lm_internlm2)
    timed("lm-static-context", phase_lm_static_context)
    lm_train = timed("lm-train", phase_lm_train)
    timed("lm-train-context", phase_lm_train_context)
    timed("dit-baselines", phase_dit_baselines)

    ms, plain, bms, by, floor = kern["timings"][dit_heads]
    no_library = ("no single PyTorch call computes a routed block-sparse "
                  "attention backward; dense SDPA's backward is another "
                  "function")
    rows = [{
        "name": "sparse_flash_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/sla2_fwd.cu",
        "replaces": "src/repro/kernels/sla2_fwd.py:176",
        "launches": serve["launches"],
        "launches_by_path": {"serve": serve["launches"],
                             "train": train["sparse_flash_fwd"],
                             "lm_static_wave_prefill": lm_static["launches"],
                             "lm_train": lm_train["launches"][
                                 "sparse_flash_fwd"]},
        "max_abs_err": kern["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "gather_floor_ms": floor,
        "lm_causal": {
            "shape": "qwen3-14b layer-0 prefill, BH 40 (K/V repeated from "
                     "8 heads), N 8192, d 128, bq 128, bk 64, int8, causal",
            "max_abs_err": lm_static["max_abs_err"], "ms": lm_static["ms"],
            "plain_ms": lm_static["plain_ms"],
            "bound_ms": lm_static["bound_ms"],
            "bound_by": lm_static["bound_by"],
            "gather_floor_ms": lm_static["gather_floor_ms"]},
        "library_ms": None,
        "library_note": "no single PyTorch call computes routed int8 "
                        "block-sparse attention; dense SDPA is another "
                        "function"}]
    for key, line in (("dq", 211), ("dkv", 248)):
        b16, by16, f32 = bwd["bounds"][key]
        name = f"sparse_flash_bwd_{key}"
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/sla2_bwd.cu",
            "replaces": f"src/repro/kernels/sla2_bwd.py:{line}",
            "launches": train[name],
            "launches_by_path": {"train": train[name],
                                 "lm_train": lm_train["launches"][name]},
            "max_abs_err": bwd["abs_err"][key], "ms": bwd["times"][key],
            "plain_ms": bwd["plain"][key], "bound_ms": b16,
            "bound_by": by16, "bound_peak": "bf16 tensor cores, 989 TFLOP/s",
            "bound_ms_f32_cuda_cores": f32,
            "gather_floor_ms": bwd["gather_floor"][key],
            "library_ms": None, "library_note": no_library,
            "lm_causal": {
                "shape": "qwen3-14b layer-0 training backward, BH 40, N "
                         "8192, d 128, bq 128, bk 64, bf16, causal",
                "max_abs_err": lm_train["abs_err"][key],
                "ms": lm_train["times"][key],
                "plain_ms": lm_train["plain"][key],
                "bound_ms": lm_train["bounds"][key][0],
                "bound_by": lm_train["bounds"][key][1],
                "gather_floor_ms": lm_train["gather_floor"][key]}})
    d_abs, d_ms, d_plain, d_bound, d_graph, d_eps = lm_kern["decode"]
    w4_ms, w4_plain, w4_bound, _, w4_graph, w4_eps = lm_spec["w4"]
    on_prefix = lambda run, key: (run["off"]["launches"][key]
                                  + run["on"]["launches"][key])

    def n_rep6(key, w4_key=None):
        """The lm-internlm2 numbers of one kernel (n_rep 6, 48 layers)."""
        err, ms_, graph, plain_, bound, lib = lm_intern[key]
        out = {"max_abs_err": err, "ms": ms_, "ms_graph": graph,
               "plain_ms": plain_, "bound_ms": bound,
               "library_ms": lib[0] if isinstance(lib, tuple) else lib}
        if w4_key is not None:
            err, ms_, graph, plain_, bound, lib = lm_intern[w4_key]
            out.update(max_abs_err=max(out["max_abs_err"], err), ms_w4=ms_,
                       ms_w4_graph=graph, plain_ms_w4=plain_,
                       bound_ms_w4=bound,
                       library_ms_w4=lib[0] if isinstance(lib, tuple)
                       else lib)
        return out

    by_path = {"lm_serve": lm_serve["launches"]["sla2_decode_paged"],
               "lm_spec_linear": lm_spec["launches"]["sla2_decode_paged"],
               "lm_prefix": on_prefix(lm_prefix, "sla2_decode_paged"),
               "lm_internlm2": lm_intern["launches"]["sla2_decode_paged"]}
    rows.append({
        "name": "sla2_decode_paged", "route": "cuda",
        "source": "src/repro_torch/csrc/sla2_decode_paged.cu",
        "replaces": "src/repro/kernels/sla2_decode_paged.py:298",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": d_abs, "ms": d_ms, "plain_ms": d_plain,
        "bound_ms": d_bound, "bound_by": "bytes", "ms_w4": w4_ms,
        "plain_ms_w4": w4_plain, "bound_ms_w4": w4_bound,
        "ms_graph": d_graph, "ms_w4_graph": w4_graph,
        "entries_per_split": d_eps[0], "entries_per_split_w4": w4_eps[0],
        "timing": "ms: a loop of 50 wrapper calls between CUDA events; "
                  "*_graph: 20 calls replayed from a CUDA graph",
        "internlm2": {"shape": "internlm2-20b layer 0, B 4, Hkv 8, n_rep 6, "
                               "Dh 128, bk 64, bf16 pool; W 4 the linear "
                               "drafter's window",
                      **n_rep6("decode", "decode_w4")},
        "library_ms": None,
        "library_note": "no PyTorch call computes routed paged attention "
                        "with the linear complement and the alpha combine"})
    (k_ms, k_plain, k_bound, k_lib, k_pps, k_graph, k_lib_graph), w4 = (
        lm_dkern["times"][1], lm_dkern["times"][4])
    by_path = {"lm_dense_serve":
               lm_dense["off"]["launches"]["dense_decode_paged"],
               "lm_spec_ngram":
               lm_dense["ngram"]["launches"]["dense_decode_paged"],
               "lm_prefix_dense": on_prefix(lm_prefix_dense,
                                            "dense_decode_paged")}
    rows.append({
        "name": "dense_decode_paged", "route": "cuda",
        "source": "src/repro_torch/csrc/sla2_decode_paged.cu",
        "replaces": "src/repro/kernels/sla2_decode_paged.py:588",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": lm_dkern["abs_err"], "ms": k_ms, "plain_ms": k_plain,
        "bound_ms": k_bound, "bound_by": "bytes", "ms_w4": w4[0],
        "plain_ms_w4": w4[1], "bound_ms_w4": w4[2], "library_ms": k_lib,
        "library_ms_w4": w4[3], "pages_per_split": k_pps,
        "ms_graph": k_graph, "ms_w4_graph": w4[5],
        "library_ms_graph": k_lib_graph, "library_ms_w4_graph": w4[6],
        "internlm2": {"shape": "internlm2-20b layer 0 (the dense model from "
                               "its tensors), B 4, Hkv 8, n_rep 6, Dh 128, "
                               "bk 64, bf16 pool; W 4 the n-gram window",
                      **n_rep6("dense", "dense_w4")},
        "timing": "ms: a loop of 50 wrapper calls between CUDA events, as "
                  "the other kernels; *_graph: 20 calls replayed from a "
                  "CUDA graph (device time without the host's issue "
                  "time), kernel and library alike",
        "library_note": "scaled_dot_product_attention over each slot's K/V "
                        "pages gathered into a contiguous copy (gather not "
                        "timed), rows masked to their lengths"})
    p_abs, p_ms, p_plain, p_bound, p_by, p_f32, p_lib = lm_kern["prefill"]
    l_ms, l_bound, l_lib = lm_kern["prefill_long"]
    by_path = {name: run["launches"]["paged_flash_prefill"]
               for name, run in (("lm_serve", lm_serve),
                                 ("lm_spec_linear", lm_spec),
                                 ("lm_dense_serve", lm_dense["off"]),
                                 ("lm_spec_ngram", lm_dense["ngram"]),
                                 ("lm_internlm2", lm_intern))}
    by_path.update(lm_prefix=on_prefix(lm_prefix, "paged_flash_prefill"),
                   lm_prefix_dense=on_prefix(lm_prefix_dense,
                                             "paged_flash_prefill"))
    long6 = n_rep6("prefill_last")
    rows.append({
        "name": "paged_flash_prefill", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_prefill.cu",
        "replaces": "src/repro/kernels/sla2_decode_paged.py:797",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": p_abs, "ms": p_ms, "plain_ms": p_plain,
        "bound_ms": p_bound, "bound_by": p_by,
        "bound_peak": "bf16 tensor cores, 989 TFLOP/s",
        "bound_ms_f32_cuda_cores": p_f32, "library_ms": p_lib,
        "offset": 2 * LM_CHUNK, "ms_long": l_ms, "bound_ms_long": l_bound,
        "library_ms_long": l_lib, "offset_long": LM_PROMPTS[0] - LM_CHUNK,
        "sweep_max_rel_err": lm_kern["sweep_err"],
        "internlm2": {"shape": "internlm2-20b layer 0, 48 query heads over 8 "
                               "KV heads (n_rep 6), C 512, Dh 128, bk 64, "
                               "bf16",
                      "offset": lm_intern["prefill_offset"],
                      **n_rep6("prefill"),
                      "offset_long": lm_intern["prefill_last_offset"],
                      "ms_long": long6["ms"],
                      "plain_ms_long": long6["plain_ms"],
                      "bound_ms_long": long6["bound_ms"],
                      "library_ms_long": long6["library_ms"],
                      "max_abs_err_long": long6["max_abs_err"]},
        "library_note": "scaled_dot_product_attention over the K/V pages "
                        "gathered into a contiguous copy (gather not timed) "
                        "with the offset-causal mask"})
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
