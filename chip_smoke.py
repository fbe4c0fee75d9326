#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line when any fails, when no CUDA card is visible, or when it is
run outside a checkout of the repository; each prints its wall time):

 1. device   the card's name and power limit (nvidia-smi);
 2. build    every CUDA source in src/repro_torch/csrc, one nvcc each,
             all started together;
 3. kernel   full-width wan-dit-1.3b (random weights from a seed, with the
             zero-initialised adaLN / output tensors filled with seeded
             N(0, 0.02^2)); layer 0's q, k, v of one 32768-token request
             and its routing go through sparse_flash_fwd (CUDA) and its
             plain PyTorch version on the card (int8, bf16, BH = 12); then a
             sweep over quant x causal x prefix_len x kv_len x dtype; then
             CUDA-event timings at BH = 12 and 24 beside the plain version
             and the bound;
 4. serve    DiffusionEngine(attn_impl="fused", n_latent=32768,
             max_slots=2) at full width serves 3 requests (2, 3, 2 steps,
             the third joining after the first step); every launch count
             of the path is set to 0 just before and read just after;
 5. context  the same config at 2 layers: one request of 2 steps through
             the fused and the gather engine, relative norm error < 0.05;
 6. bwd      the backward kernels (sla2_bwd.cu: dQ, dK/dV) against their
             plain version on layer 0's q, k, v and routing of one 32768-
             token request, with o and lse from the int8 forward kernel and
             a seeded bf16 dO (relative max error <= 2^-7); a sweep over
             causal x prefix_len x f32/bf16 with invalid padding entries and
             unselected kv blocks (1e-4 f32, 2^-7 bf16); autograd through
             the kernel-mode op against a dense softmax oracle (f32, 1e-4);
             CUDA-event times at BH = 12 beside the plain version and the
             bounds on the bf16 tensor-core and f32 CUDA-core peaks;
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
             synthetic tokens: finite losses, hard-Top-k MSE lowered.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""
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
BF16_TWO_ULPS = 2 ** -7


def log(*args):
    print(*args, flush=True)


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
            timings[tq.shape[0]] = (ms, plain, bms, by)
            log(f"[kernel] BH={tq.shape[0]}: kernel {ms:.3f} ms, plain "
                f"{plain:.3f} ms, bound {bms:.4f} ms ({by}), "
                f"{bms / ms:.1%} of bound")
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

        n_cases = invalid = unvisited = 0
        for dtype in (torch.float32, torch.bfloat16):
            for causal, prefix_len, shape, kf in (
                    (False, 0, (3, 1024, 128, 128, 64), 0.1),
                    (True, 0, (3, 1024, 128, 128, 64), 0.5),
                    (True, 192, (3, 1024, 128, 128, 64), 0.5),
                    (True, 0, (2, 512, 64, 64, 32), 0.5),
                    (False, 0, (4, 256, 32, 32, 16), 0.25),
                    (True, 48, (4, 256, 32, 32, 16), 0.5)):
                bh, n, d, sbq, sbk = shape
                sq, sk, sv, sdo = ((torch.randn(bh, n, d, generator=g,
                                                device=DEV) * 0.5
                                    ).to(dtype) for _ in range(4))
                si, sval = R.route_indices(None, sq, sk, R.RouterConfig(
                    block_q=sbq, block_k=sbk, k_frac=kf, causal=causal,
                    prefix_len=prefix_len))
                sval = sval.to(torch.int32)
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
            f"2^-7), with {invalid} invalid padding entries and "
            f"{unvisited} kv blocks no valid pair visits")
        if not (invalid and unvisited):
            raise AssertionError("the sweep missed padding or unvisited "
                                 "blocks")

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
    for name in ("dq", "dkv"):
        b16, by, f32 = bounds[name]
        log(f"[bwd] BH={q.shape[0]} {name}: kernel {times[name]:.3f} ms, "
            f"plain {plain[name]:.3f} ms, bound {b16:.4f} ms ({by}, bf16 "
            f"tensor cores; {f32:.3f} ms on f32 CUDA cores), "
            f"{b16 / times[name]:.1%} of bound")
    log(f"[bwd] whole wrapper (dd, pair sort, both kernels): {whole:.3f} ms")
    return {"abs_err": {"dq": abs_errs[0], "dkv": max(abs_errs[1:])},
            "times": times, "plain": plain, "bounds": bounds}


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
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

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
    torch.cuda.empty_cache()
    timed("context", phase_context)
    train = timed("train", phase_train)
    timed("train-context", phase_train_context)
    timed("stage1", phase_stage1)

    ms, plain, bms, by = kern["timings"][model.cfg.num_heads]
    no_library = ("no single PyTorch call computes a routed block-sparse "
                  "attention backward; dense SDPA's backward is another "
                  "function")
    rows = [{
        "name": "sparse_flash_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/sla2_fwd.cu",
        "replaces": "src/repro/kernels/sla2_fwd.py:176",
        "launches": serve["launches"],
        "launches_by_path": {"serve": serve["launches"],
                             "train": train["sparse_flash_fwd"]},
        "max_abs_err": kern["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
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
            "launches_by_path": {"train": train[name]},
            "max_abs_err": bwd["abs_err"][key], "ms": bwd["times"][key],
            "plain_ms": bwd["plain"][key], "bound_ms": b16,
            "bound_by": by16, "bound_peak": "bf16 tensor cores, 989 TFLOP/s",
            "bound_ms_f32_cuda_cores": f32, "library_ms": None,
            "library_note": no_library})
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
