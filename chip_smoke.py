#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line when any fails, when no CUDA card is visible, or when it is
run outside a checkout of the repository):

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
             the fused and the gather engine, relative norm error < 0.05.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_LAT = 32768
SEED = 0
PEAK_INT8_OPS = 1979e12     # H100 SXM dense int8, NVIDIA data sheet
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
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
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    with torch.no_grad():
        lins = [b.ada for b in params.blocks] + [params.final_ada,
                                                 params.patch_out]
        for lin in lins:
            for t in (lin.weight, lin.bias):
                t.copy_(torch.randn(t.shape, generator=g, device="cuda")
                        * std)


def layer0_qkv(model, params, req):
    """Layer 0's self-attention q, k, v (B*H, N, Dh) and routing for one
    request at its first step, as the engine computes them."""
    import torch
    from repro_torch.core import router as R
    from repro_torch.models import dit as D
    from repro_torch.models import layers as L
    cfg = model.cfg
    lat = torch.as_tensor(req.latents, device="cuda")[None]
    mods = model.precompute_step_mods(params, torch.ones(1, device="cuda"))
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

        g = torch.Generator(device="cuda")
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
                                               device="cuda") * 0.5
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
    eng = DS.DiffusionEngine(model, params, ecfg, device="cuda")
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
    params = model.init(SEED + 3, device="cuda")
    perturb_(params, seed=SEED + 4)
    outs = {}
    for impl in ("fused", "gather"):
        req = DS.make_video_requests(1, model.cfg, n_latent=N_LAT, steps=(2,),
                                     seed=SEED + 5)
        eng = DS.DiffusionEngine(model, params, DS.DiffusionEngineConfig(
            max_slots=1, n_latent=N_LAT, max_steps=2, attn_impl=impl),
            device="cuda")
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
    params = model.init(SEED, device="cuda")
    perturb_(params)
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[model] {model.cfg.name}: {n_params / 1e9:.3f} B params, "
        f"init {time.perf_counter() - t0:.1f} s")
    reqs = DS.make_video_requests(3, model.cfg, n_latent=N_LAT,
                                  steps=(2, 3, 2), seed=SEED)

    kern = phase_kernel(model, params, reqs)
    serve = phase_serve(model, params, reqs)
    del params
    torch.cuda.empty_cache()
    phase_context()

    ms, plain, bms, by = kern["timings"][model.cfg.num_heads]
    log(smi)
    print(json.dumps({"kernels": [{
        "name": "sparse_flash_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/sla2_fwd.cu",
        "replaces": "src/repro/kernels/sla2_fwd.py:176",
        "launches": serve["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes routed int8 "
                        "block-sparse attention; dense SDPA is another "
                        "function"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
