"""The int8 forward and the split SLA2 decode beside exploratory builds
and split sizes (none is an option of the port):

  forward  shipped    csrc/sla2_fwd.cu as it is (MIN_BLOCKS 2: at most
                      128 registers, two blocks per SM; STAGES 3);
           stages_4   a ring of 4 code tiles;
           one_block  MIN_BLOCKS 1 (no register cap, one block per SM)
                      with a ring of 4;
           runtime_sizes  the main tiling on the run-time-sized build
                      (MAIN never taken), capped as the shipped one for
                      MIN_BLOCKS 2 blocks per SM.
  decode   the wrapper's entries per split (decode_split_shape) beside
           1, 2, 3, 4, 6, 13 and 26 (one split), set in place of
           decode_split_shape.

Each forward build is made with the port's nvcc flags from a copy of the
sources under build/fwd_variants/ and run through the port's wrapper on
the same seeded bf16 inputs at the DiT's main tiling (BH 12, N 32768, d
128, bq 128, bk 64, k_frac 0.05): bit-equality of o with the shipped
build, CUDA-event times (loops of 20 calls), the builds taken in turns
twice; then the pre-pass alone and the device time of the two kernels
(torch.profiler).  The decode runs on qwen3-14b's geometry (B 4, Hkv 8,
n_rep 5, Dh 128, a bf16 pool of 2100 pages of 64 rows, K_sel 26, 95%
valid entries, all but the last two complete, rows near 8200 tokens) at W
1 and 4: relative max error against the plain version, the time of a
loop of 50 calls and of 20 calls replayed from a CUDA graph, per entries
per split, and the device time of the split kernel and the combine
(torch.profiler) per entries per split.

    python3 tools/fwd_decode_variants.py
"""
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

VARIANTS = {  # name: [(pattern, replacement)] in csrc/sla2_fwd.cu
    "shipped": [],
    "stages_4": [(r"constexpr int STAGES = \d+;",
                  "constexpr int STAGES = 4;")],
    "one_block": [(r"constexpr int STAGES = \d+;",
                   "constexpr int STAGES = 4;"),
                  (r"constexpr int MIN_BLOCKS = \d+;",
                   "constexpr int MIN_BLOCKS = 1;")],
    "runtime_sizes": [(r"__launch_bounds__\(MMA_NT, MAIN \? MIN_BLOCKS : 1\)",
                       "__launch_bounds__(MMA_NT, MIN_BLOCKS)"),
                      (r"const bool main = a\.d == MAIN_D",
                       "const bool main = false && a.d == MAIN_D")],
}


def build_variants() -> dict:
    """{name: (library path, ptxas report)}, one nvcc per variant at once."""
    from repro_torch.kernels import build
    src = open(os.path.join(build.CSRC, "sla2_fwd.cu")).read()
    procs = {}
    for name, subs in VARIANTS.items():
        out = os.path.join(REPO, "build", "fwd_variants", name)
        os.makedirs(out, exist_ok=True)
        for f in os.listdir(build.CSRC):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(build.CSRC, f), out)
        text = src
        for pat, rep in subs:
            text, n = re.subn(pat, rep, text)
            assert n == 1, f"{pat} not found in sla2_fwd.cu"
        cu = os.path.join(out, "sla2_fwd.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out, "libsla2_fwd.so")
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        libs[name] = (lib, err)
    return libs


def device_ms(fn, n=10) -> dict:
    """{kernel name: device ms per call} of fn under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("void ", "").replace(
                "(anonymous namespace)::", "")
            out[re.split(r"[<(]", name)[0]] = e.device_time_total / n / 1e3
    return out


def forward(chip_smoke):
    import ctypes

    import torch
    from repro_torch.core import router as R
    from repro_torch.core.quant import smooth_k
    from repro_torch.kernels import build
    from repro_torch.kernels import sla2_fwd as F
    bh, n, d, bq, bk = 12, 32768, 128, 128, 64
    g = torch.Generator(device="cuda")
    g.manual_seed(chip_smoke.SEED + 18)
    q, k, v = ((torch.randn(bh, n, d, generator=g, device="cuda") * 0.5)
               .to(torch.bfloat16) for _ in range(3))
    idx, valid = R.route_indices(None, q, k, R.RouterConfig(
        block_q=bq, block_k=bk, k_frac=0.05))
    valid = valid.to(torch.int32)
    k = smooth_k(k).contiguous()
    kw = dict(block_q=bq, block_k=bk, causal=False, quant_bits="int8")
    print(f"forward: q{tuple(q.shape)} bf16, {int(valid.sum())} routed "
          f"pairs; bound {chip_smoke.bound_ms(q, idx, valid, bq, bk)[0]:.4f}"
          f" ms, gathered-bytes floor "
          f"{chip_smoke.fwd_gather_floor_ms(q, valid, bq, bk):.4f} ms")
    built = build_variants()
    for name, (_, report) in built.items():
        for kern, res in chip_smoke.kernel_resources(report).items():
            shown = "false" if name == "runtime_sizes" else "true"
            if "int8_mma" in kern and f"bfloat16, {shown}" in kern:
                print(f"  {name}: {kern.split('(')[0]}: {res}")
    libs = {name: ctypes.CDLL(path) for name, (path, _) in built.items()}
    load = build.load_library
    with torch.no_grad():
        build.load_library = lambda _, lib=libs["shipped"]: lib
        want, _ = F.sparse_flash_fwd(q, k, v, idx, valid, **kw)
        for name in [*libs, *libs]:
            build.load_library = lambda _, lib=libs[name]: lib
            o, _ = F.sparse_flash_fwd(q, k, v, idx, valid, **kw)
            torch.cuda.synchronize()
            ms = chip_smoke.cuda_ms(
                lambda: F.sparse_flash_fwd(q, k, v, idx, valid, **kw),
                iters=20)
            print(f"  {name}: {ms:.3f} ms, o equal to the shipped build's: "
                  f"{torch.equal(o, want)}")
        build.load_library = lambda _, lib=libs["shipped"]: lib
        pre = chip_smoke.cuda_ms(lambda: F.quantize_kv_tiles(k, v, bk),
                                 iters=20)
        dev = device_ms(lambda: F.sparse_flash_fwd(q, k, v, idx, valid, **kw))
        print(f"  pre-pass alone {pre:.4f} ms; device time by kernel: "
              + ", ".join(f"{k_} {t:.4f} ms" for k_, t in dev.items()))
    build.load_library = load


def decode(chip_smoke):
    import torch
    from repro_torch.kernels import sla2_decode_paged as KP
    b, hkv, n_rep, dh, bk, k_sel, n_pages = 4, 8, 5, 128, 64, 26, 2100
    g = torch.Generator(device="cuda")
    g.manual_seed(chip_smoke.SEED + 19)
    kp, vp = (torch.randn(n_pages, hkv, bk, dh, generator=g, device="cuda")
              .bfloat16() for _ in range(2))
    for w in (1, 4):
        ints = lambda lo, hi, shape: torch.randint(
            lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)
        rnd = lambda *shape: torch.rand(*shape, generator=g, device="cuda")
        q = torch.randn(b, hkv, w, n_rep, dh, generator=g,
                        device="cuda").bfloat16()
        phys = ints(1, n_pages, (b, hkv, w, k_sel))
        jlog = ints(0, 128, (b, hkv, w, k_sel))
        valid = (rnd(b, hkv, w, k_sel) > 0.05).to(torch.int32)
        comp = valid.clone()
        comp[..., -2:] = 0
        t_new = ints(128 * bk, 130 * bk, (b, w))
        h = rnd(b, hkv, w, dh, dh) * 50
        z = rnd(b, hkv, w, dh) * 1000 + 200
        alpha = torch.randn(b, hkv, n_rep, generator=g, device="cuda")
        args = (q, kp, vp, phys, jlog, valid, comp, t_new, h, z, alpha)
        kw = dict(block_k=bk, quant_bits="none", kv_quant="none",
                  k_scale=None, v_scale=None)
        want = KP.sla2_decode_verify_plain(*args, **kw)
        choice = KP.decode_split_shape(b, hkv, k_sel, KP.sm_count(q.device))
        print(f"decode W {w}: the wrapper's choice {choice[0]} entries a "
              f"split ({choice[1]} splits); bound "
              f"{chip_smoke.decode_bound_ms(args):.4f} ms")
        shape = KP.decode_split_shape
        for eps in dict.fromkeys((choice[0], 1, 2, 3, 4, 6, 13, 26)):
            KP.decode_split_shape = lambda *_, e=eps: (e, -(-k_sel // e))
            call = lambda: KP.sla2_decode_verify(*args, **kw)
            o = call()
            torch.cuda.synchronize()
            dev = device_ms(call)
            print(f"  {eps} entries a split: loop "
                  f"{chip_smoke.cuda_ms(call, iters=50):.4f} ms, graph "
                  f"{chip_smoke.graph_ms(call):.4f} ms, rel max err "
                  f"{chip_smoke.rel_err(o, want):.3e}; device time "
                  + ", ".join(f"{k_} {t:.4f} ms" for k_, t in dev.items()))
        KP.decode_split_shape = shape


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fwd_decode_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    import chip_smoke
    print(torch.cuda.get_device_name(0))
    forward(chip_smoke)
    decode(chip_smoke)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
