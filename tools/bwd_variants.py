"""The bf16 backward kernels beside two exploratory builds of their source
(neither is an option of the port):

  shipped        csrc/sla2_bwd.cu as it is;
  one_term       P and dS as one bf16 term (TERMS = 1) instead of two;
  runtime_sizes  the main tiling without its compile-time sizes (MAIN_D
                 matches no shape, so d, bq, bk stay run-time arguments).

Each build is made with the port's nvcc flags from a copy of the sources
under build/bwd_variants/ and run through the port's wrapper on the same
seeded bf16 inputs at the DiT's main tiling (BH 12, N 32768, d 128, bq 128,
bk 64, k_frac 0.05, o and lse from the forward kernel): relative max error
of dq, dk, dv against the plain backward in f32 on the same bf16 values (so
the outputs' own bf16 rounding is counted), and CUDA-event times of the two
kernels (loops of 5 launches), the builds taken in turns twice.

    python3 tools/bwd_variants.py
"""
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


VARIANTS = {  # name: (pattern, replacement) in csrc/sla2_bwd.cu
    "shipped": None,
    "one_term": (r"constexpr int TERMS = \d+;", "constexpr int TERMS = 1;"),
    "runtime_sizes": (r"constexpr int MAIN_D = \d+,",
                      "constexpr int MAIN_D = 0,"),
}


def build_variants() -> dict:
    """{name: path of the built library}, one nvcc per variant at once."""
    from repro_torch.kernels import build
    src = open(os.path.join(build.CSRC, "sla2_bwd.cu")).read()
    procs = {}
    for name, sub in VARIANTS.items():
        out = os.path.join(REPO, "build", "bwd_variants", name)
        os.makedirs(out, exist_ok=True)
        for f in os.listdir(build.CSRC):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(build.CSRC, f), out)
        text = src
        if sub:
            text, n = re.subn(sub[0], sub[1], src)
            assert n == 1, f"{sub[0]} not found in sla2_bwd.cu"
        cu = os.path.join(out, "sla2_bwd.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out, "libsla2_bwd.so")
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        libs[name] = lib
    return libs


def main() -> int:
    import ctypes

    import torch
    if not torch.cuda.is_available():
        print("bwd_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    import chip_smoke
    from repro_torch.core import router as R
    from repro_torch.kernels import build
    from repro_torch.kernels import sla2_bwd as B
    from repro_torch.kernels.sla2_fwd import sparse_flash_fwd

    bh, n, d, bq, bk = 12, 32768, 128, 128, 64
    kw = dict(block_q=bq, block_k=bk, causal=False, prefix_len=0)
    g = torch.Generator(device="cuda")
    g.manual_seed(chip_smoke.SEED + 17)
    q, k, v, do = ((torch.randn(bh, n, d, generator=g, device="cuda") * 0.5)
                   .to(torch.bfloat16) for _ in range(4))
    idx, valid = R.route_indices(None, q, k, R.RouterConfig(
        block_q=bq, block_k=bk, k_frac=0.05))
    valid = valid.to(torch.int32)
    with torch.no_grad():
        o, lse = sparse_flash_fwd(q, k, v, idx, valid, **kw)
        want = B.sparse_flash_bwd_plain(q.float(), k.float(), v.float(), idx,
                                        valid, o.float(), lse, do.float(),
                                        **kw)
        dd, is_, vs, off = B.kernel_inputs(o, do, idx, valid, n // bk)
        print(f"{torch.cuda.get_device_name(0)}; q{tuple(q.shape)} bf16, "
              f"{int(valid.sum())} routed pairs")
        libs = {name: ctypes.CDLL(path)
                for name, path in build_variants().items()}
        for name in [*libs, *libs]:
            build.load_library = lambda _, lib=libs[name]: lib
            got = B.sparse_flash_bwd(q, k, v, idx, valid, o, lse, do, **kw)
            torch.cuda.synchronize()
            errs = [chip_smoke.rel_err(a, b) for a, b in zip(got, want)]
            ms_dq = chip_smoke.cuda_ms(lambda: B.launch_dq(
                q, k, v, do, lse, dd, idx, valid, **kw), iters=5)
            ms_dkv = chip_smoke.cuda_ms(lambda: B.launch_dkv(
                q, k, v, do, lse, dd, is_, vs, off, **kw), iters=5)
            print(f"{name}: rel max err vs the f32 plain backward dq "
                  f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}; dq "
                  f"{ms_dq:.3f} ms, dkv {ms_dkv:.3f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
