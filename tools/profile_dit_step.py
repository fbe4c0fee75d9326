"""Where one full-width diffusion engine step spends its device time.

Runs the port's DiffusionEngine (wan-dit-1.3b, 30 layers, 32768 latents,
two active slots, attn_impl="fused") on one CUDA card, warms it up with one
step, then records the next step under ``torch.profiler`` and prints the
device time by kernel and by group (the SLA2 sparse-branch kernel, GEMMs,
everything else), beside the step's wall time.

    python3 tools/profile_dit_step.py
"""
import os
import sys
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _group(name: str) -> str:
    low = name.lower()
    if "sla2_fwd" in low:
        return "sla2 sparse-branch kernel"
    if any(t in low for t in ("gemm", "cutlass", "sm90_xmma", "cublas")):
        return "GEMM (cuBLAS)"
    if any(t in low for t in ("index", "gather", "scatter")):
        return "gather / index"
    if any(t in low for t in ("softmax", "exp")):
        return "softmax / exp"
    return "other elementwise / reduction"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_dit_step: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.configs.wan_dit_1_3b import config
    from repro_torch.models.api import build_model
    from repro_torch.serve import diffusion as DS

    model = build_model(config(sla2_impl="kernel"))
    params = model.init(chip_smoke.SEED, device="cuda")
    chip_smoke.perturb_(params)
    eng = DS.DiffusionEngine(model, params, DS.DiffusionEngineConfig(
        max_slots=2, n_latent=chip_smoke.N_LAT, max_steps=8,
        attn_impl="fused"), device="cuda")
    for r in DS.make_video_requests(2, model.cfg, n_latent=chip_smoke.N_LAT,
                                    steps=(4, 4)):
        eng.submit(r)
    eng.step()                                   # admission + warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    total = sum(ms for _, ms, _ in rows)
    if not total:
        print("profile_dit_step: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    print(f"engine step (2 active slots): wall {wall_ms:.1f} ms, device "
          f"kernels {total:.1f} ms ({total / wall_ms:.1%} of wall)")
    groups = {}
    for name, ms, _ in rows:
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"  {g:32s} {ms:9.1f} ms  {ms / total:6.1%}")
    print("top kernels by device time:")
    for name, ms, n in sorted(rows, key=lambda x: -x[1])[:15]:
        print(f"  {ms:9.2f} ms  x{n:<5d} {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
