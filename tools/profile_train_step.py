"""Where one full-width QAT train step spends its device time.

Builds the port's wan-dit-1.3b (30 layers, int8 QAT forward, seeded
random weights with the zero-initialised adaLN and output tensors filled),
takes one warm-up optimizer step of 2 microbatches of one 32768-latent
video, then records the next step under ``torch.profiler`` and prints the
device time by kernel and by group (the SLA2 forward and backward kernels,
GEMMs, gathers, everything else) beside the step's wall time.  With
``--lm`` it profiles qwen3-14b instead: full width, depth cut to 2 layers
(as chip_smoke.py's lm-train), int8 QAT forward through the kernels,
remat "full", 2 microbatches of one 8192-token sequence.

    python3 tools/profile_train_step.py [--lm]
"""
import os
import sys
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _group(name: str) -> str:
    low = name.lower()
    for tag in ("sla2_bwd_dq", "sla2_bwd_dkv", "sla2_fwd"):
        if tag in low:
            return f"kernel {tag}"
    if any(t in low for t in ("gemm", "cutlass", "xmma", "cublas", "nvjet")):
        return "GEMM (cuBLAS)"
    if any(t in low for t in ("index", "gather", "scatter")):
        return "gather / index / scatter"
    if any(t in low for t in ("softmax", "exp")):
        return "softmax / exp"
    return "other elementwise / reduction"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_train_step: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.configs.wan_dit_1_3b import DIT_SHAPES, config
    from repro_torch.data import make_dataset
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    lm = "--lm" in sys.argv[1:]
    if lm:
        from repro_torch.configs import qwen3_14b
        n, unit = chip_smoke.LM_TRAIN_N, "token sequence"
        model = build_model(qwen3_14b.config(
            n_layers=chip_smoke.LM_TRAIN_LAYERS, sla2_impl="kernel",
            quant_bits="int8", remat="full"))
    else:
        n, unit = DIT_SHAPES["train_32k"]["seq_len"], "latent video"
        model = build_model(config(sla2_impl="kernel"))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-3), warmup_steps=1,
                       total_steps=2, microbatches=chip_smoke.MICROBATCHES)
    state = init_train_state(model, chip_smoke.SEED, tcfg, device="cuda")
    if not lm:
        chip_smoke.perturb_(state["params"])
    ds = make_dataset(model.cfg, seq_len=n,
                      global_batch=chip_smoke.MICROBATCHES)
    step_fn = make_train_step(model, tcfg)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in
                ds[i].items()} for i in range(2)]
    state, _ = step_fn(state, batches[0])          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batches[1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    total = sum(ms for _, ms, _ in rows)
    if not total:
        print("profile_train_step: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    print(f"{model.cfg.name} ({model.cfg.n_layers} layers) optimizer step "
          f"({chip_smoke.MICROBATCHES} microbatches of one {n}-{unit}): wall "
          f"{wall_ms:.1f} ms, device kernels "
          f"{total:.1f} ms ({total / wall_ms:.1%} of wall)")
    groups = {}
    for name, ms, _ in rows:
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"  {g:32s} {ms:9.1f} ms  {ms / total:6.1%}")
    print("top kernels by device time:")
    for name, ms, cnt in sorted(rows, key=lambda x: -x[1])[:20]:
        print(f"  {ms:9.2f} ms  x{cnt:<5d} {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
