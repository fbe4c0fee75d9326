"""Where one full-width LM decode step and one 512-token prefill chunk
spend their time.

Runs the port's ServeEngine (qwen3-14b, 40 layers, random weights from a
seed, 4 slots, max_len 32768, prefill_chunk 512, paged_impl="fused") on one
CUDA card.  Four prompts are prefilled until every slot decodes; one
decode step (4 active slots) is then recorded under ``torch.profiler``,
and one prefill chunk of a fifth prompt at offset 1024 after a fourth slot
has finished.  For each it prints the host wall time, the device time by
kernel and by group (the paged kernels, GEMMs, gathers, the rest) and the
device's idle share of the wall.

    python3 tools/profile_lm_step.py [--mechanism sla2|full]
                                     [--speculative off|linear|ngram]

``--mechanism full`` serves the dense model (the dense decode kernel);
``--speculative`` makes the recorded decode step a speculative one
(draft_len 3): drafting, the W = 4 verify pass and the commit.
"""
import argparse
import os
import sys
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _group(name: str) -> str:
    low = name.lower()
    if "sla2_decode" in low:
        return "sla2_decode kernel"
    if any(t in low for t in ("dense_decode", "dense_split", "dense_combine")):
        return "dense_decode kernel"
    if any(t in low for t in ("paged_prefill", "prefill_tc", "prefill_f32")):
        return "paged_prefill kernel"
    if any(t in low for t in ("gemm", "gemv", "cutlass", "xmma", "cublas",
                              "nvjet")):
        return "GEMM / GEMV (cuBLAS)"
    if any(t in low for t in ("index", "gather", "scatter")):
        return "gather / index / scatter"
    if any(t in low for t in ("topk", "sort", "radix")):
        return "top-k"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other elementwise / reduction"


def _report(title, prof, wall_ms):
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    total = sum(ms for _, ms, _ in rows)
    if not total:
        print("profile_lm_step: the profiler recorded no device time",
              file=sys.stderr)
        return False
    launches = sum(n for _, _, n in rows)
    print(f"{title}: wall {wall_ms:.1f} ms, device kernels {total:.1f} ms "
          f"({total / wall_ms:.1%} of wall, idle {1 - total / wall_ms:.1%}),"
          f" {launches} kernel launches")
    groups = {}
    for name, ms, _ in rows:
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    for g, ms in sorted(groups.items(), key=lambda x: -x[1]):
        print(f"  {g:32s} {ms:9.2f} ms  {ms / total:6.1%}")
    print("  top kernels by device time:")
    for name, ms, n in sorted(rows, key=lambda x: -x[1])[:12]:
        print(f"    {ms:8.2f} ms  x{n:<5d} {name[:90]}")
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mechanism", choices=("sla2", "full"), default="sla2")
    ap.add_argument("--speculative", choices=("off", "linear", "ngram"),
                    default="off")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_lm_step: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.configs.qwen3_14b import config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import make_mixed_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.DEV = "cuda"
    model = build_model(config(mechanism=args.mechanism))
    params = model.init(chip_smoke.SEED, device="cuda")
    spec = ({} if args.speculative == "off"
            else {"speculative": args.speculative, "draft_len": 3})
    eng = chip_smoke.lm_engine(model, params, **spec)
    print(f"qwen3-14b mechanism={args.mechanism} speculative="
          f"{args.speculative} on {torch.cuda.get_device_name(0)}")
    # request 0 drains first; a speculative step emits up to 4 tokens, so
    # it gets a larger budget there to still be decoding when slot 4 joins
    first = 24 if args.speculative == "off" else 96
    work = [(1024, first), (1536, 128), (1536, 128), (1536, 128), (2048, 8)]
    reqs = make_mixed_requests(model.cfg.vocab_size, work,
                               seed=chip_smoke.SEED)
    for r in reqs[:4]:
        eng.submit(r)
    while sum(s.decoding for s in eng._slots.values()) < 4:
        if eng.completed:
            raise RuntimeError("a request finished before 4 slots decoded")
        eng.step()
    eng.step()                                   # warm-up at 4 slots
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng._decode_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kind = ("decode step" if args.speculative == "off" else
            f"speculative step ({args.speculative} draft of 3, W = 4 verify, "
            f"commit)")
    ok = _report(f"{kind} (4 active slots)", prof, wall)
    while len(eng.completed) < 1:                # request 0 drains
        eng.step()
    eng.submit(reqs[4])
    eng._admit()
    eng._prefill_step()                          # its first chunk
    eng._prefill_step()                          # offset 512
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng._prefill_step()                      # offset 1024
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ok = _report("prefill chunk (512 tokens at offset 1024)", prof,
                 wall) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
