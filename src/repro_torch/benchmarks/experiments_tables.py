"""The dry run's markdown tables (the reference's EXPERIMENTS.md
§Dry-run / §Roofline) from the port's artifacts,
``artifacts/dryrun_torch/*.json``.

    PYTHONPATH=src python -m repro_torch.benchmarks.experiments_tables [--mesh single|multi] [--both]
"""

from __future__ import annotations

import sys

from .roofline_report import records

ARCH_ORDER = ["hymba-1.5b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
              "gemma2-9b", "qwen2-7b", "llama3.2-1b", "minicpm3-4b",
              "musicgen-medium", "mamba2-780m", "qwen2-vl-7b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str, include_variants=False):
    recs = [d for _, d in records(mesh, include_variants)]
    recs.sort(key=lambda d: (ARCH_ORDER.index(d["arch"]),
                             SHAPE_ORDER.index(d["shape"])))
    return recs


def fmt_bytes(n):
    return f"{n / (1 << 30):.2f}"


def dryrun_table(mesh: str):
    print(f"\n### Dry-run — {'16x16 single pod (256)' if mesh == 'single' else '2x16x16 two pods (512 GPUs)'}\n")
    print("| arch | shape | trace s | HBM GiB/dev | fits 80G | "
          "GFLOP/dev | coll GiB/dev | AR / AG / RS / A2A / CP |")
    print("|---|---|---|---|---|---|---|---|")
    for d in load(mesh):
        m, c = d["memory"], d["collectives"]
        cts = c["counts"]
        ops = "/".join(str(cts.get(k, 0)) for k in
                       ("all-reduce", "all-gather", "reduce-scatter",
                        "all-to-all", "collective-permute"))
        print(f"| {d['arch']} | {d['shape']} | {d['trace_s']} "
              f"| {m['total_per_device_gib']} "
              f"| {'y' if m['fits_80gb'] else 'N'} "
              f"| {d['cost']['flops_per_device'] / 1e9:.0f} "
              f"| {fmt_bytes(c['total_bytes'])} | {ops} |")


def roofline_table(mesh: str):
    gpus = 256 if mesh == "single" else 512
    print(f"\n### Roofline — {gpus} GPUs (H100: 989 TF bf16, 3.35 TB/s HBM,"
          " 50 GB/s/GPU assumed across nodes)\n")
    print("| arch | shape | compute s | memory s | collective s | dominant "
          "| MODEL_FLOPs/FLOPs | note |")
    print("|---|---|---|---|---|---|---|---|")
    for d in load(mesh):
        r = d["roofline"]
        u = r["useful_compute_ratio"]
        print(f"| {d['arch']} | {d['shape']} | {r['compute_s']:.4f} "
              f"| {r['memory_s']:.4f} | {r['collective_s']:.4f} "
              f"| **{r['dominant'][:-2]}** | {u:.2f} | {_note(d)} |")


def _note(d):
    r = d["roofline"]
    dom = r["dominant"]
    shape = d["shape"]
    if dom == "collective_s":
        big = max(d["collectives"]["bytes"],
                  key=d["collectives"]["bytes"].get)
        return (f"{big} traffic dominates — aggregate buckets / manual "
                f"RS+AG (SP) / fewer resharding boundaries")
    if dom == "memory_s":
        if shape in ("decode_32k", "long_500k"):
            return "KV/state streaming — inevitable at batch-1 arithmetic " \
                   "intensity; partitioned-KV decode removes the gather"
        return "activation + weight streaming — fused kernels and the " \
               "flash-attention kernel remove score/loss round-trips"
    return "compute-bound — tensor-core-limited; padding waste is the lever"


def main():
    mesh = "single"
    if "--mesh" in sys.argv:
        mesh = sys.argv[sys.argv.index("--mesh") + 1]
    if "--both" in sys.argv:
        for m in ("single", "multi"):
            dryrun_table(m)
            roofline_table(m)
    else:
        dryrun_table(mesh)
        roofline_table(mesh)


if __name__ == "__main__":
    main()
