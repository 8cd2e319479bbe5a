"""Roofline report generator: the dry run's JSON files -> markdown tables
(the twin of the JAX package's ``repro.roofline.analysis``, for the H100:
the capacity is ``constants.HBM_PER_CHIP`` and the levers speak of the
card).

    PYTHONPATH=src python -m repro_torch.roofline.analysis \\
        --dryrun-dir build/dryrun --section roofline
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.roofline import constants

LEVERS = {
    "compute_s": ("compute-bound: keep the tensor cores fed (bf16 GEMMs "
                  "of large tiles, fewer model-axis splits of the "
                  "contracted dims)"),
    "memory_s": ("memory-bound: cut HBM round trips -- fuse the "
                 "elementwise passes and the attention score chunks into "
                 "hand-written kernels that stage tiles in shared memory, "
                 "keep the residual stream bf16, drop fp32 converts"),
    "collective_s": ("collective-bound: keep the heavy axis inside a node "
                     "(NVLink, not the network), replace gathers with "
                     "all-to-all dispatch, overlap weight gathers with "
                     "compute"),
}


def capacity() -> str:
    """The card's memory as the tables' headers name it."""
    return f"{constants.HBM_PER_CHIP / 1e9:.0f} GB"


def load_cells(dryrun_dir: str):
    cells = []
    for p in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(p) as f:
            cells.append(json.load(f))
    return cells


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def dryrun_table(cells) -> str:
    out = [f"| cell | compile s | peak GB/chip | fits {capacity()} | top "
           "collectives (GiB/chip) |",
           "|---|---:|---:|:--:|---|"]
    for r in cells:
        if "skipped" in r:
            out.append(f"| {r['cell']} | -- | -- | -- | SKIP: "
                       f"{r['skipped'][:60]} |")
            continue
        if "error" in r:
            out.append(f"| {r['cell']} | -- | -- | -- | ERROR |")
            continue
        colls = {k: v["bytes"] for k, v in r["collectives"].items()
                 if isinstance(v, dict) and v["bytes"] > 0}
        top = ", ".join(f"{k}={v/2**30:.1f}"
                        for k, v in sorted(colls.items(),
                                           key=lambda kv: -kv[1])[:3])
        m = r["memory"]
        out.append(
            f"| {r['cell']} | {r['compile_seconds']:.0f} "
            f"| {fmt_bytes(m['peak_estimate_bytes'])} "
            f"| {'Y' if m['fits'] else 'N'} | {top or '--'} |")
    return "\n".join(out)


def roofline_table(cells) -> str:
    out = ["| cell | compute s | memory s | collective s | dominant | "
           "MODEL_FLOPS | useful ratio | lever |",
           "|---|---:|---:|---:|---|---:|---:|---|"]
    for r in cells:
        if "skipped" in r or "error" in r:
            continue
        rl = r["roofline"]
        dom = rl["dominant"]
        mf = r.get("model_flops", 0)
        ur = r.get("useful_flops_ratio", 0)
        out.append(
            f"| {r['cell']} | {rl['compute_s']:.4f} | {rl['memory_s']:.4f}"
            f" | {rl['collective_s']:.4f} | {dom.replace('_s', '')} "
            f"| {mf:.2e} | {ur:.2f} | {LEVERS[dom][:52]}... |")
    return "\n".join(out)


def pods_table(cells) -> str:
    """One row a cell of both meshes (``<arch>--<shape>``): on pod1 and
    pod2 the peak (GiB a chip), whether it fits, and the three roofline
    terms in ms with the dominant one starred; a skipped or errored mesh
    says so.  (The port's own table: the dry run's two meshes side by
    side.)"""
    by = {}
    for r in cells:
        name, _, mesh = r["cell"].rpartition("--")
        by.setdefault(name, {})[mesh] = r

    def one(r):
        if r is None:
            return "--"
        if "skipped" in r:
            return "skip"
        if "error" in r:
            return "ERROR"
        rl, m = r["roofline"], r["memory"]
        terms = " / ".join(
            f"{rl[k] * 1e3:.1f}" + ("*" if k == rl["dominant"] else "")
            for k in ("compute_s", "memory_s", "collective_s"))
        return (f"{fmt_bytes(m['peak_estimate_bytes'])} "
                f"{'Y' if m['fits'] else 'N'}; {terms}")
    out = [f"| cell | pod1: peak GiB, fits {capacity()}; compute / memory "
           "/ collective ms | pod2: the same |", "|---|---|---|"]
    for name, meshes in by.items():
        out.append(f"| {name} | {one(meshes.get('pod1'))} "
                   f"| {one(meshes.get('pod2'))} |")
    return "\n".join(out)


def summarize(cells) -> str:
    ok = [c for c in cells if "roofline" in c]
    doms = {}
    fits = 0
    for c in ok:
        doms[c["roofline"]["dominant"]] = \
            doms.get(c["roofline"]["dominant"], 0) + 1
        fits += bool(c["memory"]["fits"])
    sk = sum("skipped" in c for c in cells)
    er = sum("error" in c for c in cells)
    return (f"{len(ok)} compiled cells ({sk} documented skips, {er} "
            f"errors); {fits}/{len(ok)} fit {capacity()}/chip as-is; "
            f"dominant terms: {doms}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="build/dryrun")
    ap.add_argument("--section", choices=["dryrun", "roofline", "pods",
                                          "summary"], default="summary")
    args = ap.parse_args(argv)
    cells = load_cells(args.dryrun_dir)
    if args.section == "dryrun":
        print(dryrun_table(cells))
    elif args.section == "roofline":
        print(roofline_table(cells))
    elif args.section == "pods":
        print(pods_table(cells))
    else:
        print(summarize(cells))


if __name__ == "__main__":
    main()
