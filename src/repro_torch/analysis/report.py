"""The roofline markdown table of a dry run's JSONL records.

Port of the reference's report; it reads the records of either package.

    PYTHONPATH=src python -m repro_torch.analysis.report artifacts/dryrun.jsonl
"""

from __future__ import annotations

import json
import sys
from typing import Dict


def load(path: str) -> Dict:
    recs = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            recs[(r.get("arch"), r.get("shape"), r.get("multi_pod"))] = r
    return recs


def table(path: str) -> str:
    recs = load(path)
    lines = [
        "| arch | shape | scheme | t_compute | t_memory | t_collective | "
        "bound | peak GiB | useful | mfu_bound |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    singles = sorted(
        (r for r in recs.values()
         if r.get("status") == "ok" and not r.get("multi_pod")),
        key=lambda r: (r["arch"], r["shape"]))
    for r in singles:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r.get('scheme','sp')} "
            f"| {r['t_compute_s']*1e3:,.0f} ms | {r['t_memory_s']*1e3:,.0f} ms "
            f"| {r['t_collective_s']*1e3:,.0f} ms | {r['bottleneck']} "
            f"| {r['peak_hbm_gib']:.1f} | {r.get('useful_flop_fraction',0):.2f} "
            f"| {r.get('mfu_bound',0):.3f} |")
    multi_ok = sum(1 for r in recs.values()
                   if r.get("multi_pod") and r.get("status") == "ok")
    skipped = sum(1 for r in recs.values() if r.get("status") == "skipped")
    lines.append("")
    lines.append(f"Single-pod cells: {len(singles)} ok; multi-pod (512-chip) "
                 f"cells: {multi_ok} ok; skipped (documented): {skipped}.")
    # bottleneck census
    census: Dict[str, int] = {}
    for r in singles:
        census[r["bottleneck"]] = census.get(r["bottleneck"], 0) + 1
    lines.append(f"Bottleneck census (single-pod): {census}.")
    worst = [r for r in singles if r["shape"] == "train_4k"]
    if worst:
        w = min(worst, key=lambda r: r.get("mfu_bound", 0))
        lines.append(f"Worst train-cell roofline fraction: {w['arch']} "
                     f"(mfu_bound {w.get('mfu_bound',0):.3f}).")
        c = max(worst, key=lambda r: r["t_collective_s"])
        lines.append(f"Most collective-bound train cell: {c['arch']} "
                     f"(t_collective {c['t_collective_s']:.2f}s).")
    return "\n".join(lines)


if __name__ == "__main__":
    print(table(sys.argv[1] if len(sys.argv) > 1 else "artifacts/dryrun.jsonl"))
