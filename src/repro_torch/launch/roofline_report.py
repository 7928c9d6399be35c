"""Aggregate dry-run JSONs into the §Roofline table (markdown + CSV)."""

from __future__ import annotations

import argparse
import json
import pathlib


def load_cells(d: pathlib.Path) -> list[dict]:
    cells = []
    for p in sorted(d.glob("*.json")):
        try:
            cells.append(json.loads(p.read_text()))
        except json.JSONDecodeError:
            continue
    return cells


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def table(cells: list[dict], mesh: str) -> str:
    rows = []
    hdr = ("| arch | shape | compute | memory | ici | dcn | bottleneck | "
           "peak GiB | useful | roofline |")
    sep = "|" + "---|" * 10
    for c in cells:
        if c.get("mesh") != mesh:
            continue
        if c["status"] == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | — | "
                        f"skip | — | — | {c.get('reason','')[:38]} |")
            continue
        if c["status"] != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | ERR | | | | | | | |")
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['ici_s'])} | "
            f"{fmt_s(r['dcn_s'])} | {r['bottleneck']} | "
            f"{c['memory']['peak_per_device_gib']:.2f} | "
            f"{r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']*100:.1f}% |")
    return "\n".join([hdr, sep] + rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    cells = load_cells(pathlib.Path(args.dir))
    print(table(cells, args.mesh))
    # quick pick helpers for the hillclimb
    ok = [c for c in cells if c["status"] == "ok" and c["mesh"] == args.mesh]
    if ok:
        worst = min(ok, key=lambda c: c["roofline"]["roofline_fraction"])
        coll = max(ok, key=lambda c: max(c["roofline"]["ici_s"],
                                         c["roofline"]["dcn_s"])
                   / max(1e-12, c["roofline"]["step_s"]))
        print(f"\nworst roofline fraction: {worst['arch']}/{worst['shape']} "
              f"({worst['roofline']['roofline_fraction']*100:.2f}%)")
        print(f"most collective-bound:   {coll['arch']}/{coll['shape']}")


if __name__ == "__main__":
    main()
