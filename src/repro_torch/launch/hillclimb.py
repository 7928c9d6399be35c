"""Perf-iteration driver for the three hillclimb cells (the JAX
package's ``launch/hillclimb.py`` over the port's dry run).

Each entry is one hypothesis->change iteration: a dry-run invocation
with a variant flag set, results tagged under results/perf_torch/.  The
table is the reference's, copied; its numbers here are the port's dry
run's estimates on the H100's roofline with assumed link constants
(``launch/analysis.py``), not measurements.

    python -m repro_torch.launch.hillclimb --device cpu
    python -m repro_torch.launch.hillclimb --arch olmo-1b --tag it0_base
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

CELLS = {
    # (arch, shape, mesh): ordered iterations [(tag, extra_args)]
    ("qwen2.5-3b", "train_4k", "multi"): [
        ("it0_flat", ["--mode", "flat"]),                    # Gloo-flat baseline
        ("it1_hier", ["--mode", "hier"]),                    # paper AllReduceH
        ("it2_hier_pipelined", ["--mode", "hier_pipelined", "--chunks", "8"]),
        ("it3_hier_zero1", ["--mode", "hier_zero1"]),
        ("it4_fsdp", ["--mode", "fsdp"]),
        ("it5_fsdp_int8", ["--mode", "fsdp", "--compression", "int8"]),
        ("it6_fsdp_int8_sp", ["--mode", "fsdp", "--compression", "int8",
                              "--sp"]),
        # planner-chosen schedule: must match or beat the best
        # hand-enumerated iteration above (core/planner.py searches a
        # superset of these configs under the same cost model).  Keep
        # it6's structural flags (fsdp + sp) so the comparison is
        # schedule-vs-schedule, not structure-vs-structure.
        ("it7_auto", ["--plan", "auto", "--mode", "fsdp", "--sp"]),
        # overlap axis (DESIGN.md §8): no structural flag, so the plan
        # is free to recommend the chained hier_overlap executor when
        # its exposed comm time beats the sequential schedules above.
        ("it8_auto_overlap", ["--plan", "auto"]),
        # border-communicator ReduceScatter schedule (DESIGN.md §9): the
        # pod hop as an explicit RS+AG exchange over the cluster ring —
        # the schedule-IR proof of generality, A/B'd against it1/it2.
        ("it9_border_rs", ["--mode", "hier_border_rs"]),
        # skew-aware workload partitioner (DESIGN.md §10): the joint
        # skew + comm optimizer; on the homogeneous multi-pod mesh the
        # split degenerates to even (weights 1.0), so this A/Bs the
        # weighted-sync wiring itself against it8 at zero skew.
        ("it10_skew_auto", ["--plan", "auto", "--skew", "auto"]),
    ],
    ("olmo-1b", "train_4k", "single"): [
        ("it0_base", ["--mode", "hier"]),
        ("it1_save_coll", ["--mode", "hier", "--remat-policy",
                           "save_collectives"]),
        ("it2_sp", ["--mode", "hier", "--remat-policy", "save_collectives",
                    "--sp"]),
        ("it3_zero1", ["--mode", "hier_zero1", "--remat-policy",
                       "save_collectives", "--sp"]),
        ("it4_auto", ["--plan", "auto", "--mode", "hier_zero1",
                      "--remat-policy", "save_collectives", "--sp"]),
    ],
    ("qwen3-moe-30b-a3b", "train_4k", "single"): [
        # it1 (EP token dedup, 16x) is a code change: before/after
        # captured as ep_dup vs it1 in EXPERIMENTS.md.
        ("it1_ep_dedup", ["--mode", "fsdp"]),
        ("it2_cap1.0", ["--mode", "fsdp", "--capacity-factor", "1.0"]),
        ("it3_sp", ["--mode", "fsdp", "--capacity-factor", "1.0", "--sp"]),
        ("it4_save_coll", ["--mode", "fsdp", "--capacity-factor", "1.0",
                           "--sp", "--remat-policy", "save_collectives"]),
        ("it5_auto", ["--plan", "auto", "--mode", "fsdp",
                      "--capacity-factor", "1.0", "--sp",
                      "--remat-policy", "save_collectives"]),
    ],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/perf_torch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the dry run's --device: the card's path or the plain one")
    ap.add_argument("--arch", default=None, help="only this cell's iterations")
    ap.add_argument("--tag", default=None, help="only the iteration of this tag")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    # one disk-backed plan cache for every --plan auto iteration: the
    # dry-run subprocesses share topology + planner knobs, so all but the
    # first hit instead of re-searching (core/plan_cache.py)
    plan_cache = out_dir / "plan_cache.pkl"
    cache_hits = cache_misses = 0
    for (arch, shape, mesh), iters in CELLS.items():
        if args.arch is not None and arch != args.arch:
            continue
        for tag, extra in iters:
            if args.tag is not None and tag != args.tag:
                continue
            out = out_dir / f"{arch}__{shape}__{mesh}__{tag}.json"
            if out.exists() and json.loads(out.read_text()).get("status") == "ok":
                print(f"skip {out.name}")
                continue
            if "--plan" in extra:
                extra = [*extra, "--plan-cache", str(plan_cache)]
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--device", args.device, "--out", str(out), *extra]
            t0 = time.time()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=2400)
            st, pcs = "?", None
            if out.exists():
                res = json.loads(out.read_text())
                st, pcs = res.get("status"), res.get("plan_cache")
            note = ""
            if pcs is not None:
                cache_hits += pcs.get("hits", 0)
                cache_misses += pcs.get("misses", 0)
                note = (f", plan cache {pcs.get('hits', 0)}h/"
                        f"{pcs.get('misses', 0)}m")
            print(f"[{time.strftime('%H:%M:%S')}] {arch} {shape} {mesh} "
                  f"{tag}: {st} ({time.time()-t0:.0f}s{note})", flush=True)
            if st != "ok":
                print((proc.stderr or proc.stdout)[-1500:])
    print(f"plan cache across iterations: {cache_hits} hit(s), "
          f"{cache_misses} miss(es) ({plan_cache})", flush=True)


if __name__ == "__main__":
    main()
