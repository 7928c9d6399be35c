"""hier_overlap's readiness chain on full-width qwen2.5-3b, on one card,
run from a given tree: after a warm-up step, one profiled step (how many
of its bucket syncs began before the backward's last kernel, device busy
and idle share, from ``chip_smoke.overlap_timeline`` and ``_report``),
then ``--steps`` steps by the host clock, each with the host ms of the
graph walk that looks for unread parameters where the tree has one.

    python3 tools/overlap_walk.py                   # this tree
    python3 tools/overlap_walk.py --root DIR        # the tree at DIR, e.g. a
                                                    # parent's git archive
    PYTHONPATH=src python tools/overlap_walk.py --device cpu --smoke   # a rehearsal

Each run is one process with a world of one (4 x 1024 tokens, int8 on
the pod hop, the default 64 MiB bucket cap: 38 buckets at full width).
It prints one JSON line last.  To compare two trees, run them in turns
(parent, change, change, parent) in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent),
                    help="the tree whose chip_smoke.py and src/ to run")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="the smoke model (a rehearsal)")
    args = ap.parse_args(argv)
    root = pathlib.Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    smi = cs.card() if cuda else "CPU"
    print(f"[env] {smi}; tree {root}")
    train_launch.init_world(dev)
    cfg = get_config("qwen2.5-3b", smoke=args.smoke)
    model = Model(cfg, runtime_for_groups(pods=1, data_per_pod=1), dev)
    tcfg = TrainConfig(comm_mode="hier_overlap", dcn_compression="int8",
                       opt=opt_lib.OptConfig(warmup_steps=20))
    step_fn, init_fn = make_train_step(model, tcfg)
    opt = init_fn(0)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=cs.TRAIN_BATCH,
                      seq_len=cs.TRAIN_SEQ)
    b = {k: torch.from_numpy(v).long().to(dev) for k, v in synth_batch(dcfg, 0).items()}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    step_fn(opt, b)                                   # warm-up
    out = {"tree": str(root), "card": smi}
    if cuda:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            sync()
            t0 = time.perf_counter()
            step_fn(opt, b)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        out["profile"] = cs._report(prof, wall, f"{cfg.name} hier_overlap + int8 step", smi,
                                    cs.TRAIN_GROUPS, cs.TRAIN_RANGES)
        out["overlap"] = cs.overlap_timeline(prof)
    step_ms, walk_ms = [], []
    for _ in range(args.steps):
        sync()
        t0 = time.perf_counter()
        m = step_fn(opt, b)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        walk_ms.append(m.get("walk_ms"))
    out.update(step_ms=step_ms, step_ms_median=statistics.median(step_ms), walk_ms=walk_ms)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
