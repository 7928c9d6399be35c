"""Sequential dry-run sweep driver: every (arch x shape x mesh) cell,
one subprocess per cell (one fake world per process), results cached as
JSON under results/sweep_torch/ (the JAX package's ``launch/sweep.py``
over the port's dry run).

    python -m repro_torch.launch.sweep --device cpu
    python -m repro_torch.launch.sweep --archs whisper-tiny --shapes train_4k,decode_32k
    python -m repro_torch.launch.roofline_report --dir results/sweep_torch --mesh multi
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ARCHS = ["olmo-1b", "qwen2.5-3b", "hymba-1.5b", "mamba2-2.7b", "qwen1.5-4b",
         "whisper-tiny", "qwen3-moe-30b-a3b", "internlm2-20b", "mixtral-8x7b",
         "chameleon-34b"]
SHAPES = ["train_4k", "decode_32k", "prefill_32k", "long_500k"]


def run_cell(arch, shape, mesh, out_dir, mode="fsdp", extra=(),
             timeout=3000, tag="", device="cuda"):
    name = f"{arch}__{shape}__{mesh}" + (f"__{tag}" if tag else "")
    out = out_dir / f"{name}.json"
    if out.exists():
        try:
            st = json.loads(out.read_text()).get("status")
            if st in ("ok", "skipped"):
                return st, 0.0
        except json.JSONDecodeError:
            pass
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--mode", mode, "--device", device,
           "--out", str(out), *extra]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        dt = time.time() - t0
        if out.exists():
            st = json.loads(out.read_text()).get("status", "error")
        else:
            st = "error"
            out.write_text(json.dumps({
                "arch": arch, "shape": shape, "mesh": mesh,
                "status": "error",
                "error": (proc.stderr or proc.stdout)[-2000:]}))
        return st, dt
    except subprocess.TimeoutExpired:
        out.write_text(json.dumps({"arch": arch, "shape": shape, "mesh": mesh,
                                   "status": "timeout"}))
        return "timeout", time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/sweep_torch")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--mode", default="fsdp")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the dry run's --device: the card's path or the plain one")
    ap.add_argument("--timeout", type=int, default=3000)
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = args.meshes.split(",")
    for shape in args.shapes.split(","):
        for arch in args.archs.split(","):
            for mesh in meshes:
                st, dt = run_cell(arch, shape, mesh, out_dir,
                                  mode=args.mode, timeout=args.timeout,
                                  device=args.device)
                print(f"[{time.strftime('%H:%M:%S')}] {arch:18s} {shape:12s} "
                      f"{mesh:6s} -> {st} ({dt:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
