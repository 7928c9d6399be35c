"""Run chip_smoke.py's runtime-robustness phases alone on one H100, each
phase reported and the next one run even if it fails.

    python3 tools/runtime_phases.py [chaos] [resume] [elastic]

(no argument: all three).

Builds the kernels, then: (a) qwen2.5-3b at full width trained with
hier + int8 under the guard and seed 8's chaos plan (12 steps), with the
guard's host milliseconds per step split into the CRC and the finiteness
check; the NaN block on the int8 wire, card against CPU (ROADMAP R20);
(b) checkpoint and resume at 4 layers (save_async, save, restore, the
resumed losses bit-equal to an uninterrupted run); (c) elastic
re-planning on four ranks as 2 pods x 2 data sharing the card over gloo
(hier_zero1 + int8, 4 layers, pod 1 lost before step 2).  Exits non-zero
if any phase failed.
"""

from __future__ import annotations

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from moe_phases import phase  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("runtime_phases: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.card()
    print(f"[env] {smi}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"[build] {cs._build.library().build_seconds:.1f} s", flush=True)
    failed: list[str] = []
    wanted = set(sys.argv[1:]) or {"chaos", "resume", "elastic"}
    cs.train_launch.init_world(dev)
    try:
        rt = cs.runtime_for_groups(pods=1, data_per_pod=1)
        if "chaos" in wanted:
            phase(failed, "chaos", cs.train_chaos, dev, smi)
            cs.free_memory()
            phase(failed, "nan_on_int8_wire", cs.check_nan_on_int8_wire, dev, rt)
        if "resume" in wanted:
            phase(failed, "resume", cs.train_resume, dev, smi)
            cs.free_memory()
        if "elastic" in wanted:
            phase(failed, "elastic", cs.train_elastic, smi)
    finally:
        dist.destroy_process_group()
    print(f"[time] runtime_phases: {time.perf_counter() - t0:.1f} s, failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
