"""Run chip_smoke.py's MoE phases alone on one H100, each phase reported
and the next one run even if it fails.

    python3 tools/moe_phases.py

Builds the kernels, checks and times flash attention at its cases
(qwen3-moe-30b-a3b's prefill heads among them), then: (a) qwen3-moe-30b-a3b
served at full width and its profile with the drops per layer; (b) the f32
MoE smoke models on the card against the CPU, serving and hier + int8
training; (d) qwen3-moe at chip_smoke.MOE_LAYERS layers served at TP 2 by
expert parallelism against TP 1, and the smoke MoE trained at TP 2 (two
spawned ranks sharing the card through gloo); (c) qwen3-moe at
MOE_LAYERS layers trained with hier + int8.  About 100 s of command time;
exits non-zero if any phase failed.
"""

from __future__ import annotations

import pathlib
import sys
import time
import traceback

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402


def phase(failed: list, name: str, fn, *args, **kw):
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kw)
    except Exception:
        failed.append(name)
        print(f"=== {name} FAILED in {time.perf_counter() - t0:.1f} s", flush=True)
        traceback.print_exc()
        return None
    print(f"=== {name} ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_phases: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.card()
    print(f"[env] {smi}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"[build] {cs._build.library().build_seconds:.1f} s", flush=True)
    failed: list[str] = []
    phase(failed, "flash", cs.check_flash, dev, torch.Generator(device=dev).manual_seed(0), smi)
    cs.free_memory()
    phase(failed, "serve_moe", cs.serve_moe, dev, smi)
    cs.free_memory()
    phase(failed, "profile_moe", cs.profile_moe, dev, smi)
    cs.free_memory()
    for arch in cs.MOE_SMOKE_ARCHS:
        phase(failed, f"small_model {arch}", cs.check_small_model, dev, arch)
    cs.train_launch.init_world(dev)
    try:
        rt = cs.runtime_for_groups(pods=1, data_per_pod=1)
        for arch in cs.MOE_SMOKE_ARCHS:
            phase(failed, f"small_training {arch}", cs.check_small_training, dev, rt, "hier",
                  "int8", arch=arch)
        phase(failed, "serve_moe_tp", cs.serve_moe_tp, dev, smi)
        cs.free_memory()
        phase(failed, "train_tp moe", cs.train_tp, smi, cs.MOE_ARCH)
        phase(failed, "train_moe", cs.train_moe, dev, smi)
    finally:
        dist.destroy_process_group()
    print(f"[time] moe_phases: {time.perf_counter() - t0:.1f} s, failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
