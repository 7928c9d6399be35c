"""Run chip_smoke.py's phases of the SSM families alone on one H100, each
phase reported and the next one run even if it fails.

    python3 tools/ssm_phases.py

Builds the kernels, checks and times flash attention (hymba-1.5b's
prefill heads and window among its cases) and the SSD chunk (a
mamba2-2.7b TP-2 rank's and hymba-1.5b's prefill shapes among them),
then: the f32 smoke mamba2 and hymba on the card against the CPU,
serving and hier + int8 training; mamba2-2.7b and hymba-1.5b served at
full width with their profiles; mamba2-2.7b at TP 2 (two spawned ranks
sharing the card through gloo), its f32 logits against TP 1 with the
gated norm per rank's channels; the smoke mamba2
and hymba trained at TP 2; mamba2-2.7b and hymba-1.5b trained at full
width with hier + int8, and a profiled step each.  Exits non-zero if any
phase failed.
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

ARCHS = ((cs.SSM_ARCH, cs.PROMPT), (cs.HYBRID_ARCH, cs.HYBRID_SEQ))


def main() -> int:
    if not torch.cuda.is_available():
        print("ssm_phases: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = cs.card()
    print(f"[env] {smi}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"[build] {cs._build.library().build_seconds:.1f} s", flush=True)
    failed: list[str] = []
    gen = torch.Generator(device=dev).manual_seed(0)
    phase(failed, "flash", cs.check_flash, dev, gen, smi)
    phase(failed, "ssd", cs.check_ssd, dev, gen, smi)
    cs.free_memory()
    for arch, _ in ARCHS:
        phase(failed, f"small_model {arch}", cs.check_small_model, dev, arch)
    cs.train_launch.init_world(dev)
    try:
        rt = cs.runtime_for_groups(pods=1, data_per_pod=1)
        for arch, _ in ARCHS:
            phase(failed, f"small_training {arch}", cs.check_small_training, dev, rt, "hier",
                  "int8", arch=arch)
        for arch, prompt in ARCHS:
            phase(failed, f"serve {arch}", cs.serve_full_width, dev, smi, arch, prompt)
            cs.free_memory()
            phase(failed, f"profile_serving {arch}", cs.profile_serving, dev, smi, arch, prompt)
            cs.free_memory()
        phase(failed, "serve_ssm_tp", cs.serve_ssm_tp, dev, smi)
        for arch, _ in ARCHS:
            phase(failed, f"train_tp {arch}", cs.train_tp, smi, arch)
        for arch, seq in ARCHS:
            phase(failed, f"train {arch}", cs.train_full_width, dev, smi, "hier", "int8", arch, seq)
            cs.free_memory()
            phase(failed, f"profile_training {arch}", cs.profile_training, dev, rt, smi, "hier",
                  "int8", with_attention=False, arch=arch, seq=seq)
            cs.free_memory()
    finally:
        dist.destroy_process_group()
    print(f"[time] ssm_phases: {time.perf_counter() - t0:.1f} s, failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
