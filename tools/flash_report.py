#!/usr/bin/env python3
"""Resources, tensor-core instructions and time of the port's flash
attention kernels.

    python3 tools/flash_report.py

1. Compiles src/repro_torch/csrc/flash_attention.cu with the port's nvcc
   flags (sm_90a) plus ``-Xptxas -v`` and prints, per kernel
   instantiation, what ptxas reports: registers, stack, spill stores and
   loads.  The bf16 kernel's shared memory is dynamic; its bytes per
   block are printed beside it.
2. Counts the HMMA (tensor-core) instructions in each kernel's SASS
   (``cuobjdump -sass`` of the same object).
3. On a card, times the kernel at the qwen2.5-3b prefill shape (B=4,
   H=16, K=2, S=1024, dh=128, causal) in bf16 and f32 with CUDA events,
   beside ``F.scaled_dot_product_attention`` on the same inputs, and
   prints the card's name and power limit.

Steps 1-2 need the CUDA toolkit, step 3 a card.
"""

from __future__ import annotations

import collections
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = _build.CSRC / "flash_attention.cu"
# Tiles<DH>::kBytes of the source: (64 query rows + 2 x 2 x 64 key rows)
# of dh + 8 bf16 values
MMA_SMEM = {dh: (64 + 4 * 64) * (dh + 8) * 2 for dh in fa.HEAD_DIMS}


def demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("cu++filt") or str(pathlib.Path(_build.nvcc_path()).parent / "cu++filt")
    if not pathlib.Path(tool).exists():
        tool = shutil.which("c++filt")
    if tool is None:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def short(name: str) -> str:
    """flash_attention_mma_kernel<128> out of the demangled signature."""
    m = re.search(r"(flash_attention\w*)<([^>]*)>", name)
    return f"{m.group(1)}<{m.group(2).replace('(int)', '')}>" if m else name


def compile_and_inspect() -> None:
    tmp_root = _build.BUILD_DIR.parent / "report"
    tmp_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        obj = pathlib.Path(tmp) / "flash_attention.o"
        res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                              "-c", "-o", str(obj), str(SOURCE)],
                             capture_output=True, text=True, check=True)
        ptxas = collections.defaultdict(list)
        fn = None
        for line in (res.stdout + res.stderr).splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
            if m:
                fn = m.group(1)
            elif fn is not None and ("Used" in line or "stack frame" in line):
                ptxas[fn].append(line.split(":")[-1].strip() if "Used" in line
                                 else line.strip())
        cuobjdump = pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass", str(obj)], capture_output=True,
                              text=True, check=True).stdout
    hmma = collections.Counter()
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
        elif fn is not None and "HMMA" in line:
            hmma[fn] += 1
    names = demangle(sorted(set(ptxas) | set(hmma)))
    for mangled in sorted(names, key=lambda n: short(names[n])):
        label = short(names[mangled])
        dyn = ""
        if "mma" in label:
            dh = int(re.search(r"(\d+)>", label).group(1))
            dyn = f"; {MMA_SMEM[dh]} bytes of dynamic shared memory per block"
        print(f"[ptxas] {label}: {'; '.join(ptxas.get(mangled, []))}{dyn}")
        print(f"[sass] {label}: {hmma[mangled]} HMMA instructions")


def time_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_serving_shape() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, K, S, dh = 4, 16, 2, 1024, 128
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(B, H, S, dh, device="cuda", generator=gen).to(dt)
        k = torch.randn(B, K, S, dh, device="cuda", generator=gen).to(dt)
        v = torch.randn(B, K, S, dh, device="cuda", generator=gen).to(dt)
        err = (fa.flash_attention_bhsd(q, k, v).float()
               - fa.flash_attention_bhsd_plain(q, k, v).float()).abs().max().item()
        ms = time_ms(lambda: fa.flash_attention_bhsd(q, k, v, causal=True))
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                             enable_gqa=True))
        print(f"[time] [{smi}] flash_attention_bhsd {B}x{H}x{S}x{dh}, K={K}, causal, "
              f"{dt}: {ms:.4f} ms (max abs err {err:.3g} against the plain version), "
              f"F.scaled_dot_product_attention {lib:.4f} ms")


def main() -> int:
    compile_and_inspect()
    if torch.cuda.is_available():
        time_serving_shape()
    return 0


if __name__ == "__main__":
    sys.exit(main())
