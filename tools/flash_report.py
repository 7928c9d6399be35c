#!/usr/bin/env python3
"""Resources, tensor-core instructions and time of the port's tensor-core
kernels: flash attention (the default) or the Mamba2 SSD chunk.

    python3 tools/flash_report.py                     # csrc/flash_attention.cu
    python3 tools/flash_report.py --source ssd.cu     # csrc/ssd.cu

1. Compiles the source (under src/repro_torch/csrc/) with the port's nvcc
   flags (sm_90a) plus ``-Xptxas -v`` and prints, per kernel
   instantiation, what ptxas reports: registers, stack, spill stores and
   loads.  The kernels' shared memory is dynamic; its bytes per block
   are printed beside them (for the SSD chunk at the mamba2-2.7b prefill
   shape).
2. Counts the HMMA (tensor-core) instructions in each kernel's SASS
   (``cuobjdump -sass`` of the same object).
3. On a card, prints the card's name and power limit and times with CUDA
   events:
   - flash attention at the qwen2.5-3b prefill shape (B=4, H=16, K=2,
     S=1024, dh=128, causal) in bf16 and f32, beside
     ``F.scaled_dot_product_attention`` on the same inputs;
   - the SSD chunk at the mamba2-2.7b prefill shape (b=4, s=1024, h=80,
     p=64, g=1, n=128, q=128) in f32 and in bf16 at the heads per block
     the kernel picks and at 4, 8 and 16, each beside its bound and with
     the rate its f32 outputs are stored at.

Steps 1-2 need the CUDA toolkit, step 3 a card.
"""

from __future__ import annotations

import argparse
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
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402

# Tiles<DH>::kBytes of flash_attention.cu: (64 query rows + 2 x 2 x 64 key
# rows) of dh + 8 bf16 values
MMA_SMEM = {dh: (64 + 4 * 64) * (dh + 8) * 2 for dh in fa.HEAD_DIMS}
SSD_SHAPE = (4, 1024, 80, 64, 1, 128, 128)     # b, s, h, p, g, n, q
SSD_HEADS_PER_BLOCK = (0, 4, 8, 16)             # 0: the kernel's pick


def round16(v: int) -> int:
    return (v + 15) // 16 * 16


def ssd_smem(label: str) -> str:
    """Dynamic shared memory per block of ssd.cu's kernels at SSD_SHAPE:
    smem_bytes (f32) and mma_smem_bytes (bf16, at the 20 heads per block
    the launcher picks there)."""
    _, _, _, p, _, n, q = SSD_SHAPE
    if "mma" in label:
        heads, qt = 20, q // 16
        nbytes = (4 * q * (round16(n) + 8) + qt * (qt + 1) * 512 + 12 * heads * q
                  + 4 * q * (round16(p) + 8))
        return f"{nbytes} bytes at {SSD_SHAPE} with {heads} heads"
    return f"{4 * q * (2 * (n + 4) + p + 16 * 4 + 3)} bytes at {SSD_SHAPE}"


def smem_note(label: str) -> str:
    if label.startswith("flash_attention_mma"):
        dh = int(re.search(r"(\d+)>", label).group(1))
        return f"; {MMA_SMEM[dh]} bytes of dynamic shared memory per block"
    if label.startswith("ssd_chunk"):
        return f"; dynamic shared memory per block {ssd_smem(label)}"
    return ""


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
    m = re.search(r"((?:flash_attention|ssd_chunk)\w*)(?:<([^>]*)>)?", name)
    if m is None:
        return name
    return f"{m.group(1)}<{m.group(2).replace('(int)', '')}>" if m.group(2) else m.group(1)


def compile_and_inspect(source: pathlib.Path) -> None:
    tmp_root = _build.BUILD_DIR.parent / "report"
    tmp_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        obj = pathlib.Path(tmp) / f"{source.stem}.o"
        res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                              "-c", "-o", str(obj), str(source)],
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
        print(f"[ptxas] {label}: {'; '.join(ptxas.get(mangled, []))}{smem_note(label)}")
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


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def time_serving_shape(smi: str) -> None:
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


def time_ssd_prefill_shape(smi: str) -> None:
    from chip_smoke import ssd_bound_ms, ssd_inputs

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, p, g, n, q = SSD_SHAPE
    out_bytes = 4 * b * s * h * p + 4 * b * (s // q) * h * p * n   # y_diag and states, f32
    for dt in (torch.float32, torch.bfloat16):
        args = ssd_inputs("cuda", gen, b, s, h, p, g, n, dt)
        want = ssd.ssd_chunk_plain(*args, q)
        bound, by = ssd_bound_ms(b, s, h, p, g, n, q, dt)
        for hpb in (0,) if dt == torch.float32 else SSD_HEADS_PER_BLOCK:
            got = ssd.ssd_chunk_call(*args, q, heads_per_block=hpb)
            err = max(((a - w).abs().max() / w.abs().max()).item() for a, w in zip(got, want))
            ms = time_ms(lambda: ssd.ssd_chunk_call(*args, q, heads_per_block=hpb))
            runs = "one block per head" if dt == torch.float32 else (
                f"heads per block {hpb or 'picked'}")
            print(f"[time] [{smi}] ssd_chunk {SSD_SHAPE}, {dt}, {runs}: {ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({by}), {ms / bound:.1f}x the bound; f32 outputs "
                  f"stored at {out_bytes / ms / 1e9:.3f} TB/s; max error {err:.3g} of the "
                  f"largest magnitude")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default="flash_attention.cu",
                    choices=("flash_attention.cu", "ssd.cu"),
                    help="the source under src/repro_torch/csrc/ to inspect and time")
    source = _build.CSRC / ap.parse_args().source
    compile_and_inspect(source)
    if torch.cuda.is_available():
        smi = card()
        if source.stem == "ssd":
            time_ssd_prefill_shape(smi)
        else:
            time_serving_shape(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
