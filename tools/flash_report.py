#!/usr/bin/env python3
"""Resources, instructions and time of the port's hand-written kernels:
flash attention (the default), the Mamba2 SSD chunk, the int8 codec, or
the fused pack+quantize.

    python3 tools/flash_report.py                     # csrc/flash_attention.cu
    python3 tools/flash_report.py --source ssd.cu [--baseline DIR] [--variants f32]
    python3 tools/flash_report.py --source quant.cu   # csrc/quant.cu
    python3 tools/flash_report.py --source pack.cu [--baseline DIR]

1. Compiles the source (under src/repro_torch/csrc/) with the port's nvcc
   flags (sm_90a) plus ``-Xptxas -v`` and prints, per kernel
   instantiation, what ptxas reports: registers, stack, spill stores and
   loads.  The kernels' shared memory is dynamic; its bytes per block
   are printed beside them (for the SSD chunk at the mamba2-2.7b prefill
   shape).
2. Counts, in each kernel's SASS (``cuobjdump -sass`` of the same
   object), the tensor-core instructions of flash and SSD (HMMA for
   mma.sync, HGMMA for wgmma) and the TMA loads and stores (UTMALDG,
   UTMASTG), or the codec's and the packing's global loads and stores by
   width (128, 64 bits or narrower).  For the wgmma flash kernel it
   checks that the registers a block holds at launch cover what its
   warpgroups ask for after setmaxnreg (a shortfall would stall the
   consumers for good), and for the f32 (tf32x3) kernels of flash and
   the SSD chunk that no instantiation spills and each has HMMA
   instructions; it exits 1 if not.
3. On a card, prints the card's name and power limit and times with CUDA
   events:
   - flash attention at every timed prefill shape of chip_smoke.py
     (FLASH_TIMED: bf16 and f32 at the qwen2.5-3b shape, bf16 at the
     other full-width shapes, bf16 and f32 at the serve example's rank),
     each beside its bound and ``F.scaled_dot_product_attention`` on the
     same inputs, with the route the call takes; with ``--baseline DIR``,
     the flash kernels of another checkout (e.g. the parent commit
     unpacked by ``git archive``) built from its csrc/ and timed in turns
     with this tree's (baseline, this tree, this tree, baseline); with
     ``--variants [bf16|f32]``, FLASH_VARIANTS of that dtype's kernel;
   - the SSD chunk through the C entry point at the mamba2-2.7b prefill
     shape (b=4, s=1024, h=80, p=64, g=1, n=128, q=128) and at
     hymba-1.5b's (b=4, s=2048, h=32, p=100, g=1, n=16) in f32 and bf16,
     and at a mamba2-2.7b TP-2 rank's (h=40) in bf16, each beside its
     bound; with ``--baseline DIR``, the SSD kernels of another checkout
     built from its csrc/ssd.cu and timed in turns with this tree's
     (baseline, this tree, this tree, baseline); with ``--variants f32``,
     SSD_VARIANTS of the f32 kernel; then in bf16 at the mamba2-2.7b
     shape at the heads per block the kernel picks and at 4, 8 and 16,
     each beside its bound and with the rate its f32 outputs are stored
     at;
   - the shared-scale codec's streaming kernels at their main path
     shapes: amax_block and quant_scaled on qwen2.5-3b's bf16 gradient
     segment (3,085,938,688 values), dequant_int8 from int32 to bf16 on
     it, from int8 to bf16 on the KV leaf (36, 4, 1024, 2, 128) and from
     int8 to f32 on mamba2-2.7b's SSM state (64, 4, 80, 64, 128), each in
     its vector and its scalar variant (the kernel before its redesign)
     beside its bound, its rate and one PyTorch call computing the same
     function (vector_norm(ord=inf) for amax_block, torch.mul into a bf16
     out for the decode); then the same vector kernels built from edited
     copies of csrc/ (CODEC_ABLATIONS: no stores, loads only, a multiply
     for the division, streaming cache hints, CTAs per SM, amax_block's
     blocks per warp), one nvcc each, all started together;
   - fused_pack_quant at qwen2.5-3b's gradient layout (the 434 parameter
     tensors of a full-width model with random weights standing for the
     gradients), beside its bound, the kernel of another checkout of the
     repository built from its csrc/pack.cu (``--baseline DIR``, e.g. the
     parent commit unpacked by ``git archive``; the same C entry) and the
     ablations of CODEC_ABLATIONS on pack.cu (a search once per block,
     2 or 8 CTAs per SM, values only).

Steps 1-2 need the CUDA toolkit, step 3 a card; ``--inspect-only`` stops
after step 2.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
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
SASS_OPS = ("HMMA", "HGMMA", "UTMALDG", "UTMASTG")
# flash_attention_wgmma_kernel's WgSmem<DH>::kBytes: 1024 of alignment
# slack, the 128-row Q tile, 2 stages of 128-key K and V tiles, 5
# mbarriers; and the registers its warpgroups ask for after setmaxnreg
# (the producer 24 a thread, the two consumers 240), which the 384
# threads must hold at launch
WGMMA_SMEM = {dh: 1024 + (128 + 2 * 2 * 128) * dh * 2 + 8 * 5 for dh in fa.WGMMA_HEAD_DIMS}
WGMMA_ASKED = 128 * 24 + 256 * 240
# TfTiles<DH>::kBytes: 64 query rows and 2 x 32 key rows of dh + 8 floats,
# 2 x 32 value rows of dh + 4
TF32X3_SMEM = {dh: 4 * (64 * (dh + 8) + 64 * (dh + 8) + 64 * (dh + 4)) for dh in fa.HEAD_DIMS}
SSD_SHAPE = (4, 1024, 80, 64, 1, 128, 128)     # b, s, h, p, g, n, q
# the SSD chunk's shapes timed through the C entry point: mamba2-2.7b's,
# a mamba2-2.7b TP-2 rank's (40 heads) and hymba-1.5b's prefill; the
# variants run at the f32 ones
_HYMBA = (4, 2048, 32, 100, 1, 16, 128)
SSD_TIMED = {("mamba2-2.7b", torch.float32): SSD_SHAPE, ("hymba-1.5b", torch.float32): _HYMBA,
             ("mamba2-2.7b", torch.bfloat16): SSD_SHAPE,
             ("mamba2-2.7b TP-2 rank", torch.bfloat16): (4, 1024, 40, 64, 1, 128, 128),
             ("hymba-1.5b", torch.bfloat16): _HYMBA}
SSD_HEADS_PER_BLOCK = (0, 4, 8, 16)             # 0: the kernel's pick
SEGMENT = 3_085_938_688                         # qwen2.5-3b's bf16 gradient segment
KV_LEAF = (36, 4, 1024, 2, 128)                 # one qwen2.5-3b cache leaf
SSM_LEAF = (64, 4, 80, 64, 128)                 # mamba2-2.7b's f32 SSM state
PEAK_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet

_NEVER = "0x80808080u"      # no q byte is -128, so no unit's bits are this
_STORES = {
    "uint4": "__device__ __forceinline__ void store16(void* p, uint4 v) { ",
    "uint2": "__device__ __forceinline__ void store8(void* p, uint2 v) { ",
    "unsigned": "__device__ __forceinline__ void store4(void* p, unsigned v) { ",
}
_NO_STORES = [("codec.cuh", head + f"*static_cast<{t}*>(p) = v; }}",
               head + f"if ({'v' if t == 'unsigned' else 'v.x'} == {_NEVER}) "
               f"*static_cast<{t}*>(p) = v; }}") for t, head in _STORES.items()]
# name: (the kernels it is timed on, [(file under csrc/, text, replacement)]);
# each text must occur in the copy
QS, DQ, AM, FP = ("quant_scaled",), ("dequant_int8",), ("amax_block",), ("fused_pack_quant",)
KERNEL_SOURCE = {"quant_scaled": "quant.cu", "dequant_int8": "quant.cu",
                 "amax_block": "quant.cu", "fused_pack_quant": "pack.cu"}
_FUSED_WALK = "    while (sp.dst + sp.n <= base && k + 1 < n_spans) sp = spans[++k];"
CODEC_ABLATIONS = {
    "no stores": (QS + DQ, _NO_STORES),
    "loads only (no stores, no arithmetic)": (QS + DQ, _NO_STORES + [
        ("quant.cu", "  const unsigned w[4] = {in.x, in.y, in.z, in.w};",
         f"  if ((in.x ^ in.y ^ in.z ^ in.w) != {_NEVER}) return;\n"
         "  const unsigned w[4] = {in.x, in.y, in.z, in.w};"),
        ("quant.cu", "    unsigned o[4] = {};",
         "    unsigned h = 0;\n    for (int k = 0; k < kInWords; ++k) h ^= w[k];\n"
         f"    if (h != {_NEVER}) return;\n    unsigned o[4] = {{}};")]),
    "multiply for the division": (QS, [
        ("codec.cuh", "rintf(__fdiv_rn(v, scale))", "rintf(__fmul_rn(v, scale))")]),
    # the same bits as rintf and the float -> int8 conversion (both on the
    # quarter-rate conversion pipe), from two adds on the 1.5 * 2^23 grid
    "rint and int8 conversion by adding 1.5 * 2^23": (QS, [
        ("codec.cuh", "  const float r = rintf(__fdiv_rn(v, scale));\n"
         "  return r != r ? int8_t{0} : static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));",
         "  const float y = __fdiv_rn(v, scale);\n"
         "  const float t = fminf(fmaxf(__fadd_rn(y, 12582912.f), 12582785.f), 12583039.f);\n"
         "  return y != y ? int8_t{0} : static_cast<int8_t>(__float_as_uint(t) & 0xffu);")]),
    "cache hints (__ldcs, __stcs)": (QS + DQ, [
        ("codec.cuh", f"return *static_cast<const {t}*>(p);",
         f"return __ldcs(static_cast<const {t}*>(p));") for t in ("uint4", "uint2", "unsigned")] + [
        ("codec.cuh", head + f"*static_cast<{t}*>(p) = v; }}",
         head + f"__stcs(static_cast<{t}*>(p), v); }}") for t, head in _STORES.items()]),
    **{f"{k} CTA{'s' * (k > 1)} per SM": (QS, [
        ("quant.cu", "constexpr int kQuantScaledCtasPerSm = 8;",
         f"constexpr int kQuantScaledCtasPerSm = {k};")]) for k in (1, 2, 4)},
    "8 CTAs per SM forced (__launch_bounds__(256, 8))": (QS, [
        ("quant.cu", "__launch_bounds__(kThreads)\nquant_scaled_vec_kernel",
         "__launch_bounds__(kThreads, 8)\nquant_scaled_vec_kernel")]),
    **{f"{kb} KB of loads in flight per SM": (DQ, [
        ("quant.cu", "constexpr int kDequantLoadBytesPerSm = 64 * 1024;",
         f"constexpr int kDequantLoadBytesPerSm = {kb} * 1024;")]) for kb in (16, 32, 128)},
    **{f"{v} values per lane": (QS + DQ, [
        ("codec.cuh", "constexpr int kTile = 8192;", f"constexpr int kTile = {v * 256};")])
       for v in (16, 64)},
    **{f"amax_block: {kb} KB of loads in flight per SM, {k} block{'s' * (k > 1)} per warp": (AM, [
        ("quant.cu", "constexpr int kAmaxLoadBytesPerSm = 64 * 1024;",
         f"constexpr int kAmaxLoadBytesPerSm = {kb} * 1024;"),
        ("quant.cu", "constexpr int kAmaxBlocksPerWarp = 1;",
         f"constexpr int kAmaxBlocksPerWarp = {k};")]) for kb, k in ((16, 1), (32, 1), (128, 1),
                                                                     (64, 2))},
    # the suspect of the first design: a table search for every block
    "fused_pack_quant: a search once per block": (FP, [
        ("pack.cu", _FUSED_WALK,
         "    k = warp_find_span(spans, n_spans, base, lane);\n    sp = spans[k];")]),
    "fused_pack_quant: 2 CTAs per SM": (FP, [
        ("pack.cu", "constexpr int kFusedCtasPerSm = 8;", "constexpr int kFusedCtasPerSm = 2;")]),
    # at its 64 registers 4 CTAs fit an SM; 32 registers let 8 fit
    "fused_pack_quant: 8 CTAs per SM forced (__launch_bounds__(256, 8))": (FP, [
        ("pack.cu", "__launch_bounds__(kThreads)\nfused_pack_quant_kernel",
         "__launch_bounds__(kThreads, 8)\nfused_pack_quant_kernel")]),
    "fused_pack_quant: values only (no 16-byte words)": (FP, [
        ("pack.cu", "    if (sp.src != 0 && off + kBlock <= sp.n && (addr & 15) == 0) {",
         "    if (false) {")]),
}


def round16(v: int) -> int:
    return (v + 15) // 16 * 16


def ssd_smem(label: str) -> str:
    """Dynamic shared memory per block of ssd.cu's kernels at SSD_SHAPE, at
    the 20 heads per block the launchers pick there: mma_smem_bytes (bf16)
    and tf_smem_bytes (f32, two x buffers)."""
    _, _, _, p, _, n, q = SSD_SHAPE
    heads, qt = 20, q // 16
    if "mma" in label:
        nbytes = (4 * q * (round16(n) + 8) + qt * (qt + 1) * 512 + 12 * heads * q
                  + 4 * q * (round16(p) + 8))
    else:
        nbytes = 4 * (2 * q * ((p + 7) // 8 * 8 + 4) + q * (round16(n) + 4)
                      + qt * (qt + 1) * 128 + 3 * heads * q)
    return f"{nbytes} bytes at {SSD_SHAPE} with {heads} heads"


def smem_note(label: str) -> str:
    if label.startswith("flash_attention_mma"):
        dh = int(re.search(r"(\d+)>", label).group(1))
        return f"; {MMA_SMEM[dh]} bytes of dynamic shared memory per block"
    if label.startswith("flash_attention_wgmma"):
        dh = int(re.search(r"(\d+)>", label).group(1))
        return f"; {WGMMA_SMEM[dh]} bytes of dynamic shared memory per block"
    if label.startswith("flash_attention_tf32x3"):
        dh = int(re.search(r"<(\d+)", label).group(1))
        return f"; {TF32X3_SMEM[dh]} bytes of dynamic shared memory per block"
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
    m = re.search(r"((?:flash_attention|ssd_chunk|dequant_int8|quant_int8|quant_scaled|"
                  r"amax_block|pack_slots|fused_pack_quant)\w*)(?:<([^>]*)>)?", name)
    if m is None:
        return name
    return f"{m.group(1)}<{m.group(2).replace('(int)', '')}>" if m.group(2) else m.group(1)


def compile_and_inspect(source: pathlib.Path) -> bool:
    """Steps 1-2; False when a wgmma kernel's registers at launch fall
    short of what setmaxnreg asks for, or it has no HGMMA or UTMALDG, or
    a tf32x3 kernel (flash's or the SSD chunk's) spills or has no HMMA."""
    tmp_root = _build.BUILD_DIR.parent / "report"
    tmp_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp_root) as tmp:
        obj = pathlib.Path(tmp) / f"{source.stem}.o"
        res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                              "-c", "-o", str(obj), str(source)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        ptxas = collections.defaultdict(list)
        fn = None
        warnings = [line.strip() for line in (res.stdout + res.stderr).splitlines()
                    if "warning" in line.lower()]
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
    counts = collections.defaultdict(collections.Counter)
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            continue
        op = re.search(r"\b(HGMMA|HMMA|UTMALDG|UTMASTG|LDG|STG)(\.\S*)?", line)
        if fn is not None and op is not None:
            if op.group(1) in SASS_OPS:
                counts[fn][op.group(1)] += 1
            else:
                width = next((w for w in ("128", "64") if f".{w}" in (op.group(2) or "")),
                             "narrower")
                counts[fn][f"{op.group(1)}.{width}"] += 1
    names = demangle(sorted(set(ptxas) | set(counts)))
    ok = True
    for mangled in sorted(names, key=lambda n: short(names[n])):
        label = short(names[mangled])
        print(f"[ptxas] {label}: {'; '.join(ptxas.get(mangled, []))}{smem_note(label)}")
        c = counts[mangled]
        if source.stem in ("quant", "pack"):
            print(f"[sass] {label}: global loads by width " + ", ".join(
                f"{w} {c[f'LDG.{w}']}" for w in ("128", "64", "narrower")) + "; stores " + ", ".join(
                f"{w} {c[f'STG.{w}']}" for w in ("128", "64", "narrower")))
        else:
            print(f"[sass] {label}: " + ", ".join(f"{c[op]} {op}" for op in SASS_OPS))
        if label.startswith("flash_attention_wgmma"):
            used = re.search(r"Used (\d+) registers", " ".join(ptxas.get(mangled, [])))
            held = 384 * int(used.group(1)) if used else 0
            print(f"[ptxas] {label}: {held} registers held at launch, {WGMMA_ASKED} asked "
                  f"for after setmaxnreg")
            ok = ok and held >= WGMMA_ASKED and c["HGMMA"] > 0 and c["UTMALDG"] > 0
        if "tf32x3" in label:
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                               " ".join(ptxas.get(mangled, [])))
            spilled = spills is None or spills.group(1) != "0" or spills.group(2) != "0"
            print(f"[ptxas] {label}: {'spills' if spilled else 'no spills'}")
            ok = ok and not spilled and c["HMMA"] > 0
    for line in warnings:
        print(f"[ptxas] {line}")
    return ok


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


def flash_launcher(lib, q, k, v, out, causal: bool, window):
    """A call of ``lib``'s flash_attention_launch as the wrapper makes it."""
    B, H, Sq, dh = q.shape
    K, Skv = k.shape[1], k.shape[2]
    stream = _build.stream_handle(q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), fa._CODES[q.dtype],
            B, H, K, Sq, Skv, dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], 1.0 / dh ** 0.5, int(causal), window or 0, 0, Skv, stream)
    return lambda: _build.check(lib.flash_attention_launch(*args), "flash_attention")


def time_flash_shapes(smi: str, baseline: pathlib.Path | None) -> None:
    from chip_smoke import FLASH_TIMED, flash_bound_ms

    base = build_baseline(baseline, "flash_attention.cu") if baseline is not None else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (B, H, K, dh, dt, Sq, Skv, causal, window), (_, shape) in FLASH_TIMED.items():
        q = torch.randn(B, H, Sq, dh, device="cuda", generator=gen).to(dt)
        k = torch.randn(B, K, Skv, dh, device="cuda", generator=gen).to(dt)
        v = torch.randn(B, K, Skv, dh, device="cuda", generator=gen).to(dt)
        kw = dict(causal=causal, window=window)
        want = fa.flash_attention_bhsd_plain(q, k, v, **kw).float()
        err = (fa.flash_attention_bhsd(q, k, v, **kw).float() - want).abs().max().item()
        bound, by = flash_bound_ms(B, H, K, Sq, dh, 0, Skv, causal, dt, window)
        line = [f"[time] [{smi}] flash_attention_bhsd {shape}, {dt}, route "
                f"{fa.route(dt, dh)}: max abs err {err:.3g}; bound {bound:.4g} ms ({by})"]
        # both trees through the C entry point straight, then through the
        # wrapper (whose Python adds host time to every call)
        out = torch.empty_like(q)
        shipped = flash_launcher(_build.library(), q, k, v, out, causal, window)
        wrapper = lambda: fa.flash_attention_bhsd(q, k, v, **kw)   # noqa: E731
        if base is None:
            line.append(f"this tree {time_ms(shipped):.4f} ms")
        else:
            before = flash_launcher(base, q, k, v, out, causal, window)
            before()
            base_err = (out.float() - want).abs().max().item()
            times = [time_ms(fn) for fn in (before, shipped, shipped, before)]
            line.append(f"baseline {times[0]:.4f} / {times[3]:.4f} ms (max abs err "
                        f"{base_err:.3g}), this tree {times[1]:.4f} / {times[2]:.4f} ms")
        line.append(f"through the wrapper {time_ms(wrapper):.4f} ms")
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q, k, v, is_causal=causal, enable_gqa=True)
        else:
            pos = torch.arange(Sq, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        line.append(f"F.scaled_dot_product_attention {time_ms(lib):.4f} ms")
        if dt == torch.float32:
            line.append(f"max abs err {err / want.abs().max().item():.3g} of the largest "
                        f"magnitude (TF32X3_TOL {fa.TF32X3_TOL})")
        print("; ".join(line))


def _constant(name: str, old: int, new: int) -> tuple:
    return ("flash_attention.cu", f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


_BF16, _F32 = torch.bfloat16, torch.float32
# name: (the dtype whose kernel it edits, the head size it is timed at or
# None for every one, edits).  The wgmma kernel's design space (key tile,
# ring stages, blocks per SM) and the tf32x3 kernel's (key tile, the
# split's rounding), and ablations that drop one part of a tile's work,
# timed only (their outputs are wrong by design).
FLASH_VARIANTS = {
    "64-key tiles, 2 stages": (_BF16, None, [_constant("kWgKeys", 128, 64)]),
    "64-key tiles, 4 stages": (_BF16, None, [_constant("kWgKeys", 128, 64),
                                             _constant("kWgStages", 2, 4)]),
    "128-key tiles, 3 stages": (_BF16, None, [_constant("kWgStages", 2, 3)]),
    # at 2 blocks a SM a block holds 80 registers a thread at launch, so a
    # consumer gets 104 of them: only dh 64 at 64-key tiles fits
    "64-key tiles, 2 blocks per SM": (_BF16, 64, [
        _constant("kWgKeys", 128, 64), _constant("kConsumerRegs", 240, 104),
        ("flash_attention.cu", "__launch_bounds__(kWgThreads, 1)",
         "__launch_bounds__(kWgThreads, 2)")]),
    "ablation: no exp2 (timing only)": (_BF16, None, [
        ("flash_attention.cu", "exp2_approx(fmaf(s[i], scale_log2, -ms[r]))",
         "fmaf(s[i], scale_log2, -ms[r])")]),
    "ablation: no Q K^T, S = 0 (timing only)": (_BF16, None, [
        ("flash_attention.cu", "      float s[kWgKeys / 2];", "      float s[kWgKeys / 2] = {};"),
        ("flash_attention.cu", "        wgmma_ss(\n", "        if (kk < 0) wgmma_ss(\n")]),
    "ablation: no P V (timing only)": (_BF16, None, [
        ("flash_attention.cu", "          wgmma_m64n64k16_rs_tb(\n",
         "          if (kc < 0) wgmma_m64n64k16_rs_tb(\n")]),
    "ablation: consumers skip every tile, loads only (timing only)": (_BF16, None, [
        ("flash_attention.cu", "    if (wg_rows && k0 < wk_end && k0 + kWgKeys > wk_begin) {",
         "    if (false) {")]),
    "tf32x3: 64-key tiles (one block an SM at dh 128)": (_F32, None, [
        _constant("kTfKeys", 32, 64)]),
    # the split as first written: hi and lo each rounded by cvt.rna.tf32.f32
    "tf32x3: split by cvt.rna.tf32.f32 twice": (_F32, None, [
        ("mma.cuh", "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
         "  lo = __float_as_uint(x - __uint_as_float(hi));",
         '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n  hi &= 0xffffe000u;\n'
         '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));')]),
    # hi by truncation (one instruction fewer a value; lo then up to a
    # whole tf32 unit of x, so the split keeps about 2^-20 of it)
    "tf32x3: hi truncated": (_F32, None, [
        ("mma.cuh", "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
         "  hi = __float_as_uint(x) & 0xffffe000u;")]),
    # hi by Veltkamp's split on the FP32 pipe: c = x (2^13 + 1), hi = c -
    # (c - x) would keep 11 significant bits, but nvcc contracts c - x into
    # an FMA, so hi keeps more and the split loses 2^-11 (error and timing
    # only)
    "tf32x3: split by Veltkamp (FP32 pipe)": (_F32, None, [
        ("mma.cuh", "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
         "  lo = __float_as_uint(x - __uint_as_float(hi));",
         "  const float c = x * 8193.0f;\n  const float h = c - (c - x);\n"
         "  hi = __float_as_uint(h);\n  lo = __float_as_uint(x - h);")]),
    "tf32x3: 8 warps (128 query rows a block, one block an SM at dh 128)": (_F32, None, [
        _constant("kTfWarps", 4, 8),
        ("flash_attention.cu", "__launch_bounds__(kTfThreads, 2)",
         "__launch_bounds__(kTfThreads, 1)")]),
    "tf32x3: 16-key tiles, 3 blocks an SM": (_F32, None, [
        _constant("kTfKeys", 32, 16),
        ("flash_attention.cu", "__launch_bounds__(kTfThreads, 2)",
         "__launch_bounds__(kTfThreads, 3)")]),
    "ablation: tf32x3, one TF32 product (error and timing only)": (_F32, None, [
        ("mma.cuh", "  mma_tf32(d, al, bh0, bh1);\n  mma_tf32(d, ah, bl0, bl1);\n", "")]),
    "ablation: tf32x3, warps skip every tile, loads only (timing only)": (_F32, None, [
        ("flash_attention.cu",
         "    if (warp_rows && k0 < wk_end && k0 + kTfKeys > wk_begin) {", "    if (false) {")]),
}
# the shapes the variants are timed at: FLASH_TIMED's keys
FLASH_VARIANT_SHAPES = (None, "chameleon", "qwen3_moe_tp1", "whisper_encoder", "hymba", "f32")


def time_flash_variants(smi: str, which: str) -> None:
    """FLASH_VARIANTS of the bf16 or the f32 kernel (``which``, or
    "all"), each built from an edited copy of csrc/ and timed beside this
    tree's kernel at FLASH_VARIANT_SHAPES of its dtype."""
    from chip_smoke import FLASH_TIMED, device_ms, flash_bound_ms

    dtypes = {"all": (_BF16, _F32), "bf16": (_BF16,), "f32": (_F32,)}[which]
    variants = {name: v for name, v in FLASH_VARIANTS.items() if v[0] in dtypes}
    libs = build_edited("flash_attention.cu", "flash",
                        {name: edits for name, (_, _, edits) in variants.items()})
    shipped = _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (B, H, K, dh, dt, Sq, Skv, causal, window), (key, shape) in FLASH_TIMED.items():
        if key not in FLASH_VARIANT_SHAPES or dt not in dtypes:
            continue
        q = torch.randn(B, H, Sq, dh, device="cuda", generator=gen).to(dt)
        k = torch.randn(B, K, Skv, dh, device="cuda", generator=gen).to(dt)
        v = torch.randn(B, K, Skv, dh, device="cuda", generator=gen).to(dt)
        want = fa.flash_attention_bhsd_plain(q, k, v, causal=causal, window=window).float()
        out = torch.empty_like(q)
        bound, by = flash_bound_ms(B, H, K, Sq, dh, 0, Skv, causal, dt, window)
        base = flash_launcher(shipped, q, k, v, out, causal, window)
        print(f"[ablation] [{smi}] flash {shape}, {dt}: bound {bound:.4f} ms ({by}); this tree "
              f"{time_ms(base):.4f} ms, device time {device_ms(base):.4f} ms")
        for name, (vdt, only, _) in variants.items():
            if vdt != dt or only not in (None, dh):
                continue
            fn = flash_launcher(libs[name], q, k, v, out, causal, window)
            fn()
            err = (out.float() - want).abs().max().item()
            print(f"[ablation] [{smi}] flash {shape}, {dt}: {name}: {time_ms(fn):.4f} ms, device "
                  f"time {device_ms(fn):.4f} ms, max abs err {err:.3g} ({err / want.abs().max():.3g} "
                  f"of the largest magnitude)")
        print(f"[ablation] [{smi}] flash {shape}, {dt}: this tree again {time_ms(base):.4f} ms")


def _ssd(old: str, new: str) -> tuple:
    return ("ssd.cu", old, new)


_SSD_PARTS = "  a.parts = pick_parts(batch * a.nc * a.G, rep, max_heads);\n"
_SSD_ROWS = "    for (int pd = 0; has_rows && pd < PT; pd += kPassTiles) {"
_SSD_STATES = "    for (int p0 = np0; has_state && p0 < np1; p0 += kPassTiles) {"
# name: edits of csrc/ (the f32 kernel's design space: heads per block,
# one x buffer, expf for ex2.approx, the small terms' accumulator; and
# ablations that drop one part of a head's work or the split of one
# operand, timed only: their outputs are wrong by design)
SSD_VARIANTS = {
    **{f"{k} heads per block": [_ssd(_SSD_PARTS, f"  a.parts = (rep + {k - 1}) / {k};\n")]
       for k in (4, 8, 10, 16)},
    "one x buffer (no prefetch)": [_ssd(
        "  a.xbufs = tf_smem_bytes(a.Q, a.P, a.N, 1, 2) <= static_cast<size_t>(kMaxSmem) ? 2 : 1;",
        "  a.xbufs = 1;")],
    "expf for ex2.approx": [_ssd("sDt, sCs, sW, kLog2e);", "sDt, sCs, sW, 1.f);"),
                            _ssd("exp2_approx(e", "expf(e")],
    **{f"y_diag's key loop unrolled by {k}": [
        _ssd("#pragma unroll 2\n      for (int kb = 0; kb < 2 * (rt + 1); ++kb) {",
             f"#pragma unroll {k}\n      for (int kb = 0; kb < 2 * (rt + 1); ++kb) {{")]
       for k in (1, 4)},
    **{f"the states' key loop unrolled by {k}": [
        _ssd("#pragma unroll 1\n      for (int j = 2 * t; j < Q; j += 8) {",
             f"#pragma unroll {k}\n      for (int j = 2 * t; j < Q; j += 8) {{")]
       for k in (2, 4)},
    # the first design's passes: a guard on each tile past p or past the
    # warp's tiles of n
    "tile guards in the passes": [
        _ssd("for (int dp = 0; dp < kPassTiles; ++dp) {\n          const float2 x0",
             "for (int dp = 0; dp < kPassTiles; ++dp) {\n          if (pd + dp >= PT) continue;\n"
             "          const float2 x0"),
        _ssd("for (int pr = 0; pr < kPassTiles; ++pr) {\n          const float2 b0",
             "for (int pr = 0; pr < kPassTiles; ++pr) {\n          if (p0 + pr >= np1) continue;\n"
             "          const float2 b0")],
    # the small terms into a zeroed accumulator, added after: the chain
    # into d is one product, not three
    "small terms apart": [
        ("mma.cuh", "  mma_tf32(d, al, bh0, bh1);\n  mma_tf32(d, ah, bl0, bl1);\n"
         "  mma_tf32(d, ah, bh0, bh1);\n",
         "  float s[4] = {0.f, 0.f, 0.f, 0.f};\n  mma_tf32(s, al, bh0, bh1);\n"
         "  mma_tf32(s, ah, bl0, bl1);\n  mma_tf32(d, ah, bh0, bh1);\n"
         "  d[0] += s[0]; d[1] += s[1]; d[2] += s[2]; d[3] += s[3];\n")],
    "ablation: one TF32 product (error and timing only)": [
        ("mma.cuh", "  mma_tf32(d, al, bh0, bh1);\n  mma_tf32(d, ah, bl0, bl1);\n", "")],
    # the split instructions a pre-split B (states) or x (y_diag) would
    # save, at most: the operand's bits as hi and as lo, loads and products
    # as they are
    "ablation: B not split in the states (timing only)": [
        _ssd(f"split_tf32({v}0.{c}, bh0, bl0);\n          split_tf32({v}1.{c}, bh1, bl1);",
             f"bh0 = bl0 = __float_as_uint({v}0.{c});\n          "
             f"bh1 = bl1 = __float_as_uint({v}1.{c});") for v, c in (("b", "x"), ("b", "y"))],
    "ablation: x not split in y_diag (timing only)": [
        _ssd(f"split_tf32({v}0.{c}, bh0, bl0);\n          split_tf32({v}1.{c}, bh1, bl1);",
             f"bh0 = bl0 = __float_as_uint({v}0.{c});\n          "
             f"bh1 = bl1 = __float_as_uint({v}1.{c});") for v, c in (("x", "x"), ("x", "y"))],
    "ablation: no y_diag (timing only)": [_ssd(_SSD_ROWS, _SSD_ROWS.replace("has_rows", "false"))],
    "ablation: no states (timing only)": [_ssd(_SSD_STATES, _SSD_STATES.replace("has_state", "false"))],
    "ablation: loads, scans and C B^T only (timing only)": [
        _ssd(_SSD_ROWS, _SSD_ROWS.replace("has_rows", "false")),
        _ssd(_SSD_STATES, _SSD_STATES.replace("has_state", "false"))],
}


def ssd_launcher(lib, args, y, st, q: int, heads_per_block: int = 0):
    """A call of ``lib``'s ssd_chunk_launch as the wrapper makes it, into
    ``y`` and ``st``."""
    x, dt, A, B, C = args
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    call = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            ssd._CODES[x.dtype], y.data_ptr(), st.data_ptr(), b, s, h, g, p, n, q,
            *x.stride()[:3], *dt.stride()[:3], *B.stride()[:3], *C.stride()[:3],
            heads_per_block, _build.stream_handle(x.device))
    return lambda: _build.check(lib.ssd_chunk_launch(*call), "ssd_chunk")


def ssd_error(got, want) -> float:
    """The larger of y_diag's and the states' max error, as a share of the
    plain output's largest magnitude."""
    return max(((a - w).abs().max() / w.abs().max()).item() for a, w in zip(got, want))


def time_ssd_shapes(smi: str, baseline: pathlib.Path | None, variants: bool) -> None:
    """The SSD chunk at SSD_TIMED through the C entry point, beside its
    bound, the baseline's kernel in turns and (f32) SSD_VARIANTS."""
    from chip_smoke import ssd_bound_ms, ssd_inputs

    base = build_baseline(baseline, "ssd.cu") if baseline is not None else None
    libs = build_edited("ssd.cu", "ssd", SSD_VARIANTS) if variants else {}
    shipped = _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False     # the plain version in full f32
    for (name, dtype), (b, s, h, p, g, n, q) in SSD_TIMED.items():
        args = ssd_inputs("cuda", gen, b, s, h, p, g, n, dtype, view=True)
        want = ssd.ssd_chunk_plain(*args, q)
        # the kernel's outputs are contiguous (the plain version's y_diag is a
        # permuted einsum result, so not empty_like)
        y, st = (torch.empty(w.shape, device="cuda") for w in want)
        bound, by = ssd_bound_ms(b, s, h, p, g, n, q, dtype)
        this = ssd_launcher(shipped, args, y, st, q)
        this()
        err = ssd_error((y, st), want)
        line = [f"[time] [{smi}] ssd_chunk {dtype} {name} prefill {(b, s, h, p, g, n, q)}, conv "
                f"slices: bound {bound:.4f} ms ({by}); max error {err:.3g} of the largest "
                f"magnitude"]
        if base is None:
            ms = time_ms(this, 20)
            line.append(f"this tree {ms:.4f} ms ({bound / ms:.1%} of the bound)")
        else:
            before = ssd_launcher(base, args, y, st, q)
            before()
            base_err = ssd_error((y, st), want)
            times = [time_ms(fn, 20) for fn in (before, this, this, before)]
            line.append(f"baseline {times[0]:.4f} / {times[3]:.4f} ms (max error {base_err:.3g})"
                        f", this tree {times[1]:.4f} / {times[2]:.4f} ms ({bound / times[1]:.1%} "
                        f"/ {bound / times[2]:.1%} of the bound)")
        print("; ".join(line))
        if dtype != torch.float32:
            continue
        for vname, lib in libs.items():
            fn = ssd_launcher(lib, args, y, st, q)
            fn()
            verr = ssd_error((y, st), want)
            ms = time_ms(fn, 20)
            print(f"[ablation] [{smi}] ssd_chunk f32 {name}: {vname}: {ms:.4f} ms "
                  f"({bound / ms:.1%} of the bound), max error {verr:.3g} of the largest "
                  f"magnitude")
        if libs:
            print(f"[ablation] [{smi}] ssd_chunk f32 {name}: this tree again "
                  f"{time_ms(this, 20):.4f} ms")
    torch.backends.cuda.matmul.allow_tf32 = saved


def time_ssd_heads_per_block(smi: str) -> None:
    from chip_smoke import ssd_bound_ms, ssd_inputs

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, p, g, n, q = SSD_SHAPE
    out_bytes = 4 * b * s * h * p + 4 * b * (s // q) * h * p * n   # y_diag and states, f32
    args = ssd_inputs("cuda", gen, b, s, h, p, g, n, torch.bfloat16)
    want = ssd.ssd_chunk_plain(*args, q)
    bound, by = ssd_bound_ms(b, s, h, p, g, n, q, torch.bfloat16)
    for hpb in SSD_HEADS_PER_BLOCK:
        err = ssd_error(ssd.ssd_chunk_call(*args, q, heads_per_block=hpb), want)
        ms = time_ms(lambda: ssd.ssd_chunk_call(*args, q, heads_per_block=hpb))
        print(f"[time] [{smi}] ssd_chunk {SSD_SHAPE}, torch.bfloat16, heads per block "
              f"{hpb or 'picked'}: {ms:.4f} ms, bound {bound:.4f} ms ({by}), {ms / bound:.1f}x "
              f"the bound; f32 outputs stored at {out_bytes / ms / 1e9:.3f} TB/s; max error "
              f"{err:.3g} of the largest magnitude")


def bind(path: pathlib.Path) -> ctypes.CDLL:
    """A library built from one source, its entry points bound as
    kernels/_build.py binds them."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_variants(source: str) -> dict[str, ctypes.CDLL]:
    """``source`` (quant.cu or pack.cu) built from an edited copy of csrc/
    per entry of CODEC_ABLATIONS on its kernels (under
    build/report/codec/), one nvcc each, all started together."""
    return build_edited(source, "codec", {
        name: edits for name, (kernels, edits) in CODEC_ABLATIONS.items()
        if KERNEL_SOURCE[kernels[0]] == source})


def build_edited(source: str, tag: str, variants: dict[str, list]) -> dict[str, ctypes.CDLL]:
    """``source`` built from an edited copy of csrc/ per entry of
    ``variants`` (name: [(file under csrc/, text, replacement)], each text
    present in the copy) under build/report/``tag``/, one nvcc each, all
    started together."""
    root = _build.BUILD_DIR.parent / "report" / tag
    shutil.rmtree(root, ignore_errors=True)
    cmds, paths = [], {}
    for i, (name, edits) in enumerate(variants.items()):
        copy = root / f"variant{i}"
        shutil.copytree(_build.CSRC, copy)
        for fname, old, new in edits:
            text = (copy / fname).read_text()
            if old not in text:
                raise RuntimeError(f"ablation {name!r}: {old!r} is not in {fname}")
            (copy / fname).write_text(text.replace(old, new))
        paths[name] = copy / f"lib{pathlib.Path(source).stem}.so"
        cmds.append([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
                     str(paths[name]), str(copy / source)])
    _build._run_all(cmds)
    return {name: bind(path) for name, path in paths.items()}


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as integers, so equal means bit for bit (these inputs
    hold no NaN)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def time_codec_shapes(smi: str) -> None:
    from chip_smoke import device_ms, mul_decode
    from repro_torch.core import compression
    from repro_torch.kernels import quant

    variants = build_variants("quant.cu")
    shipped = _build.library()
    stream = _build.stream_handle(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, n = quant.BLOCK, SEGMENT
    nb = n // B
    x = torch.empty(n, dtype=torch.bfloat16, device="cuda")
    for c0 in range(0, n, 1 << 28):
        c1 = min(n, c0 + (1 << 28))
        x[c0:c1] = torch.randn(c1 - c0, device="cuda", generator=gen) * 1e-3
    scale = compression._shared_scale(quant.amax_block_call(x), None)
    q = quant.quant_scaled_call(x, scale)
    q32 = q.to(torch.int32)
    kv = torch.randn(KV_LEAF, device="cuda", generator=gen).to(torch.bfloat16)
    qk, sk = quant.quant_int8_call(kv)
    nk = kv.numel()
    ssm = torch.randn(SSM_LEAF, device="cuda", generator=gen)
    qm, sm = quant.quant_int8_call(ssm)
    nm = ssm.numel()
    q_out = torch.empty_like(q)
    a_out = torch.empty(nb, dtype=torch.float32, device="cuda")
    seg_out = torch.empty(n, dtype=torch.bfloat16, device="cuda")
    kv_out = torch.empty(nk, dtype=torch.bfloat16, device="cuda")
    ssm_out = torch.empty(nm, dtype=torch.float32, device="cuda")

    def amax_block(lib, vector):
        return lambda: lib.amax_block_launch(x.data_ptr(), _build.BF16, n, a_out.data_ptr(), nb,
                                             vector, stream)

    def norm():
        return torch.linalg.vector_norm(x.view(nb, B), ord=float("inf"), dim=1,
                                        dtype=torch.float32)

    def quant_scaled(lib, vector):
        return lambda: lib.quant_scaled_launch(x.data_ptr(), _build.BF16, n, scale.data_ptr(),
                                               q_out.data_ptr(), nb, vector, stream)

    def decode(qq, ss, out):
        return lambda lib, vector: lambda: lib.dequant_int8_launch(
            qq.data_ptr(), quant._CODES[qq.dtype], ss.data_ptr(), out.numel(), out.data_ptr(),
            quant._CODES[out.dtype], vector, stream)

    # (what, bytes read and written once, launch(lib, vector), output, the
    # wrapper's output, the one-call library version or None, iterations)
    cases = [
        ("amax_block bf16, gradient segment", 2 * n + 4 * nb, amax_block, a_out,
         quant.amax_block_call(x), (norm(), norm), 10),
        ("quant_scaled bf16 -> int8, gradient segment", 2 * n + 4 * nb + n, quant_scaled,
         q_out, q, None, 10),
        ("dequant_int8 int32 -> bf16, gradient segment", 4 * n + 4 * nb + 2 * n,
         decode(q32, scale, seg_out), seg_out, quant.dequant_int8_call(q32, scale, n, torch.bfloat16),
         mul_decode(q32, scale, torch.bfloat16), 10),
        ("dequant_int8 int8 -> bf16, KV leaf", nk + 4 * (nk // B) + 2 * nk,
         decode(qk, sk, kv_out), kv_out, quant.dequant_int8_call(qk, sk, nk, torch.bfloat16),
         mul_decode(qk, sk, torch.bfloat16), 100),
        ("dequant_int8 int8 -> f32, mamba2-2.7b SSM state", nm + 4 * (nm // B) + 4 * nm,
         decode(qm, sm, ssm_out), ssm_out, quant.dequant_int8_call(qm, sm, nm, torch.float32),
         mul_decode(qm, sm, torch.float32), 20),
    ]

    def rate(nbytes, ms):
        return f"{ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s, {nbytes / PEAK_BYTES_PER_S * 1e3 / ms:.1%} of the bound)"

    for what, nbytes, launch, out, want, library, iters in cases:
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        line = [f"[time] [{smi}] {what}: bound {bound:.4f} ms (bytes)"]
        for label, vector in (("vector", 1), ("scalar (before the redesign)", 0), ("vector", 1)):
            fn = launch(shipped, vector)
            _build.check(fn(), what)
            torch.cuda.synchronize()
            if not torch.equal(as_bits(out), as_bits(want)):
                raise AssertionError(f"{what}, {label}: not bit-equal to the wrapper's output")
            line.append(f"{label} {rate(nbytes, time_ms(fn, iters))}")
        if iters > 10:
            line.append(f"device time vector {device_ms(launch(shipped, 1)):.4f} ms, scalar "
                        f"{device_ms(launch(shipped, 0)):.4f} ms")
        if library is not None:
            lib_out, call = library
            equal = torch.equal(as_bits(lib_out), as_bits(want))
            line.append(f"{'vector_norm' if what.startswith('amax') else 'torch.mul'} "
                        f"{time_ms(call, iters):.4f} ms (bit-equal: {equal})")
        print("; ".join(line))
        for name, lib in variants.items():
            if not what.startswith(CODEC_ABLATIONS[name][0]):
                continue
            fn = launch(lib, 1)
            _build.check(fn(), f"{what}, {name}")
            print(f"[ablation] [{smi}] {what}, {name}: {rate(nbytes, time_ms(fn, iters))}")


def build_baseline(checkout: pathlib.Path, source: str = "pack.cu") -> ctypes.CDLL:
    """csrc/``source`` of another checkout of the repository, built with
    this tree's flags into build/report/baseline/."""
    src = checkout / "src" / "repro_torch" / "csrc" / source
    out = _build.BUILD_DIR.parent / "report" / "baseline" / f"lib{src.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    _build._run_all([[_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                      str(src)]])
    return bind(out)


def time_pack_layout(smi: str, baseline: pathlib.Path | None) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core import collectives, packing
    from repro_torch.kernels import quant
    from repro_torch.models import Model

    variants = build_variants("pack.cu")
    libs = {"shipped": _build.library()}
    if baseline is not None:
        libs[f"baseline {baseline}"] = build_baseline(baseline)
    libs.update(variants)
    model = Model(get_config("qwen2.5-3b"), device="cuda").init(0)
    leaves = model.train_leaves()
    layout = collectives.comm_layout(leaves, collectives.CommConfig(compression="int8"),
                                     world=1)
    seg = layout.segments[0]
    pieces = packing.segment_pieces(layout, leaves)[seg.dtype]
    n, padded, nb = seg.used, seg.padded, seg.padded // quant.BLOCK
    table, _ = quant._span_table(pieces, padded, "fused_pack_quant")
    want_q, want_s = quant.fused_pack_quant_call(pieces, padded)
    q = torch.empty_like(want_q)
    s = torch.empty_like(want_s)
    stream = _build.stream_handle(torch.device("cuda"))
    nbytes = 2 * n + padded + 4 * nb             # read the leaves, write q and s
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"[time] [{smi}] fused_pack_quant, qwen2.5-3b gradient layout ({len(pieces)} "
          f"tensors, {table.shape[0]} table rows, {n} bf16 values in {nb} blocks): bound "
          f"{bound:.4f} ms (bytes)")
    for name, lib in [*libs.items(), ("shipped", libs["shipped"])]:
        def fn():
            return lib.fused_pack_quant_launch(table.data_ptr(), table.shape[0], nb,
                                               q.data_ptr(), s.data_ptr(), stream)
        _build.check(fn(), name)
        torch.cuda.synchronize()
        if not (torch.equal(q, want_q) and torch.equal(s, want_s)):
            raise AssertionError(f"fused_pack_quant, {name}: not bit-equal to the wrapper's")
        ms = time_ms(fn, 10)
        print(f"[{'time' if name == 'shipped' or name.startswith('baseline') else 'ablation'}] "
              f"[{smi}] fused_pack_quant, {name}: {ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s, "
              f"{bound / ms:.1%} of the bound)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default="flash_attention.cu",
                    choices=("flash_attention.cu", "ssd.cu", "quant.cu", "pack.cu"),
                    help="the source under src/repro_torch/csrc/ to inspect and time")
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help="with --source pack.cu, flash_attention.cu or ssd.cu: another "
                         "checkout of the repository whose kernel is timed beside this tree's")
    ap.add_argument("--inspect-only", action="store_true",
                    help="compile and inspect (steps 1-2), time nothing")
    ap.add_argument("--variants", nargs="?", const="all", choices=("all", "bf16", "f32"),
                    help="with flash_attention.cu: also build and time FLASH_VARIANTS (of "
                         "one dtype's kernel, or all); with ssd.cu: SSD_VARIANTS (f32)")
    args = ap.parse_args()
    source = _build.CSRC / args.source
    if not compile_and_inspect(source):
        print("flash_report: a wgmma kernel would not get the registers setmaxnreg asks "
              "for, or has no HGMMA or UTMALDG instruction, or a tf32x3 kernel (flash's or "
              "the SSD chunk's) spills or has no HMMA", file=sys.stderr)
        return 1
    if torch.cuda.is_available() and not args.inspect_only:
        smi = card()
        if source.stem == "ssd":
            time_ssd_shapes(smi, args.baseline, bool(args.variants))
            time_ssd_heads_per_block(smi)
        elif source.stem == "quant":
            time_codec_shapes(smi)
        elif source.stem == "pack":
            time_pack_layout(smi, args.baseline)
        else:
            time_flash_shapes(smi, args.baseline)
            if args.variants:
                time_flash_variants(smi, args.variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
