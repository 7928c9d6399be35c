#!/usr/bin/env python3
"""Resources, instructions and time of the port's hand-written kernels:
flash attention (the default), the Mamba2 SSD chunk, the int8 codec, or
the fused pack+quantize.

    python3 tools/flash_report.py                     # csrc/flash_attention.cu
    python3 tools/flash_report.py --source ssd.cu     # csrc/ssd.cu
    python3 tools/flash_report.py --source quant.cu   # csrc/quant.cu
    python3 tools/flash_report.py --source pack.cu [--baseline DIR]

1. Compiles the source (under src/repro_torch/csrc/) with the port's nvcc
   flags (sm_90a) plus ``-Xptxas -v`` and prints, per kernel
   instantiation, what ptxas reports: registers, stack, spill stores and
   loads.  The kernels' shared memory is dynamic; its bytes per block
   are printed beside them (for the SSD chunk at the mamba2-2.7b prefill
   shape).
2. Counts, in each kernel's SASS (``cuobjdump -sass`` of the same
   object), the HMMA (tensor-core) instructions of flash and SSD, or the
   codec's and the packing's global loads and stores by width (128, 64
   bits or narrower).
3. On a card, prints the card's name and power limit and times with CUDA
   events:
   - flash attention at the qwen2.5-3b prefill shape (B=4, H=16, K=2,
     S=1024, dh=128, causal) in bf16 and f32, beside
     ``F.scaled_dot_product_attention`` on the same inputs;
   - the SSD chunk at the mamba2-2.7b prefill shape (b=4, s=1024, h=80,
     p=64, g=1, n=128, q=128) in f32 and in bf16 at the heads per block
     the kernel picks and at 4, 8 and 16, each beside its bound and with
     the rate its f32 outputs are stored at;
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

Steps 1-2 need the CUDA toolkit, step 3 a card.
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
SSD_SHAPE = (4, 1024, 80, 64, 1, 128, 128)     # b, s, h, p, g, n, q
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
    m = re.search(r"((?:flash_attention|ssd_chunk|dequant_int8|quant_int8|quant_scaled|"
                  r"amax_block|pack_slots|fused_pack_quant)\w*)(?:<([^>]*)>)?", name)
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
    counts = collections.defaultdict(collections.Counter)
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            continue
        op = re.search(r"\b(HMMA|LDG|STG)(\.\S*)?", line)
        if fn is not None and op is not None:
            width = next((w for w in ("128", "64") if f".{w}" in (op.group(2) or "")), "narrower")
            counts[fn][op.group(1) if op.group(1) == "HMMA" else f"{op.group(1)}.{width}"] += 1
    names = demangle(sorted(set(ptxas) | set(counts)))
    for mangled in sorted(names, key=lambda n: short(names[n])):
        label = short(names[mangled])
        print(f"[ptxas] {label}: {'; '.join(ptxas.get(mangled, []))}{smem_note(label)}")
        if source.stem in ("quant", "pack"):
            c = counts[mangled]
            print(f"[sass] {label}: global loads by width " + ", ".join(
                f"{w} {c[f'LDG.{w}']}" for w in ("128", "64", "narrower")) + "; stores " + ", ".join(
                f"{w} {c[f'STG.{w}']}" for w in ("128", "64", "narrower")))
        else:
            print(f"[sass] {label}: {counts[mangled]['HMMA']} HMMA instructions")


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
    root = _build.BUILD_DIR.parent / "report" / "codec"
    shutil.rmtree(root, ignore_errors=True)
    cmds, paths = [], {}
    for i, (name, (kernels, edits)) in enumerate(CODEC_ABLATIONS.items()):
        if KERNEL_SOURCE[kernels[0]] != source:
            continue
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


def build_baseline(checkout: pathlib.Path) -> ctypes.CDLL:
    """csrc/pack.cu of another checkout of the repository, built with this
    tree's flags into build/report/baseline/."""
    src = checkout / "src" / "repro_torch" / "csrc" / "pack.cu"
    out = _build.BUILD_DIR.parent / "report" / "baseline" / "libpack.so"
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
                    help="with --source pack.cu: another checkout of the repository whose "
                         "fused_pack_quant is timed beside this tree's")
    args = ap.parse_args()
    source = _build.CSRC / args.source
    compile_and_inspect(source)
    if torch.cuda.is_available():
        smi = card()
        if source.stem == "ssd":
            time_ssd_prefill_shape(smi)
        elif source.stem == "quant":
            time_codec_shapes(smi)
        elif source.stem == "pack":
            time_pack_layout(smi, args.baseline)
        else:
            time_serving_shape(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
