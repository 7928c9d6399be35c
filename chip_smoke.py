"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch and CUDA
   versions, and the time the kernels took to build from csrc/.
2. Each CUDA kernel of the serving paths against its plain PyTorch
   version on the card, at the serving shapes: the int8 codec bit-equal
   (amax_block, quant_scaled and dequant_int8 also at ragged sizes and on
   views at every element offset 0-7, which take their scalar variant),
   flash attention within 3e-2 (bf16, on the tensor cores) and 2e-3 (f32,
   on the CUDA cores) at every head size it takes, the SSD chunk
   within 1e-4 of its plain output's largest magnitude (bf16 on the
   tensor cores, f32 on the CUDA cores; at the JAX suite's SSD shapes, at
   p = 100 / n = 16, also as column slices of one conv output, at the
   shapes that test the bf16 kernel's runs of heads, and at mamba2-2.7b's
   prefill shape in bf16 and f32).  Each kernel is timed with CUDA events beside
   its bound, its plain version and, for flash attention and dequant_int8,
   one PyTorch call computing the same function (timed only; the port
   never calls it; a codec's yardstick counts only if it is bit-equal to
   the kernel, NaN in the same places); flash attention and the SSD chunk
   in bf16 and f32 inputs; quant_int8 and dequant_int8 at the KV leaf
   also by their device time from torch.profiler, and dequant_int8 from
   int8 to f32 at mamba2-2.7b's SSM state.
3. Smoke-size models on the card against the same models on the CPU:
   qwen2.5-3b and mamba2-2.7b prefill and decode (f32, logits within 1e-3,
   equal tokens), and 3 qwen training steps for each gradient sync of
   TRAIN_RUNS (hier, hier_pipelined, hier_zero1, hier_overlap and fsdp
   with int8 on the pod hop, hier_border_rs with bf16) through the same
   process groups (gloo for the CPU, NCCL for the card), losses within
   1e-4, and parameters within 1e-4 for the syncs before hier_overlap;
   hier_overlap and fsdp are held instead to the CPU's sync on the card's
   own gradients, bit-equal, and hier_overlap's hook executor to its sync
   after the backward, bit-equal (int8 AdamW parameters are reported:
   one rounding apart moves a value by up to lr); hier_zero1's f32 master
   and moments are bootstrapped from the same parameters on each side.
4. The serving paths at full width, random weights from a seed: qwen2.5-3b
   (36 layers) and mamba2-2.7b (64 layers) each prefill 4 requests of
   1024 tokens, move the cache (KV, or conv + SSM state) raw and int8 on
   the wire, and decode 16 tokens greedily from each.  The launch counters,
   per phase, must show every kernel on each path: flash attention or
   ssd_chunk once per layer per prefill, quant/dequant twice per int8
   transfer, nothing per decode step, and every dequant_int8 launch in its
   vector variant.  Then, per model, a profile of one prefill and four
   decode steps.
5. The training paths at full width: ``repro_torch.launch.train.run``
   trains qwen2.5-3b on 4 x 1024 tokens for 4 steps in a world of one,
   through real pod and data groups of one member, once per gradient sync
   of TRAIN_RUNS.  Every step must launch pack_slots once for its one bf16
   gradient segment, amax_block, quant_scaled and dequant_int8 once per
   pod-hop chunk with int8 (hier, hier_zero1: 1, hier_pipelined: 4) and not
   with bf16; hier_overlap all four once per bucket of its partition_tree
   (38 for qwen2.5-3b under the 64 MiB cap), synced inside the backward;
   fsdp (nothing sharded over a data group of one) the codec once per
   leaf (14) and pack_slots once per per-layer leaf (12), which it syncs
   as its (L, ...) stack; and no flash attention, every amax_block, quant_scaled and
   dequant_int8 launch in its vector variant, with finite loss and grad
   norm and the finite gate open.  hier_zero1 quantizes the gradient
   segment cast to f32 and decodes it into f32 (the f32 master's shard);
   its bootstrap packs the parameters once, before the steps.  Each run's
   peak memory is printed beside the card's.
6. The shared-scale codec at the gradient segment's size (more than 2^31
   elements): bit-equal to the plain versions chunk by chunk, edge cases
   (ragged, all-zero block, scale <= 0, .5 ties, +-127 s, NaN and +-inf
   blocks and scales, for both int8 codecs) bit-equal, and
   amax / quant_scaled / the int32 -> bf16 decode timed beside their bounds
   and, for amax and the decode, one PyTorch call (vector_norm(ord=inf),
   torch.mul into a bf16 out), if bit-equal; then the same on hier_zero1's
   f32 segment: amax / quant_scaled on f32 input and the int32 -> f32
   decode, in their vector variant.
7. Slot packing on the qwen2.5-3b gradient layout (one bf16 segment of
   more than 2^31 values) and at small sizes (f32 and bf16 leaves, list
   leaves, ragged leaves, an all-zero block; for fused_pack_quant also
   trees with more than 32 spans in a block, null spans in mid-block,
   unaligned sources and a table of more than 1024 rows): pack_slots
   bit-equal to its plain version, fused_pack_quant bit-equal to its plain
   version and to pack -> quant_int8; then the conformance check of the
   reference
   (OK-F: fused pack+quantize equals the composition) as a path of its
   own at the full layout; each timed beside its bound, and pack_slots
   against torch.cat in PACK_ROUNDS interleaved rounds, each sample
   printed, the medians compared.
8. Where the time goes: one training step per gradient sync under
   torch.profiler, device time by kernel group and the device's idle
   share of the wall time (the serving profiles are part of phase 4);
   hier_zero1's bootstrap runs before the profiled window.  For
   hier_overlap, how many bucket syncs (device-side grad_sync spans)
   began before the backward's last kernel, and the device time from the
   first bucket's codec kernel to that kernel's end.  Then one
   optimizer update per sync timed apart, free of the profiler's
   attribution of kernels to ranges.

Any failed check raises, and the script exits non-zero without printing
its result line.  The last line is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import collectives, compression, overlap, packing  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.mesh import runtime_for_groups  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.serve import disaggregated  # noqa: E402
from repro_torch.serve.serve_step import make_serve_steps  # noqa: E402
from repro_torch.train import loss as loss_lib  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainConfig, make_train_step, zero_bootstrap)

# NVIDIA H100 SXM data sheet, dense rates without sparsity
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-3}

ARCH = "qwen2.5-3b"
SSM_ARCH = "mamba2-2.7b"
# the kernel each serving path launches once per layer per prefill
PATH_KERNEL = {ARCH: "flash_attention_bhsd", SSM_ARCH: "ssd_chunk"}
BATCH, PROMPT, GEN = 4, 1024, 16
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 4
# (gradient sync, pod-hop codec) of the training paths
TRAIN_RUNS = [("hier", "int8"), ("hier_pipelined", "int8"), ("hier_border_rs", "bf16"),
              ("hier_zero1", "int8"), ("hier_overlap", "int8"), ("fsdp", "int8")]
PACK_ROUNDS = 6       # interleaved rounds of pack_slots against torch.cat
# the syncs whose small-model check holds the sync itself bit-equal to the
# CPU's on the same gradients (check_sync_parity) in place of parameters
SYNC_PARITY_MODES = ("hier_overlap", "fsdp")


def grad_layout(cfg) -> dict[str, int]:
    """The gradient layout of ``cfg``'s parameters, from their shapes alone
    (drawn under FakeTensorMode, nothing allocated): hier_overlap's buckets
    under the default cap, the leaves, and the list leaves (per-layer
    parameters, each one stacked (L, ...) leaf)."""
    with FakeTensorMode():
        model = Model(cfg, device="cpu").init(0)
        leaves = model.train_leaves()
        buckets = overlap.partition_tree(model.param_tree(), TrainConfig().bucket_cap_mb << 20)
    return {"buckets": len(buckets), "leaves": len(leaves),
            "list_leaves": sum(isinstance(leaf, list) for leaf in leaves)}


def train_kernels(mode: str, codec: str | None, cfg) -> dict[str, int]:
    """Launches per training step of ``cfg``'s model in a world of one.
    The packed syncs pack one gradient segment and run the shared-scale
    codec once per pod-hop chunk; hier_overlap packs and codes each
    bucket; fsdp (nothing sharded in a world of one) syncs leaf by leaf,
    packing each list leaf into its stack."""
    layout = grad_layout(cfg)
    chunks = TrainConfig().n_chunks if mode == "hier_pipelined" else 1
    packs, syncs = 1, chunks
    if mode == "hier_overlap":
        packs = syncs = layout["buckets"]
    elif mode == "fsdp":
        packs, syncs = layout["list_leaves"], layout["leaves"]
    n = syncs if codec == "int8" else 0
    return {"pack_slots": packs, "amax_block": n, "quant_scaled": n, "dequant_int8": n,
            "quant_int8": 0, "fused_pack_quant": 0, "flash_attention_bhsd": 0,
            "ssd_chunk": 0}


def bootstrap_kernels(mode: str) -> dict[str, int]:
    """Launches before the steps: hier_zero1 packs the parameters once for
    its f32 master."""
    return {"pack_slots": 1} if mode == "hier_zero1" else {}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
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


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time per call of ``fn`` from torch.profiler: the time its
    kernels ran, without the host's pace.  The mean is taken over the
    kernels the profiler recorded (it may drop one now and then), times
    the kernels per call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0
           and not ev.is_user_annotation]
    count = sum(ev.count for ev in evs)
    check(count > 0, "the profiler recorded no kernel")
    per_call = max(1, round(count / iters))
    return sum(ev.self_device_time_total for ev in evs) / count * per_call / 1e3


def rate_tbs(row: dict) -> float:
    """The bytes of a bytes-bound row's bound moved in its measured time, TB/s."""
    return PEAK_BYTES_PER_S * row["bound_ms"] / row["ms"] / 1e12


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN (of any payload) in the same places."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = a.isnan()
    return bool(torch.equal(nan, b.isnan())
                and torch.equal(a.view(_INT_VIEW[a.dtype])[~nan],
                                b.view(_INT_VIEW[b.dtype])[~nan]))


def mul_decode(q: torch.Tensor, s: torch.Tensor, dtype) -> tuple:
    """dequant_int8's one-call library version for a whole-block payload:
    torch.mul(q, s) rounded into a ``dtype`` out; returns (out, the call)."""
    nb = q.shape[0]
    out = torch.empty(q.shape, dtype=dtype, device=q.device)

    def call():
        torch.mul(q, s.view(nb, 1), out=out)
    call()
    return out.view(-1), call


def yardstick(fn, bit_equal: bool, what: str, iters: int) -> float | None:
    """``fn``'s time if it is bit-equal to the kernel (else None, said)."""
    if not bit_equal:
        print(f"[time] {what}: not bit-equal to the kernel, so no yardstick")
        return None
    return time_ms(fn, iters)


def check_library_nan(dev) -> dict[str, bool]:
    """Whether the one-call library versions of amax_block and dequant_int8
    agree with the kernels bit for bit on blocks holding NaN, +-inf and
    +-0 (values, and scales for the decode)."""
    nan, inf = float("nan"), float("inf")
    x = torch.randn(4 * 1024, device=dev)
    x[5], x[1024 + 7], x[2048 + 9], x[3072 + 1], x[3072 + 2] = nan, inf, -inf, nan, -0.0
    agree = {}
    xb = x.to(torch.bfloat16)
    lib = torch.linalg.vector_norm(xb.view(4, 1024), ord=inf, dim=1, dtype=torch.float32)
    agree["amax_block"] = bits_equal(lib, quant.amax_block_call(xb))
    s = torch.tensor([0.5, nan, inf, -0.25], device=dev)
    ok = True
    for qdt in (torch.int8, torch.int32):
        q = torch.randint(-127, 128, (4, 1024), device=dev).to(qdt)
        q[:, :3] = 0
        for dt in (torch.bfloat16, torch.float32):
            ok &= bits_equal(mul_decode(q, s, dt)[0], quant.dequant_int8_call(q, s, 4096, dt))
    agree["dequant_int8"] = ok
    print(f"[check] one-call library versions bit-equal to the kernels with NaN, +-inf, "
          f"+-0: {agree}")
    return agree


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def check_codec(dev, gen, agree: dict[str, bool]) -> dict:
    cfg = get_config(ARCH)
    leaf = (cfg.n_layers, BATCH, PROMPT, cfg.n_kv_heads, cfg.head_dim)
    x = torch.randn(leaf, device=dev, generator=gen).to(torch.bfloat16)
    ragged = torch.randn(37 * 1024 + 5, device=dev, generator=gen) * 50
    ragged[1024:2048] = 0                                   # an all-zero block
    cases = [("kv leaf bf16", x), ("ragged f32 with a zero block", ragged),
             ("ragged bf16", ragged.to(torch.bfloat16))]
    for name, t in cases:
        q, s = quant.quant_int8_call(t)
        pq, ps = quant.quant_int8_plain(t)
        check(torch.equal(q, pq) and torch.equal(s, ps), f"quant_int8 {name}")
        for qq, gain, label in ((q, None, "int8"), (q.int() * 5, 0.125, "int32+gain")):
            got = quant.dequant_int8_call(qq, s, t.numel(), t.dtype, gain)
            want = quant.dequant_int8_plain(qq, s, t.numel(), t.dtype, gain)
            check(torch.equal(got, want), f"dequant_int8 {name} {label}")
        print(f"[check] quant/dequant {name} ({t.numel()} elements): bit-equal")
    check(bool((quant.quant_int8_call(ragged)[1][1] == 1.0).item()),
          "all-zero block scale")

    n = x.numel()
    q, s = quant.quant_int8_call(x)
    nb = q.shape[0]
    check(n == nb * 1024, f"the KV leaf {n} is not whole blocks")
    lib_out, lib_call = mul_decode(q, s, torch.bfloat16)
    lib_equal = agree["dequant_int8"] and torch.equal(
        lib_out, quant.dequant_int8_call(q, s, n, torch.bfloat16))
    iters = 50
    quant_row = {
        "name": "quant_int8", "route": "cuda", "source": "src/repro_torch/csrc/quant.cu",
        "replaces": "src/repro/kernels/quant.py:72",
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: quant.quant_int8_call(x), iters),
        "device_ms": device_ms(lambda: quant.quant_int8_call(x)),
        "plain_ms": time_ms(lambda: quant.quant_int8_plain(x), iters // 5),
        # read the bf16 leaf once, write q and s once
        "bound_ms": (2 * n + nb * 1024 + 4 * nb) / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
    }
    dequant_row = {
        "name": "dequant_int8", "route": "cuda", "source": "src/repro_torch/csrc/quant.cu",
        "replaces": "src/repro/kernels/quant.py:172",
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: quant.dequant_int8_call(q, s, n, torch.bfloat16), iters),
        "device_ms": device_ms(lambda: quant.dequant_int8_call(q, s, n, torch.bfloat16)),
        "plain_ms": time_ms(lambda: quant.dequant_int8_plain(q, s, n, torch.bfloat16),
                            iters // 5),
        "bound_ms": (nb * 1024 + 4 * nb + 2 * n) / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": yardstick(lib_call, lib_equal, "torch.mul int8 -> bf16", iters),
        "library_device_ms": device_ms(lib_call) if lib_equal else None,
    }
    del lib_out, lib_call
    # the decode of mamba2-2.7b's f32 SSM state, int8 -> f32
    scfg = get_config(SSM_ARCH)
    ssm = torch.randn(scfg.n_layers, BATCH, scfg.d_inner // scfg.ssm_head_dim,
                      scfg.ssm_head_dim, scfg.ssm_state, device=dev, generator=gen)
    q, s = quant.quant_int8_call(ssm)
    n, nb = ssm.numel(), q.shape[0]
    check(n == nb * 1024, f"the SSM state {n} is not whole blocks")
    out = quant.dequant_int8_call(q, s, n, torch.float32)
    check(torch.equal(out, quant.dequant_int8_plain(q, s, n, torch.float32)),
          "dequant_int8 int8 -> f32 at the SSM state")
    lib_out, lib_call = mul_decode(q, s, torch.float32)
    lib_equal = agree["dequant_int8"] and torch.equal(lib_out, out)
    dequant_row["ssm_state_f32"] = {
        "ms": time_ms(lambda: quant.dequant_int8_call(q, s, n, torch.float32), iters // 5),
        "device_ms": device_ms(lambda: quant.dequant_int8_call(q, s, n, torch.float32)),
        "plain_ms": time_ms(lambda: quant.dequant_int8_plain(q, s, n, torch.float32), 5),
        # read the int8 blocks and the scales, write the f32 values
        "bound_ms": (nb * 1024 + 4 * nb + 4 * n) / PEAK_BYTES_PER_S * 1e3,
        "library_ms": yardstick(lib_call, lib_equal, "torch.mul int8 -> f32", iters // 5)}
    return {"quant_int8": quant_row, "dequant_int8": dequant_row}


# ragged sizes around the 1024-value block and the 8192-value tile, and one
# of more tiles than the vector kernels' grid has CTAs (the grid stride)
VIEW_SIZES = [1, 7, 1023, 1024, 1025, 8191, 3 * 1024 + 13, 12 * 2 ** 20 + 333]


def _at_offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """``t``'s values as a view ``off`` elements into a new buffer."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    check(buf.data_ptr() % quant.VECTOR_ALIGN == 0, "buffer alignment")
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def check_codec_views(dev, gen) -> None:
    """amax_block, quant_scaled and dequant_int8 at ragged sizes and on
    views at every element offset 0-7, bit-equal to their plain versions,
    with NaN and +-inf values and 0, NaN, inf and negative scales; each
    launch takes the variant its base's alignment calls for."""
    nan, inf = float("nan"), float("inf")
    n_vector = n_scalar = 0
    for n in VIEW_SIZES:
        nb = -(-n // 1024)
        scale = torch.rand(nb, device=dev, generator=gen) * 0.05 + 1e-3
        scale[::5], scale[1::7], scale[2::11], scale[3::13] = 0.0, nan, inf, -1.0
        xs = torch.randn(n, device=dev, generator=gen) * 3
        xs[::997], xs[1::1499], xs[2::1789] = nan, inf, -inf
        # NaN and +-inf in a few blocks only, so most block maxima stay finite
        xa = torch.randn(n, device=dev, generator=gen) * 3
        i = torch.arange(n, device=dev)
        xa[i % 5003 == 17], xa[i % 7919 == 100], xa[i % 6007 == 2000] = nan, inf, -inf
        qs = {torch.int8: torch.randint(-127, 128, (nb, 1024), device=dev, generator=gen),
              torch.int32: torch.randint(-1016, 1017, (nb, 1024), device=dev, generator=gen)}
        for off in range(8):
            for dt in (torch.float32, torch.bfloat16):
                xv = _at_offset(xs.to(dt), off)
                vector = off * xv.element_size() % 16 == 0
                fn = quant.quant_scaled_call
                before = fn.launches, fn.vector_launches
                check(torch.equal(fn(xv, scale), quant.quant_scaled_plain(xv, scale)),
                      f"quant_scaled n={n} offset {off} {dt}")
                check((fn.launches, fn.vector_launches) == (before[0] + 1, before[1] + vector),
                      f"quant_scaled n={n} offset {off} {dt}: variant")
                n_vector, n_scalar = n_vector + vector, n_scalar + (not vector)
                xv = _at_offset(xa.to(dt), off)
                fn = quant.amax_block_call
                before = fn.launches, fn.vector_launches
                check(bits_equal(fn(xv), quant.amax_block_plain(xv)),
                      f"amax_block n={n} offset {off} {dt}")
                check((fn.launches, fn.vector_launches) == (before[0] + 1, before[1] + vector),
                      f"amax_block n={n} offset {off} {dt}: variant")
                n_vector, n_scalar = n_vector + vector, n_scalar + (not vector)
            for qdt, q in qs.items():
                qv = _at_offset(q.to(qdt), off)
                vector = off * qv.element_size() % 16 == 0
                for dt in (torch.float32, torch.bfloat16):
                    for gain in (None, 0.37):
                        fn = quant.dequant_int8_call
                        before = fn.launches, fn.vector_launches
                        check(bits_equal(fn(qv, scale, n, dt, gain),
                                         quant.dequant_int8_plain(qv, scale, n, dt, gain)),
                              f"dequant_int8 n={n} offset {off} {qdt} -> {dt} gain {gain}")
                        check((fn.launches, fn.vector_launches)
                              == (before[0] + 1, before[1] + vector),
                              f"dequant_int8 n={n} offset {off} {qdt}: variant")
                        n_vector, n_scalar = n_vector + vector, n_scalar + (not vector)
    print(f"[check] amax_block, quant_scaled and dequant_int8 at sizes {VIEW_SIZES} on views "
          f"at offsets 0-7 (f32/bf16 in; int8/int32 -> f32/bf16 out, gain or none; NaN, +-inf "
          f"values, "
          f"0/NaN/inf/negative scales): bit-equal; {n_vector} launches took the vector "
          f"variant and {n_scalar} the scalar one, as the bases' alignment calls for")


FLASH_CASES = [
    # (B, H, K, Sq, Skv, dh, causal, window, q_offset, valid_kv, dtype)
    (BATCH, 16, 2, PROMPT, PROMPT, 128, True, None, 0, None, torch.bfloat16),
    (BATCH, 16, 2, PROMPT, PROMPT, 128, True, None, 0, None, torch.float32),
    (2, 8, 2, 130, 130, 128, True, 64, 0, None, torch.float32),
    (2, 16, 2, 128, 512, 128, True, None, 300, 420, torch.bfloat16),
    (2, 8, 2, 256, 256, 64, True, None, 0, None, torch.bfloat16),
    (1, 4, 1, 192, 192, 80, False, None, 0, None, torch.float32),
    # bf16 on the tensor cores at the other head sizes, ragged lengths off
    # the 64-row and 64-key tiles, a window, H/K = 8
    (2, 8, 1, 130, 200, 16, True, None, 70, 190, torch.bfloat16),
    (2, 8, 2, 130, 130, 64, True, 64, 0, None, torch.bfloat16),
    (1, 4, 1, 192, 192, 80, False, None, 0, None, torch.bfloat16),
    (2, 16, 2, 200, 200, 128, True, 100, 0, None, torch.bfloat16),
]


def flash_bound_ms(B, H, K, Sq, dh, q_offset, valid_kv, causal,
                   dtype) -> tuple[float, str]:
    """Least time for the work these inputs need: 4 flops per (q, k) pair
    and head dim over the unmasked pairs, against reading q, k, v and
    writing o once."""
    pairs = sum(min(valid_kv, q_offset + i + 1) if causal else valid_kv
                for i in range(Sq))
    flops = 4.0 * B * H * dh * pairs
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * B * dh * (2 * H * Sq + 2 * K * valid_kv)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_flash(dev, gen, smi: str) -> dict:
    main = {}
    for B, H, K, Sq, Skv, dh, causal, window, off, valid, dt in FLASH_CASES:
        q = torch.randn(B, H, Sq, dh, device=dev, generator=gen).to(dt)
        k = torch.randn(B, K, Skv, dh, device=dev, generator=gen).to(dt)
        v = torch.randn(B, K, Skv, dh, device=dev, generator=gen).to(dt)
        kw = dict(causal=causal, window=window, q_offset=off, valid_kv=valid)
        got = fa.flash_attention_bhsd(q, k, v, **kw)
        want = fa.flash_attention_bhsd_plain(q, k, v, **kw)
        err = (got.float() - want.float()).abs().max().item()
        check(err <= TOL[dt], f"flash {B, H, K, Sq, Skv, dh, kw, dt}: err {err}")
        print(f"[check] flash B={B} H={H} K={K} Sq={Sq} Skv={Skv} dh={dh} "
              f"{kw} {dt}: max abs err {err:.3g} (tol {TOL[dt]})")
        if Sq == PROMPT:
            main[dt] = err, (q, k, v)
    timing = {}
    for dt, (err, (q, k, v)) in main.items():
        bound, by = flash_bound_ms(BATCH, 16, 2, PROMPT, 128, 0, PROMPT, True, dt)
        timing[dt] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: fa.flash_attention_bhsd(q, k, v, causal=True), 20),
            "plain_ms": time_ms(lambda: fa.flash_attention_bhsd_plain(q, k, v, causal=True),
                                5),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 20)}
        t = timing[dt]
        print(f"[time] [{smi}] flash_attention_bhsd qwen2.5-3b prefill shape, {dt}: "
              f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({by}), plain "
              f"{t['plain_ms']:.4f} ms, F.scaled_dot_product_attention "
              f"{t['library_ms']:.4f} ms")
    return {"flash_attention_bhsd": {
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        **timing[torch.bfloat16], "f32": timing[torch.float32]}}


SSD_CASES = [
    # (b, s, h, p, g, n, chunk, dtype, view): tests/test_kernels.py:46-52,
    # G = 2 with H = 8 (h // (H / G) is not h % G), p = 100 and n = 16 (a
    # shape check), the bf16 cases the tensor-core kernel's grid has to get
    # right (6 heads over 2 groups: runs of heads that do not divide the
    # group; G = 2, H = 8; q = 96; p = 100 and n = 16 as column slices of one
    # conv output, rows 8-byte aligned only), then the mamba2-2.7b prefill
    (2, 256, 4, 32, 1, 64, 64, torch.float32, False),
    (1, 128, 2, 64, 2, 32, 32, torch.float32, False),
    (1, 128, 8, 32, 2, 32, 32, torch.float32, False),
    (1, 256, 8, 64, 1, 128, 128, torch.float32, False),
    (2, 128, 4, 32, 1, 64, 64, torch.bfloat16, False),
    (2, 256, 4, 100, 1, 16, 128, torch.bfloat16, False),
    (1, 256, 6, 64, 2, 64, 64, torch.bfloat16, False),
    (1, 128, 8, 32, 2, 32, 32, torch.bfloat16, False),
    (1, 192, 4, 64, 1, 64, 96, torch.bfloat16, False),
    (2, 256, 4, 100, 1, 16, 128, torch.bfloat16, True),
    (BATCH, PROMPT, 80, 64, 1, 128, 128, torch.bfloat16, False),
    (BATCH, PROMPT, 80, 64, 1, 128, 128, torch.float32, False),
]
SSD_TOL = 1e-4      # of the plain output's largest magnitude


def ssd_inputs(dev, gen, b, s, h, p, g, n, dt, view=False):
    """x, dt, A, B, C; with ``view``, x, B and C are column slices of one
    (b, s, h p + 2 g n) tensor, as the model hands over its conv output."""
    if view:
        conv = torch.randn(b, s, h * p + 2 * g * n, device=dev, generator=gen).to(dt)
        x = conv[..., :h * p].unflatten(-1, (h, p))
        Bm = conv[..., h * p:h * p + g * n].unflatten(-1, (g, n))
        Cm = conv[..., h * p + g * n:].unflatten(-1, (g, n))
    else:
        x = torch.randn(b, s, h, p, device=dev, generator=gen).to(dt)
        Bm = Cm = None
    dtv = torch.rand(b, s, h, device=dev, generator=gen) * 0.19 + 0.01
    A = -(torch.rand(h, device=dev, generator=gen) * 3.5 + 0.5)
    if not view:
        Bm = torch.randn(b, s, g, n, device=dev, generator=gen).to(dt)
        Cm = torch.randn(b, s, g, n, device=dev, generator=gen).to(dt)
    return x, dtv, A, Bm, Cm


def ssd_bound_ms(b, s, h, p, g, n, q, dt) -> tuple[float, str]:
    """x, dt, A, B and C read once, y_diag and states written once in f32,
    against the products the function needs at the peak rate of the input
    type: C B^T once per (b, chunk, group) and scores x once per head,
    each over the causal half (j <= i), and x^T (B w) once per head."""
    elem = torch.finfo(dt).bits // 8
    nc = s // q
    nbytes = (elem * b * s * (h * p + 2 * g * n) + 4 * b * s * h + 4 * h
              + 4 * b * s * h * p + 4 * b * nc * h * p * n)
    pairs = q * (q + 1) // 2
    flops = 2.0 * b * nc * (g * pairs * n + h * (pairs * p + q * p * n))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dt]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def check_ssd(dev, gen, smi: str) -> dict:
    row = {}
    for b, s, h, p, g, n, q, dt, view in SSD_CASES:
        args = ssd_inputs(dev, gen, b, s, h, p, g, n, dt, view)
        got = ssd.ssd_chunk_call(*args, q)
        want = ssd.ssd_chunk_plain(*args, q)
        errs = [(a - w).abs().max().item() for a, w in zip(got, want)]
        mags = [w.abs().max().item() for w in want]
        for what, err, mag in zip(("y_diag", "states"), errs, mags):
            check(err <= SSD_TOL * mag, f"ssd_chunk {b, s, h, p, g, n, q, dt} {what}: "
                                        f"err {err} against |max| {mag}")
        print(f"[check] ssd_chunk (b, s, h, p, g, n) = {(b, s, h, p, g, n)}, q {q}, {dt}"
              f"{', conv slices' if view else ''}: "
              f"max abs err y_diag {errs[0]:.3g} (|y| <= {mags[0]:.3g}), states "
              f"{errs[1]:.3g} (<= {mags[1]:.3g}); tol {SSD_TOL} of the largest")
        if s != PROMPT:
            continue
        timing = {"max_abs_err": max(errs),
                  "ms": time_ms(lambda: ssd.ssd_chunk_call(*args, q), 20),
                  "plain_ms": time_ms(lambda: ssd.ssd_chunk_plain(*args, q), 5)}
        timing["bound_ms"], timing["bound_by"] = ssd_bound_ms(b, s, h, p, g, n, q, dt)
        print(f"[time] [{smi}] ssd_chunk mamba2-2.7b prefill shape, {dt}: "
              f"{timing['ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
              f"({timing['bound_by']}), plain {timing['plain_ms']:.4f} ms")
        if dt == torch.bfloat16:
            row = {"name": "ssd_chunk", "route": "cuda", "source": "src/repro_torch/csrc/ssd.cu",
                   "replaces": "src/repro/kernels/ssd.py:59", **timing,
                   "library_ms": None}       # no one PyTorch call computes it
        else:
            row["f32"] = timing
    return {"ssd_chunk": row}


# ---------------------------------------------------------------------------
# 3. a small model on the card against the CPU
# ---------------------------------------------------------------------------

def check_small_model(dev, arch: str) -> None:
    """Prefill + 4 decode steps of the f32 smoke model; the path's kernel
    launches once per layer in the prefill and never in decode."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    cpu = Model(cfg, device="cpu").init(0)
    gpu = copy.deepcopy(cpu).to(dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 130),
                         generator=torch.Generator().manual_seed(0))
    kernel = PATH_KERNEL[arch]
    before = ops.launch_counts()[kernel]
    lc, cc = cpu.apply_prefill(toks, max_len=136)
    lg, cg = gpu.apply_prefill(toks.to(dev), max_len=136)
    check(ops.launch_counts()[kernel] == before + cfg.n_layers, f"small {kernel} launches")
    err = (lg.cpu() - lc).abs().max().item()
    check(err < 1e-3, f"small prefill logits differ by {err}")
    tok = lc.argmax(-1)
    check(torch.equal(lg.argmax(-1).cpu(), tok), "small prefill tokens")
    for _ in range(4):
        lc, cc = cpu.apply_decode(tok, cc)
        lg, cg = gpu.apply_decode(tok.to(dev), cg)
        err = max(err, (lg.cpu() - lc).abs().max().item())
        check(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)), "small decode tokens")
        tok = lc.argmax(-1)
    check(err < 1e-3, f"small decode logits differ by {err}")
    check(ops.launch_counts()[kernel] == before + cfg.n_layers, f"decode launched {kernel}")
    print(f"[check] {cfg.name} f32 on the card vs the CPU: prefill + 4 decode "
          f"steps, max logit diff {err:.3g}, greedy tokens equal, {kernel} "
          f"launched {cfg.n_layers} times (prefill only)")


def check_small_training(dev, rt, mode: str, codec: str | None) -> None:
    """3 steps of a smoke f32 model on the card and on the CPU, from the
    same parameters and batches, through the same groups."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32)
    cpu = Model(cfg, rt, device="cpu").init(0)
    gpu = copy.deepcopy(cpu, {id(rt): rt}).to(dev)
    tcfg = TrainConfig(comm_mode=mode, dcn_compression=codec,
                       opt=opt_lib.OptConfig(lr=1e-3, warmup_steps=1))
    want = train_kernels(mode, codec, cfg)
    runs = []
    for model in (cpu, gpu):
        step_fn, _ = make_train_step(model, tcfg)
        if mode == "hier_zero1":
            opt = zero_bootstrap(model, tcfg)
        else:
            opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
        dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=64)
        losses = []
        for i in range(3):
            b = {k: torch.from_numpy(v).long().to(model.device)
                 for k, v in synth_batch(dcfg, i).items()}
            before = ops.launch_counts()
            m = step_fn(opt, b)
            after = ops.launch_counts()
            if model is gpu:
                launched = {k: after[k] - before[k] for k in want}
                check(launched == want, f"small training {mode} launches {launched}")
            check(not m["gated"], "small training: finite gate tripped")
            losses.append(m["loss"])
        runs.append(losses)
    err = max(abs(a - b) / abs(b) for a, b in zip(runs[1], runs[0]))
    check(err < 1e-4, f"small training losses {runs}")
    perr = max((torch.stack(g) if isinstance(g, list) else g).cpu().sub(
        torch.stack(c) if isinstance(c, list) else c).abs().max().item()
        for g, c in zip(gpu.train_leaves(), cpu.train_leaves()))
    if mode in SYNC_PARITY_MODES:
        held = check_sync_parity(gpu, rt, mode, codec)
        params = f"max param diff {perr:.3g} (reported; {held})"
    else:
        check(perr < 1e-4, f"small training params differ by {perr}")
        params = f"max param diff {perr:.3g} (tol 1e-4)"
    print(f"[check] {cfg.name} f32 training, {mode} + {codec}, 3 steps on the card vs "
          f"the CPU: losses {[f'{l:.6f}' for l in runs[1]]}, max relative loss diff "
          f"{err:.3g} (tol 1e-4), {params}, launches per step {want}")


def check_sync_parity(gpu, rt, mode: str, codec: str | None) -> str:
    """A new gradient sync on the card against the same sync on the CPU,
    on the same gradients: one batch's raw gradients of the card model,
    synced on the card and, copied, on the CPU, bit-equal.  For
    hier_overlap also the hook executor inside the card's backward
    against the sync after it, bit-equal.  (Parameters after three int8
    AdamW steps are reported, not held: Adam turns one int8 rounding that
    the card's and the CPU's gradients take apart into a step of up to
    lr on that value.)"""
    cfg = gpu.cfg
    ccfg = TrainConfig(comm_mode=mode, dcn_compression=codec).comm_config(rt)
    leaves = gpu.train_leaves()
    params, _ = opt_lib.flat_params(leaves)
    b = {k: torch.from_numpy(v).long().to(gpu.device) for k, v in synth_batch(
        DataConfig(vocab_size=cfg.vocab_size, global_batch=2, seq_len=64), 7).items()}

    def backward():
        with torch.enable_grad():
            lval, _ = loss_lib.sharded_xent(gpu.apply_train(b["tokens"]), b["labels"], rt,
                                            cfg.vocab_size)
            return torch.autograd.grad(lval, params)

    for p in params:
        p.requires_grad_(True)
    raw = backward()
    card, host = [g.clone() for g in raw], [g.cpu() for g in raw]
    if mode == "hier_overlap":
        tree = gpu.param_tree()
        for grads in (card, host):
            by_id = dict(zip(map(id, params), grads))
            overlap.tree_hier_psum_overlap(_map_tree(tree, lambda t: by_id[id(t)]), ccfg)
        sync = overlap.BucketSync(tree, ccfg)
        with sync.attached():
            inside = backward()
        check(all(bits_equal(a, c) for a, c in zip(inside, card)),
              "hier_overlap: the hook executor differs from the sync after the backward")
        synced = (card, host)
    else:
        synced = []
        for grads in (card, host):
            it = iter(grads)
            synced.append([train_step.fsdp_sync([next(it) for _ in leaf]
                                                if isinstance(leaf, list) else next(it),
                                                False, ccfg, rt) for leaf in leaves])
    check(all(bits_equal(a.cpu(), c) for a, c in zip(*synced)),
          f"{mode}: the card's sync differs from the CPU's on the same gradients")
    return ("sync bit-equal to the CPU's on the card's gradients"
            + (", hook executor bit-equal to the sync after the backward"
               if mode == "hier_overlap" else ""))


def _map_tree(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, list):
        return [_map_tree(t, fn) for t in tree]
    return {k: _map_tree(v, fn) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# 6. the shared-scale codec at the gradient segment's size
# ---------------------------------------------------------------------------

def _chunks(n: int, step: int = 1 << 28):
    for c0 in range(0, n, step):
        yield c0, min(n, c0 + step)


def check_shared_codec(dev, gen, n: int, agree: dict[str, bool]) -> tuple[dict, dict]:
    """Edge cases at small sizes, then one buffer of ``n`` > 2^31 bf16
    values (the gradient segment) compared chunk by chunk with the plain
    versions, and timed.  Returns the rows of rows 4-5 and the int32
    decode's numbers."""
    B = quant.BLOCK
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn(37 * B + 5, device=dev, generator=gen) * 50).to(dt)
        x[B:2 * B] = 0                                       # an all-zero block
        a = quant.amax_block_call(x)
        check(torch.equal(a, quant.amax_block_plain(x)), f"amax_block {dt}")
        scale = a / 127
        scale[3], scale[4] = 0.0, -1.0                       # s <= 0 divides as 1
        q = quant.quant_scaled_call(x, scale)
        check(torch.equal(q, quant.quant_scaled_plain(x, scale)), f"quant_scaled {dt}")
    k = torch.arange(4 * B, device=dev) % 300 - 150
    x = (k + 0.5) * 0.25                                     # exact .5 ties
    x[2 * B:] = torch.where(k[2 * B:] % 2 == 0, 127 * 0.25, -200 * 0.25)
    scale = torch.full((4,), 0.25, device=dev)
    q = quant.quant_scaled_call(x, scale)
    check(torch.equal(q, quant.quant_scaled_plain(x, scale)), "quant_scaled ties")
    check(bool(q[2:].abs().eq(127).all()), "quant_scaled clipping at +-127")
    nan, inf = float("nan"), float("inf")
    x = torch.randn(4 * B + 9, device=dev, generator=gen)
    x[5], x[B + 7], x[2 * B + 9], x[3 * B + 1], x[3 * B + 2] = nan, inf, -inf, nan, inf
    for dt in (torch.float32, torch.bfloat16):
        xt = x.to(dt)
        a = quant.amax_block_call(xt)
        check(bits_equal(a, quant.amax_block_plain(xt)), f"amax_block NaN/inf {dt}")
        check(bool(a[[0, 3]].isnan().all() and a[[1, 2]].isinf().all()),
              f"amax_block propagates NaN {dt}")
        for scale in (a / 127, torch.tensor([1.0, inf, 0.5, nan, 2.0], device=dev)):
            check(torch.equal(quant.quant_scaled_call(xt, scale),
                              quant.quant_scaled_plain(xt, scale)),
                  f"quant_scaled NaN/inf {dt}")
        q, s = quant.quant_int8_call(xt)
        pq, ps = quant.quant_int8_plain(xt)
        check(torch.equal(q, pq) and bits_equal(s, ps), f"quant_int8 NaN/inf {dt}")
    print("[check] amax_block / quant_scaled, f32 and bf16, ragged with an all-zero "
          "block, scales <= 0, .5 ties, +-127 s, NaN and +-inf blocks and scales "
          "(quant_int8 too): bit-equal, NaN in the same places")

    check(n > 2 ** 31, f"gradient segment {n} is not above 2^31")
    x = torch.empty(n, dtype=torch.bfloat16, device=dev)
    for c0, c1 in _chunks(n):
        x[c0:c1] = torch.randn(c1 - c0, device=dev, generator=gen) * 1e-3
    x[B:2 * B] = 0
    nb = n // B
    check(n == nb * B, f"the gradient segment {n} is not whole blocks")
    before = quant.amax_block_call.vector_launches, quant.quant_scaled_call.vector_launches
    a = quant.amax_block_call(x)
    scale = compression._shared_scale(a.clone(), None)
    q = quant.quant_scaled_call(x, scale)
    check((quant.amax_block_call.vector_launches, quant.quant_scaled_call.vector_launches)
          == (before[0] + 1, before[1] + 1), "amax_block, quant_scaled: vector variant")
    for c0, c1 in _chunks(n):
        b0, b1 = c0 // B, -(-c1 // B)
        check(torch.equal(a[b0:b1], quant.amax_block_plain(x[c0:c1])),
              f"amax_block at [{c0}, {c1})")
        check(torch.equal(q[b0:b1], quant.quant_scaled_plain(x[c0:c1], scale[b0:b1])),
              f"quant_scaled at [{c0}, {c1})")

    def norm():
        return torch.linalg.vector_norm(x.view(nb, B), ord=float("inf"), dim=1,
                                        dtype=torch.float32)
    amax_equal = agree["amax_block"] and torch.equal(norm(), a)
    rows = {
        "amax_block": {
            "name": "amax_block", "route": "cuda", "source": "src/repro_torch/csrc/quant.cu",
            "replaces": "src/repro/kernels/quant.py:90", "max_abs_err": 0.0,
            "ms": time_ms(lambda: quant.amax_block_call(x), 10),
            "plain_ms": time_ms(lambda: quant.amax_block_plain(x), 1, warmup=1),
            # read the bf16 segment once, write nb floats
            "bound_ms": (2 * n + 4 * nb) / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": yardstick(norm, amax_equal, "vector_norm(ord=inf)", 10)},
        "quant_scaled": {
            "name": "quant_scaled", "route": "cuda", "source": "src/repro_torch/csrc/quant.cu",
            "replaces": "src/repro/kernels/quant.py:107", "max_abs_err": 0.0,
            "ms": time_ms(lambda: quant.quant_scaled_call(x, scale), 10),
            "plain_ms": time_ms(lambda: quant.quant_scaled_plain(x, scale), 1, warmup=1),
            # read the segment and the scales once, write the int8 blocks
            "bound_ms": (2 * n + 4 * nb + nb * B) / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None},
    }
    del x
    free_memory()
    q32 = q.to(torch.int32)                    # the int32 ring sum of a pod of one
    del q
    free_memory()
    before = quant.dequant_int8_call.vector_launches
    out = quant.dequant_int8_call(q32, scale, n, torch.bfloat16)
    check(quant.dequant_int8_call.vector_launches == before + 1, "dequant_int8: vector variant")
    for c0, c1 in _chunks(n):
        b0, b1 = c0 // B, -(-c1 // B)
        want = quant.dequant_int8_plain(q32[b0:b1], scale[b0:b1], c1 - c0, torch.bfloat16)
        check(torch.equal(out[c0:c1], want), f"dequant int32 -> bf16 at [{c0}, {c1})")
    lib_out, lib_call = mul_decode(q32, scale, torch.bfloat16)
    lib_equal = agree["dequant_int8"] and torch.equal(lib_out, out)
    del out, lib_out
    free_memory()
    deq = {"ms": time_ms(lambda: quant.dequant_int8_call(q32, scale, n, torch.bfloat16), 10),
           "plain_ms": time_ms(lambda: quant.dequant_int8_plain(q32, scale, n, torch.bfloat16),
                               1, warmup=1),
           # read the int32 blocks and the scales, write the bf16 values
           "bound_ms": (4 * nb * B + 4 * nb + 2 * n) / PEAK_BYTES_PER_S * 1e3,
           "library_ms": yardstick(lib_call, lib_equal, "torch.mul int32 -> bf16", 10)}
    del lib_call
    print(f"[check] gradient segment of {n} bf16 values (> 2^31), in chunks of 2^28: "
          f"amax_block, quant_scaled and the int32 -> bf16 decode bit-equal, all three "
          f"in their vector variant; library versions bit-equal: "
          f"vector_norm {amax_equal}, torch.mul {lib_equal}")
    return rows, deq


def check_shared_codec_f32(dev, gen, n: int, agree: dict[str, bool]) -> dict:
    """hier_zero1's codec input: one f32 buffer of ``n`` > 2^31 values (the
    gradient segment cast to f32), through amax_block and quant_scaled and
    the int32 -> f32 decode, each in its vector variant, compared chunk by
    chunk with the plain versions and timed beside its bound (amax_block
    and the decode also beside one PyTorch call, if bit-equal)."""
    B = quant.BLOCK
    nb = n // B
    check(n == nb * B, f"the gradient segment {n} is not whole blocks")
    x = torch.empty(n, dtype=torch.float32, device=dev)
    for c0, c1 in _chunks(n):
        x[c0:c1] = torch.randn(c1 - c0, device=dev, generator=gen) * 1e-3
    x[B:2 * B] = 0
    before = ops.vector_launch_counts()
    a = quant.amax_block_call(x)
    scale = compression._shared_scale(a.clone(), None)
    q = quant.quant_scaled_call(x, scale)
    after = ops.vector_launch_counts()
    check(all(after[k] == before[k] + 1 for k in ("amax_block", "quant_scaled")),
          "amax_block, quant_scaled on f32: vector variant")
    for c0, c1 in _chunks(n):
        b0, b1 = c0 // B, -(-c1 // B)
        check(torch.equal(a[b0:b1], quant.amax_block_plain(x[c0:c1])),
              f"amax_block f32 at [{c0}, {c1})")
        check(torch.equal(q[b0:b1], quant.quant_scaled_plain(x[c0:c1], scale[b0:b1])),
              f"quant_scaled f32 at [{c0}, {c1})")

    def norm():
        return torch.linalg.vector_norm(x.view(nb, B), ord=float("inf"), dim=1)
    amax_equal = agree["amax_block"] and torch.equal(norm(), a)
    out = {
        # read the f32 segment once, write nb floats
        "amax_block": {"ms": time_ms(lambda: quant.amax_block_call(x), 10),
                       "bound_ms": (4 * n + 4 * nb) / PEAK_BYTES_PER_S * 1e3,
                       "library_ms": yardstick(norm, amax_equal,
                                               "vector_norm(ord=inf), f32", 10)},
        # read the segment and the scales once, write the int8 blocks
        "quant_scaled": {"ms": time_ms(lambda: quant.quant_scaled_call(x, scale), 10),
                         "bound_ms": (4 * n + 4 * nb + nb * B) / PEAK_BYTES_PER_S * 1e3,
                         "library_ms": None},
    }
    del x
    free_memory()
    q32 = q.to(torch.int32)
    del q
    free_memory()
    before = quant.dequant_int8_call.vector_launches
    dec = quant.dequant_int8_call(q32, scale, n, torch.float32)
    check(quant.dequant_int8_call.vector_launches == before + 1,
          "dequant_int8 int32 -> f32: vector variant")
    for c0, c1 in _chunks(n):
        b0, b1 = c0 // B, -(-c1 // B)
        want = quant.dequant_int8_plain(q32[b0:b1], scale[b0:b1], c1 - c0, torch.float32)
        check(torch.equal(dec[c0:c1], want), f"dequant int32 -> f32 at [{c0}, {c1})")
    lib_out, lib_call = mul_decode(q32, scale, torch.float32)
    lib_equal = agree["dequant_int8"] and torch.equal(lib_out, dec)
    del dec, lib_out
    free_memory()
    # read the int32 blocks and the scales, write the f32 values
    out["dequant_int8"] = {
        "ms": time_ms(lambda: quant.dequant_int8_call(q32, scale, n, torch.float32), 10),
        "bound_ms": (4 * nb * B + 4 * nb + 4 * n) / PEAK_BYTES_PER_S * 1e3,
        "library_ms": yardstick(lib_call, lib_equal, "torch.mul int32 -> f32", 10)}
    del lib_call, q32
    free_memory()
    print(f"[check] hier_zero1's f32 gradient segment of {n} values (> 2^31), in chunks "
          f"of 2^28: amax_block and quant_scaled on f32 and the int32 -> f32 decode "
          f"bit-equal, all three in their vector variant; library versions bit-equal: "
          f"vector_norm {amax_equal}, torch.mul {lib_equal}")
    return out


# ---------------------------------------------------------------------------
# 7. slot packing, alone and fused with the int8 codec
# ---------------------------------------------------------------------------

def _small_tree(dev, gen, dtypes) -> list:
    """Leaves taking ``dtypes`` in turn: a 16-byte-aligned leaf, a list leaf
    of three ragged layers, ragged leaves, a scalar and an all-zero leaf."""
    def r(*shape):
        return torch.randn(shape, device=dev, generator=gen) * 3

    made = [r(64, 32), [r(129) for _ in range(3)], r(5), r(2048), r(), r(37, 11),
            torch.zeros(2048 + 257, device=dev)]
    return [[p.to(dtypes[i % len(dtypes)]) for p in x] if isinstance(x, list)
            else x.to(dtypes[i % len(dtypes)]) for i, x in enumerate(made)]


def _stress_trees(dev, gen) -> dict:
    """Piece lists that drive every branch of fused_pack_quant's table walk:
    name -> (pieces, padded)."""
    def leaf(n, dt):
        return (torch.randn(n, device=dev, generator=gen) * 3).to(dt)

    def sizes(lo, hi, k):
        return torch.randint(lo, hi, (k,), device=dev, generator=gen).tolist()

    def back_to_back(lengths, dtypes, gaps=None):
        pieces, pos = [], 0
        for i, n in enumerate(lengths):
            pos += gaps[i] if gaps else 0
            pieces.append((pos, leaf(n, dtypes[i % len(dtypes)])))
            pos += n
        return pieces, -(-(pos + 1) // quant.BLOCK) * quant.BLOCK

    f32, bf16 = torch.float32, torch.bfloat16
    odd = leaf(3 + 4096, bf16)[3:]                # a source 6 bytes off 16
    return {
        # more than 32 spans in block 0, offsets not multiples of 8, words
        # straddling two spans, bf16 and f32 in turns
        "40 small leaves, bf16/f32": back_to_back(sizes(1, 26, 40), (bf16, f32)),
        # null spans in mid-block (300-517, 717-2100) and whole null blocks
        "gaps": ([(0, leaf(300, bf16)), (517, leaf(200, f32)), (2100, leaf(5000, bf16))],
                 10240),
        # blocks inside one span: 16-byte words where the source allows
        # them (offsets 0, 4096, 12296, 16396), values where it does not
        # (the unaligned source at 8192, the bf16 leaf at 20501)
        "aligned and unaligned words": ([(0, leaf(4096, bf16)), (4096, leaf(4096, f32)),
                                         (8192, odd), (12296, leaf(4096, bf16)),
                                         (16396, leaf(4096, f32)), (20501, leaf(3000, bf16))],
                                        24576),
        # a table of more than 1024 rows: three search rounds
        "1100 leaves with gaps": back_to_back(sizes(1, 3000, 1100), (bf16, f32, f32),
                                              sizes(0, 4, 1100)),
    }


def check_pack_small(dev, gen) -> None:
    f32, bf16 = torch.float32, torch.bfloat16
    for dtypes in ((f32,), (bf16,), (f32, bf16)):
        leaves = _small_tree(dev, gen, dtypes)
        layout = packing.plan_layout(packing.tree_metas(leaves), world=4, n_chunks=4,
                                     block=quant.BLOCK)
        got = packing.pack(layout, leaves)
        for name, pieces in packing.segment_pieces(layout, leaves).items():
            padded = layout.segment(name).padded
            buf = got[name]
            check(torch.equal(buf, quant.pack_slots_plain(pieces, padded, buf.dtype)),
                  f"pack_slots {name} segment of {dtypes}")
            other = bf16 if buf.dtype == f32 else f32           # a cast as it copies
            check(torch.equal(quant.pack_slots_call(pieces, padded, other),
                              quant.pack_slots_plain(pieces, padded, other)),
                  f"pack_slots {name} into {other}")
            fq, fs = quant.fused_pack_quant_call(pieces, padded)
            pq, ps = quant.fused_pack_quant_plain(pieces, padded)
            cq, cs = quant.quant_int8_call(buf)
            check(torch.equal(fq, pq) and torch.equal(fs, ps),
                  f"fused_pack_quant {name} of {dtypes} against plain")
            check(torch.equal(fq, cq) and torch.equal(fs, cs),
                  f"fused_pack_quant {name} of {dtypes} against pack -> quant_int8")
    print("[check] pack_slots and fused_pack_quant, f32, bf16 and mixed trees (list "
          "leaves, ragged leaves, a scalar, an all-zero leaf, casts both ways): "
          "bit-equal to the plain versions and to pack -> quant_int8")
    rows = {}
    for name, (pieces, padded) in _stress_trees(dev, gen).items():
        fq, fs = quant.fused_pack_quant_call(pieces, padded)
        pq, ps = quant.fused_pack_quant_plain(pieces, padded)
        cq, cs = quant.quant_int8_call(quant.pack_slots_call(pieces, padded))
        check(torch.equal(fq, pq) and torch.equal(fs, ps), f"fused_pack_quant {name} against plain")
        check(torch.equal(fq, cq) and torch.equal(fs, cs),
              f"fused_pack_quant {name} against pack -> quant_int8")
        rows[name] = quant._span_table(pieces, padded, "fused_pack_quant")[0].shape[0]
    check(max(rows.values()) > 1024, f"table rows {rows}")
    print(f"[check] fused_pack_quant on stress trees (table rows {rows}): bit-equal to the "
          f"plain version and to pack -> quant_int8")


def check_pack(dev, gen, rt, smi: str) -> tuple[dict, dict]:
    """Small cases, then the qwen2.5-3b gradient layout (the parameters of
    a full-width model stand for its gradients): the conformance path with
    its launch counts set to 0 just before it and read just after, the
    kernels against their plain versions, and the timings."""
    check_pack_small(dev, gen)
    model = Model(get_config(ARCH), rt, dev).init(0)
    leaves = model.train_leaves()
    layout = collectives.comm_layout(leaves, collectives.CommConfig(compression="int8"),
                                     world=1)
    check(len(layout.segments) == 1, f"segments {layout.segments}")
    seg = layout.segments[0]
    pieces = packing.segment_pieces(layout, leaves)[seg.dtype]
    n, padded, nb = seg.used, seg.padded, seg.padded // quant.BLOCK
    check(padded > 2 ** 31 and seg.dtype == "bfloat16", f"segment {seg}")

    # the reference's OK-F conformance row: fused pack+quantize == pack -> quant
    ops.reset_launch_counts()
    buf = packing.pack(layout, leaves)[seg.dtype]
    cq, cs = quant.quant_int8_call(buf)
    fq, fs = quant.fused_pack_quant_call(pieces, padded)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(torch.equal(fq, cq) and torch.equal(fs, cs), "OK-F: fused != pack -> quant_int8")
    want = {k: 0 for k in counts}
    want.update(pack_slots=1, quant_int8=1, fused_pack_quant=1)
    check(counts == want, f"conformance launches {counts}")
    del cq, cs
    check(torch.equal(buf, quant.pack_slots_plain(pieces, padded, torch.bfloat16)),
          "pack_slots at the gradient layout")
    del buf
    free_memory()
    pq, ps = quant.fused_pack_quant_plain(pieces, padded)
    check(torch.equal(fq, pq) and torch.equal(fs, ps), "fused_pack_quant at the gradient layout")
    del pq, ps, fq, fs
    free_memory()
    print(f"[check] conformance (OK-F) at the qwen2.5-3b gradient layout, {len(pieces)} "
          f"parameter tensors, {n} bf16 values padded to {padded} (> 2^31): fused "
          f"pack+quantize == pack -> quant_int8, and both kernels == their plain "
          f"versions, bit for bit; launches {want}")

    parts = [p.reshape(-1) for _, p in pieces]
    parts.append(torch.zeros(padded - n, dtype=torch.bfloat16, device=dev))
    rows = {
        "pack_slots": {
            "name": "pack_slots", "route": "cuda", "source": "src/repro_torch/csrc/pack.cu",
            "replaces": "src/repro/kernels/quant.py:137", "max_abs_err": 0.0,
            "ms": time_ms(lambda: quant.pack_slots_call(pieces, padded, torch.bfloat16), 10),
            "plain_ms": time_ms(lambda: quant.pack_slots_plain(pieces, padded, torch.bfloat16),
                                3, warmup=1),
            # read every parameter tensor once, write the padded segment once
            "bound_ms": (2 * n + 2 * padded) / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": time_ms(lambda: torch.cat(parts), 10)},
        "fused_pack_quant": {
            "name": "fused_pack_quant", "route": "cuda", "source": "src/repro_torch/csrc/pack.cu",
            "replaces": "src/repro/kernels/quant.py:158", "max_abs_err": 0.0,
            "ms": time_ms(lambda: quant.fused_pack_quant_call(pieces, padded), 10),
            "plain_ms": time_ms(lambda: quant.fused_pack_quant_plain(pieces, padded), 1,
                                warmup=1),
            # read every parameter tensor once, write the int8 blocks and scales
            "bound_ms": (2 * n + padded + 4 * nb) / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None},
    }
    rows["pack_slots"]["interleaved"] = pack_against_cat(pieces, parts, padded, smi)
    del model, leaves, pieces, parts
    free_memory()
    return rows, counts


def pack_against_cat(pieces, parts, padded: int, smi: str) -> dict:
    """pack_slots and torch.cat on the same gradient layout in PACK_ROUNDS
    rounds, taking turns at going first, each sample timed as the row's
    ``ms`` is; every sample printed."""
    calls = {"pack_slots": lambda: quant.pack_slots_call(pieces, padded, torch.bfloat16),
             "torch.cat": lambda: torch.cat(parts)}
    samples = {name: [] for name in calls}
    for i in range(PACK_ROUNDS):
        for name in (list(calls) if i % 2 == 0 else list(calls)[::-1]):
            samples[name].append(time_ms(calls[name], 10))
            print(f"[time] [{smi}] pack_slots vs torch.cat, round {i}: {name} "
                  f"{samples[name][-1]:.4f} ms")
    med = {name: statistics.median(ms) for name, ms in samples.items()}
    print(f"[time] [{smi}] pack_slots vs torch.cat over {PACK_ROUNDS} interleaved rounds: "
          f"medians pack_slots {med['pack_slots']:.4f} ms, torch.cat "
          f"{med['torch.cat']:.4f} ms ({med['pack_slots'] / med['torch.cat'] - 1:+.1%})")
    return {"samples_ms": samples, "median_ms": med}


# ---------------------------------------------------------------------------
# 8. where the time goes
# ---------------------------------------------------------------------------

MATMUL_KEYS = ("gemm", "nvjet", "xmma", "cutlass", "cublas", "splitk")
# the f32 flash_attention_kernel and the bf16 flash_attention_mma_kernel;
# the f32 ssd_chunk_kernel and the bf16 ssd_chunk_mma_kernel
SERVE_GROUPS = (("flash_attention", ("flash_attention",)),
                ("ssd_chunk", ("ssd_chunk_kernel", "ssd_chunk_mma_kernel")),
                ("matmul", MATMUL_KEYS),
                ("int8 codec", ("quant_int8_kernel", "dequant_int8")))
SERVE_RANGES = ("ssd_inter_chunk", "causal_conv1d")
TRAIN_GROUPS = (("codec", ("amax_block", "quant_scaled", "dequant_int8")),
                ("pack", ("pack_slots_kernel",)),
                ("matmul", MATMUL_KEYS))
TRAIN_RANGES = ("grad_sync", "grad_norm", "optimizer")


def _name_group(name: str, name_groups) -> str | None:
    return next((g for g, keys in name_groups if any(k in name.lower() for k in keys)),
                None)


def _in_range(ev, ranges) -> str | None:
    while ev is not None:
        if ev.name in ranges:
            return ev.name
        ev = ev.cpu_parent
    return None


def _breakdown(prof, name_groups, ranges) -> tuple[dict, dict, float, int, list]:
    """Device time by group: kernels matching ``name_groups`` by name; the
    rest by the record_function range (of ``ranges``) their launching op
    ran in; everything else as "other".  The kernels that the ctypes
    wrappers launch have no launching aten op, so device time and names
    come from the device events, and the ranges only from the kernels an
    aten op launched.  Also the host time spent inside each range."""
    groups = {g: 0.0 for g, _ in name_groups}
    busy, n_kernels, top = 0.0, 0, []
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        # a record_function range also shows as a device-side span
        if (us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA
                or ev.is_user_annotation):
            continue
        busy += us / 1e3
        n_kernels += ev.count
        top.append((us / 1e3, ev.count, ev.key[:70]))
        g = _name_group(ev.key, name_groups)
        if g is not None:
            groups[g] += us / 1e3
    for g in ranges:
        groups[g] = 0.0
    host = {g: 0.0 for g in ranges}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        if ev.name in ranges:
            host[ev.name] += ev.cpu_time_total / 1e3
        rng = _in_range(ev, ranges)
        for kern in ev.kernels:
            if rng is not None and _name_group(kern.name, name_groups) is None:
                groups[rng] += kern.duration / 1e3
    groups["other"] = busy - sum(groups.values())
    return groups, host, busy, n_kernels, sorted(top, reverse=True)[:6]


def _report(prof, wall_ms: float, label: str, smi: str, name_groups, ranges) -> dict:
    groups, host, busy, n_kernels, top = _breakdown(prof, name_groups, ranges)
    idle = 1.0 - busy / wall_ms
    shares = ", ".join(f"{g} {ms:.3f} ms ({ms / busy:.1%})"
                       for g, ms in sorted(groups.items(), key=lambda t: -t[1]) if ms > 0)
    hosts = ", ".join(f"host time in {g} {ms:.3f} ms" for g, ms in host.items())
    print(f"[profile] [{smi}] {label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {idle:.1%}, {n_kernels} kernels; {shares}"
          + (f"; {hosts}" if hosts else ""))
    for ms, count, name in top:
        print(f"[profile]   {ms:9.3f} ms  x{count:<5d} {name}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": idle,
            "groups_ms": groups, "kernels": n_kernels, "host_ms": host}


def check_vector_launches(counts: dict[str, int], path: str) -> None:
    """Every launch on a main path of a kernel that has a vector variant
    (amax_block, quant_scaled, dequant_int8) took it."""
    vector = ops.vector_launch_counts()
    check(all(vector[k] == counts[k] for k in vector),
          f"{path}: vector launches {vector} of {counts}")


def serve_full_width(dev, smi: str, arch: str) -> tuple[dict, dict]:
    """A serving main path; the launch counts are set to 0 just before it
    and read just after, and each phase's launches are checked."""
    ops.reset_launch_counts()
    res = disaggregated.run(arch, batch=BATCH, prompt_len=PROMPT, gen=GEN, device=dev)
    counts = ops.launch_counts()
    cfg = get_config(arch)
    kernel = PATH_KERNEL[arch]
    phases = res["launches"]
    expect = {"prefill": {kernel: cfg.n_layers * res["prefills"]},
              # two leaves of at least 1024 values cross as int8 (k and v,
              # or conv and ssm); the lengths travel raw
              "int8_transfer": {"quant_int8": 2 * res["int8_transfers"],
                                "dequant_int8": 2 * res["int8_transfers"]},
              "raw_transfer": {}, "decode": {}}
    for phase, want in expect.items():
        got = {k: n for k, n in phases[phase].items() if n}
        check(got == want, f"{arch} {phase} launches {got}, expected {want}")
    check(counts == {k: sum(p[k] for p in phases.values()) for k in counts},
          f"{arch} launches {counts} against the phases {phases}")
    check_vector_launches(counts, arch)
    shapes = res["cache_shapes"]
    if cfg.family == "ssm":
        ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        want_shapes = {"conv": [cfg.n_layers, BATCH, cfg.conv_width - 1, ch],
                       "ssm": [cfg.n_layers, BATCH, cfg.d_inner // cfg.ssm_head_dim,
                               cfg.ssm_head_dim, cfg.ssm_state]}
    else:
        leaf = [cfg.n_layers, BATCH, PROMPT, cfg.n_kv_heads, cfg.head_dim]
        want_shapes = {"k": leaf, "v": leaf}
    check(all(shapes[k] == v for k, v in want_shapes.items())
          and shapes["length"] == [cfg.n_layers], f"{arch} cache {shapes}")
    check(res["cache_finite"], f"{arch}: non-finite cache")
    tokens = torch.tensor(res["tokens"])
    check(tokens.shape == (BATCH, GEN + 1), f"tokens {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token ids")
    check(res["raw_transfer_exact"], f"{arch}: the raw transfer changed the generation")
    print(f"[serve] [{smi}] {res['arch']} ({res['params'] / 1e9:.3f} B params, bf16, "
          f"{cfg.n_layers} layers), {BATCH} x {PROMPT}-token prompts: TTFT "
          f"{res['ttft_ms']:.2f} ms, decode {res['decode_ms_per_step']:.2f} ms/step, int8 "
          f"transfer of {res['cache_bytes']} cache bytes {res['int8_transfer_ms']:.2f} ms, "
          f"peak memory {res['peak_mem_gb']:.2f} GB, int8 token agreement "
          f"{res['int8_token_agreement']:.4f}, raw transfer exact")
    print(f"[serve] {res['arch']} kernel launches {counts}: by phase {phases} "
          f"({res['prefills']} prefills, {res['int8_transfers']} int8 transfers, "
          f"{res['decode_steps']} decode steps)")
    return res, counts


def profile_serving(dev, smi: str, arch: str) -> dict:
    """One prefill and four decode steps under torch.profiler (after a
    warm-up) on one full-width model."""
    cfg = get_config(arch)
    model = Model(cfg, device=dev).init(0)
    prefill, decode = make_serve_steps(model)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    tok, caches = prefill(prompt)                         # warm-up
    decode(tok, caches)
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches = prefill(prompt)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out["prefill"] = _report(prof, wall, f"{cfg.name} prefill {BATCH}x{PROMPT}", smi,
                             SERVE_GROUPS, SERVE_RANGES)
    steps = 4
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, caches = decode(tok, caches)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out["decode"] = _report(prof, wall, f"{cfg.name} {steps} decode steps", smi,
                            SERVE_GROUPS, SERVE_RANGES)
    return out


def attention_ms(dev, cfg) -> float:
    """Device time of one layer's training attention, forward + backward,
    at the training shape; a layer runs its forward twice (once more in
    the checkpoint's recompute)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    p = {k: v.requires_grad_(True)
         for k, v in attention.init_attention(gen, cfg, 1, cfg.dtype).items()}
    x = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, device=dev, generator=gen)
         .to(cfg.dtype).requires_grad_(True))
    rt = runtime_for_groups()
    dy = torch.randn_like(x)

    def fwd_bwd():
        torch.autograd.backward(attention.attention_train(p, x, cfg, rt), dy)

    with torch.no_grad():
        fwd = time_ms(lambda: attention.attention_train(p, x, cfg, rt), 5)
    return fwd + time_ms(fwd_bwd, 5)


def profile_training(dev, rt, smi: str, mode: str, codec: str | None,
                     with_attention: bool) -> dict:
    """One full-width training step under torch.profiler, after one
    warm-up step: device time by kernel group (the codec kernels, the
    pack, matmul, the rest of the gradient sync, the gradient norm, the
    optimizer, everything else) and the device's idle share; then one
    optimizer update timed apart (``optimizer_ms``)."""
    cfg = get_config(ARCH)
    model = Model(cfg, rt, dev)
    step_fn, init_fn = make_train_step(model, TrainConfig(
        comm_mode=mode, dcn_compression=codec, opt=opt_lib.OptConfig(warmup_steps=20)))
    opt = init_fn(0)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=TRAIN_BATCH,
                      seq_len=TRAIN_SEQ)
    b = {k: torch.from_numpy(v).long().to(dev) for k, v in synth_batch(dcfg, 0).items()}
    step_fn(opt, b)                                       # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(opt, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out = _report(prof, wall, f"training step {TRAIN_BATCH}x{TRAIN_SEQ}, {mode} + {codec}",
                  smi, TRAIN_GROUPS, TRAIN_RANGES)
    if mode == "hier_overlap":
        out["overlap"] = ov = overlap_timeline(prof)
        print(f"[time] [{smi}] hier_overlap's profiled step: {ov['syncs_begun_before']} of "
              f"{ov['syncs']} bucket syncs began before the backward's last kernel "
              f"({ov['last_backward_kernel']}); device time from the first bucket's codec "
              f"kernel to that kernel's end {ov['overlap_ms']:.3f} ms")
    out["optimizer_timed_apart"] = optimizer_ms(model, opt, opt_lib.OptConfig())
    print(f"[profile] [{smi}] {mode}'s optimizer update, timed apart: device time "
          f"{out['optimizer_timed_apart']['device_ms']:.3f} ms, event-timed "
          f"{out['optimizer_timed_apart']['ms']:.3f} ms")
    del model, opt, step_fn, init_fn
    free_memory()
    if not with_attention:
        return out
    out["attention_ms_timed_apart"] = attn = attention_ms(dev, cfg) * cfg.n_layers
    print(f"[profile] [{smi}] training attention, timed apart ({cfg.n_layers} layers x "
          f"(forward + forward/backward)): {attn:.3f} ms, inside matmul and other")
    return out


def overlap_timeline(prof) -> dict:
    """hier_overlap on the device timeline of one profiled step (one
    stream): each bucket's sync is a device-side ``grad_sync`` span; the
    backward's last kernel is the last kernel outside every such span
    that ran before the ``grad_norm`` range.  How many syncs began before
    it, and the device time from the first codec kernel (bucket 0's
    amax_block) to its end."""
    evs = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in evs
                   if ev.is_user_annotation and ev.name == "grad_sync")
    norm = [ev.time_range.start for ev in evs if ev.is_user_annotation and ev.name == "grad_norm"]
    check(bool(spans) and bool(norm), "no device-side grad_sync or grad_norm span in the profile")
    kernels = sorted((ev for ev in evs if not ev.is_user_annotation
                      and ev.time_range.start < min(norm)), key=lambda ev: ev.time_range.start)
    compute = [ev for ev in kernels
               if not any(s <= ev.time_range.start <= e for s, e in spans)]
    codec = [ev for ev in kernels if "amax_block" in ev.name]
    check(bool(compute) and bool(codec), "no backward or codec kernel before grad_norm")
    last, first = compute[-1], codec[0]
    return {"syncs": len(spans),
            "syncs_begun_before": sum(s < last.time_range.start for s, _ in spans),
            "last_backward_kernel": last.name[:60],
            "overlap_ms": (last.time_range.end - first.time_range.start) / 1e3}


def optimizer_ms(model, opt, ocfg) -> dict[str, float]:
    """One update of the live optimizer state outside the step: the
    profile's ``optimizer`` range without the profiler's attribution of
    kernels to ranges.  ``device_ms`` sums its kernels' device time;
    ``ms`` spans it with CUDA events, so it also holds the gaps a slower
    host leaves.  The moments (ZeRO-1) or the parameters stand in for the
    gradients."""
    if isinstance(opt, opt_lib.ZeroState):
        def update():
            opt_lib.zero_update(opt.mu, opt, ocfg, 0.5)
    else:
        params, decay = opt_lib.flat_params(model.train_leaves())

        def update():
            opt_lib.adam_update(params, opt, params, decay, ocfg, 0.5)
    return {"device_ms": device_ms(update, iters=3), "ms": time_ms(update, 3, warmup=1)}


def train_full_width(dev, smi: str, mode: str, codec: str | None) -> dict:
    """A training main path; the launch counts are set to 0 just before
    it and read just after."""
    ops.reset_launch_counts()
    res = train_launch.run(ARCH, steps=TRAIN_STEPS, mode=mode, compression=codec,
                           global_batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev,
                           log=lambda line: print(f"[train] {line}"))
    counts = ops.launch_counts()
    want = train_kernels(mode, codec, get_config(ARCH))
    boot = bootstrap_kernels(mode)
    check(counts == {k: n * TRAIN_STEPS + boot.get(k, 0) for k, n in want.items()},
          f"{mode} launches {counts} over {TRAIN_STEPS} steps and the bootstrap {boot}")
    check_vector_launches(counts, mode)
    for rec in res["records"]:
        launched = {k: rec["launches"][k] for k in want}
        check(launched == want, f"{mode} step {rec['step']} launches {launched}")
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["gnorm"]),
              f"step {rec['step']}: loss {rec['loss']}, grad norm {rec['gnorm']}")
        check(not rec["gated"], f"step {rec['step']}: the finite gate tripped")
    check(res["params"] == 3_085_938_688, f"params {res['params']}")
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    check(res["peak_mem_gb"] < total_gb, f"peak {res['peak_mem_gb']} GB of {total_gb} GB")
    losses = [r["loss"] for r in res["records"]]
    print(f"[train] [{smi}] {res['arch']} ({res['params']} params, bf16, 36 layers), {mode} + "
          f"{codec} over a pod and a data group of one, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
          f"step {res['step_ms']:.3f} ms (median of steps 1-{TRAIN_STEPS - 1}), "
          f"{res['tokens_per_s']:.1f} tokens/s, peak memory {res['peak_mem_gb']:.3f} GB of "
          f"the card's {total_gb:.3f} GB, losses {losses}; launches per step {want}, "
          f"before the steps {boot}")
    res["counts"] = counts
    return res


# ---------------------------------------------------------------------------

def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = card()
    print(f"[env] {smi}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"python {sys.version.split()[0]}")
    lib = _build.library()
    print(f"[build] [{smi}] {len(_build.sources())} sources -> {lib.path.name} in "
          f"{lib.build_seconds:.1f} s (one nvcc per source, in parallel, sm_90a)")

    gen = torch.Generator(device=dev).manual_seed(0)
    agree = check_library_nan(dev)
    rows = check_codec(dev, gen, agree)
    check_codec_views(dev, gen)
    rows.update(check_flash(dev, gen, smi))
    rows.update(check_ssd(dev, gen, smi))
    free_memory()
    check_small_model(dev, ARCH)
    check_small_model(dev, SSM_ARCH)
    train_launch.init_world(dev)        # a world of one: gloo for CPU, NCCL for CUDA
    try:
        rt = runtime_for_groups(pods=1, data_per_pod=1)
        # fsdp's runtime: the data group of one is also the FSDP group
        rt_fsdp = runtime_for_groups(pods=1, data_per_pod=1, fsdp=True)
        for mode, codec in TRAIN_RUNS:
            check_small_training(dev, rt_fsdp if mode == "fsdp" else rt, mode, codec)
        serve, serve_counts, serve_profile = {}, {}, {}
        for arch in (ARCH, SSM_ARCH):
            serve[arch], serve_counts[arch] = serve_full_width(dev, smi, arch)
            free_memory()
            serve_profile[arch] = profile_serving(dev, smi, arch)
            free_memory()
        train = {}
        for mode, codec in TRAIN_RUNS:
            train[mode] = train_full_width(dev, smi, mode, codec)
            free_memory()
        peaks = ", ".join(f"{m} {r['peak_mem_gb']:.3f} GB" for m, r in train.items())
        print(f"[train] [{smi}] peak memory by gradient sync: {peaks}")
        n_segment = packing.aligned_size(train["hier"]["params"],
                                         packing.comm_alignment(1, 4, 1024))
        codec_rows, deq = check_shared_codec(dev, gen, n_segment, agree)
        rows.update(codec_rows)
        free_memory()
        f32 = check_shared_codec_f32(dev, gen, n_segment, agree)
        free_memory()
        pack_rows, conformance_counts = check_pack(dev, gen, rt, smi)
        rows.update(pack_rows)
        free_memory()
        train_profile = {mode: profile_training(dev, rt_fsdp if mode == "fsdp" else rt, smi,
                                                mode, codec, with_attention=mode == "hier")
                         for mode, codec in TRAIN_RUNS}
    finally:
        dist.destroy_process_group()

    rows["dequant_int8"]["int32_grad_segment"] = deq
    rows["amax_block"]["f32_grad_segment"] = f32["amax_block"]
    rows["quant_scaled"]["f32_grad_segment"] = f32["quant_scaled"]
    rows["dequant_int8"]["int32_f32_grad_segment"] = f32["dequant_int8"]
    paths = {"serve": serve_counts[ARCH], "serve_mamba2": serve_counts[SSM_ARCH],
             **{f"train_{mode}": res["counts"] for mode, res in train.items()},
             "conformance": conformance_counts}
    for name, row in rows.items():
        row["paths"] = {path: counts[name] for path, counts in paths.items()}
        row["launches"] = sum(row["paths"].values())
        check(row["launches"] > 0, f"{name} launched on no path")
        lib_ms = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        rate = (f" = {rate_tbs(row):.3f} TB/s against {PEAK_BYTES_PER_S / 1e12} TB/s"
                if row["bound_by"] == "bytes" else "")
        dev_ms = f", device time {row['device_ms']:.4f} ms" if "device_ms" in row else ""
        print(f"[time] [{smi}] {name}: {row['ms']:.4f} ms{dev_ms}, bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}){rate}, plain {row['plain_ms']:.4f} ms, library "
              f"{lib_ms} ms, launches {row['paths']}")
    ssm = rows["dequant_int8"]["ssm_state_f32"]
    lib_ms = "-" if ssm["library_ms"] is None else f"{ssm['library_ms']:.4f}"
    print(f"[time] [{smi}] dequant_int8 int8 -> f32, mamba2-2.7b SSM state: {ssm['ms']:.4f} ms, "
          f"device time {ssm['device_ms']:.4f} ms, bound {ssm['bound_ms']:.4f} ms (bytes) = "
          f"{rate_tbs(ssm):.3f} TB/s against {PEAK_BYTES_PER_S / 1e12} TB/s, plain "
          f"{ssm['plain_ms']:.4f} ms, library (torch.mul) {lib_ms} ms")
    lib_ms = "-" if deq["library_ms"] is None else f"{deq['library_ms']:.4f}"
    print(f"[time] [{smi}] dequant_int8 int32 -> bf16, {n_segment} values: "
          f"{deq['ms']:.4f} ms, bound {deq['bound_ms']:.4f} ms (bytes) = "
          f"{rate_tbs(deq):.3f} TB/s against {PEAK_BYTES_PER_S / 1e12} TB/s, "
          f"plain {deq['plain_ms']:.4f} ms, library (torch.mul) {lib_ms} ms")
    for name, what in (("amax_block", "f32 input"), ("quant_scaled", "f32 input"),
                       ("dequant_int8", "int32 -> f32")):
        row = f32[name]
        lib_ms = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        print(f"[time] [{smi}] {name} {what}, hier_zero1's {n_segment}-value segment: "
              f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms (bytes) = "
              f"{rate_tbs(row):.3f} TB/s against {PEAK_BYTES_PER_S / 1e12} TB/s, "
              f"library {lib_ms} ms")
    print(json.dumps({"serve": {arch: {k: res[k] for k in (
        "ttft_ms", "decode_ms_per_step", "int8_transfer_ms", "peak_mem_gb",
        "int8_token_agreement", "cache_bytes", "params")} for arch, res in serve.items()},
        "serve_profile": serve_profile,
        "train": {mode: {k: res[k] for k in ("compression", "step_ms", "tokens_per_s",
                                              "peak_mem_gb", "global_batch", "seq", "params")}
                  for mode, res in train.items()},
        "train_losses": {mode: [r["loss"] for r in res["records"]]
                         for mode, res in train.items()},
        "train_profile": train_profile, "card": smi}))
    print(f"[time] chip_smoke: {time.perf_counter() - t_start:.1f} s from start to result")
    print(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
