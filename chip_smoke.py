"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch and CUDA
   versions, and the time the kernels took to build from csrc/.
2. Each CUDA kernel of the serving path against its plain PyTorch
   version on the card, at the serving shapes: the int8 codec bit-equal,
   flash attention within 3e-2 (bf16) and 2e-3 (f32).  Each kernel is
   timed with CUDA events beside its bound, its plain version and, for
   flash attention, one PyTorch call computing the same function (timed
   only; the port never calls it).
3. A smoke-size model on the card against the same model on the CPU:
   prefill and decode, and 3 training steps (hier, int8 on the pod hop)
   through the same process groups (gloo for the CPU, NCCL for the card),
   losses and parameters within 1e-4.
4. The serving path at full width: qwen2.5-3b (36 layers, random weights
   from a seed) prefills 4 requests of 1024 tokens, moves the KV cache
   raw and int8 on the wire, and decodes 16 tokens greedily from each.
   The launch counters must show every kernel on that path.
5. The training path at full width: ``repro_torch.launch.train.run``
   trains qwen2.5-3b (hier, int8 on the pod hop) on 4 x 1024 tokens for
   4 steps in a world of one, through real pod and data groups of one
   member.  Every step must launch amax_block, quant_scaled and
   dequant_int8 once for its one bf16 gradient segment and no flash
   attention, with finite loss and grad norm and the finite gate open.
6. The shared-scale codec at the gradient segment's size (more than 2^31
   elements): bit-equal to the plain versions chunk by chunk, edge cases
   (ragged, all-zero block, scale <= 0, .5 ties, +-127 s, NaN and +-inf
   blocks and scales, for both int8 codecs) bit-equal, and
   amax / quant_scaled / the int32 -> bf16 decode timed beside their bounds.
7. Where the time goes: one prefill, four decode steps and one training
   step under torch.profiler, device time by kernel group and the
   device's idle share of the wall time.

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
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import compression, packing  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.mesh import runtime_for_groups  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.serve import disaggregated  # noqa: E402
from repro_torch.serve.serve_step import make_serve_steps  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import TrainConfig, make_train_step  # noqa: E402

# NVIDIA H100 SXM data sheet, dense rates without sparsity
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-3}

ARCH = "qwen2.5-3b"
BATCH, PROMPT, GEN = 4, 1024, 16
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 4
TRAIN_KERNELS = {"amax_block": 1, "quant_scaled": 1, "dequant_int8": 1,
                 "quant_int8": 0, "flash_attention_bhsd": 0}


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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal, with NaN in the same places."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def check_codec(dev, gen) -> dict:
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
    iters = 50
    quant_row = {
        "name": "quant_int8", "route": "cuda", "source": "src/repro_torch/csrc/quant.cu",
        "replaces": "src/repro/kernels/quant.py:72",
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: quant.quant_int8_call(x), iters),
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
        "plain_ms": time_ms(lambda: quant.dequant_int8_plain(q, s, n, torch.bfloat16),
                            iters // 5),
        "bound_ms": (nb * 1024 + 4 * nb + 2 * n) / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
    }
    return {"quant_int8": quant_row, "dequant_int8": dequant_row}


FLASH_CASES = [
    # (B, H, K, Sq, Skv, dh, causal, window, q_offset, valid_kv, dtype)
    (BATCH, 16, 2, PROMPT, PROMPT, 128, True, None, 0, None, torch.bfloat16),
    (BATCH, 16, 2, PROMPT, PROMPT, 128, True, None, 0, None, torch.float32),
    (2, 8, 2, 130, 130, 128, True, 64, 0, None, torch.float32),
    (2, 16, 2, 128, 512, 128, True, None, 300, 420, torch.bfloat16),
    (2, 8, 2, 256, 256, 64, True, None, 0, None, torch.bfloat16),
    (1, 4, 1, 192, 192, 80, False, None, 0, None, torch.float32),
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


def check_flash(dev, gen) -> dict:
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
        if (Sq, dt) == (PROMPT, torch.bfloat16):
            main_err, main = err, (q, k, v)
    q, k, v = main
    bound, by = flash_bound_ms(BATCH, 16, 2, PROMPT, 128, 0, PROMPT, True,
                               torch.bfloat16)
    return {"flash_attention_bhsd": {
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:85",
        "max_abs_err": main_err,
        "ms": time_ms(lambda: fa.flash_attention_bhsd(q, k, v, causal=True), 20),
        "plain_ms": time_ms(lambda: fa.flash_attention_bhsd_plain(q, k, v, causal=True), 5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20),
    }}


# ---------------------------------------------------------------------------
# 3. a small model on the card against the CPU
# ---------------------------------------------------------------------------

def check_small_model(dev) -> None:
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32)
    cpu = Model(cfg, device="cpu").init(0)
    gpu = copy.deepcopy(cpu).to(dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 130),
                         generator=torch.Generator().manual_seed(0))
    lc, cc = cpu.apply_prefill(toks, max_len=136)
    lg, cg = gpu.apply_prefill(toks.to(dev), max_len=136)
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
    print(f"[check] {cfg.name} f32 on the card vs the CPU: prefill + 4 decode "
          f"steps, max logit diff {err:.3g}, greedy tokens equal")


def check_small_training(dev, rt) -> None:
    """3 hier+int8 steps of a smoke f32 model on the card and on the CPU,
    from the same parameters and batches, through the same groups."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32)
    cpu = Model(cfg, rt, device="cpu").init(0)
    gpu = copy.deepcopy(cpu, {id(rt): rt}).to(dev)
    tcfg = TrainConfig(comm_mode="hier", dcn_compression="int8",
                       opt=opt_lib.OptConfig(lr=1e-3, warmup_steps=1))
    runs = []
    for model in (cpu, gpu):
        step_fn, _ = make_train_step(model, tcfg)
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
                launched = {k: after[k] - before[k] for k in TRAIN_KERNELS}
                check(launched == TRAIN_KERNELS, f"small training launches {launched}")
            check(not m["gated"], "small training: finite gate tripped")
            losses.append(m["loss"])
        runs.append(losses)
    err = max(abs(a - b) / abs(b) for a, b in zip(runs[1], runs[0]))
    check(err < 1e-4, f"small training losses {runs}")
    perr = max((torch.stack(g) if isinstance(g, list) else g).cpu().sub(
        torch.stack(c) if isinstance(c, list) else c).abs().max().item()
        for g, c in zip(gpu.train_leaves(), cpu.train_leaves()))
    check(perr < 1e-4, f"small training params differ by {perr}")
    print(f"[check] {cfg.name} f32 training, hier + int8, 3 steps on the card vs "
          f"the CPU: losses {[f'{l:.6f}' for l in runs[1]]}, max relative loss diff "
          f"{err:.3g}, max param diff {perr:.3g} (tol 1e-4)")


# ---------------------------------------------------------------------------
# 6. the shared-scale codec at the gradient segment's size
# ---------------------------------------------------------------------------

def _chunks(n: int, step: int = 1 << 28):
    for c0 in range(0, n, step):
        yield c0, min(n, c0 + step)


def check_shared_codec(dev, gen, n: int) -> dict:
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
        check(same(a, quant.amax_block_plain(xt)), f"amax_block NaN/inf {dt}")
        check(bool(a[[0, 3]].isnan().all() and a[[1, 2]].isinf().all()),
              f"amax_block propagates NaN {dt}")
        for scale in (a / 127, torch.tensor([1.0, inf, 0.5, nan, 2.0], device=dev)):
            check(torch.equal(quant.quant_scaled_call(xt, scale),
                              quant.quant_scaled_plain(xt, scale)),
                  f"quant_scaled NaN/inf {dt}")
        q, s = quant.quant_int8_call(xt)
        pq, ps = quant.quant_int8_plain(xt)
        check(torch.equal(q, pq) and same(s, ps), f"quant_int8 NaN/inf {dt}")
    print("[check] amax_block / quant_scaled, f32 and bf16, ragged with an all-zero "
          "block, scales <= 0, .5 ties, +-127 s, NaN and +-inf blocks and scales "
          "(quant_int8 too): bit-equal, NaN in the same places")

    check(n > 2 ** 31, f"gradient segment {n} is not above 2^31")
    x = torch.empty(n, dtype=torch.bfloat16, device=dev)
    for c0, c1 in _chunks(n):
        x[c0:c1] = torch.randn(c1 - c0, device=dev, generator=gen) * 1e-3
    x[B:2 * B] = 0
    nb = n // B
    a = quant.amax_block_call(x)
    scale = compression._shared_scale(a.clone(), None)
    q = quant.quant_scaled_call(x, scale)
    for c0, c1 in _chunks(n):
        b0, b1 = c0 // B, -(-c1 // B)
        check(torch.equal(a[b0:b1], quant.amax_block_plain(x[c0:c1])),
              f"amax_block at [{c0}, {c1})")
        check(torch.equal(q[b0:b1], quant.quant_scaled_plain(x[c0:c1], scale[b0:b1])),
              f"quant_scaled at [{c0}, {c1})")
    rows = {
        "amax_block": {
            "name": "amax_block", "route": "cuda", "source": "src/repro_torch/csrc/quant.cu",
            "replaces": "src/repro/kernels/quant.py:90", "max_abs_err": 0.0,
            "ms": time_ms(lambda: quant.amax_block_call(x), 10),
            "plain_ms": time_ms(lambda: quant.amax_block_plain(x), 1, warmup=1),
            # read the bf16 segment once, write nb floats
            "bound_ms": (2 * n + 4 * nb) / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None},
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
    out = quant.dequant_int8_call(q32, scale, n, torch.bfloat16)
    for c0, c1 in _chunks(n):
        b0, b1 = c0 // B, -(-c1 // B)
        want = quant.dequant_int8_plain(q32[b0:b1], scale[b0:b1], c1 - c0, torch.bfloat16)
        check(torch.equal(out[c0:c1], want), f"dequant int32 -> bf16 at [{c0}, {c1})")
    del out
    free_memory()
    deq = {"ms": time_ms(lambda: quant.dequant_int8_call(q32, scale, n, torch.bfloat16), 10),
           "plain_ms": time_ms(lambda: quant.dequant_int8_plain(q32, scale, n, torch.bfloat16),
                               1, warmup=1),
           # read the int32 blocks and the scales, write the bf16 values
           "bound_ms": (4 * nb * B + 4 * nb + 2 * n) / PEAK_BYTES_PER_S * 1e3}
    print(f"[check] gradient segment of {n} bf16 values (> 2^31), in chunks of 2^28: "
          f"amax_block, quant_scaled and the int32 -> bf16 decode bit-equal")
    return rows, deq


# ---------------------------------------------------------------------------
# 7. where the time goes
# ---------------------------------------------------------------------------

KERNEL_GROUPS = (("flash_attention", ("flash_attention_kernel",)),
                 ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "splitk")),
                 ("int8 codec", ("quant_int8_kernel",)))


def _breakdown(prof, wall_ms: float, label: str, smi: str) -> dict:
    """Device time per kernel group from a profile over ``wall_ms``."""
    groups: dict[str, float] = {}
    top = []
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        top.append((us / 1e3, ev.count, name[:70]))
    busy = sum(groups.values())
    idle = 1.0 - busy / wall_ms if wall_ms > 0 else float("nan")
    shares = ", ".join(f"{g} {ms:.3f} ms ({ms / busy:.1%})"
                       for g, ms in sorted(groups.items(), key=lambda t: -t[1]))
    print(f"[profile] [{smi}] {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {idle:.1%}; {shares}")
    for ms, count, name in sorted(top, reverse=True)[:6]:
        print(f"[profile]   {ms:9.3f} ms  x{count:<5d} {name}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": idle,
            "groups_ms": groups}


def serve_full_width(dev, smi: str) -> tuple[dict, dict]:
    """The serving main path; the launch counts are read just before and
    just after it."""
    ops.reset_launch_counts()
    res = disaggregated.run(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                            device=dev)
    counts = ops.launch_counts()
    cfg = get_config(ARCH)
    check(counts["flash_attention_bhsd"] == cfg.n_layers * res["prefills"],
          f"flash launches {counts}")
    check(counts["quant_int8"] == 2 * res["int8_transfers"], f"quant launches {counts}")
    check(counts["dequant_int8"] == 2 * res["int8_transfers"], f"dequant launches {counts}")
    check(counts["amax_block"] == counts["quant_scaled"] == 0, f"launches {counts}")
    check(res["kv_cache_shape"] == [cfg.n_layers, BATCH, PROMPT, cfg.n_kv_heads,
                                    cfg.head_dim], f"cache {res['kv_cache_shape']}")
    check(res["cache_finite"], "non-finite KV cache")
    tokens = torch.tensor(res["tokens"])
    check(tokens.shape == (BATCH, GEN + 1), f"tokens {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()), "token ids")
    check(res["raw_transfer_exact"], "raw KV transfer changed the generation")
    print(f"[serve] [{smi}] {res['arch']} ({res['params'] / 1e9:.3f} B params, bf16), "
          f"{BATCH} x {PROMPT}-token prompts: TTFT {res['ttft_ms']:.2f} ms, "
          f"decode {res['decode_ms_per_step']:.2f} ms/step, int8 KV transfer "
          f"{res['int8_transfer_ms']:.2f} ms, peak memory {res['peak_mem_gb']:.2f} GB, "
          f"int8 token agreement {res['int8_token_agreement']:.4f}, raw transfer exact")
    per_request = {name: n / res["prefills"] for name, n in counts.items()}
    print(f"[serve] kernel launches {counts} over {res['prefills']} prefills and "
          f"{res['int8_transfers']} int8 transfers ({per_request} per request batch)")
    return res, counts


def profile_serving(dev, smi: str) -> dict:
    cfg = get_config(ARCH)
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
    out["prefill"] = _breakdown(prof, wall, f"prefill {BATCH}x{PROMPT}", smi)
    steps = 4
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, caches = decode(tok, caches)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out["decode"] = _breakdown(prof, wall, f"{steps} decode steps", smi)
    return out


TRAIN_GROUPS = (("codec", ("amax_block_kernel", "quant_scaled_kernel",
                            "dequant_int8_kernel")),
                ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "splitk")))
TRAIN_RANGES = ("grad_sync", "optimizer")


def _name_group(name: str) -> str | None:
    return next((g for g, keys in TRAIN_GROUPS if any(k in name.lower() for k in keys)),
                None)


def _in_range(ev) -> str | None:
    while ev is not None:
        if ev.name in TRAIN_RANGES:
            return ev.name
        ev = ev.cpu_parent
    return None


def _train_breakdown(prof) -> tuple[dict, dict, float, int, list]:
    """Device time by group: codec and matmul by kernel name; the rest of
    the gradient sync and the optimizer by the record_function range
    their launching op ran in; everything else.  The kernels that the
    ctypes wrappers launch have no launching aten op, so device time and
    names come from the device events, and the ranges only from the
    kernels an aten op launched.  Also the host time spent inside each
    range."""
    groups = {"codec": 0.0, "matmul": 0.0}
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
        g = _name_group(ev.key)
        if g is not None:
            groups[g] += us / 1e3
    for g in TRAIN_RANGES:
        groups[g] = 0.0
    host = {g: 0.0 for g in TRAIN_RANGES}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        if ev.name in TRAIN_RANGES:
            host[ev.name] += ev.cpu_time_total / 1e3
        rng = _in_range(ev)
        for kern in ev.kernels:
            if rng is not None and _name_group(kern.name) is None:
                groups[rng] += kern.duration / 1e3
    groups["other"] = busy - sum(groups.values())
    return groups, host, busy, n_kernels, sorted(top, reverse=True)[:6]


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


def profile_training(dev, rt, smi: str) -> dict:
    """One full-width training step under torch.profiler, after one
    warm-up step: device time by kernel group (the codec kernels, matmul,
    the rest of the gradient sync, the optimizer, everything else) and
    the device's idle share."""
    cfg = get_config(ARCH)
    model = Model(cfg, rt, dev)
    step_fn, init_fn = make_train_step(model, TrainConfig(
        comm_mode="hier", dcn_compression="int8", opt=opt_lib.OptConfig(warmup_steps=20)))
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
    groups, host, busy, n_kernels, top = _train_breakdown(prof)
    idle = 1.0 - busy / wall
    del model, opt, step_fn, init_fn
    free_memory()
    attn = attention_ms(dev, cfg) * cfg.n_layers
    shares = ", ".join(f"{g} {ms:.3f} ms ({ms / busy:.1%})"
                       for g, ms in sorted(groups.items(), key=lambda t: -t[1]))
    print(f"[profile] [{smi}] training step {TRAIN_BATCH}x{TRAIN_SEQ}: wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share {idle:.1%}; {shares}; attention "
          f"(timed apart, {cfg.n_layers} layers x (forward + forward/backward)) "
          f"{attn:.3f} ms, inside matmul and other; {n_kernels} kernels; host time "
          f"in grad_sync {host['grad_sync']:.3f} ms, in optimizer {host['optimizer']:.3f} ms")
    for ms, count, name in top:
        print(f"[profile]   {ms:9.3f} ms  x{count:<5d} {name}")
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": idle,
            "groups_ms": groups, "kernels": n_kernels, "host_ms": host,
            "attention_ms_timed_apart": attn}


def train_full_width(dev, smi: str) -> dict:
    """The training main path; the launch counts are read just before
    and just after it."""
    ops.reset_launch_counts()
    res = train_launch.run(ARCH, steps=TRAIN_STEPS, mode="hier", compression="int8",
                           global_batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev,
                           log=lambda line: print(f"[train] {line}"))
    counts = ops.launch_counts()
    for rec in res["records"]:
        launched = {k: rec["launches"][k] for k in TRAIN_KERNELS}
        check(launched == TRAIN_KERNELS, f"step {rec['step']} launches {launched}")
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["gnorm"]),
              f"step {rec['step']}: loss {rec['loss']}, grad norm {rec['gnorm']}")
        check(not rec["gated"], f"step {rec['step']}: the finite gate tripped")
    check(res["params"] == 3_085_938_688, f"params {res['params']}")
    losses = [r["loss"] for r in res["records"]]
    print(f"[train] [{smi}] {res['arch']} ({res['params']} params, bf16, 36 layers), hier + "
          f"int8 over a pod and a data group of one, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
          f"step {res['step_ms']:.3f} ms (median of steps 1-{TRAIN_STEPS - 1}), "
          f"{res['tokens_per_s']:.1f} tokens/s, peak memory {res['peak_mem_gb']:.3f} GB, "
          f"losses {losses}; launches {counts} over {TRAIN_STEPS} steps")
    res["counts"] = counts
    return res


# ---------------------------------------------------------------------------

def main() -> int:
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
    print(f"[build] {len(_build.sources())} sources -> {lib.path.name} in "
          f"{lib.build_seconds:.1f} s (one nvcc call, sm_90a)")

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = check_codec(dev, gen)
    rows.update(check_flash(dev, gen))
    check_small_model(dev)
    train_launch.init_world(dev)        # a world of one: gloo for CPU, NCCL for CUDA
    try:
        rt = runtime_for_groups(pods=1, data_per_pod=1)
        check_small_training(dev, rt)
        res, serve_counts = serve_full_width(dev, smi)
        serve_profile = profile_serving(dev, smi)
        free_memory()
        train = train_full_width(dev, smi)
        free_memory()
        n_segment = packing.aligned_size(train["params"], packing.comm_alignment(1, 4, 1024))
        codec_rows, deq = check_shared_codec(dev, gen, n_segment)
        rows.update(codec_rows)
        free_memory()
        train_profile = profile_training(dev, rt, smi)
    finally:
        dist.destroy_process_group()

    rows["dequant_int8"]["int32_grad_segment"] = deq
    for name, row in rows.items():
        row["paths"] = {"serve": serve_counts[name], "train": train["counts"][name]}
        row["launches"] = serve_counts[name] + train["counts"][name]
        lib_ms = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        print(f"[time] [{smi}] {name}: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, library {lib_ms} ms, "
              f"launches {row['paths']}")
    print(f"[time] [{smi}] dequant_int8 int32 -> bf16, {n_segment} values: "
          f"{deq['ms']:.4f} ms, bound {deq['bound_ms']:.4f} ms (bytes), "
          f"plain {deq['plain_ms']:.4f} ms")
    print(json.dumps({"serve": {k: res[k] for k in (
        "ttft_ms", "decode_ms_per_step", "int8_transfer_ms", "peak_mem_gb",
        "int8_token_agreement")}, "serve_profile": serve_profile,
        "train": {k: train[k] for k in ("step_ms", "tokens_per_s", "peak_mem_gb",
                                         "global_batch", "seq", "params")},
        "train_losses": [r["loss"] for r in train["records"]],
        "train_profile": train_profile, "card": smi}))
    print(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
