"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

1. Environment: the card's name and power limit, torch and CUDA
   versions, and the time the kernels took to build from csrc/.
2. Each CUDA kernel against its plain PyTorch version on the card, at the
   serving shapes: the int8 codec bit-equal, flash attention within
   3e-2 (bf16) and 2e-3 (f32).  Each kernel is timed with CUDA events
   beside its bound, its plain version and, for flash attention, one
   PyTorch call computing the same function (timed only; the port never
   calls it).
3. A smoke-size model on the card against the same model on the CPU.
4. The serving path at full width: qwen2.5-3b (36 layers, random weights
   from a seed) prefills 4 requests of 1024 tokens, moves the KV cache
   raw and int8 on the wire, and decodes 16 tokens greedily from each.
   The launch counters must show every kernel on that path.
5. Where the time goes: one prefill and four decode steps under
   torch.profiler, device time by kernel group and the device's idle
   share of the wall time.

Any failed check raises, and the script exits non-zero without printing
its result line.  The last line is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import disaggregated  # noqa: E402
from repro_torch.serve.serve_step import make_serve_steps  # noqa: E402

# NVIDIA H100 SXM data sheet, dense rates without sparsity
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-3}

ARCH = "qwen2.5-3b"
BATCH, PROMPT, GEN = 4, 1024, 16


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


# ---------------------------------------------------------------------------
# 5. where the time goes
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

    # 4. the main path; counts read just before and just after it
    ops.reset_launch_counts()
    res = disaggregated.run(ARCH, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                            device=dev)
    counts = ops.launch_counts()
    cfg = get_config(ARCH)
    check(counts["flash_attention_bhsd"] == cfg.n_layers * res["prefills"],
          f"flash launches {counts}")
    check(counts["quant_int8"] == 2 * res["int8_transfers"], f"quant launches {counts}")
    check(counts["dequant_int8"] == 2 * res["int8_transfers"], f"dequant launches {counts}")
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

    for name, row in rows.items():
        row["launches"] = counts[name]
        lib_ms = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        print(f"[time] [{smi}] {name}: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, library {lib_ms} ms")
    profile = profile_serving(dev, smi)
    print(json.dumps({"serve": {k: res[k] for k in (
        "ttft_ms", "decode_ms_per_step", "int8_transfer_ms", "peak_mem_gb",
        "int8_token_agreement")}, "profile": profile, "card": smi}))
    print(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
