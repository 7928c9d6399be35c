"""Disaggregated prefill/decode serving (paper §6.2.2), one process.

Prefill a batch of prompts, move the cache to the decode side through
``kv_transfer_body`` (raw, and int8 on the wire), then decode greedily
from the moved caches and from the original one.  The cache is the KV
cache of a dense, MoE or VLM model, the conv and SSM state of a Mamba2
model, both for a Hymba model, or the self- and cross-attention KV
caches of a whisper model, whose encoder first reads the stub audio
frontend's frame embeddings (``enc_seq`` frames per request, drawn from
the seed).  The
raw transfer must reproduce same-side generation token for token; the
int8 transfer reports its token agreement.  Weights are random, drawn
from ``--seed``.

It runs as one pod, so the pod group has one member: the permutation is
the identity and only the codec kernels run on the transfer
(``kv_transfer_body`` shifts over a real pod group).  With ``--tp N`` the
pod is N tensor-parallel ranks, one process each, from the usual
``RANK``/``WORLD_SIZE``/``MASTER_*`` environment: every rank prefills,
moves and decodes its own shard of the cache, and prints its own line.

    python -m repro_torch.serve.disaggregated                  # qwen2.5-3b on the GPU
    python -m repro_torch.serve.disaggregated --arch mamba2-2.7b
    python -m repro_torch.serve.disaggregated --arch hymba-1.5b --prompt-len 2048
    python -m repro_torch.serve.disaggregated --arch qwen3-moe-30b-a3b
    python -m repro_torch.serve.disaggregated --arch whisper-tiny
    python -m repro_torch.serve.disaggregated --arch chameleon-34b     # on an empty card
    python -m repro_torch.serve.disaggregated --smoke --device cpu
    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=29500 \
        python -m repro_torch.serve.disaggregated --tp 2      # or --arch mamba2-2.7b --tp 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import BACKENDS, init_world, runtime_for_groups
from repro_torch.models.model import Model, resolve_device
from repro_torch.serve.serve_step import cache_leaves, make_kv_transfer, make_serve_steps
from repro_torch.train.loss import sharded_argmax


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _PhaseLaunches:
    """Kernel launches per phase of a run, from the wrappers' counters
    (which count only launches on the card)."""

    def __init__(self):
        self.by_phase: dict[str, dict[str, int]] = {}

    def __call__(self, phase: str, fn, *args):
        before = ops.launch_counts()
        out = fn(*args)
        counts = self.by_phase.setdefault(phase, dict.fromkeys(before, 0))
        for name, n in ops.launch_counts().items():
            counts[name] += n - before[name]
        return out


def _generate(decode, token, caches, steps: int) -> torch.Tensor:
    """Greedy decode ``steps`` steps from the prefill's ``token``; returns
    that token and the decoded ones, (B, steps + 1)."""
    out = [token]
    for _ in range(steps):
        token, caches = decode(token, caches)
        out.append(token)
    return torch.cat(out, dim=1)


def run(arch: str = "qwen2.5-3b", *, smoke: bool = False, batch: int = 4,
        prompt_len: int = 1024, gen: int = 16, seed: int = 0,
        device="cuda", tp: int = 1, layers: int | None = None,
        moe_capacity_factor: float = 1.25) -> dict:
    """Serve one batch end to end and return what it measured.  One
    warm-up prefill and transfer run first (the kernels build then); the
    warm-up's last-token logits (this rank's vocabulary shard) come back
    as ``prefill_logits``.  With ``tp`` > 1 the running process group must
    be ``tp`` ranks (an MoE model runs expert parallelism over them when
    it has at least ``tp`` experts).  ``layers`` cuts the depth;
    ``moe_capacity_factor`` is the Runtime's.  Times are host wall-clock
    around work that ends in a device synchronize."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch, smoke=smoke)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if tp > 1:
        if not dist.is_initialized() or dist.get_world_size() != tp:
            raise ValueError(f"tp {tp} needs a process group of {tp} ranks")
        rt = runtime_for_groups(pods=1, data_per_pod=1, tp=tp,
                                moe_capacity_factor=moe_capacity_factor)
    else:
        rt = runtime_for_groups(moe_capacity_factor=moe_capacity_factor)
    model = Model(cfg, rt, device).init(seed)
    gen_tok = torch.Generator(device="cpu").manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen_tok).to(device)
    # the stub audio frontend's frame embeddings (B, enc_seq, d_model)
    frames = (torch.randn((batch, cfg.enc_seq, cfg.d_model), generator=gen_tok).to(device)
              if cfg.n_enc_layers else None)
    prefill, decode = make_serve_steps(model)
    transfer = make_kv_transfer(model)
    transfer_q = make_kv_transfer(model, compress="int8")

    phase = _PhaseLaunches()
    # warm-up: ``prefill`` in its two halves, to keep the logits
    logits, caches = phase("prefill", model.apply_prefill, prompt, frames)
    phase("prefill", sharded_argmax, logits, model.rt, cfg.vocab_size)
    phase("int8_transfer", transfer_q, caches)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    tok, caches = phase("prefill", prefill, prompt, frames)
    _sync(device)
    ttft_s = time.perf_counter() - t0

    # transfer first: decoding writes the cache it is given
    moved = phase("raw_transfer", transfer, caches)
    _sync(device)
    t0 = time.perf_counter()
    moved_q = phase("int8_transfer", transfer_q, caches)
    _sync(device)
    transfer_s = time.perf_counter() - t0
    cache_finite = all(bool(torch.isfinite(leaf).all())
                       for c in (caches, moved_q) for _, leaf in cache_leaves(c)
                       if leaf.is_floating_point())

    t0 = time.perf_counter()
    ref = phase("decode", _generate, decode, tok, caches, gen)
    _sync(device)
    decode_s = time.perf_counter() - t0
    dis = phase("decode", _generate, decode, tok, moved, gen)
    dis_q = phase("decode", _generate, decode, tok, moved_q, gen)
    _sync(device)

    return {
        "arch": cfg.name, "device": str(device), "tp": tp, "layers": cfg.n_layers,
        "rank": dist.get_rank() if tp > 1 else 0, "batch": batch,
        "prompt_len": prompt_len, "gen": gen,
        "params": sum(p.numel() for p in model.parameters()),
        "prefills": 2, "int8_transfers": 2, "decode_steps": 3 * gen,
        "launches": phase.by_phase,
        "ttft_ms": ttft_s * 1e3,
        "decode_ms_per_step": decode_s * 1e3 / gen,
        "int8_transfer_ms": transfer_s * 1e3,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
        "raw_transfer_exact": bool(torch.equal(ref, dis)),
        "cache_finite": cache_finite,
        "int8_token_agreement": float((ref == dis_q).float().mean()),
        "tokens": ref.cpu().tolist(),
        "prefill_logits": logits[:, -1].cpu(),
        "cache_shapes": {name: list(leaf.shape) for name, leaf in cache_leaves(caches)},
        "cache_bytes": sum(leaf.numel() * leaf.element_size()
                           for _, leaf in cache_leaves(caches)),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", help="the arch's small config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks")
    ap.add_argument("--dist-backend", default=None, choices=list(BACKENDS),
                    help="with --tp: nccl (the default on the card) or gloo (the "
                         "CPU's, and ranks sharing one card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    started = args.tp > 1 and init_world(device, args.dist_backend)
    try:
        res = run(args.arch, smoke=args.smoke, batch=args.batch,
                  prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                  device=device, tp=args.tp)
    finally:
        if started:
            dist.destroy_process_group()
    res.pop("tokens")
    res.pop("prefill_logits")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
