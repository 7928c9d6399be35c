"""Data-parallel training with the HetCCL gradient sync.

    python -m repro_torch.launch.train --arch qwen2.5-3b --mode hier --compression int8
    python -m repro_torch.launch.train --smoke --device cpu --steps 2

Each process trains one replica on its slice of the global batch; the
gradients meet through ``flat`` or ``hier`` (optionally bf16 or int8 on
the pod hop).  The world and this process's rank come from the usual
``torch.distributed`` environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); a lone process makes its own world
of one over an in-process store, whose pod and data groups are real
groups of one member, so the pod hop and its codec still run.  The
world is cut into ``--pods`` pods of equal size, pod-major.

Weights are random, drawn from ``--seed``; the data is the synthetic
zipf-ish stream of ``data/pipeline.py``.  Every ``--log-every`` steps a
JSON line gives the reference's per-step log (step, loss, grad norm,
ms per step) and the kernel launches of the step.  It runs on the GPU
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.kernels import ops
from repro_torch.launch.mesh import runtime_for_groups
from repro_torch.models.model import Model, resolve_device
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import TrainConfig, make_train_step


def init_world(device: torch.device) -> bool:
    """Start the default process group unless one is running.  Returns
    whether it started one.  On the GPU one group serves CPU tensors
    through gloo and CUDA tensors through NCCL."""
    if dist.is_initialized():
        return False
    backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(arch: str = "qwen2.5-3b", *, smoke: bool = False, steps: int = 4,
        mode: str = "hier", compression: str | None = None,
        global_batch: int = 4, seq: int = 1024, lr: float = 3e-3,
        log_every: int = 1, seed: int = 0, pods: int = 1, device="cuda",
        log=print) -> dict:
    """Train ``steps`` steps in the running process group and return what
    was measured.  Step times are host wall-clock around work that ends
    in a device synchronize."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % pods or global_batch % world:
        raise ValueError(f"world {world}, pods {pods}, global batch {global_batch}")
    rt = runtime_for_groups(pods=pods, data_per_pod=world // pods)
    cfg = get_config(arch, smoke=smoke)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = Model(cfg, rt, device)
    tcfg = TrainConfig(comm_mode=mode, dcn_compression=compression,
                       opt=OptConfig(lr=lr, warmup_steps=20))
    step_fn, init_fn = make_train_step(model, tcfg)
    opt = init_fn(seed)
    n_params = sum(p.numel() for p in model.parameters())
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=global_batch,
                      seq_len=seq, seed=seed)
    rows = slice(rank * (global_batch // world), (rank + 1) * (global_batch // world))
    records = []
    for step, batch in batches(dcfg):
        if step >= steps:
            break
        b = {k: torch.from_numpy(v[rows]).long().to(device) for k, v in batch.items()}
        before = ops.launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        m = step_fn(opt, b)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        after = ops.launch_counts()
        rec = {"step": step, "loss": m["loss"], "gnorm": m["grad_norm"],
               "ms_per_step": ms, "gated": m["gated"],
               "launches": {k: after[k] - before[k] for k in after}}
        records.append(rec)
        if step % log_every == 0:
            log(json.dumps(rec))
    timed = [r["ms_per_step"] for r in records[1:]] or [records[0]["ms_per_step"]]
    step_ms = statistics.median(timed)
    return {
        "arch": cfg.name, "device": str(device), "world": world, "pods": pods,
        "mode": mode, "compression": compression,
        "global_batch": global_batch, "seq": seq, "params": n_params,
        "records": records, "step_ms": step_ms,
        "tokens_per_s": global_batch * seq / (step_ms / 1e3),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", help="the arch's small config")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--mode", default="hier", choices=["flat", "hier"])
    ap.add_argument("--compression", default=None, choices=["bf16", "int8"])
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    started = init_world(device)
    try:
        res = run(args.arch, smoke=args.smoke, steps=args.steps, mode=args.mode,
                  compression=args.compression,
                  global_batch=args.global_batch, seq=args.seq, lr=args.lr,
                  log_every=args.log_every, seed=args.seed, pods=args.pods,
                  device=device)
    finally:
        if started:
            dist.destroy_process_group()
    res.pop("records")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
