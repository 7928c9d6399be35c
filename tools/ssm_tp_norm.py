"""How far Mamba2 at TP 2 lies from TP 1, on the CPU: two gloo ranks
against one process, from the same seed.

    PYTHONPATH=src python tools/ssm_tp_norm.py --d-model 512 --layers 64 --dtype bf16

mamba2-2.7b's config at a smaller ``--d-model`` (64-wide heads, state
128) and ``--layers``, 2 x 256 prompt tokens.  Prints the largest
difference of the last-token logits at TP 2 from TP 1 (the reference's
TP-2 function normalizes the gated norm over each rank's d_inner / 2
channels, ROADMAP R18) and from TP 1 with that norm taken over the same
two channel groups (``chip_smoke.grouped_gated_norm``), each beside the
largest TP-1 logit.  In f32 the second is the summation order alone; in
bf16 it is the TP-2 all-reduce's roundings, grown through the layers.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import pathlib
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import grouped_gated_norm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import runtime_for_groups  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _config(args):
    return dataclasses.replace(get_config("mamba2-2.7b"), d_model=args.d_model,
                               n_layers=args.layers, dtype=DTYPES[args.dtype])


def _prompt(cfg) -> torch.Tensor:
    return torch.randint(0, cfg.vocab_size, (2, 256), generator=torch.Generator().manual_seed(1))


def _rank(rank: int, port: int, args, queue) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=600))
    try:
        cfg = _config(args)
        model = Model(cfg, runtime_for_groups(pods=1, data_per_pod=1, tp=2), device="cpu")
        queue.put((rank, model.init(0).apply_prefill(_prompt(cfg))[0][:, -1].float()))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=64)
    ap.add_argument("--dtype", default="bf16", choices=list(DTYPES))
    args = ap.parse_args(argv)
    cfg = _config(args)
    model = Model(cfg, device="cpu").init(0)
    one = model.apply_prefill(_prompt(cfg))[0][:, -1].float()
    with grouped_gated_norm(2):
        grouped = model.apply_prefill(_prompt(cfg))[0][:, -1].float()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, args, queue)) for r in range(2)]
    for p in procs:
        p.start()
    shards = dict(queue.get(timeout=600) for _ in procs)
    for p in procs:
        p.join(timeout=60)
    two = torch.cat([shards[0], shards[1]], dim=-1)[:, :cfg.vocab_size]
    one, grouped = one[:, :cfg.vocab_size], grouped[:, :cfg.vocab_size]
    scale = one.abs().max().item()
    print(f"d_model {args.d_model}, {args.layers} layers, {args.dtype}: TP 2 - TP 1 "
          f"{(two - one).abs().max().item():.4g}, TP 2 - TP 1 with 2 norm groups "
          f"{(two - grouped).abs().max().item():.4g}, largest TP-1 logit {scale:.4g}")


if __name__ == "__main__":
    main()
