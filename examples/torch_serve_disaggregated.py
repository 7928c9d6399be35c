"""Disaggregated prefill/decode serving across pods (paper §6.2.2), in
PyTorch.

8 processes as 2 pods x 2 data x 2 model ranks over gloo (on the GPU all
8 share the one card).  Pod 0 plays the prefill cluster, pod 1 the
decode cluster; the KV cache crosses the pod boundary through the
HetCCL SendRecv (a shift over the pod group), optionally int8 on the
wire.  Each (pod, data) rank holds one request and TP 2 splits its
heads.  Generation continuing from the transferred cache must match
same-pod generation token for token.  The port of
``examples/serve_disaggregated.py``.

    python examples/torch_serve_disaggregated.py                 # on the GPU
    python examples/torch_serve_disaggregated.py --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import compression  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import (TEST_SHAPE, init_world, mesh_coords,  # noqa: E402
                                     runtime_for_groups, spawn_world)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.model import resolve_device  # noqa: E402
from repro_torch.serve import make_kv_transfer, make_serve_steps  # noqa: E402
from repro_torch.serve.serve_step import cache_leaves, kv_transfer_body  # noqa: E402

ARCH = "qwen2.5-3b"
B, S, GEN = 4, 16, 8
PODS, DATA, TP = TEST_SHAPE


def world_runtime():
    """This rank's Runtime of the (pod, data, model) world."""
    return runtime_for_groups(pods=PODS, data_per_pod=DATA, tp=TP, moe_capacity_factor=8.0)


def smoke_config(f32: bool = False):
    """The smoke qwen2.5-3b (bf16), or in f32 (the parity checks')."""
    cfg = get_config(ARCH, smoke=True)
    return dataclasses.replace(cfg, dtype=torch.float32) if f32 else cfg


def prompt_tokens(cfg, prompt_len: int = S) -> torch.Tensor:
    """The (B, prompt_len) prompt of every request, from seed 1."""
    return torch.randint(0, cfg.vocab_size, (B, prompt_len),
                         generator=torch.Generator().manual_seed(1))


def my_rows(rank: int) -> slice:
    """The requests of ``rank``: the batch is split over (pod, data) and
    shared by the TP ranks of an index."""
    pod, data, _ = mesh_coords(rank, DATA, TP)
    per = B // (PODS * DATA)
    index = pod * DATA + data
    return slice(index * per, (index + 1) * per)


def _launched(before: dict) -> dict:
    return {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}


@torch.inference_mode()
def disaggregate(model: Model, prompt: torch.Tensor, gen: int = GEN) -> dict:
    """This rank's part of the example: prefill its requests, move the
    cache and the sampled token over the pod group (raw, and int8 on the
    wire), then ``gen`` greedy steps from the cache kept (same-pod) and
    from each moved one.  Returns the tokens of each path ((gen, rows)
    arrays; ``prefill`` the first sampled token per request), the kernel
    launches of each phase, the cache's leaves and those that crossed
    as int8."""
    prefill, decode = make_serve_steps(model)
    transfer = make_kv_transfer(model)
    transfer_q = make_kv_transfer(model, compress="int8")
    launches = {}
    before = ops.launch_counts()
    tok, caches = prefill(prompt.to(model.device))
    launches["prefill"] = _launched(before)
    # ship copies across the pod boundary first: decode() writes its cache
    # in place.  The requests travel with their caches: pod 1 takes over
    # pod 0's requests and pod 0 pod 1's (the 2-pod ring is a swap)
    before = ops.launch_counts()
    moved = transfer(caches)
    launches["transfer"] = _launched(before)
    before = ops.launch_counts()
    moved_q = transfer_q(caches)
    launches["transfer_int8"] = _launched(before)
    tok_moved = kv_transfer_body(tok[:, :1], model.rt)
    out = {"prefill": tok[:, 0].cpu().numpy()}
    before = ops.launch_counts()
    for path, (t, c) in (("same_pod", (tok, caches)), ("disaggregated", (tok_moved, moved)),
                         ("int8", (tok_moved, moved_q))):
        toks = []
        for _ in range(gen):
            toks.append(t[:, 0].cpu().numpy())
            t, c = decode(t[:, :1], c)
        out[path] = np.stack(toks)
    launches["decode"] = _launched(before)
    out["launches"] = launches
    leaves = dict(cache_leaves(caches))
    out["cache_leaves"] = list(leaves)
    out["int8_leaves"] = [name for name, leaf in leaves.items()
                          if leaf.dtype in (torch.bfloat16, torch.float32)
                          and leaf.numel() >= compression.BLOCK]
    return out


def serve_rank(rank: int, device: str, prompt_len: int) -> dict:
    """One rank of the world: the weights drawn from seed 0 on the CPU (so
    a device draws the same tree) and moved to ``device``, then
    ``disaggregate`` on its requests."""
    dev = resolve_device(device)
    init_world(dev, "gloo")
    try:
        cfg = smoke_config()
        model = Model(cfg, world_runtime(), device="cpu").init(0).to(dev)
        return disaggregate(model, prompt_tokens(cfg, prompt_len)[my_rows(rank)])
    finally:
        torch.distributed.destroy_process_group()


def gather(ranks: list[dict]) -> dict:
    """The global (B,) / (GEN, B) token arrays, each request's from the
    first rank of its TP group; the TP ranks of a request must agree."""
    out = {}
    for path in ("prefill", "same_pod", "disaggregated", "int8"):
        parts = []
        for r in range(0, len(ranks), TP):
            for m in range(1, TP):
                if not np.array_equal(ranks[r][path], ranks[r + m][path]):
                    raise AssertionError(f"TP ranks {r} and {r + m} disagree on {path}")
            parts.append(ranks[r][path])
        out[path] = np.concatenate(parts, axis=-1)
    return out


def swap_halves(a: np.ndarray) -> np.ndarray:
    return np.concatenate([a[..., B // 2:], a[..., :B // 2]], axis=-1)


def run(device: str, prompt_len: int = S) -> dict:
    """The 8 ranks' serving: the global tokens of each path, whether the
    disaggregated generation matches same-pod up to the ownership swap,
    the int8 agreement, every rank's launches and the cache leaves that
    crossed as int8 (a leaf of fewer than ``compression.BLOCK`` values
    crosses raw)."""
    ranks = spawn_world(serve_rank, PODS * DATA * TP, device, prompt_len)
    tokens = gather(ranks)
    ref = swap_halves(tokens["same_pod"])
    return {"tokens": tokens, "same": bool((ref == tokens["disaggregated"]).all()),
            "int8_agreement": float(np.mean(ref == tokens["int8"])),
            "launches": [r["launches"] for r in ranks],
            "cache_leaves": ranks[0]["cache_leaves"], "int8_leaves": ranks[0]["int8_leaves"]}


def report(res: dict) -> None:
    """The reference's lines, and one more: the leaves that crossed as
    int8."""
    print("prefill done; first sampled token per request:", res["tokens"]["prefill"])
    print(f"disaggregated generation matches same-pod (mod ownership swap): "
          f"{res['same']}")
    print(f"int8 KV transfer token agreement: {res['int8_agreement']*100:.0f}% "
          f"(4x wire bytes saved)")
    print(f"int8 on the wire: {len(res['int8_leaves'])} of {len(res['cache_leaves'])} cache "
          f"leaves a rank ({', '.join(res['int8_leaves']) or 'none'}; fewer than "
          f"{compression.BLOCK} values cross raw)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--prompt-len", type=int, default=S,
                    help="prompts of 128 tokens or more take the flash kernel")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    res = run(args.device, args.prompt_len)
    report(res)
    assert res["same"]
    return res


if __name__ == "__main__":
    main()
