"""Quickstart: the HetCCL hierarchical collectives as a library, in PyTorch.

Runs 8 processes arranged as 2 pods x (2 data x 2 model) ranks over
gloo (on the GPU all 8 share the one card), and shows the paper's core
move — the same all-reduce, scheduled flat vs hierarchically — plus the
cost model predicting why it matters at real pod sizes.  The port of
``examples/quickstart.py``.

    python examples/torch_quickstart.py                 # on the GPU
    python examples/torch_quickstart.py --device cpu
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import CommConfig, cost_model, hier_psum, tpu_multipod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import (TEST_SHAPE, init_world, mesh_coords,  # noqa: E402
                                     runtime_for_groups, spawn_world)
from repro_torch.models.model import resolve_device  # noqa: E402

PODS, DATA, TP = TEST_SHAPE
# the four syncs: name -> CommConfig fields
SYNCS = {"flat": dict(mode="flat"),
         "hier": dict(mode="hier"),
         "hier_pipelined": dict(mode="hier_pipelined", n_chunks=4),
         "int8": dict(mode="hier", compression="int8")}


def gradients() -> np.ndarray:
    """The (8, 65536) f32 gradients of the reference's quickstart."""
    return np.random.default_rng(0).normal(size=(8, 1 << 16)).astype(np.float32)


def sync_rank(rank: int, device: str) -> dict:
    """One rank: its (pod, data) index's rows of ``gradients()`` (the
    reference's ``P(("pod", "data"))``), synced by each of SYNCS over the
    data-parallel groups at its model index.  Returns the synced rows and
    the kernel launches of each sync."""
    dev = resolve_device(device)
    init_world(dev, "gloo")
    try:
        rt = runtime_for_groups(pods=PODS, data_per_pod=DATA, tp=TP)
        pod, data, _ = mesh_coords(rank, DATA, TP)
        rows = gradients().shape[0] // (PODS * DATA)
        index = pod * DATA + data
        mine = torch.from_numpy(gradients()[index * rows:(index + 1) * rows]).to(dev)
        out, launches = {}, {}
        for name, fields in SYNCS.items():
            cfg = CommConfig(pod_group=rt.pod_group, intra_group=rt.data_group,
                             dp_group=rt.dp_group, **fields)
            before = ops.launch_counts()
            out[name] = hier_psum(mine.clone(), cfg).cpu()
            launches[name] = {k: v - before[k] for k, v in ops.launch_counts().items()
                              if v != before[k]}
        return {"synced": out, "launches": launches}
    finally:
        torch.distributed.destroy_process_group()


def comparison_lines(synced: dict) -> list[str]:
    """The reference's three comparison lines."""
    flat, hier = synced["flat"], synced["hier"]
    pipe, comp = synced["hier_pipelined"], synced["int8"]
    rel = float(torch.mean(torch.abs(flat - comp) / (torch.abs(flat) + 1e-3)))
    return [f"flat == hier: {bool(torch.allclose(flat, hier, atol=1e-4))}",
            f"flat == hier_pipelined: {bool(torch.allclose(flat, pipe, atol=1e-4))}",
            f"int8-compressed DCN hop mean rel err: {rel:.4f}"]


def cost_model_lines() -> list[str]:
    """Why it matters at scale: the cost model on 2 x 256-chip TPU v5e
    pods (the reference's topology; a prediction, not a measurement)."""
    topo = tpu_multipod(2, 256)
    n = 256 << 20  # 256 MiB of gradients per chip
    est = cost_model.estimate_hier_collective(topo, "all_reduce", n, n_chunks=8)
    host = cost_model.flat_host_forwarding_time(topo, "all_reduce", n)
    return ["",
            f"2x256-chip all-reduce of {n >> 20} MiB/chip:",
            f"  hierarchical (pipelined): {est.pipelined_s * 1e3:8.1f} ms",
            f"  hierarchical (sequential):{est.sequential_s * 1e3:8.1f} ms",
            f"  host-forwarding baseline: {host * 1e3:8.1f} ms",
            f"  speedup vs host-forwarding: {host / est.pipelined_s:.1f}x"]


def run(device: str) -> dict:
    """The 8 ranks' syncs: rank 0's synced rows, every rank's launches and
    the lines to print."""
    ranks = spawn_world(sync_rank, PODS * DATA * TP, device)
    return {"synced": ranks[0]["synced"], "launches": [r["launches"] for r in ranks],
            "lines": comparison_lines(ranks[0]["synced"]) + cost_model_lines()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    res = run(args.device)
    for line in res["lines"]:
        print(line)
    return res


if __name__ == "__main__":
    main()
