"""End-to-end driver: train a ~100M-param LM for a few hundred steps, in
PyTorch.

Wraps ``repro_torch.launch.train`` with a purpose-built ~100M dense
config (a scaled member of the qwen2.5 family).  Defaults are sized so
the run finishes on a CPU box; pass --hundred-m --steps 300 for the
full-size variant of the deliverable.  ``--mesh test`` trains on 8
processes as 2 pods x 2 data x 2 model ranks over gloo (on the GPU all 8
share the one card).  The port of ``examples/train_lm.py``.

    python examples/torch_train_lm.py --steps 200                 # on the GPU
    python examples/torch_train_lm.py --hundred-m --steps 300
    python examples/torch_train_lm.py --mesh test --mode fsdp --compression int8
    python examples/torch_train_lm.py --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import base as cfg_base  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.mesh import TEST_SHAPE, spawn_world  # noqa: E402
from repro_torch.models.model import resolve_device  # noqa: E402

PODS, DATA, TP = TEST_SHAPE


def make_config(hundred_m: bool) -> cfg_base.ModelConfig:
    if hundred_m:  # ~105M params (GPT-2-small-ish, qwen-style blocks)
        return cfg_base.ModelConfig(
            name="demo-100m", family="dense", n_layers=12, d_model=768,
            n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32768,
            qkv_bias=True, rope_theta=1e4, tie_embeddings=True)
    return cfg_base.ModelConfig(  # ~22M: finishes quickly on CPU
        name="demo-20m", family="dense", n_layers=6, d_model=384,
        n_heads=6, n_kv_heads=2, d_ff=1024, vocab_size=16384,
        qkv_bias=True, rope_theta=1e4, tie_embeddings=True)


def register(cfg: cfg_base.ModelConfig) -> None:
    """Register ``cfg`` on the fly so the shared driver resolves it."""
    registry._MODULES[cfg.name] = type(
        "M", (), {"full": staticmethod(lambda: cfg),
                  "smoke": staticmethod(lambda: cfg)})


def train_argv(cfg, args) -> list[str]:
    """The driver's arguments: the reference example's, and the port's
    device and (``--mesh test``) world."""
    argv = ["--arch", cfg.name, "--steps", str(args.steps), "--mode", args.mode,
            "--global-batch", "8", "--seq", "256", "--lr", "1e-3",
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100", "--device", args.device]
    if args.compression:
        argv += ["--compression", args.compression]
    if args.mesh == "test":
        argv += ["--pods", str(PODS), "--tp", str(TP), "--dist-backend", "gloo"]
    return argv


def train(hundred_m: bool, argv: list[str]) -> list[float]:
    """Register the config and run the driver: the losses per step."""
    register(make_config(hundred_m))
    from repro_torch.launch import train as train_mod
    return train_mod.main(argv)


def mesh_rank(rank: int, hundred_m: bool, argv: list[str]) -> list[float]:
    """One rank of ``--mesh test``; rank 0 prints."""
    with open(os.devnull, "w") as quiet, \
            contextlib.redirect_stdout(quiet) if rank else contextlib.nullcontext():
        return train(hundred_m, argv)


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--mesh", default="none", choices=["none", "test"])
    ap.add_argument("--mode", default="hier")
    ap.add_argument("--compression", default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_demo_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cfg = make_config(args.hundred_m)
    n = cfg.param_count()
    print(f"model {cfg.name}: {n/1e6:.1f}M params")
    targs = train_argv(cfg, args)
    if args.mesh == "test":
        losses = spawn_world(mesh_rank, PODS * DATA * TP, args.hundred_m, targs)[0]
    else:
        losses = train(args.hundred_m, targs)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}) over {len(losses)} steps")
    assert losses[-1] < losses[0], "training must make progress"
    return losses


if __name__ == "__main__":
    main()
