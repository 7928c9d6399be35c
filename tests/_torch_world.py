"""The spawned-world harness of the port's multi-rank parity tests.

A test module that holds a multi-rank path against the JAX package runs
two sides once, in a module fixture: the reference on host devices, in
subprocesses that run the test module as a script (one per part, side by
side), and the port on gloo ranks, one spawned process each.  Both sides
write .npz files into one directory, which the fixture loads.
``tests/test_torch_tp.py`` started this harness; it and the SSM
families' files (``test_torch_ssm_tp.py``, ``test_torch_ssm_train.py``,
``test_torch_hybrid.py``) share it from here.
"""

from __future__ import annotations

import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def flat_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict of arrays -> {"a/b/c": numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def nest(flat) -> dict:
    """The inverse of ``flat_tree`` (also of a loaded .npz)."""
    tree: dict = {}
    for path in flat:
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = np.asarray(flat[path])
    return tree


def run_world(script: str, tmp: pathlib.Path, jax_parts: tuple[str, ...], n_devices: int,
              rank_fn, world: int, timeout: int = 300,
              ranks_after_jax: bool = False) -> tuple[dict, list]:
    """Run ``python script tmp part`` for each of ``jax_parts`` on
    ``n_devices`` host devices (each writes jax_<part>.npz into ``tmp``),
    and ``rank_fn(rank, store_path, tmp)`` on ``world`` spawned ranks (each
    writes rank<r>.npz), all at once, or the ranks once the parts are done
    (``ranks_after_jax``: the ranks read the reference's outputs).  Returns
    (the parts' arrays merged, each rank's arrays).  Every process is
    waited for or killed."""
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    jax_procs = [subprocess.Popen([sys.executable, script, str(tmp), part], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for part in jax_parts]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_fn, args=(r, str(tmp / "store"), str(tmp)))
             for r in range(world)]
    try:
        jax_outs = [jp.communicate(timeout=timeout)[0] for jp in jax_procs] \
            if ranks_after_jax else None
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=timeout)
        jax_outs = jax_outs or [jp.communicate(timeout=timeout)[0] for jp in jax_procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for jp in jax_procs:
            if jp.poll() is None:
                jp.kill()
                jp.wait(timeout=10)
    for jp, out in zip(jax_procs, jax_outs):
        assert jp.returncode == 0, out.decode()[-3000:]
    assert [p.exitcode for p in procs] == [0] * world
    want: dict = {}
    for part in jax_parts:
        want.update(np.load(tmp / f"jax_{part}.npz"))
    return want, [np.load(tmp / f"rank{r}.npz") for r in range(world)]
