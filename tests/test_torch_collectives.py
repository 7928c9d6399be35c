"""The port's gradient-sync layers against the JAX package's.

* The shared-scale codec's plain versions (``amax_block``,
  ``quant_scaled``) are bit-equal to the Pallas kernels in interpret mode,
  NaN and infinite blocks included.
* The codec on one rank (``int8_encode``, ``int8_transfer``,
  ``compressed_psum``) is bit-equal to the jitted JAX functions under
  ``shard_map`` on a one-device ("pod",) mesh (int8); bf16 is equal too.
* The schedule IR and the packed layout are copies: the same steps and
  the same slots, offsets and padded sizes.
* ``hier_psum`` / ``tree_hier_psum`` on 4 gloo ranks (2 pods x 2 data)
  against JAX on 4 virtual CPU devices, mesh (pod 2, data 2), for
  ``flat``, ``hier``, ``hier_pipelined`` (1, 2 and 4 chunks) and
  ``hier_border_rs``.  int8 is bit-equal; f32 agrees within 1e-6
  relative (of the largest value); bf16 within one bf16 ulp of the
  summands' scale per two terms that one collective sums (see
  ``bf16_ulps``).  Every rank holds the same result, and
  ``hier_pipelined`` runs exactly k pod reductions for k chunks.  The
  JAX side runs this file as a script in a subprocess with 4 host
  devices.
* ReduceScatterH and AllGatherH on the same 4 ranks:
  ``hier_psum_scatter`` (no codec, bf16, int8; int8 bit-equal) and its
  round trip through ``hier_all_gather_flat``, ``hier_all_gather``
  (``flat``, ``hier``; along dims 0 and 1), ``pipelined_all_gather`` and
  ``c2c_cpy`` (all three exact), ``pipelined_hier_psum(use_ring=True)``
  against the reference's and against ``use_ring=False``, and the ZeRO-1
  layer: ``zero1_local_shard``, then ``tree_hier_psum_scatter`` ->
  ``tree_hier_unscatter`` on a tree of f32, bf16 and list leaves, its
  ``_zero1_layout`` the reference's.
"""

import dataclasses
import datetime
import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np

CASE_SIZE = 5003                     # odd: pads for the intra shard and the codec
MODES = ("flat", "hier")
CODECS = (None, "bf16", "int8")
WEIGHTS = (None, (0.5, 1.5))
DTYPES = ("f32", "bf16")
CHUNKS = (1, 2, 4)
# (mode, codec, cluster weights, dtype, n_chunks)
CASES = ([(m, c, w, d, 4) for m in MODES for c in CODECS for w in WEIGHTS for d in DTYPES]
         + [("hier_pipelined", c, w, d, k) for k in CHUNKS for c in CODECS
            for w in WEIGHTS for d in DTYPES]
         + [("hier_border_rs", c, w, d, 4) for c in (None, "bf16") for w in WEIGHTS
            for d in DTYPES])
TREE_CASES = [("hier", "int8"), ("hier", None), ("flat", None), ("hier", "bf16"),
              ("hier_pipelined", "int8"), ("hier_border_rs", "bf16")]
WORLD = 4
# (codec, dtype) of the ReduceScatterH cases
SCATTER_CASES = [(c, d) for c in CODECS for d in DTYPES]
GATHER_CASES = [("flat", 0), ("hier", 0), ("hier", 1)]
RING_CHUNKS = (1, 4)
ZERO_CODECS = (None, "int8")
OVERLAP_CODECS = CODECS
OVERLAP_CAP = 1500                   # bytes: 6 buckets of the overlap tree
OVERLAP_LEAVES = (("embed", "bf16"), ("final_norm/scale", "f32"), ("head", "bf16"),
                  ("layers/a", "f32"), ("layers/b", "f32"))
GATHER_DIMS = (0, 1)
EF_CODECS = ("bf16", "int8")


def case_id(case) -> str:
    m, c, w, d, k = case
    chunks = f"-k{k}" if m == "hier_pipelined" else ""
    return f"{m}{chunks}-{c}-{'w' if w else 'even'}-{d}"


def rank_input(rank: int) -> np.ndarray:
    x = np.random.default_rng(1000 + rank).normal(size=CASE_SIZE).astype(np.float32) * 3
    x[1024:2048] = 0.0                      # an all-zero block
    return x


def rank_matrix(rank: int) -> np.ndarray:
    """A (2, 37) shard for the all-gathers."""
    return rank_input(rank)[:74].reshape(2, 37)


def _on_bf16_grid(a: np.ndarray) -> np.ndarray:
    return (a.view(np.uint32) & 0xFFFF0000).view(np.float32)


def rank_overlap_tree(rank: int) -> dict:
    """A param-shaped gradient tree: two head keys (an f32 norm, a bf16
    leaf), a stacked 3-layer subtree of f32 leaves and a bf16 tail key.
    At OVERLAP_CAP its buckets are: final_norm, head, one per layer (in
    reverse), embed."""
    rng = np.random.default_rng(3000 + rank)
    return {"embed": _on_bf16_grid(rng.normal(size=(37, 11)).astype(np.float32)),
            "final_norm": {"scale": rng.normal(size=300).astype(np.float32)},
            "head": _on_bf16_grid(rng.normal(size=(50, 7)).astype(np.float32)),
            "layers": {"a": rng.normal(size=(3, 129)).astype(np.float32),
                       "b": rng.normal(size=(3, 20, 7)).astype(np.float32)}}


def gather_cotangent(rank: int, dim: int) -> np.ndarray:
    """The cotangent of a (2, 37) shard gathered over 2 data ranks."""
    shape = (4, 37) if dim == 0 else (2, 74)
    return np.random.default_rng(4000 + 10 * rank + dim).normal(size=shape).astype(np.float32)


def rank_tree(rank: int) -> dict:
    """A small gradient tree: an f32 leaf, a bf16 leaf (as f32 values
    already on the bf16 grid) and a stacked (L, ...) f32 leaf."""
    rng = np.random.default_rng(2000 + rank)
    bf = rng.normal(size=(37, 11)).astype(np.float32)
    bf = (bf.view(np.uint32) & 0xFFFF0000).view(np.float32)
    return {"a": rng.normal(size=(300, 7)).astype(np.float32),
            "b": bf,
            "layers": rng.normal(size=(3, 129)).astype(np.float32)}


# ---------------------------------------------------------------------------
# the JAX side, run as a script with 4 host devices
# ---------------------------------------------------------------------------

def _jax_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import collectives as jcoll
    from repro.parallel.sharding import shard_map

    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    spec = P(("pod", "data"))
    xs = np.stack([rank_input(r) for r in range(WORLD)])
    trees = [rank_tree(r) for r in range(WORLD)]
    res = {}
    for case in CASES:
        mode, codec, w, dt, k = case
        cfg = jcoll.CommConfig(mode=mode, pod_axis="pod", intra_axis="data",
                               n_chunks=k, compression=codec, cluster_weights=w)
        jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
        fn = jax.jit(shard_map(lambda x, cfg=cfg: jcoll.hier_psum(x[0], cfg)[None],
                               mesh=mesh, in_specs=spec, out_specs=spec))
        res[case_id(case)] = np.asarray(fn(jnp.asarray(xs, jdt)).astype(jnp.float32))
    for mode, codec in TREE_CASES:
        cfg = jcoll.CommConfig(mode=mode, pod_axis="pod", intra_axis="data",
                               compression=codec)
        tree = {"a": jnp.asarray(np.stack([t["a"] for t in trees])),
                "b": jnp.asarray(np.stack([t["b"] for t in trees]), jnp.bfloat16),
                "layers": jnp.asarray(np.stack([t["layers"] for t in trees]))}

        def body(t, cfg=cfg):
            out = jcoll.tree_hier_psum(jax.tree.map(lambda a: a[0], t), cfg)
            return jax.tree.map(lambda a: a[None], out)

        out = jax.jit(shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec))(tree)
        for k, v in out.items():
            res[f"tree-{mode}-{codec}-{k}"] = np.asarray(v.astype(jnp.float32))
    _jax_gather_cases(mesh, spec, xs, trees, res)
    _jax_overlap_cases(mesh, spec, res)
    np.savez(os.path.join(out_dir, "jax.npz"), **res)


def _jax_overlap_cases(mesh, spec, res) -> None:
    """tree_hier_psum_overlap, fsdp_gather (forward and gradient) and
    psum_ef (two steps, the residual carried) on the (pod 2, data 2) mesh."""
    import jax
    import jax.numpy as jnp

    from repro.core import collectives as jcoll
    from repro.core import compression as jcomp
    from repro.core import overlap as joverlap
    from repro.parallel.sharding import fsdp_gather as jgather
    from repro.parallel.sharding import shard_map

    def run(fn, *args, n_out=1):
        out_specs = spec if n_out == 1 else (spec,) * n_out
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * len(args),
                                 out_specs=out_specs, check_vma=False))(*args)

    trees = [rank_overlap_tree(r) for r in range(WORLD)]
    stacked = jax.tree.map(lambda *a: np.stack(a), *trees)
    tree = jax.tree.map(jnp.asarray, stacked)
    tree["embed"] = tree["embed"].astype(jnp.bfloat16)
    tree["head"] = tree["head"].astype(jnp.bfloat16)
    for codec in OVERLAP_CODECS:
        cfg = jcoll.CommConfig(mode="hier", pod_axis="pod", intra_axis="data",
                               compression=codec)

        def body(t, cfg=cfg):
            out = joverlap.tree_hier_psum_overlap(jax.tree.map(lambda a: a[0], t), cfg,
                                                  cap_bytes=OVERLAP_CAP)
            return jax.tree.map(lambda a: a[None], out)

        out = run(body, tree)
        for name, _ in OVERLAP_LEAVES:
            leaf = out
            for k in name.split("/"):
                leaf = leaf[k]
            res[f"overlap-{codec}-{name}"] = np.asarray(leaf.astype(jnp.float32))
    ms = jnp.asarray(np.stack([rank_matrix(r) for r in range(WORLD)]))
    for dim in GATHER_DIMS:
        cts = jnp.asarray(np.stack([gather_cotangent(r, dim) for r in range(WORLD)]))

        def gather_vjp(x, c, dim=dim):
            y, vjp = jax.vjp(lambda p: jgather({"w": p}, {"w": dim}, "data")["w"], x[0])
            return y[None], vjp(c[0])[0][None]

        y, g = run(gather_vjp, ms, cts, n_out=2)
        res[f"fsdp-gather-{dim}"], res[f"fsdp-grad-{dim}"] = np.asarray(y), np.asarray(g)
    x1 = jnp.asarray(np.stack([rank_input(r) for r in range(WORLD)]))
    x2 = jnp.asarray(np.stack([rank_input(r + WORLD) * 0.3 for r in range(WORLD)]))
    for codec in EF_CODECS:
        def ef(a, b, codec=codec):
            s1, r1 = jcomp.psum_ef(a[0], jnp.zeros_like(a[0]), "pod", codec)
            s2, r2 = jcomp.psum_ef(b[0], r1, "pod", codec)
            return s1[None], r1[None], s2[None], r2[None]

        for name, v in zip(("s1", "r1", "s2", "r2"), run(ef, x1, x2, n_out=4)):
            res[f"ef-{codec}-{name}"] = np.asarray(v)


def _jax_gather_cases(mesh, spec, xs, trees, res) -> None:
    import jax
    import jax.numpy as jnp

    from repro.core import collectives as jcoll
    from repro.core import pipelined as jpipe
    from repro.core import primitives as jprim
    from repro.parallel.sharding import shard_map

    def run(fn, x, out_specs=spec):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=spec, out_specs=out_specs,
                                 check_vma=False))(x)

    for codec, dt in SCATTER_CASES:
        cfg = jcoll.CommConfig(mode="hier", pod_axis="pod", intra_axis="data",
                               compression=codec)
        x = jnp.asarray(xs, jnp.float32 if dt == "f32" else jnp.bfloat16)
        res[f"scatter-{codec}-{dt}"] = np.asarray(run(
            lambda v, cfg=cfg: jcoll.hier_psum_scatter(v[0], cfg)[None], x)
            .astype(jnp.float32))
        res[f"roundtrip-{codec}-{dt}"] = np.asarray(run(
            lambda v, cfg=cfg: jcoll.hier_all_gather_flat(
                jcoll.hier_psum_scatter(v[0], cfg), cfg, CASE_SIZE)[None], x)
            .astype(jnp.float32))
    ms = jnp.asarray(np.stack([rank_matrix(r) for r in range(WORLD)]))
    for mode, dim in GATHER_CASES:
        cfg = jcoll.CommConfig(mode=mode, pod_axis="pod", intra_axis="data")
        res[f"gather-{mode}-{dim}"] = np.asarray(run(
            lambda v, cfg=cfg, dim=dim: jcoll.hier_all_gather(v[0], cfg, gather_dim=dim)[None],
            ms))
    cfg = jcoll.CommConfig(mode="hier", pod_axis="pod", intra_axis="data")
    res["pipelined-gather"] = np.asarray(run(
        lambda v: jpipe.pipelined_all_gather(v[0], cfg)[None], ms))
    res["c2c-cpy"] = np.asarray(run(lambda v: jprim.c2c_cpy(v[0], "pod")[None],
                                    jnp.asarray(xs[:, :37])))
    for k in RING_CHUNKS:
        cfg = jcoll.CommConfig(mode="hier_pipelined", pod_axis="pod", intra_axis="data",
                               n_chunks=k)
        res[f"ring-{k}"] = np.asarray(run(
            lambda v, cfg=cfg: jpipe.pipelined_hier_psum(v[0], cfg, use_ring=True)[None],
            jnp.asarray(xs)))
    tree = {"a": jnp.asarray(np.stack([t["a"] for t in trees])),
            "b": jnp.asarray(np.stack([t["b"] for t in trees]), jnp.bfloat16),
            "layers": jnp.asarray(np.stack([t["layers"] for t in trees]))}
    for codec in ZERO_CODECS:
        cfg = jcoll.CommConfig(mode="hier", pod_axis="pod", intra_axis="data",
                               compression=codec)

        def body(t, cfg=cfg):
            local = jax.tree.map(lambda a: a[0], t)
            boot, _ = jcoll.zero1_local_shard(local, cfg)
            shard, meta = jcoll.tree_hier_psum_scatter(local, cfg)
            out = jcoll.tree_hier_unscatter(shard, meta, cfg)
            return boot[None], shard[None], jax.tree.map(lambda a: a[None], out)

        boot, shard, out = run(body, tree, out_specs=(spec, spec, spec))
        res[f"zero-{codec}-boot"] = np.asarray(boot)
        res[f"zero-{codec}-shard"] = np.asarray(shard)
        for k, v in out.items():
            res[f"zero-{codec}-{k}"] = np.asarray(v.astype(jnp.float32))


# ---------------------------------------------------------------------------
# the port's side: 4 gloo ranks
# ---------------------------------------------------------------------------

def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from repro_torch.core import collectives as tcoll
    from repro_torch.core import compression as tcomp
    from repro_torch.core import primitives as tprim
    from repro_torch.launch.mesh import runtime_for_groups

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        rt = runtime_for_groups(pods=2, data_per_pod=2)
        res = {}
        # count the pod reductions: the int8 reduce ring, or the native
        # all-reduce over the pod group
        pod_reductions = [0]

        def counted(fn):
            def wrapped(*args, **kwargs):
                pod_reductions[0] += 1
                return fn(*args, **kwargs)
            return wrapped

        tcomp._ring_int8_sum = counted(tcomp._ring_int8_sum)
        tprim.c2c_red = counted(tprim.c2c_red)
        x = torch.from_numpy(rank_input(rank))
        for case in CASES:
            mode, codec, w, dt, k = case
            cfg = tcoll.CommConfig(mode=mode, pod_group=rt.pod_group,
                                   intra_group=rt.data_group, dp_group=rt.dp_group,
                                   n_chunks=k, compression=codec, cluster_weights=w)
            xt = x.clone() if dt == "f32" else x.to(torch.bfloat16)   # consumed
            pod_reductions[0] = 0
            out = tcoll.hier_psum(xt, cfg)
            assert out.dtype == xt.dtype and out.shape == xt.shape
            res[case_id(case)] = out.float().numpy()
            res[f"pod-reductions-{case_id(case)}"] = np.array(pod_reductions[0])
        t = rank_tree(rank)
        for mode, codec in TREE_CASES:
            cfg = tcoll.CommConfig(mode=mode, pod_group=rt.pod_group,
                                   intra_group=rt.data_group, dp_group=rt.dp_group,
                                   compression=codec)
            leaves = [torch.from_numpy(t["a"]),
                      torch.from_numpy(t["b"]).to(torch.bfloat16),
                      [torch.from_numpy(row) for row in t["layers"]]]
            out = tcoll.tree_hier_psum(leaves, cfg)
            for k, v in zip(("a", "b", "layers"), out):
                res[f"tree-{mode}-{codec}-{k}"] = v.float().numpy()
        _gloo_gather_cases(rank, rt, res)
        _gloo_overlap_cases(rank, rt, res)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _gloo_gather_cases(rank: int, rt, res: dict) -> None:
    import torch

    from repro_torch.core import collectives as tcoll
    from repro_torch.core import pipelined as tpipe
    from repro_torch.core import primitives as tprim

    def config(**kw):
        return tcoll.CommConfig(pod_group=rt.pod_group, intra_group=rt.data_group,
                                dp_group=rt.dp_group, **kw)

    x = torch.from_numpy(rank_input(rank))
    for codec, dt in SCATTER_CASES:
        cfg = config(mode="hier", compression=codec)
        tdt = torch.float32 if dt == "f32" else torch.bfloat16
        shard = tcoll.hier_psum_scatter(x.to(tdt, copy=True), cfg)
        assert shard.dtype == tdt
        res[f"scatter-{codec}-{dt}"] = shard.float().numpy()
        out = tcoll.hier_all_gather_flat(tcoll.hier_psum_scatter(x.to(tdt, copy=True), cfg),
                                         cfg, CASE_SIZE)
        res[f"roundtrip-{codec}-{dt}"] = out.float().numpy()
    m = torch.from_numpy(rank_matrix(rank))
    for mode, dim in GATHER_CASES:
        res[f"gather-{mode}-{dim}"] = tcoll.hier_all_gather(m, config(mode=mode),
                                                            gather_dim=dim).numpy()
    res["pipelined-gather"] = tpipe.pipelined_all_gather(m, config(mode="hier")).numpy()
    res["c2c-cpy"] = tprim.c2c_cpy(x[:37].clone(), rt.pod_group).numpy()
    for k in RING_CHUNKS:
        cfg = config(mode="hier_pipelined", n_chunks=k)
        res[f"ring-{k}"] = tpipe.pipelined_hier_psum(x.clone(), cfg, use_ring=True).numpy()
        res[f"no-ring-{k}"] = tpipe.pipelined_hier_psum(x.clone(), cfg).numpy()
    t = rank_tree(rank)
    for codec in ZERO_CODECS:
        cfg = config(mode="hier", compression=codec)

        def leaves():
            return [torch.from_numpy(t["a"]).clone(),
                    torch.from_numpy(t["b"]).to(torch.bfloat16),
                    [torch.from_numpy(row).clone() for row in t["layers"]]]

        boot, bmeta = tcoll.zero1_local_shard(leaves(), cfg)
        shard, meta = tcoll.tree_hier_psum_scatter(leaves(), cfg)
        assert bmeta == meta and shard.dtype == boot.dtype == torch.float32
        assert shard.numel() == meta.padded // 2
        res[f"zero-{codec}-boot"] = boot.numpy()
        res[f"zero-{codec}-shard"] = shard.numpy()
        for k, v in zip(("a", "b", "layers"), tcoll.tree_hier_unscatter(shard, meta, cfg)):
            res[f"zero-{codec}-{k}"] = v.float().numpy()


def _gloo_overlap_cases(rank: int, rt, res: dict) -> None:
    import torch

    from repro_torch.core import collectives as tcoll
    from repro_torch.core import compression as tcomp
    from repro_torch.core import overlap as toverlap
    from repro_torch.parallel.sharding import fsdp_gather

    def config(**kw):
        return tcoll.CommConfig(pod_group=rt.pod_group, intra_group=rt.data_group,
                                dp_group=rt.dp_group, **kw)

    t = rank_overlap_tree(rank)
    for codec in OVERLAP_CODECS:
        tree = {"embed": torch.from_numpy(t["embed"]).to(torch.bfloat16),
                "final_norm": {"scale": torch.from_numpy(t["final_norm"]["scale"]).clone()},
                "head": torch.from_numpy(t["head"]).to(torch.bfloat16),
                "layers": [{k: torch.from_numpy(v[i]).clone() for k, v in t["layers"].items()}
                           for i in range(3)]}
        out = toverlap.tree_hier_psum_overlap(tree, config(mode="hier", compression=codec),
                                              cap_bytes=OVERLAP_CAP)
        assert out is tree and out["embed"].dtype == torch.bfloat16
        flat = {"embed": out["embed"], "final_norm/scale": out["final_norm"]["scale"],
                "head": out["head"],
                "layers/a": torch.stack([lp["a"] for lp in out["layers"]]),
                "layers/b": torch.stack([lp["b"] for lp in out["layers"]])}
        for name, v in flat.items():
            res[f"overlap-{codec}-{name}"] = v.float().numpy()
    for dim in GATHER_DIMS:
        x = torch.from_numpy(rank_matrix(rank)).requires_grad_(True)
        y = fsdp_gather({"w": x}, {"w": dim}, rt.data_group)["w"]
        y.backward(torch.from_numpy(gather_cotangent(rank, dim)))
        res[f"fsdp-gather-{dim}"] = y.detach().numpy()
        res[f"fsdp-grad-{dim}"] = x.grad.numpy()
    x1 = torch.from_numpy(rank_input(rank))
    x2 = torch.from_numpy(rank_input(rank + WORLD) * 0.3)
    for codec in EF_CODECS:
        s1, r1 = tcomp.psum_ef(x1, torch.zeros_like(x1), rt.pod_group, codec)
        s2, r2 = tcomp.psum_ef(x2, r1, rt.pod_group, codec)
        for name, v in zip(("s1", "r1", "s2", "r2"), (s1, r1, s2, r2)):
            assert v.dtype == torch.float32 and v.shape == x1.shape
            res[f"ef-{codec}-{name}"] = v.numpy()


if __name__ == "__main__":
    _jax_main(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import collectives as jcoll  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import overlap as joverlap  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.kernels import quant as jquant  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro.parallel import sharding as jshard  # noqa: E402
from repro.parallel.sharding import shard_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.core import collectives as tcoll  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import overlap as toverlap  # noqa: E402
from repro_torch.core import packing as tpack  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.kernels import quant as tquant  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.model import param_specs  # noqa: E402
from repro_torch.parallel import sharding as tshard  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, JDT[dt])
    return j, to_tensor(np.asarray(j), "cpu")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(jnp.asarray(t, jnp.float32) if t.dtype == jnp.bfloat16 else t)


# ---------------------------------------------------------------------------
# plain kernels against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _edge_payload() -> tuple[np.ndarray, np.ndarray]:
    """Five 1024-blocks: random, all zero, .5 ties at a power-of-two scale,
    values on and beyond +-127 s, random again; and a scale vector with a
    zero and a negative entry."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=5 * 1024).astype(np.float32) * 4
    x[1024:2048] = 0
    k = np.arange(1024) % 300 - 150
    x[2048:3072] = (k + 0.5) * 0.25
    x[3072:4096] = np.where(np.arange(1024) % 2, 127.0, -200.0) * 0.125
    x[3072] = -127 * 0.125
    scale = (np.abs(x.reshape(5, 1024)).max(axis=1) / 127).astype(np.float32)
    scale[2], scale[3] = 0.25, 0.125
    scale[1], scale[4] = 0.0, -1.0
    return x, scale


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_amax_block_bit_equal_to_pallas(dt):
    x, _ = _edge_payload()
    jx, tx = _pair(x, dt)
    want = jquant.amax_block_call(jnp.asarray(jx, jnp.float32), interpret=True)
    np.testing.assert_array_equal(tquant.amax_block_call(tx).numpy(), np.asarray(want))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quant_scaled_bit_equal_to_pallas(dt):
    x, scale = _edge_payload()
    jx, tx = _pair(x, dt)
    want = jquant.quant_scaled_call(jnp.asarray(jx, jnp.float32), jnp.asarray(scale),
                                    interpret=True)
    got = tquant.quant_scaled_call(tx, torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[3].abs() == 127).any() and got[1].eq(0).all()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_codec_nan_and_inf_blocks_match_pallas(dt):
    """A NaN propagates through the block max and takes scale 1; a NaN
    quotient (NaN input, inf / inf) quantizes to 0, infinities clip."""
    x = np.random.default_rng(6).normal(size=4 * 1024).astype(np.float32)
    x[5], x[1024 + 7], x[2048 + 9], x[3072 + 1] = np.nan, np.inf, -np.inf, np.nan
    x[3072 + 2] = np.inf
    jx, tx = _pair(x, dt)
    jf = jnp.asarray(jx, jnp.float32)
    want = np.asarray(jquant.amax_block_call(jf, interpret=True))
    got = tquant.amax_block_call(tx).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[[0, 3]]).all() and np.isinf(got[[1, 2]]).all()
    for scale in (got / 127, np.array([1.0, np.inf, 0.5, np.nan], np.float32)):
        want = jquant.quant_scaled_call(jf, jnp.asarray(scale), interpret=True)
        q = tquant.quant_scaled_call(tx, torch.from_numpy(scale))
        np.testing.assert_array_equal(q.numpy(), np.asarray(want))
    jq, js = jquant.quant_int8_call(jf, interpret=True)      # the local-scale codec
    q, s = tquant.quant_int8_call(tx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 7, 1023, 1025, 8191, 3 * 1024 + 13])
def test_amax_block_ragged_bit_equal_to_pallas(n, dt):
    """The plain version the CUDA kernels are held to, at the ragged sizes
    that end in the vector kernel's epilogue, against the Pallas kernel on
    the zero-padded payload."""
    x = np.random.default_rng(n).normal(size=n).astype(np.float32) * 3
    jx, tx = _pair(x, dt)
    padded = jnp.concatenate([jnp.asarray(jx, jnp.float32),
                              jnp.zeros(((-n) % 1024,), jnp.float32)])
    want = jquant.amax_block_call(padded, interpret=True)
    np.testing.assert_array_equal(tquant.amax_block_call(tx).numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1000, 3 * 1024 + 17])
def test_codec_ragged_tail_counts_as_zeros(n):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    padded = np.concatenate([x, np.zeros((-n) % 1024, np.float32)])
    amax = tquant.amax_block_call(torch.from_numpy(x))
    np.testing.assert_array_equal(
        amax.numpy(), np.asarray(jquant.amax_block_call(jnp.asarray(padded))))
    q = tquant.quant_scaled_call(torch.from_numpy(x), amax / 127)
    want = jquant.quant_scaled_call(jnp.asarray(padded), jnp.asarray(amax.numpy() / 127))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the codec on one rank against the jitted JAX codec
# ---------------------------------------------------------------------------

def _on_pod_mesh(fn):
    mesh = jax.make_mesh((1,), ("pod",))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P()))


@pytest.mark.parametrize("w", [None, 1.7])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_encode_and_transfer_bit_equal(dt, w):
    x = np.random.default_rng(3).normal(size=4 * 1024 + 300).astype(np.float32)
    x[:1024] = 0
    jx, tx = _pair(x, dt)
    jw = None if w is None else jnp.float32(w)
    tw = None if w is None else torch.tensor(w, dtype=torch.float32)
    jq, js = _on_pod_mesh(lambda a: jcomp.int8_encode(a, "pod", weight=jw))(jx)
    q, s = tcomp.int8_encode(tx, None, weight=tw)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    jout = _on_pod_mesh(lambda a, b: jcomp.int8_transfer(a, b, "pod", x.size, JDT[dt]))(jq, js)
    out = tcomp.int8_transfer(q, s, None, x.size, tx.dtype)
    np.testing.assert_array_equal(_np(out), _np(jout))


@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("w", [None, 0.5])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_compressed_psum_one_rank(codec, w, dt):
    x = np.random.default_rng(4).normal(size=(3, 1111)).astype(np.float32) * 10
    jx, tx = _pair(x, dt)
    jw = None if w is None else jnp.float32(w)
    tw = None if w is None else torch.tensor(w, dtype=torch.float32)
    want = _on_pod_mesh(lambda a: jcomp.compressed_psum(a, "pod", codec, weight=jw))(jx)
    got = tcomp.compressed_psum(tx, None, codec, weight=tw)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# copied layers: the schedule IR and the packed layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("mode", MODES + ("hier_pipelined", "hier_border_rs"))
def test_build_schedule_is_the_reference(mode, codec):
    if (mode, codec) == ("hier_border_rs", "int8"):
        for sched in (jsched, tsched):
            with pytest.raises(ValueError, match="int8"):
                sched.build_schedule("all_reduce", mode, 4, codec)
        return
    for wrap in (lambda s: s, "with_cluster_scale", "with_packing"):
        j = jsched.build_schedule("all_reduce", mode, 4, codec)
        t = tsched.build_schedule("all_reduce", mode, 4, codec)
        if isinstance(wrap, str):
            j, t = getattr(jsched, wrap)(j), getattr(tsched, wrap)(t)
        assert repr(t) == repr(j)            # dataclass reprs: every field


@pytest.mark.parametrize("codec,world", [("int8", 4), (None, 4), ("bf16", 1), ("int8", 1)])
def test_comm_layout_matches_reference(codec, world):
    jm = JaxModel(jax_config("qwen2.5-3b", smoke=True), JaxRuntime())
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    jcfg = jcoll.CommConfig(mode="hier", compression=codec)
    want = jcoll.comm_layout(jax.tree.leaves(shapes), jcfg, world=world)
    tm = Model(get_config("qwen2.5-3b", smoke=True), device="cpu").init(0)
    got = tcoll.comm_layout(tm.train_leaves(), tcoll.CommConfig(mode="hier",
                                                                compression=codec),
                            world=world)
    assert repr(got) == repr(want)


def test_unported_modes_raise():
    """The All2All steps wait for the MoE slice."""
    cfg = tcoll.CommConfig(mode="hier", pod_group=object())
    for step in (tsched.IntraAll2All("start"), tsched.BorderExchange("c2c")):
        with pytest.raises(NotImplementedError, match="MoE"):
            tcoll._exec_step(step, [torch.ones(8)], cfg, tcoll._ExecCtx())


def _jax_tree(tree: dict) -> dict:
    return {"a": jnp.asarray(tree["a"]), "b": jnp.asarray(tree["b"], jnp.bfloat16),
            "layers": jnp.asarray(tree["layers"])}


def _port_leaves(tree: dict) -> list:
    return [torch.from_numpy(tree["a"]), torch.from_numpy(tree["b"]).to(torch.bfloat16),
            [torch.from_numpy(row) for row in tree["layers"]]]


@pytest.mark.parametrize("isize", [1, 2, 4])
def test_zero1_layout_matches_reference(isize):
    """The ZeRO-1 master layout (slots, segments, padded sizes) of a tree of
    f32, bf16 and list leaves, and of the smoke qwen2.5-3b model."""
    got = tcoll._zero1_layout(_port_leaves(rank_tree(0)), isize)
    want = jcoll._zero1_layout(jax.tree.leaves(_jax_tree(rank_tree(0))), isize)
    assert repr(got) == repr(want)
    assert [s.dtype for s in got.segments] == ["float32", "bfloat16"]
    jm = JaxModel(jax_config("qwen2.5-3b", smoke=True), JaxRuntime())
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    tm = Model(get_config("qwen2.5-3b", smoke=True), device="cpu").init(0)
    got = tcoll._zero1_layout(tm.train_leaves(), isize)
    assert repr(got) == repr(jcoll._zero1_layout(jax.tree.leaves(shapes), isize))


def test_zero1_without_groups_matches_jax():
    """With no groups (one rank, one cluster) the bootstrap, the scattered
    sync and the reconstruction against the reference on a one-device
    ("data",) mesh with no pod axis: bit-equal."""
    tree = rank_tree(1)
    mesh = jax.make_mesh((1,), ("data",))
    jcfg = jcoll.CommConfig(mode="hier", pod_axis=None, compression="int8")

    def body(t):
        boot, _ = jcoll.zero1_local_shard(t, jcfg)
        shard, meta = jcoll.tree_hier_psum_scatter(t, jcfg)
        return boot, shard, jcoll.tree_hier_unscatter(shard, meta, jcfg)

    jboot, jshard, jout = jax.jit(shard_map(body, mesh=mesh, in_specs=P(), out_specs=P(),
                                            check_vma=False))(_jax_tree(tree))
    cfg = tcoll.CommConfig(mode="hier", compression="int8")
    boot, _ = tcoll.zero1_local_shard(_port_leaves(tree), cfg)
    shard, meta = tcoll.tree_hier_psum_scatter(_port_leaves(tree), cfg)
    np.testing.assert_array_equal(boot.numpy(), np.asarray(jboot))
    np.testing.assert_array_equal(shard.numpy(), np.asarray(jshard))
    out = tcoll.tree_hier_unscatter(shard, meta, cfg)
    for got, (k, want) in zip(out, sorted(jout.items())):
        assert got.shape == want.shape
        np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------------
# 4 gloo ranks against JAX on 4 devices
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("four_ranks")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    jax_proc = subprocess.Popen([sys.executable, __file__, str(out)], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(out / "store"), str(out)))
             for r in range(WORLD)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=240)
        jax_out, _ = jax_proc.communicate(timeout=240)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait(timeout=10)
    assert jax_proc.returncode == 0, jax_out.decode()[-3000:]
    assert [p.exitcode for p in procs] == [0] * WORLD
    jres = np.load(out / "jax.npz")
    ranks = [np.load(out / f"rank{r}.npz") for r in range(WORLD)]
    return jres, ranks


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def bf16_ulps(mode: str) -> int:
    """How far, in bf16 ulps of the summands' scale, the port's bf16 sums
    may sit from the reference's.  XLA's all-reduce of bf16 accumulates
    in f32 and rounds once; a native all-reduce (gloo here, NCCL on the
    card) rounds after each partial sum, so one collective over n ranks
    rounds up to n - 1 times, each time by at most half an ulp of a
    partial sum: n / 2 ulps.  ``hier``'s collectives each sum the 2
    members of a data or pod group (1 ulp); ``flat``'s one all-reduce sums
    all 4 ranks (2 ulps)."""
    return WORLD // 2 if mode == "flat" else 1


def _assert_agree(got: np.ndarray, want: np.ndarray, codec, dt: str,
                  magnitude: np.ndarray | None = None, ulps: int = 1) -> None:
    """int8 bit-equal; bf16 within ``ulps`` bf16 ulps of ``magnitude``
    (default: of the larger result); f32 within 1e-6 of the largest value."""
    if codec == "int8":
        np.testing.assert_array_equal(got, want)
    elif dt == "bf16":
        mag = np.maximum(np.abs(got), np.abs(want)) if magnitude is None else magnitude
        diff = np.abs(got - want)
        assert (diff <= ulps * _bf16_ulp(mag)).all(), diff.max()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_hier_psum_four_ranks_match_jax(four_ranks, case):
    jres, ranks = four_ranks
    mode, codec, w, dt, _ = case
    want = jres[case_id(case)]
    weights = w if w is not None else (1.0, 1.0)
    magnitude = sum(abs(weights[r // 2] * rank_input(r)) for r in range(WORLD))
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][case_id(case)], ranks[0][case_id(case)])
        _assert_agree(ranks[r][case_id(case)], want[r],
                      None if mode == "flat" else codec, dt, magnitude, bf16_ulps(mode))


@pytest.mark.parametrize("k", CHUNKS)
@pytest.mark.parametrize("codec", CODECS)
def test_pipelined_runs_k_pod_reductions(four_ranks, codec, k):
    """The fill and the drain are peeled: k chunks make exactly k pod
    reductions (int8 reduce rings, or all-reduces over the pod group)."""
    _, ranks = four_ranks
    for case in CASES:
        if case[:2] == ("hier_pipelined", codec) and case[4] == k:
            for r in range(WORLD):
                assert int(ranks[r][f"pod-reductions-{case_id(case)}"]) == k


@pytest.mark.parametrize("tcase", TREE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_tree_hier_psum_four_ranks_match_jax(four_ranks, tcase):
    jres, ranks = four_ranks
    mode, codec = tcase
    for leaf, dt in (("a", "f32"), ("b", "bf16"), ("layers", "f32")):
        key = f"tree-{mode}-{codec}-{leaf}"
        magnitude = sum(abs(rank_tree(r)[leaf]) for r in range(WORLD))
        for r in range(WORLD):
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key])
            assert ranks[r][key].shape == jres[key][r].shape
            _assert_agree(ranks[r][key], jres[key][r], codec, dt, magnitude,
                          bf16_ulps(mode))


def _shard_of(full: np.ndarray, rank: int) -> np.ndarray:
    """The intra shard of a padded flat vector that ``rank`` holds."""
    padded = np.concatenate([full, np.zeros((-full.size) % 2, full.dtype)])
    n = padded.size // 2
    return padded[(rank % 2) * n:(rank % 2 + 1) * n]


def _sum_magnitude() -> np.ndarray:
    return sum(abs(rank_input(r)) for r in range(WORLD))


@pytest.mark.parametrize("codec, dt", SCATTER_CASES)
def test_hier_psum_scatter_four_ranks_match_jax(four_ranks, codec, dt):
    """Each rank holds its data index's shard of the global sum; the round
    trip through hier_all_gather_flat gives the whole sum on every rank."""
    jres, ranks = four_ranks
    key = f"scatter-{codec}-{dt}"
    for r in range(WORLD):
        got = ranks[r][key]
        assert got.shape == (-(-CASE_SIZE // 2),)
        np.testing.assert_array_equal(got, ranks[(r + 2) % WORLD][key])
        _assert_agree(got, jres[key][r], codec, dt, _shard_of(_sum_magnitude(), r),
                      bf16_ulps("hier"))
        if codec is None and dt == "f32":
            np.testing.assert_allclose(got, _shard_of(sum(rank_input(q) for q in range(WORLD)),
                                                      r), rtol=0, atol=1e-5)
    key = f"roundtrip-{codec}-{dt}"
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][key], ranks[0][key])
        _assert_agree(ranks[r][key], jres[key][r], codec, dt, _sum_magnitude(),
                      bf16_ulps("hier"))


@pytest.mark.parametrize("mode, dim", GATHER_CASES)
def test_hier_all_gather_four_ranks_match_jax(four_ranks, mode, dim):
    jres, ranks = four_ranks
    want = np.concatenate([rank_matrix(r) for r in range(WORLD)], axis=dim)
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][f"gather-{mode}-{dim}"], want)
        np.testing.assert_array_equal(jres[f"gather-{mode}-{dim}"][r], want)


def test_pipelined_all_gather_four_ranks_match_jax(four_ranks):
    jres, ranks = four_ranks
    want = np.concatenate([rank_matrix(r) for r in range(WORLD)])
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["pipelined-gather"], want)
        np.testing.assert_array_equal(jres["pipelined-gather"][r], want)


def test_c2c_cpy_four_ranks_match_jax(four_ranks):
    """Each rank stacks its pod peers' shards (same data index) in pod order."""
    jres, ranks = four_ranks
    for r in range(WORLD):
        want = np.stack([rank_input(p * 2 + r % 2)[:37] for p in range(2)])
        np.testing.assert_array_equal(ranks[r]["c2c-cpy"], want)
        np.testing.assert_array_equal(jres["c2c-cpy"][r], want)


@pytest.mark.parametrize("k", RING_CHUNKS)
def test_pipelined_reduce_ring_four_ranks_match_jax(four_ranks, k):
    """The mechanism-faithful pod ring sums as the native all-reduce does."""
    jres, ranks = four_ranks
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][f"ring-{k}"], ranks[0][f"ring-{k}"])
        _assert_agree(ranks[r][f"ring-{k}"], ranks[r][f"no-ring-{k}"], None, "f32")
        _assert_agree(ranks[r][f"ring-{k}"], jres[f"ring-{k}"][r], None, "f32")


@pytest.mark.parametrize("codec", ZERO_CODECS)
def test_zero1_scatter_and_unscatter_four_ranks_match_jax(four_ranks, codec):
    """The bootstrap's master shard is exact; the f32 gradient shard (int8
    bit-equal) and the reconstructed leaves agree with the reference's."""
    jres, ranks = four_ranks
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][f"zero-{codec}-boot"],
                                      jres[f"zero-{codec}-boot"][r])
        _assert_agree(ranks[r][f"zero-{codec}-shard"], jres[f"zero-{codec}-shard"][r],
                      codec, "f32")
        for leaf, dt in (("a", "f32"), ("b", "bf16"), ("layers", "f32")):
            key = f"zero-{codec}-{leaf}"
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key])
            assert ranks[r][key].shape == rank_tree(0)[leaf].shape
            magnitude = sum(abs(rank_tree(q)[leaf]) for q in range(WORLD))
            _assert_agree(ranks[r][key], jres[key][r], codec, dt, magnitude)


# ---------------------------------------------------------------------------
# hier_overlap's bucket layout and fsdp's sharding rules (one process)
# ---------------------------------------------------------------------------

def _qwen_trees(smoke: bool, d_ff: int | None = None):
    """The reference's qwen2.5-3b param shapes (ShapeDtypeStructs) and the
    port's param tree, drawn on the CPU when smoke and under
    FakeTensorMode (shapes only, nothing allocated) at full width."""
    jcfg, tcfg = jax_config("qwen2.5-3b", smoke=smoke), get_config("qwen2.5-3b", smoke=smoke)
    if d_ff is not None:
        jcfg, tcfg = (dataclasses.replace(c, d_ff=d_ff) for c in (jcfg, tcfg))
    shapes = jax.eval_shape(JaxModel(jcfg, JaxRuntime()).init, jax.random.key(0))
    if smoke:
        return jcfg, shapes, tcfg, Model(tcfg, device="cpu").init(0).param_tree()
    with FakeTensorMode():
        return jcfg, shapes, tcfg, Model(tcfg, device="cpu").init(0).param_tree()


@pytest.mark.parametrize("cap", [1 << 10, 1 << 20, toverlap.DEFAULT_CAP_BYTES])
def test_partition_tree_smoke_is_the_reference(cap):
    _, shapes, _, tree = _qwen_trees(smoke=True)
    got = toverlap.partition_tree(tree, cap)
    assert repr(got) == repr(joverlap.partition_tree(shapes, cap))
    assert len(got) >= 3


def test_partition_tree_full_width_is_the_reference():
    """qwen2.5-3b under the 64 MiB cap: final_norm, the 36 layers one by
    one (308 MB of f32 each), the tied embed last."""
    _, shapes, _, tree = _qwen_trees(smoke=False)
    got = toverlap.partition_tree(tree)
    assert repr(got) == repr(joverlap.partition_tree(shapes))
    assert len(got) == 38
    assert got[0].entries == (("final_norm", None, None),)
    assert [b.entries for b in got[1:37]] == [(("layers", i, i + 1),) for i in range(35, -1, -1)]
    assert got[37].entries == (("embed", None, None),)


@pytest.mark.parametrize("cap", [1, 1000, 1 << 20, toverlap.DEFAULT_CAP_BYTES])
def test_bucket_sizes_for_volume_is_the_reference(cap):
    for total in (0, 1, 7, 1000, 12_343_754_752):
        for n_layers in (0, 1, 3, 36, 5000):
            assert (toverlap.bucket_sizes_for_volume(total, n_layers, cap)
                    == joverlap.bucket_sizes_for_volume(total, n_layers, cap))


@pytest.mark.parametrize("align", [2048, (1024, 4096, 8)])
def test_plan_bucket_layout_is_the_reference(align):
    metas = [[("float32", (300,), 300), ("bfloat16", (50, 7), 350)],
             [("float32", (1, 129), 129), ("float32", (1, 20, 7), 140)],
             [("bfloat16", (37, 11), 407)]]
    got = tpack.plan_bucket_layout(metas, align=align)
    assert repr(got) == repr(jpack.plan_bucket_layout(metas, align=align))
    assert len(got.bucket_bounds) == 3


def test_fsdp_dim_is_the_reference():
    for shape in [(36, 2048), (2, 64, 160), (36, 2048, 11008), (3, 5), (2, 300, 300),
                  (1, 1 << 16), (7, 1 << 16)]:
        for n in (1, 2, 4, 3):
            for taken in ((), (0,), (0, 1)):
                assert tshard.fsdp_dim(shape, n, taken) == jshard.fsdp_dim(shape, n, taken)
    assert tshard.FSDP_MIN_SIZE == jshard.FSDP_MIN_SIZE


@pytest.mark.parametrize("which", ["smoke", "smoke_d_ff_512", "full"])
def test_fsdp_specs_are_the_reference(which):
    """The sharded-leaf choice at fsdp 2 from the global stacked shapes:
    nothing at the smoke widths (every leaf under FSDP_MIN_SIZE), the MLP
    at d_ff 512, and at full width every layer leaf, norm scales too (36
    x 2048 >= 2^16) but the k and v biases (36 x 256)."""
    jcfg, shapes, tcfg, tree = _qwen_trees(smoke=which != "full",
                                           d_ff=512 if which == "smoke_d_ff_512" else None)
    jm = JaxModel(jcfg, JaxRuntime(fsdp_axis="data")).with_fsdp(2)
    flat, _ = jax.tree_util.tree_flatten_with_path(jm.param_specs(shapes),
                                                   is_leaf=lambda x: isinstance(x, P))
    want = {tuple(k.key for k in path): tuple(spec) for path, spec in flat}
    got = param_specs(tree, tcfg, 1, 2)
    assert got == want
    assert list(got) == sorted(got)            # train_leaves order
    data = {path for path, spec in got.items() if "data" in spec}
    if which == "smoke":
        assert not data
    elif which == "smoke_d_ff_512":
        assert data == {("layers", "mlp", k) for k in ("w_down", "w_gate", "w_up")}
    else:
        assert data == {path for path in got if path[0] == "layers"} - {
            ("layers", "attn", "bk"), ("layers", "attn", "bv")}
        assert got[("layers", "norm_attn", "scale")] == (None, "data")


# ---------------------------------------------------------------------------
# hier_overlap, fsdp_gather and psum_ef on 4 gloo ranks against JAX
# ---------------------------------------------------------------------------

def _overlap_leaf(tree: dict, name: str) -> np.ndarray:
    for k in name.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("codec", OVERLAP_CODECS)
def test_tree_hier_psum_overlap_four_ranks_match_jax(four_ranks, codec):
    jres, ranks = four_ranks
    shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32),
                          rank_overlap_tree(0))
    assert len(joverlap.partition_tree(shapes, OVERLAP_CAP)) == 6
    for name, dt in OVERLAP_LEAVES:
        key = f"overlap-{codec}-{name}"
        magnitude = sum(abs(_overlap_leaf(rank_overlap_tree(r), name)) for r in range(WORLD))
        for r in range(WORLD):
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key])
            assert ranks[r][key].shape == jres[key][r].shape
            _assert_agree(ranks[r][key], jres[key][r], codec, dt, magnitude, bf16_ulps("hier"))


@pytest.mark.parametrize("dim", GATHER_DIMS)
def test_fsdp_gather_four_ranks_match_jax(four_ranks, dim):
    """The tiled gather over the data group and, as its gradient, the
    reduce-scatter of the cotangents: exact."""
    jres, ranks = four_ranks
    for r in range(WORLD):
        pod, d = divmod(r, 2)
        peers = [2 * pod + q for q in range(2)]
        want = np.concatenate([rank_matrix(q) for q in peers], axis=dim)
        ct = sum(gather_cotangent(q, dim) for q in peers)
        want_grad = np.split(ct, 2, axis=dim)[d]
        np.testing.assert_array_equal(ranks[r][f"fsdp-gather-{dim}"], want)
        np.testing.assert_array_equal(jres[f"fsdp-gather-{dim}"][r], want)
        np.testing.assert_array_equal(ranks[r][f"fsdp-grad-{dim}"], jres[f"fsdp-grad-{dim}"][r])
        np.testing.assert_allclose(ranks[r][f"fsdp-grad-{dim}"], want_grad, rtol=0, atol=1e-6)


@pytest.mark.parametrize("codec", EF_CODECS)
def test_psum_ef_four_ranks_match_jax(four_ranks, codec):
    """Two error-feedback steps over the pod group, the residual carried:
    int8 sums and residuals bit-equal, bf16 sums within bf16_ulps and
    residuals exact."""
    jres, ranks = four_ranks
    for r in range(WORLD):
        for name in ("s1", "r1", "s2", "r2"):
            key = f"ef-{codec}-{name}"
            if name[0] == "s":                # both pods hold the pod sum
                np.testing.assert_array_equal(ranks[r][key], ranks[r ^ 2][key])
            if codec == "int8" or name[0] == "r":
                np.testing.assert_array_equal(ranks[r][key], jres[key][r])
            else:
                _assert_agree(ranks[r][key], jres[key][r], codec, "bf16",
                              ulps=bf16_ulps("hier"))
