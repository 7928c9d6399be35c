"""The port's package API against the JAX package's.

* ``repro_torch.core``, ``.parallel``, ``.train`` and ``.data`` export
  every name the reference's ``__init__`` of the same package imports,
  each bound to the port's own object (``repro_torch.core.hier_psum is
  repro_torch.core.collectives.hier_psum``); the names are read from the
  reference's ``__init__`` by ``ast``.  Importing the four packages builds
  no kernel and imports no ``triton``.
* ``primitives.c2c_send_recv``, ``primitives.c2c_bcast`` and
  ``collectives.tree_hier_psum_mean`` on 8 gloo ranks as 2 pods x 2 data
  x 2 model, against the reference's functions on 8 host devices with
  the same numpy inputs (device i holds row i, as the ranks do): the
  shift and the broadcast bit for bit (f32 and bf16; shift 1 and -1,
  root 0 and 1), the mean over f32 and bf16 leaves under ``hier`` and
  ``hier_pipelined`` as the existing sums are held (f32 within 1e-6 of
  the largest value, bf16 within R7's n/2 ulps: one ulp, every
  collective there sums two ranks), and the mean through a bound plan
  equal to the mean through its ``CommConfig``.
"""

import ast
import datetime
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
PODS, DATA, MODEL = 2, 2, 2
WORLD = PODS * DATA * MODEL
ROW = 37
DTYPES = ("f32", "bf16")
SHIFTS = (1, -1)
ROOTS = (0, 1)
MEAN_MODES = (("hier", 1), ("hier_pipelined", 4))
LEAF_SHAPES = (("a", (37, 19), "f32"), ("b", (6, 19), "bf16"), ("c", (19,), "f32"))


def rows(dt: str) -> np.ndarray:
    """The (WORLD, ROW) input, row i on device / rank i; bf16 values are
    exact in f32."""
    x = np.random.default_rng(7).normal(size=(WORLD, ROW)).astype(np.float32)
    return _round_bf16(x) if dt == "bf16" else x


def _round_bf16(x: np.ndarray) -> np.ndarray:
    bits = x.view(np.uint32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.view(np.float32)


def rank_leaves(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    out = {}
    for name, shape, dt in LEAF_SHAPES:
        x = rng.normal(size=shape).astype(np.float32) * 3
        out[name] = _round_bf16(x) if dt == "bf16" else x
    return out


def _jax_main(out_dir: str, part: str) -> None:
    """The reference's functions on the (2, 2, 2) mesh of 8 host devices:
    each device's output of each case, stacked in device order."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import collectives, primitives
    from repro.core.collectives import CommConfig
    from repro.parallel.sharding import shard_map

    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    mesh = jax.make_mesh((PODS, DATA, MODEL), ("pod", "data", "model"))
    spec = P(("pod", "data", "model"))

    def per_device(fn, *args):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * len(args),
                                 out_specs=spec, check_vma=False))(*args)

    res = {}
    for dt in DTYPES:
        x = jnp.asarray(rows(dt), jdt[dt])
        for shift in SHIFTS:
            out = per_device(lambda v, s=shift: primitives.c2c_send_recv(v, "pod", s), x)
            res[f"send_recv/{dt}/{shift}"] = np.asarray(out.astype(jnp.float32))
        for root in ROOTS:
            out = per_device(lambda v, r=root: primitives.c2c_bcast(v, "pod", root=r), x)
            res[f"bcast/{dt}/{root}"] = np.asarray(out.astype(jnp.float32))
    leaves = [jnp.asarray(np.stack([rank_leaves(r)[name] for r in range(WORLD)]), jdt[dt])
              for name, _, dt in LEAF_SHAPES]
    for mode, k in MEAN_MODES:
        cfg = CommConfig(mode=mode, pod_axis="pod", intra_axis="data", n_chunks=k)

        def mean(*ls, cfg=cfg):
            out = collectives.tree_hier_psum_mean([leaf[0] for leaf in ls], cfg)
            return tuple(o[None] for o in out)

        outs = jax.jit(shard_map(mean, mesh=mesh, in_specs=(spec,) * len(leaves),
                                 out_specs=(spec,) * len(leaves), check_vma=False))(*leaves)
        for (name, _, _), o in zip(LEAF_SHAPES, outs):
            assert o.dtype == leaves[[n for n, _, _ in LEAF_SHAPES].index(name)].dtype
            res[f"mean/{mode}/{name}"] = np.asarray(o.astype(jnp.float32))
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"), **res)


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from repro_torch.core import collectives, planner, primitives, topology
    from repro_torch.core.collectives import CommConfig
    from repro_torch.launch.mesh import runtime_for_groups

    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    res = {}
    try:
        rt = runtime_for_groups(pods=PODS, data_per_pod=DATA, tp=MODEL)
        for dt in DTYPES:
            x = torch.from_numpy(rows(dt)[rank].copy()).to(tdt[dt])
            for shift in SHIFTS:
                out = primitives.c2c_send_recv(x, rt.pod_group, shift)
                assert out.dtype == tdt[dt]
                res[f"send_recv/{dt}/{shift}"] = out.float().numpy()
            for root in ROOTS:
                out = primitives.c2c_bcast(x, rt.pod_group, root=root)
                res[f"bcast/{dt}/{root}"] = out.float().numpy()
            # a group of one: the identity, nothing sent
            assert primitives.c2c_bcast(x, None) is x
            assert primitives.c2c_send_recv(x, None) is x

        def leaves():
            return [torch.from_numpy(rank_leaves(rank)[name]).to(tdt[dt])
                    for name, _, dt in LEAF_SHAPES]

        for mode, k in MEAN_MODES:
            cfg = CommConfig(mode=mode, pod_group=rt.pod_group, intra_group=rt.data_group,
                             dp_group=rt.dp_group, n_chunks=k)
            out = collectives.tree_hier_psum_mean(leaves(), cfg)
            for (name, shape, dt), o in zip(LEAF_SHAPES, out):
                assert o.dtype == tdt[dt] and tuple(o.shape) == shape
                res[f"mean/{mode}/{name}"] = o.float().numpy()
            plan = planner.CommPlan(topology.tpu_multipod(PODS, DATA), False, "all_reduce",
                                    "pod", "data", (planner.BucketPlan(
                                        1 << 12, planner.Candidate(mode, k, None),
                                        0.0, 0.0, 0.0, True),))
            bound = collectives.tree_hier_psum_mean(leaves(), planner.BoundPlan.of(plan, rt))
            res[f"bound_equal/{mode}"] = np.asarray(
                all(torch.equal(a, b) for a, b in zip(bound, out)))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _jax_main(sys.argv[1], sys.argv[2])
    sys.exit(0)


import importlib  # noqa: E402

import pytest  # noqa: E402

from _torch_world import run_world  # noqa: E402

PACKAGES = ("core", "parallel", "train", "data")


def reference_names(pkg: str) -> list[tuple[str, str]]:
    """(module, name) of every name ``src/repro/<pkg>/__init__.py``
    imports, in its order."""
    tree = ast.parse((ROOT / "src" / "repro" / pkg / "__init__.py").read_text())
    return [(node.module, alias.name) for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names]


EXPORTS = [(pkg, mod, name) for pkg in PACKAGES for mod, name in reference_names(pkg)]


def test_the_reference_exports_what_the_issue_counts():
    counts = {pkg: len(reference_names(pkg)) for pkg in PACKAGES}
    assert counts == {"core": 31, "parallel": 6, "train": 7, "data": 5}


@pytest.mark.parametrize("pkg, mod, name", EXPORTS, ids=[f"{p}.{n}" for p, _, n in EXPORTS])
def test_port_exports_the_references_name(pkg, mod, name):
    package = importlib.import_module(f"repro_torch.{pkg}")
    module = importlib.import_module(f"repro_torch.{pkg}.{mod}")
    assert getattr(package, name) is getattr(module, name)


def test_the_packages_build_nothing_at_import():
    code = ("import sys\n"
            "import repro_torch.core, repro_torch.parallel, repro_torch.train, repro_torch.data\n"
            "from repro_torch.kernels import _build\n"
            "assert _build.library.cache_info().currsize == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('triton', 'jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("api_world")
    return run_world(__file__, tmp, ("ops",), WORLD, _gloo_rank, WORLD)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shift", SHIFTS)
def test_c2c_send_recv_bit_equal_to_jax(world, dt, shift):
    want, ranks = world
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r][f"send_recv/{dt}/{shift}"],
                                      want[f"send_recv/{dt}/{shift}"][r])
    # the ring itself: rank r holds the row of the rank `shift` pods before it
    pod_stride = DATA * MODEL
    for r in range(WORLD):
        src = (r - shift * pod_stride) % WORLD
        np.testing.assert_array_equal(ranks[r][f"send_recv/{dt}/{shift}"], rows(dt)[src])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("root", ROOTS)
def test_c2c_bcast_bit_equal_to_jax(world, dt, root):
    want, ranks = world
    pod_stride = DATA * MODEL
    for r in range(WORLD):
        got = ranks[r][f"bcast/{dt}/{root}"]
        np.testing.assert_array_equal(got, want[f"bcast/{dt}/{root}"][r])
        # every rank ends with its pod group's root's row
        np.testing.assert_array_equal(got, rows(dt)[root * pod_stride + r % pod_stride])


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("mode", [m for m, _ in MEAN_MODES])
@pytest.mark.parametrize("leaf", [name for name, _, _ in LEAF_SHAPES])
def test_tree_hier_psum_mean_matches_jax(world, mode, leaf):
    want, ranks = world
    dt = {name: dt for name, _, dt in LEAF_SHAPES}[leaf]
    for r in range(WORLD):
        got, ref = ranks[r][f"mean/{mode}/{leaf}"], want[f"mean/{mode}/{leaf}"][r]
        if dt == "bf16":
            # R7: one ulp of the summands' scale (each collective sums 2 ranks)
            members = [m for m in range(WORLD) if m % MODEL == r % MODEL]
            scale = sum(np.abs(rank_leaves(m)[leaf]) for m in members) / len(members)
            assert (np.abs(got - ref) <= _bf16_ulp(scale)).all()
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
        assert bool(ranks[r][f"bound_equal/{mode}"])
