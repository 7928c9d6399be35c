"""All2AllH of the port against the JAX package's, on eight gloo ranks.

The analog of ``tests/mdscripts/check_a2a.py``.  Rows, each a rank group
in pod-major order (rank p * D + d):

    flat     8 ranks, one cluster (no pod group)
    2pod     (2 pods, 4 ranks each)
    3vendor  (3 pods, 2 ranks each) on ranks 0-5

and per row: ``hier_a2a`` and ``flat_a2a`` x ``n_chunks`` {1, 2} x f32 and
bf16 payloads at split = concat = 0 (the MoE dispatch shape), a
split != concat row per mode, on the multi-pod rows ``hier_a2a`` with the
bf16 wire codec on the pod exchange, and uneven-token buffers (zero
padding above each (source, destination) count) exchanged once and
round-tripped (an a2a with split == concat is an involution).  Every
lossless row equals the numpy gather/scatter reference and the
reference's ``hier_all_to_all`` on 8 host devices exactly; a codec row
equals the reference exactly and the gather/scatter reference of the
bf16-rounded payload (the cast takes the whole buffer of the pod
exchange).  Then the gradients:
``hom_all_to_all`` (split 0, concat 1) and ``hier_a2a`` on 2pod against
``jax.vjp``, exactly.

One spawned world of eight ranks, one JAX subprocess (this file run as a
script).
"""

import datetime
import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np

WORLD = 8
TOPOS = {"flat": (1, 8), "2pod": (2, 4), "3vendor": (3, 2)}   # (pods, ranks per pod)
MODES = ("hier_a2a", "flat_a2a")


def cells() -> list[tuple]:
    """(name, topology, mode, n_chunks, payload dtype, codec, split, concat,
    input key) of every exchange, in the order both sides run them."""
    out = []
    for topo in TOPOS:
        for mode in MODES:
            for k in (1, 2):
                for dt in ("f32", "bf16"):
                    out.append((f"{topo}/{mode}/k{k}/{dt}", topo, mode, k, dt, None, 0, 0, "x00"))
            out.append((f"{topo}/{mode}/sd0cd1", topo, mode, 1, "f32", None, 0, 1, "x01"))
        if TOPOS[topo][0] > 1:
            for k in (1, 2):
                out.append((f"{topo}/hier_a2a/k{k}/codec", topo, "hier_a2a", k, "f32", "bf16",
                            0, 0, "xw"))
    return out


def inputs() -> dict:
    """The global arrays of every row, rows split over the ranks."""
    rng = np.random.default_rng(13)
    out = {}
    for topo, (P, D) in TOPOS.items():
        W = P * D
        out[f"{topo}/x00"] = rng.normal(size=(W * W * 3, 5)).astype(np.float32)
        out[f"{topo}/x01"] = rng.normal(size=(W * W * 2, 6)).astype(np.float32)
        out[f"{topo}/xw"] = rng.normal(size=(W * W * 3, 5)).astype(np.float32)
        if P > 1:
            C, Dm = 4, 3
            buf = np.zeros((W * W, C, Dm), np.float32)
            counts = rng.integers(0, C + 1, size=(W, W))
            for src in range(W):
                for dst in range(W):
                    t = int(counts[src, dst])
                    buf[src * W + dst, :t] = rng.normal(size=(t, Dm))
            out[f"{topo}/uneven"] = buf
    out["grad/x"] = rng.normal(size=(WORLD * WORLD * 2, 3)).astype(np.float32)
    out["grad/ct"] = rng.normal(size=(WORLD * 2, 3 * WORLD)).astype(np.float32)
    out["grad/x2"] = rng.normal(size=(WORLD * WORLD * 2, 3)).astype(np.float32)
    out["grad/ct2"] = rng.normal(size=(WORLD * WORLD * 2, 3)).astype(np.float32)
    return out


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even) -> f32, in numpy."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def gather_scatter(x: np.ndarray, W: int, sd: int, cd: int) -> np.ndarray:
    """Single-device reference: rank r's output is the concat over sources of
    the r-th split piece of each source's block."""
    blocks = np.split(x, W, axis=0)
    return np.concatenate([np.concatenate([np.split(blocks[src], W, axis=sd)[r]
                                           for src in range(W)], axis=cd)
                           for r in range(W)], axis=0)


def _jax_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from repro.core.collectives import CommConfig, hier_all_to_all
    from repro.parallel.sharding import shard_map

    ins = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    meshes = {"flat": (jax.make_mesh((8,), ("data",)), None),
              "2pod": (jax.make_mesh((2, 4), ("pod", "data")), "pod"),
              "3vendor": (jax.make_mesh((3, 2), ("pod", "data"), devices=jax.devices()[:6]),
                          "pod")}

    def spec(mesh, nd):
        return P(*((mesh.axis_names,) + (None,) * (nd - 1)))

    out = {}
    for name, topo, mode, k, dt, comp, sd, cd, key in cells():
        mesh, pod = meshes[topo]
        cfg = CommConfig(mode=mode, pod_axis=pod, intra_axis="data", n_chunks=k,
                         compression=comp)
        x = jnp.asarray(ins[f"{topo}/{key}"], jnp.bfloat16 if dt == "bf16" else jnp.float32)
        fn = jax.jit(shard_map(lambda v, cfg=cfg, sd=sd, cd=cd: hier_all_to_all(v, cfg, sd, cd),
                               mesh=mesh, in_specs=spec(mesh, 2), out_specs=spec(mesh, 2)))
        out[name] = np.asarray(fn(x).astype(jnp.float32))
    for topo in ("2pod", "3vendor"):
        mesh, pod = meshes[topo]
        for mode in MODES:
            cfg = CommConfig(mode=mode, pod_axis=pod, intra_axis="data", n_chunks=1)
            once = jax.jit(shard_map(lambda v, cfg=cfg: hier_all_to_all(v, cfg, 0, 0),
                                     mesh=mesh, in_specs=spec(mesh, 3), out_specs=spec(mesh, 3)))
            buf = jnp.asarray(ins[f"{topo}/uneven"])
            out[f"{topo}/{mode}/uneven/once"] = np.asarray(once(buf))
            out[f"{topo}/{mode}/uneven/twice"] = np.asarray(once(once(buf)))
    # gradients: the native exchange (split 0, concat 1) on 8 ranks, and
    # hier_a2a (split = concat = 0) on 2pod
    flat = meshes["flat"][0]

    def vjp_of(f):
        def body(x, ct):
            y, vjp = jax.vjp(f, x)
            return y, vjp(ct)[0]
        return body

    body = vjp_of(lambda a: lax.all_to_all(a, "data", 0, 1, tiled=True))
    y, g = jax.jit(shard_map(body, mesh=flat, in_specs=(P("data"), P("data")),
                             out_specs=(P("data"), P("data"))))(
        jnp.asarray(ins["grad/x"]), jnp.asarray(ins["grad/ct"]))
    out["grad/native/y"], out["grad/native/g"] = np.asarray(y), np.asarray(g)
    mesh2 = meshes["2pod"][0]
    cfg = CommConfig(mode="hier_a2a", pod_axis="pod", intra_axis="data", n_chunks=1)
    body = vjp_of(lambda a: hier_all_to_all(a, cfg, 0, 0))
    sp = P(("pod", "data"))
    y, g = jax.jit(shard_map(body, mesh=mesh2, in_specs=(sp, sp), out_specs=(sp, sp)))(
        jnp.asarray(ins["grad/x2"]), jnp.asarray(ins["grad/ct2"]))
    out["grad/hier/y"], out["grad/hier/g"] = np.asarray(y), np.asarray(g)
    np.savez(os.path.join(out_dir, "jax.npz"), **out)


def _groups(dist) -> dict:
    """Every topology's groups, each built by every rank in the same order:
    {topology: (pod group, intra group, dp group) of this rank, or None}."""
    rank = dist.get_rank()
    out = {}
    for topo, (P, D) in TOPOS.items():
        W = P * D
        dp = dist.new_group(list(range(W)))
        intra = [dist.new_group([p * D + d for d in range(D)]) for p in range(P)]
        pod = [dist.new_group([p * D + d for p in range(P)]) for d in range(D)] if P > 1 else None
        if rank < W:
            out[topo] = (None if pod is None else pod[rank % D], intra[rank // D], dp)
    return out


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from repro_torch.convert import to_tensor
    from repro_torch.core import primitives
    from repro_torch.core.collectives import CommConfig, hier_all_to_all

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        ins = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        groups = _groups(dist)
        out = {}

        def local(a: np.ndarray, W: int) -> np.ndarray:
            return np.split(a, W, axis=0)[rank]

        for name, topo, mode, k, dt, comp, sd, cd, key in cells():
            if topo not in groups:
                continue
            pod, intra, dp = groups[topo]
            W = TOPOS[topo][0] * TOPOS[topo][1]
            cfg = CommConfig(mode=mode, pod_group=pod, intra_group=intra, dp_group=dp,
                             n_chunks=k, compression=comp)
            x = to_tensor(local(ins[f"{topo}/{key}"], W), "cpu")
            if dt == "bf16":
                x = x.to(torch.bfloat16)
            y = hier_all_to_all(x, cfg, sd, cd)
            assert y.dtype == x.dtype
            out[name] = y.float().numpy()
        for topo in ("2pod", "3vendor"):
            if topo not in groups:
                continue
            pod, intra, dp = groups[topo]
            W = TOPOS[topo][0] * TOPOS[topo][1]
            for mode in MODES:
                cfg = CommConfig(mode=mode, pod_group=pod, intra_group=intra, dp_group=dp,
                                 n_chunks=1)
                buf = to_tensor(local(ins[f"{topo}/uneven"], W), "cpu")
                once = hier_all_to_all(buf, cfg, 0, 0)
                out[f"{topo}/{mode}/uneven/once"] = once.numpy()
                out[f"{topo}/{mode}/uneven/twice"] = hier_all_to_all(once, cfg, 0, 0).numpy()
        _, intra, _ = groups["flat"]
        x = to_tensor(local(ins["grad/x"], WORLD), "cpu").requires_grad_(True)
        y = primitives.hom_all_to_all(x, intra, 0, 1)
        (g,) = torch.autograd.grad(y, x, to_tensor(local(ins["grad/ct"], WORLD), "cpu"))
        out["grad/native/y"], out["grad/native/g"] = y.detach().numpy(), g.numpy()
        pod, intra, dp = groups["2pod"]
        cfg = CommConfig(mode="hier_a2a", pod_group=pod, intra_group=intra, dp_group=dp,
                         n_chunks=1)
        x = to_tensor(local(ins["grad/x2"], WORLD), "cpu").requires_grad_(True)
        y = hier_all_to_all(x, cfg, 0, 0)
        (g,) = torch.autograd.grad(y, x, to_tensor(local(ins["grad/ct2"], WORLD), "cpu"))
        out["grad/hier/y"], out["grad/hier/g"] = y.detach().numpy(), g.numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _jax_main(sys.argv[1])
    sys.exit(0)


import pytest  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(inputs, the reference's outputs, the port's outputs gathered over
    the ranks in rank order, as the reference's global arrays)."""
    tmp = tmp_path_factory.mktemp("a2a_world")
    ins = inputs()
    np.savez(tmp / "inputs.npz", **ins)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    jax_proc = subprocess.Popen([sys.executable, __file__, str(tmp)], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp / "store"), str(tmp)))
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
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    got = {key: np.concatenate([rk[key] for rk in ranks if key in rk], axis=0)
           for key in ranks[0]}
    return ins, dict(np.load(tmp / "jax.npz")), got


@pytest.mark.parametrize("cell", cells(), ids=lambda c: c[0])
def test_hier_all_to_all_is_the_reference_and_the_gather_scatter(results, cell):
    ins, want, got = results
    name, topo, mode, k, dt, comp, sd, cd, key = cell
    P, D = TOPOS[topo]
    x = ins[f"{topo}/{key}"]
    # the codec casts the whole buffer of the pod exchange, the blocks that
    # stay in their pod too
    oracle = gather_scatter(_bf16(x) if "bf16" in (dt, comp) else x, P * D, sd, cd)
    np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(got[name], oracle, err_msg=name)
    if comp == "bf16":
        assert not np.array_equal(got[name], gather_scatter(x, P * D, sd, cd))


@pytest.mark.parametrize("topo", ["2pod", "3vendor"])
@pytest.mark.parametrize("mode", MODES)
def test_uneven_tokens_round_trip_exactly(results, topo, mode):
    ins, want, got = results
    buf = ins[f"{topo}/uneven"]
    W = TOPOS[topo][0] * TOPOS[topo][1]
    once = got[f"{topo}/{mode}/uneven/once"]
    np.testing.assert_array_equal(once, gather_scatter(buf, W, 0, 0))
    np.testing.assert_array_equal(once, want[f"{topo}/{mode}/uneven/once"])
    np.testing.assert_array_equal(got[f"{topo}/{mode}/uneven/twice"], buf)


@pytest.mark.parametrize("which", ["native", "hier"])
def test_all_to_all_backward_is_the_reference_vjp(results, which):
    """The exchange's backward is the exchange with split and concat swapped,
    as ``lax.all_to_all`` transposes; through hier_a2a's block transposes
    and its two exchanges too."""
    _, want, got = results
    for part in ("y", "g"):
        np.testing.assert_array_equal(got[f"grad/{which}/{part}"], want[f"grad/{which}/{part}"])
