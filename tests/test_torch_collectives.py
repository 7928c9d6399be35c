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
"""

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


def case_id(case) -> str:
    m, c, w, d, k = case
    chunks = f"-k{k}" if m == "hier_pipelined" else ""
    return f"{m}{chunks}-{c}-{'w' if w else 'even'}-{d}"


def rank_input(rank: int) -> np.ndarray:
    x = np.random.default_rng(1000 + rank).normal(size=CASE_SIZE).astype(np.float32) * 3
    x[1024:2048] = 0.0                      # an all-zero block
    return x


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
    res = {}
    for case in CASES:
        mode, codec, w, dt, k = case
        cfg = jcoll.CommConfig(mode=mode, pod_axis="pod", intra_axis="data",
                               n_chunks=k, compression=codec, cluster_weights=w)
        jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
        fn = jax.jit(shard_map(lambda x, cfg=cfg: jcoll.hier_psum(x[0], cfg)[None],
                               mesh=mesh, in_specs=spec, out_specs=spec))
        res[case_id(case)] = np.asarray(fn(jnp.asarray(xs, jdt)).astype(jnp.float32))
    trees = [rank_tree(r) for r in range(WORLD)]
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
    np.savez(os.path.join(out_dir, "jax.npz"), **res)


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
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


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
from repro.core import schedule as jsched  # noqa: E402
from repro.kernels import quant as jquant  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro.parallel.sharding import shard_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.core import collectives as tcoll  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.kernels import quant as tquant  # noqa: E402
from repro_torch.models import Model  # noqa: E402

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
    """AllGatherH's raw-shard copy ring is not on a ported path yet."""
    cfg = tcoll.CommConfig(mode="hier", pod_group=object())
    with pytest.raises(NotImplementedError, match="ZeRO-1"):
        tcoll._exec_step(tsched.C2CCpy("c2c"), torch.ones(8), cfg, tcoll._ExecCtx())


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
