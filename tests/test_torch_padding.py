"""Head padding under tensor parallelism: the port against the JAX package
where the reference pads Q heads to a multiple of the TP size, pads
sharded KV heads, or replicates KV heads that are fewer than the ranks.

* Eight gloo ranks, spawned once, against the reference on 8 host
  devices (the JAX side runs this file as a script, its parts side by
  side), every model f32 and converted from the reference's padded tree
  of its TP size:
  - serving, each case on a (data 1, model T) mesh against a TP group of
    T ranks (at T = 4 both TP groups of the world serve the same prompt):
    qwen1.5-4b smoke at TP 4 (5 heads padded to 8 Q / 8 KV, sharded) and
    TP 8 (8 Q, 5 KV replicated), hymba smoke at TP 8 (8 Q, 2 KV
    replicated, one SSM head a rank), whisper smoke at TP 8 (8 Q, 4 KV
    replicated, self- and cross-attention) and a whisper of 6 heads at
    TP 4 (8 / 8 sharded): each rank's prefill logits, the greedy tokens of
    the prefill and three decode steps, and the prefill's cache leaves,
    read as the reference's ``cache_specs`` shards them (its f32 5-D
    leaves along dim 2, ROADMAP R13); the int8 transfer of the hymba
    cache, leaf by leaf;
  - three ``hier`` + int8 training steps of qwen1.5-4b smoke at TP 4 on 2
    pods and at TP 8, and of hymba smoke at TP 8: every rank's loss and
    grad norm against its own device's, its parameters, and the phantom
    rows of ``wo``: zero where KV is sharded (a phantom Q head reads a
    zero phantom KV head), moving alike in both packages where it is
    replicated (ROADMAP R23: a phantom Q head reads a real KV head);
  - qwen1.5-4b smoke's TP-1 tree, padded with zero heads to TP 4's
    shapes, gives its TP-1 logits at TP 4;
  - the entry points' ``run`` at TP 8 (hymba, qwen1.5-4b, whisper) and
    the trainer's at TP 4 (whisper).
* In this process: the full-width ``param_specs`` and shard shapes of
  qwen1.5-4b at TP 8, whisper-tiny at TP 4 and 8 and hymba-1.5b at TP 8
  from shapes alone (``FakeTensorMode`` against ``jax.eval_shape``); the
  R23 Q -> KV maps of both packages; the whisper server at ``--tp 4`` as
  4 processes.
"""

import dataclasses
import datetime
import os
import sys

import numpy as np

WORLD = 8
SB, SS, GEN = 2, 40, 3              # serving batch, prompt (> hymba's window 32), decode steps
GB, S, N_STEPS = 2, 32, 3
LR, WARMUP = 1e-3, 1
W6 = dict(n_heads=6, n_kv_heads=6, d_head=16)     # whisper of 6 heads: 8 / 8 at TP 4
# serving cases: (arch, TP, config overrides)
SERVE = {"q4": ("qwen1.5-4b", 4, {}), "q8": ("qwen1.5-4b", 8, {}),
         "h8": ("hymba-1.5b", 8, {}), "w8": ("whisper-tiny", 8, {}),
         "w6": ("whisper-tiny", 4, W6)}
# training cases: (arch, TP, pods), hier + int8
TRAIN = {"q4t": ("qwen1.5-4b", 4, 2), "q8t": ("qwen1.5-4b", 8, 1),
         "h8t": ("hymba-1.5b", 8, 1)}
JAX_PARTS = ("serve0", "serve1", "q4t", "q8t", "h8t")
SERVE_PARTS = {"serve0": ("q4", "q8", "h8"), "serve1": ("w8", "w6")}
PAD_TP = 4                          # the zero-padded TP-1 tree's TP size


def serve_inputs(vocab: int, enc_seq: int, d_model: int) -> list[np.ndarray]:
    rng = np.random.default_rng(61)
    prompt = rng.integers(0, vocab, (SB, SS), dtype=np.int32)
    return [prompt] + ([rng.normal(size=(SB, enc_seq, d_model)).astype(np.float32)]
                       if enc_seq else [])


def batch(step: int, vocab: int, enc_seq: int, d_model: int) -> dict:
    rng = np.random.default_rng(600 + step)
    out = {"tokens": rng.integers(0, vocab, (GB, S), dtype=np.int32),
           "labels": rng.integers(0, vocab, (GB, S), dtype=np.int32)}
    if enc_seq:
        out["enc"] = rng.normal(size=(GB, enc_seq, d_model)).astype(np.float32)
    return out


def _cache_shard(a: np.ndarray, r: int, tp: int, name: str) -> np.ndarray:
    """Device r's shard of the reference's global cache leaf: the conv state
    on its channels, the 5-D f32 leaves on dim 2 (the window of a KV leaf,
    the heads of an SSM state), the lengths replicated."""
    if name.endswith("length"):
        return a
    dim = 3 if name.endswith("conv") else 2
    n = a.shape[dim] // tp
    return np.take(a, range(r * n, (r + 1) * n), axis=dim)


def _jax_main(out_dir: str, part: str) -> None:
    """The reference on 8 host devices: the serving cases of ``part``
    "serve<i>", or the training case ``part``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from _torch_world import nest
    from repro.configs import get_config as jax_config
    from repro.launch.mesh import runtime_for_mesh
    from repro.models import Model as JaxModel
    from repro.parallel import sharding as jsh
    from repro.serve import make_serve_steps as jax_serve_steps
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import make_train_step as jax_train_step
    from repro.train import optimizer as jopt
    from repro.train.optimizer import OptConfig as JaxOpt

    def load(name):
        return jax.tree.map(jnp.asarray, nest(np.load(os.path.join(out_dir, f"params_{name}.npz"))))

    def leaves(caches, family):
        parts = {"hybrid": ("kv", "ssm"), "encdec": ("kv", "cross")}.get(family)
        pairs = zip(parts, caches) if parts else [("", caches)]
        for prefix, c in pairs:
            for n in c._fields:
                yield (f"{prefix}.{n}" if prefix else n), getattr(c, n)

    out = {}
    if part in SERVE_PARTS:
        for case in SERVE_PARTS[part]:
            arch, tp, over = SERVE[case]
            cfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=jnp.float32, **over)
            mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("data", "model"))
            jm = JaxModel(cfg, runtime_for_mesh(mesh, use_pallas=True))
            params = load(case)
            ins = [jnp.asarray(a) for a in serve_inputs(cfg.vocab_size, cfg.enc_seq,
                                                        cfg.d_model)]
            prefill, decode, _ = jax_serve_steps(jm, mesh, SB, SS)
            tok, caches = prefill(params, *ins)
            for name, leaf in leaves(caches, cfg.family):
                out[f"{case}/cache/{name}"] = np.array(leaf.astype(jnp.float32))
            toks = [np.asarray(tok)]
            for _ in range(GEN):
                tok, caches = decode(params, tok, caches)
                toks.append(np.asarray(tok))
            out[f"{case}/tokens"] = np.concatenate(toks, axis=1)
            pspecs = jm.param_specs(jax.tree.map(
                lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params))
            logits = jax.jit(jsh.shard_map(lambda p, *a: jm.apply_prefill(p, *a)[0], mesh=mesh,
                                           in_specs=(pspecs,) + (P(),) * len(ins),
                                           out_specs=P(None, None, "model")))
            out[f"{case}/logits"] = np.asarray(logits(params, *ins))
    else:
        arch, tp, pods = TRAIN[part]
        cfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=jnp.float32)
        mesh = jax.make_mesh((pods, WORLD // (pods * tp), tp), ("pod", "data", "model"))
        order = list(mesh.devices.flat)             # rank (p * data + d) * tp + m
        model = JaxModel(cfg, runtime_for_mesh(mesh))
        tcfg = JaxTrainConfig(comm_mode="hier", dcn_compression="int8",
                              opt=JaxOpt(lr=LR, warmup_steps=WARMUP))
        params = load(part)
        build, _ = jax_train_step(model, tcfg, mesh=mesh, donate=False)   # R12
        shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params)
        step, _ = build(shapes)
        pspecs = model.param_specs(shapes)
        params = jax.tree.map(lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params,
                              pspecs)
        opt = jopt.adam_init(params)
        metrics = np.zeros((WORLD, N_STEPS, 2))
        for i in range(N_STEPS):
            b = {k: jnp.asarray(v) for k, v in batch(i, cfg.vocab_size, cfg.enc_seq,
                                                     cfg.d_model).items()}
            params, opt, m = step(params, opt, b)
            for j, name in enumerate(("loss", "grad_norm")):
                for sh in m[name].addressable_shards:      # each device's own value
                    metrics[order.index(sh.device), i, j] = float(sh.data)
        out[f"{part}/metrics"] = metrics
        specs, _ = jax.tree_util.tree_flatten_with_path(pspecs,
                                                        is_leaf=lambda x: isinstance(x, P))
        for (path, _), leaf in zip(specs, jax.tree.leaves(params)):
            name = "/".join(str(k.key) for k in path)
            for sh in leaf.addressable_shards:
                out[f"{part}/param/rank{order.index(sh.device)}/{name}"] = np.asarray(sh.data)
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"), **out)


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    """One rank of the eight-rank world: every serving and training case,
    the padded TP-1 tree, then the entry points."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from _torch_world import nest
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.core import compression
    from repro_torch.kernels import ref
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.launch.train import dp_rows
    from repro_torch.serve import disaggregated
    from repro_torch.serve.serve_step import cache_leaves, make_kv_transfer, make_serve_steps
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    # ROADMAP C1: the first plain SSD call of a process, at throwaway inputs
    g = torch.Generator().manual_seed(0)
    ref.ssd_chunked(torch.randn(1, 64, 2, 8, generator=g), torch.rand(1, 64, 2, generator=g),
                    -torch.rand(2, generator=g), torch.randn(1, 64, 1, 8, generator=g),
                    torch.randn(1, 64, 1, 8, generator=g), chunk=32)

    def tree(name):
        return nest(np.load(os.path.join(out_dir, f"params_{name}.npz")))

    def serve_model(case, arch, tp, over, name=None):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32, **over)
        rt = runtime_for_groups(pods=1, data_per_pod=WORLD // tp, tp=tp)
        return params_from_jax(tree(name or case), cfg, rt, device="cpu")

    out = {}
    try:
        for case, (arch, tp, over) in SERVE.items():
            model = serve_model(case, arch, tp, over)
            cfg = model.cfg
            ins = [torch.from_numpy(a) for a in serve_inputs(cfg.vocab_size, cfg.enc_seq,
                                                             cfg.d_model)]
            ins[0] = ins[0].long()
            prefill, decode = make_serve_steps(model)
            tok, caches = prefill(*ins)
            for name, leaf in cache_leaves(caches):
                out[f"{case}/cache/{name}"] = leaf.float().numpy().copy()
            if case == "h8":
                # the int8 transfer over this rank's pod group (of one)
                moved = make_kv_transfer(model, compress="int8")(caches)
                for (name, got), (_, sent) in zip(cache_leaves(moved), cache_leaves(caches)):
                    want = sent
                    if sent.is_floating_point() and sent.numel() >= compression.BLOCK:
                        q, s = compression.quantize_int8(sent)
                        want = compression.dequantize_int8(q, s, sent.numel(), sent.dtype)
                    out[f"{case}/moved/{name}"] = np.asarray(
                        torch.equal(got.reshape(-1), want.reshape(-1)) and got.shape == sent.shape)
            toks = [tok]
            for _ in range(GEN):
                tok, caches = decode(tok, caches)
                toks.append(tok)
            out[f"{case}/tokens"] = torch.cat(toks, dim=1).numpy()
            out[f"{case}/logits"] = model.apply_prefill(*ins)[0].numpy()

        model = serve_model("pad1", "qwen1.5-4b", PAD_TP, {})
        out["pad1/logits"] = model.apply_prefill(
            torch.from_numpy(serve_inputs(model.cfg.vocab_size, 0, 0)[0]).long())[0].numpy()

        for case, (arch, tp, pods) in TRAIN.items():
            cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
            data = WORLD // (pods * tp)
            rt = runtime_for_groups(pods=pods, data_per_pod=data, tp=tp)
            model = params_from_jax(tree(case), cfg, rt, device="cpu")
            step_fn, _ = make_train_step(model, TrainConfig(
                comm_mode="hier", dcn_compression="int8",
                opt=opt_lib.OptConfig(lr=LR, warmup_steps=WARMUP)))
            opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
            rows = dp_rows(rank, GB, pods, data, tp)
            metrics = []
            for i in range(N_STEPS):
                b = batch(i, cfg.vocab_size, cfg.enc_seq, cfg.d_model)
                m = step_fn(opt, {k: torch.from_numpy(v[rows]).long() for k, v in b.items()})
                assert not m["gated"]
                metrics.append((m["loss"], m["grad_norm"]))
            out[f"{case}/metrics"] = np.asarray(metrics)
            for path, leaf in zip(model.param_specs(), model.train_leaves()):
                out[f"{case}/param/{'/'.join(path)}"] = (
                    torch.stack(leaf) if isinstance(leaf, list) else leaf).detach().numpy()

        quiet = dict(smoke=True, device="cpu")
        for arch in ("hymba-1.5b", "qwen1.5-4b", "whisper-tiny"):
            res = disaggregated.run(arch, tp=WORLD, batch=2, prompt_len=40, gen=2, **quiet)
            out[f"entry/serve/{arch}"] = np.asarray(
                [res["raw_transfer_exact"], res["cache_finite"], res["tp"] == WORLD])
            out[f"entry/serve/{arch}/tokens"] = np.asarray(res["tokens"])
        for arch, tp in (("hymba-1.5b", 8), ("qwen1.5-4b", 8), ("whisper-tiny", 4),
                         ("whisper-tiny", 8)):
            res = train_cli.run(arch, tp=tp, steps=2, seq=32, global_batch=WORLD // tp,
                                mode="hier", compression="int8", log=lambda *a, **k: None,
                                **quiet)
            out[f"entry/train/{arch}/{tp}"] = np.asarray(res["losses"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _jax_main(sys.argv[1], sys.argv[2])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from _torch_world import flat_tree, nest, run_world  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from test_torch_ssm import _conv_state_close  # noqa: E402
from test_torch_tp import _RankRt, _run_ranks  # noqa: E402

TOL = {"qwen1.5-4b": 1e-5, "whisper-tiny": 1e-5, "hymba-1.5b": 1e-4}


def _jax_tree(arch: str, tp: int, **over) -> dict:
    cfg = dataclasses.replace(jax_config(arch, smoke=True), dtype=jnp.float32, **over)
    params = JaxModel(cfg, JaxRuntime(tp_axis="model" if tp > 1 else None, tp_size=tp)).init(
        jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _pad_heads(tree: dict, cfg, tp: int) -> dict:
    """A TP-1 tree (the reference's layout, layer leaves stacked) at TP
    ``tp``'s shapes: zero phantom Q heads (columns of wq and bq, rows of
    wo), zero phantom KV heads (columns of wk/wv, entries of bk/bv) and
    zero vocabulary rows."""
    dh = cfg.head_dim
    widths = {"wq": cfg.padded_heads(tp), "bq": cfg.padded_heads(tp),
              "wk": cfg.padded_kv_heads(tp), "wv": cfg.padded_kv_heads(tp),
              "bk": cfg.padded_kv_heads(tp), "bv": cfg.padded_kv_heads(tp),
              "wo": cfg.padded_heads(tp)}
    out = flat_tree(tree)
    for path, a in out.items():
        name = path.split("/")[-1]
        if "/attn/" in path and name in widths:
            dim = a.ndim - 2 if name == "wo" else a.ndim - 1
            pad = [(0, 0)] * a.ndim
            pad[dim] = (0, widths[name] * dh - a.shape[dim])
            out[path] = np.pad(a, pad)
        elif name in ("embed", "lm_head"):
            out[path] = np.pad(a, [(0, cfg.padded_vocab(tp) - a.shape[0]), (0, 0)])
    return nest(out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case on 8 gloo ranks and in JAX on 8 host devices: (the
    reference's results, each rank's)."""
    tmp = tmp_path_factory.mktemp("padding_world")
    for case, (arch, tp, over) in SERVE.items():
        np.savez(tmp / f"params_{case}.npz", **flat_tree(_jax_tree(arch, tp, **over)))
    for case, (arch, tp, _) in TRAIN.items():
        np.savez(tmp / f"params_{case}.npz", **flat_tree(_jax_tree(arch, tp)))
    cfg = jax_config("qwen1.5-4b", smoke=True)
    np.savez(tmp / "params_pad1.npz",
             **flat_tree(_pad_heads(_jax_tree("qwen1.5-4b", 1), cfg, PAD_TP)))
    return run_world(__file__, tmp, JAX_PARTS, WORLD, _gloo_rank, WORLD, timeout=400)


def _close(name: str, got: np.ndarray, want: np.ndarray, tol: float, msg: str) -> None:
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if name.endswith("conv"):
        _conv_state_close(torch.from_numpy(got).bfloat16(), want, torch.float32, msg)
    elif name.endswith("length"):
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=msg)


@pytest.mark.parametrize("case", list(SERVE))
def test_serving_matches_jax(results, case):
    """Every rank's logits shard, tokens and prefill cache shard; rank r
    is model index r % T of its TP group."""
    want, ranks = results
    arch, tp, over = SERVE[case]
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    for rank, got in enumerate(ranks):
        r = rank % tp
        np.testing.assert_array_equal(got[f"{case}/tokens"], want[f"{case}/tokens"])
        vl = got[f"{case}/logits"].shape[-1]
        assert vl * tp == cfg.padded_vocab(tp)
        np.testing.assert_allclose(got[f"{case}/logits"],
                                   want[f"{case}/logits"][..., r * vl:(r + 1) * vl],
                                   rtol=0, atol=TOL[arch], err_msg=f"rank {rank}")
        names = [k.split("/", 2)[2] for k in got.files if k.startswith(f"{case}/cache/")]
        assert sorted(names) == sorted(k.split("/", 2)[2] for k in want
                                       if k.startswith(f"{case}/cache/"))
        for name in names:
            _close(name, got[f"{case}/cache/{name}"],
                   _cache_shard(want[f"{case}/cache/{name}"], r, tp, name), TOL[arch],
                   f"{case} rank {rank} {name}")
    # the local heads a rank caches: its Q heads where KV is replicated
    kl = cfg.local_q_heads(tp) if cfg.kv_replicated(tp) else cfg.padded_kv_heads(tp) // tp
    k = ranks[0][f"{case}/cache/{'k' if cfg.family == 'dense' else 'kv.k'}"]
    assert k.shape[3] == kl


def test_hybrid_cache_int8_transfer_at_tp8(results):
    """Each leaf of the hymba TP-8 shard (1 local KV head, 1 SSM head)
    crosses as the rule says: through the codec from 1024 values on
    (k, v), raw below (the smoke shard's conv and SSM state, the
    lengths), shapes kept."""
    _, ranks = results
    for rank, got in enumerate(ranks):
        moved = {k: bool(got[k]) for k in got.files if k.startswith("h8/moved/")}
        assert len(moved) == 6 and all(moved.values()), (rank, moved)


def test_replicated_kv_at_tp8_gathers_the_references_map(results):
    """qwen1.5-4b smoke at TP 8: 5 KV heads replicated, rank r's one Q head
    reads KV head r * 5 // 8 (ranks 0-1 head 0, rank 7 head 4); two ranks
    that share a KV head cache the same K."""
    _, ranks = results
    k = [ranks[r]["q8/cache/k"] for r in range(WORLD)]
    np.testing.assert_array_equal(k[0], k[1])
    assert not np.allclose(k[1], k[2])


@pytest.mark.parametrize("case", list(TRAIN))
def test_training_matches_jax(results, case):
    """Losses and grad norms per device within 1e-4 (relative: hymba's grad
    norms reach 84); parameters within 2 lr,
    all but 0.1% within 1e-4 (an int8 rounding that falls another way
    moves an Adam step by up to lr)."""
    want, ranks = results
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{case}/metrics"], want[f"{case}/metrics"][r],
                                   rtol=1e-4, atol=0, err_msg=f"rank {r}")
        names = sorted(k.split("/", 2)[2] for k in got.files if k.startswith(f"{case}/param/"))
        assert names == sorted(k.split("/", 3)[3] for k in want
                               if k.startswith(f"{case}/param/rank{r}/"))
        far = total = 0
        for name in names:
            a, b = got[f"{case}/param/{name}"], want[f"{case}/param/rank{r}/{name}"]
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR, err_msg=f"rank {r} {name}")
            far += int((np.abs(a - b) > 1e-4).sum())
            total += a.size
        assert far <= 1e-3 * total, f"rank {r}: {far} of {total} parameters beyond 1e-4"


@pytest.mark.parametrize("case", list(TRAIN))
def test_phantom_wo_rows_after_training(results, case):
    """The rows of ``wo`` that belong to phantom Q heads: still zero in
    both packages where KV is sharded (qwen1.5-4b at TP 4: heads 5-7 read
    zero phantom KV heads), moved from zero in both where KV is
    replicated (they read real KV heads, R23), and the same in both."""
    want, ranks = results
    arch, tp, _ = TRAIN[case]
    cfg = get_config(arch, smoke=True)
    hl, dh = cfg.local_q_heads(tp), cfg.head_dim
    moved = []
    for rank, got in enumerate(ranks):
        r = rank % tp
        phantom = [j for j in range(hl) if r * hl + j >= cfg.n_heads]
        if not phantom:
            continue
        rows = np.concatenate([np.arange(j * dh, (j + 1) * dh) for j in phantom])
        a = got[f"{case}/param/layers/attn/wo"][:, rows]
        b = want[f"{case}/param/rank{rank}/layers/attn/wo"][:, rows]
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR, err_msg=f"rank {rank}")
        moved.append((np.abs(a).max(), np.abs(b).max()))
    assert moved, "no rank holds a phantom head"
    if cfg.kv_replicated(tp):
        assert all(x > 0 and y > 0 for x, y in moved), moved
    else:
        assert all(x == 0 and y == 0 for x, y in moved), moved


def test_zero_padded_tp1_tree_keeps_the_tp1_function(results):
    """qwen1.5-4b smoke's TP-1 tree with zero heads up to TP 4's 8 Q / 8 KV:
    the TP-4 ranks' logits, gathered, are the TP-1 logits within 1e-5.
    With sharded KV each phantom Q head reads a phantom KV head whose v is
    zero, so no real head's grouping changes."""
    _, ranks = results
    cfg = dataclasses.replace(get_config("qwen1.5-4b", smoke=True), dtype=torch.float32)
    tm = params_from_jax(_jax_tree("qwen1.5-4b", 1), cfg, device="cpu")
    prompt = torch.from_numpy(serve_inputs(cfg.vocab_size, 0, 0)[0]).long()
    want = tm.apply_prefill(prompt)[0].numpy()
    got = np.concatenate([ranks[r]["pad1/logits"] for r in range(PAD_TP)], axis=-1)
    np.testing.assert_allclose(got[..., :cfg.vocab_size], want[..., :cfg.vocab_size],
                               rtol=0, atol=1e-5)


def test_entry_points_run_with_padded_heads(results):
    """The server's ``run`` at TP 8 (hymba: 32 Q / 5 KV replicated at full
    width, 8 / 2 smoke) and the trainer's at TP 8 and, for whisper, TP 4:
    every rank the same finite losses and tokens, the raw transfer exact."""
    _, ranks = results
    for arch in ("hymba-1.5b", "qwen1.5-4b", "whisper-tiny"):
        for got in ranks:
            assert got[f"entry/serve/{arch}"].all(), arch
            np.testing.assert_array_equal(got[f"entry/serve/{arch}/tokens"],
                                          ranks[0][f"entry/serve/{arch}/tokens"])
    for key in [k for k in ranks[0].files if k.startswith("entry/train/")]:
        losses = ranks[0][key]
        assert losses.shape == (2,) and np.isfinite(losses).all(), key
        for got in ranks:
            np.testing.assert_array_equal(got[key], losses)
    assert len([k for k in ranks[0].files if k.startswith("entry/train/")]) == 4


def test_whisper_server_at_tp4_on_4_processes():
    """``python -m repro_torch.serve.disaggregated --arch whisper-tiny --tp 4``
    at full width as 4 processes: 6 heads padded to 8, 2 Q / 2 KV a rank
    in the self- and the cross-attention cache.  (The smoke whisper's 4
    heads split 4 ways; its padded case is TP 8, served in the world.)"""
    cfg = get_config("whisper-tiny")
    outs = _run_ranks("repro_torch.serve.disaggregated",
                      ["--arch", "whisper-tiny", "--device", "cpu", "--batch", "1",
                       "--prompt-len", "16", "--gen", "2", "--tp", "4"], 4)
    kv = [cfg.n_layers, 1, 16, 2, cfg.head_dim]
    cross = [cfg.n_layers, 1, cfg.enc_seq, 2, cfg.head_dim]
    for rank, (res,) in enumerate(outs):
        assert (res["rank"], res["tp"]) == (rank, 4)
        assert res["raw_transfer_exact"] and res["cache_finite"]
        assert res["cache_shapes"] == {"kv.k": kv, "kv.v": kv, "kv.length": [cfg.n_layers],
                                       "cross.k": cross, "cross.v": cross,
                                       "cross.length": [cfg.n_layers]}


# ---------------------------------------------------------------------------
# From shapes alone, and the Q -> KV maps
# ---------------------------------------------------------------------------

def _global_shapes(tree: dict) -> dict:
    out = {}
    for key, v in tree.items():
        if isinstance(v, torch.Tensor):
            out[(key,)] = tuple(v.shape)
        elif key in tmodel.STACKED:
            out.update({path: (len(v),) + tuple(t.shape)
                        for path, t in tmodel._paths(v[0], (key,))})
        else:
            out.update({path: tuple(t.shape) for path, t in tmodel._paths(v, (key,))})
    return out


@pytest.mark.parametrize("arch, tp", [("qwen1.5-4b", 8), ("whisper-tiny", 4),
                                      ("whisper-tiny", 8), ("hymba-1.5b", 8)])
def test_full_width_specs_and_shards_are_the_references(arch, tp):
    """At full width, drawn under FakeTensorMode: every leaf's global shape
    and its spec at (TP ``tp``, FSDP 2) as the reference's ``param_specs``
    of its ``eval_shape``, and the last rank's TP shard of every leaf as
    that spec cuts the reference's global shape."""
    cfg, jc = get_config(arch), jax_config(arch)
    jm = JaxModel(jc, JaxRuntime(tp_axis="model", tp_size=tp, fsdp_axis="data")).with_fsdp(2)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(
        jm.param_specs(shapes), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {"/".join(str(k.key) for k in path): (tuple(leaf.shape), tuple(spec))
            for (path, spec), leaf in zip(flat, jax.tree.leaves(shapes))}
    rt = _RankRt(tp_group="tp", size=tp, rank=tp - 1)
    with FakeTensorMode():
        model = Model(cfg, rt, device="cpu")
        tree = model.draw(0)
        specs = tmodel.param_specs(tree, cfg, tp, 2)
        local = _global_shapes(model.set_params(tree).param_tree())
    glob = _global_shapes(tree)
    got = {"/".join(p): (glob[p], s) for p, s in specs.items()}
    assert got == want
    for path, spec in specs.items():
        shard = tuple(n // tp if a == "model" else n for n, a in zip(glob[path], spec))
        assert local[path] == shard, path
    hp = cfg.padded_heads(tp)
    assert glob[("layers", "attn", "wq")][-1] == hp * cfg.head_dim
    assert local[("layers", "attn", "wq")][-1] == hp // tp * cfg.head_dim


def _ref_maps(cfg, tp: int) -> np.ndarray:
    """The reference's Q -> KV map: at TP ``tp`` its ``_kv_map_for_local_q``
    under vmap over a named model axis, at TP 1 its ``_repeat_kv`` of the
    KV head ids."""
    if tp == 1:
        ids = jnp.arange(cfg.n_kv_heads, dtype=jnp.float32).reshape(1, 1, -1, 1)
        return np.asarray(jattn._repeat_kv(ids, cfg.n_heads // cfg.n_kv_heads)).reshape(-1)
    rt = JaxRuntime(tp_axis="model", tp_size=tp)
    maps = jax.vmap(lambda _: jattn._kv_map_for_local_q(cfg, rt), axis_name="model")(
        jnp.arange(tp))
    return np.asarray(maps).reshape(-1)


def _port_maps(cfg, tp: int) -> np.ndarray:
    if tp == 1:
        ids = torch.arange(cfg.n_kv_heads, dtype=torch.float32).reshape(1, 1, -1, 1)
        return tattn._repeat_kv(ids, cfg.n_heads // cfg.n_kv_heads).reshape(-1).numpy()
    return np.concatenate([tattn._kv_map_for_local_q(cfg, _RankRt(tp_group="tp", size=tp,
                                                                  rank=r)).numpy()
                           for r in range(tp)])


@pytest.mark.parametrize("smoke, heads", [(False, [5, 6]), (True, [2, 3])])
def test_r23_kv_map_at_tp8_differs_from_tp1(smoke, heads):
    """ROADMAP R23: with replicated KV and padded Q heads the reference maps
    Q head h to KV head h * K // Hp, at TP 1 to h // (H // K); both packages
    alike.  hymba-1.5b (25 / 5, Hp 32): head 5 reads KV 0 at TP 8 and KV 1
    at TP 1; the smoke (4 / 2, Hp 8): heads 2-3 read KV 0 and KV 1."""
    cfg, jc = get_config("hymba-1.5b", smoke=smoke), jax_config("hymba-1.5b", smoke=smoke)
    m8, m1 = _ref_maps(jc, 8), _ref_maps(jc, 1)
    np.testing.assert_array_equal(_port_maps(cfg, 8), m8)
    np.testing.assert_array_equal(_port_maps(cfg, 1), m1)
    assert len(m8) == cfg.padded_heads(8) and len(m1) == cfg.n_heads
    for h in heads:
        assert m8[h] != m1[h], h
    assert m8[heads[0]] == 0 and m1[heads[0]] == 1
