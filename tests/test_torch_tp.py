"""Tensor parallelism of the port against the JAX package's, smoke qwen2.5-3b.

* Eight gloo ranks, spawned once, as a (pod 2, data 2, model 2) world,
  against the reference on a mesh of the same shape over 8 host devices
  (the JAX side runs this file as a script), from the same f32
  parameters and batches: three training steps each of ``flat``,
  ``hier`` + int8, ``hier_pipelined`` + int8, ``hier_border_rs`` + bf16,
  ``hier_overlap`` + int8 (1 MiB buckets), ``hier_zero1`` + int8,
  ``fsdp`` + int8 and ``hier`` with sequence parallelism: losses and
  grad norms within 1e-3.  ``fsdp`` runs at d_ff 1024, so that the MLP
  leaves, halved by TP, still reach FSDP_MIN_SIZE and are sharded over
  the data group too.
* In the same world, TP 2 and TP 4 serving (the smoke model has 2 KV
  heads: fewer than 4 ranks is the replicated-KV path) against
  ``make_serve_steps`` on a (data 1, model T) mesh: tokens of a prefill
  and four decode steps equal, prefill logits and KV-cache shards within
  1e-5 in f32.
* ``copy_to_tp``, ``reduce_from_tp``, ``gather_sp`` and ``scatter_sp`` on
  the TP groups, forward and backward, and the vocab-sharded
  ``sharded_xent`` (value and gradient) and ``sharded_argmax`` (a tie
  across shards, a tie within one, labels and a maximum in the padded
  range) against the reference's under ``shard_map``.
* Each rank's converted shards, TP and FSDP, equal the reference's
  addressable shards.
* Four places where the port differed from the reference before tensor
  parallelism came: the replicated-KV cache layout, the per-Q-head K/V
  gather, the data-parallel group (the ranks of one model index) and
  the batch rows (by data-parallel index).
* Both entry points at ``--tp 2`` on the CPU.
"""

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys

import numpy as np

WORLD, GB, S, N_STEPS = 8, 4, 32, 3
LR, WARMUP = 1e-2, 1
# (comm mode, pod-hop codec, sequence parallelism) of the eight-rank runs
TRAIN_CASES = [("flat", None, False), ("hier", "int8", False), ("hier_pipelined", "int8", False),
               ("hier_border_rs", "bf16", False), ("hier_overlap", "int8", False),
               ("hier_zero1", "int8", False), ("fsdp", "int8", False), ("hier", None, True)]
FSDP_D_FF = 1024          # w_gate at TP 2: 2 x 64 x 512 = 2^16
OVERLAP_CAP_MB = 1
SERVE_TP = (2, 4)
SB, SS, GEN = 2, 24, 4    # serving batch, prompt, decode steps
# the loss's vocab shards: 2 x 8 columns, the last 3 padding
LOSS_TP, LOSS_VL, LOSS_VOCAB = 2, 8, 13
PAIR_SHAPE = (2, 6, 4)    # (B, S, D) of the autograd-pair inputs (gathered S)
# the JAX side's processes, run side by side: the training cases dealt
# round-robin over three (compiling a step dominates), and the rest
JAX_TRAIN_PROCS = 3
JAX_PARTS = tuple(f"train{i}" for i in range(JAX_TRAIN_PROCS)) + ("serve",)


def case_id(mode: str, codec, sp: bool) -> str:
    return f"{mode}_{codec}{'_sp' if sp else ''}"


def batch(step: int, vocab: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return {"tokens": rng.integers(0, vocab, (GB, S), dtype=np.int32),
            "labels": rng.integers(0, vocab, (GB, S), dtype=np.int32)}


def serve_prompt(vocab: int) -> np.ndarray:
    return np.random.default_rng(11).integers(0, vocab, (SB, SS), dtype=np.int32)


def pair_inputs(tp_rank: int) -> dict:
    """This TP rank's inputs and cotangents of the autograd pairs."""
    rng = np.random.default_rng(50 + tp_rank)
    B, Sg, D = PAIR_SHAPE
    full = rng.normal(size=(B, Sg, D)).astype(np.float32)
    half = rng.normal(size=(B, Sg // LOSS_TP, D)).astype(np.float32)
    return {"x": full, "ct": rng.normal(size=(B, Sg, D)).astype(np.float32),
            "x_half": half, "ct_half": rng.normal(size=half.shape).astype(np.float32)}


def loss_inputs() -> tuple[np.ndarray, np.ndarray]:
    """Global logits (2, 3, 16) and labels (2, 3): ids 2 and 10 tie for
    the maximum across the two shards, ids 3 and 5 within one, the
    largest value sits in a padded column, and labels fall in the padded
    range (13, 15) and below zero."""
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(2, 3, LOSS_TP * LOSS_VL)).astype(np.float32)
    logits[0, 0, 2] = logits[0, 0, 10] = 5.0
    logits[1, 1, 3] = logits[1, 1, 5] = 6.0
    logits[1, 2, 14] = 100.0
    labels = np.array([[0, 9, 13], [15, 2, -1]], dtype=np.int32)
    return logits, labels


def _jax_main(out_dir: str, part: str) -> None:
    """The reference on 8 host devices: the results this file compares,
    the training cases of ``part`` "train<i>" or the rest ("serve")."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config as jax_config
    from repro.launch.mesh import runtime_for_mesh
    from repro.models import Model as JaxModel
    from repro.parallel import sharding as jsh
    from repro.serve import make_serve_steps as jax_serve_steps
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import loss as jloss
    from repro.train import make_train_step as jax_train_step
    from repro.train import optimizer as jopt
    from repro.train.optimizer import OptConfig as JaxOpt

    from _torch_world import nest as _nest

    out = {}
    base = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), dtype=jnp.float32)
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))

    def rank_of(device) -> int:
        p, d, m = np.argwhere(mesh.devices == device)[0]
        return int((p * 2 + d) * 2 + m)

    if part.startswith("train"):
        # the batch rows each device trains on
        arr = jax.device_put(np.arange(GB * S).reshape(GB, S),
                             NamedSharding(mesh, P(("pod", "data"))))
        for sh in arr.addressable_shards:
            out[f"rows/rank{rank_of(sh.device)}"] = np.asarray(sh.data)[:, 0] // S

        # training
        trees = {name: jax.tree.map(jnp.asarray,
                                    _nest(np.load(os.path.join(out_dir, f"params_{name}.npz"))))
                 for name in ("base", "fsdp")}
        for mode, codec, sp in TRAIN_CASES[int(part[5:])::JAX_TRAIN_PROCS]:
            fsdp = mode == "fsdp"
            cfg = dataclasses.replace(base, d_ff=FSDP_D_FF) if fsdp else base
            model = JaxModel(cfg, runtime_for_mesh(mesh, fsdp=fsdp, sp=sp))
            if fsdp:
                model = model.with_fsdp(2)
            tcfg = JaxTrainConfig(comm_mode=mode, dcn_compression=codec, bucket_cap_mb=OVERLAP_CAP_MB,
                                  opt=JaxOpt(lr=LR, warmup_steps=WARMUP))
            params = trees["fsdp" if fsdp else "base"]
            # donated, the reference's step fails XLA's alias check on a mesh
            # with a model axis (an input shard aliased to another leaf's
            # output); donation changes nothing it computes
            build, _ = jax_train_step(model, tcfg, mesh=mesh, donate=False)
            shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params)
            step, boot = build(shapes)
            # the state the reference's init_fn gives these parameters
            opt = boot(params) if boot is not None else jopt.adam_init(params)
            if fsdp:
                # every device's shard of every leaf, by rank
                specs, _ = jax.tree_util.tree_flatten_with_path(
                    model.param_specs(shapes), is_leaf=lambda x: isinstance(x, P))
                for (path, spec), leaf in zip(specs, jax.tree.leaves(params)):
                    name = "/".join(str(k.key) for k in path)
                    for sh in jax.device_put(leaf, NamedSharding(mesh, spec)).addressable_shards:
                        out[f"shard/rank{rank_of(sh.device)}/{name}"] = np.asarray(sh.data)
            metrics = []
            for i in range(N_STEPS):
                b = {k: jnp.asarray(v) for k, v in batch(i, cfg.vocab_size).items()}
                params, opt, m = step(params, opt, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            out[f"train/{case_id(mode, codec, sp)}"] = np.asarray(metrics)
    else:
        # serving on a (data 1, model T) mesh
        prompt = jnp.asarray(serve_prompt(base.vocab_size))
        for tp in SERVE_TP:
            smesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("data", "model"))
            jm = JaxModel(base, runtime_for_mesh(smesh))
            params = jax.tree.map(jnp.asarray,
                                  _nest(np.load(os.path.join(out_dir, f"params_tp{tp}.npz"))))
            prefill, decode, _ = jax_serve_steps(jm, smesh, SB, SS + GEN)
            tok, caches = prefill(params, prompt)
            toks = [np.asarray(tok)]
            # copies: decode donates the cache
            out[f"serve{tp}/k"], out[f"serve{tp}/v"] = np.array(caches.k), np.array(caches.v)
            for _ in range(GEN):
                tok, caches = decode(params, tok, caches)
                toks.append(np.asarray(tok))
            out[f"serve{tp}/tokens"] = np.concatenate(toks, axis=1)
            pspecs = jm.param_specs(jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype),
                                                 params))
            logits = jax.jit(jsh.shard_map(lambda p, t: jm.apply_prefill(p, t)[0], mesh=smesh,
                                           in_specs=(pspecs, P()), out_specs=P(None, None, "model")))
            out[f"serve{tp}/logits"] = np.asarray(logits(params, prompt))

        # the autograd pairs and the loss on a 2-device model axis
        tmesh = Mesh(np.array(jax.devices()[:LOSS_TP]), ("model",))

        def per_rank(fn, *arrays):
            """fn on each device's [0] of the stacked inputs, restacked."""
            body = lambda *xs: jax.tree.map(lambda y: y[None], fn(*(x[0] for x in xs)))  # noqa: E731
            return jax.jit(jsh.shard_map(body, mesh=tmesh, in_specs=(P("model"),) * len(arrays),
                                         out_specs=P("model")))(*arrays)

        ins = {k: np.stack([pair_inputs(r)[k] for r in range(LOSS_TP)]) for k in pair_inputs(0)}
        pairs = {"copy_to_tp": (jsh.copy_to_tp, "x", "ct"),
                 "reduce_from_tp": (jsh.reduce_from_tp, "x", "ct"),
                 "gather_sp": (jsh.gather_sp, "x_half", "ct"),
                 "scatter_sp": (jsh.scatter_sp, "x", "ct_half")}
        for name, (fn, x, ct) in pairs.items():
            def fwd_bwd(xx, cc, fn=fn):
                y, vjp = jax.vjp(lambda a: fn(a, "model"), xx)
                return y, vjp(cc)[0]
            y, g = per_rank(fwd_bwd, ins[x], ins[ct])
            out[f"pair/{name}/out"], out[f"pair/{name}/grad"] = np.asarray(y), np.asarray(g)

        logits, labels = loss_inputs()
        shards = np.stack(np.split(logits, LOSS_TP, axis=-1))
        lbl = np.stack([labels] * LOSS_TP)
        rt = jsh.Runtime(tp_axis="model", tp_size=LOSS_TP)

        def loss_fn(lg, lb):
            (loss, met), grad = jax.value_and_grad(
                lambda a: jloss.sharded_xent(a, lb, rt, LOSS_VOCAB), has_aux=True)(lg)
            return loss, met["mean_logp"], grad, jloss.sharded_argmax(lg, rt, LOSS_VOCAB)
        loss, logp, grad, arg = per_rank(loss_fn, shards, lbl)
        out.update({"loss/value": np.asarray(loss), "loss/mean_logp": np.asarray(logp),
                    "loss/grad": np.asarray(grad), "loss/argmax": np.asarray(arg)})
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"), **out)


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    """One rank of the eight-rank world: every port result this file
    compares, saved as rank{rank}.npz."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.launch.train import dp_rows
    from repro_torch.parallel import sharding as tsh
    from repro_torch.serve.serve_step import make_serve_steps
    from repro_torch.train import loss as tloss
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step, zero_bootstrap

    from _torch_world import nest as _nest

    torch.set_num_threads(1)        # eight ranks share the host's cores
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        base = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=torch.float32)
        rt = runtime_for_groups(pods=2, data_per_pod=2, tp=2)
        for role in ("tp_group", "data_group", "pod_group", "dp_group"):
            out[f"group/{role}"] = np.asarray(dist.get_process_group_ranks(getattr(rt, role)))
        rows = dp_rows(rank, GB, 2, 2, 2)
        out["rows"] = np.arange(GB)[rows]

        trees = {name: _nest(np.load(os.path.join(out_dir, f"params_{name}.npz")))
                 for name in ("base", "fsdp")}
        for mode, codec, sp in TRAIN_CASES:
            fsdp = mode == "fsdp"
            cfg = dataclasses.replace(base, d_ff=FSDP_D_FF) if fsdp else base
            case_rt = dataclasses.replace(rt, sp=sp, fsdp_group=rt.data_group if fsdp else None)
            model = params_from_jax(trees["fsdp" if fsdp else "base"], cfg, case_rt,
                                    device="cpu", fsdp=2 if fsdp else 1)
            if fsdp:
                for path, leaf in zip(model.param_specs(), model.train_leaves()):
                    # a copy: the steps below update the parameters in place
                    out[f"shard/{'/'.join(path)}"] = (torch.stack(leaf) if isinstance(leaf, list)
                                                      else leaf.clone()).numpy()
            tcfg = TrainConfig(comm_mode=mode, dcn_compression=codec,
                               bucket_cap_mb=OVERLAP_CAP_MB,
                               opt=opt_lib.OptConfig(lr=LR, warmup_steps=WARMUP))
            step_fn, _ = make_train_step(model, tcfg)
            if mode == "hier_zero1":
                opt = zero_bootstrap(model, tcfg)
            else:
                opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
            metrics = []
            for i in range(N_STEPS):
                b = {k: torch.from_numpy(v[rows]).long() for k, v in batch(i, cfg.vocab_size).items()}
                m = step_fn(opt, b)
                assert not m["gated"]
                metrics.append((m["loss"], m["grad_norm"]))
            out[f"train/{case_id(mode, codec, sp)}"] = np.asarray(metrics)

        prompt = torch.from_numpy(serve_prompt(base.vocab_size)).long()
        for tp in SERVE_TP:
            srt = runtime_for_groups(pods=1, data_per_pod=WORLD // tp, tp=tp)
            model = params_from_jax(_nest(np.load(os.path.join(out_dir, f"params_tp{tp}.npz"))),
                                    base, srt, device="cpu")
            prefill, decode = make_serve_steps(model)
            tok, caches = prefill(prompt)
            # copies: decode writes the cache in place
            out[f"serve{tp}/k"], out[f"serve{tp}/v"] = caches.k.numpy().copy(), caches.v.numpy().copy()
            toks = [tok]
            for _ in range(GEN):
                tok, caches = decode(tok, caches)
                toks.append(tok)
            out[f"serve{tp}/tokens"] = torch.cat(toks, dim=1).numpy()
            out[f"serve{tp}/logits"] = model.apply_prefill(prompt)[0].numpy()

        r = rt.tp_rank
        ins = {k: torch.from_numpy(v) for k, v in pair_inputs(r).items()}
        pairs = {"copy_to_tp": (tsh.copy_to_tp, "x", "ct"),
                 "reduce_from_tp": (tsh.reduce_from_tp, "x", "ct"),
                 "gather_sp": (tsh.gather_sp, "x_half", "ct"),
                 "scatter_sp": (tsh.scatter_sp, "x", "ct_half")}
        for name, (fn, x, ct) in pairs.items():
            xx = ins[x].clone().requires_grad_(True)
            y = fn(xx, rt.tp_group)
            (g,) = torch.autograd.grad(y, xx, ins[ct])
            out[f"pair/{name}/out"], out[f"pair/{name}/grad"] = y.detach().numpy(), g.numpy()

        logits, labels = loss_inputs()
        lg = torch.from_numpy(np.split(logits, LOSS_TP, axis=-1)[r]).requires_grad_(True)
        loss, met = tloss.sharded_xent(lg, torch.from_numpy(labels).long(), rt, LOSS_VOCAB)
        (g,) = torch.autograd.grad(loss, lg)
        out.update({"loss/value": loss.detach().numpy(), "loss/mean_logp": met["mean_logp"].detach().numpy(),
                    "loss/grad": g.numpy(),
                    "loss/argmax": tloss.sharded_argmax(lg.detach(), rt, LOSS_VOCAB).numpy()})
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

from _torch_world import ROOT, flat_tree, run_world  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import dp_rows  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import Model, pad_vocab  # noqa: E402
from repro_torch.parallel.sharding import Runtime  # noqa: E402

MESH_RANKS = {"tp_group": lambda p, d, m: [(p * 2 + d) * 2 + i for i in range(2)],
              "data_group": lambda p, d, m: [(p * 2 + i) * 2 + m for i in range(2)],
              "pod_group": lambda p, d, m: [(i * 2 + d) * 2 + m for i in range(2)],
              "dp_group": lambda p, d, m: [(i * 2 + j) * 2 + m for i in range(2) for j in range(2)]}


def _jax_params(tp: int, **overrides) -> dict:
    cfg = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), dtype=jnp.float32, **overrides)
    params = JaxModel(cfg, JaxRuntime(tp_axis="model", tp_size=tp)).init(jax.random.key(0))
    return flat_tree(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case on 8 gloo ranks and in JAX on 8 host devices: (the
    reference's results, each rank's)."""
    tmp = tmp_path_factory.mktemp("tp_world")
    np.savez(tmp / "params_base.npz", **_jax_params(2))
    np.savez(tmp / "params_fsdp.npz", **_jax_params(2, d_ff=FSDP_D_FF))
    for tp in SERVE_TP:
        np.savez(tmp / f"params_tp{tp}.npz", **_jax_params(tp))
    return run_world(__file__, tmp, JAX_PARTS, WORLD, _gloo_rank, WORLD)


@pytest.mark.parametrize("mode, codec, sp", TRAIN_CASES)
def test_training_2x2x2_matches_jax(results, mode, codec, sp):
    want, ranks = results
    key = f"train/{case_id(mode, codec, sp)}"
    for got in ranks:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3)


def _ref_cache_shard(a: np.ndarray, r: int, window: int) -> np.ndarray:
    """Device r's (L, B, W, kl, dh) cache in the reference's global f32
    cache: its ``cache_specs`` takes a 5-D f32 leaf for an SSM state and
    puts the model axis on dim 2, so the shards lie side by side along W."""
    return a[:, :, r * window:(r + 1) * window]


@pytest.mark.parametrize("tp", SERVE_TP)
def test_serving_matches_jax(results, tp):
    """Ranks 0..tp-1 form the first TP group; rank r's logits and cache
    are device r's shards of the reference's (the vocabulary on the last
    dim of the logits)."""
    want, ranks = results
    for r in range(tp):
        got = ranks[r]
        np.testing.assert_array_equal(got[f"serve{tp}/tokens"], want[f"serve{tp}/tokens"])
        vl = got[f"serve{tp}/logits"].shape[-1]
        np.testing.assert_allclose(got[f"serve{tp}/logits"],
                                   want[f"serve{tp}/logits"][..., r * vl:(r + 1) * vl],
                                   rtol=0, atol=1e-5)
        for leaf in ("k", "v"):
            np.testing.assert_allclose(got[f"serve{tp}/{leaf}"],
                                       _ref_cache_shard(want[f"serve{tp}/{leaf}"], r, SS),
                                       rtol=0, atol=1e-5)


def test_replicated_kv_cache_at_tp4_holds_the_gathered_heads(results):
    """TP 4 over 2 KV heads: each rank caches the one KV head its local Q
    head uses (ranks 0-1 head 0, ranks 2-3 head 1), the reference's
    layout and contents."""
    want, ranks = results
    for r in range(4):
        k = ranks[r]["serve4/k"]
        ref = _ref_cache_shard(want["serve4/k"], r, SS)
        assert k.shape == ref.shape and k.shape[3] == 1
        np.testing.assert_allclose(k, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["serve4/k"], ranks[1]["serve4/k"], rtol=0, atol=1e-6)
    assert not np.allclose(ranks[1]["serve4/k"], ranks[2]["serve4/k"])


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_cache_shape_is_the_reference(tp):
    """Full-width qwen2.5-3b (16 Q / 2 KV heads): at TP 4 and 8 the KV
    heads are replicated and the cache holds the local Q heads' gather."""
    jcfg, cfg = jax_config("qwen2.5-3b"), get_config("qwen2.5-3b")
    want = jax.eval_shape(lambda: jattn.make_cache(jcfg, 2, tp, 64)).k.shape
    got = tattn.make_cache(cfg, 3, 2, tp, 64, torch.bfloat16, "meta").k.shape
    assert tuple(got) == (3,) + tuple(want)


@dataclasses.dataclass(frozen=True)
class _RankRt(Runtime):
    """A Runtime that reports a TP size and rank without a process group
    (for the functions that only read them)."""
    size: int = 1
    rank: int = 0

    @property
    def tp(self) -> int:
        return self.size

    @property
    def tp_rank(self) -> int:
        return self.rank


@pytest.mark.parametrize("n_heads, tp", [(8, 4), (4, 4)])
def test_kv_gathered_per_local_q_head(n_heads, tp):
    """Replicated KV (2 KV heads, TP 4): each rank's K and V hold, per
    local Q head, the KV head the reference's map gives it, against
    the reference's _project_qkv under vmap over a named model axis."""
    jcfg = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), n_heads=n_heads,
                               dtype=jnp.float32)
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), n_heads=n_heads,
                              dtype=torch.float32)
    assert cfg.kv_replicated(tp)
    p = jax.tree.map(np.asarray, jattn.init_attention(jax.random.key(3), jcfg, tp, jnp.float32))
    x = np.random.default_rng(4).normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    hl = cfg.local_q_heads(tp) * cfg.head_dim

    def local(r):
        return {k: v[..., r * hl:(r + 1) * hl] if k in ("wq", "bq") else v for k, v in p.items()
                if k != "wo"}

    jrt = JaxRuntime(tp_axis="model", tp_size=tp)
    stacked = {k: np.stack([local(r)[k] for r in range(tp)]) for k in local(0)}
    jq, jk, jv = jax.vmap(lambda lp: jattn._project_qkv(lp, x, x, jcfg, jrt),
                          axis_name="model")(stacked)
    for r in range(tp):
        q, k, v = tattn._project_qkv({n: torch.tensor(a) for n, a in local(r).items()},
                                     torch.from_numpy(x), torch.from_numpy(x), cfg,
                                     _RankRt(tp_group="tp", size=tp, rank=r))
        for got, want in ((q, jq), (k, jk), (v, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want[r]), rtol=0, atol=1e-6)


def test_groups_are_the_reference_mesh(results):
    """Rank (p * 2 + d) * 2 + m: its TP group is its (pod, data) cell, its
    data and pod groups stay at its model index, and its data-parallel
    group is every rank at its model index, never the whole world."""
    _, ranks = results
    for rank, got in enumerate(ranks):
        p, d, m = rank // 4, rank // 2 % 2, rank % 2
        for role, members in MESH_RANKS.items():
            np.testing.assert_array_equal(got[f"group/{role}"], members(p, d, m), err_msg=role)
        assert len(got["group/dp_group"]) == 4


def test_batch_rows_by_dp_index(results):
    """Each rank trains the rows the reference's P(("pod", "data")) batch
    sharding gives its device: the TP ranks of a data-parallel index
    share them."""
    want, ranks = results
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got["rows"], want[f"rows/rank{rank}"])
        assert dp_rows(rank, 8, 2, 2, 2) == slice(rank // 2 * 2, rank // 2 * 2 + 2)


def test_converted_shards_are_the_reference_addressable_shards(results):
    """fsdp + TP: every leaf's shard on every rank, by TP dim then FSDP dim."""
    want, ranks = results
    for rank, got in enumerate(ranks):
        names = sorted(k.split("/", 1)[1] for k in got.files if k.startswith("shard/"))
        assert names == sorted(k.split("/", 2)[2] for k in want
                               if k.startswith(f"shard/rank{rank}/"))
        for name in names:
            np.testing.assert_array_equal(got[f"shard/{name}"], want[f"shard/rank{rank}/{name}"],
                                          err_msg=name)
    # the MLP leaves are sharded on both axes
    assert ranks[0]["shard/layers/mlp/w_gate"].shape == (2, 32, FSDP_D_FF // 2)


@pytest.mark.parametrize("name", ["copy_to_tp", "reduce_from_tp", "gather_sp", "scatter_sp"])
def test_autograd_pair_matches_jax(results, name):
    want, ranks = results
    for r in range(LOSS_TP):
        for part in ("out", "grad"):
            np.testing.assert_allclose(ranks[r][f"pair/{name}/{part}"],
                                       want[f"pair/{name}/{part}"][r], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("what", ["value", "mean_logp", "grad", "argmax"])
def test_vocab_sharded_loss_matches_jax(results, what):
    want, ranks = results
    for r in range(LOSS_TP):
        np.testing.assert_allclose(ranks[r][f"loss/{what}"], want[f"loss/{what}"][r],
                                   rtol=1e-6, atol=1e-7)
    if what == "argmax":
        # ties: the smallest id, across shards (2 over 10) and within one (3
        # over 5); the padded column's 100 is masked
        assert ranks[0]["loss/argmax"][0, 0] == 2 and ranks[0]["loss/argmax"][1, 1] == 3
        assert ranks[0]["loss/argmax"][1, 2] < LOSS_VOCAB


def test_pad_to_tp_keeps_the_function_and_refuses_head_padding():
    """``pad_vocab``, the padding ``Model.init`` draws through, pads a TP-1
    tree to TP 4 with zero vocabulary rows.  Heads that pad are no longer
    refused: ``Model.init`` at TP 4 with 6 Q / 2 KV heads draws the
    reference's padded tree (8 Q heads, the 2 KV heads replicated), the
    phantom columns of ``wq`` and rows of ``wo`` zero, and the last rank
    keeps the two phantom heads."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), vocab_size=200,
                              dtype=torch.float32)
    model = Model(cfg, device="cpu").init(0)
    tree = {"embed": model.embed.data, "final_norm": {"scale": model.final_norm["scale"].data},
            "layers": []}
    padded = pad_vocab(tree, cfg, 4)
    assert padded["embed"].shape[0] == cfg.padded_vocab(4) == 512
    assert torch.equal(padded["embed"][:256], tree["embed"])
    assert not padded["embed"][256:].any()
    padded_heads = dataclasses.replace(cfg, n_heads=6, n_kv_heads=2, d_head=16)
    assert pad_vocab(tree, padded_heads, 4)["embed"].shape[0] == 512
    D, dh = cfg.d_model, 16
    drawn = Model(padded_heads, _RankRt(tp_group="tp", size=4, rank=3), device="cpu").draw(0)
    for lp in drawn["layers"]:
        a = lp["attn"]
        assert a["wq"].shape == (D, 8 * dh) and a["wo"].shape == (8 * dh, D)
        assert a["wk"].shape == a["wv"].shape == (D, 2 * dh)    # replicated: true count
        assert not a["wq"][:, 6 * dh:].any() and not a["wo"][6 * dh:].any()
        assert a["wq"][:, :6 * dh].any() and a["wo"][:6 * dh].any()
    last = Model(padded_heads, _RankRt(tp_group="tp", size=4, rank=3), device="cpu").init(0)
    for lp in last.layers:
        assert lp["attn"]["wq"].shape == (D, 2 * dh) and not lp["attn"]["wq"].any()
        assert lp["attn"]["wo"].shape == (2 * dh, D) and not lp["attn"]["wo"].any()
        assert lp["attn"]["wk"].shape == (D, 2 * dh) and lp["attn"]["wk"].any()


def test_nccl_refuses_ranks_sharing_a_card(monkeypatch):
    """No backend switch: under "nccl" a rank without a card of its own
    raises before any process group starts."""
    from repro_torch.launch.mesh import init_world

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="gloo backend can"):
        init_world(torch.device("cuda"), "nccl")
    assert not torch.distributed.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(module: str, args: list[str], world: int) -> list[dict]:
    """``python -m module args`` as ``world`` ranks of one gloo world
    through the environment; each rank's last JSON line."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo",
                   OMP_NUM_THREADS="1", RANK=str(r), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-m", module, *args], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, out + err
            outs.append([json.loads(line) for line in out.splitlines()
                         if line.startswith("{")])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return outs


@pytest.mark.parametrize("sp", [False, True])
def test_train_entry_point_at_tp2_on_cpu(sp):
    """Two TP ranks of one replica, with and without sequence parallelism:
    both log the same finite losses, the first within 1e-4 of a world of
    one's on the same seed (the TP-1 draw, vocabulary padded; the bf16
    row-parallel products are rounded per rank before their sum)."""
    args = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "32", "--mode", "hier",
            "--compression", "int8"]
    one = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *args],
                           env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                    GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1"),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        two = _run_ranks("repro_torch.launch.train",
                         args + ["--tp", "2"] + (["--sp"] if sp else []), 2)
        out, err = one.communicate(timeout=180)
    finally:
        if one.poll() is None:
            one.kill()
            one.wait(timeout=10)
    assert one.returncode == 0, out + err
    single = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    for lines in two:
        steps, summary = lines[:-1], lines[-1]
        assert (summary["tp"], summary["sp"], summary["world"]) == (2, sp, 2)
        assert all(np.isfinite(s["loss"]) and not s["gated"] for s in steps)
        assert [s["loss"] for s in steps] == [s["loss"] for s in two[0][:-1]]
    np.testing.assert_allclose(two[0][0]["loss"], single[0]["loss"], rtol=1e-4)


def test_serve_entry_point_at_tp2_on_cpu():
    cfg = get_config("qwen2.5-3b", smoke=True)
    outs = _run_ranks("repro_torch.serve.disaggregated",
                      ["--smoke", "--device", "cpu", "--prompt-len", "130", "--gen", "4",
                       "--tp", "2"], 2)
    for rank, (res,) in enumerate(outs):
        assert (res["rank"], res["tp"]) == (rank, 2)
        assert res["raw_transfer_exact"] and res["cache_finite"]
        assert res["cache_shapes"]["k"] == [cfg.n_layers, 4, 130, 1, cfg.head_dim]
