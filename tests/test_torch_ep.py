"""Expert parallelism of the port against the JAX package's, on eight gloo
ranks.

* The MoE toy of ``tests/mdscripts/check_moe.py`` (qwen1.5-4b's dense
  shape shrunk, an 8-expert top-2 bank, capacity factor 4.0) on a (pod 2,
  data 2, model 2) world: three training steps with ``comm_mode="flat"``
  per MoE All2All mode (``flat``, ``flat_a2a``, ``hier_a2a``), against
  the reference's ``ep`` trajectory on a mesh of the same shape (built
  with ``donate=False``, ROADMAP R12): losses, grad norms and aux within
  1e-4.  Skew-aware capacity: weights (1, 1) bit-equal to the unweighted
  run, and (1.5, 0.5) against the reference.
* ``etp``: the toy with 2 experts at TP 4 on a (pod 2, data 1, model 4)
  world, trained the same way.
* Serving at TP 2 (``ep``) and, for the 2-expert toy, at TP 4 (``etp``)
  against ``make_serve_steps`` on a (data 1, model T) mesh: a batch of 3
  prompts of 13 tokens, so that the prefill's 39 tokens and every decode
  step's 3 tokens pad to the TP size; tokens of a prefill and four decode
  steps equal, prefill logits (this rank's vocabulary shard) within 1e-5.

One spawned world of eight ranks and one JAX subprocess (this file run as
a script).
"""

import dataclasses
import datetime
import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np

WORLD, GB, S, N_STEPS = 8, 4, 16, 3
LR, WARMUP, FACTOR = 1e-2, 1, 4.0
A2A_MODES = ("flat", "flat_a2a", "hier_a2a")
SKEWS = {"even": (1.0, 1.0), "skewed": (1.5, 0.5)}
SB, SS, GEN = 3, 13, 4       # serving: odd token counts at TP 2 and TP 4
TOY = dict(name="qwen1_5_4b_moe_toy", family="moe", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=176, vocab_size=256, n_experts=8, top_k=2, moe_d_ff=88,
           rope_theta=1e6)
# (name, experts, pods, data per pod, tp, a2a mode, skew weights) of the runs
TRAIN_CASES = ([(f"ep_{m}", 8, 2, 2, 2, m, None) for m in A2A_MODES]
               + [(f"ep_{k}", 8, 2, 2, 2, "flat", w) for k, w in SKEWS.items()]
               + [("etp_tp4", 2, 2, 1, 4, "flat", None)])
SERVE_CASES = [("ep_tp2", 8, 2), ("etp_tp4", 2, 4)]


def batch(step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return {k: rng.integers(0, TOY["vocab_size"], (GB, S), dtype=np.int32)
            for k in ("tokens", "labels")}


def serve_prompt() -> np.ndarray:
    return np.random.default_rng(11).integers(0, TOY["vocab_size"], (SB, SS), dtype=np.int32)


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nest(flat) -> dict:
    tree: dict = {}
    for path in flat:
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = np.asarray(flat[path])
    return tree


def _jax_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.configs.base import ModelConfig
    from repro.launch.mesh import runtime_for_mesh
    from repro.models import Model
    from repro.parallel import sharding as jsh
    from repro.serve import make_serve_steps
    from repro.train import TrainConfig, make_train_step
    from repro.train import optimizer as jopt
    from repro.train.optimizer import OptConfig

    def params(name):
        return jax.tree.map(jnp.asarray, _nest(np.load(os.path.join(out_dir, f"{name}.npz"))))

    out = {}
    for name, experts, pods, dpp, tp, mode, weights in TRAIN_CASES:
        cfg = ModelConfig(**dict(TOY, n_experts=experts), dtype=jnp.float32)
        mesh = jax.make_mesh((pods, dpp, tp), ("pod", "data", "model"))
        rt = runtime_for_mesh(mesh, moe_capacity_factor=FACTOR, moe_a2a_mode=mode,
                              moe_cluster_weights=weights)
        model = Model(cfg, rt)
        build, _ = make_train_step(model, TrainConfig(comm_mode="flat",
                                                      opt=OptConfig(lr=LR, warmup_steps=WARMUP)),
                                   mesh=mesh, donate=False)
        p = params(f"params_e{experts}_tp{tp}")
        step, boot = build(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), p))
        opt = boot(p) if boot is not None else jopt.adam_init(p)
        metrics = []
        for i in range(N_STEPS):
            p, opt, m = step(p, opt, {k: jnp.asarray(v) for k, v in batch(i).items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"]), float(m["aux"])))
        out[f"train/{name}"] = np.asarray(metrics)
    prompt = jnp.asarray(serve_prompt())
    for name, experts, tp in SERVE_CASES:
        cfg = ModelConfig(**dict(TOY, n_experts=experts), dtype=jnp.float32)
        smesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("data", "model"))
        jm = Model(cfg, runtime_for_mesh(smesh))
        p = params(f"params_e{experts}_tp{tp}")
        prefill, decode, _ = make_serve_steps(jm, smesh, SB, SS + GEN)
        tok, caches = prefill(p, prompt)
        toks = [np.asarray(tok)]
        for _ in range(GEN):
            tok, caches = decode(p, tok, caches)
            toks.append(np.asarray(tok))
        out[f"serve/{name}/tokens"] = np.concatenate(toks, axis=1)
        pspecs = jm.param_specs(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), p))
        logits = jax.jit(jsh.shard_map(lambda pp, t: jm.apply_prefill(pp, t)[0], mesh=smesh,
                                       in_specs=(pspecs, P()), out_specs=P(None, None, "model")))
        out[f"serve/{name}/logits"] = np.asarray(logits(p, prompt))
    np.savez(os.path.join(out_dir, "jax.npz"), **out)


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.launch.train import dp_rows
    from repro_torch.serve.serve_step import make_serve_steps
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        out = {}
        worlds = {}
        for name, experts, pods, dpp, tp, mode, weights in TRAIN_CASES:
            if (pods, dpp, tp) not in worlds:
                worlds[(pods, dpp, tp)] = runtime_for_groups(pods=pods, data_per_pod=dpp, tp=tp,
                                                             moe_capacity_factor=FACTOR)
            rt = dataclasses.replace(worlds[(pods, dpp, tp)], moe_a2a_mode=mode,
                                     moe_cluster_weights=weights)
            cfg = ModelConfig(**dict(TOY, n_experts=experts), dtype=torch.float32)
            tree = _nest(np.load(os.path.join(out_dir, f"params_e{experts}_tp{tp}.npz")))
            model = params_from_jax(tree, cfg, rt, device="cpu")
            step_fn, _ = make_train_step(model, TrainConfig(
                comm_mode="flat", opt=opt_lib.OptConfig(lr=LR, warmup_steps=WARMUP)))
            opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
            rows = dp_rows(rank, GB, pods, dpp, tp)
            metrics = []
            for i in range(N_STEPS):
                m = step_fn(opt, {k: torch.from_numpy(v[rows]).long()
                                  for k, v in batch(i).items()})
                assert not m["gated"]
                metrics.append((m["loss"], m["grad_norm"], m["aux"]))
            out[f"train/{name}"] = np.asarray(metrics)
        prompt = torch.from_numpy(serve_prompt()).long()
        for name, experts, tp in SERVE_CASES:
            srt = runtime_for_groups(pods=1, data_per_pod=WORLD // tp, tp=tp)
            cfg = ModelConfig(**dict(TOY, n_experts=experts), dtype=torch.float32)
            tree = _nest(np.load(os.path.join(out_dir, f"params_e{experts}_tp{tp}.npz")))
            model = params_from_jax(tree, cfg, srt, device="cpu")
            prefill, decode = make_serve_steps(model)
            tok, caches = prefill(prompt)
            toks = [tok]
            for _ in range(GEN):
                tok, caches = decode(tok, caches)
                toks.append(tok)
            out[f"serve/{name}/tokens"] = torch.cat(toks, dim=1).numpy()
            out[f"serve/{name}/logits"] = model.apply_prefill(prompt)[0].numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _jax_main(sys.argv[1])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case on 8 gloo ranks and in JAX on 8 host devices: (the
    reference's results, each rank's)."""
    tmp = tmp_path_factory.mktemp("ep_world")
    for experts, tp in {(e, t) for _, e, _, _, t, _, _ in TRAIN_CASES} | {
            (e, t) for _, e, t in SERVE_CASES}:
        cfg = JaxModelConfig(**dict(TOY, n_experts=experts), dtype=jnp.float32)
        params = JaxModel(cfg, JaxRuntime(tp_axis="model", tp_size=tp)).init(jax.random.key(0))
        np.savez(tmp / f"params_e{experts}_tp{tp}.npz",
                 **_flat_tree(jax.tree.map(np.asarray, params)))
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
            p.join(timeout=300)
        jax_out, _ = jax_proc.communicate(timeout=300)
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
    return dict(np.load(tmp / "jax.npz")), [dict(np.load(tmp / f"rank{r}.npz"))
                                             for r in range(WORLD)]


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: c[0])
def test_training_matches_the_reference(results, case):
    """Loss, grad norm and aux of every step: the ranks of model index 0
    against the reference's metrics, which are its model column 0's, and
    every rank equal to the rank of its model index in the first replica.
    Under ep the router's gradient differs per model column (the combine
    weights of the column's token slice) and is summed over no TP group, in
    the reference as here, so the columns' router copies and the metrics
    they report drift apart (ROADMAP R14)."""
    want, ranks = results
    key, tp = f"train/{case[0]}", case[4]
    for rank, got in enumerate(ranks):
        if rank % tp == 0:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got[key], ranks[rank % tp][key])
    assert (want[key][:, 2] > 0).all()


def test_even_cluster_weights_are_the_unweighted_run(results):
    """Weights (1, 1): every cluster's capacity is the even one, so the run
    is the unweighted one bit for bit, here as in the reference."""
    want, ranks = results
    for got in ranks:
        np.testing.assert_array_equal(got["train/ep_even"], got["train/ep_flat"])
    np.testing.assert_array_equal(want["train/ep_even"], want["train/ep_flat"])


@pytest.mark.parametrize("case", SERVE_CASES, ids=lambda c: c[0])
def test_serving_matches_the_reference(results, case):
    """Ranks 0..tp-1 form the first TP group; each generates the reference's
    tokens and holds its vocabulary shard of the prefill logits."""
    name, _, tp = case
    want, ranks = results
    for r in range(tp):
        got = ranks[r]
        np.testing.assert_array_equal(got[f"serve/{name}/tokens"], want[f"serve/{name}/tokens"])
        vl = got[f"serve/{name}/logits"].shape[-1]
        np.testing.assert_allclose(got[f"serve/{name}/logits"],
                                   want[f"serve/{name}/logits"][..., r * vl:(r + 1) * vl],
                                   rtol=0, atol=1e-5)
