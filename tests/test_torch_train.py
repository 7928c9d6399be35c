"""The port's training path against the JAX package's, smoke qwen2.5-3b.

* One process, no groups: three steps of ``make_train_step`` (``flat``)
  against the reference's ``make_train_step(mesh=None)`` from the same
  f32 parameters and batches: losses and grad norms within 1e-4
  relative, parameters within 1e-4.
* Four gloo ranks (2 pods x 2 data) against the reference on a 4-device
  (pod 2, data 2) mesh, for ``hier``, ``hier_pipelined``, ``hier_overlap``
  (a 1 MiB bucket cap on both sides: final_norm, both layers, embed),
  ``hier_zero1`` and ``fsdp`` with int8 on the pod hop,
  ``hier_border_rs`` with bf16, and ``fsdp`` with no codec: losses within
  1e-3 over three steps.  The ``fsdp`` cases run the smoke model at d_ff
  512, so that its MLP leaves reach FSDP_MIN_SIZE and are sharded over
  the data group; each rank's shards are exactly the reference's slices
  of the drawn parameters, and its prefill and decode (which gather the
  shards) equal the unsharded model's bit for bit.  The JAX side runs
  this file as a script with 4 host devices.
* ``hier_overlap``'s hook executor in a gloo world of one, int8 on the
  pod hop: the gradients it syncs inside the backward are bit-equal to
  ``tree_hier_psum_overlap`` run after the backward, and its event log
  shows bucket 0 synced before the first gradient of the last bucket
  arrived, every bucket synced in index order.
* An unknown comm mode fails with the schedule registry's error, as in
  the reference.
* A one-rank gloo world (pod and data groups of one member, in a spawned
  process) against the reference on a (1, 1) ("pod", "data") mesh, three
  ``hier_zero1`` steps with no codec: losses and grad norms within 1e-4
  relative, parameters and the f32 master within 1e-4.
* ``zero_update`` against the reference's on a flat master, whole and in
  chunks: within 1e-6, the 1-D leaf's part decayed too (ROADMAP R9).
* Chunked training attention (forward and gradient) against the
  reference's ``chunked_attention``: within 1e-5.
* The synthetic data is the reference's token stream, bit for bit.
* The entry point prints finite JSON lines on the CPU, and refuses to
  run without a card unless told to use the CPU.
"""

import dataclasses
import datetime
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np

GB, S, N_STEPS, WORLD = 4, 32, 3, 4
LR, WARMUP = 1e-2, 1
# (comm mode, pod-hop codec) of the four-rank runs
FOUR_RANK_CASES = [("hier", "int8"), ("hier_pipelined", "int8"), ("hier_border_rs", "bf16"),
                   ("hier_zero1", "int8"), ("hier_overlap", "int8"), ("fsdp", "int8"),
                   ("fsdp", None)]
OVERLAP_CAP_MB = 1        # hier_overlap's bucket cap in the four-rank runs
FSDP_D_FF = 512           # the fsdp runs' d_ff: w_gate/w_up/w_down reach 2 x 64 x 512 = 2^16


def smoke_cfg(mode: str, cfg):
    """The f32 smoke config of a four-rank run (JAX or torch)."""
    return dataclasses.replace(cfg, d_ff=FSDP_D_FF) if mode == "fsdp" else cfg


def train_kwargs(mode: str) -> dict:
    return {"bucket_cap_mb": OVERLAP_CAP_MB} if mode == "hier_overlap" else {}


def batch(step: int, vocab: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return {"tokens": rng.integers(0, vocab, (GB, S), dtype=np.int32),
            "labels": rng.integers(0, vocab, (GB, S), dtype=np.int32)}


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

    from repro.configs import get_config as jax_config
    from repro.launch.mesh import runtime_for_mesh
    from repro.models import Model as JaxModel
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import make_train_step as jax_train_step
    from repro.train.optimizer import OptConfig as JaxOpt

    from jax.sharding import NamedSharding, PartitionSpec

    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    base = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), dtype=jax.numpy.float32)
    for mode, codec in FOUR_RANK_CASES:
        cfg = smoke_cfg(mode, base)
        model = JaxModel(cfg, runtime_for_mesh(mesh, fsdp=mode == "fsdp"))
        if mode == "fsdp":
            model = model.with_fsdp(2)
        tcfg = JaxTrainConfig(comm_mode=mode, dcn_compression=codec,
                              opt=JaxOpt(lr=LR, warmup_steps=WARMUP), **train_kwargs(mode))
        build, init = jax_train_step(model, tcfg, mesh=mesh)
        params, opt = init(jax.random.key(0))
        shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params)
        step, boot = build(shapes)
        if mode == "fsdp":
            # each device's slice of every sharded leaf, by rank (pod-major)
            shards = {}
            specs, _ = jax.tree_util.tree_flatten_with_path(
                model.param_specs(shapes), is_leaf=lambda x: isinstance(x, PartitionSpec))
            for (path, spec), leaf in zip(specs, jax.tree.leaves(params)):
                if "data" not in tuple(spec):
                    continue
                arr = jax.device_put(leaf, NamedSharding(mesh, spec))
                for sh in arr.addressable_shards:
                    p, d = np.argwhere(mesh.devices == sh.device)[0]
                    name = "/".join(str(k.key) for k in path)
                    shards[f"rank{2 * p + d}/{name}"] = np.asarray(sh.data)
            np.savez(os.path.join(out_dir, f"jax_shards_{codec}.npz"), **shards)
        if boot is not None:
            opt = boot(params)
        losses = []
        for i in range(N_STEPS):
            b = {k: jax.numpy.asarray(v) for k, v in batch(i, cfg.vocab_size).items()}
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
        np.save(os.path.join(out_dir, f"jax_losses_{mode}_{codec}.npy"), np.asarray(losses))


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step, zero_bootstrap

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    try:
        rt = runtime_for_groups(pods=2, data_per_pod=2)
        rt_fsdp = runtime_for_groups(pods=2, data_per_pod=2, fsdp=True)
        base = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=torch.float32)
        rows = slice(rank * GB // WORLD, (rank + 1) * GB // WORLD)
        for mode, codec in FOUR_RANK_CASES:
            cfg = smoke_cfg(mode, base)
            fsdp = mode == "fsdp"
            params = _nest(np.load(os.path.join(out_dir, f"params_{'fsdp' if fsdp else 'base'}.npz")))
            model = params_from_jax(params, cfg, rt_fsdp if fsdp else rt, device="cpu",
                                    fsdp=2 if fsdp else 1)
            if fsdp:
                shards = {f"{'/'.join(path)}": torch.stack(leaf).numpy()
                          for path, leaf in zip(model.param_specs(), model.train_leaves())
                          if "data" in model.param_specs()[path]}
                # serving gathers the shards too: prefill and one decode step
                # equal the unsharded model's bit for bit
                whole = params_from_jax(params, cfg, rt, device="cpu")
                toks = torch.from_numpy(batch(9, cfg.vocab_size)["tokens"][:2, :12]).long()
                (lg, cg), (lw, cw) = (m_.apply_prefill(toks, max_len=13) for m_ in (model, whole))
                nxt = lw.argmax(-1)
                dg, dw = model.apply_decode(nxt, cg)[0], whole.apply_decode(nxt, cw)[0]
                shards["serving_equal"] = np.asarray(torch.equal(lg, lw) and torch.equal(dg, dw))
                np.savez(os.path.join(out_dir, f"rank{rank}_shards_{codec}.npz"), **shards)
            tcfg = TrainConfig(comm_mode=mode, dcn_compression=codec,
                               opt=opt_lib.OptConfig(lr=LR, warmup_steps=WARMUP),
                               **train_kwargs(mode))
            step_fn, _ = make_train_step(model, tcfg)
            if mode == "hier_zero1":
                opt = zero_bootstrap(model, tcfg)
            else:
                opt = opt_lib.adam_init(opt_lib.flat_params(model.train_leaves())[0])
            losses = []
            for i in range(N_STEPS):
                b = {k: torch.from_numpy(v[rows]).long()
                     for k, v in batch(i, cfg.vocab_size).items()}
                m = step_fn(opt, b)
                assert not m["gated"]
                losses.append(m["loss"])
            np.save(os.path.join(out_dir, f"rank{rank}_losses_{mode}_{codec}.npy"),
                    np.asarray(losses))
    finally:
        dist.destroy_process_group()


def _one_rank_zero1(out_dir: str, lr: float) -> None:
    """hier_zero1 in a world of one, through pod and data groups of one
    member: the losses, grad norms, parameters and master of 3 steps."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import TrainConfig, make_train_step, zero_bootstrap

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        rt = runtime_for_groups(pods=1, data_per_pod=1)
        cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=torch.float32)
        model = params_from_jax(_nest(np.load(os.path.join(out_dir, "params.npz"))), cfg,
                                rt, device="cpu")
        tcfg = TrainConfig(comm_mode="hier_zero1",
                           opt=opt_lib.OptConfig(lr=lr, warmup_steps=WARMUP))
        step_fn, _ = make_train_step(model, tcfg)
        opt = zero_bootstrap(model, tcfg)
        metrics = []
        for i in range(N_STEPS):
            m = step_fn(opt, {k: torch.from_numpy(v).long()
                              for k, v in batch(i, cfg.vocab_size).items()})
            assert not m["gated"]
            metrics.append((m["loss"], m["grad_norm"]))
        leaves = [torch.stack(p) if isinstance(p, list) else p for p in model.train_leaves()]
        np.savez(os.path.join(out_dir, "port.npz"), metrics=np.asarray(metrics),
                 master=opt.flat_param.numpy(),
                 **{f"leaf{i}": p.detach().numpy() for i, p in enumerate(leaves)})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _jax_main(sys.argv[1])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.parallel.sharding import Runtime as JaxRuntime  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro.train.optimizer import OptConfig as JaxOpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train.train_step import TrainConfig, make_train_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_setup(**overrides):
    cfg = dataclasses.replace(jax_config("qwen2.5-3b", smoke=True), dtype=jnp.float32,
                              **overrides)
    model = JaxModel(cfg, JaxRuntime())
    return cfg, model, model.init(jax.random.key(0))


def _port_model(params, rt=None):
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=torch.float32)
    return params_from_jax(jax.tree.map(np.asarray, params), cfg, rt, device="cpu")


# The key bias gets a gradient that is zero in exact arithmetic (a shift
# of every key's score by q.bk leaves the softmax unchanged), so Adam
# turns rounding noise into steps of up to lr on it: the parameter
# comparison runs at lr 1e-3, where that noise stays below its 1e-4.
PARITY_LR = 1e-3


def test_train_step_one_process_matches_jax():
    cfg, jm, params = _jax_setup()
    tm = _port_model(params)
    jopt_cfg = JaxOpt(lr=PARITY_LR, warmup_steps=WARMUP)
    jstep, jinit = jax_train_step(jm, JaxTrainConfig(comm_mode="flat", opt=jopt_cfg))
    jopt = jinit(jax.random.key(0))[1]
    step_fn, _ = make_train_step(tm, TrainConfig(
        comm_mode="flat", opt=opt_lib.OptConfig(lr=PARITY_LR, warmup_steps=WARMUP)))
    opt = opt_lib.adam_init(opt_lib.flat_params(tm.train_leaves())[0])
    for i in range(N_STEPS):
        b = batch(i, cfg.vocab_size)
        params, jopt, jm_ = jstep(params, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        m = step_fn(opt, {k: torch.from_numpy(v).long() for k, v in b.items()})
        assert not m["gated"]
        np.testing.assert_allclose(m["loss"], float(jm_["loss"]), rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"], float(jm_["grad_norm"]), rtol=1e-4)
    for got, want in zip(tm.train_leaves(), jax.tree.leaves(params)):
        got = torch.stack(got) if isinstance(got, list) else got
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)


@pytest.fixture(scope="module")
def four_rank_losses(tmp_path_factory):
    """Every case of FOUR_RANK_CASES on 4 gloo ranks and in JAX on 4 host
    devices: the directory of their losses."""
    tmp_path = tmp_path_factory.mktemp("four_rank_training")
    _, _, params = _jax_setup()
    np.savez(tmp_path / "params_base.npz", **_flat_tree(jax.tree.map(np.asarray, params)))
    _, _, params = _jax_setup(d_ff=FSDP_D_FF)
    np.savez(tmp_path / "params_fsdp.npz", **_flat_tree(jax.tree.map(np.asarray, params)))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join([str(ROOT / "src")]))
    jax_proc = subprocess.Popen([sys.executable, __file__, str(tmp_path)], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp_path / "store"), str(tmp_path)))
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
    return tmp_path


@pytest.mark.parametrize("mode, codec", FOUR_RANK_CASES)
def test_train_step_four_ranks_matches_jax(four_rank_losses, mode, codec):
    want = np.load(four_rank_losses / f"jax_losses_{mode}_{codec}.npy")
    for r in range(WORLD):
        got = np.load(four_rank_losses / f"rank{r}_losses_{mode}_{codec}.npy")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    if mode == "fsdp":
        jshards = np.load(four_rank_losses / f"jax_shards_{codec}.npz")
        for r in range(WORLD):
            got = np.load(four_rank_losses / f"rank{r}_shards_{codec}.npz")
            assert bool(got["serving_equal"])
            names = sorted(set(got.files) - {"serving_equal"})
            assert names == sorted(k.split("/", 1)[1] for k in jshards.files
                                   if k.startswith(f"rank{r}/"))
            assert {"layers/mlp/w_gate", "layers/mlp/w_down"} <= set(names)
            for name in names:
                np.testing.assert_array_equal(got[name], jshards[f"rank{r}/{name}"])


@pytest.mark.parametrize("window", [None, 40])
def test_chunked_attention_matches_jax(window):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 70, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 70, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 70, 2, 16)).astype(np.float32)
    ct = rng.normal(size=q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = jattn.chunked_attention(q, k, v, causal=True, window=window,
                                      q_offset=0, chunk=32)
        return jnp.sum(out * ct), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tattn.chunked_attention(tq, tk, tv, causal=True, window=window, chunk=32)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    for t, j in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-5)


@pytest.mark.parametrize("step", [0, 5])
def test_synth_batch_is_the_reference(step):
    kw = dict(vocab_size=1000, global_batch=3, seq_len=17, seed=4)
    want = jpipe.synth_batch(jpipe.DataConfig(**kw), step)
    got = tpipe.synth_batch(tpipe.DataConfig(**kw), step)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("mode", ["hier_overlapped", "zero3"])
def test_unknown_comm_mode_raises_the_registry_error(mode):
    tm = _port_model(_jax_setup()[2])
    with pytest.raises(ValueError) as got:
        make_train_step(tm, TrainConfig(comm_mode=mode))
    with pytest.raises(ValueError) as want:
        JaxTrainConfig(comm_mode=mode).comm_config(JaxRuntime())
    assert str(got.value) == str(want.value) and mode in str(got.value)


def _bucket_sync_run(out_dir: str) -> None:
    """hier_overlap's sync in a gloo world of one (int8 on the pod hop):
    the gradients of one batch synced after the backward by
    tree_hier_psum_overlap, then synced inside a second, identical
    backward by BucketSync; both, and the hook executor's event log."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch.distributed as dist

    from repro_torch.core import overlap
    from repro_torch.core.collectives import CommConfig
    from repro_torch.launch.mesh import runtime_for_groups
    from repro_torch.train import loss as loss_lib

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        rt = runtime_for_groups(pods=1, data_per_pod=1)
        cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), dtype=torch.float32)
        model = params_from_jax(_nest(np.load(os.path.join(out_dir, "params.npz"))), cfg, rt,
                                device="cpu")
        ccfg = CommConfig(mode="hier", pod_group=rt.pod_group, intra_group=rt.data_group,
                          dp_group=rt.dp_group, compression="int8")
        params, _ = opt_lib.flat_params(model.train_leaves())
        for p in params:
            p.requires_grad_(True)
        b = {k: torch.from_numpy(v).long() for k, v in batch(0, cfg.vocab_size).items()}

        def grads():
            logits = model.apply_train(b["tokens"])
            lval, _ = loss_lib.sharded_xent(logits, b["labels"], rt, cfg.vocab_size)
            return torch.autograd.grad(lval, params)

        after = dict(zip(map(id, params), grads()))
        tree = model.param_tree()
        overlap.tree_hier_psum_overlap(_map_tensors(tree, lambda t: after[id(t)]), ccfg,
                                       cap_bytes=OVERLAP_CAP_MB << 20)
        sync = overlap.BucketSync(tree, ccfg, OVERLAP_CAP_MB << 20)
        with sync.attached():
            inside = grads()
        np.savez(os.path.join(out_dir, "bucket_sync.npz"),
                 events=np.asarray([(e == "sync", bucket) for e, bucket in sync.events]),
                 **{f"after{i}": after[id(p)].numpy() for i, p in enumerate(params)},
                 **{f"inside{i}": g.numpy() for i, g in enumerate(inside)})
    finally:
        dist.destroy_process_group()


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, list):
        return [_map_tensors(t, fn) for t in tree]
    return {k: _map_tensors(v, fn) for k, v in tree.items()}


def test_bucket_sync_in_the_backward_equals_the_sync_after_it(tmp_path):
    _, _, params = _jax_setup()
    np.savez(tmp_path / "params.npz", **_flat_tree(jax.tree.map(np.asarray, params)))
    proc = multiprocessing.get_context("spawn").Process(target=_bucket_sync_run,
                                                        args=(str(tmp_path),))
    proc.start()
    proc.join(timeout=240)
    if proc.is_alive():
        proc.kill()
        proc.join(timeout=10)
    assert proc.exitcode == 0
    got = np.load(tmp_path / "bucket_sync.npz")
    n = len([k for k in got.files if k.startswith("after")])
    assert n == 2 + 12 * 2                         # embed, final_norm, 12 leaves x 2 layers
    for i in range(n):
        np.testing.assert_array_equal(got[f"inside{i}"], got[f"after{i}"])
    events = [("sync" if s else "grad", int(b)) for s, b in got["events"]]
    syncs = [b for e, b in events if e == "sync"]
    assert syncs == [0, 1, 2]                      # final_norm, both layers, embed
    assert events.index(("sync", 0)) < events.index(("grad", 2))
    assert events.index(("sync", 1)) < events.index(("grad", 2))
    assert events[-1] == ("sync", 2)


def test_zero1_one_rank_matches_jax(tmp_path):
    """hier_zero1 with no codec in a gloo world of one (spawned) against the
    reference on a (1, 1) ("pod", "data") mesh, from the same f32
    parameters and batches."""
    from repro.launch.mesh import runtime_for_mesh

    cfg, _, params = _jax_setup()
    np.savez(tmp_path / "params.npz", **_flat_tree(jax.tree.map(np.asarray, params)))
    proc = multiprocessing.get_context("spawn").Process(
        target=_one_rank_zero1, args=(str(tmp_path), PARITY_LR))
    proc.start()
    mesh = jax.make_mesh((1, 1), ("pod", "data"))
    jm = JaxModel(cfg, runtime_for_mesh(mesh))
    build, _ = jax_train_step(jm, JaxTrainConfig(
        comm_mode="hier_zero1", opt=JaxOpt(lr=PARITY_LR, warmup_steps=WARMUP)), mesh=mesh)
    step, boot = build(jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params))
    opt = boot(params)
    want = []
    for i in range(N_STEPS):
        params, opt, m = step(params, opt, {k: jnp.asarray(v)
                                            for k, v in batch(i, cfg.vocab_size).items()})
        want.append((float(m["loss"]), float(m["grad_norm"])))
    proc.join(timeout=240)
    if proc.is_alive():
        proc.kill()
        proc.join(timeout=10)
    assert proc.exitcode == 0
    got = np.load(tmp_path / "port.npz")
    np.testing.assert_allclose(got["metrics"], np.asarray(want), rtol=1e-4)
    np.testing.assert_allclose(got["master"], np.asarray(opt.flat_param), atol=1e-4)
    leaves = jax.tree.leaves(params)
    for i, want_leaf in enumerate(leaves):
        np.testing.assert_allclose(got[f"leaf{i}"], np.asarray(want_leaf), atol=1e-4)
    assert f"leaf{len(leaves)}" not in got


@pytest.mark.parametrize("chunk", [None, 1000])
def test_zero_update_matches_jax(monkeypatch, chunk):
    """Three updates of a flat master built from a (40, 50) weight and a
    (50,) bias; the bias's gradient is zero in the first step, so there
    the step moves it by its decay alone: the reference decays every
    element of the master, 1-D leaves too (R9)."""
    from repro.train import optimizer as jopt
    from repro_torch.core import collectives as tcoll

    if chunk is not None:
        monkeypatch.setattr(opt_lib, "ZERO_CHUNK", chunk)
    rng = np.random.default_rng(11)
    w, b = rng.normal(size=(40, 50)).astype(np.float32), rng.normal(size=50).astype(np.float32)
    master, meta = tcoll.zero1_local_shard([torch.from_numpy(w), torch.from_numpy(b)],
                                           tcoll.CommConfig())
    bias = slice(meta.layout.slots[1].offset, meta.layout.slots[1].offset + 50)
    ocfg = opt_lib.OptConfig(lr=1e-2, warmup_steps=2)
    st = opt_lib.zero_init_from_flatparam(master.clone())
    jst = jopt.zero_init_from_flatparam(jnp.asarray(master.numpy()))
    jcfg = JaxOpt(lr=1e-2, warmup_steps=2)
    for i in range(3):
        g = rng.normal(size=master.numel()).astype(np.float32)
        if i == 0:
            g[bias] = 0
        before = st.flat_param.clone()
        opt_lib.zero_update(torch.from_numpy(g), st, ocfg, torch.tensor(0.7))
        jst = jopt.zero_update(jnp.asarray(g), jst, jcfg, jnp.float32(0.7))
        np.testing.assert_allclose(st.flat_param.numpy(), np.asarray(jst.flat_param),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(st.mu.numpy(), np.asarray(jst.mu), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(st.nu.numpy(), np.asarray(jst.nu), rtol=1e-6, atol=1e-6)
        if i == 0:
            decayed = before[bias] * (1 - opt_lib.lr_at(ocfg, 0) * ocfg.weight_decay)
            np.testing.assert_allclose(st.flat_param[bias].numpy(), decayed.numpy(),
                                       rtol=1e-6)
            assert not torch.equal(st.flat_param[bias], before[bias])
    assert st.step == int(jst.step) == 3


@pytest.mark.parametrize("mode", ["hier", "hier_pipelined", "hier_zero1", "hier_overlap",
                                  "fsdp"])
def test_entry_point_smoke_on_cpu(mode):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                          "--device", "cpu", "--steps", "2", "--seq", "32",
                          "--mode", mode, "--compression", "int8"],
                         env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(line) for line in res.stdout.splitlines()]
    steps, summary = lines[:-1], lines[-1]
    assert [s["step"] for s in steps] == [0, 1]
    assert all(np.isfinite(s["loss"]) and np.isfinite(s["gnorm"]) and not s["gated"]
               for s in steps)
    assert summary["world"] == 1 and summary["mode"] == mode


def test_entry_point_refuses_border_rs_with_int8():
    """As in the reference: the int8 ring does not compose with the border
    exchange's reduce-scatter."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                          "--device", "cpu", "--steps", "1", "--seq", "32",
                          "--mode", "hier_border_rs", "--compression", "int8"],
                         env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode != 0
    assert "hier_border_rs supports only lossless/bf16 wire codecs" in res.stderr


def test_entry_point_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--smoke", "--steps", "1"])
