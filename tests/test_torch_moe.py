"""The port's MoE layer and MoE models against the JAX package's, on the CPU.

The same numpy-seeded inputs and the reference's parameters go through
``repro.models.moe`` and ``repro_torch.models.moe``: routing, capacity,
the per-cluster capacities (over a grid that covers the integer split's
ties, ROADMAP R1: equality with the reference, not monotonicity), the
pack and the combine, the layer at TP 1 and its gradients against
``jax.grad``; then both MoE smoke models (qwen3-moe, and mixtral with
its window of 32) against the reference's single-device ``Model``:
prefill logits, greedy decode and three training steps with the aux
loss.  Integers (ids, slots, keep masks, capacities, tokens) are equal;
floats in f32 within 1e-4 abs and rel (summation order only).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.mesh import runtime_for_mesh
from repro.models import Model as JaxModel
from repro.models import moe as jmoe
from repro.parallel.sharding import Runtime as JaxRuntime
from repro.serve import make_serve_steps as jax_serve_steps
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import loss as jloss
from repro.train import make_train_step as jax_train_step
from repro.train import optimizer as jopt
from repro.train.optimizer import OptConfig as JaxOpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.models import Model
from repro_torch.models import moe as tmoe
from repro_torch.parallel.sharding import Runtime
from repro_torch.serve.serve_step import make_serve_steps
from repro_torch.train import loss as tloss
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import TrainConfig, make_train_step

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b")
B, S, GEN, N_STEPS = 2, 40, 5, 3


def _cfgs(arch: str, **overrides):
    return (dataclasses.replace(jax_config(arch, smoke=True), dtype=jnp.float32, **overrides),
            dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32, **overrides))


def _layer(arch: str = "qwen3-moe-30b-a3b", T: int = 48, seed: int = 0):
    """The reference's MoE params and an (1, T, D) input, both sides."""
    jc, tc = _cfgs(arch)
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.key(seed), jc, 1, jnp.float32))
    x = np.random.default_rng(seed).normal(size=(1, T, jc.d_model)).astype(np.float32)
    return jc, tc, p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}, x


def _np(t) -> np.ndarray:
    return t.detach().numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    jc, tc, jp, tp, x = _layer(arch)
    w, ids, aux = tmoe._route(tp, torch.from_numpy(x[0]), tc)
    jw, jids, jaux = jmoe._route(jp, jnp.asarray(x[0]), jc)
    np.testing.assert_array_equal(_np(ids), np.asarray(jids))
    np.testing.assert_allclose(_np(w), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("T, k, E, factor", [(1, 1, 8, 1.25), (4096, 8, 128, 1.25),
                                             (4, 8, 128, 1.25), (48, 2, 8, 4.0),
                                             (1000, 2, 8, 1.0), (7, 3, 5, 2.5)])
def test_capacity_matches_jax(T, k, E, factor):
    assert tmoe._capacity(T, k, E, factor) == jmoe._capacity(T, k, E, factor)


def test_cluster_capacities_match_jax():
    """The grid holds R1's ties (equal weights, weights that split a budget
    into halves, .5 remainders): the port equals the reference wherever it
    lands, monotone or not."""
    weights = [(1.0, 1.0), (1.5, 0.5), (0.5, 1.5), (1.0, 1.0, 1.0), (1.2, 0.9, 0.9),
               (2.0, 1.0, 0.0), (1.0,), (0.25, 1.75), (1.1, 0.9), (1.3, 1.3, 0.4)]
    n = 0
    for T in (1, 7, 24, 48, 100, 4096):
        for k, E in ((1, 8), (2, 8), (8, 128), (3, 5)):
            for factor in (1.0, 1.25, 4.0):
                for w in weights:
                    assert (tmoe.cluster_capacities(T, k, E, factor, w)
                            == jmoe.cluster_capacities(T, k, E, factor, w)), (T, k, E, factor, w)
                    n += 1
    assert n == 6 * 4 * 3 * len(weights)


@pytest.mark.parametrize("capped", [False, True])
def test_pack_and_combine_match_jax(capped):
    """A capacity that drops tokens: slots, keep masks and buffers equal,
    and the combine within f32 rounding; with per-expert caps too."""
    jc, tc, jp, tp, x = _layer(T=64)
    x2d = x[0]
    jw, jids, _ = jmoe._route(jp, jnp.asarray(x2d), jc)
    E, k, C = jc.n_experts, jc.top_k, 8          # 64 x 2 slots over 8 experts: drops
    cap = np.array([8, 3, 5, 8, 1, 8, 6, 2], np.int32) if capped else None
    jbuf, (jid2, jslot, jkeep, _) = jmoe._pack(jnp.asarray(x2d), jids, jw, E, C,
                                              None if cap is None else jnp.asarray(cap))
    ids, w = torch.tensor(np.asarray(jids)).long(), torch.tensor(np.asarray(jw))
    buf, route = tmoe._pack(torch.from_numpy(x2d), ids, w, E, C,
                            None if cap is None else torch.from_numpy(cap).long())
    np.testing.assert_array_equal(_np(route[1]), np.asarray(jslot))
    np.testing.assert_array_equal(_np(route[2]), np.asarray(jkeep))
    assert not np.asarray(jkeep).all()
    np.testing.assert_array_equal(_np(buf), np.asarray(jbuf))
    out_buf = np.random.default_rng(3).normal(size=(E, C, jc.d_model)).astype(np.float32)
    got = tmoe._combine(torch.from_numpy(out_buf), route, 64, k, torch.float32)
    want = jmoe._combine(jnp.asarray(out_buf), (jid2, jslot, jkeep, jw), 64, k, jnp.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_combine_rounds_in_the_buffers_dtype():
    """bf16 expert outputs: weighted and summed in bf16, cast at the end,
    as the reference orders it."""
    jc, tc, jp, tp, x = _layer(T=32)
    jw, jids, _ = jmoe._route(jp, jnp.asarray(x[0]), jc)
    jbuf, route = jmoe._pack(jnp.asarray(x[0]), jids, jw, jc.n_experts, 16)
    out_buf = jnp.asarray(np.random.default_rng(4).normal(size=jbuf.shape), jnp.bfloat16)
    want = jmoe._combine(out_buf, route, 32, jc.top_k, jnp.float32)
    troute = tuple(torch.tensor(np.asarray(a)) for a in route)
    troute = (troute[0].long(), troute[1].long(), troute[2], troute[3])
    got = tmoe._combine(to_tensor(np.asarray(out_buf), "cpu"), troute, 32, jc.top_k,
                        torch.float32)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_and_its_gradients_match_jax(arch):
    """The layer at TP 1 and the gradients of sum(out * ct) + 0.5 aux with
    respect to x and every parameter, against ``jax.grad``."""
    jc, tc, jp, tp, x = _layer(arch)
    ct = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss_fn(p, xx):
        out, aux = jmoe.apply_moe(p, xx, jc, JaxRuntime())
        return jnp.sum(out * ct) + 0.5 * aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(jloss_fn, argnums=(0, 1),
                                                       has_aux=True)(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    xx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.apply_moe(tp, xx, tc, Runtime())
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum() + 0.5 * aux,
                                [xx] + [tp[k] for k in sorted(tp)])
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)
    np.testing.assert_allclose(_np(grads[0]), np.asarray(jgx), **TOL)
    for name, g in zip(sorted(tp), grads[1:]):
        np.testing.assert_allclose(_np(g), np.asarray(jgp[name]), **TOL, err_msg=name)


def _models(arch: str):
    jc, tc = _cfgs(arch)
    jm = JaxModel(jc, JaxRuntime())
    params = jm.init(jax.random.key(0))
    return jc, jm, params, params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_serving_matches_jax(arch):
    """Prefill logits within 1e-4, and greedy tokens equal over a prefill
    and GEN decode steps (mixtral's prompt outruns its window of 32)."""
    jc, jm, params, tm = _models(arch)
    prompt = np.random.default_rng(11).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    logits, _ = tm.apply_prefill(torch.from_numpy(prompt).long())
    jlogits, _ = jm.apply_prefill(params, jnp.asarray(prompt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    jprefill, jdecode, _ = jax_serve_steps(JaxModel(jc, runtime_for_mesh(mesh)), mesh, B, S)
    prefill, decode = make_serve_steps(tm)
    jtok, jcaches = jprefill(params, jnp.asarray(prompt))
    tok, caches = prefill(torch.from_numpy(prompt).long())
    for i in range(GEN + 1):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok), err_msg=f"token {i}")
        if i < GEN:
            jtok, jcaches = jdecode(params, jtok, jcaches)
            tok, caches = decode(tok, caches)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_training_matches_jax(arch):
    """Three steps: loss (with 1e-2 x aux), grad norm and aux within 1e-4."""
    jc, jm, params, tm = _models(arch)
    ocfg = dict(lr=1e-3, warmup_steps=1)
    jstep, _ = jax_train_step(jm, JaxTrainConfig(comm_mode="flat", opt=JaxOpt(**ocfg)))
    jopt_state = jopt.adam_init(params)
    step_fn, _ = make_train_step(tm, TrainConfig(comm_mode="flat",
                                                 opt=opt_lib.OptConfig(**ocfg)))
    opt = opt_lib.adam_init(opt_lib.flat_params(tm.train_leaves())[0])
    for i in range(N_STEPS):
        rng = np.random.default_rng(100 + i)
        b = {k: rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
        params, jopt_state, jm_ = jstep(params, jopt_state,
                                        {k: jnp.asarray(v) for k, v in b.items()})
        m = step_fn(opt, {k: torch.from_numpy(v).long() for k, v in b.items()})
        assert not m["gated"]
        for key in ("loss", "grad_norm", "aux"):
            np.testing.assert_allclose(m[key], float(jm_[key]), **TOL,
                                       err_msg=f"step {i} {key}")
        assert m["aux"] > 0


def test_sharded_xent_with_z_loss_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(2, 5, 16)).astype(np.float32) * 3
    labels = np.array([[0, 3, 15, 13, 2], [-1, 14, 1, 12, 7]], np.int32)
    lg = torch.from_numpy(logits).requires_grad_(True)
    loss, met = tloss.sharded_xent(lg, torch.from_numpy(labels).long(), Runtime(), 14,
                                   z_loss=1e-3)
    (g,) = torch.autograd.grad(loss, lg)
    (jl, jmet), jg = jax.value_and_grad(
        lambda a: jloss.sharded_xent(a, jnp.asarray(labels), JaxRuntime(), 14, 1e-3),
        has_aux=True)(jnp.asarray(logits))
    for got, want in ((loss, jl), (met["nll_sum"], jmet["nll_sum"]), (g, jg)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    plain, _ = tloss.sharded_xent(lg, torch.from_numpy(labels).long(), Runtime(), 14)
    assert loss.item() > plain.item()


@dataclasses.dataclass(frozen=True)
class _Tp2(Runtime):
    """A Runtime reporting TP 2 without a process group (the guard raises
    before any collective)."""

    @property
    def tp(self) -> int:
        return 2

    @property
    def tp_rank(self) -> int:
        return 0


def test_expert_count_guard_names_both_sizes():
    """n_experts = 7 at TP 2: the sharding rules and the layer raise the
    reference's ValueError, naming both sizes."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", smoke=True), n_experts=7,
                              dtype=torch.float32)
    with pytest.raises(ValueError, match=r"n_experts=7 % tp=2"):
        Model(cfg, _Tp2(tp_group="tp"), device="cpu").init(0)
    jc = dataclasses.replace(jax_config("qwen3-moe-30b-a3b", smoke=True), n_experts=7,
                             dtype=jnp.float32)
    p = {k: torch.tensor(np.asarray(v)) for k, v in
         jmoe.init_moe(jax.random.key(0), jc, 1, jnp.float32).items()}
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match=r"n_experts=7 % tp=2") as err:
        tmoe.apply_moe(p, x, cfg, _Tp2(tp_group="tp"))
    want = ("MoE expert parallelism needs the tensor-parallel size to divide the expert "
            "count: n_experts=7 % tp=2 (axis 'model') = 1")
    assert str(err.value).startswith(want)


def test_moe_init_draws_the_full_width_banks_per_layer():
    """qwen3-moe-30b-a3b's leaves, drawn under FakeTensorMode: (128, 2048,
    768) banks and an f32 (2048, 128) router per layer, and the reference's
    parameter count."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=2)
    with FakeTensorMode():
        m = Model(cfg, device="cpu").init(0)
        lp = m.layers[0]["moe"]
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in lp.items()}
        n = sum(p.numel() for p in m.parameters())
    assert shapes == {"router": ((2048, 128), torch.float32),
                      "w_gate": ((128, 2048, 768), torch.bfloat16),
                      "w_up": ((128, 2048, 768), torch.bfloat16),
                      "w_down": ((128, 768, 2048), torch.bfloat16)}
    assert n == cfg.param_count() + (2 * cfg.n_layers + 1) * cfg.d_model  # + norm scales
    assert get_config("qwen3-moe-30b-a3b").param_count() == 30_078_926_848


def _run(args: list[str], module: str) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", module, *args], env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    return [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("mode", ["flat", "hier", "hier_pipelined", "hier_border_rs",
                                  "hier_zero1", "hier_overlap", "fsdp"])
def test_train_entry_point_with_moe_on_cpu(mode):
    """Every --mode of the trainer on the MoE smoke model (bf16 on the pod
    hop of hier_border_rs, which refuses int8)."""
    codec = "bf16" if mode == "hier_border_rs" else "int8"
    lines = _run(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu", "--steps", "2",
                  "--seq", "32", "--mode", mode, "--compression", codec],
                 "repro_torch.launch.train")
    steps, summary = lines[:-1], lines[-1]
    assert summary["arch"] == "qwen3-moe-smoke" and summary["moe_a2a_mode"] == "flat"
    assert all(np.isfinite(s["loss"]) and s["aux"] > 0 and not s["gated"] for s in steps)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_entry_point_with_moe_on_cpu(arch):
    (res,) = _run(["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len", "40",
                   "--gen", "4"], "repro_torch.serve.disaggregated")
    assert res["raw_transfer_exact"] and res["cache_finite"]
    window = get_config(arch, smoke=True).sliding_window
    assert res["cache_shapes"]["k"][2] == min(40, window or 40)


def test_serve_entry_point_with_moe_at_tp2_on_cpu():
    """``--arch qwen3-moe-30b-a3b --tp 2``: two ranks through the usual
    environment, expert parallelism over them; 3 x 41 prompt tokens pad to
    the TP size.  Each rank's raw transfer is exact and its cache holds its
    local KV head."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), GLOO_SOCKET_IFNAME="lo",
                   OMP_NUM_THREADS="1", RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serve.disaggregated", "--arch",
             "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu", "--prompt-len", "41",
             "--gen", "3", "--batch", "3", "--tp", "2"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, out + err
            outs.append(json.loads(out.splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    for rank, res in enumerate(outs):
        assert (res["rank"], res["tp"]) == (rank, 2)
        assert res["raw_transfer_exact"] and res["cache_finite"]
        assert res["cache_shapes"]["k"] == [cfg.n_layers, 3, 41, 1, cfg.head_dim]
