"""GPipe over the pod group (``repro_torch.parallel.pipeline``) against
the JAX package's ``repro.parallel.pipeline``.

* The analog of ``tests/mdscripts/check_pipeline_pp.py``: a 2-stage GPipe
  of a 4-layer tanh MLP (Megatron pattern: column-parallel w1,
  row-parallel w2) on 8 gloo ranks as 2 pods x 2 data x 2 model, with
  M = 4 microbatches as in the script and with M = 1.  Each rank holds
  its pod's 2 layers, its model shard of them and its data shard of the
  batch; the loss and both stages' gradients (summed over the data
  group, the train step's job) must equal one process computing all
  layers: loss within rtol 1e-5, gradients within rtol 2e-4, atol 2e-5.
  The reference's GPipe on 8 host devices (one JAX subprocess; this file
  run as a script) gives the single-device oracle and its own PP result.
* In this process: the handoff's backward is the reverse ring (the
  adjoint of the forward shift, by gradcheck over a ring laid out on dim
  0), and a pipeline of one stage is the stage applied to each
  microbatch.
"""

import datetime
import os
import sys

import numpy as np

L, D, FF = 4, 16, 32          # 4 layers -> 2 per stage
BM, S = 2, 8                  # microbatch rows per data rank, sequence
PODS, DATA, TP = 2, 2, 2
MICROS = (4, 1)


def inputs(m: int) -> dict:
    """The check script's draws: weights (L, D, FF) and (L, FF, D), x and y
    (M, Bm * data, S, D)."""
    rng = np.random.default_rng(0)
    return {"w1": (rng.normal(size=(L, D, FF)) * 0.3).astype(np.float32),
            "w2": (rng.normal(size=(L, FF, D)) * 0.3).astype(np.float32),
            "x": rng.normal(size=(m, BM * DATA, S, D)).astype(np.float32),
            "y": rng.normal(size=(m, BM * DATA, S, D)).astype(np.float32)}


def _jax_main(out_dir: str, part: str) -> None:
    """The reference's GPipe on a (pod 2, data 2, model 2) mesh and the
    single-device loss and gradients, for each M."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from repro.parallel.pipeline import gpipe_apply, pp_loss_mask
    from repro.parallel.sharding import Runtime, copy_to_tp, reduce_from_tp, shard_map

    mesh = jax.make_mesh((PODS, DATA, TP), ("pod", "data", "model"))
    rt = Runtime(tp_axis="model", dp_axis="data", pod_axis="pod", tp_size=TP)

    def layer(x, w1, w2, tp_axis):
        h = jnp.tanh(copy_to_tp(x, tp_axis) @ w1)
        return x + reduce_from_tp(h @ w2, tp_axis)

    def ref_loss(ws1, ws2, x, y):
        def apply_all(xm):
            for i in range(L):
                xm = layer(xm, ws1[i], ws2[i], None)
            return xm
        return jnp.mean((jax.vmap(apply_all)(x) - y) ** 2)

    def pp_loss(ws1, ws2, x, y):
        def stage(xm):
            for i in range(L // PODS):
                xm = layer(xm, ws1[i], ws2[i], "model")
            return xm
        per = jnp.mean((gpipe_apply(stage, x, rt, n_stages=PODS) - y) ** 2)
        return reduce_from_tp(pp_loss_mask(per, rt, n_stages=PODS), "data") / DATA

    def pp_step(ws1, ws2, x, y):
        loss, grads = jax.value_and_grad(pp_loss, argnums=(0, 1))(ws1, ws2, x, y)
        return loss, jax.tree.map(lambda g: lax.psum(g, "data"), grads)

    pp = jax.jit(shard_map(
        pp_step, mesh=mesh,
        in_specs=(P("pod", None, "model"), P("pod", "model", None),
                  P(None, "data"), P(None, "data")),
        out_specs=(P(), (P("pod", None, "model"), P("pod", "model", None))),
        check_vma=False))
    out = {}
    for m in MICROS:
        a = {k: jnp.asarray(v) for k, v in inputs(m).items()}
        loss, (g1, g2) = pp(a["w1"], a["w2"], a["x"], a["y"])
        rloss, (r1, r2) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
            a["w1"], a["w2"], a["x"], a["y"])
        out.update({f"m{m}/pp/loss": np.asarray(loss), f"m{m}/pp/g1": np.asarray(g1),
                    f"m{m}/pp/g2": np.asarray(g2), f"m{m}/ref/loss": np.asarray(rloss),
                    f"m{m}/ref/g1": np.asarray(r1), f"m{m}/ref/g2": np.asarray(r2)})
    np.savez(os.path.join(out_dir, f"jax_{part}.npz"), **out)


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    """One rank of the (2, 2, 2) world: the pipeline's loss and this rank's
    gradient shards for each M."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import mesh_coords, runtime_for_groups
    from repro_torch.parallel.pipeline import gpipe_apply, pp_loss_mask
    from repro_torch.parallel.sharding import copy_to_tp, reduce_from_tp

    torch.set_num_threads(1)
    world = PODS * DATA * TP
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        rt = runtime_for_groups(pods=PODS, data_per_pod=DATA, tp=TP)
        pod, d, mi = mesh_coords(rank, DATA, TP)
        lay, ff = slice(pod * L // PODS, (pod + 1) * L // PODS), slice(mi * FF // TP,
                                                                        (mi + 1) * FF // TP)
        rows = slice(d * BM, (d + 1) * BM)

        def layer(x, w1, w2):
            h = torch.tanh(copy_to_tp(x, rt.tp_group) @ w1)
            return x + reduce_from_tp(h @ w2, rt.tp_group)

        for m in MICROS:
            a = inputs(m)
            w1 = torch.from_numpy(a["w1"][lay][:, :, ff].copy()).requires_grad_()
            w2 = torch.from_numpy(a["w2"][lay][:, ff].copy()).requires_grad_()
            x, y = (torch.from_numpy(a[k][:, rows].copy()) for k in ("x", "y"))

            def stage(xm):
                for i in range(L // PODS):
                    xm = layer(xm, w1[i], w2[i])
                return xm

            per = torch.mean((gpipe_apply(stage, x, rt, n_stages=PODS) - y) ** 2)
            loss = reduce_from_tp(pp_loss_mask(per, rt, n_stages=PODS), rt.data_group) / DATA
            loss.backward()
            for g in (w1.grad, w2.grad):
                dist.all_reduce(g, group=rt.data_group)
            out.update({f"m{m}/loss": loss.detach().numpy(), f"m{m}/g1": w1.grad.numpy(),
                        f"m{m}/g2": w2.grad.numpy()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _jax_main(sys.argv[1], sys.argv[2])
    sys.exit(0)


import pytest  # noqa: E402
import torch  # noqa: E402

from _torch_world import run_world  # noqa: E402
from repro_torch.launch.mesh import mesh_coords  # noqa: E402
from repro_torch.parallel import pipeline  # noqa: E402
from repro_torch.parallel.sharding import Runtime  # noqa: E402

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    return run_world(__file__, tmp, ("pp",), PODS * DATA * TP, _gloo_rank,
                     PODS * DATA * TP)


def _shard(g: np.ndarray, rank: int, which: str) -> np.ndarray:
    """Rank ``rank``'s block of a global gradient: its pod's layers, its
    model slice of FF (dim 2 of w1, dim 1 of w2)."""
    pod, _, mi = mesh_coords(rank, DATA, TP)
    g = g[pod * L // PODS:(pod + 1) * L // PODS]
    n = FF // TP
    return g[:, :, mi * n:(mi + 1) * n] if which == "g1" else g[:, mi * n:(mi + 1) * n]


@pytest.mark.parametrize("m", MICROS)
def test_loss_matches_one_process(results, m):
    want, ranks = results
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(float(got[f"m{m}/loss"]), float(want[f"m{m}/ref/loss"]),
                                   rtol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(float(got[f"m{m}/loss"]), float(want[f"m{m}/pp/loss"]),
                                   rtol=1e-5, err_msg=f"rank {r}")


@pytest.mark.parametrize("m", MICROS)
@pytest.mark.parametrize("which", ["g1", "g2"])
def test_both_stages_gradients_match_one_process(results, m, which):
    """Each rank's shard against one process's gradient and against the
    reference's GPipe shard of it, so both stages (pods 0 and 1) and both
    model shards are held."""
    want, ranks = results
    for r, got in enumerate(ranks):
        g = got[f"m{m}/{which}"]
        np.testing.assert_allclose(g, _shard(want[f"m{m}/ref/{which}"], r, which),
                                   **GRAD_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(g, _shard(want[f"m{m}/pp/{which}"], r, which),
                                   **GRAD_TOL, err_msg=f"rank {r}")
        assert np.abs(g).max() > 0, f"rank {r}: its stage took no gradient"


def test_handoff_backward_is_the_reverse_ring(monkeypatch):
    """With the ring of pods laid out on dim 0 (a shift by k is a roll by
    k), the handoff sends forward by +1 and its backward by -1, the
    adjoint: gradcheck in f64."""
    calls = []

    def ring(tensors, group, by=1):
        calls.append(by)
        return [torch.roll(t, by, 0) for t in tensors]

    monkeypatch.setattr(pipeline, "shift", ring)
    x = torch.randn(4, 3, 5, dtype=torch.float64, requires_grad=True)
    y = pipeline._RingShift.apply(x, "pods")
    assert torch.equal(y, torch.roll(x, 1, 0)) and calls == [1]
    g = torch.randn_like(y)
    (gx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(gx, torch.roll(g, -1, 0)) and calls == [1, -1]
    assert torch.autograd.gradcheck(lambda t: pipeline._RingShift.apply(t, "pods"), (x,))


def test_one_stage_is_the_stage_per_microbatch():
    """No pod group: T = M slots, each microbatch through the stage once,
    in order, and the loss mask keeps the value."""
    w = torch.randn(D, D, dtype=torch.float64)
    x = torch.randn(3, BM, S, D, dtype=torch.float64)
    out = pipeline.gpipe_apply(lambda t: torch.tanh(t @ w), x, Runtime(), n_stages=1)
    torch.testing.assert_close(out, torch.tanh(x @ w), rtol=0, atol=0)
    v = torch.tensor(2.5)
    assert pipeline.pp_loss_mask(v, Runtime(), n_stages=1) == v
