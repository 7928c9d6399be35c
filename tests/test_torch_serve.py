"""The port's serving path against the JAX package's, smoke qwen2.5-3b.

The JAX side runs ``make_serve_steps`` / ``make_kv_transfer`` on a
one-device (pod, data, model) mesh.  Given the same cache, the int8 KV
transfer is bit-equal; in f32 the generated tokens are equal.  A 2-rank
gloo run checks the pod ring itself: rank r receives the int8 round
trip of rank r-1's cache.  Also: the port imports neither JAX nor the
JAX package, and its entry point refuses to run without a card unless
told to use the CPU.  The int8 sweep (``serve/int8_sensitivity.py``)
runs on the CPU for both serving models.
"""

import dataclasses
import datetime
import multiprocessing
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.launch.mesh import runtime_for_mesh
from repro.models import Model as JaxModel
from repro.serve import make_kv_transfer as jax_kv_transfer
from repro.serve import make_serve_steps as jax_serve_steps
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.kernels import quant as tquant
from repro_torch.launch.mesh import runtime_for_groups
from repro_torch.models.attention import KVCache
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import Runtime
from repro_torch.serve import disaggregated, int8_sensitivity
from repro_torch.serve.serve_step import (kv_transfer_body, make_kv_transfer,
                                          make_serve_steps)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S, GEN = 2, 130, 6


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.is_floating_point() else t).numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _setup(dt: str):
    jdt, tdt = DT[dt]
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    jm = JaxModel(dataclasses.replace(jax_config("qwen2.5-3b", smoke=True),
                                      dtype=jdt), runtime_for_mesh(mesh))
    params = jm.init(jax.random.key(0))
    tm = params_from_jax(jax.tree.map(np.asarray, params),
                         dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                                             dtype=tdt), device="cpu")
    prompt = np.random.default_rng(11).integers(0, jm.cfg.vocab_size, (B, S))
    return mesh, jm, params, tm, prompt


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_int8_kv_transfer_bit_equal_to_jax(dt):
    mesh, jm, params, tm, prompt = _setup(dt)
    jprefill, _, cshape = jax_serve_steps(jm, mesh, B, S + GEN)
    jtransfer = jax_kv_transfer(jm, mesh, cshape, B, compress="int8")
    _, jcaches = jprefill(params, jnp.asarray(prompt, jnp.int32))
    caches = KVCache(*(to_tensor(np.asarray(a), "cpu") for a in jcaches))
    moved = make_kv_transfer(tm, compress="int8")(caches)
    jmoved = jtransfer(jcaches)
    for got, want, sent in zip(moved, jmoved, caches):
        assert got.shape == want.shape and got.dtype == sent.dtype
        np.testing.assert_array_equal(_np(got), _jnp(want))
    assert not torch.equal(moved.k, caches.k)     # int8 is lossy: it ran


def test_disaggregated_generation_matches_jax_f32():
    mesh, jm, params, tm, prompt = _setup("f32")
    jprefill, jdecode, cshape = jax_serve_steps(jm, mesh, B, S + GEN)
    jtransfer = jax_kv_transfer(jm, mesh, cshape, B, compress="int8")
    jtok, jcaches = jprefill(params, jnp.asarray(prompt, jnp.int32))
    jcaches = jtransfer(jcaches)
    prefill, decode = make_serve_steps(tm)
    tok, caches = prefill(torch.from_numpy(prompt))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    caches = make_kv_transfer(tm, compress="int8")(caches)
    assert caches.k.shape[2] == S     # the prompt-long cache of the reference
    for i in range(GEN):
        jtok, jcaches = jdecode(params, jtok, jcaches)
        tok, caches = decode(tok, caches)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {i}")


def test_transfer_with_one_pod_returns_new_tensors():
    cache = KVCache(torch.randn(2, 1, 8, 2, 64), torch.randn(2, 1, 8, 2, 64),
                    torch.full((2,), 8, dtype=torch.int32))
    for compress in (None, "int8"):
        moved = kv_transfer_body(cache, Runtime(), compress)
        for a, b in zip(moved, cache):
            assert a.data_ptr() != b.data_ptr() and a.shape == b.shape
    assert torch.equal(kv_transfer_body(cache, Runtime()).k, cache.k)


# ---------------------------------------------------------------------------
# the pod ring on two gloo ranks
# ---------------------------------------------------------------------------

def _rank_cache(rank: int) -> KVCache:
    rng = np.random.default_rng(100 + rank)
    shape = (2, 2, 37, 2, 16)    # 4736 elements: a ragged last block
    k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    return KVCache(k, v, torch.full((2,), 30 + rank, dtype=torch.int32))


def _roundtrip(x: torch.Tensor) -> torch.Tensor:
    q, s = tquant.quant_int8_plain(x)
    return tquant.dequant_int8_plain(q, s, x.numel(), x.dtype).reshape(x.shape)


def _gloo_worker(rank: int, world: int, store_path: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        rt = runtime_for_groups(pod_group=dist.group.WORLD)
        mine, prev = _rank_cache(rank), _rank_cache((rank - 1) % world)
        moved = kv_transfer_body(mine, rt, compress="int8")
        assert torch.equal(moved.k, _roundtrip(prev.k))
        assert torch.equal(moved.v, _roundtrip(prev.v))
        assert torch.equal(moved.length, prev.length)      # raw: < 1024 elements
        raw = kv_transfer_body(mine, rt)
        assert all(torch.equal(a, b) for a, b in zip(raw, prev))
    finally:
        dist.destroy_process_group()


def test_kv_transfer_over_two_gloo_ranks(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    world = 2
    procs = [ctx.Process(target=_gloo_worker,
                         args=(r, world, str(tmp_path / "store")))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    assert [p.exitcode for p in procs] == [0] * world


# ---------------------------------------------------------------------------
# entry point and import isolation
# ---------------------------------------------------------------------------

def test_entry_point_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        disaggregated.run(smoke=True, batch=1, prompt_len=8, gen=1)


def test_entry_point_smoke_on_cpu():
    res = disaggregated.run(smoke=True, batch=2, prompt_len=130, gen=3,
                            device="cpu")
    assert res["raw_transfer_exact"]
    assert 0.0 <= res["int8_token_agreement"] <= 1.0
    assert res["cache_shapes"]["k"] == [2, 2, 130, 2, 16]
    assert len(res["tokens"][0]) == 4


@pytest.mark.parametrize("arch, leaves", [("qwen2.5-3b", ["k", "v"]),
                                          ("mamba2-2.7b", ["conv", "ssm"])])
def test_int8_sensitivity_smoke_on_cpu(arch, leaves):
    res = int8_sensitivity.run(arch, smoke=True, batch=2, prompt_len=130, gen=3,
                               device="cpu")
    variants = res["variants"]
    assert list(variants) == leaves + ["+".join(leaves)]
    both = variants["+".join(leaves)]
    for leaf in leaves:
        # a leaf's blocks are quantized alone: the same error in every variant
        assert variants[leaf]["leaf_rel_rms_err"] == {leaf: both["leaf_rel_rms_err"][leaf]}
        assert 0.0 < both["leaf_rel_rms_err"][leaf] < 0.05
    for v in variants.values():
        assert 0.0 < v["first_step_logit_rel_rms_err"] < 0.1
        assert 0 <= v["first_step_flips"] <= 2
        assert 0.0 <= v["decoded_token_agreement"] <= 1.0
    assert res["raw_logit_rms"] > 0 and res["raw_top2_margin_median"] >= 0


def test_int8_sensitivity_reads_only_the_real_vocab(monkeypatch):
    """mamba2-2.7b pads its vocabulary (50280 to 50304).  With a smoke
    config whose vocabulary pads too (250 to 256), and the padded columns
    made the largest logits, no token that the tool feeds to decode and
    no logit statistic it reports comes from a padded column."""
    cfg = dataclasses.replace(get_config("mamba2-2.7b", smoke=True), vocab_size=250)
    assert cfg.padded_vocab(1) == 256
    monkeypatch.setattr(int8_sensitivity, "get_config", lambda arch, smoke=False: cfg)
    fed = []
    real_decode = Model.apply_decode

    def apply_decode(self, token, caches):
        fed.append(int(token.max()))
        logits, caches = real_decode(self, token, caches)
        padded = torch.arange(logits.shape[-1]) >= cfg.vocab_size
        return torch.where(padded, 1e4, logits), caches

    monkeypatch.setattr(Model, "apply_decode", apply_decode)
    res = int8_sensitivity.run("mamba2-2.7b", smoke=True, batch=2, prompt_len=130,
                               gen=3, device="cpu")
    assert fed and max(fed) < cfg.vocab_size
    assert 0 < res["raw_top2_margin_median"] and res["raw_logit_rms"] < 1e3
    assert all(v["first_step_logit_rel_rms_err"] < 0.1 for v in res["variants"].values())


_IMPORT_CHECK = """
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
