"""The port's dry run end to end and the sweep tools over it.

* ``--device cuda`` needs a CUDA build of torch: in this one, views and
  autograd of fake CUDA tensors ask for the CUDA device guard, so the
  trace refuses by name (the card's own trace is
  ``tests/test_torch_gpu.py``'s and ``chip_smoke.py``'s; the launches it
  counts are held on the meta device in ``tests/test_torch_dryrun.py``).
* The CLI at full width on the 512-rank multi-pod mesh, each run in a
  subprocess of its own, side by side: whisper-tiny ``train_4k`` with
  ``--plan auto``; qwen2.5-3b ``train_4k`` under ``hier_zero1`` + int8
  (its ZeRO-1 master shaped by ``zero1_master_layout``); every arch's
  ``decode_32k`` in one process (one fake world, cut again per cell),
  and ``long_500k`` skipped where the reference's ``cell_applicable``
  skips it, with its reason; one ``--elastic --guard --chaos 0`` cell,
  whose sections equal the port's functions' (held to the reference's
  in ``tests/test_torch_dryrun.py``).
* The sweep tools: ``sweep.py`` over two whisper-tiny cells;
  ``roofline_report.py`` a verbatim copy whose markdown over those JSONs
  is the reference script's; ``hillclimb.py``'s ``CELLS`` the
  reference's, and one olmo-1b single-pod iteration run through it.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, hillclimb, sweep

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
ALL_DECODE = """
import json, sys
from repro_torch.launch import dryrun, sweep
cells = [dryrun.lower_cell(a, s, multi_pod=True, device="cpu")
         for s in ("decode_32k", "long_500k") for a in sweep.ARCHS]
json.dump(cells, open(sys.argv[1], "w"))
"""


def _dryrun(*args):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "multi",
            "--device", "cpu", *args]


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """Every subprocess of this file, started together before the first
    test: (their directory, {name: process})."""
    tmp = tmp_path_factory.mktemp("sweep")
    cmds = {
        "whisper": _dryrun("--arch", "whisper-tiny", "--shape", "train_4k", "--plan", "auto",
                           "--out", str(tmp / "whisper.json")),
        "qwen": _dryrun("--arch", "qwen2.5-3b", "--shape", "train_4k", "--mode", "hier_zero1",
                        "--compression", "int8", "--out", str(tmp / "qwen.json")),
        "decode": [sys.executable, "-c", ALL_DECODE, str(tmp / "decode.json")],
        "sections": _dryrun("--arch", "whisper-tiny", "--shape", "decode_32k", "--mode", "hier",
                            "--elastic", "--guard", "--chaos", "0", "--plan-cache",
                            str(tmp / "plans.pkl"), "--out", str(tmp / "sections.json")),
        "sweep": [sys.executable, "-m", "repro_torch.launch.sweep", "--archs", "whisper-tiny",
                  "--shapes", "train_4k,decode_32k", "--meshes", "multi", "--device", "cpu",
                  "--out", str(tmp / "sweep")],
        "hillclimb": [sys.executable, "-m", "repro_torch.launch.hillclimb", "--arch", "olmo-1b",
                      "--tag", "it0_base", "--device", "cpu", "--out", str(tmp / "perf")],
    }
    procs = {name: subprocess.Popen(cmd, env=ENV, cwd=tmp, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, cmd in cmds.items()}
    try:
        yield tmp, procs
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate(timeout=10)


@pytest.fixture(scope="module")
def runs(started):
    """{name: (return code, output, the JSON it wrote)} once every
    subprocess has ended, and "tmp": their directory."""
    tmp, procs = started
    out = {"tmp": tmp}
    for name, proc in procs.items():
        text = proc.communicate(timeout=600)[0]
        path = tmp / f"{name}.json"
        out[name] = (proc.returncode, text,
                     json.loads(path.read_text()) if path.exists() else None)
    return out


# ---------------------------------------------------------------------------
# The card's path refused where this torch cannot trace it
# ---------------------------------------------------------------------------

WORLD_OF_ONE = {"pod": 1, "data": 1, "model": 1}


def test_cuda_trace_needs_a_cuda_build():
    if torch.backends.cuda.is_built():
        pytest.skip("this torch is built with CUDA: the card's trace runs")
    with pytest.raises(RuntimeError, match="CUDA build"):
        dryrun.trace_cell(get_config("qwen2.5-3b", smoke=True),
                          ShapeConfig("t", "train", 8, 2), None, WORLD_OF_ONE, device="cuda")


# ---------------------------------------------------------------------------
# The CLI end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["whisper", "qwen"])
def test_cli_train_cell(runs, name):
    rc, text, res = runs[name]
    assert rc == 0, text[-3000:]
    assert res["status"] == "ok" and res["n_chips"] == 512
    for key in ("collectives", "roofline", "memory", "kernels", "trace_s", "flops", "bytes"):
        assert key in res
    assert res["memory"]["peak_per_device_gib"] > 0 and res["flops"] > 0
    assert res["roofline"]["dcn_bytes"] > 0          # the gradients cross the pods
    if name == "whisper":
        assert "plan" in res and "plan_cache" in res
    else:
        assert res["comm_mode"] == "hier_zero1" and res["compression"] == "int8"
        assert set(res["collectives"]) >= {"all-reduce", "reduce-scatter", "all-gather"}


def test_cli_every_arch_decode_and_long(runs):
    from repro.configs import cell_applicable, get_config as jax_config
    from repro.configs import get_shape as jax_shape

    rc, text, cells = runs["decode"]
    assert rc == 0, text[-3000:]
    assert len(cells) == 2 * len(sweep.ARCHS)
    for cell in cells:
        ok, why = cell_applicable(jax_config(cell["arch"]), jax_shape(cell["shape"]))
        if ok:
            assert cell["status"] == "ok", cell
            assert cell["kernels"] == {} and cell["memory"]["peak_per_device_gib"] > 0
        else:
            assert cell["status"] == "skipped" and cell["reason"] == why
    assert sum(c["status"] == "ok" for c in cells) > len(sweep.ARCHS)


def test_cli_sections_equal_the_functions(runs, tmp_path):
    rc, text, res = runs["sections"]
    assert rc == 0, text[-3000:]
    assert res["guard"] == dryrun.guard_section(None, mode="hier", chunks=4, compression=None,
                                                n_chips=512)
    assert res["chaos"] == json.loads(json.dumps(dryrun.chaos_section(
        0, "whisper-tiny", multi_pod=True, border_scarce=False, plan=None, mode="hier",
        chunks=4, compression=None)))
    rep = dryrun.elastic_replan_report("whisper-tiny", multi_pod=True, comm_mode="hier",
                                       plan_cache_path=str(tmp_path / "plans.pkl")).summary()
    got = dict(res["replan"])
    for r in (rep, got):
        r.pop("replan_latency_s")
    assert got == json.loads(json.dumps(rep))


def test_cli_error_writes_status_error(tmp_path):
    out = tmp_path / "e.json"
    proc = subprocess.run(_dryrun("--arch", "no-such-arch", "--shape", "decode_32k",
                                  "--out", str(out)), env=ENV, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1
    assert json.loads(out.read_text())["status"] == "error"


# ---------------------------------------------------------------------------
# The sweep tools
# ---------------------------------------------------------------------------

def test_sweep_two_whisper_cells(runs):
    rc, text, _ = runs["sweep"]
    assert rc == 0, text[-3000:]
    cells = [json.loads(p.read_text()) for p in sorted((runs["tmp"] / "sweep").glob("*.json"))]
    assert [(c["arch"], c["shape"], c["mesh"], c["status"]) for c in cells] == [
        ("whisper-tiny", "decode_32k", "multi", "ok"), ("whisper-tiny", "train_4k", "multi", "ok")]
    assert cells[1]["comm_mode"] == "fsdp"


def test_roofline_report_is_the_references(runs):
    assert ((ROOT / "src/repro_torch/launch/roofline_report.py").read_text()
            == (ROOT / "src/repro/launch/roofline_report.py").read_text())
    outs = []
    for pkg in ("repro", "repro_torch"):
        proc = subprocess.run([sys.executable, "-m", f"{pkg}.launch.roofline_report", "--dir",
                               str(runs["tmp"] / "sweep"), "--mesh", "multi"], env=ENV,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    assert outs[0] == outs[1]
    assert "| whisper-tiny | train_4k |" in outs[1] and "most collective-bound" in outs[1]


def test_hillclimb_cells_are_the_references(runs):
    from repro.launch import hillclimb as ref_hillclimb

    assert hillclimb.CELLS == ref_hillclimb.CELLS
    assert sum(len(v) for v in hillclimb.CELLS.values()) == 21
    rc, text, _ = runs["hillclimb"]
    assert rc == 0, text[-3000:]
    res = json.loads((runs["tmp"] / "perf" / "olmo-1b__train_4k__single__it0_base.json")
                     .read_text())
    assert res["status"] == "ok" and res["n_chips"] == 256 and res["comm_mode"] == "hier"
    assert "olmo-1b train_4k single it0_base: ok" in text


def test_sweep_lists_the_references():
    from repro.launch import sweep as ref_sweep

    assert (sweep.ARCHS, sweep.SHAPES) == (ref_sweep.ARCHS, ref_sweep.SHAPES)
    assert {get_shape(s).name for s in sweep.SHAPES} == set(sweep.SHAPES)
