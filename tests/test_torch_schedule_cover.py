"""The port's counterpart of the schedule-cover gate
(``tools/check_schedule_cover.py``): every quoted mode-shaped token
(``flat`` / ``hier*``) under ``src/repro_torch/``, in ``chip_smoke.py``
and in the port's examples is a registered schedule builder mode
(``repro_torch.core.schedule.registered_modes()``) or a structural
wrapper (``STRUCTURAL_MODES``), whose targets are registered builders.
The port's schedule module registers the reference's builders and wraps
the same modes."""

import pathlib
import re

import pytest

from repro_torch.core import schedule

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the gate's pattern: a quoted "flat" or "hier" with optional _word suffixes
MODE_RE = re.compile(r"""["'](flat|hier(?:_[a-z0-9]+)*)["']""")
SOURCES = {"src/repro_torch": sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
           "chip_smoke.py": [ROOT / "chip_smoke.py"],
           "examples": sorted((ROOT / "examples").glob("torch_*.py"))}


def scan(paths) -> dict[str, list[str]]:
    """mode token -> the "file:line" sites it is quoted at."""
    found: dict[str, list[str]] = {}
    for path in paths:
        text = path.read_text()
        for m in MODE_RE.finditer(text):
            line = text.count("\n", 0, m.start()) + 1
            found.setdefault(m.group(1), []).append(f"{path.relative_to(ROOT)}:{line}")
    return found


def test_structural_modes_wrap_registered_builders():
    registered = set(schedule.registered_modes())
    assert set(schedule.STRUCTURAL_MODES.values()) <= registered


@pytest.mark.parametrize("where", list(SOURCES))
def test_every_mode_string_has_a_schedule(where):
    assert SOURCES[where], f"no source files under {where}"
    covered = set(schedule.registered_modes()) | set(schedule.STRUCTURAL_MODES)
    found = scan(SOURCES[where])
    missing = {m: sites[:5] for m, sites in found.items() if m not in covered}
    assert not missing, f"mode strings without a registered schedule builder: {missing}"


def test_the_port_registers_the_references_modes():
    from repro.core import schedule as jax_schedule

    assert schedule.registered_modes() == jax_schedule.registered_modes()
    assert schedule.STRUCTURAL_MODES == jax_schedule.STRUCTURAL_MODES


def test_the_gate_sees_the_modes_the_port_runs():
    """The scan is not vacuous: the port quotes every registered
    all-reduce mode and every mode-shaped structural wrapper
    (``hier_overlap``, ``hier_zero1``; ``fsdp`` is not mode-shaped)."""
    found = set(scan(SOURCES["src/repro_torch"]) | scan(SOURCES["chip_smoke.py"]))
    assert {"flat", "hier", "hier_pipelined", "hier_border_rs"} <= found
    assert {m for m in schedule.STRUCTURAL_MODES if MODE_RE.fullmatch(f'"{m}"')} \
        == {"hier_overlap", "hier_zero1"} <= found
