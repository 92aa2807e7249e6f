"""chip_smoke.py on the CPU: it refuses to run without a GPU, --multichip
selects only the four-card paths, and every phase's checks pass at small
sizes (the CPU rehearsal of the GPU run)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# the iteration counts are the CPU's float64 readings at these sizes
SMALL = {
    "B": dict(n=16, expect=8),
    "C": dict(n=16, expect=13),
    "D": dict(nx=8, ny=2, nz=2, expect=4),
    "E": dict(n=1000),
    "F": dict(n=10, expect={"mult": 10, "async_multadd": 73}),
    "G": dict(n=4, expect=10),
    "dist_elasticity": dict(nx=7, ny=2, nz=2, expect=4),
    "grid_multadd": dict(n=12, expect=75),
    "async_ams": dict(n=4, expect=88),
}


def _run_script(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [(), ("--multichip",)],
                         ids=["single", "multichip"])
def test_exits_nonzero_without_gpu(args):
    out = _run_script(REPO, *args)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_exits_nonzero_outside_the_repo(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_multichip_selects_only_its_phases():
    assert chip_smoke.phases_for(True) == chip_smoke.MULTICHIP_PHASES
    assert chip_smoke.phases_for(False) == chip_smoke.SINGLE_PHASES
    assert not set(chip_smoke.MULTICHIP_PHASES) & set(chip_smoke.SINGLE_PHASES)
    assert chip_smoke.MULTICHIP_DEVICES == 4
    assert set(chip_smoke.FULL) == set(chip_smoke.PHASE_FNS)


def test_phase_option_selects_within_the_mode():
    assert chip_smoke.select_phases(False) == chip_smoke.SINGLE_PHASES
    assert chip_smoke.select_phases(True, []) == chip_smoke.MULTICHIP_PHASES
    assert chip_smoke.select_phases(
        True, ["async_ams", "grid_multadd"]) == ("grid_multadd", "async_ams")
    with pytest.raises(SystemExit, match="dist_elasticity"):
        chip_smoke.select_phases(False, ["dist_elasticity"])
    with pytest.raises(SystemExit, match="B"):
        chip_smoke.select_phases(True, ["B"])


def test_full_sizes_are_the_stated_ones():
    """192^3 for the structured phases, the 362k-dof beam, and a
    four-way-divisible beam for the sharded elasticity path."""
    assert chip_smoke.FULL["B"]["n"] ** 3 == 7_077_888
    d = chip_smoke.FULL["D"]
    assert 3 * (d["nx"] + 1) * (d["ny"] + 1) * (d["nz"] + 1) == 361_875
    e = chip_smoke.FULL["dist_elasticity"]
    assert (e["nx"] + 1) % chip_smoke.MULTICHIP_DEVICES == 0
    # the grid paths' grids divide over the cards (no replicated fallback)
    g = chip_smoke.FULL["grid_multadd"]["n"]
    assert g >= 128 and g % chip_smoke.MULTICHIP_DEVICES == 0
    assert chip_smoke.FULL["async_ams"]["n"] % chip_smoke.MULTICHIP_DEVICES == 0


def test_check_raises():
    with pytest.raises(chip_smoke.CheckFailed, match="boom"):
        chip_smoke.check(False, "boom")
    chip_smoke.check(True, "never")


def _readings(sizes):
    for phase, kw in sizes.items():
        exp = kw.get("expect")
        if isinstance(exp, dict):
            yield from ((f"{phase}-{k}", v) for k, v in exp.items())
        elif phase != "E":
            yield phase, exp


@pytest.mark.parametrize("name,expect", list(_readings(chip_smoke.FULL)),
                         ids=[n for n, _ in _readings(chip_smoke.FULL)])
def test_every_solve_phase_has_a_band(name, expect):
    """A reading exists for every solving phase, and its band catches a
    doubled or halved iteration count."""
    assert isinstance(expect, int) and expect > 0, name
    lo, hi = chip_smoke.band(expect)
    assert lo <= expect <= hi
    assert 2 * expect > hi and expect // 2 < lo


def test_check_band_rejects_counts_outside():
    chip_smoke.check_band("X", 20, 16)
    with pytest.raises(chip_smoke.CheckFailed, match=r"X: 48 iterations"):
        chip_smoke.check_band("X", 48, 16)
    with pytest.raises(chip_smoke.CheckFailed, match=r"outside \[12, 20\]"):
        chip_smoke.check_band("X", 11, 16)


@pytest.mark.parametrize("phase", chip_smoke.SINGLE_PHASES)
def test_single_card_phase_small(phase, capsys):
    chip_smoke.run_phases([phase], SMALL)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["phase"] == phase and rec["seconds"] >= 0


@pytest.mark.parametrize("phase", chip_smoke.MULTICHIP_PHASES)
def test_multichip_phase_small(phase, capsys):
    """On four of the eight virtual CPU devices the tests provide."""
    chip_smoke.run_phases([phase], SMALL)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["phase"] == phase
    assert rec["dev4"]["host_rel"] > 0 and rec["dev1"]["host_rel"] > 0
