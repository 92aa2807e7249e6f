"""bench.py on the CPU: its table of peaks, its timing helpers, and its
refusal to measure without a GPU."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402


def test_peaks_lookup_known_kind():
    p = bench.peaks_for("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["source"]


@pytest.mark.parametrize("kind", ["Intel Data Center GPU Max 1550", "cpu", "NVIDIA A100"])
def test_peaks_lookup_unknown_kind_is_an_error(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peaks_for(kind)


def test_fori_slope_removes_fixed_cost():
    """run(k) = fixed + k * step: the slope recovers the step exactly."""
    assert bench.fori_slope(lambda k: 0.5 + 0.01 * k, 2, 22) == \
        pytest.approx(0.01)


def test_loop_runner_times_a_jitted_loop():
    import jax.numpy as jnp

    run = bench.loop_runner(lambda a, v: v + a, jnp.float32(1.0),
                            jnp.zeros(4, jnp.float32))
    assert run(3) > 0 and run(30) > 0


def test_recorder_tags_every_record(capsys):
    import json

    rec = bench.Recorder({"platform": "gpu", "kind": "k", "count": 1},
                         {"hbm_bytes_per_s": 1e12}, "card, 700.00 W")
    rec.copy_bw = 5e11
    out = rec.rate("m", 1e-3, 1e9)
    assert out["peak_share"] == pytest.approx(1.0)
    assert out["copy_share"] == pytest.approx(2.0)
    line = json.loads(capsys.readouterr().out)
    assert line["card"] == "card, 700.00 W" and line["device"]["kind"] == "k"


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "bench.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert out.stdout.strip() == ""
