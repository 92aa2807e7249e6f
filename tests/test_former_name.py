"""The package's former name still imports: each of its modules is the very
module of amg_jax, and `python -m` runs the CLI through it."""

import importlib
import os
import subprocess
import sys

import pytest

import amg_jax.utils.cli
import amg_jax.utils.runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORMER = sorted(
    d for d in os.listdir(REPO)
    if d.startswith("amg_") and d != "amg_jax"
    and os.path.isfile(os.path.join(REPO, d, "__init__.py"))
)


def test_one_former_name():
    assert len(FORMER) == 1


@pytest.mark.parametrize("sub", ["utils.cli", "utils.runner", "dtypes",
                                 "setup.structured", "parallel.grid"])
def test_submodule_is_the_same_module(sub):
    alias = importlib.import_module(f"{FORMER[0]}.{sub}")
    real = importlib.import_module(f"amg_jax.{sub}")
    assert alias is real
    # the import through the alias leaves the module's own spec in place
    assert real.__spec__.name == f"amg_jax.{sub}"


def test_entry_points_and_package_names():
    pkg = importlib.import_module(FORMER[0])
    cli = importlib.import_module(f"{FORMER[0]}.utils.cli")
    assert cli.main is amg_jax.utils.cli.main
    assert pkg.CSRMatrix is amg_jax.CSRMatrix
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module(f"{FORMER[0]}.no_such_module")


def test_run_experiment_through_former_name():
    runner = importlib.import_module(f"{FORMER[0]}.utils.runner")
    assert runner.run_experiment is amg_jax.utils.runner.run_experiment


def test_cli_runs_as_module():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", f"{FORMER[0]}.utils.cli", "-problem", "5pt",
         "-n", "8", "-tol", "1e-6"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "rel res 2-norm" in out.stdout
