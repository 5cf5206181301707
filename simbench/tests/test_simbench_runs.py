"""Whole runs at a small size on the CPU, the harness's look for a card
skipped: the result line's schema; the plain reference agrees with the
port's plain path; each planted fault and the float32 control come out
not correct. And, on the card, one run of each cell."""

import json
import subprocess
import sys

import pytest
import torch

from simbench import core, faults

from .helpers import SEED, run_small

CELLS = [w["name"] for w in core.read_json(core.REPO / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    result, rows = run_small(name)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] == 2
    assert set(result["metrics"]) == {"lane_steps_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(v == 0 for _, v, _ in rows), rows
    json.dumps(result)


FAULTED = [(name, fault) for name in CELLS for fault in faults.FAULTS[core.Cell(name).traffic["unit"]]]


@pytest.mark.parametrize("name,fault", FAULTED)
def test_planted_fault_is_not_correct(name, fault):
    cell = core.Cell(name)
    adapter = core.experiment("experiments", cell.config, cell.traffic["unit"])
    with faults.planted(fault, cell.traffic["unit"], adapter):
        result, rows = run_small(name)
    assert result["correct"] is False, rows


@pytest.mark.parametrize("name", CELLS)
def test_float32_control_is_not_correct(name):
    result, rows = run_small(name, dtype=torch.float32)
    assert result["correct"] is False, rows


FIRST_ITERATION_IMPORTS = """
import sys
from simbench.experiments import optim_sphere
from simbench.tests.helpers import run_small

step, new = optim_sphere.Program.fit_step, []


def fit_step(self, state, span):
    before = set(sys.modules)
    out = step(self, state, span)
    new.append(sorted(set(sys.modules) - before))
    return out


optim_sphere.Program.fit_step = fit_step
result, rows = run_small("sphere_room.fit")
assert result["correct"] is True, rows
assert new and not new[0], new[0][:20]
"""


def test_a_fit_imports_nothing_in_its_first_iteration():
    # a fresh process: what the set-up leaves for the window to import, the
    # window pays (torch's forward-mode products import torch._dynamo)
    out = subprocess.run([sys.executable, "-c", FIRST_ITERATION_IMPORTS], cwd=core.REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = core.main(["--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1"], 0.0)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "simbench/run.py", "--workload", name, "--seed", str(SEED), "--seconds",
                          "1", "--trace", "0"], cwd=core.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu", result
