"""Small sizes at which a cell runs on the CPU in a test (the port's plain
path in place of its kernels): 2 lanes, and few enough frames that the
bodies touch down and bounce a little."""

import time

from simbench import core

SEED = 2**31 + 12345


def small(cell: core.Cell) -> dict:
    c = cell.config
    if c["experiment"] == "optim_sphere":
        return dict(lanes=2, run_time=0.9, draws={"rad": {"kind": "uniform", "low": 1.8, "high": 2.0}},
                    sphere=dict(c["sphere"], mesh_subdiv=1), sim=dict(c["sim"], mesh_subdiv=1))
    return dict(lanes=2, run_time=0.6)


def run_small(name: str, dtype=None, seed: int = SEED):
    """(result, check rows) of one unit of the cell at its small size (the
    program on four threads: on the CPU it does the work itself)."""
    core.PROGRAM_THREADS = 4
    cell = core.Cell(name)
    result, rows, _ = core.run(cell, seed, 0.0, False, time.perf_counter(), device="cpu", dtype=dtype,
                               overrides=small(cell))
    return result, rows
