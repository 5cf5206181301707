"""K1, K2, K3, K4 and K5's CUDA sources run on the CPU (tests/cuda_emu: g++,
one OS thread per CUDA thread, clusters, distributed shared memory and the
DMMA fragment layout emulated) and held against their plain versions, case
by case (see tests/cuda_emu/emu_check.py). Slow: it compiles the sources
with g++ and runs every CUDA thread of a cluster as an OS thread."""

import importlib.util
import os

import pytest
import torch

pytestmark = pytest.mark.slow

_spec = importlib.util.spec_from_file_location(
    "emu_check", os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_emu", "emu_check.py"))
emu_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(emu_check)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return emu_check.build_libs(str(tmp_path_factory.mktemp("cuda_emu")))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", emu_check.CASES, ids=[c[0].replace(" ", "-") for c in emu_check.CASES])
def test_kernels_match_plain_emulated(libs, case, dtype):
    for line, ok in emu_check.check_case(libs, dtype, case):
        assert ok, line


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", emu_check.K4_CASES, ids=[c[0].replace(" ", "-") for c in emu_check.K4_CASES])
def test_igr_kernel_matches_plain_emulated(libs, case, dtype):
    for line, ok in emu_check.check_k4_case(libs, dtype, case):
        assert ok, line


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", emu_check.K3_CASES, ids=[c.replace(" ", "-") for c in emu_check.K3_CASES])
def test_fw_kernel_matches_plain_emulated(libs, case, dtype):
    for line, ok in emu_check.check_k3_case(libs, dtype, case):
        assert ok, line


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", emu_check.K5_CASES, ids=[c[0].replace(" ", "-") for c in emu_check.K5_CASES])
def test_grid_kernel_matches_plain_emulated(libs, case, dtype):
    for line, ok in emu_check.check_k5_case(libs, dtype, case):
        assert ok, line
