"""Each kernel's operation and byte count against a small case worked by
hand, and the sizes read from a wrapper's call."""

import types

import pytest
import torch

from simbench.counts import k1, k2, k3, k4


def test_k1_one_contact():
    # nz 6, no equality row, k 1 contact with fd 2: nineq 4, m2 = 0 + 1 + 1 = 2;
    # base 2*2*6*3 + 2*3*6 = 108, LU solve 2/3*8 + 2*4; bytes (2*36 + 24 + 16 + 6 + 4) in + (6 + 8) out
    s = k1.sizes(dict(dims=(1, 1, 6, 1, 0, 4, 1, 2, 10, 3)))
    assert s == dict(is64=1, B=1, nz=6, neq=0, nineq=4, k=1, fd=2)
    ops, nbytes = k1.count(s)
    assert ops == pytest.approx(108 + 16 / 3 + 8)
    assert nbytes == (72 + 24 + 16 + 6 + 4 + 14) * 8
    ops3, nbytes3 = k1.count(dict(s, B=3, is64=0))
    assert ops3 == pytest.approx(3 * ops) and nbytes3 == 3 * nbytes // 2


def test_k2_one_contact():
    s = k2.sizes(dict(dims=(1, 1, 6, 1, 0, 4, 1, 2)))
    ops, nbytes = k2.count(s)
    assert ops == pytest.approx(108 + 16 / 3 + 8)
    assert nbytes == (36 + 24 + 16 + 4 + 6 + 6 + 4) * 8


def test_k3_two_poses_of_a_tetrahedron():
    bd1 = types.SimpleNamespace(faces_t=torch.zeros((4, 3), dtype=torch.int64), verts=torch.zeros((4, 3)),
                                lanes=0, is_sdf=True)
    q = torch.zeros((2, 4), dtype=torch.float64)
    s = k3.sizes(bd1, q, None, None, None, None, types.SimpleNamespace(contact_polish_iters=10))
    assert s == dict(is64=1, R=2, F=4, V=4, lanes1=1, polish=10)
    ops, nbytes = k3.count(s)
    assert ops == 2 * 4 * (500 + 2000)
    assert nbytes == (4 * 3 * 8 + 4 * 3 * 8 + 2 * 2 * 7 * 8) + (2 * 4 * (13 * 8 + 2) + 2 * 8)


def test_k4_two_layers():
    params = types.SimpleNamespace(weights=(torch.zeros((3, 5)), torch.zeros((1, 3))))
    s = k4.sizes(params, torch.zeros((10, 5), dtype=torch.float64))
    assert s == dict(is64=1, N=10, d_in=5, layers=[(3, 5), (1, 3)])
    ops, nbytes = k4.count(s)
    assert ops == 10 * (2 * 18 + 4 * 3)
    assert nbytes == (10 * 6 + 15 + 3 + 3 + 1) * 8
