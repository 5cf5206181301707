"""The fit's check over its sampled lanes, on synthetic answers: every lane
is held by its worst gap, and a lane is treated as at a contact tie only
where the reference's own loss or gradient shows one."""

import torch

from simbench import compare, core

LIMITS = core.Cell("sphere_room.fit").workload["limits"]


def _traj(n):
    z = torch.zeros((n, 3, 2, 1, 3), dtype=torch.float64)
    valid = torch.zeros((n, 3, 2), dtype=torch.bool)
    valid[..., 0] = True
    return compare.Traj(t=z[..., 0, 0], quat=torch.zeros((n, 3, 2, 1, 4), dtype=torch.float64), pos=z, v=z,
                        valid=valid, bisect_failed=torch.zeros((n, 3, 2), dtype=torch.bool),
                        truncated=torch.zeros((n, 3), dtype=torch.bool),
                        n_halvings=torch.zeros((n, 3, 2), dtype=torch.int64))


def _answers(grad, loss=None):
    g = torch.tensor(grad, dtype=torch.float64)
    lo = torch.ones_like(g) if loss is None else torch.tensor(loss, dtype=torch.float64)
    return dict(loss=lo, grad=g, param=1.0 - 0.1 * g, target=_traj(len(grad)))


def _check(prog_grad, ref_grad, moved_grad, prog_loss=None, ref_loss=None, moved_loss=None):
    """``check`` with the reference's jobs answered from the lists: each
    sampled lane's gradient (and loss, 1 where not given), and each lane's
    at its start times 1 +- 1e-13."""
    n = len(prog_grad)
    ones = [1.0] * n
    prog_loss, ref_loss, moved_loss = (x or ones for x in (prog_loss, ref_loss, moved_loss))
    sample = list(range(n))
    calls = []

    def map_(fn, jobs):
        out = []
        for job in jobs:
            calls.append(job["lanes"])
            i = job["lanes"][0]
            if job["scale"] == [1.0]:
                out.append(_answers([ref_grad[i]], [ref_loss[i]]))
            else:
                out.append(_answers([moved_grad[i]] * 2, [moved_loss[i]] * 2))
        return out

    job = dict(traffic=dict(unit="fit"), sample=sample, limits=LIMITS, program=_answers(prog_grad, prog_loss))
    numbers, notes = core.check(job, map_)
    return compare.judge(numbers, LIMITS)[0], numbers, notes, calls


def test_every_lane_is_held_by_the_worst():
    ok, numbers, notes, calls = _check([1.0, 2.0, 0.0, 0.0], [1.0, 2.0, 3.0, 4.0], [1.0, 2.0, 3.0, 4.0])
    assert not ok and numbers["grad"] == 1.0 and numbers["param"] > LIMITS["param"]
    assert notes["ties"] == [] and calls[4:] == [[2, 2], [3, 3]]


def test_a_gradient_at_a_contact_tie_is_left_out():
    ok, numbers, notes, _ = _check([1.0, 2.01], [1.0, 2.0], [1.0, 2.02])
    assert ok and notes["ties"] == [1] and numbers["grad"] == 0.0


def test_a_gradient_not_at_a_tie_fails():
    ok, numbers, notes, _ = _check([1.0, 2.01], [1.0, 2.0], [1.0, 2.0])
    assert not ok and notes["ties"] == [] and numbers["grad"] > LIMITS["grad"]


def test_a_loss_at_a_tie_is_held_to_the_nearest_reading():
    """As a lane read on the card: the reference's loss and gradient at its
    start stand apart from those at 1 +- 1e-13, and the program's match the
    latter."""
    grad, loss = [1.0, 2.334004354216], [1.0, 2.8769374794645]
    ok, numbers, notes, _ = _check(grad, [1.0, 2.334018516962], grad, loss, [1.0, 2.8769382658621], loss)
    assert ok and notes["ties"] == [1] and numbers["loss"] == 0.0
    ok, numbers, notes, _ = _check(grad, [1.0, 2.334018516962], grad, [1.0, 2.9], [1.0, 2.8769382658621], loss)
    assert not ok and numbers["loss"] > LIMITS["loss"]


def test_a_loss_not_at_a_tie_fails():
    ok, numbers, notes, _ = _check([1.0, 2.0], [1.0, 2.0], [1.0, 2.0], [1.0, 1.0 + 1e-6], [1.0, 1.0], [1.0, 1.0])
    assert not ok and notes["ties"] == [] and numbers["loss"] > LIMITS["loss"]


def test_sampled_lanes_are_distinct_and_spread():
    lanes = core.sample_lanes(2**31 + 7, 50, 8)
    assert len(set(lanes)) == 8 and all(i * 50 // 8 <= x < (i + 1) * 50 // 8 + 1 for i, x in enumerate(lanes))
    assert core.sample_lanes(5, 2, 8) == [0, 1]
