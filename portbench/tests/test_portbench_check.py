"""The comparison that decides ``correct``: its numbers, and whole runs on
the CPU at a tiny size that skip the look for a card. A sound run is
correct; the control in the port's place, and each fault of
:mod:`portbench.faults` planted under the timed path, are not."""

from __future__ import annotations

import pytest

from portbench import check, faults, run
from portbench.tests.tiny import tiny_cell

CELLS = ("resnet50.train_b212", "vit_s16.train_b212")
SEED = 2 ** 31 + 11  # past 32 signed bits: seeds may be that large


def _readings(loss, grad, change, stats=None):
    return check.Readings(losses=loss, grad=grad, change=change, stats=stats or {})


def test_numbers_take_the_worst_leaf_against_its_norm_or_the_median():
    ref = _readings([2.0, 2.0, 2.0], {"a": 1.0, "b": 2.0, "c": 3.0, "z": 1e-9},
                    {"a": 1.0, "b": 2.0, "c": 3.0, "z": 1e-5}, {"s": 1.0})
    got = _readings([2.0, 2.02, 2.0], {"a": 1.1, "b": 2.0, "c": 3.3, "z": 0.5},
                    {"a": 1.0, "b": 2.2, "c": 3.0, "z": 9.0}, {"s": 0.5})
    found = check.numbers(got, ref)
    assert found["loss_gap"] == (pytest.approx(0.01), "step 2")
    # z's gap is 0.5 over the median leaf's 1.5.
    assert found["grad_gap"] == (pytest.approx(0.5 / 1.5), "z")
    # z's reference gradient is under a thousandth of the median: not held.
    assert found["change_gap"] == (pytest.approx(0.1), "b")
    assert found["stats_gap"] == (pytest.approx(0.5), "s")
    # The median of a's 0.1 / 1.5, b's 0, c's 0.1 and z's 0.5 / 1.5.
    assert found["grad_gap_median"] == (pytest.approx((0.1 / 1.5 + 0.1) / 2), "median leaf")


def test_judge_needs_every_number_within_its_limit():
    found = {"loss_gap": (0.001, ""), "grad_gap": (0.02, "")}
    assert check.judge(found, {"loss_gap": 0.01, "grad_gap": 0.05})[0]
    assert not check.judge(found, {"loss_gap": 0.01, "grad_gap": 0.01})[0]
    # Only the cell's numbers are compared; a number it compares must be read.
    assert check.judge(found, {"loss_gap": 0.01})[0]
    assert not check.judge(found, {"loss_gap": 0.01, "stats_gap": 0.01})[0]
    assert not check.judge(found, {})[0]
    assert not check.judge({"loss_gap": (float("nan"), "")}, {"loss_gap": 0.01})[0]


def _quiet(*args, **kwargs):
    pass


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, lines = run.run_cell(tiny_cell(name), SEED, 0.2, False, device="cpu", log=_quiet)
    assert result["correct"], lines
    assert lines[-1] == "correct: True"
    assert list(result)[-1] == "check"
    assert set(result["check"]) == set(tiny_cell(name).settings["check"]) | {"failed_steps"}


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    result, lines = run.run_cell(tiny_cell(name), SEED, 0.2, False, device="cpu",
                                 plant=lambda task: faults.plant(task, fault), log=_quiet)
    assert not result["correct"], lines


@pytest.mark.parametrize("name", CELLS)
def test_float8_control_is_not_correct(name):
    from portbench.traffic import make_pool

    cell = tiny_cell(name)
    pool = make_pool(cell.traffic, cell.config["num_classes"], SEED, "cpu")
    ref = run.reference_readings(cell, SEED, pool, "cpu")
    control = run.reference_readings(cell, SEED, pool, "cpu", precision="float8")
    ok, table = check.judge(check.numbers(control, ref), cell.settings["check"])
    assert not ok, table
