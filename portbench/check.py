"""The comparison that decides ``correct``.

Once a training cell's window has closed, the window's own task is put
back to the state drawn from the seed and takes three steps through the
window's own call and feed, on three distinct batches; the run keeps what
the check compares (:class:`Readings`): each step's loss; each leaf's
norm of the first gradient, as the optimizer got it (Adam's first moment
after one step over ``1 - beta1``); each leaf's norm of the parameters'
change after the three steps and before the fourth; and the same change
of each buffer (BatchNorm's running statistics). With the port's state
freed, the reference follows the same three steps from the same weights
and batches in float32, and the numbers below hold the two apart:

- ``loss_gap``: the largest ``|L - L_ref| / |L_ref|`` over the steps;
- ``grad_gap``, ``change_gap``, ``stats_gap``: over the leaves, the
  largest gap between the port's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger. A leaf whose reference gradient is under a thousandth of the
  median leaf's (nought to rounding, as a key's bias under softmax) moves
  under Adam by round-off alone and is left out of ``change_gap``;
- ``grad_gap_median``: the median over the leaves of that same gap of the
  first gradient, steady from seed to seed; compared beside ``grad_gap``
  where the worst leaf is the rounding noise of a small leaf whose
  gradient is a sum that cancels (a BatchNorm shift or scale of the first
  stages, in bfloat16), which leaves ``grad_gap`` a wide limit.

Each number has its limit in the cell's file (``workloads/<cell>.json``,
``check``), set from the port's readings over a dozen seeds and the
control's (``PERF.md`` gives them).
"""

from __future__ import annotations

import dataclasses
import statistics

NUMBERS = ("loss_gap", "grad_gap", "grad_gap_median", "change_gap", "stats_gap")
ROUNDING_ONLY = 1e-3  # of the median leaf's reference gradient


@dataclasses.dataclass
class Readings:
    losses: list[float]
    grad: dict[str, float]
    change: dict[str, float]
    stats: dict[str, float]


def _gaps(got: dict[str, float], ref: dict[str, float], leaves) -> dict[str, float]:
    """Each leaf's gap between the two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    leaves = list(leaves)
    if set(got) != set(ref):
        missing = sorted(set(ref) ^ set(got))[:4]
        raise ValueError(f"the two sides have different leaves: {missing}")
    if not leaves:
        return {}
    floor = statistics.median(ref[n] for n in leaves)
    return {n: abs(got[n] - ref[n]) / max(ref[n], floor) if max(ref[n], floor) > 0
            else (0.0 if got[n] == 0 else float("inf")) for n in leaves}


def _worst(gaps: dict[str, float]) -> tuple[float, str]:
    if not gaps:
        return 0.0, ""
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def numbers(got: Readings, ref: Readings) -> dict[str, tuple[float, str]]:
    """``{number: (value, where)}``, where ``where`` names the step or leaf
    that set it."""
    if len(got.losses) != len(ref.losses):
        raise ValueError(f"{len(got.losses)} losses against {len(ref.losses)}")
    loss = [abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses)]
    step = max(range(len(loss)), key=loss.__getitem__)
    floor = statistics.median(ref.grad.values())
    moved = [n for n, g in ref.grad.items() if g >= ROUNDING_ONLY * floor]
    grad = _gaps(got.grad, ref.grad, ref.grad)
    out = {
        "loss_gap": (loss[step], f"step {step + 1}"),
        "grad_gap": _worst(grad),
        "grad_gap_median": (statistics.median(grad.values()), "median leaf"),
        "change_gap": _worst(_gaps(got.change, ref.change, moved)),
    }
    if ref.stats:
        out["stats_gap"] = _worst(_gaps(got.stats, ref.stats, ref.stats))
    return out


def judge(found: dict[str, tuple[float, str]], limits: dict[str, float]) -> tuple[bool, dict]:
    """``(correct, {number: {"value", "limit", "at"}})`` over the numbers
    the cell compares (its ``limits``): correct when each is finite and
    within its limit."""
    table, ok = {}, set(limits) <= set(found) and bool(limits)
    for name in sorted(limits):
        value, at = found.get(name, (float("nan"), "not read"))
        table[name] = {"value": value, "limit": limits[name], "at": at}
        ok = ok and value == value and value <= limits[name]
    return ok, table
