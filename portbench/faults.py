"""Faults planted in the timed path, for the tests that show the check
fails them and for the readings of ``portbench.calibrate``. Each takes the
port's ``ClassifierTask`` and breaks its training step underneath the
window's own call:

- ``state_unchanged``: the step runs and then puts back the model's and
  the optimizer's state as they were, so it returns its state unchanged;
- ``half_batch``: the step sees the first half of each batch only, the
  mean taken over it;
- ``grad_dropped``: the gradient of the largest leaf is lost (zeroed)
  where the backward produced it, before the update: an answer altered
  where it is produced. (A gradient scaled by a constant would leave
  Adam's update as it is; only the first gradient's own reading sees it.)

The exchange between chips has no fault here: every cell runs on one chip.
"""

from __future__ import annotations

FAULTS = ("state_unchanged", "half_batch", "grad_dropped")


def plant(task, fault: str) -> None:
    if fault == "state_unchanged":
        step = task.train_step

        def unchanged(batch):
            model = {k: v.detach().clone() for k, v in task.model.state_dict().items()}
            opt = task.optimizer.state_dict()
            opt = {"state": {k: {n: t.clone() if hasattr(t, "clone") else t for n, t in s.items()}
                             for k, s in opt["state"].items()},
                   "param_groups": opt["param_groups"]}
            out = step(batch)
            task.model.load_state_dict(model)
            task.optimizer.state.clear()
            if opt["state"]:
                task.optimizer.load_state_dict(opt)
            return out

        task.train_step = unchanged
    elif fault == "half_batch":
        step = task.train_step

        def half(batch):
            return step({k: v[: len(v) // 2] for k, v in batch.items()})

        task.train_step = half
    elif fault == "grad_dropped":
        commit = task.commit_update
        largest = max(task.model.parameters(), key=lambda p: p.numel())

        def dropped():
            if largest.grad is not None:
                largest.grad.zero_()
            commit()

        task.commit_update = dropped
    else:
        raise ValueError(f"fault {fault!r} is not one of {FAULTS}")
