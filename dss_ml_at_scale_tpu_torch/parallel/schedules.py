"""Learning-rate schedules of the port, as plain functions of the step.

Port of the one ``optax`` schedule the JAX CLI builds
(``optax.warmup_cosine_decay_schedule`` with ``init_value=0``, as
``config/commands.py::_resolve_lr_schedule`` calls it). A task drives it
through ``torch.optim.lr_scheduler.LambdaLR`` on an optimizer whose base
learning rate is 1, so update ``i`` (from 0) runs at exactly
``schedule(i)``: optax evaluates a schedule at the update count before it
increments, so the first update of a warmup runs at 0 and moves only
Adam's moments.
"""

from __future__ import annotations

import math
from typing import Callable


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int,
                                 decay_steps: int) -> Callable[[int], float]:
    """Linear warmup from 0 to ``peak_value`` over ``warmup_steps``, then
    cosine decay to 0 at ``decay_steps`` (which includes the warmup), and 0
    after. Raises ``ValueError`` where optax does: ``decay_steps`` not
    greater than ``warmup_steps``."""
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={cosine_steps} (decay {decay_steps} - warmup {warmup_steps})"
        )

    def schedule(step: int) -> float:
        if step < warmup_steps:  # optax.linear_schedule(0, peak, warmup)
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return -peak_value * frac + peak_value
        count = min(step - warmup_steps, cosine_steps)
        return peak_value * 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps))

    return schedule
