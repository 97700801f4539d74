"""Process topology, read from the process group.

Port of ``dss_ml_at_scale_tpu/runtime/topology.py``. In the port one
process drives one card, so the global device count is the world size and
each process has one local device.
"""

from __future__ import annotations

import dataclasses

from .distributed import process_count, process_index


@dataclasses.dataclass(frozen=True)
class Topology:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0

    def steps_per_epoch(self, total_rows: int, per_process_batch: int) -> int:
        """Epoch accounting: ``rows // (batch x world)``, at least one (the
        reference's ``train_rows // (BATCH_SIZE * WORLD_SIZE)``)."""
        return max(1, total_rows // (per_process_batch * self.process_count))


def local_topology() -> Topology:
    world = process_count()
    return Topology(process_index=process_index(), process_count=world,
                    local_device_count=1, global_device_count=world)
