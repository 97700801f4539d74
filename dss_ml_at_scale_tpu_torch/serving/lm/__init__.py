"""Token-level LM serving: slot KV arenas + continuous batching.

Port of ``dss_ml_at_scale_tpu/serving/lm``: the subsystem between
``POST /generate`` (chunked token streaming in :mod:`...workloads.serving`)
and the model (:mod:`.kvcache`, :mod:`.engine`).
"""

from __future__ import annotations

from .engine import (
    Generation,
    LMConfig,
    LMEngine,
    PromptTooLong,
    StubLMDecoder,
    TransformerDecoder,
)
from .kvcache import (
    SlotAllocator,
    make_arena,
    prefill_bucket,
    slot_decode,
    write_slot,
)

__all__ = [
    "Generation",
    "LMConfig",
    "LMEngine",
    "PromptTooLong",
    "SlotAllocator",
    "StubLMDecoder",
    "TransformerDecoder",
    "make_arena",
    "prefill_bucket",
    "slot_decode",
    "write_slot",
]
