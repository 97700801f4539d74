"""Preallocated slot-based KV cache for continuous-batching decode.

Port of ``dss_ml_at_scale_tpu/serving/lm/kvcache.py``. A slot arena is a
fixed ``[slots, heads, max_len, head_dim]`` k/v slab per layer, allocated
once at boot on the model's device. Where JAX donates the arena through
every program so XLA aliases it, the port writes it in place: no per-token
cache copy, no per-request allocation.

``slot_decode``
    One token for EVERY slot at once. JAX vmaps the single-sequence decode
    over the slot axis; here the slot axis is the batch dimension and
    ``pos`` is one position per slot, so each slot writes and masks at its
    own position. Inactive slots decode garbage at position 0; the mask
    (``arange(max_len) <= pos``) never lets a slot read another slot's
    rows, and a freshly allocated slot is overwritten wholesale by
    ``write_slot`` before its first real step.

``prefill_bucket``
    The whole bucket-padded prompt through one causal pass (the flash
    kernel on the card) into a single-sequence scratch cache.

``write_slot``
    Copies the scratch cache into one arena slot, the whole slot.

Nothing clamps a position: the engine's capacity guards are what keep
every write inside the arena, as in JAX (whose slices clamp silently).
"""

from __future__ import annotations

import threading

import torch

from ...models.transformer import TransformerLM

Arena = tuple  # tuple per layer of {"k": [slots,h,max_len,d], "v": ...}


def make_arena(model: TransformerLM, slots: int, max_len: int) -> Arena:
    """Allocate the slot arena on the model's device: one k/v slab per
    layer. ``max_len`` may be smaller than ``model.max_seq``."""
    if max_len > model.max_seq:
        raise ValueError(
            f"arena max_len {max_len} > model max_seq {model.max_seq}"
        )
    head_dim = model.dim // model.num_heads
    shape = (slots, model.num_heads, max_len, head_dim)
    return tuple(
        {
            "k": torch.zeros(shape, dtype=model.dtype, device=model.device),
            "v": torch.zeros(shape, dtype=model.dtype, device=model.device),
        }
        for _ in range(model.num_layers)
    )


def slot_decode(model, tokens: torch.Tensor, arena: Arena, pos: torch.Tensor):
    """One decode step for every slot. ``tokens`` ``[slots]`` (each slot's
    last sampled token), ``pos`` ``[slots]`` (the position that token
    occupies). Returns ``(logits [slots, vocab], arena)``, the arena
    updated in place."""
    return model(tokens[:, None], cache=arena, pos=pos)


def prefill_bucket(model, tokens: torch.Tensor, cache: Arena):
    """Prefill one bucket-padded prompt (``[1, bucket]``) into a
    single-sequence cache. Returns ``(logits, cache)``: logits
    ``[1, bucket, vocab]`` (``[1, vocab]`` for a 1-token bucket).
    Positions past the real prompt hold padding k/v, never attended
    (causal mask) and overwritten by decode steps before the position
    pointer passes them."""
    return model(tokens, cache=cache, pos=0)


def write_slot(arena: Arena, rows: Arena, slot: int) -> Arena:
    """Copy a single-sequence cache (leaves ``[1, heads, len, head_dim]``)
    into arena ``slot``, in place."""
    for layer, src in zip(arena, rows):
        layer["k"][slot].copy_(src["k"][0])
        layer["v"][slot].copy_(src["v"][0])
    return arena


class SlotAllocator:
    """Host-side free-list over arena slots (lowest index first).

    Lowest-first keeps allocation deterministic: the same admission order
    always lands in the same slots.
    """

    _guarded_by_lock = ("_free", "_in_use")

    def __init__(self, slots: int):
        self._lock = threading.Lock()
        self._free = list(range(slots))
        self._in_use: set[int] = set()
        self.slots = slots

    def alloc(self) -> int | None:
        """Claim the lowest free slot, or None when the arena is full."""
        with self._lock:
            if not self._free:
                return None
            slot = min(self._free)
            self._free.remove(slot)
            self._in_use.add(slot)
            return slot

    def free(self, slot: int) -> None:
        with self._lock:
            if slot not in self._in_use:
                raise ValueError(f"slot {slot} is not allocated")
            self._in_use.remove(slot)
            self._free.append(slot)

    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def n_used(self) -> int:
        with self._lock:
            return len(self._in_use)
