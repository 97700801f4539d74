"""Continuous-batching decode engine: token serving over slot arenas.

Port of ``dss_ml_at_scale_tpu/serving/lm/engine.py``. The engine (admission,
the decode loop, retirement, drain, the settle-once latch, the fail-closed
halt) is the JAX package's, line for line; only :class:`TransformerDecoder`
changes, from jitted programs to a torch model on its device.

An always-running decode loop: requests are admitted INTO an in-flight
batch. One engine thread alternates

    admit waiting requests into free slots
        (bucket-padded prefill through the flash kernel; a copy into the
         slot arena; first token = TTFT)
    one ``slot_decode`` step over ALL slots
        (every active request advances one token per step)
    per-slot retirement
        (EOS / max-token / deadline / cancel — the slot frees and the
         batch keeps running; nothing stops, no shape changes)

The HTTP layer talks to the engine through :meth:`LMEngine.submit`,
which returns a :class:`Generation` whose event queue streams tokens
to the response writer. Admission, deadline, and drain semantics are
the image tier's, reused verbatim: a full queue raises
:class:`~..admission.QueueFull` (429 + Retry-After), a draining engine
raises :class:`~..admission.NotAccepting` (503), and drain = stop
admitting, finish every in-flight slot.

Two decoder backends satisfy the same five-method protocol
(``prefill``/``step``/``warmup`` + ``slots``/``vocab_size``):
:class:`TransformerDecoder` runs the real model;
:class:`StubLMDecoder` is the bench/CI stand-in whose per-STEP cost is
independent of how many slots are active — exactly the property that
makes continuous batching win, minus the model weights.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time

import numpy as np
import torch

from ... import telemetry
from ..admission import AdmissionController, DeadlineExceeded, NotAccepting
from . import kvcache


class PromptTooLong(ValueError):
    """Request exceeds the preallocated KV capacity (HTTP 400).

    The capacity guard: an oversized budget must be
    REJECTED before a slot is touched — never allowed to scatter past
    the arena (the same cap ``models.transformer.generate`` now derives
    from its cache shape).
    """


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Engine knobs — ``dsst serve-lm`` flags map 1:1."""

    slots: int = 8
    max_len: int = 128
    prefill_buckets: tuple = (16, 32, 64)
    queue_depth: int = 32
    deadline_ms: float = 0.0  # admit -> last token; 0 disables
    inter_token_budget_ms: float = 0.0  # arms inter_token_p99 when > 0
    drain_timeout_s: float = 10.0

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        buckets = tuple(sorted(set(int(b) for b in self.prefill_buckets)))
        if not buckets:
            raise ValueError("at least one prefill bucket is required")
        if buckets[0] < 1 or buckets[-1] > self.max_len:
            raise ValueError(
                f"prefill buckets {buckets} must lie in [1, max_len="
                f"{self.max_len}]"
            )
        object.__setattr__(self, "prefill_buckets", buckets)


class Generation:
    """One streamed request: engine-side state + client-side queue.

    The engine thread owns the decode state (``n_past``, ``last_token``,
    ``emitted``); the HTTP thread only reads the event queue and may set
    ``cancelled`` (a latch, safe without the engine lock). Events are
    ``("token", token, index)`` then exactly one terminal
    ``("done", reason)`` or ``("error", exc)`` — :meth:`settle_once` is
    the latch that keeps the terminal exactly-once even when engine
    retirement and drain's leftovers sweep race to settle the same
    generation.
    """

    _guarded_by_lock = ("_settled",)
    _lock_name = "_lock"

    def __init__(self, gen_id, prompt, max_new_tokens, *, temperature,
                 top_k, eos_id, seed, trace_id, deadline):
        self.gen_id = gen_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.trace_id = trace_id
        self.deadline = deadline  # monotonic, or None
        self.queue: queue.Queue = queue.Queue()
        self.cancelled = False
        self.reason: str | None = None
        self._lock = threading.Lock()
        self._settled = False
        self.t_admit = time.monotonic()
        self.t_first: float | None = None
        self.t_last: float | None = None
        # Engine-thread-only decode state.
        self.n_past = 0
        self.last_token = 0
        self.emitted = 0
        self._rng = np.random.default_rng(seed)

    def sample(self, logits_row: np.ndarray) -> int:
        if self.temperature <= 0.0:
            return int(np.argmax(logits_row))
        scaled = logits_row.astype(np.float64) / self.temperature
        if self.top_k is not None:
            kth = np.sort(scaled)[-self.top_k]
            scaled = np.where(scaled < kth, -np.inf, scaled)
        scaled -= scaled.max()
        p = np.exp(scaled)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    def settle_once(self) -> bool:
        """Claim the right to emit THE terminal event (first caller
        wins). Engine retirement and drain's leftovers sweep can race
        to settle the same generation; exactly one of them may emit the
        terminal and release the admission ticket."""
        with self._lock:
            if self._settled:
                return False
            self._settled = True
            return True

    def is_settled(self) -> bool:
        with self._lock:
            return self._settled

    def next_event(self, timeout: float | None = None):
        """Block for the next stream event (raises ``queue.Empty``)."""
        return self.queue.get(timeout=timeout)

    def cancel(self) -> None:
        """Client went away: retire the slot at the next step."""
        self.cancelled = True


class TransformerDecoder:
    """The real backend: a TransformerLM over a slot arena on its device.

    One batched ``slot_decode`` per step over every slot (the arena is
    written in place), one ``prefill_bucket`` per admission at its bucket
    length (flash attention on the card), and a ``write_slot`` copy into
    the admitted slot. ``warmup()`` runs every bucket and one step before
    the server reports ready, which also builds the flash kernel.
    """

    def __init__(self, model, *, slots, max_len, buckets):
        self.model = model
        self.device = model.device
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.buckets = tuple(buckets)
        self.vocab_size = model.vocab_size
        self._arena = kvcache.make_arena(model, self.slots, self.max_len)
        # ONE prefill scratch cache, reused: stale rows past the real
        # prompt are never attended and are overwritten before the
        # position pointer reaches them, so no re-zeroing is needed.
        self._scratch = kvcache.make_arena(model, 1, self.max_len)

    def warmup(self) -> None:
        """Run every production shape once before serving traffic."""
        for bucket in self.buckets:
            self.prefill(np.zeros((1, bucket), np.int32), 1, 0)
        self.step(
            np.zeros(self.slots, np.int32), np.zeros(self.slots, np.int32)
        )

    @torch.inference_mode()
    def prefill(self, tokens: np.ndarray, n_real: int, slot: int):
        """Prefill one bucket-padded prompt and copy it into ``slot``.

        Returns the logits row of the last REAL prompt position (host
        numpy) — what the first sampled token comes from.
        """
        logits, cache = kvcache.prefill_bucket(
            self.model,
            torch.as_tensor(tokens, dtype=torch.long, device=self.device),
            self._scratch,
        )
        kvcache.write_slot(self._arena, cache, slot)
        row = logits[0] if logits.ndim == 2 else logits[0, n_real - 1]
        return row.float().cpu().numpy()

    @torch.inference_mode()
    def step(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One ``slot_decode`` over every slot; returns [slots, vocab]."""
        logits, _ = kvcache.slot_decode(
            self.model,
            torch.as_tensor(tokens, dtype=torch.long, device=self.device),
            self._arena,
            torch.as_tensor(pos, dtype=torch.long, device=self.device),
        )
        return logits.float().cpu().numpy()


class StubLMDecoder:
    """Model-free backend for bench/CI: fixed per-STEP cost.

    The next token is a pure function of (last token, position), so
    streams are deterministic; ``step()`` sleeps ``step_ms`` ONCE no
    matter how many slots are active — the continuous-batching speedup
    the ``lm_serving`` bench gates is therefore structural, not noise.
    Logits are one-hot so greedy sampling recovers the function exactly.
    """

    def __init__(self, *, vocab_size=256, step_ms=2.0, prefill_ms=None,
                 slots=8, max_len=128, buckets=(16,)):
        self.vocab_size = int(vocab_size)
        self.step_ms = float(step_ms)
        self.prefill_ms = float(
            step_ms if prefill_ms is None else prefill_ms
        )
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.buckets = tuple(buckets)

    def _next(self, tok: int, pos: int) -> int:
        return (int(tok) * 1103515245 + int(pos) * 12345 + 7) % self.vocab_size

    def warmup(self) -> None:
        pass

    def prefill(self, tokens: np.ndarray, n_real: int, slot: int):
        time.sleep(self.prefill_ms / 1000.0)
        row = np.zeros(self.vocab_size, np.float32)
        row[self._next(tokens[0, n_real - 1], n_real - 1)] = 1.0
        return row

    def step(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        time.sleep(self.step_ms / 1000.0)
        out = np.zeros((self.slots, self.vocab_size), np.float32)
        for i in range(self.slots):
            out[i, self._next(tokens[i], pos[i])] = 1.0
        return out


class LMEngine:
    """The always-running decode loop + admission front door."""

    # Lock contract: HTTP threads submit and drain; the engine
    # thread admits, steps, and retires — the shared scheduling state
    # below only moves under _cond.
    _guarded_by_lock = ("_waiting", "_active", "_admitting", "_accepting",
                        "_stopped")
    _lock_name = "_cond"

    def __init__(self, decoder, config: LMConfig | None = None):
        self.cfg = config or LMConfig()
        self.decoder = decoder
        if getattr(decoder, "max_len", self.cfg.max_len) < self.cfg.max_len:
            raise ValueError(
                f"decoder max_len {decoder.max_len} < config max_len "
                f"{self.cfg.max_len}"
            )
        if decoder.slots < self.cfg.slots:
            raise ValueError(
                f"decoder has {decoder.slots} slots, config wants "
                f"{self.cfg.slots}"
            )
        self._alloc = kvcache.SlotAllocator(self.cfg.slots)
        self._cond = threading.Condition()
        self._waiting: list[Generation] = []
        self._active: dict[int, Generation] = {}
        # Generations pulled off _waiting but not yet in _active (their
        # prefill is running): drain must see this in-transit window or
        # it can declare the engine empty mid-admission and truncate a
        # stream it promised to finish — and its leftovers sweep must
        # settle them if the engine thread wedges, so the actual
        # Generations are tracked, not just a count.
        self._admitting: list[Generation] = []
        self._accepting = True
        self._stopped = False
        self._gen_seq = 0
        self._thread: threading.Thread | None = None
        self._slo = telemetry.slo.get_engine()
        self._admission = AdmissionController(
            self.cfg.queue_depth,
            on_depth=lambda n: self._depth_gauge.set(n),
        )
        self._depth_gauge = telemetry.gauge(
            "lm_queue_depth", "LM generations admitted and not yet retired"
        )
        self._tokens_total = telemetry.counter(
            "lm_tokens_total", "tokens streamed by the LM engine"
        )
        self._slots_gauge = telemetry.gauge(
            "lm_slots_active", "KV arena slots currently decoding"
        )
        self._retired = telemetry.counter(
            "lm_retired_total",
            "generations retired, by reason",
            labels=("reason",),
        )
        self._prefill_hist = telemetry.histogram(
            "lm_prefill_seconds", "bucketed prefill latency (per admission)"
        )
        self._step_hist = telemetry.histogram(
            "lm_decode_step_seconds", "slot_decode latency (per step)"
        )
        self._ttft_window = telemetry.window(
            "lm_ttft_window_seconds",
            "live windowed time-to-first-token (admit -> first chunk)",
        )
        self._inter_window = telemetry.window(
            "lm_inter_token_window_seconds",
            "live windowed gap between streamed tokens",
        )

    # -- front door (HTTP threads) ------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, temperature=0.0,
               top_k=None, eos_id=None, seed=0, trace_id=None) -> Generation:
        """Admit one generation (or raise the HTTP-mapped refusal).

        Raises :class:`PromptTooLong` (400) when the request cannot fit
        the preallocated capacity, ``ValueError`` (400) for sampling
        params the engine thread could not survive (non-finite
        temperature, out-of-range top_k — json accepts NaN, so the door
        must not), ``QueueFull`` (429) at the admission bound,
        ``NotAccepting`` (503) while draining.
        """
        prompt = [int(t) for t in prompt]
        n_new = int(max_new_tokens)
        if not prompt:
            raise ValueError("prompt must contain at least one token")
        if n_new < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        vocab = self.decoder.vocab_size
        if any(t < 0 or t >= vocab for t in prompt):
            raise ValueError(f"prompt tokens must lie in [0, {vocab})")
        # Sampling-state validation: everything Generation.sample and
        # default_rng consume is checked HERE, before the admission
        # ticket — a bad value past this point would blow up inside the
        # shared engine thread (or leak a ticket), not in this request.
        temperature = float(temperature)
        if not math.isfinite(temperature):
            raise ValueError(f"temperature must be finite, got {temperature}")
        if top_k is not None:
            top_k = int(top_k)
            if not 1 <= top_k <= vocab:
                raise ValueError(
                    f"top_k must lie in [1, vocab_size={vocab}], "
                    f"got {top_k}"
                )
        seed = int(seed)
        if seed < 0:
            raise ValueError(f"seed must be >= 0, got {seed}")
        buckets = self.cfg.prefill_buckets
        if len(prompt) > buckets[-1]:
            raise PromptTooLong(
                f"prompt length {len(prompt)} exceeds the largest prefill "
                f"bucket {buckets[-1]}"
            )
        if len(prompt) + n_new > self.cfg.max_len:
            raise PromptTooLong(
                f"prompt + max_new_tokens = {len(prompt) + n_new} > "
                f"max_len {self.cfg.max_len} (preallocated KV slot capacity)"
            )
        deadline = None
        if self.cfg.deadline_ms > 0:
            deadline = time.monotonic() + self.cfg.deadline_ms / 1000.0
        with self._cond:
            if not self._accepting:
                raise NotAccepting("LM engine is draining")
            self._admission.admit(1)
            self._gen_seq += 1
            gen = Generation(
                self._gen_seq, prompt, n_new, temperature=temperature,
                top_k=top_k, eos_id=eos_id, seed=seed, trace_id=trace_id,
                deadline=deadline,
            )
            self._waiting.append(gen)
            self._cond.notify_all()
        return gen

    @property
    def pending(self) -> int:
        """Generations admitted and not yet retired (for drain prints)."""
        return self._admission.pending

    def start(self) -> "LMEngine":
        """Arm SLO targets, warm the decoder, start the decode thread."""
        if self.cfg.deadline_ms > 0:
            # TTFT must beat the full-request deadline; arming turns the
            # informational quantile objective into a judged one.
            self._slo.set_target("ttft_p99", self.cfg.deadline_ms / 1000.0)
        if self.cfg.inter_token_budget_ms > 0:
            self._slo.set_target(
                "inter_token_p99", self.cfg.inter_token_budget_ms / 1000.0
            )
        self.decoder.warmup()
        self._thread = threading.Thread(
            target=self._loop, name="lm-decode", daemon=True
        )
        self._thread.start()
        return self

    def drain(self, timeout_s: float | None = None) -> bool:
        """Stop admitting, finish in-flight slots, stop the loop.

        Returns True when everything retired within the budget; on
        timeout the loop is stopped anyway and survivors are settled
        with a ``("done", "drain")`` event so no client hangs forever.
        """
        budget = self.cfg.drain_timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + max(0.0, budget)
        with self._cond:
            self._accepting = False
            self._cond.notify_all()
            while (
                (self._waiting or self._active or self._admitting)
                and not self._stopped
            ):
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(min(left, 0.1))
            clean = (
                not self._waiting and not self._active
                and not self._admitting
            )
            self._stopped = True
            self._cond.notify_all()
        thread = self._thread
        alive = False
        if thread is not None:
            thread.join(5.0)
            alive = thread.is_alive()
        # Settle anything the budget abandoned — including generations
        # caught in the in-transit admission window (neither waiting
        # nor active while their prefill runs). The join may have timed
        # out with the thread wedged inside a slow decoder call; the
        # settle-once latch makes this sweep safe to race against a
        # thread that later comes back and retires the same slots.
        with self._cond:
            leftovers = (
                list(self._waiting) + list(self._active.values())
                + list(self._admitting)
            )
            self._waiting.clear()
            self._active.clear()
            self._admitting.clear()
        for gen in leftovers:
            self._settle(gen, "drain")
        return clean and not alive

    # -- engine thread ------------------------------------------------

    def _loop(self) -> None:
        try:
            self._run()
        except Exception as exc:
            # Nothing may escape the engine thread: an unguarded raise
            # here used to kill the loop silently — every in-flight
            # stream stalled and every later request hung until its
            # event timeout. Fail CLOSED instead: refuse new work (503)
            # and settle every owned generation with an error event.
            self._halt(exc)

    def _halt(self, exc: Exception) -> None:
        with self._cond:
            self._accepting = False
            self._stopped = True
            leftovers = (
                list(self._waiting) + list(self._active.values())
                + list(self._admitting)
            )
            self._waiting.clear()
            self._active.clear()
            self._admitting.clear()
            self._cond.notify_all()
        for gen in leftovers:
            self._settle(gen, "error", error=exc)

    def _run(self) -> None:
        while True:
            admitted, expired, cancelled = [], [], []
            with self._cond:
                while (
                    not self._stopped
                    and not self._waiting
                    and not self._active
                ):
                    self._cond.wait(0.05)
                if self._stopped:
                    return
                now = time.monotonic()
                still_waiting = []
                for gen in self._waiting:
                    if gen.cancelled:
                        cancelled.append(gen)
                        continue
                    if gen.deadline is not None and now > gen.deadline:
                        expired.append(gen)
                        continue
                    slot = self._alloc.alloc()
                    if slot is None:
                        still_waiting.append(gen)
                    else:
                        admitted.append((gen, slot))
                self._waiting[:] = still_waiting
                self._admitting.extend(gen for gen, _ in admitted)
            for gen in cancelled:
                self._settle(gen, "cancelled")
            for gen in expired:
                self._settle(
                    gen, "deadline",
                    error=DeadlineExceeded(
                        "deadline passed before a slot freed"
                    ),
                )
            for gen, slot in admitted:
                try:
                    self._admit_into_slot(gen, slot)
                except Exception as exc:
                    # A poisoned generation (sampling state the door's
                    # validation could not foresee) retires ITSELF, not
                    # the shared loop: free its slot, settle it with an
                    # error event, keep serving everyone else.
                    with self._cond:
                        self._active.pop(slot, None)
                        self._slots_gauge.set(len(self._active))
                    if not gen.is_settled():
                        self._alloc.free(slot)
                        self._settle(gen, "error", error=exc)
            if admitted:
                with self._cond:
                    for gen, _ in admitted:
                        if gen in self._admitting:
                            self._admitting.remove(gen)
                    self._cond.notify_all()
            self._step_once()

    def _admit_into_slot(self, gen: Generation, slot: int) -> None:
        """Bucketed prefill + scatter + first token (TTFT)."""
        prompt = gen.prompt
        bucket = next(
            b for b in self.cfg.prefill_buckets if b >= len(prompt)
        )
        padded = np.zeros((1, bucket), np.int32)
        padded[0, : len(prompt)] = prompt
        t0 = time.perf_counter()
        with telemetry.span("lm.prefill", bucket=bucket,
                            prompt_tokens=len(prompt)):
            row = self.decoder.prefill(padded, len(prompt), slot)
        self._prefill_hist.observe(time.perf_counter() - t0)
        gen.n_past = len(prompt)
        token = gen.sample(row)
        now = time.monotonic()
        ttft = now - gen.t_admit
        gen.t_first = gen.t_last = now
        self._emit(gen, token)
        self._ttft_window.observe(ttft, gen.trace_id)
        self._slo.note_ttft(ttft, trace_id=gen.trace_id)
        if self._should_retire(gen, token):
            self._retire_slot(slot, gen)
            return
        with self._cond:
            self._active[slot] = gen
            self._slots_gauge.set(len(self._active))

    def _step_once(self) -> None:
        with self._cond:
            active = dict(self._active)
        if not active:
            return
        # Sized to the DECODER's arena, not cfg.slots: both backends
        # iterate or batch over decoder.slots, and the constructor allows a
        # decoder with more slots than the config admits.
        tokens = np.zeros(self.decoder.slots, np.int32)
        pos = np.zeros(self.decoder.slots, np.int32)
        for slot, gen in active.items():
            tokens[slot] = gen.last_token
            pos[slot] = gen.n_past
        t0 = time.perf_counter()
        with telemetry.span("lm.step", active=len(active)):
            logits = self.decoder.step(tokens, pos)
        self._step_hist.observe(time.perf_counter() - t0)
        now = time.monotonic()
        for slot in sorted(active):
            gen = active[slot]
            gen.n_past += 1
            if gen.cancelled:
                self._retire_slot(slot, gen, reason="cancelled")
                continue
            if gen.deadline is not None and now > gen.deadline:
                self._retire_slot(slot, gen, reason="deadline")
                continue
            try:
                token = gen.sample(logits[slot])
            except Exception as exc:
                # Per-generation blast radius: a sample() failure
                # retires this slot with an error event; the step loop
                # and every other stream keep running.
                self._retire_slot(slot, gen, reason="error", error=exc)
                continue
            gap = now - (gen.t_last if gen.t_last is not None else now)
            gen.t_last = now
            self._emit(gen, token)
            self._inter_window.observe(gap, gen.trace_id)
            self._slo.note_inter_token(gap, trace_id=gen.trace_id)
            if self._should_retire(gen, token):
                self._retire_slot(slot, gen)

    def _emit(self, gen: Generation, token: int) -> None:
        gen.last_token = token
        if gen.is_settled():
            # Drain's sweep already emitted the terminal event while
            # this thread was wedged: no tokens after a terminal.
            return
        gen.queue.put(("token", token, gen.emitted))
        gen.emitted += 1
        self._tokens_total.inc()

    def _should_retire(self, gen: Generation, token: int) -> bool:
        if gen.eos_id is not None and token == gen.eos_id:
            gen.reason = "eos"
            return True
        if gen.emitted >= gen.max_new_tokens:
            gen.reason = "max_tokens"
            return True
        return False

    def _retire_slot(self, slot: int, gen: Generation,
                     reason: str | None = None,
                     error: Exception | None = None) -> None:
        with self._cond:
            self._active.pop(slot, None)
            self._slots_gauge.set(len(self._active))
            self._cond.notify_all()
        self._alloc.free(slot)
        wall = time.monotonic() - gen.t_admit
        # Seconds-per-generation normalized by slot count: the cost one
        # admission adds to the shared step loop, feeding Retry-After.
        self._admission.note_service_rate(wall / max(1, self.cfg.slots))
        self._settle(gen, reason or gen.reason or "done", error=error)

    def _settle(self, gen: Generation, reason: str,
                error: Exception | None = None) -> None:
        """Terminal event + admission release, exactly once.

        Engine retirement, the drain sweep, and the halt path can race
        to settle the same generation; the per-generation latch makes
        every settlement after the first a no-op, so a client sees ONE
        terminal and the pending count can never go negative.
        """
        if not gen.settle_once():
            return
        if gen.reason is None:
            gen.reason = reason
        if error is not None:
            gen.queue.put(("error", error))
        else:
            gen.queue.put(("done", gen.reason))
        self._retired.labels(reason=gen.reason).inc()
        self._admission.release(1)
