"""Retry with exponential backoff, full jitter, and a deadline.

Port of ``dss_ml_at_scale_tpu/resilience/retry.py``: the same policy, the
same delay draws (``RetryPolicy.delay`` under one ``random.Random`` gives
the JAX package's delays), the same ``retry_total{site=}`` counter, the
same classifier of the RPC layer's errors.

The transport classifier is the important half: a retry loop that
re-runs *semantic* failures (undecodable bytes, a schema mismatch) just
burns time repeating a deterministic outcome. :func:`is_transient`
answers "could this plausibly succeed on a second attempt?":
connection failures, timeouts, truncated streams and IO errors yes,
anything else no.

Full jitter (AWS architecture-blog style): each delay is uniform in
``[0, min(max_delay, base * 2**attempt)]``, so a burst of callers that
failed together doesn't re-converge into a synchronized retry storm.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable

from .. import telemetry

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape + budget for one retried operation."""

    max_retries: int = 3          # retries AFTER the first attempt
    base_delay: float = 0.05      # seconds; doubles per attempt
    max_delay: float = 2.0        # ceiling on any single delay
    deadline: float | None = None  # total seconds across all attempts

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        """Full-jitter delay for retry number ``attempt`` (0-based)."""
        cap = min(self.max_delay, self.base_delay * (2 ** attempt))
        return (rng or random).uniform(0.0, cap)


def is_transient(exc: BaseException) -> bool:
    """True when a failure is transport-shaped and worth retrying:
    connection failures (an injected fault among them), timeouts,
    truncated streams and other OS-level IO errors. Of the RPC layer's, a
    stalled handshake is (a wedged peer); a rejected secret and a remote
    handler's error are not (they do not fix themselves)."""
    from ..runtime.rpc import RpcAuthError, RpcHandshakeTimeout, RpcRemoteError

    if isinstance(exc, RpcHandshakeTimeout):
        return True
    if isinstance(exc, (RpcAuthError, RpcRemoteError)):
        return False
    return isinstance(exc, (ConnectionError, TimeoutError, EOFError, OSError))


def call_with_retry(
    fn: Callable,
    *args,
    policy: RetryPolicy,
    retryable: Callable[[BaseException], bool] = is_transient,
    site: str = "",
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    **kwargs,
):
    """Run ``fn(*args, **kwargs)``, retrying failures ``retryable`` allows.

    Each retry increments ``retry_total{site=}`` on the process registry.
    The deadline bounds total elapsed time: a retry whose backoff would
    land past it re-raises instead of sleeping into a guaranteed bust.
    """
    start = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            if attempt >= policy.max_retries or not retryable(e):
                raise
            delay = policy.delay(attempt)
            if (
                policy.deadline is not None
                and time.monotonic() - start + delay > policy.deadline
            ):
                raise
            telemetry.counter(
                "retry_total", "operations retried after a transient "
                "failure", labels=("site",),
            ).labels(site=site or "unnamed").inc()
            log.warning(
                "retry %d/%d at %s in %.3fs after %s: %s",
                attempt + 1, policy.max_retries, site or "unnamed", delay,
                type(e).__name__, e,
            )
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
            attempt += 1
