"""Deterministic fault injection at named sites.

Port of ``dss_ml_at_scale_tpu/resilience/faults.py``: the same plan
grammar, the same seeded per-site draws (a stream per site keyed by
``seed ^ crc32(site)``, so the same spec and seed fire on the same hits
as the JAX package's plan), the same dotted-prefix matching. Production
code marks its failure-prone seams with :func:`maybe_fail`; a seeded
:class:`FaultPlan` (installed programmatically, via the ``DSST_FAULT_PLAN``
env var, or the CLI's global ``--fault-plan`` flag) arms chosen sites with
exact trigger counts or seeded per-hit probabilities. Disarmed (the
production default) a site check is one global read and a ``None``
comparison.

Plan spec grammar (semicolon-separated entries)::

    checkpoint.save=2            # fail the first 2 hits of this site
    grads.nonfinite=1@5          # skip the first 5 hits, fail the next 1
    reader.next=p0.25            # fail each hit with probability 0.25
    checkpoint.restore=1;seed=7  # seed the probability draws
    fs.crash_after_tmp=k1        # SIGKILL the process at the 1st hit

Site names are dotted paths; a spec entry matches a checked site when it
is equal to it or a dotted prefix of it (``fs.fsync`` arms
``fs.fsync.manifest`` and ``fs.fsync.journal``; the most specific entry
wins). Injected failures raise :class:`InjectedFault`, a
``ConnectionError`` subclass, so the retry classifier treats it as a
transport failure. Sites that corrupt *values* instead of raising (a NaN
gradient is not an exception) poll :func:`fault_fires`, which consumes a
hit and returns a bool; the call site applies its own corruption.

:data:`KNOWN_SITES` lists the sites the port calls, and no other: the
JAX package's ``rpc.send`` belongs to its RPC layer, which the port does
not have yet; ``trial.evaluate`` is the HPO layer's objective site
(:func:`..hpo.fmin.call_with_protocol`). ``tests/test_torch_faults.py``
holds the registry and the call sites to each other.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import threading
import zlib

log = logging.getLogger(__name__)

# The fault-injection surface: site name -> what arming it simulates.
# The CLI renders the keys into the --fault-plan help text.
KNOWN_SITES = {
    "trial.evaluate": "an HPO objective raising mid-trial (permanent, "
                      "never transport-retried)",
    "checkpoint.save": "a checkpoint write failing before commit",
    "checkpoint.restore": "a checkpoint restore raising (damage the "
                          "manifest cannot see)",
    "reader.next": "a transient IO failure loading a Parquet row group",
    "sample.corrupt": "undecodable sample bytes inside a row group "
                      "(truncated image, bad row)",
    "grads.nonfinite": "a NaN/Inf gradient step (poisons the train "
                       "step's loss/grad-norm health signals)",
    "loss.spike": "a loss spike far outside the EWMA band on one "
                  "train step",
    "fs.torn_write": "a power cut mid-write: the durable writer leaves "
                     "a truncated .tmp and fails before publish (suffix "
                     ".<kind>: manifest, checkpoint, run_json, journal, "
                     "quarantine, bundle)",
    "fs.crash_after_tmp": "a crash between the staged .tmp write and "
                          "its atomic rename: a complete .tmp is left, "
                          "nothing published (suffix .<kind> as "
                          "fs.torn_write; arm kN to SIGKILL in-window)",
    "fs.fsync": "an fsync raising (EIO-like) during a durable publish "
                "(suffix .<kind> as fs.torn_write)",
}


class InjectedFault(ConnectionError):
    """A failure injected by the active :class:`FaultPlan`."""


@dataclasses.dataclass
class _Site:
    """Arming state for one plan entry."""

    count: int | None = None      # exact-count mode: fail the next N hits
    probability: float = 0.0      # probability mode: seeded per-hit draw
    skip: int = 0                 # N@K mode: hits to pass before firing
    kill: bool = False            # kN mode: SIGKILL the process on fire
    hits: int = 0                 # matching check()/fires() calls observed
    fired: int = 0                # faults actually raised


class FaultPlan:
    """A seeded, thread-safe set of armed fault sites."""

    def __init__(self, sites: dict[str, _Site] | None = None, seed: int = 0):
        self._lock = threading.Lock()
        self._sites = dict(sites or {})
        self.seed = seed
        self._rngs: dict[str, random.Random] = {}

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse ``"site=N;site=pX;seed=S"`` into a plan.

        Raises ``ValueError`` on malformed entries: a mistyped plan must
        fail the run loudly, not silently inject nothing.
        """
        sites: dict[str, _Site] = {}
        seed = 0
        for raw in spec.split(";"):
            entry = raw.strip()
            if not entry:
                continue
            name, sep, value = entry.partition("=")
            name, value = name.strip(), value.strip()
            if not sep or not name or not value:
                raise ValueError(f"fault plan entry {entry!r} is not site=value")
            if name == "seed":
                seed = int(value)
            elif value.startswith("p"):
                p = float(value[1:])
                if not 0.0 <= p <= 1.0:
                    raise ValueError(
                        f"fault probability must be in [0, 1], got {entry!r}"
                    )
                sites[name] = _Site(probability=p)
            else:
                kill = value.startswith("k")
                count_s, at, skip_s = value[1 if kill else 0:].partition("@")
                n = int(count_s)
                skip = int(skip_s) if at else 0
                if n < 0 or skip < 0:
                    raise ValueError(
                        f"fault count/offset must be >= 0, got {entry!r}"
                    )
                sites[name] = _Site(count=n, skip=skip, kill=kill)
        plan = cls(sites, seed=seed)
        return plan

    def _match(self, site: str) -> tuple[str, _Site] | None:
        """Most-specific armed entry equal to or a dotted prefix of ``site``."""
        probe = site
        while probe:
            armed = self._sites.get(probe)
            if armed is not None:
                return probe, armed
            probe, _, _ = probe.rpartition(".")
        return None

    def _consume(self, site: str) -> tuple[bool, bool]:
        """Advance the matching entry's state for one hit.

        Returns ``(fire, kill)``: ``fire`` when the plan arms this hit,
        ``kill`` when the armed entry is a ``kN`` power-cut entry (the
        caller delivers SIGKILL to the process instead of raising).
        """
        with self._lock:
            hit = self._match(site)
            if hit is None:
                return False, False
            name, armed = hit
            armed.hits += 1
            fire = False
            if armed.count is not None:
                if armed.skip > 0:
                    armed.skip -= 1
                elif armed.count > 0:
                    armed.count -= 1
                    fire = True
            elif armed.probability > 0.0:
                rng = self._rngs.get(name)
                if rng is None:
                    # Stable per-site stream: independent of dict order,
                    # check order across sites, and PYTHONHASHSEED.
                    rng = self._rngs[name] = random.Random(
                        self.seed ^ zlib.crc32(name.encode())
                    )
                fire = rng.random() < armed.probability
            if fire:
                armed.fired += 1
        if fire:
            # Local import: the CLI imports this module for KNOWN_SITES
            # while building its parser.
            from .. import telemetry

            telemetry.counter(
                "faults_injected_total", "faults raised by the active "
                "FaultPlan", labels=("site",),
            ).labels(site=name).inc()
        return fire, armed.kill

    def check(self, site: str) -> None:
        """Raise :class:`InjectedFault` if the plan arms this hit."""
        fire, kill = self._consume(site)
        if fire:
            if kill:
                _sigkill_self(site)
            log.warning("fault plan: injecting fault at site %r", site)
            raise InjectedFault(f"injected fault at site {site!r}")

    def fires(self, site: str) -> bool:
        """Consume one hit; True when the call site should self-corrupt.

        The non-raising twin of :meth:`check` for sites where the
        failure mode is a *bad value*, not an exception (non-finite
        gradients, corrupt sample bytes): the caller applies its own
        corruption when this returns True.
        """
        fire, kill = self._consume(site)
        if fire:
            if kill:
                _sigkill_self(site)
            log.warning("fault plan: arming value fault at site %r", site)
            return True
        return False

    def stats(self) -> dict[str, dict[str, int]]:
        """Per-entry ``{"hits": n, "fired": n}``."""
        with self._lock:
            return {
                name: {"hits": s.hits, "fired": s.fired}
                for name, s in self._sites.items()
            }


def _sigkill_self(site: str) -> None:
    """The power-cut: SIGKILL the current process at the armed site.

    Flushes nothing on purpose — a real power cut doesn't either. The
    log line goes to stderr (unbuffered enough in practice to usually
    survive), then the uncatchable kill lands; no Python cleanup, no
    atexit, no finally blocks run.
    """
    import signal

    log.warning("fault plan: SIGKILL (power cut) at site %r", site)
    os.kill(os.getpid(), signal.SIGKILL)


# -- process-global plan -----------------------------------------------------

_plan: FaultPlan | None = None


def install(plan: FaultPlan | None) -> FaultPlan | None:
    """Install ``plan`` as the process fault plan (None disarms)."""
    global _plan
    _plan = plan
    return plan


def install_from_spec(spec: str | None) -> FaultPlan | None:
    """Parse and install a plan spec; None/empty disarms. Returns the plan."""
    return install(FaultPlan.parse(spec) if spec else None)


def clear() -> None:
    install(None)


def active_plan() -> FaultPlan | None:
    return _plan


def maybe_fail(site: str) -> None:
    """The site marker production code calls; no-op unless a plan is armed."""
    if _plan is not None:
        _plan.check(site)


def fault_fires(site: str) -> bool:
    """Value-corruption site marker: False (no-op) unless a plan arms it."""
    return _plan is not None and _plan.fires(site)
