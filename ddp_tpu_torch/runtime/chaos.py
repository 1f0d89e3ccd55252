"""Deterministic fault injection: drills for the fault-tolerance layer
(a copy of ``ddp_tpu/runtime/chaos.py``, pure host code; the port keeps
its own so that it imports nothing of the JAX package).

A seeded, deterministic schedule of process kills, SIGTERMs, checkpoint
corruption and input stalls that fire at exact points of a run, from
the CLI (``--chaos``) and from tests. Every event fires once across
restarts: a per-rank ledger next to the checkpoints records what fired,
so a relaunched run replays the same steps without replaying the faults.

The replica, reload and stage events below name the JAX package's fleet
router, hot-swap loop and MPMD supervisor (its ``serve/fleet.py``,
``serve/lifecycle.py``, ``parallel/mpmd.py``), which the port has not
ported yet: they parse and round-trip, and never fire inside a trainer.

Spec grammar (comma-separated events)::

    kill:rank<R>@step<N>          SIGKILL rank R before global step N
    kill:rank<R>@epoch<N>         ... at the top of epoch N
    sigterm:rank<R>@step<N>       graceful-preemption signal instead
    sigterm:rank<R>@epoch<N>
    shrink:rank<R>@step<N>        rank R is PERMANENTLY lost (exits
    shrink:rank<R>@epoch<N>       with launch.SHRINK_EXIT_CODE): an
                                  elastic supervisor relaunches the
                                  world one worker smaller — the
                                  scale-down drill
    grow:+1@step<N>               a lost host is restored (rank 0
    grow:+1@epoch<N>              exits launch.GROW_EXIT_CODE): the
                                  elastic supervisor relaunches one
                                  worker larger — the scale-up drill
    stall:input@step<N>:<S>s      sleep S seconds before step N's
                                  dispatch, on every rank (an input-
                                  pipeline stall the straggler sentry
                                  should see)
    ckpt_corrupt:latest           at process start (rank 0, before
                                  restore): truncate the largest file
                                  of the latest checkpoint on disk —
                                  the torn-write drill for the
                                  manifest/quarantine fallback path
    kill:replica<R>@request<N>    FLEET drills (serve/fleet.py): when
    stall:replica<R>@request<N>:<S>s
                                  the fleet router dispatches its Nth
                                  request, the replica MANAGER SIGKILLs
                                  replica R (the mid-traffic death the
                                  router must replay around) or
                                  SIGSTOPs it for S seconds (the
                                  straggling replica hedging should
                                  beat; SIGCONT restores it). Replica
                                  events never fire inside a trainer —
                                  ``ChaosEngine`` skips them; the
                                  fleet manager owns their firing.
    kill:replica<R>@reload        LIFECYCLE drills (serve/lifecycle.py
    ckpt_corrupt:reload           + serve/fleet.py /reloadz): SIGKILL
                                  replica R while ITS hot-swap is in
                                  flight (the mid-swap death the
                                  manager must restart on the
                                  PREVIOUS checkpoint), or corrupt the
                                  INCOMING checkpoint at the start of
                                  a reload so verification must
                                  reject-and-rollback while the old
                                  model keeps serving. Reload events
                                  never fire inside a trainer; the
                                  fleet reload loop owns their firing.
    kill:stage<K>@step<N>         MPMD pipeline drills (parallel/
    stall:stage<K>@step<N>:<S>s   mpmd.py): SIGKILL stage K's process
                                  before its step-N dispatch (the
                                  mid-epoch death the supervisor must
                                  restart from the stage-sliced
                                  checkpoint) or sleep it S seconds
                                  (a straggling stage the bubble
                                  accounting should attribute). Stage
                                  events fire only inside an engine
                                  armed with ``stage=K`` — a trainer
                                  rank or an SPMD run never owns one.

"Step N" means the global optimizer-step counter (which survives
restarts via the checkpoint), checked at the step boundary before the
dispatch that would run step N — so a resumed run re-approaches the
same trigger point deterministically, and the ledger is what stops a
second firing.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import signal
import time
from typing import Iterable, Sequence

logger = logging.getLogger("ddp_tpu_torch")

KINDS = ("kill", "sigterm", "shrink", "grow", "stall", "ckpt_corrupt")

_EVENT_RE = re.compile(
    r"^(?P<kind>kill|sigterm|shrink)"
    r":rank(?P<rank>\d+)"
    r"@(?P<unit>step|epoch)(?P<at>\d+)$"
)
_GROW_RE = re.compile(
    r"^grow:\+1@(?P<unit>step|epoch)(?P<at>\d+)$"
)
_STALL_RE = re.compile(
    r"^stall:input@(?P<unit>step|epoch)(?P<at>\d+)"
    r":(?P<seconds>\d+(?:\.\d+)?)s$"
)
_CORRUPT_RE = re.compile(r"^ckpt_corrupt:latest$")
# Fleet drills (serve/fleet.py): the trigger point is the router's
# global dispatch counter, not a training step — a serving fleet has
# no step clock, but "the Nth request" is just as deterministic.
_REPLICA_RE = re.compile(
    r"^(?P<kind>kill|stall)"
    r":replica(?P<replica>\d+)"
    r"@request(?P<request>\d+)"
    r"(?::(?P<seconds>\d+(?:\.\d+)?)s)?$"
)
# Lifecycle drills (serve/lifecycle.py): the trigger point is a model
# hot-swap, not a request ordinal — kill the replica whose swap is in
# flight, or corrupt the checkpoint the swap is about to install.
_REPLICA_RELOAD_RE = re.compile(
    r"^kill:replica(?P<replica>\d+)@reload$"
)
_CORRUPT_RELOAD_RE = re.compile(r"^ckpt_corrupt:reload$")
# MPMD pipeline drills (parallel/mpmd.py): the trigger point is the
# pipeline's optimizer-step counter, but the victim is a STAGE process
# — step-only (an MPMD run has no epoch clock).
_STAGE_RE = re.compile(
    r"^(?P<kind>kill|stall)"
    r":stage(?P<stage>\d+)"
    r"@step(?P<at>\d+)"
    r"(?::(?P<seconds>\d+(?:\.\d+)?)s)?$"
)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault. ``rank`` None = every rank (stalls);
    ``step``/``epoch`` are mutually exclusive trigger points; kills
    and sigterms name exactly one rank; ``seconds`` is the stall
    duration. ``ckpt_corrupt`` has no trigger point — it fires at
    process start on rank 0, before checkpoint discovery."""

    kind: str
    rank: int | None = None
    step: int | None = None
    epoch: int | None = None
    seconds: float = 0.0
    # Fleet drills: ``replica`` + ``request`` instead of rank +
    # step/epoch. A replica event belongs to the fleet manager
    # (serve/fleet.py), never to a trainer rank.
    replica: int | None = None
    request: int | None = None
    # MPMD drills: ``stage`` + ``step``. A stage event belongs to one
    # pipeline-stage process (parallel/mpmd.py), never to a trainer
    # rank or an SPMD run.
    stage: int | None = None
    # Lifecycle drills: the trigger point is a model hot-swap instead
    # of a request ordinal / step counter. ``kill:replica<R>@reload``
    # sets replica+reload; ``ckpt_corrupt:reload`` sets reload alone
    # (the victim is the INCOMING checkpoint, wherever the reload
    # points). Owned by the fleet reload loop, never a trainer.
    reload: bool = False

    @property
    def token(self) -> str:
        """Canonical spec token (the ledger id; format/parse round-trip)."""
        if self.kind == "ckpt_corrupt":
            return (
                "ckpt_corrupt:reload" if self.reload
                else "ckpt_corrupt:latest"
            )
        if self.replica is not None:
            if self.reload:
                return f"kill:replica{self.replica}@reload"
            base = f"{self.kind}:replica{self.replica}@request{self.request}"
            if self.kind == "stall":
                base += f":{self.seconds:g}s"
            return base
        if self.stage is not None:
            base = f"{self.kind}:stage{self.stage}@step{self.step}"
            if self.kind == "stall":
                base += f":{self.seconds:g}s"
            return base
        at = (
            f"step{self.step}" if self.step is not None
            else f"epoch{self.epoch}"
        )
        if self.kind == "stall":
            return f"stall:input@{at}:{self.seconds:g}s"
        if self.kind == "grow":
            return f"grow:+1@{at}"
        return f"{self.kind}:rank{self.rank}@{at}"


def parse_chaos(spec: str | None) -> tuple[ChaosEvent, ...]:
    """``--chaos`` string → events. Raises ValueError naming the bad
    token; an empty/None spec parses to ()."""
    if not spec or not spec.strip():
        return ()
    events = []
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        m = _EVENT_RE.match(token)
        if m:
            at = int(m.group("at"))
            events.append(
                ChaosEvent(
                    kind=m.group("kind"),
                    rank=int(m.group("rank")),
                    step=at if m.group("unit") == "step" else None,
                    epoch=at if m.group("unit") == "epoch" else None,
                )
            )
            continue
        m = _GROW_RE.match(token)
        if m:
            at = int(m.group("at"))
            events.append(
                ChaosEvent(
                    kind="grow",
                    step=at if m.group("unit") == "step" else None,
                    epoch=at if m.group("unit") == "epoch" else None,
                )
            )
            continue
        m = _STALL_RE.match(token)
        if m:
            at = int(m.group("at"))
            seconds = float(m.group("seconds"))
            if seconds <= 0:
                raise ValueError(
                    f"chaos stall duration must be > 0: {token!r}"
                )
            events.append(
                ChaosEvent(
                    kind="stall",
                    step=at if m.group("unit") == "step" else None,
                    epoch=at if m.group("unit") == "epoch" else None,
                    seconds=seconds,
                )
            )
            continue
        if _CORRUPT_RE.match(token):
            events.append(ChaosEvent(kind="ckpt_corrupt"))
            continue
        if _CORRUPT_RELOAD_RE.match(token):
            events.append(ChaosEvent(kind="ckpt_corrupt", reload=True))
            continue
        m = _REPLICA_RELOAD_RE.match(token)
        if m:
            events.append(
                ChaosEvent(
                    kind="kill",
                    replica=int(m.group("replica")),
                    reload=True,
                )
            )
            continue
        m = _REPLICA_RE.match(token)
        if m:
            kind = m.group("kind")
            seconds = m.group("seconds")
            if kind == "stall":
                if seconds is None:
                    raise ValueError(
                        f"chaos replica stall needs a duration: {token!r}"
                    )
                if float(seconds) <= 0:
                    raise ValueError(
                        f"chaos stall duration must be > 0: {token!r}"
                    )
            elif seconds is not None:
                raise ValueError(
                    f"chaos replica kill takes no duration: {token!r}"
                )
            events.append(
                ChaosEvent(
                    kind=kind,
                    replica=int(m.group("replica")),
                    request=int(m.group("request")),
                    seconds=float(seconds) if seconds else 0.0,
                )
            )
            continue
        m = _STAGE_RE.match(token)
        if m:
            kind = m.group("kind")
            seconds = m.group("seconds")
            if kind == "stall":
                if seconds is None:
                    raise ValueError(
                        f"chaos stage stall needs a duration: {token!r}"
                    )
                if float(seconds) <= 0:
                    raise ValueError(
                        f"chaos stall duration must be > 0: {token!r}"
                    )
            elif seconds is not None:
                raise ValueError(
                    f"chaos stage kill takes no duration: {token!r}"
                )
            events.append(
                ChaosEvent(
                    kind=kind,
                    stage=int(m.group("stage")),
                    step=int(m.group("at")),
                    seconds=float(seconds) if seconds else 0.0,
                )
            )
            continue
        raise ValueError(
            f"bad chaos event {token!r}; grammar: "
            "kill:rank<R>@step<N>|epoch<N>, "
            "sigterm:rank<R>@step<N>|epoch<N>, "
            "shrink:rank<R>@step<N>|epoch<N>, grow:+1@step<N>|epoch<N>, "
            "stall:input@step<N>|epoch<N>:<S>s, ckpt_corrupt:latest, "
            "kill:replica<R>@request<N>, "
            "stall:replica<R>@request<N>:<S>s, "
            "kill:replica<R>@reload, ckpt_corrupt:reload, "
            "kill:stage<K>@step<N>, stall:stage<K>@step<N>:<S>s"
        )
    return tuple(events)


def format_chaos(events: Iterable[ChaosEvent]) -> str:
    """Events → canonical spec string (``parse_chaos`` round-trips)."""
    return ",".join(e.token for e in events)


def fleet_events(
    events: Iterable[ChaosEvent] | str | None,
) -> tuple[ChaosEvent, ...]:
    """The replica-scoped subset of a plan — what the fleet manager
    (serve/fleet.py) owns. Accepts a spec string for CLI plumbing."""
    if isinstance(events, str) or events is None:
        events = parse_chaos(events)
    return tuple(e for e in events if e.replica is not None)


def reload_events(
    events: Iterable[ChaosEvent] | str | None,
) -> tuple[ChaosEvent, ...]:
    """The reload-scoped subset of a plan — what the fleet's hot-swap
    loop (serve/fleet.py /reloadz) owns. Accepts a spec string."""
    if isinstance(events, str) or events is None:
        events = parse_chaos(events)
    return tuple(e for e in events if e.reload)


def stage_events(
    events: Iterable[ChaosEvent] | str | None,
) -> tuple[ChaosEvent, ...]:
    """The stage-scoped subset of a plan — what the MPMD pipeline
    supervisor (parallel/mpmd.py) owns. Accepts a spec string."""
    if isinstance(events, str) or events is None:
        events = parse_chaos(events)
    return tuple(e for e in events if e.stage is not None)


def corrupt_latest_checkpoint(
    directory: str, *, seed: int = 0
) -> str | None:
    """Truncate the largest file of the latest committed checkpoint.

    The deterministic torn-write drill: picks ``epoch_<max>`` under
    ``directory``, then its largest file (ties broken by path, so the
    choice is stable), and truncates it to half its size — exactly the
    artifact a mid-write kill leaves. Returns the corrupted path, or
    None when there is nothing to corrupt. ``seed`` varies WHERE the
    truncation lands (half ± a seeded offset) without changing which
    file is hit.
    """
    try:
        epochs = [
            (int(m.group(1)), name)
            for name in os.listdir(directory)
            for m in [re.match(r"^epoch_(\d+)$", name)]
            if m and os.path.isdir(os.path.join(directory, name))
        ]
    except OSError:
        return None
    if not epochs:
        return None
    _, latest = max(epochs)
    step_dir = os.path.join(directory, latest)
    files = []
    for root, _, names in os.walk(step_dir):
        for n in names:
            p = os.path.join(root, n)
            try:
                files.append((os.path.getsize(p), p))
            except OSError:
                continue
    if not files:
        return None
    size, victim = max(files, key=lambda t: (t[0], t[1]))
    # Half the file ± up to 25%, seeded — never 0 (an empty file is a
    # different failure than a torn one) unless the file was tiny.
    cut = max(1, size // 2 + (seed % max(1, size // 4)) - size // 8)
    cut = min(cut, max(0, size - 1))
    with open(victim, "r+b") as f:
        f.truncate(cut)
    logger.warning(
        "chaos: truncated %s from %d to %d bytes", victim, size, cut
    )
    return victim


class ChaosEngine:
    """Arms a rank's share of a chaos plan and fires events once.

    The trainer calls ``on_start`` (before checkpoint discovery),
    ``on_epoch`` (top of each epoch) and ``on_step`` (each step
    boundary, with the global step counter). Events that already fired
    — in this process or a previous incarnation, per the ledger — are
    skipped, which is what makes ``--chaos kill:...`` + a restart loop
    terminate instead of crash-looping.
    """

    def __init__(
        self,
        events: Sequence[ChaosEvent] | str | None,
        *,
        rank: int = 0,
        stage: int | None = None,
        ledger_path: str | None = None,
        seed: int = 0,
    ):
        if isinstance(events, str) or events is None:
            events = parse_chaos(events)
        self.events = tuple(events)
        self.rank = int(rank)
        self.stage = None if stage is None else int(stage)
        self.seed = int(seed)
        self._ledger_path = ledger_path
        self._fired: set[str] | None = None  # lazy ledger load

    @property
    def enabled(self) -> bool:
        return bool(self.events)

    def has_step_events(self) -> bool:
        return any(e.step is not None for e in self.events)

    # ---- ledger ------------------------------------------------------

    def _load_ledger(self) -> set[str]:
        if self._fired is not None:
            return self._fired
        fired: set[str] = set()
        if self._ledger_path:
            try:
                with open(self._ledger_path) as f:
                    data = json.load(f)
                fired = set(data.get("fired", []))
            except (OSError, ValueError):
                fired = set()
        self._fired = fired
        return fired

    def _mark_fired(self, ev: ChaosEvent) -> None:
        fired = self._load_ledger()
        fired.add(ev.token)
        if not self._ledger_path:
            return
        # Durable BEFORE the fault lands: a kill must not forget it
        # fired, or the relaunched run kills itself at the same step
        # forever. Atomic (tmp+replace) like every sidecar here.
        try:
            os.makedirs(
                os.path.dirname(os.path.abspath(self._ledger_path)),
                exist_ok=True,
            )
            tmp = f"{self._ledger_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"fired": sorted(fired)}, f)
            os.replace(tmp, self._ledger_path)
        except OSError as e:  # unwritable dir: fire anyway, log why
            logger.warning("chaos ledger write failed: %s", e)

    # ---- trigger points ----------------------------------------------

    def _mine(self, ev: ChaosEvent) -> bool:
        if ev.reload:
            # Lifecycle events (kill:replica<R>@reload,
            # ckpt_corrupt:reload) fire from the fleet's hot-swap loop
            # — a trainer rank never owns one (in particular rank 0's
            # on_start must NOT corrupt a checkpoint that only a
            # reload is supposed to see corrupted).
            return False
        if ev.replica is not None:
            # Fleet events (kill:replica<R>@request<N>) fire from the
            # replica MANAGER's dispatch counter (serve/fleet.py) —
            # a trainer rank never owns one.
            return False
        if ev.stage is not None:
            # Stage events (kill:stage<K>@step<N>) belong to one MPMD
            # stage process; an engine armed without ``stage`` (any
            # trainer rank, any SPMD run) rejects them outright.
            return self.stage is not None and ev.stage == self.stage
        if ev.kind in ("ckpt_corrupt", "grow"):
            # one filesystem, one corruptor; one world, one grow
            # requester (any single rank works — rank 0 is the
            # convention every other singleton here uses)
            return self.rank == 0
        return ev.rank is None or ev.rank == self.rank

    def _fire(self, ev: ChaosEvent, checkpoint_dir: str | None = None) -> None:
        self._mark_fired(ev)
        logger.warning("chaos: firing %s (rank %d)", ev.token, self.rank)
        if ev.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        elif ev.kind == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        elif ev.kind in ("shrink", "grow"):
            # The elastic resize contract rides the exit code
            # (runtime/launch.py). os._exit, not sys.exit: a reclaimed
            # host runs no cleanup — and a SystemExit would be caught
            # by the trainer's post-mortem machinery as an exception.
            from ddp_tpu_torch.runtime.launch import (
                GROW_EXIT_CODE,
                SHRINK_EXIT_CODE,
            )

            os._exit(
                SHRINK_EXIT_CODE if ev.kind == "shrink" else GROW_EXIT_CODE
            )
        elif ev.kind == "stall":
            time.sleep(ev.seconds)
        elif ev.kind == "ckpt_corrupt" and checkpoint_dir:
            corrupt_latest_checkpoint(checkpoint_dir, seed=self.seed)

    def _pending(self) -> Iterable[ChaosEvent]:
        fired = self._load_ledger()
        return (
            e for e in self.events
            if self._mine(e) and e.token not in fired
        )

    def on_start(self, checkpoint_dir: str | None) -> None:
        """Process-start events (``ckpt_corrupt``) — call BEFORE
        checkpoint discovery/restore."""
        if not self.events:
            return
        for ev in list(self._pending()):
            if ev.kind == "ckpt_corrupt":
                self._fire(ev, checkpoint_dir=checkpoint_dir)

    def on_epoch(self, epoch: int) -> None:
        if not self.events:
            return
        for ev in list(self._pending()):
            if ev.epoch is not None and ev.epoch == epoch:
                self._fire(ev)

    def on_step(self, step: int) -> None:
        """``step`` = the global optimizer step the NEXT dispatch will
        run (the counter restored from checkpoints, so trigger points
        survive restarts). Chaos-off is free: the guard is one tuple
        truthiness test in the hot loop."""
        if not self.events:
            return
        for ev in list(self._pending()):
            if ev.step is not None and ev.step == step:
                self._fire(ev)
