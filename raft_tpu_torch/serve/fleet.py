"""Supervised replica fleet: N warm daemons behind one failover router
(port of ``raft_tpu.serve.fleet``).

``Fleet`` is the supervisor of the serving tier.  It launches N replica
daemons — each one a ``python -m raft_tpu_torch.serve daemon`` child on
its own AF_UNIX socket, started with ``subprocess`` (a new interpreter:
a parent that has initialised CUDA is never forked into a replica) — ALL
sharing the port's kernel build directory ``raft_tpu_torch/_build/``, so
every replica past the first loads the kernel libraries built before it
(zero compiles at ready) and a restarted replica comes back warm for the
same reason (as the JAX fleet's replicas share its AOT cache root).
:func:`raft_tpu_torch.core.nvcc.run_jobs` publishes each library
atomically, so two cold replicas building at once are safe.  In front of
them it runs a :class:`~raft_tpu_torch.serve.router.FleetRouter`
in-process: clients speak the unchanged length-prefixed JSON protocol to
ONE socket and never learn the tier's width.

Supervision contract:

* the babysit loop ``wait``-polls every child; a dead one is restarted
  on its original socket path, warm off the shared cache root, and
  RE-ADMITTED only after the router's health probe passes — a replica
  that restarts but cannot serve never takes traffic;
* restarts are storm-bounded: at most ``restart_max`` restarts per
  ``restart_window_s`` sliding window per replica (a crash-looping
  child must not melt the host), with the suppression visible as the
  ``fleet.restart_suppressed`` counter and in telemetry;
* the supervisor is the router's fault *injector*: the counted
  ``kill_replica:K`` fault (:mod:`raft_tpu_torch.resilience.faults`) reaches
  a real ``SIGKILL`` through :meth:`Fleet.kill`, which is also what the
  fleet smoke uses to prove the failover path against real processes.

Everything is injectable for the deterministic tests: ``spawn_fn``
replaces the Popen child with anything that returns ``(handle,
ready_dict)`` (the restart-storm test hands back instantly-dead
handles), ``clock`` drives the restart window, and
:meth:`Fleet._babysit_once` is the loop body tests call directly.

``FleetConfig`` is the arm-time snapshot of the ``RAFT_TPU_FLEET_*``
knobs: the router's concurrent request path only ever sees this frozen
dataclass, never ``os.environ``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque

from raft_tpu_torch.obs import metrics as _metrics
from raft_tpu_torch.serve.router import FleetRouter

REPLICAS_ENV = "RAFT_TPU_FLEET_REPLICAS"
PROBE_MS_ENV = "RAFT_TPU_FLEET_PROBE_MS"
PROBE_TIMEOUT_MS_ENV = "RAFT_TPU_FLEET_PROBE_TIMEOUT_MS"
QUEUE_MAX_ENV = "RAFT_TPU_FLEET_QUEUE_MAX"
SHED_ERROR_RATE_ENV = "RAFT_TPU_FLEET_SHED_ERROR_RATE"
RESTART_MAX_ENV = "RAFT_TPU_FLEET_RESTART_MAX"
RESTART_WINDOW_S_ENV = "RAFT_TPU_FLEET_RESTART_WINDOW_S"
SOCKET_ENV = "RAFT_TPU_FLEET_SOCKET"

DEFAULT_REPLICAS = 2
DEFAULT_PROBE_MS = 500.0
DEFAULT_PROBE_TIMEOUT_MS = 2000.0
DEFAULT_QUEUE_MAX = 32
DEFAULT_SHED_ERROR_RATE = 0.5
DEFAULT_RESTART_MAX = 3
DEFAULT_RESTART_WINDOW_S = 30.0


def default_fleet_socket() -> str:
    """Default front-end AF_UNIX socket path (per-uid tmp namespace,
    distinct from the single daemon's default and from the JAX fleet's, so
    all can coexist)."""
    return os.path.join(tempfile.gettempdir(),
                        f"raft_tpu_torch_fleet_{os.getuid()}.sock")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Frozen arm-time snapshot of everything the fleet tier consults
    (supervisor AND router — one snapshot, handed to both)."""

    replicas: int = DEFAULT_REPLICAS
    #: heartbeat cadence; <= 0 disables the probe/babysit threads (the
    #: deterministic tests drive probe_once()/_babysit_once() directly)
    probe_interval_s: float = DEFAULT_PROBE_MS / 1e3
    #: deadline on each ping probe AND each admission/refresh connection
    probe_timeout_s: float = DEFAULT_PROBE_TIMEOUT_MS / 1e3
    #: forward deadline: an in-flight request older than this is expired
    #: into the resubmission ladder (the stalled-replica recovery path)
    request_timeout_s: float = 120.0
    #: per-replica in-flight cap; total admission is queue_max x healthy
    queue_max: int = DEFAULT_QUEUE_MAX
    #: windowed SLO error rate above which admission sheds
    shed_error_rate: float = DEFAULT_SHED_ERROR_RATE
    #: minimum windowed events before the error budget can shed (a single
    #: early error must not latch an idle fleet shut)
    shed_min_events: int = 8
    #: retry-after hint carried on every shed response
    retry_after_ms: float = 50.0
    #: restart-storm bound: restarts per replica per sliding window
    restart_max: int = DEFAULT_RESTART_MAX
    restart_window_s: float = DEFAULT_RESTART_WINDOW_S
    #: failover resubmission ladder (retry_call bounds)
    resubmit_retries: int = 4
    resubmit_backoff_s: float = 0.05
    #: front-end socket path ("" = default_fleet_socket())
    socket_path: str = ""

    @classmethod
    def from_env(cls, **overrides) -> "FleetConfig":
        """Snapshot the ``RAFT_TPU_FLEET_*`` knobs (arm time only — never
        from the request path).  ``overrides`` win over the environment
        (CLI flags, test fixtures).  Malformed values fail LOUDLY."""
        vals: dict = {}

        def _num(raw, env: str, key: str, cast, scale=None, unit=""):
            # the caller fetches the value with the knob-name constant
            # inline so the registry-drift audit sees each read
            raw = (raw or "").strip()
            if not raw:
                return
            try:
                v = cast(raw)
            except ValueError:
                kind = "an integer" if cast is int else "a number"
                raise ValueError(f"{env}={raw!r} is not {kind}{unit}")
            vals[key] = v if scale is None else v * scale

        _num(os.environ.get(REPLICAS_ENV), REPLICAS_ENV,
             "replicas", int)
        _num(os.environ.get(PROBE_MS_ENV), PROBE_MS_ENV,
             "probe_interval_s", float, scale=1e-3,
             unit=" (milliseconds)")
        _num(os.environ.get(PROBE_TIMEOUT_MS_ENV), PROBE_TIMEOUT_MS_ENV,
             "probe_timeout_s", float, scale=1e-3,
             unit=" (milliseconds)")
        _num(os.environ.get(QUEUE_MAX_ENV), QUEUE_MAX_ENV,
             "queue_max", int)
        _num(os.environ.get(SHED_ERROR_RATE_ENV), SHED_ERROR_RATE_ENV,
             "shed_error_rate", float)
        _num(os.environ.get(RESTART_MAX_ENV), RESTART_MAX_ENV,
             "restart_max", int)
        _num(os.environ.get(RESTART_WINDOW_S_ENV), RESTART_WINDOW_S_ENV,
             "restart_window_s", float, unit=" (seconds)")
        vals["socket_path"] = (os.environ.get(SOCKET_ENV, "").strip()
                               or default_fleet_socket())
        vals.update(overrides)
        cfg = cls(**vals)
        if cfg.replicas < 1:
            raise ValueError(f"{REPLICAS_ENV} must be >= 1, got "
                             f"{cfg.replicas}")
        if cfg.queue_max < 1:
            raise ValueError(f"{QUEUE_MAX_ENV} must be >= 1, got "
                             f"{cfg.queue_max}")
        if cfg.probe_timeout_s <= 0:
            raise ValueError(f"{PROBE_TIMEOUT_MS_ENV} must be > 0, got "
                             f"{cfg.probe_timeout_s * 1e3}")
        if not (0.0 <= cfg.shed_error_rate <= 1.0):
            raise ValueError(f"{SHED_ERROR_RATE_ENV} must be in [0, 1], "
                             f"got {cfg.shed_error_rate}")
        if cfg.restart_max < 0 or cfg.restart_window_s <= 0:
            raise ValueError(
                f"{RESTART_MAX_ENV}/{RESTART_WINDOW_S_ENV} must be "
                f">= 0 / > 0, got {cfg.restart_max}/{cfg.restart_window_s}")
        return cfg


class _Replica:
    """Supervisor-side record of one replica child (babysit-loop state;
    the router keeps its own routing view keyed by the same index)."""

    def __init__(self, idx: int, socket_path: str):
        self.idx = idx
        self.socket_path = socket_path
        self.handle = None           # Popen-like: poll/kill/terminate/wait
        self.ready: dict = {}        # last ready line (compiles_at_ready..)
        self.restarts = 0
        self.suppressed = False
        self.restart_times: deque = deque()


class Fleet:
    """See module docstring.  ``serve_args`` is appended to every child's
    ``python -m raft_tpu_torch.serve daemon --socket <path>`` command line
    (``--device``, ``--nw``, ``--warm``, ...); ``child_env`` replaces the
    inherited environment."""

    def __init__(self, config: FleetConfig | None = None, serve_args=(),
                 child_env: dict | None = None, run_dir: str | None = None,
                 spawn_fn=None, clock=time.monotonic,
                 ready_timeout_s: float = 300.0):
        self.config = config if config is not None else FleetConfig.from_env()
        self.serve_args = list(serve_args)
        self.child_env = dict(child_env) if child_env is not None else None
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="raft_tpu_fleet_")
        self.spawn_fn = spawn_fn or self._spawn_daemon_child
        self.clock = clock
        self.ready_timeout_s = float(ready_timeout_s)
        self._replicas = [
            _Replica(i, os.path.join(self.run_dir, f"replica{i}.sock"))
            for i in range(self.config.replicas)]
        self.router = FleetRouter(
            self.config, [r.socket_path for r in self._replicas],
            socket_path=(self.config.socket_path or default_fleet_socket()),
            injector=self, on_shutdown=self.stop)
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._babysit_thread: threading.Thread | None = None

    # ---------------------------------------------------------- lifecycle
    def start(self) -> dict:
        """Spawn every replica to its ready line (all at once), arm the
        router (which admits them), start the babysit loop; returns the
        fleet's ready summary (front socket + per-replica ready lines).
        The JAX fleet spawns its replicas one after another; a replica of
        the port spends most of its start-up in ``import torch`` and the
        first CUDA work, which overlap."""
        # every replica starts at once, each in a thread that waits for its
        # ready line (on one card their CUDA contexts share it time-sliced)
        errors: list = []

        def spawn(r):
            try:
                self._spawn(r)
            except Exception as e:       # re-raised below, first one wins
                errors.append(e)

        threads = [threading.Thread(target=spawn, args=(r,), name=f"fleet-spawn-{r.idx}")
                   for r in self._replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        self.router.start()
        if self.config.probe_interval_s > 0:
            self._babysit_thread = threading.Thread(
                target=self._babysit_loop, name="fleet-babysit", daemon=True)
            self._babysit_thread.start()
        return {"socket": self.router.socket_path,
                "replicas": {str(r.idx): r.ready for r in self._replicas}}

    def stop(self, timeout: float = 30.0) -> None:
        """Router first (stops intake, fails in-flight loudly), then
        SIGTERM every child with a bounded wait (kill on overrun)."""
        if self._stopping.is_set():
            return
        self._stopping.set()
        if self._babysit_thread is not None:
            self._babysit_thread.join(timeout=timeout)
        self.router.stop()
        procs = []
        for r in self._replicas:
            h = r.handle
            if h is None or h.poll() is not None:
                continue
            try:
                h.terminate()
                procs.append(h)
            except OSError:                     # pragma: no cover
                pass
        for h in procs:
            try:
                h.wait(timeout)
            except subprocess.TimeoutExpired:   # pragma: no cover
                h.kill()
                h.wait(10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # ----------------------------------------------------------- spawning
    def _spawn(self, r: _Replica) -> None:
        handle, ready = self.spawn_fn(r.idx, r.socket_path)
        with self._lock:
            r.handle = handle
            r.ready = ready

    def _spawn_daemon_child(self, idx: int, socket_path: str):
        """Default ``spawn_fn``: one real daemon child, stderr to a file
        (a chatty child must never block on an undrained pipe), blocking
        until its ready line (threaded deadline) — the serve-smoke spawn
        discipline."""
        from raft_tpu_torch.serve.smoke import _read_ready_line

        stderr_path = os.path.join(self.run_dir, f"replica{idx}.err")
        stderr_f = open(stderr_path, "a")
        env = (dict(self.child_env) if self.child_env is not None
               else dict(os.environ))
        # a replica child is unbounded by design: its lifetime is owned
        # by this supervisor (ready-line deadline below, SIGTERM + bounded
        # wait in stop(), SIGKILL through the kill_replica injector)
        proc = subprocess.Popen(
            [sys.executable, "-m", "raft_tpu_torch.serve", "daemon",
             "--socket", socket_path, *self.serve_args],
            stdout=subprocess.PIPE, stderr=stderr_f, text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
        )
        stderr_f.close()                 # the child holds its own handle
        try:
            line = _read_ready_line(proc, self.ready_timeout_s)
        except RuntimeError as e:
            try:
                with open(stderr_path) as f:
                    tail = f.read()[-2000:]
            except OSError:
                tail = "<stderr unavailable>"
            raise RuntimeError(
                f"replica {idx} failed to become ready: {e}\n"
                f"--- replica stderr tail ---\n{tail}")
        ready = json.loads(line)
        if not ready.get("ready"):
            raise RuntimeError(f"unexpected replica {idx} ready line: "
                               f"{line!r}")
        return proc, ready

    # ---------------------------------------------------- fault injector
    def kill(self, idx: int) -> None:
        """SIGKILL replica ``idx`` — the router's ``kill_replica``
        injection hook (and the smoke's chaos hand).  The babysit loop
        restarts it warm; the router re-admits it after a passing probe."""
        h = self._replicas[idx].handle
        if h is None:
            return
        try:
            h.kill()
        except OSError:                          # pragma: no cover
            pass

    # ------------------------------------------------------- babysitting
    def _babysit_loop(self) -> None:
        while not self._stopping.wait(self.config.probe_interval_s):
            try:
                self._babysit_once()
            except Exception:      # pragma: no cover - supervision must
                pass               # survive anything a respawn can raise

    def _babysit_once(self, now: float | None = None) -> list:
        """One supervision sweep (the loop body; the restart-storm test
        calls it directly on a virtual clock): restart dead children
        within the per-replica storm bound.  Returns the indices
        restarted this sweep."""
        now = self.clock() if now is None else now
        cfg = self.config
        restarted = []
        for r in self._replicas:
            h = r.handle
            if h is not None and h.poll() is None:
                continue                      # alive
            if self._stopping.is_set():
                break
            while (r.restart_times
                   and now - r.restart_times[0] > cfg.restart_window_s):
                r.restart_times.popleft()
            if len(r.restart_times) >= cfg.restart_max:
                if not r.suppressed:
                    r.suppressed = True
                    _metrics.counter("fleet.restart_suppressed").inc()
                continue                      # window full: wait it out
            r.restart_times.append(now)
            r.restarts += 1
            r.suppressed = False
            _metrics.counter("fleet.restart").inc()
            try:
                self._spawn(r)
                restarted.append(r.idx)
            except Exception:
                # the failed spawn consumed a restart-budget slot; the
                # next sweep retries, bounded by the same window
                with self._lock:
                    r.handle = None
        return restarted

    # -------------------------------------------------------- telemetry
    def telemetry(self) -> dict:
        """Supervisor view (restarts, suppression, ready lines) merged
        with the router's live routing/SLO snapshot."""
        with self._lock:
            sup = [{"idx": r.idx,
                    "alive": (r.handle is not None
                              and r.handle.poll() is None),
                    "restarts": r.restarts,
                    "suppressed": r.suppressed,
                    "compiles_at_ready": r.ready.get("compiles_at_ready"),
                    "ready_s": r.ready.get("ready_s"),
                    "socket": r.socket_path}
                   for r in self._replicas]
        return {"supervisor": {"replicas": sup, "run_dir": self.run_dir},
                "router": self.router.telemetry()}
