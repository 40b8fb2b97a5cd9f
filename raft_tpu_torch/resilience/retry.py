"""Bounded, backoff-aware retry for host-side fallible operations (port of
``raft_tpu.resilience.retry``).

One retry discipline for every flaky host boundary the port crosses —
the ``g++`` build of the host panel solver, child processes — instead of
a bespoke loop per call site:

* attempts are BOUNDED (``retries``), never unbounded spin;
* waits between attempts grow exponentially (``backoff_s * growth**n``,
  capped at ``max_backoff_s``) — a transient wedge gets room to clear
  without a tight retry hammering it;
* an optional ``deadline_s`` makes the whole ladder wall-clock-aware:
  no attempt starts (and no sleep happens) past the deadline, so a
  caller with a time budget can hand the budget down instead of
  multiplying worst cases.

:func:`checked_subprocess` is the companion primitive for child
processes: a hard timeout on every launch (a native build or a device
start-up can hang forever), non-zero exit turned into a typed exception
carrying a REDACTED stderr tail (these diagnostics may land verbatim in
logs and committed artifacts), and the ``hang_subprocess``
fault-injection hook for the resilience harness.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import time


class SubprocessFailed(RuntimeError):
    """A checked subprocess timed out, failed to spawn, or exited non-zero.

    ``kind``: ``"timeout"`` / ``"nonzero"`` / ``"spawn"``;
    ``stderr_tail``: redacted tail of the child's stderr (may be "").
    """

    def __init__(self, describe: str, kind: str, detail: str = "",
                 returncode: int | None = None, stderr_tail: str = ""):
        self.describe = describe
        self.kind = kind
        self.detail = detail
        self.returncode = returncode
        self.stderr_tail = stderr_tail
        msg = f"{describe}: {kind}"
        if returncode is not None:
            msg += f" (rc={returncode})"
        if detail:
            msg += f": {detail}"
        if stderr_tail:
            msg += f"\nstderr tail: {stderr_tail}"
        super().__init__(msg)


class RetryExhausted(RuntimeError):
    """Every attempt of a :func:`retry_call` ladder failed.

    ``last`` is the final attempt's exception; ``attempts`` how many ran;
    ``elapsed_s`` total wall-clock including backoff sleeps.
    """

    def __init__(self, describe: str, attempts: int, elapsed_s: float, last):
        self.describe = describe
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.last = last
        super().__init__(
            f"{describe}: {attempts} attempt(s) failed in {elapsed_s:.1f}s; "
            f"last error: {last}")


def redacted_tail(text, n: int = 300) -> str:
    """Last ~n chars of subprocess output with credential-looking tokens
    masked — the shared redaction rule for every diagnostic that lands in
    a committed artifact (error dicts, build failures, retry logs).

    Redacts BEFORE truncating: slicing first could cut the key prefix
    ('Bearer ', 'api_key=') off a credential that straddles the cut,
    leaving the bare token with nothing for the patterns to anchor on.
    """
    if not text:
        return ""
    if isinstance(text, bytes):
        text = text.decode("utf-8", "replace")
    # header form first ("Authorization: Bearer <tok>" / bare
    # "Bearer <tok>" — the credential follows the word, no = or :
    # between them), then key=value / key: value forms, then bare
    # sk-style keys
    text = re.sub(r"(?i)(bearer\s+)\S+", r"\1[redacted]", text.strip())
    text = re.sub(
        r"(?i)((?:api[_-]?key|token|secret|password|authorization)"
        r"\S*\s*[=:]\s*)\S+",
        r"\1[redacted]", text,
    )
    return re.sub(r"\bsk-[A-Za-z0-9_-]{8,}", "[redacted]", text)[-n:]


def retry_call(fn, *, retries: int = 3, backoff_s: float = 1.0,
               growth: float = 2.0, max_backoff_s: float = 60.0,
               deadline_s: float | None = None,
               retry_on: tuple = (Exception,), describe: str = "call",
               on_retry=None, sleep=time.sleep):
    """Call ``fn(attempt)`` up to ``retries`` times with exponential
    backoff between attempts; return its value, or raise
    :class:`RetryExhausted` wrapping the last failure.

    ``fn`` receives the 0-based attempt index.  Only exceptions matching
    ``retry_on`` are retried — anything else propagates immediately
    (a deterministic failure should not burn the backoff budget).
    ``deadline_s`` bounds the TOTAL wall-clock from the first attempt:
    when the next backoff sleep (or next attempt) would start past the
    deadline, the ladder stops early and raises with whatever the last
    error was.  ``on_retry(attempt, exc)`` observes each failure (logging
    hooks); ``sleep`` is injectable for tests.
    """
    retries = max(1, int(retries))
    t0 = time.monotonic()
    last = None
    attempts = 0
    for attempt in range(retries):
        if attempt:
            delay = min(backoff_s * growth ** (attempt - 1), max_backoff_s)
            if deadline_s is not None:
                remaining = deadline_s - (time.monotonic() - t0)
                if remaining <= delay:
                    break          # deadline-aware: no pointless sleep
            sleep(delay)
        attempts += 1
        try:
            return fn(attempt)
        except retry_on as e:      # noqa: PERF203 - the point of the loop
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
            if (deadline_s is not None
                    and time.monotonic() - t0 >= deadline_s):
                break
    raise RetryExhausted(describe, attempts, time.monotonic() - t0, last)


def checked_subprocess(cmd, *, timeout_s: float, env=None,
                       describe: str = "subprocess",
                       require_stdout: bool = False):
    """``subprocess.run`` with a HARD timeout and typed failure.

    Returns the ``CompletedProcess`` on rc == 0 (and, with
    ``require_stdout``, non-empty stdout); raises
    :class:`SubprocessFailed` otherwise, with a redacted stderr tail so
    the caller's diagnostics are safe to commit.  The
    ``hang_subprocess`` fault spec (:mod:`raft_tpu_torch.resilience.faults`)
    substitutes a sleep-forever child so timeout/retry paths can be
    exercised deterministically.
    """
    from raft_tpu_torch.resilience import faults

    if faults.consume("hang_subprocess"):
        cmd = [sys.executable, "-c", "import time; time.sleep(3600)"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout_s, env=env)
    except subprocess.TimeoutExpired as e:
        raise SubprocessFailed(
            describe, "timeout",
            detail=f"did not complete within {timeout_s:.0f}s",
            stderr_tail=redacted_tail(getattr(e, "stderr", None)))
    except OSError as e:
        raise SubprocessFailed(describe, "spawn", detail=str(e)[-300:])
    if r.returncode != 0:
        raise SubprocessFailed(
            describe, "nonzero", returncode=r.returncode,
            stderr_tail=redacted_tail(r.stderr or r.stdout))
    if require_stdout and not r.stdout.strip():
        raise SubprocessFailed(
            describe, "nonzero", returncode=r.returncode,
            detail="exited 0 with empty stdout",
            stderr_tail=redacted_tail(r.stderr))
    return r


def build_timeout_s(default: float = 300.0) -> float:
    """Native-toolchain build timeout from ``RAFT_TPU_BUILD_TIMEOUT``
    (seconds; the ``g++`` BEM build must never hang a sweep forever)."""
    v = os.environ.get("RAFT_TPU_BUILD_TIMEOUT", "").strip()
    if not v:
        return default
    try:
        return max(1.0, float(v))
    except ValueError:
        import warnings

        warnings.warn(
            f"RAFT_TPU_BUILD_TIMEOUT={v!r} is not a number; using the "
            f"default {default:.0f}s", stacklevel=2)
        return default
