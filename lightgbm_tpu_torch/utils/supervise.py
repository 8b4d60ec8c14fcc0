"""Hardened subprocess supervision: the ``bench.probe_backend`` pattern
(own process group + ``killpg`` on timeout + temp-file output so a surviving
grandchild can't block the parent through an inherited pipe) generalized
into reusable primitives for unattended perf capture:

- :func:`run_stage` — run one command under a wall-clock budget with
  retries and jittered exponential backoff; every attempt is crash- and
  hang-isolated from the caller.
- :class:`Heartbeat` — structured append-only jsonl progress records, so
  an unattended run leaves a legible trail even when it dies mid-stage.
- :class:`SingleOwnerLock` — pid-checked lock file guaranteeing only one
  process ever touches the card; stale locks (dead owner) are reclaimed.

STDLIB-ONLY by design (the port's copy of the JAX package's
``utils/supervise.py``): a supervising front-end can load this module
without importing the ``lightgbm_tpu_torch`` package (whose ``__init__``
pulls in torch).  Load it package-free via::

    spec = importlib.util.spec_from_file_location("supervise", path)

The module itself must therefore never import torch, numpy, or anything
else of the package.
"""
from __future__ import annotations

import json
import os
import random
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field


# --------------------------------------------------------------------------
# process-group reaping
# --------------------------------------------------------------------------

def _descendants(root: int) -> list:
    """Pids of every live descendant of ``root`` via a /proc ppid scan.
    Needed because killpg alone misses grandchildren that called setsid
    themselves (e.g. a supervised stage that itself uses run_stage): a new
    session is a new process group, outside the root's.  Collected BEFORE
    the kill — afterwards orphans reparent to init and the chain is
    lost."""
    children: dict = {}
    try:
        for entry in os.listdir("/proc"):
            if not entry.isdigit():
                continue
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
                # field 4 (after the parenthesised comm, which may contain
                # spaces): ppid
                ppid = int(stat.rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            children.setdefault(ppid, []).append(int(entry))
    except OSError:
        return []
    out, frontier = [], [root]
    while frontier:
        p = frontier.pop()
        for c in children.get(p, ()):
            out.append(c)
            frontier.append(c)
    return out


def kill_process_group(pid: int, reap_timeout: float = 5.0,
                       proc: "subprocess.Popen | None" = None) -> bool:
    """SIGKILL the whole process TREE rooted at ``pid``: its process
    group, plus every /proc-walked descendant's group (a descendant that
    called setsid — a nested run_stage stage — left the root's group and
    would otherwise survive as an orphan holding the card).  Reaps the
    direct child; returns True when reaped (False = D-state unreapable
    child: give up and move on — never block the supervisor on it)."""
    strays = _descendants(pid)
    try:
        mypg = os.getpgid(0)
    except OSError:
        mypg = -1
    try:
        os.killpg(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    for s in strays:
        try:
            pg = os.getpgid(s)
        except (ProcessLookupError, OSError):
            pg = -1
        try:
            if pg > 0 and pg != mypg:
                os.killpg(pg, signal.SIGKILL)
            else:
                os.kill(s, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            pass
    if proc is None:
        return True
    try:
        proc.wait(reap_timeout)
        return True
    except subprocess.TimeoutExpired:
        return False


def backoff_schedule(retries: int, base: float, factor: float = 2.0,
                     cap: float = 600.0, jitter: float = 0.25,
                     rng: "random.Random | None" = None) -> list:
    """Jittered exponential backoff delays for ``retries`` re-attempts:
    ``min(cap, base * factor**i)`` each scaled by ``1 ± jitter`` (full
    jitter would let delays collapse to ~0; a bounded band keeps the
    schedule monotone-ish while decorrelating concurrent pollers)."""
    rng = rng or random.Random()
    out = []
    for i in range(retries):
        d = min(cap, base * (factor ** i))
        out.append(d * (1.0 + jitter * (2.0 * rng.random() - 1.0)))
    return out


# --------------------------------------------------------------------------
# stage runner
# --------------------------------------------------------------------------

@dataclass
class StageResult:
    """Outcome of one :func:`run_stage` call (the LAST attempt)."""
    name: str
    status: str                 # "ok" | "crash" | "timeout" | "unreaped"
    returncode: "int | None"
    attempts: int
    elapsed: float              # wall-clock across all attempts, incl. backoff
    output_tail: str = ""       # merged stdout+stderr tail of the last attempt
    # flight-recorder dumps collected from a failed child (run_stage's
    # flight_dir): forensic jsonl files moved beside the caller's journal
    flight_dumps: "list" = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def to_record(self) -> dict:
        rec = {"stage": self.name, "status": self.status,
               "returncode": self.returncode, "attempts": self.attempts,
               "elapsed_sec": round(self.elapsed, 3)}
        if self.flight_dumps:
            rec["flight_dumps"] = list(self.flight_dumps)
        return rec


def run_stage(name: str, argv: list, timeout: float, retries: int = 0,
              backoff: float = 5.0, backoff_factor: float = 2.0,
              backoff_cap: float = 600.0, jitter: float = 0.25,
              env: "dict | None" = None, cwd: "str | None" = None,
              heartbeat=None, tail_bytes: int = 8192,
              sleep=time.sleep, rng: "random.Random | None" = None,
              flight_dir: "str | None" = None,
              ) -> StageResult:
    """Run ``argv`` as a timeout-guarded, crash-isolated stage.

    Each attempt runs in its own session/process group; on timeout the
    WHOLE group is SIGKILLed (a hung device init can leave helper
    grandchildren — ``kill(p.pid)`` alone orphans them holding the
    card).  Output goes to a temp file, never a pipe, so a grandchild that
    survives an incomplete kill cannot block us on read.  A nonzero exit
    or timeout is retried up to ``retries`` times with jittered
    exponential backoff; ``sleep``/``rng`` are injectable so tests can
    verify the schedule without wall-clock cost.

    ``heartbeat`` is any callable accepting ``(event, **fields)`` — see
    :class:`Heartbeat`.  Never raises for child failures; the caller
    branches on ``StageResult.status``.

    ``flight_dir``: arm the child's flight recorder.  Each attempt gets a
    private scratch dir exported as ``LGBM_FLIGHT_DIR``; when the attempt
    fails (crash/timeout/unreaped) any ``flight_*.jsonl`` the child's
    recorder flushed — including the last periodic flush of a SIGKILLed
    child — is moved into ``flight_dir`` (collision-safe names recorded
    in ``StageResult.flight_dumps``); an ok attempt's scratch is dropped.
    """
    hb = heartbeat or (lambda event, **kv: None)
    delays = backoff_schedule(retries, backoff, backoff_factor,
                              backoff_cap, jitter, rng)
    t_start = time.monotonic()
    status, rc, tail = "crash", None, ""
    flight_dumps: list = []
    for attempt in range(retries + 1):
        hb("stage_attempt", stage=name, attempt=attempt,
           argv=list(map(str, argv)), timeout=timeout)
        t_a = time.monotonic()
        child_env, flight_tmp = env, None
        if flight_dir is not None:
            os.makedirs(flight_dir, exist_ok=True)
            # scratch INSIDE flight_dir: collection is a same-filesystem
            # rename, atomic even against a half-written later dump
            flight_tmp = tempfile.mkdtemp(
                dir=flight_dir, prefix=f".flight_{_safe_name(name)}_")
            child_env = dict(os.environ if env is None else env)
            child_env["LGBM_FLIGHT_DIR"] = flight_tmp
        try:
            with tempfile.TemporaryFile(mode="w+", errors="replace") as out:
                try:
                    p = subprocess.Popen(argv, stdout=out,
                                         stderr=subprocess.STDOUT,
                                         stdin=subprocess.DEVNULL,
                                         env=child_env, cwd=cwd,
                                         start_new_session=True)
                except OSError as e:
                    status, rc, tail = "crash", -1, f"spawn failed: {e}"
                    hb("stage_spawn_error", stage=name, attempt=attempt,
                       error=str(e))
                    break           # argv itself is broken: retrying is noise
                try:
                    rc = p.wait(timeout)
                    status = "ok" if rc == 0 else "crash"
                except subprocess.TimeoutExpired:
                    reaped = kill_process_group(p.pid, proc=p)
                    status = "timeout" if reaped else "unreaped"
                    rc = None
                try:
                    out.seek(0, os.SEEK_END)
                    out.seek(max(0, out.tell() - tail_bytes))
                    tail = out.read()
                except (OSError, ValueError):
                    tail = ""
        finally:
            if flight_tmp is not None:
                collected = _collect_flight_dumps(
                    flight_tmp, flight_dir, name, attempt,
                    keep=status != "ok")
                flight_dumps.extend(collected)
                if collected:
                    hb("stage_flight_dump", stage=name, attempt=attempt,
                       dumps=collected)
        hb("stage_result", stage=name, attempt=attempt, status=status,
           returncode=rc, secs=round(time.monotonic() - t_a, 3))
        if status == "ok":
            break
        if attempt < retries:
            hb("stage_backoff", stage=name, attempt=attempt,
               delay_sec=round(delays[attempt], 3))
            sleep(delays[attempt])
    return StageResult(name=name, status=status, returncode=rc,
                       attempts=attempt + 1,
                       elapsed=time.monotonic() - t_start,
                       output_tail=tail, flight_dumps=flight_dumps)


def _safe_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", str(name))


def _collect_flight_dumps(tmp: str, dest: str, name: str, attempt: int,
                          keep: bool) -> list:
    """Move a failed attempt's ``flight_*.jsonl`` from its scratch dir into
    ``dest`` under collision-safe names; drop the scratch dir either way."""
    out: list = []
    try:
        files = sorted(f for f in os.listdir(tmp)
                       if f.startswith("flight_") and f.endswith(".jsonl"))
    except OSError:
        files = []
    if keep:
        for f in files:
            target = os.path.join(
                dest, f"flight_{_safe_name(name)}_a{attempt}_"
                      f"{f[len('flight_'):]}")
            try:
                os.replace(os.path.join(tmp, f), target)
                out.append(target)
            except OSError:
                pass
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def extract_json_line(text: str):
    """Last parseable ``{...}`` line of a stage's output, or None — the
    bench scripts' one-JSON-line contract, parsed in exactly one place
    (the watcher's headline extraction and the suite's subprocess
    big-headline share it)."""
    for line in reversed(text.splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                pass
    return None


# --------------------------------------------------------------------------
# heartbeat
# --------------------------------------------------------------------------

class Heartbeat:
    """Append-only jsonl heartbeat: one self-describing record per event,
    flushed per write (the reader is usually a human tailing the file after
    the unattended run died).  Instances are callable with the
    ``(event, **fields)`` shape :func:`run_stage` expects."""

    def __init__(self, path: str, extra: "dict | None" = None):
        self.path = path
        self._extra = dict(extra or {})
        self._seq = 0

    def __call__(self, event: str, **fields) -> None:
        self.beat(event, **fields)

    def beat(self, event: str, **fields) -> None:
        rec = {"ts": round(time.time(), 3), "seq": self._seq,
               "pid": os.getpid(), "event": event,
               **self._extra, **fields}
        self._seq += 1
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass                   # heartbeat must never kill the watcher


# --------------------------------------------------------------------------
# single-owner lock
# --------------------------------------------------------------------------

class LockHeldError(RuntimeError):
    """Another live process owns the lock; the message names it."""


class SingleOwnerLock:
    """Pid-checked lock file: exactly one process may own the card.

    Acquisition publishes the lock by HARD-LINKING a fully written temp
    file into place — atomic on every POSIX fs, and the body (owner
    pid/host/argv, so a refusal can say WHO holds it) is complete the
    instant the lock exists: there is no empty-file window for a racing
    acquirer to misread as corrupt/stale.  A lock whose owner pid is dead
    is stale (the watcher crashed without cleanup) and is reclaimed under
    an flock-serialized critical section.  Pid liveness is only
    meaningful on the same host — a lock from another host, or one with
    an unreadable body, is honored as live (fail safe; remove by hand)."""

    def __init__(self, path: str):
        self.path = path
        self._owned = False

    def acquire(self) -> "SingleOwnerLock":
        payload = json.dumps({"pid": os.getpid(),
                              "host": socket.gethostname(),
                              "since": round(time.time(), 3),
                              "argv": sys.argv})
        tmp = f"{self.path}.{os.getpid()}.tmp"
        for _ in range(3):          # extra passes after reclaim/vanish races
            with open(tmp, "w") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            try:
                os.link(tmp, self.path)     # atomic create WITH content
                self._owned = True
                return self
            except FileExistsError:
                owner = self._read_owner()
                if owner is None:
                    continue                # vanished under us: just retry
                if self._owner_alive(owner):
                    raise LockHeldError(
                        f"lock {self.path} held by pid {owner.get('pid')} "
                        f"on {owner.get('host')} since {owner.get('since')} "
                        f"({owner.get('argv')}) — refusing to start; remove "
                        "the file only if that process is truly gone")
                self._reclaim_stale()
            finally:
                try:
                    os.unlink(tmp)
                except FileNotFoundError:
                    pass
        raise LockHeldError(f"lock {self.path} could not be acquired "
                            "(lost the reclaim race repeatedly)")

    def _reclaim_stale(self) -> None:
        """Unlink a stale lock under an flock-serialized critical section.
        A blind unlink races two concurrent reclaimers: the loser could
        delete the winner's FRESH lock and both would own the card.  The
        guard file serializes check-then-unlink; the re-read inside the
        section ensures we only ever delete a lock whose owner is dead."""
        import fcntl
        with open(self.path + ".guard", "w") as g:
            fcntl.flock(g, fcntl.LOCK_EX)
            owner = self._read_owner()
            if owner is None or self._owner_alive(owner):
                return              # vanished, or reclaimed-and-reacquired
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass

    def release(self) -> None:
        if self._owned:
            self._owned = False
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass

    def _read_owner(self):
        """Owner dict; {} for an unreadable/corrupt body; None when the
        file vanished (another process released or reclaimed it)."""
        try:
            with open(self.path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            return {}

    def _owner_alive(self, owner: dict) -> bool:
        pid = owner.get("pid")
        if not isinstance(pid, int):
            # our own locks are link-published with a complete body, so a
            # corrupt one is foreign/hand-made: fail safe, honor as live
            return True
        if owner.get("host") not in (None, socket.gethostname()):
            return True             # foreign host: cannot check, fail safe
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:
            return True             # exists, owned by someone else

    def __enter__(self) -> "SingleOwnerLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


# --------------------------------------------------------------------------
# atomic journal io (shared by the watcher's state file)
# --------------------------------------------------------------------------

def write_json_atomic(path: str, obj) -> None:
    """Write-then-rename so a crash mid-write can never leave a torn
    journal (the resume path reads this file first thing)."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        raise


def read_json(path: str, default=None):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return default
