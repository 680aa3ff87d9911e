"""Run a reference (JAX) script in a fresh process for the port's parity
tests, with an environment that does not depend on the test worker's.

The child sees only a fixed set of variables: ``PATH``, ``HOME``, the
repo's ``src`` on ``PYTHONPATH``, ``JAX_PLATFORMS=cpu``, one OpenMP thread
and XLA's CPU client on one thread (``XLA_FLAGS``), so that its reduction
order is the same on every machine and whatever the worker inherited.
Its result is the JSON object on its last stdout line that starts with
``RESULT``; a failure names the return code and the tails of both
streams.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TAG = "RESULT "


def ref_env() -> dict:
    """The child's whole environment."""
    env = {"PYTHONPATH": os.path.abspath(SRC), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"}
    for k in ("PATH", "HOME"):
        if k in os.environ:
            env[k] = os.environ[k]
    return env


def start(script: str, argv=()) -> subprocess.Popen:
    """Start ``python -c script *argv`` under :func:`ref_env`."""
    return subprocess.Popen([sys.executable, "-c", script, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, stdin=subprocess.PIPE, text=True,
                            env=ref_env())


def tail(text: str, n: int = 3000) -> str:
    return text[-n:] if len(text) > n else text


def finish(proc: subprocess.Popen, stdin: str | None = None, timeout: float = 300):
    """Hand ``stdin`` to ``proc``, wait for it and return its tagged JSON
    result; raise AssertionError with the return code and the streams'
    tails if it failed or printed no result."""
    try:
        stdout, stderr = proc.communicate(stdin, timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
        raise AssertionError(f"reference process timed out after {timeout} s; stderr tail:\n"
                             f"{tail(stderr)}") from None
    lines = [ln for ln in stdout.splitlines() if ln.startswith(TAG)]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"reference process failed: return code {proc.returncode}; "
                             f"stdout tail:\n{tail(stdout)}\nstderr tail:\n{tail(stderr)}")
    return json.loads(lines[-1][len(TAG):])


def run(script: str, argv=(), stdin: str | None = None, timeout: float = 300):
    """:func:`start` then :func:`finish`."""
    return finish(start(script, argv), stdin, timeout)


def first_difference(got: dict, want: dict, label: str = "") -> str | None:
    """The first uid and position where two {uid: token list} streams
    differ, with both tokens, or None when they are equal."""
    if set(got) != set(want):
        return f"{label}uids {sorted(got)} != {sorted(want)}"
    for uid in sorted(want):
        a, b = got[uid], want[uid]
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return f"{label}uid {uid} position {i}: port {x}, reference {y}"
        if len(a) != len(b):
            return f"{label}uid {uid}: port {len(a)} tokens, reference {len(b)}"
    return None
