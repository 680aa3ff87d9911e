"""Process-environment helpers for the launch entry points (port of
``repro/launch/env.py``).

``LD_PRELOAD`` takes effect only at process start, so a launcher that
wants tcmalloc composes it for its children, respects anything the user
already exported, and never crashes when the library is missing from
the image:

* :func:`find_tcmalloc` / :func:`tcmalloc_env` — locate ``libtcmalloc``
  in the usual distro paths and build the ``LD_PRELOAD`` +
  allocation-report-threshold pair.  For an already-running process the
  helper is advisory: :func:`apply` exports it for *child* processes.
* :func:`add_env_args` / :func:`apply_env_args` — argparse glue
  (``--tcmalloc``) for a launcher that starts worker processes.  The
  port's ``launch/serve.py`` and ``launch/train.py`` do not take it: they
  run their work in their own process, where a preload exported after
  start has no effect (the reference's ``apply`` also set ``XLA_FLAGS``,
  which its own process did read).

The reference's other helpers have no torch meaning and are left out:
``xla_flags`` composes ``XLA_FLAGS``, which only XLA reads; ``enable_x64``
flips JAX's 64-bit mode, where torch takes each tensor's dtype as given;
their flags ``--x64``, ``--host-devices`` (fake host devices for XLA;
the port's multi-rank runs are processes under ``torchrun``) and
``--xla-preset`` go with them.  Everything degrades to a no-op on
missing files.
"""

from __future__ import annotations

import argparse
import glob
import os
import warnings

_TCMALLOC_GLOBS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc*.so*",
    "/usr/lib/aarch64-linux-gnu/libtcmalloc*.so*",
    "/usr/lib64/libtcmalloc*.so*",
    "/usr/lib/libtcmalloc*.so*",
)


def find_tcmalloc() -> str | None:
    """Path to a ``libtcmalloc`` shared object, or None if absent."""
    for pattern in _TCMALLOC_GLOBS:
        hits = sorted(glob.glob(pattern))
        if hits:
            return hits[0]
    return None


def tcmalloc_env() -> dict[str, str]:
    """Env pairs that preload tcmalloc (empty dict when unavailable),
    with the large-alloc report threshold so multi-GB host arenas don't
    spam warnings."""
    lib = find_tcmalloc()
    if lib is None:
        return {}
    preload = os.environ.get("LD_PRELOAD", "")
    if lib not in preload.split(":"):
        preload = f"{preload}:{lib}".strip(":")
    return {"LD_PRELOAD": preload,
            "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000"}


def apply(env: dict[str, str]) -> dict[str, str]:
    """Export ``env`` into ``os.environ``; returns what actually changed.
    ``LD_PRELOAD`` set after process start reaches child processes only."""
    changed: dict[str, str] = {}
    for k, v in env.items():
        if os.environ.get(k) == v:
            continue
        os.environ[k] = v
        changed[k] = v
    return changed


# .. argparse glue shared by the launchers ..

def add_env_args(ap: argparse.ArgumentParser) -> None:
    g = ap.add_argument_group("environment")
    g.add_argument("--tcmalloc", action="store_true",
                   help="preload libtcmalloc for child processes")


def apply_env_args(args: argparse.Namespace) -> dict[str, str]:
    """Apply the ``add_env_args`` flags; returns the changed env pairs."""
    env: dict[str, str] = {}
    if args.tcmalloc:
        tc = tcmalloc_env()
        if not tc:
            warnings.warn("libtcmalloc not found; skipping preload",
                          stacklevel=2)
        env.update(tc)
    return apply(env)
