"""The program's own spans: host intervals inside the port, timed on the
clock onto which ``torch.profiler`` puts the device's timestamps
(``time.time_ns``), so that one reader lays them over a device trace.

The recorder is off until :func:`enable` and keeps spans in memory only;
:func:`disable` turns it off and returns what it recorded.  While it is
off, :func:`span` returns one shared null context: it reads no clock and
keeps nothing.  A span's parent is the span open on the same thread when
it began: one stack a thread, since the autograd engine runs a backward's
device work on a thread of its own, whose spans must not nest under
whatever the caller's thread has open.

The spans of the program:

* ``sched.tick``: ``PipelinedScheduler.tick``;
* ``sched.decode`` (``rows``: the decoding slots): the whole decode
  dispatch of a tick (page mapping, the feed, ``decode_step``, the
  sampler);
* ``req.queued`` (``uid``): a request's wait from ``submit`` to its
  admission (closed by :func:`close`);
* ``train.step``: one train step, single-device or sharded;
* ``train.backward`` (``microbatch``): each ``loss.backward()`` of the
  gradient accumulation;
* ``train.adamw`` (``leaves``): the AdamW update, clipping included.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    start_ns: int
    end_ns: int
    name: str
    id: int
    parent_id: int | None
    thread_id: int
    attrs: dict


_OFF = contextlib.nullcontext()
_spans: list[Span] | None = None        # the recording, while on
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    """Start a fresh recording."""
    global _spans
    _spans = []


def disable() -> list[Span]:
    """Stop recording; returns the spans that closed while it was on, in
    the order they closed."""
    global _spans
    out, _spans = _spans, None
    return out if out is not None else []


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("name", "attrs", "id", "parent_id", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.parent_id = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        spans = _spans
        if spans is not None:
            spans.append(Span(self.start_ns, end, self.name, self.id, self.parent_id,
                              threading.get_ident(), self.attrs))
        return False


def span(name: str, **attrs):
    """``with span(name, **attrs): ...`` records the block as a span under
    the span open on this thread; it is kept if the recorder is on when
    the block ends."""
    if _spans is None:
        return _OFF
    return _Open(name, attrs)


def close(name: str, start_ns: int, **attrs) -> None:
    """Record a span from ``start_ns`` (``time.time_ns()``, kept by the
    caller) to now, only if the recorder is on now.  Its start lies
    outside this thread's stack of open spans, so it has no parent."""
    spans = _spans
    if spans is not None:
        spans.append(Span(start_ns, time.time_ns(), name, next(_ids), None,
                          threading.get_ident(), attrs))
