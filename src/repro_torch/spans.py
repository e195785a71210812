"""Spans of the port's layers: where the host's time goes in a sweep.

A span is a named interval of host time, stamped with ``time.time_ns()``:
the Unix-epoch clock on which ``torch.profiler`` reports its events, so
the spans and a profiler's trace of the same run share one clock. Each
record is ``(name, span id, parent id, sweep id, start ns, end ns)``; the
parent is the span that was innermost when this one opened (0: none),
and every span of one ``simulate_batch`` call carries that call's sweep
id (0 outside a sweep). Records stay in memory until :func:`take`.

The recorder follows ``torch.profiler`` by default, as
``torch.profiler.record_function`` does: it records while a profiler
runs and not otherwise, so a profiled run carries its spans with no
other switch. :func:`enable` makes it record always, :func:`disable`
never, :func:`follow_profiler` restores the default. Not recording, a
span costs a test of two flags and hands back one shared no-op object:
no tensor op, no host sync, no allocation. Recording, it never reads or
writes a tensor either, and keeps its records as plain ints and names,
which the garbage collector does not track. One thread records at a
time.

    with spans.span("driver.issue"):
        ...
    spans.phase("tick.1_control")   # closes the open phase, opens this one
    ...
    spans.phase(None)               # closes it

A phase marks a section of a long body without nesting it in a ``with``:
it closes the phase open on top of the stack, if any, and opens the
next. A span that closes closes the phases still open inside it.
"""
from __future__ import annotations

import time

import torch.autograd.profiler as _profiler

#: None: record while torch.profiler runs; True: always; False: never
_mode: "bool | None" = None
#: the closed spans, six values each, in the order they closed
_flat: list = []
#: the open spans, innermost last:
#: (name, id, parent, sweep, start, is phase, the sweep id outside it)
_stack: list = []
_next_id = 1
_sweep = 0
_next_sweep = 1


def enable() -> None:
    """Record every span from now on."""
    global _mode
    _mode = True


def disable() -> None:
    """Record no span from now on, profiler or not."""
    global _mode
    _mode = False


def follow_profiler() -> None:
    """Record while ``torch.profiler`` runs (the default)."""
    global _mode
    _mode = None


def take() -> list:
    """The closed spans' records, in the order they closed; clears them
    and forgets any span still open."""
    global _flat
    flat, _flat = _flat, []
    _stack.clear()
    return [tuple(flat[i:i + 6]) for i in range(0, len(flat), 6)]


def _open(name: str, is_phase: bool, new_sweep: bool = False) -> None:
    global _next_id, _sweep, _next_sweep
    outside = _sweep
    if new_sweep:
        _sweep, _next_sweep = _next_sweep, _next_sweep + 1
    _stack.append((name, _next_id, _stack[-1][1] if _stack else 0, _sweep,
                   time.time_ns(), is_phase, outside))
    _next_id += 1


def _close(depth: int) -> None:
    """Close the open spans above the first ``depth``, at one time."""
    global _sweep
    now = time.time_ns()
    while len(_stack) > depth:
        name, sid, parent, sweep, start, _, outside = _stack.pop()
        _flat.extend((name, sid, parent, sweep, start, now))
        _sweep = outside


class _Span:
    """The one recording context manager: spans nest as ``with`` blocks
    do, so its exit closes the innermost open span that is not a
    phase."""

    __slots__ = ("name", "new_sweep")

    def __enter__(self):
        _open(self.name, False, self.new_sweep)
        return self

    def __exit__(self, *exc):
        for k in range(len(_stack) - 1, -1, -1):
            if not _stack[k][5]:
                _close(k)
                break
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_SPAN = _Span()
_NO_SPAN = _NoSpan()


def span(name: str, new_sweep: bool = False):
    """A context manager that records ``name`` around its body (with
    ``new_sweep``, under a new sweep id)."""
    if not (_mode or (_mode is None and _profiler._is_profiler_enabled)):
        return _NO_SPAN
    _SPAN.name, _SPAN.new_sweep = name, new_sweep
    return _SPAN


def sweep():
    """The root span ``sweep`` of one ``simulate_batch`` call: the spans
    inside it carry a new sweep id."""
    return span("sweep", new_sweep=True)


def phase(name: "str | None") -> None:
    """Close the phase open on top of the stack, if any (recording or
    not, so none outlives its body), and open phase ``name`` (None: open
    none)."""
    if _stack and _stack[-1][5]:
        _close(len(_stack) - 1)
    if name is not None and (
            _mode or (_mode is None and _profiler._is_profiler_enabled)):
        _open(name, True)
