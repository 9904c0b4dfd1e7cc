"""Spans of the program's phases: where a fit's host time goes.

A span names a phase of set-up or of the optimizer's host loop
(`vilma.pack`, `vilma.step`, `vilma.trial`, `vilma.fetch`, ...; the
table is in README.md). The recorder is off by default: `span()` then
checks one module global and returns a shared no-op context; it reads no
clock and makes no torch call. `fit --profile` turns it on for the
profiled fit.

When on, each span records (name, parent index, start_ns, end_ns) on
time.perf_counter_ns in an in-memory list (`records()`; the parent is
the index of the span open around it, None at the top). While a
torch.profiler records, the span also enters
torch.profiler.record_function(name), so it appears as a
`user_annotation` event in the profiler's trace, on the trace's clock,
around the ops and kernel launches of its phase.

A span closes when an exception passes through it (the exception goes
on). The recorder serves the thread that runs the fit: spans opened on
two threads at once would nest wrongly.
"""
import contextlib
import functools
import time

import torch

#: the context `span` returns while the recorder is off
NOOP = contextlib.nullcontext()

_on = False
_records = []       # [name, parent, start_ns, end_ns] per span, in order
_open = []          # indices of the spans open now, innermost last


class _Span:
    __slots__ = ('name', 'index', 'annotation')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.index = len(_records)
        _records.append([self.name, _open[-1] if _open else None,
                         time.perf_counter_ns(), None])
        _open.append(self.index)
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _records[self.index][3] = time.perf_counter_ns()
        _open.pop()
        return False


def span(name):
    """A context manager that records the phase `name` while on."""
    if not _on:
        return NOOP
    return _Span(name)


def spanned(name):
    """Decorator: every call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def enable():
    """Record spans from now on."""
    global _on
    _on = True


def disable():
    """Record no more spans (those open still close)."""
    global _on
    _on = False


def records():
    """The spans recorded so far, in the order they opened: tuples
    (name, parent index or None, start_ns, end_ns), end_ns None while
    the span is open."""
    return [tuple(r) for r in _records]


def clear():
    """Forget the recorded spans; raises while a span is open (its
    children would name a parent that is gone)."""
    if _open:
        raise RuntimeError(f'{len(_open)} span(s) still open')
    _records.clear()
