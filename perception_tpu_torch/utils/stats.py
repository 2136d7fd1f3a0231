"""Runtime statistics of one recognition (reference EnvStats,
utils/utils.h:114-120), with peak device memory from `torch.cuda`, and named
spans (`StageTimer`), which are also the process's tracing.

Tracing: the service, the env, the scorer and the search open spans at each
layer boundary through `span(name)`, per request, phase and batch (never per
candidate or pose). Each finished span is a `SpanRecord` on the clock of
`time.perf_counter_ns()`, the clock of `time.perf_counter()` (and of
`torch.profiler`'s host events), with its parent and request taken from the
opening thread's stack of open spans. The records go to `TRACE`, the
process's `StageTimer`, which keeps the last `REQUESTS_KEPT` requests and the
last `LOOSE_KEPT` spans opened outside any request; `TRACE.drain()` hands
over what finished since the last drain. While tracing is on, a `gc.callbacks`
hook records each collection of the garbage collector as a `gc` span under
the span open on the collecting thread (counters `generation`, `collected`).

Tracing is off unless `set_tracing(True)`: then `span()` is one global test
that returns a shared no-op context, reads no clock and allocates nothing,
and no `gc` hook is registered. Counters are set through the context's
`add(name, value)`; a site that computes a counter tests the context first
(`if sp:`), as the no-op context is false.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import itertools
import threading
import time

import torch

# Requests whose spans the trace buffer keeps (the oldest go first).
REQUESTS_KEPT = 256
# Finished spans outside any request kept, and finished spans not yet
# drained.
LOOSE_KEPT = 4096
FRESH_KEPT = 1 << 14


@dataclasses.dataclass
class EnvStats:
    scenes_rendered: int = 0
    scenes_valid: int = 0
    expands: int = 0
    time: float = 0.0           # total recognition seconds
    input_time: float = 0.0
    gpu_time: float = 0.0       # device dispatch seconds
    icp_time: float = 0.0
    cost: int = -1
    peak_device_mem_mb: float = 0.0

    def update_peak_memory(self, device: torch.device) -> None:
        """Raise peak_device_mem_mb to the allocator's peak on a CUDA
        device (no-op for the CPU)."""
        if device.type == "cuda":
            self.peak_device_mem_mb = max(
                self.peak_device_mem_mb,
                torch.cuda.max_memory_allocated(device) / 1e6)


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One span: nanoseconds of `time.perf_counter_ns()`, its id, its
    parent's id and its request's id (None outside one), integer counters,
    and string tags (the request's `mode`)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    request: int | None
    counters: dict[str, int]
    tags: dict[str, str]


class _Span:
    """An open span of a StageTimer: `add` sets a counter, `tag` a tag."""

    __slots__ = ("timer", "record")

    def __init__(self, timer: "StageTimer", record: SpanRecord):
        self.timer = timer
        self.record = record

    def add(self, name: str, value: int) -> None:
        c = self.record.counters
        c[name] = c.get(name, 0) + int(value)

    def tag(self, name: str, value: str) -> None:
        self.record.tags[name] = str(value)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.record.counters["error"] = 1
        self.timer._close(self.record)


class _NoSpan:
    """The shared context of every span site while tracing is off."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def add(self, name: str, value: int) -> None:
        pass

    def tag(self, name: str, value: str) -> None:
        pass

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NO_SPAN = _NoSpan()


class StageTimer:
    """Named spans: `with timer.span("render"): ...` adds the span's seconds
    to `spans[name]` and one to `counts[name]`, and records it
    (`SpanRecord`). Records of a request (a span opened with `request=`, and
    every span opened inside it on the same thread) are kept by request, the
    last `REQUESTS_KEPT`; others in their own bounded buffer."""

    def __init__(self):
        self.spans: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._by_request: collections.OrderedDict[
            int, list[SpanRecord]] = collections.OrderedDict()
        self._loose: collections.deque[SpanRecord] = collections.deque(
            maxlen=LOOSE_KEPT)
        self._fresh: collections.deque[SpanRecord] = collections.deque(
            maxlen=FRESH_KEPT)
        self._collections: collections.deque[SpanRecord] = (
            collections.deque())
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list[SpanRecord]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str, request: int | None = None,
              push: bool = True) -> SpanRecord:
        """A started record under the thread's innermost open span (pushed
        onto the thread's stack unless `push` is false)."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        if request is None and parent is not None:
            request = parent.request
        rec = SpanRecord(name, time.perf_counter_ns(), 0, next(self._ids),
                         parent.id if parent is not None else None,
                         request, {}, {})
        if push:
            stack.append(rec)
        return rec

    def span(self, name: str, request: int | None = None) -> _Span:
        """An open span; `request` makes it a request's root."""
        return _Span(self, self._open(name, request))

    def _close(self, rec: SpanRecord) -> None:
        rec.end_ns = time.perf_counter_ns()
        stack = self._stack()
        # Unwind to the record: a span left open inside it (a generator
        # never resumed) does not outlive it on the stack.
        while stack:
            if stack.pop() is rec:
                break
        self._finish(rec)

    def _finish(self, rec: SpanRecord) -> None:
        """Add a closed record to the totals and the buffers."""
        with self._lock:
            self._keep(rec)
            self._flush_collections()

    def _finish_later(self, rec: SpanRecord) -> None:
        """Hand over a closed record without taking the lock, for the
        garbage collector's hook: a collection can start inside `_finish`,
        on the thread that holds the lock. The next `_finish`, `drain`,
        `requests` or `loose` keeps it."""
        self._collections.append(rec)

    def _flush_collections(self) -> None:
        while self._collections:
            self._keep(self._collections.popleft())

    def _keep(self, rec: SpanRecord) -> None:
        self.spans[rec.name] = (self.spans.get(rec.name, 0.0)
                                + (rec.end_ns - rec.start_ns) / 1e9)
        self.counts[rec.name] = self.counts.get(rec.name, 0) + 1
        self._fresh.append(rec)
        if rec.request is None:
            self._loose.append(rec)
            return
        spans = self._by_request.get(rec.request)
        if spans is None:
            spans = self._by_request[rec.request] = []
            while len(self._by_request) > REQUESTS_KEPT:
                self._by_request.popitem(last=False)
        spans.append(rec)

    def open_spans(self) -> list[SpanRecord]:
        """The calling thread's open spans, outermost first."""
        return list(self._stack())

    def drain(self) -> list[SpanRecord]:
        """The spans finished since the last drain, in finishing order."""
        with self._lock:
            self._flush_collections()
            out = list(self._fresh)
            self._fresh.clear()
        return out

    def requests(self) -> list[dict]:
        """The kept requests, oldest first: {"request_id", "spans": [the
        records as dicts, in finishing order]}."""
        with self._lock:
            self._flush_collections()
            kept = [(rid, list(spans))
                    for rid, spans in self._by_request.items()]
        return [{"request_id": rid,
                 "spans": [dataclasses.asdict(r) for r in spans]}
                for rid, spans in kept]

    def loose(self) -> list[SpanRecord]:
        """The kept spans opened outside any request."""
        with self._lock:
            self._flush_collections()
            return list(self._loose)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.counts.clear()
            self._by_request.clear()
            self._loose.clear()
            self._fresh.clear()
            self._collections.clear()

    def summary(self) -> str:
        return " | ".join(
            f"{k}: {v:.3f}s/{self.counts[k]}" for k, v in self.spans.items())


# The process's tracing: the recorder every span site records into, and the
# switch each site tests.
TRACE = StageTimer()
_tracing = False
_request_ids = itertools.count(1)
_gc_open = threading.local()


def span(name: str, request: int | None = None):
    """A span of the process's trace (`TRACE.span`) while tracing is on,
    else the shared no-op context."""
    if not _tracing:
        return NO_SPAN
    return TRACE.span(name, request)


def next_request_id() -> int:
    """A request id unique in the process."""
    return next(_request_ids)


def tracing() -> bool:
    return _tracing


def set_tracing(on: bool) -> None:
    """Turn the process's tracing on or off; on, the garbage collector's
    passes are recorded as `gc` spans."""
    global _tracing
    on = bool(on)
    if on == _tracing:
        return
    _tracing = on
    if on:
        gc.callbacks.append(_on_gc)
    else:
        gc.callbacks.remove(_on_gc)


def _on_gc(phase: str, info: dict) -> None:
    """gc.callbacks hook: a `gc` span from "start" to "stop" under the span
    open on the collecting thread (not pushed: it has no children)."""
    if phase == "start":
        _gc_open.record = TRACE._open("gc", push=False)
        return
    rec = getattr(_gc_open, "record", None)
    if rec is None:
        return
    _gc_open.record = None
    rec.counters["generation"] = int(info.get("generation", -1))
    rec.counters["collected"] = int(info.get("collected", 0))
    rec.end_ns = time.perf_counter_ns()
    TRACE._finish_later(rec)
