"""Recorder: the write side of repro_torch.obs.

A copy of the JAX package's ``obs/recorder.py``; the port records the
same rows under the same names.

Event model — every record is one flat dict ("row") with a ``kind``:

``span``    a named interval.  Wall duration (``wall_s``) is measured
            by the recorder's injectable clock when used as a context
            manager (``with rec.span("warmup"):``); simulated bounds
            (``t0``/``t1``, seconds on the session wall clock) are
            attached via :meth:`Recorder.span_at` for phases whose
            extent lives in simulated time.
``event``   a named instant, optionally at simulated time ``t``.
``flows``   a columnar batch of transport flows on one track
            (``warmup`` / ``bt`` / ``background`` / ``spray``): aligned
            ``src`` / ``dst`` / ``t_start`` / ``t_end`` lists plus any
            extra aligned columns — per-flow granularity, not
            per-chunk, so recordings stay tractable at paper scale.
``metric``  the registry snapshot, emitted at export time: one row per
            counter (sum), gauge (last value), or histogram (all
            observations).

A *region* (:meth:`Recorder.region`, the port's own addition, used by
the FL round) is a ``span`` row that ``torch.profiler`` and the device
can see: while open it is a ``record_function`` annotation, so a
profiler trace shows it on the kernels' clock; with ``device=True`` it
also records a CUDA event pair on the current stream, and
:meth:`Recorder.resolve` sets its ``device_ms`` once the caller has
synchronised.  Its row adds ``id``, ``parent`` (the id of the region
open around it, on any thread) and ``round`` (the id of the enclosing
``round=True`` region, whose row also counts ``host_syncs`` and
``alloc_retries``).  While a region is open, garbage collections are
``py.gc`` regions.  Spans, events and flows keep the JAX package's
fields; only region rows carry the new ones.

Simulated instants (``t``, ``t0``, ``t1``, ``t_start``, ``t_end``) are
shifted by ``time_base`` at record time; wall durations are not.
"""
from __future__ import annotations

import contextlib
import gc
import warnings

import numpy as np

# Keys whose values are simulated instants: shifted by ``time_base`` so
# multi-round recordings share the session wall clock.
_TIME_KEYS = ("t", "t0", "t1", "t_start", "t_end")


def _zero_clock() -> float:
    return 0.0


class _NullSpan:
    """No-op span handle (shared singleton)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs):
        pass


_NULL_SPAN = _NullSpan()

# What torch's sync debug mode warns (``TORCH_WARN``) at each
# synchronising CUDA call.
SYNC_WARNING = "called a synchronizing CUDA operation"


class NullRecorder:
    """Disabled telemetry: every hook is a no-op.

    This is the default active recorder — the zero-overhead-when-
    disabled contract is a single attribute load plus an empty method
    call at each instrumentation site (bounded by the overhead
    micro-test in ``tests/test_obs.py``).
    """

    enabled = False
    time_base = 0.0

    def set_ctx(self, **attrs):
        pass

    def span(self, name, **attrs):
        return _NULL_SPAN

    def region(self, name, *, device=False, round=False, **attrs):
        return _NULL_SPAN

    def span_at(self, name, t0, t1, **attrs):
        pass

    def event(self, name, t=None, **attrs):
        pass

    def counter(self, name, value=1.0, **attrs):
        pass

    def gauge(self, name, value, **attrs):
        pass

    def hist(self, name, values, **attrs):
        pass

    def flows(self, track, src, dst, t_start, t_end, **cols):
        pass


class _Span:
    """Live span handle: measures wall time between enter and exit on
    the owning recorder's injectable clock, then appends one row."""

    __slots__ = ("_rec", "name", "attrs", "_w0")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self._w0 = 0.0

    def __enter__(self):
        self._w0 = self._rec.clock()
        return self

    def note(self, **attrs):
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        wall = self._rec.clock() - self._w0
        self._rec._append(dict(kind="span", name=self.name,
                               wall_s=float(wall), **self.attrs))
        return False


class _SyncCount:
    """Synchronising CUDA calls made while open: torch's sync debug mode
    set to warn, and its warnings counted, not shown (the autograd
    engine replays those its device threads raise on the thread that
    called backward); other warnings are shown as before.  The mode and
    the warning filters are restored on exit."""

    __slots__ = ("n", "_mode", "_catch")

    def __enter__(self):
        import torch
        self.n = 0
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        shown = warnings.showwarning

        def count(message, category, filename, lineno, file=None,
                  line=None):
            if str(message).startswith(SYNC_WARNING):
                self.n += 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = count
        self._mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(self._mode)
        self._catch.__exit__(*exc)
        return False


class _Region:
    """Live region handle (``Recorder.region``): a wall-clocked span
    that is also a profiler annotation and, with ``device``, a CUDA
    event pair on the current stream."""

    __slots__ = ("_rec", "name", "attrs", "_device", "_is_round", "id",
                 "parent", "round", "_outer_round", "_rf", "_ev", "_syncs",
                 "_retries", "_w0")

    def __init__(self, rec: "Recorder", name: str, device: bool,
                 is_round: bool, attrs: dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self._device = device
        self._is_round = is_round

    def __enter__(self):
        # torch is imported here, not with the module: the swarm's
        # paths, which record no region, import nothing more through it
        import torch
        rec = self._rec
        self.id = rec._next_id
        rec._next_id += 1
        self.parent = rec._open[-1] if rec._open else None
        if self._is_round:
            self._outer_round, rec._round = rec._round, self.id
        self.round = rec._round
        rec._open.append(self.id)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        cuda = ((self._device or self._is_round)
                and torch.cuda.is_initialized())
        self._syncs = self._retries = self._ev = None
        if self._is_round and cuda:
            self._syncs = _SyncCount().__enter__()
            self._retries = _alloc_retries(torch)
        if self._device and cuda:
            self._ev = torch.cuda.Event(enable_timing=True)
            self._ev.record()
        self._w0 = rec.clock()
        return self

    def __exit__(self, *exc):
        import torch
        rec = self._rec
        wall = rec.clock() - self._w0
        row = dict(kind="span", name=self.name, id=self.id,
                   round=self.round, parent=self.parent,
                   wall_s=float(wall), **self.attrs)
        if self._ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec._timed.append((row, self._ev, end))
        if self._is_round:
            row["host_syncs"] = 0
            if self._syncs is not None:
                self._syncs.__exit__(*exc)
                row["host_syncs"] = self._syncs.n
                row["alloc_retries"] = (_alloc_retries(torch)
                                        - self._retries)
            rec._round = self._outer_round
        self._rf.__exit__(*exc)
        rec._open.remove(self.id)
        rec._append(row)
        return False


def _alloc_retries(torch) -> int:
    """The caching allocator's retries so far on the current device:
    allocations that failed until every cached block was released."""
    return int(torch.cuda.memory_stats().get("num_alloc_retries", 0))


class Recorder:
    """Enabled telemetry sink.

    ``clock`` is the wall-clock source behind context-manager spans —
    injectable exactly like ``core.simulator.set_clock`` (benchmarks
    pass ``time.perf_counter``); the default constant zero clock keeps
    recordings deterministic and core RNG007-clean.  ``meta`` is an
    arbitrary JSON-able dict stamped into the header row.
    """

    enabled = True

    def __init__(self, clock=None, meta: dict | None = None):
        self.clock = clock if clock is not None else _zero_clock
        self.meta = dict(meta or {})
        self.rows: list[dict] = []
        self.metrics: dict[str, dict] = {}
        # Session wall-clock offset added to simulated instants at
        # record time (SwarmSession sets this to offsets[-1] per round).
        self.time_base = 0.0
        # Ambient attributes merged into every row (e.g. round=r).
        self._ctx: dict = {}
        self._seq = 0
        # Regions: the next id, the ids open (innermost last; one stack
        # for every thread, since a round's host side runs one thread at
        # a time: the caller waits while autograd's device thread runs
        # the backward), the open round, the garbage collection in
        # progress, and the device-timed rows awaiting ``resolve``.
        self._next_id = 0
        self._open: list[int] = []
        self._round: int | None = None
        self._gc: _Region | None = None
        self._timed: list = []

    # -- plumbing -------------------------------------------------------
    def set_ctx(self, **attrs):
        """Merge ambient attributes into every subsequent row (a value
        of ``None`` removes the key)."""
        for k, v in attrs.items():
            if v is None:
                self._ctx.pop(k, None)
            else:
                self._ctx[k] = v

    def _append(self, row: dict):
        if self._ctx:
            row = {**self._ctx, **row}
        base = self.time_base
        if base:
            for k in _TIME_KEYS:
                v = row.get(k)
                if v is not None:
                    row[k] = (np.asarray(v, np.float64) + base
                              if isinstance(v, np.ndarray) else
                              float(v) + base)
        row["seq"] = self._seq
        self._seq += 1
        self.rows.append(row)

    # -- spans ----------------------------------------------------------
    def span(self, name: str, **attrs) -> _Span:
        """Wall-clocked span: ``with rec.span("warmup", round=r): ...``"""
        return _Span(self, name, attrs)

    def region(self, name: str, *, device: bool = False,
               round: bool = False, **attrs) -> _Region:
        """A span that ``torch.profiler`` sees (and, with ``device``, the
        stream times): ``with rec.region("fl.forward", device=True):``.
        ``round=True`` makes it the ``round`` of the regions inside and
        counts, on a CUDA process, ``host_syncs`` and ``alloc_retries``
        on its row (``host_syncs`` is 0 where CUDA is not in use)."""
        return _Region(self, name, device, round, attrs)

    def resolve(self) -> None:
        """Set ``device_ms`` on the rows of the device-timed regions
        closed so far.  Call once the device has synchronised: the
        recorder itself never waits for it."""
        for row, a, b in self._timed:
            row["device_ms"] = float(a.elapsed_time(b))
        self._timed.clear()

    def span_at(self, name: str, t0: float, t1: float, **attrs):
        """Post-hoc span over SIMULATED time ``[t0, t1]`` (seconds on
        the session wall clock after the ``time_base`` shift); pass
        ``wall_s=`` for the host-time cost of producing it."""
        self._append(dict(kind="span", name=name, t0=float(t0),
                          t1=float(t1), **attrs))

    # -- instants -------------------------------------------------------
    def event(self, name: str, t: float | None = None, **attrs):
        row = dict(kind="event", name=name, **attrs)
        if t is not None:
            row["t"] = float(t)
        self._append(row)

    # -- metrics registry ----------------------------------------------
    def counter(self, name: str, value: float = 1.0, **attrs):
        m = self.metrics.get(name)
        if m is None:
            self.metrics[name] = m = {"metric": "counter", "value": 0.0}
        m["value"] += float(value)

    def gauge(self, name: str, value: float, **attrs):
        self.metrics[name] = {"metric": "gauge", "value": float(value)}

    def hist(self, name: str, values, **attrs):
        m = self.metrics.get(name)
        if m is None:
            self.metrics[name] = m = {"metric": "hist", "values": []}
        if np.isscalar(values):
            m["values"].append(float(values))
        else:
            m["values"].extend(float(v) for v in np.asarray(values).ravel())

    # -- flow batches ---------------------------------------------------
    def flows(self, track: str, src, dst, t_start, t_end, **cols):
        """One columnar batch of transport flows on ``track``; all
        arguments are aligned 1-d arrays.  Non-finite end stamps (dead
        zero-rate flows) are recorded as-is minus inf -> the exporter
        clamps; callers should prefer pre-filtering."""
        src = np.asarray(src, np.int64)
        if src.size == 0:
            return
        row = dict(kind="flows", track=str(track), n=int(src.size),
                   src=src, dst=np.asarray(dst, np.int64),
                   t_start=np.asarray(t_start, np.float64),
                   t_end=np.asarray(t_end, np.float64))
        for k, v in cols.items():
            row[k] = np.asarray(v)
        self._append(row)


# -- module-level active recorder ---------------------------------------
_active: NullRecorder | Recorder = NullRecorder()


def get():
    """The active recorder (a NullRecorder unless one is installed)."""
    return _active


def _gc_region(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a collection while a region is open is a
    ``py.gc`` region (host time the device may sit idle through)."""
    rec = _active
    if phase == "start":
        if isinstance(rec, Recorder) and rec._open and rec._gc is None:
            rec._gc = rec.region("py.gc", generation=info["generation"])
            rec._gc.__enter__()
    elif getattr(rec, "_gc", None) is not None:
        g, rec._gc = rec._gc, None
        g.__exit__(None, None, None)


def install(rec):
    """Install ``rec`` as the active recorder (``None`` restores the
    null recorder); returns the previously active one.  The ``py.gc``
    hook is in ``gc.callbacks`` only while a Recorder is installed."""
    global _active
    prev = _active
    _active = rec if rec is not None else NullRecorder()
    hooked = _gc_region in gc.callbacks
    if isinstance(_active, Recorder):
        if not hooked:
            gc.callbacks.append(_gc_region)
    elif hooked:
        gc.callbacks.remove(_gc_region)
    return prev


@contextlib.contextmanager
def recording(rec: Recorder | None = None, *, clock=None,
              meta: dict | None = None):
    """Scoped recording: install a recorder (a fresh one by default),
    yield it, and ALWAYS restore the previous recorder on exit —
    telemetry can never leak into subsequent determinism-sensitive
    code even if the recorded block raises."""
    if rec is None:
        rec = Recorder(clock=clock, meta=meta)
    prev = install(rec)
    try:
        yield rec
    finally:
        install(prev)
