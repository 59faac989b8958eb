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

Simulated instants (``t``, ``t0``, ``t1``, ``t_start``, ``t_end``) are
shifted by ``time_base`` at record time; wall durations are not.
"""
from __future__ import annotations

import contextlib

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


def install(rec):
    """Install ``rec`` as the active recorder (``None`` restores the
    null recorder); returns the previously active one."""
    global _active
    prev = _active
    _active = rec if rec is not None else NullRecorder()
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
