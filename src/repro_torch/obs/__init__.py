"""repro_torch.obs — swarm telemetry, the recorder half.

A copy of the write side of the JAX package's ``obs``: an injectable
:class:`Recorder` of spans, events, flow batches and metrics, behind a
module-level active recorder that defaults to a :class:`NullRecorder`
(every hook a no-op, ``enabled`` False).  The recorder only observes:
it draws no rng and never feeds back into simulated time, so a round's
schedule is the same with telemetry on or off.

The JSONL / Perfetto exporters and the report CLI (the JAX package's
``obs/export.py``, ``obs/report.py``) wait for a later slice
(ROADMAP.md queue 1 item 3).
"""
from .recorder import NullRecorder, Recorder, get, install, recording

__all__ = ["NullRecorder", "Recorder", "get", "install", "recording"]
