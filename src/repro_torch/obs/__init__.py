"""repro_torch.obs — swarm telemetry.

A copy of the JAX package's ``obs``: an injectable :class:`Recorder` of
spans, events, flow batches and metrics, behind a module-level active
recorder that defaults to a :class:`NullRecorder` (every hook a no-op,
``enabled`` False), plus the JSONL / Perfetto exporters and the
``python -m repro_torch.obs report|validate|perfetto`` CLI.  The
recorder only observes: it draws no rng and never feeds back into
simulated time, so a round's schedule is the same with telemetry on or
off.  Rows, exports and reports are the JAX package's, field for field.
"""
from .recorder import (NullRecorder, Recorder, get, install, recording)
from .export import (read_jsonl, to_jsonl_rows, to_perfetto,
                     validate_rows, write_jsonl, write_perfetto)
from .report import summarize, format_report

__all__ = [
    "NullRecorder", "Recorder", "get", "install", "recording",
    "read_jsonl", "to_jsonl_rows", "to_perfetto", "validate_rows",
    "write_jsonl", "write_perfetto",
    "summarize", "format_report",
]
