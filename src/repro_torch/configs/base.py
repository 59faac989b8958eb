"""Shape registry + per-cell skip logic for the assigned architectures.

Four input-shape sets (assignment):
    train_4k     seq 4096,   global_batch 256   -> train_step
    prefill_32k  seq 32768,  global_batch 32    -> prefill
    decode_32k   cache 32768, global_batch 128  -> serve_step
    long_500k    cache 524288, global_batch 1   -> serve_step (sub-quadratic
                                                   state only)

Skips (documented in DESIGN.md §4): encoder-only archs have no decode;
``long_500k`` runs only for archs whose state is bounded (xlstm,
recurrentgemma); pure full-attention archs skip it.
"""
from __future__ import annotations

from dataclasses import dataclass



@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Archs whose per-token state is bounded (recurrent / windowed-only):
SUBQUADRATIC = {"xlstm-350m", "recurrentgemma-2b"}
ENCODER_ONLY = {"hubert-xlarge"}


def cell_skip_reason(arch: str, shape: str) -> str | None:
    if arch in ENCODER_ONLY and shape in ("decode_32k", "long_500k"):
        return "encoder-only: no autoregressive decode step"
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return ("pure full-attention arch: 524288-token KV cache is not "
                "sub-quadratic state (DESIGN.md §4)")
    return None


def all_cells():
    """Yield (arch_id, shape_name, skip_reason) for the 40-cell grid."""
    from . import ARCHS
    for arch in ARCHS:
        for shape in SHAPES:
            yield arch, shape, cell_skip_reason(arch, shape)
