"""Assigned-architecture registry: ``--arch <id>`` resolves here."""
from . import (base, chameleon_34b, deepseek_7b, gemma2_2b, gemma3_4b,
               granite_moe_1b, hubert_xlarge, olmoe_1b_7b,
               qwen3_1_7b, recurrentgemma_2b, xlstm_350m)
from .base import SHAPES, ShapeSpec, all_cells, cell_skip_reason

_MODULES = {
    "gemma2-2b": gemma2_2b,
    "qwen3-1.7b": qwen3_1_7b,
    "gemma3-4b": gemma3_4b,
    "deepseek-7b": deepseek_7b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "xlstm-350m": xlstm_350m,
    "recurrentgemma-2b": recurrentgemma_2b,
    "hubert-xlarge": hubert_xlarge,
    "chameleon-34b": chameleon_34b,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, *, reduced: bool = False):
    mod = _MODULES[arch]
    return mod.REDUCED if reduced else mod.CONFIG


__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_config", "all_cells",
           "cell_skip_reason"]
