"""PyTorch/CUDA port of the FLTorrent federated train step.

Mirrors the layout of the JAX package ``repro`` module by module, so
each module here has its counterpart under ``src/repro/``.  The port
imports torch, numpy and the standard library only: never jax, never a
module of ``repro``.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
with no GPU present and no explicit device they raise instead of
falling back to the CPU (``resolve_device``).
"""
from __future__ import annotations


def resolve_device(device=None) -> "torch.device":
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when CUDA is asked for (explicitly or by default) and no GPU
    is present; the CPU is used only when the caller names it.
    """
    # torch is imported here, not at the top, so that the stdlib-only
    # ``repro_torch.analysis`` imports without it.
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev
