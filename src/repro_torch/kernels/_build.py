"""Build and load the CUDA kernels; count their launches.

The sources under ``csrc/`` are compiled at first use, and only when a
CUDA tensor needs a kernel, with ``torch.utils.cpp_extension.load``
into ``build/torch_kernels/`` at the repository root (``.gitignore``
lists ``build/``).  Importing this module compiles nothing, so the
package imports where there is no ``nvcc``.  A failed build raises;
nothing falls back to the plain versions.

``LAUNCHES`` counts, per kernel, the calls in which its wrapper
launched it on the card; ``chip_smoke.py`` resets it before driving
the train step and reads it after, to show the step ran the kernels.
"""
from __future__ import annotations

import collections
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("bindings.cpp", "fedavg.cu", "quantize.cu", "attention.cu",
           "rglru.cu", "mlstm.cu")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

LAUNCHES: collections.Counter = collections.Counter()

_ext = None


def reset_launches() -> None:
    LAUNCHES.clear()


def extension():
    """The compiled extension module, built on the first call."""
    global _ext
    if _ext is None:
        from torch.utils.cpp_extension import load
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _ext = load(name="repro_torch_kernels",
                    sources=[str(CSRC / s) for s in SOURCES],
                    extra_include_paths=[str(CSRC)],
                    extra_cflags=["-O3"],
                    extra_cuda_cflags=CUDA_FLAGS,
                    build_directory=str(BUILD_DIR))
    return _ext


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs every tensor on "
                         f"one CUDA device, got {sorted(map(str, devs))}")
