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

A fake tensor (``FakeTensorMode``: the dry run's stand-ins, which
claim a device but hold no data) has nothing to launch on: a wrapper
given one traces its plain version, which gives the outputs' shapes
and lets ``launch.cost_analysis`` count the work; no launch is counted
(``plain_route``).
"""
from __future__ import annotations

import collections
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("bindings.cpp", "fedavg.cu", "quantize.cu", "attention.cu",
           "rglru.cu", "mlstm.cu", "slots.cu", "fairshare.cu")
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


def plain_route(x) -> bool:
    """Whether a wrapper runs its plain version on ``x``: a CPU tensor,
    or a fake one."""
    if x.device.type == "cpu":
        return True
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x)


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs every tensor on "
                         f"one CUDA device, got {sorted(map(str, devs))}")
