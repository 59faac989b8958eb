"""Hand-written Hopper kernels for the hot spots + dispatch (ops).

Kernels (each <name>.py = wrapper over csrc/<name>.cu; ref.py = the
plain versions):

* ``fedavg``    — masked FedAvg reduction over stacked client updates
                  (the paper's aggregation step, §II-B).
* ``quantize``  — per-chunk int8 quantize / dequantize (the torrent
                  collective's wire compression).

``LAUNCHES`` counts the launches of each kernel (see ``_build.py``).
"""
from . import fedavg, ops, quantize, ref
from ._build import LAUNCHES, reset_launches

__all__ = ["fedavg", "ops", "quantize", "ref", "LAUNCHES",
           "reset_launches"]
