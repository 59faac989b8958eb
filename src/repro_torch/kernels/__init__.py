"""Hand-written Hopper kernels for the hot spots + dispatch (ops).

Kernels (each <name>.py = wrapper over csrc/<name>.cu; ref.py = the
plain versions):

* ``fedavg``    — masked FedAvg reduction over stacked client updates
                  (the paper's aggregation step, §II-B).
* ``quantize``  — per-chunk int8 quantize / dequantize (the torrent
                  collective's wire compression).
* ``attention`` — flash attention forward with causal / window /
                  softcap / GQA and decode-cache offsets (serving).
* ``rglru``     — the RG-LRU linear recurrence (recurrentgemma).
* ``mlstm``     — the chunkwise-parallel mLSTM from a zero state
                  (xLSTM prefill).
* ``slots``     — the GPU slot engine's bitplane kernels (stage-1
                  planes, overlap rank counts, ranked extraction); no
                  TPU kernel's counterpart (``core/jit_engine.py``).
* ``fairshare`` — the event engine's max-min solve and transport
                  segment loop, one launch a call; no TPU kernel's
                  counterpart (``net/fairshare.py``).

``LAUNCHES`` counts the launches of each kernel (see ``_build.py``).
"""
from . import (attention, fairshare, fedavg, mlstm, ops, quantize, ref,
               rglru, slots)
from ._build import LAUNCHES, reset_launches

__all__ = ["attention", "fairshare", "fedavg", "mlstm", "ops", "quantize",
           "ref", "rglru", "slots", "LAUNCHES", "reset_launches"]
