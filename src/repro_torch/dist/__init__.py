"""Collective layer: the torrent aggregate + the FL step.

``torrent.py``  — ``torrent_fedavg``: chunked dissemination of per-pod
updates (optionally int8-compressed per block), then masked FedAvg; on
a mesh's ``pod`` axis a ring of P2P sends over ``torch.distributed``.

``fl_step.py``  — ``make_fl_train_step``: per-pod local gradients ->
torrent aggregate -> one AdamW update; ``ElasticFLStep``: the mesh and
step rebuilt per active pod count (§III-E); ``make_serve_step``: one
greedy decode step.
"""
from .fl_step import ElasticFLStep, make_fl_train_step, make_serve_step
from .torrent import take_pods, torrent_fedavg

__all__ = ["torrent_fedavg", "take_pods", "make_fl_train_step",
           "ElasticFLStep", "make_serve_step"]
