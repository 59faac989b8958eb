"""Round-level checkpoint/restart: npz payload + JSON manifest.

Port of ``repro/checkpoint/store.py`` with the same on-disk format, so
a checkpoint written by the JAX package loads here and back:
``round_<idx:08d>.npz`` holds leaf ``i`` as raw bytes under
``leaf_<i>``, and ``round_<idx:08d>.json`` records each leaf's shape
and dtype name.  Leaves are numbered in ``jax.tree_util`` order
(``repro_torch.tree``), so the two packages agree on which array is
which.  Writes are atomic (tmp + rename) and ``keep`` bounds disk use.
``restore_or_init`` is the one entry point a launcher calls on
(re)start, as in the reference.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten

# every dtype both packages can spell, named as numpy (and ml_dtypes,
# for bfloat16 and the float8 types) spells it
_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    "float8_e4m3fnuz": torch.float8_e4m3fnuz,
    "float8_e5m2fnuz": torch.float8_e5m2fnuz,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint64": torch.uint64, "uint32": torch.uint32,
    "uint16": torch.uint16, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}
# dtypes that go to and from numpy bytes through a signed integer view
# of the same width (numpy has no bfloat16 or float8 of its own)
_VIEWS = {torch.bfloat16: torch.int16, torch.uint16: torch.int16,
          torch.uint32: torch.int32, torch.uint64: torch.int64,
          torch.float8_e4m3fn: torch.int8, torch.float8_e5m2: torch.int8,
          torch.float8_e4m3fnuz: torch.int8,
          torch.float8_e5m2fnuz: torch.int8}


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _TORCH_DTYPES:
        raise ValueError(f"checkpoint leaf of dtype {name!r}: the port "
                         f"knows {sorted(_TORCH_DTYPES)}")
    return _TORCH_DTYPES[name]


def _leaf_bytes(x) -> tuple[bytes, list, str]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"checkpoint leaf of dtype {t.dtype}: the "
                             f"port saves {sorted(_TORCH_DTYPES)}")
        name = _NAMES[t.dtype]
        t = t.view(_VIEWS.get(t.dtype, t.dtype))
        return t.numpy().tobytes(), list(x.shape), name
    a = np.asarray(x)
    return a.tobytes(), list(a.shape), str(a.dtype)


def _leaf_tensor(buf: np.ndarray, lm: dict) -> torch.Tensor:
    dt = _torch_dtype(lm["dtype"])
    view = _VIEWS.get(dt, dt)
    t = torch.from_numpy(np.frombuffer(buf.tobytes(),
                                       np.dtype(_NAMES[view])).copy())
    return t.view(dt).reshape(lm["shape"])


def save_checkpoint(ckpt_dir: str, round_idx: int, tree, *,
                    meta: dict | None = None, keep: int = 3) -> str:
    """Atomically write ``round_<idx>.npz`` + manifest; GC old rounds."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves, treedef = flatten(tree)
    arrays = {}
    leaf_meta = []
    for i, x in enumerate(leaves):
        raw, shape, name = _leaf_bytes(x)
        arrays[f"leaf_{i}"] = np.frombuffer(raw, np.uint8)
        leaf_meta.append({"shape": shape, "dtype": name})
    payload = {
        "round": round_idx,
        "treedef": repr(treedef),
        "n_leaves": len(leaves),
        "leaves": leaf_meta,
        "meta": meta or {},
    }
    base = os.path.join(ckpt_dir, f"round_{round_idx:08d}")
    # the suffix must end in .npz or np.savez appends one and the rename
    # would move an empty file (torn checkpoint)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, base + ".npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".json.tmp")
    os.close(fd)
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, base + ".json")
    _gc(ckpt_dir, keep)
    return base + ".npz"


def _gc(ckpt_dir: str, keep: int):
    rounds = sorted(_list_rounds(ckpt_dir))
    for r in rounds[:-keep] if keep > 0 else []:
        for ext in (".npz", ".json"):
            try:
                os.remove(os.path.join(ckpt_dir, f"round_{r:08d}{ext}"))
            except FileNotFoundError:
                pass


def _list_rounds(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(name[len("round_"):-len(".json")])
            for name in os.listdir(ckpt_dir)
            if name.startswith("round_") and name.endswith(".json")]


def latest_round(ckpt_dir: str) -> int | None:
    rounds = _list_rounds(ckpt_dir)
    return max(rounds) if rounds else None


def load_checkpoint(ckpt_dir: str, round_idx: int, like_tree):
    """Restore into the structure of ``like_tree``: each leaf takes the
    dtype, shape and device of its counterpart there."""
    base = os.path.join(ckpt_dir, f"round_{round_idx:08d}")
    with open(base + ".json") as f:
        manifest = json.load(f)
    with np.load(base + ".npz") as z:
        raw = [z[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    like_leaves, treedef = flatten(like_tree)
    if len(raw) != len(like_leaves):
        raise ValueError(f"checkpoint holds {len(raw)} leaves, the tree "
                         f"{len(like_leaves)}")
    out = [_leaf_tensor(buf, lm).to(device=l.device, dtype=l.dtype)
           .reshape(l.shape)
           for buf, lm, l in zip(raw, manifest["leaves"], like_leaves)]
    return unflatten(treedef, out), manifest["meta"]


def restore_or_init(ckpt_dir: str, init_fn: Callable[[], tuple], *,
                    like_fn: Callable | None = None):
    """Resume from the latest round if one exists, else initialise.

    ``init_fn() -> (tree, meta)``.  Returns ``(tree, meta,
    start_round)``: ``init_fn``'s tree and meta and round 0 when
    ``ckpt_dir`` holds no checkpoint, else round r's tree (cast into the
    structure of ``init_fn``'s), its meta and r + 1.  ``like_fn`` is
    accepted for the reference's signature, which ignores it too.
    """
    r = latest_round(ckpt_dir)
    if r is None:
        tree, meta = init_fn()
        return tree, meta, 0
    like, _ = init_fn()
    tree, meta = load_checkpoint(ckpt_dir, r, like)
    return tree, meta, r + 1
