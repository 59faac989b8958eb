"""Round-level checkpoint/restart: npz payload + JSON manifest.

Port of ``repro/checkpoint/store.py`` with the same on-disk format, so
a checkpoint written by the JAX package loads here and back:
``round_<idx:08d>.npz`` holds leaf ``i`` as raw bytes under
``leaf_<i>``, and ``round_<idx:08d>.json`` records each leaf's shape
and dtype name.  Leaves are numbered in ``jax.tree_util`` order
(``repro_torch.tree``), so the two packages agree on which array is
which.  Writes are atomic (tmp + rename) and ``keep`` bounds disk use.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten

# dtype names as numpy (and ml_dtypes, for bfloat16) spell them
_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _leaf_bytes(x) -> tuple[bytes, list, str]:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = _NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes(), list(x.shape), name
    a = np.asarray(x)
    return a.tobytes(), list(a.shape), str(a.dtype)


def _leaf_tensor(buf: np.ndarray, lm: dict) -> torch.Tensor:
    dt = _TORCH_DTYPES[lm["dtype"]]
    raw = buf.tobytes()
    if dt == torch.bfloat16:
        t = torch.from_numpy(np.frombuffer(raw, np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, np.dtype(lm["dtype"])).copy())
    return t.reshape(lm["shape"])


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
