"""Small models for the FL learning-utility experiments, in PyTorch.

The paper trains GoogLeNet-scale CNNs on MNIST/CIFAR-10; for the
synthetic stand-ins a compact CNN and MLP suffice to reproduce the
*comparison* (CFL vs GossipDFL vs FLTorrent) — the dissemination layer
is model-agnostic by construction.

Port of the JAX package's ``fl/models_small.py`` with its parameter
layout: ``{"w", "b"}`` leaves, dense ``w`` of shape (fan_in, fan_out),
HWIO conv kernels and NHWC activations, so a JAX-initialised tree
(``repro_torch.interop.params_from_numpy``) runs here unchanged.
Initialisation draws from an explicit ``torch.Generator`` on the CPU
and then moves to the device, so a seed gives the same weights on
every device.  The law is the reference's (normal x sqrt(2 / fan_in),
zero biases, f32); ``jax.random``'s stream itself cannot be reproduced.

On the GPU, cuDNN runs f32 convolutions in TF32 unless told not to;
the JAX models compute in f32, so the runners call :func:`true_f32`
around a run (see there).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.tree import leaves as tree_leaves


@contextlib.contextmanager
def true_f32():
    """Run f32 matmuls and convolutions in f32, not TF32, and restore the
    caller's settings on exit.

    ``torch.backends.cudnn.allow_tf32`` is True by default, which would
    run the CNN's convolutions in TF32 on the card (a 10-bit mantissa);
    ``torch.backends.cuda.matmul.allow_tf32`` is False by default but a
    caller may have set it.  Both are process-wide flags, so this is a
    context, not a side effect of importing the module."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _normal(gen, shape, fan_in, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32)
    return (w * math.sqrt(2.0 / fan_in)).to(device)


def _dense_init(gen, fan_in, fan_out, device):
    return {"w": _normal(gen, (fan_in, fan_out), fan_in, device),
            "b": torch.zeros((fan_out,), dtype=torch.float32,
                             device=device)}


def init_cnn(gen: torch.Generator, input_shape, num_classes: int,
             device="cpu"):
    """3-block CNN: conv3x3(32) - conv3x3(64) - pool - dense."""
    h, w, c = input_shape
    params = {
        "conv1": {"w": _normal(gen, (3, 3, c, 32), 9 * c, device),
                  "b": torch.zeros((32,), dtype=torch.float32,
                                   device=device)},
        "conv2": {"w": _normal(gen, (3, 3, 32, 64), 9 * 32, device),
                  "b": torch.zeros((64,), dtype=torch.float32,
                                   device=device)},
    }
    flat = (h // 4) * (w // 4) * 64
    params["fc1"] = _dense_init(gen, flat, 128, device)
    params["fc2"] = _dense_init(gen, 128, num_classes, device)
    return params


def _same_pad(size: int, stride: int, k: int = 3) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: ceil(size / stride)
    outputs, the total split low-first, so the extra row or column goes
    to the high side ((0, 1) at size 28, 32 or 16 and stride 2)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def cnn_apply(params, x: torch.Tensor) -> torch.Tensor:
    """``x`` (N, H, W, C) NHWC; returns (N, classes) logits."""
    def conv(p, x, stride):                      # x NCHW
        hl, hh = _same_pad(x.shape[2], stride)
        wl, wh = _same_pad(x.shape[3], stride)
        y = F.conv2d(F.pad(x, (wl, wh, hl, hh)),
                     p["w"].permute(3, 2, 0, 1), stride=stride)
        return torch.relu(y + p["b"][:, None, None])

    x = x.permute(0, 3, 1, 2)
    x = conv(params["conv1"], x, 2)
    x = conv(params["conv2"], x, 2)
    # Flatten in NHWC order, as the reference's fc1 rows are laid out.
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def init_mlp(gen: torch.Generator, input_shape, num_classes: int,
             device="cpu"):
    d = int(np.prod(input_shape))
    return {"fc1": _dense_init(gen, d, 256, device),
            "fc2": _dense_init(gen, 256, 128, device),
            "fc3": _dense_init(gen, 128, num_classes, device)}


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    x = torch.relu(x @ params["fc2"]["w"] + params["fc2"]["b"])
    return x @ params["fc3"]["w"] + params["fc3"]["b"]


MODELS = {"cnn": (init_cnn, cnn_apply), "mlp": (init_mlp, mlp_apply)}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None].long()))


def accuracy(apply_fn, params, x, y, batch: int = 512) -> float:
    """Share of ``x`` classified as ``y``, in batches of ``batch``.

    ``x`` and ``y`` are numpy arrays or tensors; they are moved once to
    the parameters' device.  The correct counts add up on the device and
    are read once."""
    dev = tree_leaves(params)[0].device
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for i in range(0, len(y), batch):
            logits = apply_fn(params, x[i:i + batch])
            correct += (torch.argmax(logits, -1) == y[i:i + batch]).sum()
    return int(correct) / len(y)
