"""Train a (reduced) LM on the PyTorch port with the full FL round step:
local grads -> torrent dissemination -> masked FedAvg -> AdamW, with
round-boundary checkpointing and a resume from the latest checkpoint.

The torch counterpart of ``examples/train_lm_fl.py``, with its argv
flag for flag plus ``--device``, through ``repro_torch.launch.train``.
Its checkpoints go to a directory of their own (``CKPT``, emptied when
the example starts): the two packages' stores share one format, so the
JAX example's directory would resume this run from the JAX run's state.

    PYTHONPATH=src python examples/train_lm_fl_torch.py   # GPU
    PYTHONPATH=src python examples/train_lm_fl_torch.py --device cpu
"""
import argparse
import os
import shutil
import tempfile

from repro_torch import resolve_device
from repro_torch.launch.train import main as train_main

STEPS = 120
RESUME_STEPS = 140
CKPT = os.path.join(tempfile.gettempdir(), "fltorrent_torch_ckpt")
MAX_LOSS = 3.0


def _argv(steps: int, device: str) -> list:
    return ["--arch", "qwen3-1.7b", "--reduced",
            "--steps", str(steps), "--batch", "8", "--seq", "64",
            "--lr", "3e-3", "--ckpt", CKPT,
            "--ckpt-every", "40", "--log-every", "20",
            "--device", device]


def main(argv=None):
    """Returns the final losses of the run and of the resumed run."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain kernels")
    device = str(resolve_device(ap.parse_args(argv).device))
    shutil.rmtree(CKPT, ignore_errors=True)     # start fresh, then resume
    loss = train_main(_argv(STEPS, device))
    if not loss < MAX_LOSS:
        raise RuntimeError(f"training did not converge (loss {loss})")
    print(f"\nresuming from the latest checkpoint for "
          f"{RESUME_STEPS - STEPS} more steps "
          "(paper §III-E: rejoin at round boundary) ...")
    return loss, train_main(_argv(RESUME_STEPS, device))


if __name__ == "__main__":
    main()
