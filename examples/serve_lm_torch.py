"""Serve a (reduced) LM on the PyTorch port: batched prefill + greedy
KV-cache decode, through ``repro_torch.launch.serve``.

The torch counterpart of ``examples/serve_lm.py``, with its two argv
lists flag for flag plus ``--device``.  On the card the prefill and
decode of gemma2-2b run the ``flash_attention`` kernel, and
recurrentgemma-2b's also the ``rglru_scan`` kernel; for CPU tensors
the wrappers run their plain versions.

    PYTHONPATH=src python examples/serve_lm_torch.py   # GPU
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse

from repro_torch import resolve_device
from repro_torch.launch.serve import main as serve_main

SERVES = (
    ["--arch", "gemma2-2b", "--reduced", "--batch", "4",
     "--prompt-len", "32", "--gen", "16"],
    ["--arch", "recurrentgemma-2b", "--reduced", "--batch", "2",
     "--prompt-len", "24", "--gen", "8"],
)


def main(argv=None):
    """Returns each serve's generated tokens, (batch, gen) int32."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain kernels")
    device = str(resolve_device(ap.parse_args(argv).device))
    return [serve_main(serve + ["--device", device]) for serve in SERVES]


if __name__ == "__main__":
    main()
