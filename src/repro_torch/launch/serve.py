"""Batched serving driver: prefill a prompt batch, decode greedily.

Port of ``repro/launch/serve.py`` with the same CLI plus ``--device``
(default ``cuda``; with no GPU present the driver raises unless
``--device cpu`` is given).

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
        --arch olmoe-1b-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --full --batch 8 --prompt-len 8192 --gen 32

Every causal arch of ``repro_torch.configs`` serves: the attention
archs (gemma2-2b, gemma3-4b, qwen3-1.7b, ...), the moe archs
(olmoe-1b-7b, granite-moe-1b-a400m: global attention, a top-k MoE FFN
in plain PyTorch), recurrentgemma-2b and xlstm-350m.

It serves with ``attn_impl="pallas"`` and ``rnn_impl="pallas"``, the
JAX package's names for its kernels, which the port maps to its CUDA
kernels (``flash_attention``, ``rglru_scan``, ``mlstm_chunkwise``): on
the card the kernels are the serving path, and for CPU tensors the
wrappers run their plain versions.  That is the one difference from
the JAX driver, which serves with the config's own impls.  Parameters come from a
``torch.Generator`` seeded with 0 and the prompts from
``np.random.default_rng(0)``; ``jax.random`` cannot be reproduced in
torch, so the tokens differ from the JAX driver's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def serving_config(arch: str, reduced: bool):
    """The arch's config with the kernels selected, as served here."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, reduced=reduced)
    return cfg.replace(attn_impl="pallas", rnn_impl="pallas")


def make_params(cfg, device) -> dict:
    from repro_torch.models import init_params
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return init_params(cfg, gen)


def make_prompts(cfg, batch: int, prompt_len: int, device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.integers(0, cfg.vocab,
                                        size=(batch, prompt_len)),
                           device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, stats: dict | None = None):
    """Serve; returns the generated tokens, (batch, gen) numpy int32.

    ``stats`` has no counterpart in the JAX driver: when it is a dict it
    receives the prefill and decode seconds, the decode tokens/s, the
    prefill's last-position logits (on the CPU) and the bytes of the
    parameters and of the decode caches, so a caller such as
    ``chip_smoke.py`` can read them without parsing the log.
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain kernels")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.dist.fl_step import make_serve_step
    from repro_torch.models import prefill
    from repro_torch.tree import leaves

    device = resolve_device(args.device)
    cfg = serving_config(args.arch, args.reduced)
    assert cfg.causal, "serving requires a causal LM"
    if args.gen < 1:
        raise SystemExit(f"--gen must be at least 1, got {args.gen}")
    max_len = args.prompt_len + args.gen

    with torch.no_grad():
        params = make_params(cfg, device)
        prompts = make_prompts(cfg, args.batch, args.prompt_len, device)
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = prefill(cfg, params, prompts, max_len=max_len)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        _sync(device)
        t1 = time.perf_counter()
        out = [tok]
        serve = make_serve_step(cfg)
        for i in range(args.gen - 1):
            tok, _, caches = serve(params, caches, tok, args.prompt_len + i)
            out.append(tok)
        gen = torch.stack(out, 1)
        _sync(device)
        t2 = time.perf_counter()

    n_dec = args.batch * (args.gen - 1)
    dec_s = t2 - t1
    dec_rate = n_dec / dec_s if dec_s > 0 else float("inf")
    dt = t2 - t0
    print(f"generated {args.batch}x{args.gen} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)", flush=True)
    print(f"prefill {args.batch}x{args.prompt_len} tokens in "
          f"{t1 - t0:.3f}s; decode {n_dec} tokens in {dec_s:.3f}s "
          f"({dec_rate:.1f} tok/s)", flush=True)
    result = gen.cpu().numpy()
    print(result[: min(args.batch, 2)], flush=True)
    if stats is not None:
        stats.update(prefill_s=t1 - t0, decode_s=dec_s,
                     decode_tok_s=dec_rate, logits=logits.float().cpu(),
                     param_bytes=sum(t.numel() * t.element_size()
                                     for t in leaves(params)),
                     cache_bytes=sum(t.numel() * t.element_size()
                                     for t in leaves(caches)))
    return result


if __name__ == "__main__":
    main()
