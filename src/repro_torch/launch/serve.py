"""Serving driver: batched prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m --reduced \
        --batch 4 --prompt-len 64 --gen 32 [--device cpu]

Runs on the card unless ``--device`` names another device; the weights are drawn
from a seeded ``torch.Generator`` on that device.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, reduced_for_smoke
from ..device import resolve_device
from ..models.model import init_params, prefill
from ..train.data import synth_batch
from ..train.step import make_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced_for_smoke(cfg)

    params = init_params(cfg, seed=0, device=dev)
    raw = synth_batch(cfg, step=0, global_batch=args.batch, seq=args.prompt_len)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items() if k != "labels"}

    cache_len = args.prompt_len + args.gen
    t0 = time.time()
    with torch.no_grad():
        logits, cache = prefill(cfg, params, batch, cache_len=cache_len)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(dev)
    t_prefill = time.time() - t0
    print(f"[serve] prefill {args.batch}×{args.prompt_len} in {t_prefill:.2f}s")

    serve_step = make_serve_step(cfg)
    outputs = [tok]
    t0 = time.time()
    for _ in range(args.gen - 1):
        tok, logits, cache = serve_step(params, cache, tok)
        outputs.append(tok)
    _sync(dev)
    t_dec = time.time() - t0
    toks = args.batch * (args.gen - 1)
    print(f"[serve] decoded {toks} tokens in {t_dec:.2f}s → {toks / max(t_dec, 1e-9):,.0f} tok/s")
    gen = torch.stack(outputs, dim=1).cpu().numpy()
    print(f"[serve] sample generation (first row): {gen[0][:16].tolist()}")
    return {"gen": gen, "t_prefill": t_prefill, "t_decode": t_dec}


if __name__ == "__main__":
    main()
