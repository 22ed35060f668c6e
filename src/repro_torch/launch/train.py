"""Training driver: real steps on one device (the card unless ``--device`` names
another).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m --steps 50 \
        --global-batch 8 --seq 256 --ckpt-dir <dir> [--resume] [--reduced] [--device cpu]

Features exercised here: auto-resume from the latest complete checkpoint; async
checkpointing every --ckpt-every steps; straggler monitor + heartbeat file;
deterministic stateless data (restart-safe); optional int8 gradient compression.
The weights are drawn from a seeded ``torch.Generator`` on the device."""

from __future__ import annotations

import argparse
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import torch

from ..configs import ARCHS, reduced_for_smoke
from ..device import resolve_device
from ..models.model import init_params
from ..train.checkpoint import CheckpointManager
from ..train.data import synth_batch
from ..train.fault import Heartbeat, StragglerMonitor
from ..train.optimizer import AdamWConfig
from ..train.step import TrainConfig, init_train_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--width", type=int, default=0, help="override d_model (with --reduced)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    if args.width:
        cfg = replace(cfg, d_model=args.width, head_dim=max(16, args.width // max(1, cfg.n_heads)))
    if args.layers:
        pat = len(cfg.pattern)
        n = max(pat, (args.layers // pat) * pat) + len(cfg.prefix)
        cfg = replace(cfg, n_layers=n)

    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                          total_steps=args.steps),
        microbatches=args.microbatches,
        compress_grads=args.compress_grads,
    )

    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"device={dev} batch={args.global_batch} seq={args.seq}")

    state = init_train_state(cfg, tcfg, params)
    step_fn = make_train_step(cfg, tcfg)

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume:
            latest = mgr.latest_step()
            if latest is not None:
                restored, meta = mgr.restore(latest, {"params": params, "opt": state})
                params, state = restored["params"], restored["opt"]
                start = latest + 1
                print(f"[train] resumed from step {latest}")

    mon = StragglerMonitor(on_straggler=lambda s, d, e: print(
        f"[straggler] step {s}: {d:.3f}s vs ema {e:.3f}s", flush=True))
    hb = Heartbeat(Path(args.ckpt_dir) / "heartbeat" if args.ckpt_dir
                   else Path(tempfile.gettempdir()) / "repro_torch_heartbeat")

    history = []
    for step in range(start, args.steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in synth_batch(cfg, step=step, global_batch=args.global_batch,
                                         seq=args.seq).items()}
        params, state, metrics = step_fn(params, state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        mon.record(step, dt)
        hb.beat(step)
        history.append(loss)
        if step % args.log_every == 0:
            tok_s = args.global_batch * args.seq / dt
            print(f"[step {step:5d}] loss={loss:.4f} lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s {tok_s:,.0f} tok/s",
                  flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save_async(step, {"params": params, "opt": state},
                           {"arch": cfg.name, "loss": loss})
    if mgr and history:
        mgr.wait()
        mgr.save(args.steps - 1, {"params": params, "opt": state}, {"arch": cfg.name})
    if history:
        print(f"[train] done: loss {history[0]:.4f} → {history[-1]:.4f}")
    else:
        print(f"[train] nothing to do (resumed at step {start} ≥ {args.steps})")
    return {"history": history, "n_params": n_params}


if __name__ == "__main__":
    main()
