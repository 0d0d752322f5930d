"""Centralized LM training driver of the port: a reduced architecture
widened toward a target size, trained by ``model.sgd_train_step`` under a
warmup-cosine schedule on a synthetic token stream, on the GPU.

The same flags as ``repro.launch.train`` plus ``--device`` and ``--seed``
(the params' generator and the token stream's seed; 0 is the reference's
stream). On the card every attention layer runs K4 forward and backward
(with ``build``'s default remat, the forward twice a layer a step); on the
CPU their plain versions. An arch with the vision stub (pixtral, llama4)
gets one draw of frontend embeddings prepended to every step's tokens, with
the labels of those positions ignored (-1); an encoder-decoder (whisper)
one draw of frames, as the reference's driver reuses one ``synth_batch``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 200 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.data.synthetic import make_token_stream
from repro_torch.device import resolve_device
from repro_torch.models import factory
from repro_torch.optim.schedules import warmup_cosine


def build_sized(arch: str, target_params: float) -> ArchConfig:
    """Reduced variant scaled up toward ~target_params (CPU trainable)."""
    cfg = get_arch(arch)
    red = cfg.reduced()
    # widen/deepen the reduced config until close to target
    d = red.d_model
    layers = 2
    while True:
        test = dataclasses.replace(red, d_model=d, vocab_size=min(cfg.vocab_size, 8192))
        if test.param_count() * (layers / test.num_layers) >= target_params or d >= 1024:
            break
        d *= 2
    return dataclasses.replace(red, d_model=d, vocab_size=min(cfg.vocab_size, 8192))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--target-params", type=float, default=20e6)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run on the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Runs the driver; returns ``{cfg, params, losses, tokens_per_s,
    seconds}`` (``losses`` one float a step, read from the device at the
    log points and at the end)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = build_sized(args.arch, args.target_params)
    model = factory.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} params={n / 1e6:.1f}M layers={cfg.num_layers} d={cfg.d_model}")

    B, S = args.batch, args.seq
    stream = make_token_stream(cfg.vocab_size, args.steps * B * (S + 1) + 1, args.seed)
    # the whole stream and schedule on the device once: a step slices views
    # (no host-to-device copy, no sync inside the loop)
    docs = torch.as_tensor(stream[:args.steps * B * (S + 1)], device=dev).view(
        args.steps, B, S + 1)
    lrs = warmup_cosine(args.lr, args.steps // 10, args.steps)(
        torch.arange(args.steps, device=dev))
    ft = cfg.frontend_tokens if cfg.frontend != "none" else 0
    stub = factory.synth_batch(torch.Generator(device=dev).manual_seed(args.seed), cfg,
                               B, S + ft)
    stub = {k: v for k, v in stub.items() if k in ("frontend", "frames")}
    ignored = torch.full((B, ft), -1, dtype=docs.dtype, device=dev)

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        labels = docs[step, :, 1:]
        if ft:
            labels = torch.cat([ignored, labels], dim=1)
        batch = {"tokens": docs[step, :, :-1], "labels": labels, **stub}
        params, metrics = model.sgd_train_step(params, batch, lrs[step])
        losses.append(metrics["loss"])
        if (step + 1) % args.log_every == 0:
            window = [float(x) for x in losses[-args.log_every:]]
            rate = (step + 1) * B * S / (time.time() - t0)
            print(f"step {step + 1:5d} loss {np.mean(window):.4f} ({rate:.0f} tok/s)",
                  flush=True)
    losses = [float(x) for x in losses]
    seconds = time.time() - t0
    print(f"final loss {np.mean(losses[-10:]):.4f} (initial {np.mean(losses[:10]):.4f})")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, step=args.steps)
        print("checkpoint ->", args.checkpoint)
    return {"cfg": cfg, "params": params, "losses": losses,
            "tokens_per_s": args.steps * B * S / seconds, "seconds": seconds}


if __name__ == "__main__":
    main()
