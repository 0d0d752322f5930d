"""Batched serving driver of the port: prefill a batch of prompts through
the decode path, then decode, on the GPU.

The same flags as ``repro.launch.serve`` plus ``--device``; like the
reference, ``main`` serves the arch's ``reduced()`` variant with weights
drawn from a seed (the published checkpoints are not in the repository).
Every decode step's attention runs through the K5 CUDA kernel
(``kernels.flash_decode``), one launch per layer; a Mamba2 layer's decode
step is the O(1) recurrence, in plain torch. A decoder's prompt goes in
through ``prefill_tokens`` (one decode step a token), as in the reference,
so ``serve`` reaches neither K4 nor K6 there; ``model.prefill`` does. An
encoder-decoder (whisper) gets random ``frames`` and goes through
``model.prefill`` (the encoder, the decoder's self-attention on K4 where
the prompt is a multiple of 128 tokens, the cross K/V), as the reference's
driver does.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --batch 4 --prompt-len 32 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # CPU run
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import factory
from repro_torch.models.common import dtype_of
from repro_torch.serve.batching import prefill_tokens


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray  # (batch, gen) generated tokens
    prefill_logits: torch.Tensor  # (batch, 1, V) after the last prompt token
    prefill_s: float  # prompt ingestion, host clock to a device sync
    decode_s: float  # the gen decode steps, host clock to a device sync
    gen: int


def _generators(seed: int, device) -> Dict[str, torch.Generator]:
    """Independent generators for params, prompts, sampling and encoder
    frames, as the reference splits one key."""
    seeds = np.random.SeedSequence(seed).generate_state(4)
    return {name: torch.Generator(device=device).manual_seed(int(s))
            for name, s in zip(("init", "prompt", "sample", "frames"), seeds)}


def sample(logits: torch.Tensor, temperature: float,
           gen: torch.Generator) -> torch.Tensor:
    """(B, 1) int32 next tokens from (B, 1, V) logits: the argmax at
    temperature 0, else a draw from softmax(logits / temperature) by the
    Gumbel-max trick (``jax.random.categorical``'s method; no host sync)."""
    last = logits[:, -1].float()
    if temperature <= 0:
        return last.argmax(-1, keepdim=True).to(torch.int32)
    u = torch.rand(last.shape, generator=gen, device=last.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    return (last / temperature + gumbel).argmax(-1, keepdim=True).to(torch.int32)


def serve(cfg: ArchConfig, batch: int, prompt_len: int, gen: int,
          temperature: float = 0.8, device=None, seed: int = 0,
          params=None, prompts: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens into ring caches
    of ``prompt_len + gen`` slots with ``prefill_tokens`` (an
    encoder-decoder: ``model.prefill`` of ``frames`` and the prompts), then
    run ``gen`` decode steps, sampling at ``temperature``. ``params`` and
    ``prompts`` default to draws from ``seed``; an encoder-decoder's frames
    are always drawn from it (standard normal in the compute dtype). The
    first token is the argmax of the prefill logits, as in the reference."""
    dev = resolve_device(device)
    model = factory.build(cfg)
    gens = _generators(seed, dev)
    if params is None:
        params = model.init(gens["init"])
    if prompts is None:
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=gens["prompt"], device=dev,
                                dtype=torch.int32)
    ctx = prompt_len + gen
    with torch.no_grad():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if cfg.encoder is not None:
            frames = torch.randn((batch, cfg.encoder.source_len, cfg.d_model),
                                 generator=gens["frames"], device=dev).to(
                                     dtype_of(cfg.compute_dtype))
            logits, caches = model.prefill(
                params, {"frames": frames, "tokens": prompts, "seq_len": ctx})
        else:
            caches = model.init_decode_caches(batch, ctx, dev)
            logits, caches = prefill_tokens(model.decode_step, params, caches, prompts)
        prefill_logits = logits
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        out = []
        tok = logits[:, -1:].float().argmax(-1).to(torch.int32)
        for _ in range(gen):
            out.append(tok)
            logits, caches = model.decode_step(params, caches, tok)
            tok = sample(logits, temperature, gens["sample"])
        tokens = torch.cat(out, dim=1).cpu().numpy()  # the one sync of the loop
        t2 = time.perf_counter()
    return ServeResult(tokens, prefill_logits, t1 - t0, t2 - t1, gen)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run on the CPU)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> ServeResult:
    args = parse_args(argv)
    cfg = get_arch(args.arch).reduced()
    res = serve(cfg, args.batch, args.prompt_len, args.gen, args.temperature,
                device=args.device)
    n = args.batch * args.gen
    print(f"arch={cfg.name} generated {args.batch}x{args.gen} tokens "
          f"in {res.decode_s:.2f}s ({n / res.decode_s:.1f} tok/s)")
    for b in range(min(args.batch, 2)):
        print(f"  sample {b}: {res.tokens[b][:16].tolist()} ...")
    return res


if __name__ == "__main__":
    main()
