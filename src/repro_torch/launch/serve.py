"""Batched serving driver: prefill + decode loop against the KV/state caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1_7b \
        --batch 4 --prompt-len 16 --gen 32 [--smoke] [--device cuda]

Greedy decoding over synthetic prompts with random weights (seed 0); reports
decode tokens/s and checks finiteness.  Runs on the GPU unless
``--device cpu`` is given, and raises when no CUDA device is there.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs as configs_lib
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model


def synthetic_batch(cfg, batch: int, prompt_len: int, *, device, seed: int = 0) -> dict:
    """Random prompts [B, P] (and the stub frontends' embeddings at 0.1 std)
    drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                                   device=device)}
    if cfg.family == "vlm":
        out["vis_emb"] = torch.randn((batch, cfg.n_vision_tokens, cfg.d_model), generator=gen,
                                     device=device) * 0.1
    if cfg.family == "encdec":
        out["enc_emb"] = torch.randn((batch, prompt_len, cfg.d_model), generator=gen,
                                     device=device) * 0.1
    return out


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor        # [B, G] the greedy tokens fed back (on the host)
    logits: torch.Tensor        # [B, P + G, V] float32, every step's, on the device
    prefill_s: float            # the prompt's P steps, token by token
    step_s: list                # each of the G decode steps


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model, batch: dict, gen: int) -> Generation:
    """Ingest the prompt token by token, then ``gen`` greedy steps; each
    step's token is read back to the host, as a server streams it."""
    cfg, dev = model.cfg, model.device
    prompts = batch["tokens"]
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen, enc_len=P if cfg.family == "encdec" else 0)
    cache = model.prefill_cache(cache, batch)
    steps = []
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(P):
        logits, cache = model.serve_step(cache, prompts[:, t : t + 1], t)
        steps.append(logits[:, 0].float())
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out_tokens, step_s = [], []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    for t in range(P, P + gen):
        t1 = time.perf_counter()
        out_tokens.append(tok.cpu())
        logits, cache = model.serve_step(cache, tok, t)
        steps.append(logits[:, 0].float())
        tok = torch.argmax(logits[:, -1:], dim=-1)
        _sync(dev)
        step_s.append(time.perf_counter() - t1)
    return Generation(torch.cat(out_tokens, dim=1), torch.stack(steps, dim=1), prefill_s, step_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs_lib.ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs_lib.smoke_config(args.arch) if args.smoke else configs_lib.config_for(args.arch)
    dev = resolve_device(args.device)
    model = build_model(cfg, dev)
    B, P, G = args.batch, args.prompt_len, args.gen
    batch = synthetic_batch(cfg, B, P, device=dev)
    out = generate(model, batch, G)
    dt = sum(out.step_s)

    gen = out.tokens.numpy()
    if not torch.isfinite(out.logits[:, -1]).all():
        raise RuntimeError(f"{cfg.name}: the last step's logits are not finite")
    print(f"[serve] {cfg.name}: generated {gen.shape} tokens, "
          f"{B * G / dt:.1f} tok/s decode")
    print(f"[serve] sample: {gen[0][:16].tolist()}")
    return gen


if __name__ == "__main__":
    main()
