"""End-to-end training launcher with checkpoint/restart fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_1_7b --steps 200 \
        --smoke --batch 8 --seq 64 --ckpt-dir /tmp/ckpt [--device cuda]

- `--smoke` uses the reduced same-family config; without it the arch's
  full config (qwen3-1.7b: 28 layers, d_model 2048, bfloat16) trains on the
  card with random weights.
- Restart: if the checkpoint dir has a committed step, training resumes from
  it (exact: stateless data pipeline keyed by step).  Checkpoints are in the
  JAX package's format, so either package resumes the other's.
- `--simulate-preemption N` exits with code 42 at step N to exercise the
  restart path (used by tests/examples).
- Runs on the GPU unless ``--device cpu`` is given, and raises when no CUDA
  device is there.  Parameters are ``Model.init_params``' seed-0 draw.

``main`` returns a :class:`TrainRun`: the model with its final parameters,
the train state, and each step's loss, grad norm, lr and seconds (host
clock, ending in the loss's copy to the host).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from repro_torch import configs as configs_lib
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, build_model
from repro_torch.training import (OptConfig, SyntheticTokenPipeline, TrainConfig, checkpoint,
                                  make_train_step)
from repro_torch.training.train_step import init_train_state


@dataclasses.dataclass
class TrainRun:
    model: Model                # holding the final parameters
    state: dict                 # the final train state
    start_step: int             # 0, or the step restored from a checkpoint
    history: list               # a dict a step run: step, loss, grad_norm, lr, step_s

    @property
    def final_loss(self) -> float:
        return self.history[-1]["loss"]


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs_lib.ARCHS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--simulate-preemption", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs_lib.smoke_config(args.arch) if args.smoke else configs_lib.config_for(args.arch)
    dev = resolve_device(args.device)
    model = build_model(cfg, dev)
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
                      total_steps=args.steps),
        grad_accum=args.grad_accum,
    )
    pipe = SyntheticTokenPipeline(
        vocab=cfg.vocab, global_batch=args.batch, seq_len=args.seq, seed=17,
        vis_tokens=cfg.n_vision_tokens if cfg.family == "vlm" else 0,
        enc_len=args.seq if cfg.family == "encdec" else 0,
        d_model=cfg.d_model,
    )

    params = model.init_params()
    state = init_train_state(model, params, tcfg)
    start_step = 0
    if args.ckpt_dir:
        latest = checkpoint.latest_step(args.ckpt_dir)
        if latest is not None:
            like = checkpoint.to_jax_layout(cfg, params, state)
            restored = checkpoint.restore(args.ckpt_dir, latest, like)
            loaded, state = checkpoint.from_jax_layout(cfg, restored, device=dev)
            model.load_params(loaded)
            params = model.params()
            start_step = latest
            print(f"[train] restored checkpoint at step {latest}")

    step_fn = make_train_step(model, tcfg)
    t0 = time.time()
    tokens_seen = 0
    history = []
    for step in range(start_step, args.steps):
        t_step = time.perf_counter()
        batch = pipe.batch_at(step)
        params, state, metrics = step_fn(params, state, batch)
        loss = float(metrics["loss"])
        history.append({"step": step + 1, "loss": loss,
                        "grad_norm": float(metrics["grad_norm"]), "lr": float(metrics["lr"]),
                        "step_s": time.perf_counter() - t_step})
        tokens_seen += batch["tokens"].size
        if args.ckpt_dir and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step + 1, checkpoint.to_jax_layout(cfg, params, state))
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            dt = time.time() - t0
            print(f"[train] step {step + 1}/{args.steps} "
                  f"loss={loss:.4f} "
                  f"gnorm={history[-1]['grad_norm']:.3f} "
                  f"lr={history[-1]['lr']:.2e} "
                  f"tok/s={tokens_seen / max(dt, 1e-9):.0f}")
        if args.simulate_preemption and step + 1 == args.simulate_preemption:
            print(f"[train] SIMULATED PREEMPTION at step {step + 1}", flush=True)
            sys.exit(42)

    run = TrainRun(model, state, start_step, history)
    print(f"[train] done: final loss {run.final_loss:.4f}")
    return run


if __name__ == "__main__":
    main()
