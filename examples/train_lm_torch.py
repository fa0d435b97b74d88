"""Train a small qwen3-family LM end to end on the PyTorch port (data
pipeline -> model -> AdamW -> checkpointing), with a mid-run simulated
preemption + restart to demonstrate the fault-tolerance contract: the
counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--d-model 256] \
        [--device cuda]

Default config is ~10-20M params so the example completes on the CPU
(``--device cpu``); pass --d-model 768 --layers 12 for a ~100M-class run on
the card.  Checkpoints are written every min(25, steps // 2) steps, and the
restart at the midpoint rewinds once to the last of them, so every step
count has one to restore.
"""
import argparse
import dataclasses
import tempfile
import time

from repro_torch.configs import config_for
from repro_torch.models.model import build_model
from repro_torch.training import (OptConfig, SyntheticTokenPipeline, TrainConfig, checkpoint,
                                  make_train_step)
from repro_torch.training.train_step import init_train_state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=192)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = dataclasses.replace(
        config_for("qwen3_1_7b"),
        name="qwen3-mini",
        n_layers=args.layers, d_model=args.d_model,
        n_heads=max(4, args.d_model // 64), n_kv_heads=max(2, args.d_model // 128),
        d_head=64, d_ff=args.d_model * 4, vocab=8192, dtype="float32",
    )
    model = build_model(cfg, args.device)
    params = model.init_params()
    n_params = sum(p.numel() for p in params.values())
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, {args.steps} steps on {model.device}")

    tcfg = TrainConfig(opt=OptConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps))
    state = init_train_state(model, params, tcfg)
    pipe = SyntheticTokenPipeline(vocab=cfg.vocab, global_batch=args.batch,
                                  seq_len=args.seq, seed=1)
    step_fn = make_train_step(model, tcfg)
    every = max(1, min(25, args.steps // 2))

    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0, losses = time.time(), []
        step, restarted = 0, False
        while step < args.steps:
            batch = pipe.batch_at(step)
            params, state, metrics = step_fn(params, state, batch)
            losses.append(float(metrics["loss"]))
            step += 1
            if step % every == 0:
                checkpoint.save(ckpt_dir, step, checkpoint.to_jax_layout(cfg, params, state))
                tput = args.batch * args.seq * step / (time.time() - t0)
                print(f"step {step:4d} loss={losses[-1]:.4f} "
                      f"lr={float(metrics['lr']):.2e} tok/s={tput:.0f}")
            if step == args.steps // 2 and not restarted:
                # simulate a preemption: restore from the last checkpoint
                latest = checkpoint.latest_step(ckpt_dir)
                like = checkpoint.to_jax_layout(cfg, params, state)
                restored = checkpoint.restore(ckpt_dir, latest, like)
                loaded, state = checkpoint.from_jax_layout(cfg, restored, device=model.device)
                model.load_params(loaded)
                params = model.params()
                step, restarted = latest, True
                print(f"-- simulated preemption: restarted from step {latest} --")

        first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
        print(f"done: loss {first:.3f} -> {last:.3f} "
              f"({'improved' if last < first else 'NOT improved'})")
        assert last < first, "training must make progress"


if __name__ == "__main__":
    main()
