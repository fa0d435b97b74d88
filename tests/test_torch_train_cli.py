"""The port's train CLI (``python -m repro_torch.launch.train``) on the CPU:
its log lines, preemption at a step and the exact restart from the latest
checkpoint, the GPU default; ``examples/train_lm_torch.py``; and the
smoke's train phase at smoke size."""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3_1_7b", "recurrentgemma_9b"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As ``_torch_train.one_torch_thread`` (this file imports no JAX): one
    intra-op thread for the smoke models, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(arch, *extra):
    return ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "4", "--seq", "32", *extra]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_logs_the_jax_fields(arch, capsys):
    """main() trains and prints the JAX CLI's lines: '[train] step k/N
    loss= gnorm= lr= tok/s=' every --log-every steps and at the last, then
    '[train] done: final loss'; each step's loss and grad norm are finite."""
    run = train.main(_argv(arch, "--steps", "4", "--log-every", "2"))
    lines = capsys.readouterr().out.strip().splitlines()
    field = r"loss=\d+\.\d{4} gnorm=\d+\.\d{3} lr=\d\.\d{2}e[-+]\d+ tok/s=\d+"
    assert re.fullmatch(rf"\[train\] step 2/4 {field}", lines[0]), lines[0]
    assert re.fullmatch(rf"\[train\] step 4/4 {field}", lines[1]), lines[1]
    assert lines[2] == f"[train] done: final loss {run.final_loss:.4f}"
    assert [h["step"] for h in run.history] == [1, 2, 3, 4] and run.start_step == 0
    assert all(torch.isfinite(torch.tensor([h["loss"], h["grad_norm"]])).all()
               for h in run.history)
    assert int(run.state["step"]) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_preemption_and_exact_restart(arch, tmp_path, capsys):
    """--simulate-preemption 3 with --ckpt-every 3 exits 42 after
    committing step 3; the rerun restores step 3 and trains to 6, and its
    final parameters, train state and losses are bitwise those of an
    uninterrupted 6-step run."""
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(SystemExit) as exc:
        train.main(_argv(arch, "--steps", "6", "--ckpt-dir", ckpt, "--ckpt-every", "3",
                         "--simulate-preemption", "3"))
    assert exc.value.code == 42
    assert "[train] SIMULATED PREEMPTION at step 3" in capsys.readouterr().out
    resumed = train.main(_argv(arch, "--steps", "6", "--ckpt-dir", ckpt, "--ckpt-every", "3"))
    assert "[train] restored checkpoint at step 3" in capsys.readouterr().out
    assert resumed.start_step == 3 and [h["step"] for h in resumed.history] == [4, 5, 6]
    whole = train.main(_argv(arch, "--steps", "6"))
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in whole.history[3:]]
    got, want = resumed.model.params(), whole.model.params()
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for mom in ("mu", "nu"):
        for name, v in whole.state["opt"][mom].items():
            assert torch.equal(resumed.state["opt"][mom][name], v), (mom, name)
    assert int(resumed.state["step"]) == int(whole.state["step"]) == 6


def test_train_cli_without_cuda_raises(monkeypatch):
    """The default device is the GPU; with none the CLI raises instead of
    training on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen3_1_7b", "--smoke", "--steps", "1"])


def test_example_train_lm_torch_runs_on_cpu():
    """examples/train_lm_torch.py at --steps 40 --d-model 64 --layers 2
    --seq 32 --device cpu: restarts from its checkpoint at the midpoint and
    exits 0 (it asserts the loss fell)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
                          "--steps", "40", "--d-model", "64", "--layers", "2", "--seq", "32",
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "-- simulated preemption: restarted from step 20 --" in out.stdout
    assert "(improved)" in out.stdout


def test_train_phase_on_cpu(monkeypatch, capsys):
    """The smoke's train phase on the CPU, qwen3-1.7b cut to its smoke
    config in its bfloat16 and S = 32 (``config_for`` and the sequence
    stubbed), the card's memory calls stubbed: every check holds (the ten
    smoke archs' card-against-host steps, here host against host; the
    CLI's 8 finite steps with the parameters moved; the loss falling on a
    repeated batch; the CLI's restart bitwise its uninterrupted run), and
    no PMV kernel launches."""
    import dataclasses

    import numpy as np

    from repro_torch import configs

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    monkeypatch.setattr(configs, "config_for",
                        lambda a: dataclasses.replace(configs.smoke_config(a), dtype="bfloat16"))
    monkeypatch.setattr(smoke, "TRAIN_S", 32)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 1 << 30)
    monkeypatch.setattr(smoke, "device_breakdown", lambda torch, run, iters: run() and {})
    failures = []
    smoke.train_phase(torch, np, torch.device("cpu"), "a card, 700 W", failures)
    out = capsys.readouterr().out
    assert failures == [], failures
    assert "FAIL" not in out
    for arch in configs.ARCHS:
        assert f"train {arch} smoke card vs host: loss rel 0.000e+00" in out
    assert "[train] step 8/8 loss=" in out and "wte among them: True" in out
    assert "bitwise True -> ok" in out and "PMV kernel launches 0" in out
    assert "step split: loss + gradients (remat)" in out
