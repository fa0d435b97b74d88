"""The port's LM serving path (``repro_torch.models``, ``launch.serve``)
against the JAX package's, on the dense and SSM smoke configs (the cases in
``_torch_lm.py``), and the serve CLI."""
import numpy as np
import pytest
import torch

from _torch_lm import (Pair, test_decode_trajectory, test_forward_logits_loss_aux,  # noqa: F401
                       test_init_params_tree_matches_jax, test_params_round_trip)
from repro_torch.launch import serve
from repro_torch.models.model import build_model

ARCHS = ["qwen3_1_7b", "qwen3_14b", "stablelm_12b", "phi3_medium_14b", "mamba2_130m"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "mamba2_130m", "whisper_medium"])
def test_serve_cli_returns_tokens(arch, capsys):
    """``main([... --device cpu])`` returns the greedy tokens [B, G], in the
    vocabulary, and prints the JAX package's two [serve] lines."""
    gen = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "3",
                      "--prompt-len", "8", "--gen", "5"])
    assert isinstance(gen, np.ndarray) and gen.shape == (3, 5)
    assert gen.min() >= 0 and gen.max() < 256
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[serve] ") and "generated (3, 5) tokens" in lines[0]
    assert lines[0].endswith("tok/s decode") and lines[1].startswith("[serve] sample: ")


def test_serve_tokens_are_greedy_over_the_forward():
    """The served tokens are the argmax of the port's own full forward over
    prompt + generated tokens, step by step."""
    from repro_torch.configs import smoke_config

    cfg = smoke_config("qwen3_1_7b")
    model = build_model(cfg, "cpu")
    batch = serve.synthetic_batch(cfg, 2, 6, device=torch.device("cpu"))
    out = serve.generate(model, batch, 4)
    seq = torch.cat([batch["tokens"], out.tokens], dim=1)
    with torch.inference_mode():
        logits, _ = model({"tokens": seq})
    assert torch.equal(out.tokens, torch.argmax(logits[:, 5:9], dim=-1))
    assert out.logits.shape == (2, 10, cfg.vocab) and len(out.step_s) == 4


def test_without_cuda_the_serve_and_model_raise(monkeypatch):
    """The default device is the GPU; with none the model and the CLI raise
    instead of running on the host."""
    from repro_torch.configs import smoke_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(smoke_config("qwen3_1_7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3_1_7b", "--smoke"])
