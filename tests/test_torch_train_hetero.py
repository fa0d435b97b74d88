"""One train step of the port against the JAX package's on the smoke
configs with heterogeneous stacks: the hybrid (RG-LRU + local attention),
encdec, the two MoE (MLA, sliding window; tokens dropped at capacity
factor 1.25) and the VLM (the case in ``_torch_train.py``)."""
import pytest

from _torch_lm import Pair
from _torch_train import one_torch_thread, test_train_step_matches_jax  # noqa: F401

ARCHS = ["recurrentgemma_9b", "whisper_medium", "deepseek_v2_lite_16b", "mixtral_8x22b",
         "llama_3_2_vision_90b"]


@pytest.fixture(scope="module", params=ARCHS)
def step_pair(request):
    return Pair(request.param)
