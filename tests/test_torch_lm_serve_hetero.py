"""The port's LM serving path against the JAX package's on the smoke configs
with heterogeneous stacks: the hybrid (RG-LRU + local attention), encdec,
the two MoE (MLA, sliding window) and the VLM (the cases in
``_torch_lm.py``)."""
import pytest

from _torch_lm import (Pair, test_decode_trajectory, test_forward_logits_loss_aux,  # noqa: F401
                       test_init_params_tree_matches_jax, test_params_round_trip)

ARCHS = ["recurrentgemma_9b", "whisper_medium", "deepseek_v2_lite_16b", "mixtral_8x22b",
         "llama_3_2_vision_90b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return Pair(request.param)
