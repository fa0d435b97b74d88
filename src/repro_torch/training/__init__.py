"""The LM training slice, ported from the JAX package's ``repro.training``:
AdamW (``optimizer``), the train step with gradient accumulation
(``train_step``; block remat is the model's ``cfg.remat``), on one device
or on a ``DeviceMesh`` (DTensor parameters and state, and
``TrainConfig(compress_pod=True)``'s int8 error-feedback all-reduce over the
pod axis), the stateless data pipeline (``data``), checkpoints in the JAX
package's format that re-shard across meshes (``checkpoint``) and the GPipe
schedule over the pod axis (``pipeline``).  Plain PyTorch: no Pallas kernel
is on this path, so no CUDA."""
from repro_torch.training.optimizer import adamw_init, adamw_update, OptConfig
from repro_torch.training.train_step import make_train_step, TrainConfig
from repro_torch.training.data import SyntheticTokenPipeline
from repro_torch.training import checkpoint

__all__ = [
    "adamw_init",
    "adamw_update",
    "OptConfig",
    "make_train_step",
    "TrainConfig",
    "SyntheticTokenPipeline",
    "checkpoint",
]
