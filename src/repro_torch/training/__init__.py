"""The LM training slice on one device, ported from the JAX package's
``repro.training``: AdamW (``optimizer``), the train step with gradient
accumulation (``train_step``; block remat is the model's
``cfg.remat``), the stateless data pipeline (``data``) and checkpoints in
the JAX package's format (``checkpoint``).  Plain PyTorch: no Pallas
kernel is on this path, so no CUDA.  Not ported yet: ``pipeline`` (the
GPipe schedule over a mesh) and ``TrainConfig(compress_pod=True)``, which
need the mesh slice."""
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
