"""The LM scaffolding's models, ported from the JAX package's
``repro.models``: the config, the layers, MLA, MoE, Mamba-2 SSD, RG-LRU,
the block kinds and the ``Model`` (forward, a differentiable loss with
block remat, caches, decode).  Plain PyTorch: no Pallas kernel is on this
path, so no CUDA.  ``convert`` maps the JAX package's parameter tree onto
the port's modules.  Not ported yet: ``sharding`` (the mesh layout of the
parameters)."""
