"""The LM scaffolding's models, ported from the JAX package's
``repro.models``: the config, the layers, MLA, MoE, Mamba-2 SSD, RG-LRU,
the block kinds and the ``Model`` (forward, a differentiable loss with
block remat, caches, decode).  Plain PyTorch: no Pallas kernel is on this
path, so no CUDA.  ``convert`` maps the JAX package's parameter tree onto
the port's modules.  ``sharding`` holds the JAX package's mesh layout of
the parameters, batches and caches (specs and their DTensor placements) and
``spmd`` the way a model distributed on a ``DeviceMesh`` computes: each
rank its rows (and under ``seq_parallel`` its sequence slice), every
parameter gathered where a layer reads it and its gradient reduced back to
its shards."""
