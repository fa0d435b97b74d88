"""Launchers of the LM scaffolding, ported from the JAX package's
``repro.launch``: ``flops`` (the analytic parameter / FLOP / byte model),
``serve`` (greedy prefill and decode against the caches), ``train`` (the
training launcher with checkpoint / restart), ``mesh`` (the production
``DeviceMesh``), ``dryrun`` (one step of every cell traced on a fake 256 /
512-rank process group under ``FakeTensorMode``), ``hlo_analysis`` (its
collective and memory accounting) and ``roofline`` (its records against
H100 data-sheet peaks)."""
