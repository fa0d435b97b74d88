"""Per-block launch profiler: measured kernel time for every planned block
(the counterpart of the JAX package's ``repro.obs.profiler``).

The planner prices each pre-partitioned b x b sub-block in abstract slot
units (cost_model.ell_block_cost / dense_block_cost), but the fused planned
step launches whole same-tactic groups, so per-block wall time is invisible
from inside it.  This module re-runs each non-skip block's kernel launch
STANDALONE -- the same row-bucketed ELL tables
(blocks.pack_bucketed_ell -> the ELL GIM-V kernel) and materialized dense
matrices (blocks.materialize_dense_block -> the dense GIM-V kernel) the
planned packer builds -- under ``launch.ell`` / ``launch.dense`` spans
carrying the plan's prediction, which :mod:`repro_torch.obs.report` joins
into per-kind calibration residuals.

Standalone launches measure the kernels without the fused group's scatter
tail, so treat the residuals as per-tactic unit costs (seconds per slot),
not step predictions -- the step-level comparison lives in
``PMVEngine.explain(live=True)``.  Each span holds the block's launches and
the fence that waits for them, so on the card it includes the launch
overheads as well as the device time.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import blocks as blocks_lib
from repro_torch.core import placement
from repro_torch.kernels.block_gimv import has_semiring, semiring_of
from repro_torch.obs.recorder import Recorder, as_recorder

__all__ = ["profile_block_launches"]


def _host(x) -> np.ndarray:
    """One stripe array on the host (it may be a device tensor)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def profile_block_launches(engine, spec, ctx: dict | None = None, *,
                           repeats: int = 1, obs=None, inspect=None) -> Recorder:
    """Time every non-skip planned block's kernel launch in isolation.

    Prepares (and caches) the engine's solve, then walks the ExecutionPlan's
    block grid: each 'ell' block is packed into its row-bucketed ELL tables
    and dispatched through the ELL GIM-V kernel, one launch per non-empty
    bucket; each 'dense' block is materialized and dispatched through the
    dense GIM-V kernel.  Every block is launched once first, outside any
    span (on the card the first launch of a kernel may build it), then
    ``repeats`` times under a ``launch.<tactic>`` span with
    ``plan.block_attrs(i, j)`` attached (predicted_cost in slots,
    predicted_s via SLOT_TIME_S).  On a CPU engine the wrappers run the
    kernels' plain versions.

    The block's host work (its slice of the stripe, the ELL pack or the
    dense materialization, the copy to the device) is recorded as a
    ``profile.pack`` span beside its launch spans.  ``inspect``, if given,
    is called once per block right after its first launch, outside every
    span, with a dict of ``name``, ``attrs``, ``launch`` (the closure the
    spans time), ``operands`` (the ELL ``(cols, w)`` tables or the dense
    matrix), ``v`` and ``out`` (that launch's outputs).

    Returns the recorder (a fresh enabled one unless ``obs`` is given).
    """
    rec = as_recorder(True if obs is None else obs)
    if not has_semiring(spec.combine2, spec.combine_all):
        raise ValueError(
            f"spec {spec.name!r} has no kernel semiring -- per-block kernel "
            "launches cannot be profiled (the planned backend would also "
            "degrade to 'torch' here)")
    *_, meta = engine.prepare(spec, ctx)
    plan, pm, hm, part = meta["plan"], meta["pm"], meta["hm"], meta["part"]
    if pm is None:
        raise ValueError(
            "residency='disk' never materializes the stripes; profile a "
            "resident engine over the same store (residency='host') -- the "
            "disk path's launches are traced live as 'launch.disk_block'")
    # worker j's vertical stripe holds blocks (i, j) with inner axis i, the
    # same (dest, src) indexing as plan.block(i, j); hybrid plans price the
    # sparse region, whose stripes share that layout.
    stripes = hm.sparse_vertical if hm is not None else pm.vertical
    semiring = semiring_of(spec.combine2, spec.combine_all)
    n_local = part.n_local
    dev = engine.device
    # deterministic non-trivial operand (values are irrelevant to timing)
    v = torch.linspace(0.1, 1.0, n_local, dtype=torch.float64, device=dev).to(spec.torch_dtype)

    for j, stripe in enumerate(stripes):
        # each stripe comes to the host once, not once per block
        counts = _host(stripe.count)
        seg = _host(stripe.seg_local)
        gat = _host(stripe.gat_local)
        www = _host(stripe.w) if stripe.w is not None else None
        for i in range(part.b):
            bp = plan.block(i, j)
            cnt = int(counts[i])
            if bp.tactic == "skip" or cnt == 0:
                continue
            attrs = plan.block_attrs(i, j)
            with rec.span("profile.pack", {"i": i, "j": j, "tactic": bp.tactic}):
                dst, src = seg[i, :cnt], gat[i, :cnt]
                wij = www[i, :cnt] if www is not None else None
                if bp.tactic == "dense":
                    operands = torch.from_numpy(blocks_lib.materialize_dense_block(
                        dst, src, wij, n_local, semiring)).to(dev)

                    def launch(m2d=operands):
                        return placement._dense_call(spec, m2d, v)

                    name = "launch.dense"
                else:
                    operands = [
                        (torch.from_numpy(bk.cols).to(dev),
                         None if bk.w is None else torch.from_numpy(bk.w).to(dev))
                        for bk in blocks_lib.pack_bucketed_ell(dst, src, wij, plan.boundaries)
                        if bk.rows.size]

                    def launch(tables=operands):
                        return [placement.ell_gimv_call(spec, cols, w, v)
                                for cols, w in tables]

                    name = "launch.ell"
                rec.fence(operands)
            out = rec.fence(launch())     # build + warm outside the spans
            if inspect is not None:
                inspect({"name": name, "attrs": attrs, "launch": launch,
                         "operands": operands, "v": v, "out": out})
            for _ in range(repeats):
                with rec.span(name, attrs):
                    rec.fence(launch())
    return rec
