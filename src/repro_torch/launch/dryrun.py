"""Multi-pod dry run: trace one step of every (arch x shape x mesh) cell on a
production mesh without a card and without allocating a parameter (the
JAX package's ``repro.launch.dryrun``, in PyTorch's idiom).

For each cell, in this process:
    torch.distributed.init_process_group("fake", world_size=256 | 512)
    mesh = make_production_mesh(multi_pod=..., device_type="cuda")
    with FakeTensorMode(), FlopCounterMode(), CollectiveRecorder(), MemoryRecorder():
        place params / state / batch / caches by repro_torch.models.sharding
        run one train step (grad accumulation included), prefill or decode step

The step is the port's (``repro_torch.models.spmd``), laid out as GSPMD
lays out the JAX package's: tensor parallel over 'model' for the layers
whose shards fall on whole heads and columns (``spmd.tp_layout``: GQA
attention, the SwiGLU MLP, the MoE experts, the vocab-parallel embedding,
logits and loss), FSDP over 'data', the rows over the data axes; the other
layers, and a decode step, gather their weights over 'model'.  Each
record's ``meta['parallelism']`` names the cell's TP layers and
``meta['layout']`` gives every layer's path.
This rank's (rank 0's) share of the step is what is traced: it runs eagerly
on fake tensors, each collective is recorded with its result bytes as it is
dispatched, the flops are ``FlopCounterMode``'s per rank (without its module
tracker), the memory the live fake storages' peak.  The JAX package lowers and compiles; here
``lower_s`` is the traces' seconds and ``compile_s`` 0.

The JAX package lowers each scan once: the superblock stack and the
microbatch loop.  The port fits them instead (``fit_points``): it traces
the cell's own step at 1 and 2 superblocks of its ``scan_plan()`` pattern
(head and tail kept; both stacks of an enc-dec) and, training, at two
microbatch counts of the cell's own microbatch size, and extrapolates every
count (flops, collective bytes and counts by kind, argument / output /
alias / temp bytes) bilinearly to the cell's superblocks and
microbatches.  Each count is affine in each of the two, so the fit is the
whole trace's, which ``trace_lm_cell(..., whole=True)`` still gives; the
collectives' ``top`` list is the largest traced step's.  A record's
``meta['fit']`` names the traced points.
Records are written incrementally to ``build/dryrun_results/<cell>.json``
(``build/`` is git-ignored), so the sweep is restartable; failures are
data.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3_1_7b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--force]          # every cell, both meshes
    python -m repro_torch.launch.dryrun --pmv-cell twitter@pagerank@hybrid --mesh multi
"""
import argparse
import contextlib
import dataclasses
import fractions
import gc
import json
import os
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as configs_lib
from repro_torch.launch import flops as flops_lib
from repro_torch.launch.hlo_analysis import (
    KINDS,
    CollectiveRecorder,
    MemoryRecorder,
    collective_totals,
    compiled_memory_stats,
)
from repro_torch.launch.mesh import data_axes, make_production_mesh, worker_axes
from repro_torch.models import sharding as sh
from repro_torch.models import spmd
from repro_torch.models.sharding import _batch_axes

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                           "dryrun_results")

# train_4k microbatching (memory knob; the JAX package's):
GRAD_ACCUM = {
    "qwen3_1_7b": 1, "qwen3_14b": 2, "stablelm_12b": 2, "phi3_medium_14b": 2,
    "mamba2_130m": 1, "recurrentgemma_9b": 2, "whisper_medium": 1,
    "deepseek_v2_lite_16b": 2, "mixtral_8x22b": 8, "llama_3_2_vision_90b": 16,
}
WHISPER_DECODE_ENC_LEN = 1500  # real whisper-medium encoder output length

# hillclimb variants: cell name arch@shape@<variant>
VARIANTS = {
    "sp": {"seq_parallel": True},                       # sequence parallelism
    "spskip": {"seq_parallel": True, "flash_skip": True},  # SP + triangle sched
    "skip": {"flash_skip": True},
    "sp_ga4": {"seq_parallel": True, "grad_accum": 4},  # SP + fewer microbatches
    "ga4": {"grad_accum": 4},
    "ga8": {"grad_accum": 8},
    "noremat": {"remat": "none"},
    "sp_noremat": {"seq_parallel": True, "remat": "none"},
}

MESH_WORLD = {"single": 256, "multi": 512}
ALL_CELL_TIMEOUT_S = 300.0      # --all: a cell whose trace takes longer fails as data

# What the traced step computes on the mesh (``repro_torch.models.spmd``),
# recorded in every record's meta with the cell's TP layers
FSDP_PARALLELISM = ("FSDP over 'data': a weight gathered over 'data' where a layer reads it; "
                    "rows over the data axes")
DECODE_PARALLELISM = ("decode: every weight gathered over 'data' and 'model' where a layer "
                      "reads it; rows over the data axes; long caches split over 'model' "
                      "(split-KV)")
SP_PARALLELISM = "; seq_parallel: the sequence over 'model'"
PMV_PARALLELISM = "PMV workers: one block row of the matrix a rank"
# CPU-test scale: smoke configs at small shapes, a small graph, on a small
# fake mesh named by its shape ("2x2": ('data', 'model'), "2x2x2": ('pod',
# 'data', 'model'))
SMOKE_SHAPES = {"train_4k": (32, 16, "train"), "prefill_32k": (32, 8, "prefill"),
                "decode_32k": (64, 8, "decode"), "long_500k": (64, 1, "decode")}
SMOKE_GRAPHS = {"smoke": (4096, 65536, 2.0)}


# ---------------------------------------------------------------------------
def _local_bytes(tree) -> float:
    """Bytes of a tree's local tensors (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return float(tree.numel() * tree.element_size())
    return 0.0


def _storages(tree) -> set:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return set().union(*(_storages(v) for v in tree.values())) if tree else set()
    if isinstance(tree, (list, tuple)):
        return set().union(*(_storages(v) for v in tree)) if tree else set()
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return {tree.untyped_storage()._cdata}
    return set()


def _outputs(out, args) -> tuple[float, float]:
    """(output bytes, of which written into the arguments' storages)."""
    held = _storages(args)
    total = alias = 0.0

    def walk(t):
        nonlocal total, alias
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            n = _local_bytes(t)
            if n and _storages(t) <= held:
                alias += n
            else:
                total += n
    walk(out)
    return total, alias


# ---------------------------------------------------------------------------
def lm_cell_config(arch: str, shape_name: str, mesh, overrides: dict | None = None, *,
                   smoke: bool = False):
    """(cfg, seq, batch, mode, grad_accum) of an LM cell.

    overrides: ModelConfig field overrides for the variants, e.g.
    {"seq_parallel": True} — applied via dataclasses.replace.  ``smoke``:
    the smoke config at ``SMOKE_SHAPES``."""
    cfg = (configs_lib.smoke_config if smoke else configs_lib.config_for)(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, dp_axes=data_axes(mesh), **overrides)
    seq, batch, mode = (SMOKE_SHAPES if smoke else configs_lib.SHAPES)[shape_name]
    ga = 1
    if mode == "train":
        ga = cfg.grad_accum if cfg.grad_accum > 1 else GRAD_ACCUM.get(arch, 1)
    return cfg, seq, batch, mode, ga


def with_superblocks(cfg, k: int):
    """``cfg`` with ``k`` superblocks of its ``scan_plan()`` pattern, its
    head and tail layers kept (an enc-dec: ``k`` layers a stack)."""
    plan = cfg.scan_plan()
    return dataclasses.replace(cfg, n_layers=cfg.n_layers - (plan["n_sb"] - k)
                               * len(plan["pattern"]))


def fit_points(cfg, mode: str, batch: int, grad_accum: int, mesh) -> tuple[tuple, tuple]:
    """The superblock counts and the microbatch counts to trace an LM cell
    at: (1, 2) superblocks where the stack has more than 2 (else its own
    count); training, two counts of at least 2 microbatches below its own
    (the step's accumulation path; 1 takes another) whose rows split over
    the data axes as the cell's do, where it has two such below its own
    (else its own count)."""
    n_sb = cfg.scan_plan()["n_sb"]
    ks = (1, 2) if n_sb > 2 else (n_sb,)
    ms = (grad_accum,)
    if mode == "train" and grad_accum > 3:
        rows = batch // grad_accum
        want = _batch_axes(mesh, batch)
        same = [m for m in range(2, grad_accum) if _batch_axes(mesh, m * rows) == want]
        if len(same) >= 2:
            ms = tuple(same[:2])
    return ks, ms


def build_lm_cell(arch: str, shape_name: str, mesh, overrides: dict | None = None, *,
                  smoke: bool = False, superblocks: int | None = None,
                  microbatches: int | None = None):
    """Returns (fn, args, meta): ``fn(*args)`` runs one step of the cell on
    this rank, its inputs placed on ``mesh`` (call it under FakeTensorMode).

    overrides and ``smoke`` as :func:`lm_cell_config` takes them;
    ``superblocks``: the stack cut to that many (:func:`with_superblocks`);
    ``microbatches``: a train step of that many microbatches of the cell's
    own size (None: the cell's own)."""
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import TrainConfig, init_train_state, make_train_step

    cfg, seq, batch, mode, ga = lm_cell_config(arch, shape_name, mesh, overrides, smoke=smoke)
    if superblocks is not None:
        cfg = with_superblocks(cfg, superblocks)
    if microbatches is not None:
        batch, ga = batch // ga * microbatches, microbatches
    model = build_model(cfg, "cpu")           # fake: allocates nothing
    params = model.distribute(mesh, src_data_rank=None)
    dev = model.device
    layout = {} if mode == "decode" else model.layout

    def batch_struct():
        b = {"tokens": torch.zeros((batch, seq), dtype=torch.int32, device=dev)}
        if cfg.family == "vlm":
            b["vis_emb"] = torch.zeros((batch, cfg.n_vision_tokens, cfg.d_model),
                                       dtype=torch.bfloat16, device=dev)
        if cfg.family == "encdec":
            b["enc_emb"] = torch.zeros((batch, seq, cfg.d_model), dtype=torch.bfloat16,
                                       device=dev)
        return sh.sds_with(b, sh.batch_shardings(b, mesh), mesh, src_data_rank=None)

    if mode == "train":
        tcfg = TrainConfig(opt=OptConfig(), grad_accum=ga)
        state = init_train_state(model, params, tcfg)  # moments mirror params
        step = make_train_step(model, tcfg, mesh)
        return step, (params, state, batch_struct()), {"cfg": cfg, "mode": mode,
                                                       "grad_accum": ga, "layout": layout}

    if mode == "prefill":
        def prefill(p, b):
            with torch.no_grad():
                return model.forward(b)[0]
        return prefill, (params, batch_struct()), {"cfg": cfg, "mode": mode, "layout": layout}

    # decode: one token against a seq-long cache
    enc_len = WHISPER_DECODE_ENC_LEN if cfg.family == "encdec" else 0
    cache = model.init_cache(batch, seq, enc_len=enc_len)
    cache = sh.sds_with(cache, sh.cache_shardings(cache, mesh, cfg), mesh, src_data_rank=None)
    tok = {"tokens": torch.zeros((batch, 1), dtype=torch.int32, device=dev)}
    tok = sh.sds_with(tok, sh.batch_shardings(tok, mesh), mesh, src_data_rank=None)["tokens"]

    def decode(p, c, t, pos):
        with torch.no_grad():
            return model.serve_step(c, t, pos)
    return decode, (params, cache, tok, seq - 1), {"cfg": cfg, "mode": mode, "enc_len": enc_len,
                                                   "layout": layout}


# ---------------------------------------------------------------------------
# PMV graph-engine cells: the paper's own workload at production scale.
PMV_GRAPHS = {
    # name: (n_vertices, n_edges, skew factor for block padding)
    "twitter": (41_652_230, 1_468_365_182, 2.0),
    "clueweb12": (6_231_126_594, 71_746_553_402, 2.0),
}
PMV_CELLS = [
    # (graph, algorithm, strategy) — horizontal only at twitter scale: it
    # needs the whole |v| per worker (paper Lemma 3.1), which for ClueWeb12
    # exceeds HBM by design; selective/Eq.5 picks vertical there (Fig. 1).
    ("twitter", "pagerank", "horizontal"),
    ("twitter", "pagerank", "vertical"),
    ("twitter", "pagerank", "hybrid"),
    ("twitter", "sssp", "hybrid"),
    ("clueweb12", "pagerank", "vertical"),
    ("clueweb12", "pagerank", "hybrid"),
    ("clueweb12", "cc", "hybrid"),
    # beyond-paper: topology-aware two-hop exchange (multi-pod cell)
    ("clueweb12", "pagerank", "vertical_hier"),
]


def build_pmv_cell(graph: str, algo: str, strategy: str, mesh):
    """One PMV step of this rank's worker (``core.engine.make_step`` under
    the mesh, every mesh dim one worker axis): its [1, ...] rows of the
    padded stripes, static-shaped (the capacity is fixed)."""
    from repro_torch.core import algorithms, cost_model
    from repro_torch.core.blocks import BlockEdges, DenseRegion
    from repro_torch.core.engine import StepConfig, make_step

    exchange = "sparse"
    if strategy.endswith("_hier"):
        strategy = strategy[: -len("_hier")]
        exchange = "hier"
    n, m, skew = {**PMV_GRAPHS, **SMOKE_GRAPHS}[graph]
    b = int(np.prod(mesh.shape))
    axis = worker_axes(mesh)
    n_local = -(-n // b)
    e_blk = int(m / (b * b) * skew) + 1            # padded per-block edge capacity
    exp_partial = cost_model.expected_partial_nnz(b, n, m)
    capacity = min(n_local, int(exp_partial * 2.0) + 1)

    if algo == "pagerank":
        spec = algorithms.pagerank(n)
    elif algo == "sssp":
        spec = algorithms.sssp(0)
    else:
        spec = algorithms.connected_components()
    dev = torch.device(mesh.device_type)
    i32 = torch.int32

    def zeros(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def stripe(e_cap):           # this rank's worker row of the stacked stripes
        return BlockEdges(seg_local=zeros(1, b, e_cap), gat_local=zeros(1, b, e_cap),
                          w=zeros(1, b, e_cap, dtype=torch.float32)
                          if spec.needs_weights else None,
                          count=zeros(1, b))

    if strategy in ("horizontal", "vertical"):
        matrix = {"stripe": stripe(e_blk)}
    else:
        d_frac = 0.01  # ~P(out-degree >= theta*) for power-law web graphs
        d_cap = max(int(n_local * d_frac * skew), 1)
        matrix = {"sparse_stripe": stripe(int(e_blk * 0.7) + 1),
                  "dense_stripe": stripe(int(e_blk * 0.3) + 1),
                  "dense_region": DenseRegion(gather_idx=zeros(1, d_cap), d_count=zeros(1),
                                              d_cap=d_cap, theta=200.0)}
    v = zeros(1, n_local, dtype=torch.from_numpy(np.zeros(0, spec.dtype)).dtype)
    mask = zeros(1, n_local, dtype=torch.bool)
    cfg = StepConfig(strategy=strategy, n_local=n_local, exchange=exchange, capacity=capacity)
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():      # the worker axis reads the mesh's real rank grid
        step = make_step(spec, cfg, mesh, axis)
    meta = {"n": n, "m": m, "b": b, "n_local": n_local, "e_blk": e_blk,
            "capacity": capacity, "algo": algo, "strategy": strategy,
            "exchange": exchange}
    return step, (matrix, v, {}, mask), meta


# ---------------------------------------------------------------------------
def dry_device_type() -> str:
    """'cuda' where the build has CUDA, else 'cpu'.  Fake CUDA tensors need
    no card, but their backward does need the build's CUDA device guard (a
    CPU-only build aborts the process); the LM step's collectives are the
    same funcols on either (it redistributes Shard <-> Replicate / Partial
    only, never through the CPU group's all-to-all fallback)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def production_mesh(mesh_name: str):
    """The fake process group of the mesh's world size (re-initialised when
    it differs) and the production mesh over it (or a small mesh named by
    its shape, e.g. "2x2x2"), on ``dry_device_type()``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if mesh_name in MESH_WORLD:
        world, shape = MESH_WORLD[mesh_name], None
    else:
        shape = tuple(int(x) for x in mesh_name.split("x"))
        world = int(np.prod(shape))
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    if shape is None:
        return make_production_mesh(multi_pod=(mesh_name == "multi"),
                                    device_type=dry_device_type())
    names = ("pod", "data", "model")[3 - len(shape):]
    return init_device_mesh(dry_device_type(), shape, mesh_dim_names=names)


class _Deadline(TorchDispatchMode):
    """TimeoutError from the first op dispatched after ``seconds`` (0: never):
    raised where an op would raise, so the trace unwinds as from a failing
    op (a signal could land inside a C++ callback and abort the process)."""

    def __init__(self, seconds: float):
        super().__init__()
        self.seconds = seconds
        self.end = time.monotonic() + seconds

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.seconds and time.monotonic() > self.end:
            raise TimeoutError(f"the trace took over {self.seconds:.0f} s")
        return func(*args, **(kwargs or {}))


class _GlobalOnly:
    """A ``FlopCounterMode``'s module tracker that files every op under
    'Global' and registers no module hook: the real tracker's autograd hooks
    kept each microbatch's tensors alive to the step's end, and the memory
    recorder counted them (12 TB a rank in a 16-microbatch train cell)."""

    parents = ("Global",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def trace_step(fn, args) -> dict:
    """Run ``fn(*args)`` (inputs already fake) under the recorders:
    {'seconds', 'flops', 'collectives', 'memory'}.  Python's automatic
    garbage collection is off while it runs: where a collection landed
    moved the recorded peak, so the same step could record different temp
    bytes."""
    from torch.utils.flop_counter import FlopCounterMode

    arg_bytes = _local_bytes(args)
    coll, mem = CollectiveRecorder(), MemoryRecorder()
    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _GlobalOnly()
    gc.collect()
    gc.disable()
    t0 = time.time()
    try:
        with counter, mem, coll:
            out = fn(*args)
    finally:
        gc.enable()
    seconds = time.time() - t0
    out_bytes, alias = _outputs(out, args)
    memory = compiled_memory_stats({"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                                    "alias_bytes": alias, "temp_bytes": mem.peak})
    return {"seconds": seconds, "flops": float(counter.get_total_flops()),
            "collectives": collective_totals(coll), "memory": memory}


_MEMORY_KEYS = ("temp_bytes", "argument_bytes", "output_bytes", "alias_bytes")


def _weights(points: tuple, x: int) -> dict:
    """Linear interpolation weights of ``points`` (one or two) at ``x``."""
    if len(points) == 1:
        return {points[0]: fractions.Fraction(1)}
    a, b = points
    return {a: fractions.Fraction(b - x, b - a), b: fractions.Fraction(x - a, b - a)}


def fit_traces(traces: dict, superblocks: int, microbatches: int) -> dict:
    """:func:`trace_step`'s dict at ``superblocks`` and ``microbatches``,
    extrapolated bilinearly (exactly, in rationals) from ``traces``, the
    steps traced at each (superblocks, microbatches) point of a grid of one
    or two values a dimension; 'seconds' is the traces' sum, the
    collectives' 'top' the largest traced step's."""
    ks = tuple(sorted({k for k, _ in traces}))
    ms = tuple(sorted({m for _, m in traces}))
    w = {(k, m): wk * wm for k, wk in _weights(ks, superblocks).items()
         for m, wm in _weights(ms, microbatches).items()}

    def fit(get):
        return float(sum(wt * fractions.Fraction(get(traces[p])) for p, wt in w.items()))

    nbytes = {k: fit(lambda t, k=k: t["collectives"]["bytes"][k]) for k in KINDS}
    coll = {"bytes": {**nbytes, "total": sum(nbytes.values())},
            "raw_bytes": {**nbytes, "total": sum(nbytes.values())},
            "counts": {k: int(fit(lambda t, k=k: t["collectives"]["counts"][k])) for k in KINDS},
            "top": traces[ks[-1], ms[-1]]["collectives"]["top"]}
    memory = compiled_memory_stats({k: fit(lambda t, k=k: t["memory"][k]) for k in _MEMORY_KEYS})
    return {"seconds": sum(t["seconds"] for t in traces.values()),
            "flops": fit(lambda t: t["flops"]), "collectives": coll, "memory": memory}


def _parallelism(kind: str, meta: dict) -> str:
    if kind != "lm":
        return PMV_PARALLELISM
    if meta["mode"] == "decode":
        out = DECODE_PARALLELISM
    else:
        out = f"{spmd.describe_layout(meta['layout'])}; {FSDP_PARALLELISM}"
    return out + (SP_PARALLELISM if meta["cfg"].seq_parallel else "")


def trace_lm_cell(arch: str, shape_name: str, mesh, overrides: dict | None = None, *,
                  smoke: bool = False, whole: bool = False,
                  deadline=contextlib.nullcontext()) -> tuple[dict, dict]:
    """(trace, meta) of an LM cell: its step traced at :func:`fit_points`
    and extrapolated (:func:`fit_traces`), or ``whole`` traced as it is;
    each traced step in a fresh ``FakeTensorMode``, under ``deadline``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, _seq, batch, mode, ga = lm_cell_config(arch, shape_name, mesh, overrides, smoke=smoke)
    n_sb = cfg.scan_plan()["n_sb"]
    ks, ms = ((n_sb,), (ga,)) if whole else fit_points(cfg, mode, batch, ga, mesh)
    traces = {}
    for k in ks:
        for m in ms:
            with FakeTensorMode(allow_non_fake_inputs=True), deadline:
                fn, args, meta = build_lm_cell(arch, shape_name, mesh, overrides, smoke=smoke,
                                               superblocks=None if k == n_sb else k,
                                               microbatches=None if m == ga else m)
                traces[k, m] = trace_step(fn, args)
                del fn, args
    meta = {**meta, "cfg": cfg, "fit": {"superblocks": list(ks), "n_sb": n_sb,
                                        "microbatches": list(ms)}}
    if mode == "train":
        meta["grad_accum"] = ga
    return fit_traces(traces, n_sb, ga), meta


def run_cell(kind: str, name: str, mesh_name: str, *, force=False,
             results_dir: str = RESULTS_DIR, timeout_s: float = 0.0, smoke: bool = False) -> dict:
    """Trace one cell (an LM cell fitted, :func:`trace_lm_cell`); its record
    (written to ``results_dir``, read back unless ``force``).
    ``timeout_s``: a trace that takes longer fails as data (TimeoutError);
    ``smoke``: the CPU-test scale."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    os.makedirs(results_dir, exist_ok=True)
    out_path = os.path.join(results_dir, f"{mesh_name}__{kind}__{name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    mesh = production_mesh(mesh_name)
    rec = {"kind": kind, "cell": name, "mesh": mesh_name,
           "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)), "ok": False}
    device_type = mesh.device_type
    t0 = time.time()
    try:
        deadline = _Deadline(timeout_s) if timeout_s else contextlib.nullcontext()
        if kind == "lm":
            parts = name.split("@")
            arch, shape_name = parts[0], parts[1]
            overrides = VARIANTS[parts[2]] if len(parts) > 2 else None
            tr, meta = trace_lm_cell(arch, shape_name, mesh, overrides, smoke=smoke,
                                     deadline=deadline)
        else:
            with FakeTensorMode(allow_non_fake_inputs=True), deadline:
                graph, algo, strategy = name.split("@")
                fn, args, meta = build_pmv_cell(graph, algo, strategy, mesh)
                tr = trace_step(fn, args)
        lower_s = time.time() - t0

        analytic = None
        if kind == "lm":
            arch, shape_name = name.split("@")[:2]
            seq, batch, mode = (SMOKE_SHAPES if smoke else configs_lib.SHAPES)[shape_name]
            cfg = meta["cfg"]
            analytic = flops_lib.cell_cost(
                cfg, mode, seq, batch,
                grad_accum=meta.get("grad_accum", 1),
                enc_len=(seq if mode != "decode" else meta.get("enc_len", 0))
                if cfg.family == "encdec" else 0,
                vis_tokens=cfg.n_vision_tokens,
            ).as_dict()
        coll, mem = tr["collectives"], tr["memory"]
        rec.update(
            ok=True, hlo=None,      # the JAX record's HLO file: the port has none
            lower_s=round(lower_s, 1), compile_s=0.0,
            memory=mem, cost={"flops": tr["flops"]}, collectives=coll, analytic=analytic,
            meta={**{k: v for k, v in (meta or {}).items()
                     if not hasattr(v, "dtype") and k != "cfg"}, "device_type": device_type,
                  "parallelism": _parallelism(kind, meta)},
        )
        print(f"[dryrun] {mesh_name} {kind} {name}: OK "
              f"flops={tr['flops']:.3e} "
              f"coll={coll['bytes']['total']:.3e}B "
              f"temp={mem['temp_bytes'] / 2**30:.2f}GiB "
              f"(trace {rec['lower_s']:.0f}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — failures are data, not crashes
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[dryrun] {mesh_name} {kind} {name}: FAIL {type(e).__name__}: {e}", flush=True)

    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def all_cells():
    cells = []
    for arch in configs_lib.ARCHS:
        for shape_name, *_ in configs_lib.cells(arch):
            cells.append(("lm", f"{arch}@{shape_name}"))
    for graph, algo, strategy in PMV_CELLS:
        cells.append(("pmv", f"{graph}@{algo}@{strategy}"))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--variant", default=None, choices=list(VARIANTS))
    ap.add_argument("--pmv-cell", help="graph@algo@strategy")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    kw = {"force": args.force, "results_dir": args.results_dir,
          "timeout_s": ALL_CELL_TIMEOUT_S if args.all else 0.0}
    results = []
    if args.all:
        for mesh_name in meshes:
            for kind, name in all_cells():
                results.append(run_cell(kind, name, mesh_name, **kw))
    elif args.pmv_cell:
        for mesh_name in meshes:
            results.append(run_cell("pmv", args.pmv_cell, mesh_name, **kw))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all / --pmv-cell)")
        cell = f"{args.arch}@{args.shape}" + (f"@{args.variant}" if args.variant else "")
        for mesh_name in meshes:
            results.append(run_cell("lm", cell, mesh_name, **kw))

    n_ok = sum(r["ok"] for r in results)
    print(f"[dryrun] {n_ok}/{len(results)} cells OK", flush=True)
    with contextlib.suppress(Exception):
        import torch.distributed as dist

        dist.destroy_process_group()
    if n_ok < len(results):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
