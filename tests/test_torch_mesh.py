"""The mesh slice's rules on the CPU, in one process: the port's sharding
specs against the JAX package's on abstract meshes (every per-layer
parameter and train-state leaf, the batch and the caches of all ten
architectures, smoke and full configs), ``launch.mesh``'s helpers,
``roofline_row`` and ``collective_totals``.

The port keeps one module per layer where the JAX package stacks a scanned
stack's layers under a leading axis, so a port spec is held to the JAX
spec of its stacked leaf with that (replicated) leading entry removed.  The
port's shapes come from models built under ``FakeTensorMode`` (nothing is
allocated), the JAX package's from ``jax.eval_shape``."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh

from repro import configs as jconfigs
from repro.models import sharding as jsh
from repro.models.model import build_model as j_build_model
from repro.training.train_step import TrainConfig as JTrainConfig
from repro.training.train_step import init_train_state as j_init_train_state
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import sharding as tsh
from repro_torch.models.convert import flatten_tree

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
STACKS = ("blocks", "enc_blocks", "dec_blocks")
CACHE_SHAPES = {"smoke": (8, 64), "full": (128, 32_768)}


def _norm(spec) -> tuple:
    """A PartitionSpec or a port spec as a tuple of None / name / names."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, (tuple, list)) else e)
    return tuple(out)


def _jax_name(port_name: str) -> tuple[str, int]:
    """(JAX flat name, stacked dims dropped) of a port leaf name."""
    parts = port_name.split(".")
    if parts[0] in STACKS and len(parts) > 2:
        return ".".join([parts[0]] + parts[2:]), 1
    return port_name, 0


def _flat_specs(tree, prefix: str = "") -> dict:
    """A port spec tree (dicts / lists, tuple leaves) -> {dotted name: spec}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _jax_specs(shardings) -> dict:
    return {k: _norm(v.spec) for k, v in flatten_tree(shardings).items()}


def _port_vs_jax(port_specs: dict, jax_specs: dict):
    assert port_specs, "no leaves"
    seen = set()
    for name, spec in port_specs.items():
        jname, lead = _jax_name(name)
        want = jax_specs[jname]
        assert all(e is None for e in want[:lead]), (jname, want)
        assert _norm(spec) == want[lead:], (name, spec, want)
        seen.add(jname)
    assert seen == set(jax_specs), sorted(set(jax_specs) - seen)[:5]


class Shapes:
    """One config's abstract trees in both packages: parameters, train
    state, batch and caches."""

    def __init__(self, arch: str, kind: str):
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.models.model import build_model
        from repro_torch.training.train_step import TrainConfig, init_train_state

        get_j = jconfigs.config_for if kind == "full" else jconfigs.smoke_config
        get_t = tconfigs.config_for if kind == "full" else tconfigs.smoke_config
        self.jcfg, self.tcfg = get_j(arch), get_t(arch)
        assert dataclasses.asdict(self.jcfg) == dataclasses.asdict(self.tcfg)
        jm = j_build_model(self.jcfg)
        self.j_params = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
        self.j_state = jax.eval_shape(lambda p: j_init_train_state(jm, p, JTrainConfig()),
                                      self.j_params)
        batch, seq = CACHE_SHAPES[kind]
        enc = 16 if self.jcfg.family == "encdec" else 0
        self.j_cache = jax.eval_shape(lambda: jm.init_cache(batch, seq, enc_len=enc))
        self.j_batch = {"tokens": jax.ShapeDtypeStruct((batch, seq), jnp.int32)}
        with FakeTensorMode():
            tm = build_model(self.tcfg, "cpu")
            self.t_params = tm.params()
            self.t_state = init_train_state(tm, self.t_params, TrainConfig())
            self.t_cache = tm.init_cache(batch, seq, enc_len=enc)
        self.t_batch = {"tokens": np.zeros((batch, seq), np.int32)}


@pytest.fixture(scope="module")
def shapes():
    cache = {}

    def get(arch, kind):
        if (arch, kind) not in cache:
            cache[arch, kind] = Shapes(arch, kind)
        return cache[arch, kind]
    return get


def _meshes(name):
    shape, names = MESHES[name]
    return JAbstractMesh(shape, names), AbstractMesh(shape, names)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", ["smoke", "full"])
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_param_and_state_specs_match_jax(shapes, arch, kind, mesh):
    """Every per-layer parameter leaf, and every moment of the train state
    (moments mirror the parameters; scalars replicate), gets the JAX spec
    of its stacked leaf with the stacked dim removed."""
    s = shapes(arch, kind)
    jm, tm = _meshes(mesh)
    _port_vs_jax(tsh.param_shardings(s.t_params, tm),
                 _jax_specs(jsh.param_shardings(s.j_params, jm)))
    t_state = tsh.param_shardings(s.t_state, tm)
    j_state = jsh.param_shardings(s.j_state, jm)
    for m in ("mu", "nu"):
        _port_vs_jax(t_state["opt"][m], _jax_specs(j_state["opt"][m]))
    assert t_state["step"] == t_state["opt"]["step"] == ()
    assert _norm(j_state["step"].spec) == _norm(j_state["opt"]["step"].spec) == ()


@pytest.mark.parametrize("seq_shard", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", ["smoke", "full"])
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_batch_and_cache_specs_match_jax(shapes, arch, kind, mesh, seq_shard):
    """batch_shardings, and cache_shardings with decode_seq_shard on and
    off (a long KV / MLA latent sequence over 'model' when it divides and is
    at least 4x the axis), equal the JAX package's."""
    s = shapes(arch, kind)
    jm, tm = _meshes(mesh)
    assert _norm(tsh.batch_shardings(s.t_batch, tm)["tokens"]) == \
        _norm(jsh.batch_shardings(s.j_batch, jm)["tokens"].spec)
    jcfg = dataclasses.replace(s.jcfg, decode_seq_shard=seq_shard)
    tcfg = dataclasses.replace(s.tcfg, decode_seq_shard=seq_shard)
    _port_vs_jax(_flat_specs(tsh.cache_shardings(s.t_cache, tm, tcfg)),
                 _jax_specs(jsh.cache_shardings(s.j_cache, jm, jcfg)))


def test_mesh_helpers():
    """data_axes / model_axis / worker_axes over a mesh's dim names, the
    production shapes, and make_production_mesh refusing a world size that
    is neither 256 nor 512, naming both."""
    for shape, names in MESHES.values():
        m = AbstractMesh(shape, names)
        assert tmesh.data_axes(m) == tuple(a for a in names if a in ("pod", "data"))
        assert tmesh.model_axis(m) == "model"
        assert tmesh.worker_axes(m) == names
    assert tmesh.SINGLE_POD == ((16, 16), ("data", "model"))
    assert tmesh.MULTI_POD == ((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(RuntimeError, match="256"):
        tmesh.make_production_mesh()     # no process group in this process


def test_make_production_mesh_names_both_sizes(tmp_path):
    """On a one-rank group the production mesh raises ValueError naming
    256 and 512 (run in a fresh interpreter: a process group lives for the
    process)."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import torch.distributed as dist, sys\n"
        f"dist.init_process_group('gloo', init_method='file://{tmp_path}/s', rank=0,"
        " world_size=1)\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "for multi in (False, True):\n"
        "    try:\n"
        "        make_production_mesh(multi_pod=multi, device_type='cpu')\n"
        "    except ValueError as e:\n"
        "        print('ERR', e)\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("ERR")]
    assert len(lines) == 2, out.stderr[-2000:]
    for ln in lines:
        assert "256" in ln and "512" in ln


def test_placements_of_a_split_dim():
    """A dim split over ('pod', 'data') takes the pod mesh dim first; a
    split against the mesh order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    m = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert tsh.placements((("pod", "data"), None, "model"), m) == (Shard(0), Shard(0), Shard(2))
    assert tsh.placements((None, None), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        tsh.placements((("data", "pod"),), m)


RECORD = {
    "kind": "lm", "cell": "qwen3_1_7b@train_4k", "mesh": "single",
    "mesh_shape": {"data": 16, "model": 16}, "ok": True,
    "collectives": {"bytes": {"total": 3.5e9}},
    "analytic": {"flops": 2.1e16, "hbm_bytes": 4.0e13, "model_flops": 1.8e16},
    "memory": {"argument_bytes": 1.5e8},
}


def _jax_formula(rec, peak, hbm, link_bw, links):
    """The JAX package's roofline_row terms with its constants swapped."""
    chips = int(np.prod(list(rec["mesh_shape"].values())))
    ana = rec["analytic"]
    t_comp = ana["flops"] / (chips * peak)
    t_mem = ana["hbm_bytes"] / (chips * hbm)
    t_coll = rec["collectives"]["bytes"]["total"] / (links * link_bw)
    total = max(t_comp, t_mem, t_coll)
    return {"t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
            "roofline_frac": ana["model_flops"] / (chips * peak) / total,
            "useful_ratio": ana["model_flops"] / ana["flops"]}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_roofline_row_is_the_jax_formula_on_h100(mesh):
    """roofline_row of a fixed record is the JAX package's formula with the
    H100 SXM constants in place of the TPU's; a mesh of more than 8 GPUs is
    flagged as crossing nodes."""
    from repro_torch.launch import roofline as rf

    rec = dict(RECORD, mesh=mesh, mesh_shape={"data": 16, "model": 16} if mesh == "single"
               else {"pod": 2, "data": 16, "model": 16})
    row = rf.roofline_row(rec)
    want = _jax_formula(rec, rf.H100.peak_flops_bf16, rf.H100.hbm_bw, rf.H100.nvlink_bw, 1)
    for k, v in want.items():
        assert row[k] == pytest.approx(v, rel=1e-12), k
    assert rf.H100.peak_flops_bf16 == 989e12 and rf.H100.hbm_bw == 3.35e12
    assert rf.H100.nvlink_bw == 450e9
    assert row["crosses_nodes"] is True
    assert row["dominant"] == max(("compute", "memory", "collective"),
                                  key=lambda t: row[f"t_{t}_s"])
    assert rf.roofline_row(dict(rec, ok=False)) is None
    small = rf.roofline_row(dict(rec, mesh_shape={"data": 2, "model": 4}))
    assert small["crosses_nodes"] is False


def test_collective_totals_of_a_hand_made_record():
    """collective_totals sums each kind's bytes under the JAX package's five
    kind names, counts them, keeps raw bytes (eager tracing: every op is one
    execution) and the 12 largest."""
    from repro_torch.launch.hlo_analysis import KINDS, collective_totals

    rec = [("all-gather", 100.0, "ag0"), ("all-gather", 300.0, "ag1"),
           ("reduce-scatter", 50.0, "rs"), ("all-reduce", 4.0, "ar")]
    rec += [("collective-permute", float(i), f"p{i}") for i in range(1, 12)]
    out = collective_totals(rec)
    assert KINDS == ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                     "collective-permute")
    assert out["bytes"] == {"all-gather": 400.0, "all-reduce": 4.0, "reduce-scatter": 50.0,
                            "all-to-all": 0.0, "collective-permute": 66.0, "total": 520.0}
    assert out["raw_bytes"] == out["bytes"]
    assert out["counts"] == {"all-gather": 2, "all-reduce": 1, "reduce-scatter": 1,
                             "all-to-all": 0, "collective-permute": 11}
    assert len(out["top"]) == 12
    assert [t["bytes"] for t in out["top"][:3]] == [300.0, 100.0, 50.0]
    assert set(out["top"][0]) == {"kind", "bytes", "mult", "effective", "comp", "line"}
    assert collective_totals([])["bytes"]["total"] == 0.0
