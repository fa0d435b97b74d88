"""Build and load the CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library for Hopper (``sm_90a``), at first use, into
``build/kernels/<hash>/`` under the repository root (or the directory named
by ``REPRO_TORCH_BUILD_DIR``).  The hash covers every source and the flags,
so an edited kernel is rebuilt and an unchanged one is reused.  All sources
compile in parallel, one ``nvcc`` each.  The libraries are loaded with
``ctypes``; each exported function returns the ``cudaError_t`` of its
launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build_all", "load", "check_rc", "build_dir", "SOURCES"]

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = {
    "ell_gimv": "ell_gimv.cu",
    "dense_gimv": "dense_gimv.cu",
    "scatter_combine": "scatter_combine.cu",
    "ell_gimv_multi": "ell_gimv_multi.cu",
    "dense_gimv_multi": "dense_gimv_multi.cu",
    "scatter_combine_multi": "scatter_combine_multi.cu",
    "packed_scatter_combine": "packed_scatter_combine.cu",
    "packed_scatter_combine_multi": "packed_scatter_combine_multi.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # cols, w, v, out, rows, width, semiring, vtype, stream
    "ell_gimv": [_P, _P, _P, _P, _LL, _I, _I, _I, _P],
    # m, v, out, rows, k, semiring, vtype, stream
    "dense_gimv": [_P, _P, _P, _LL, _I, _I, _I, _P],
    # idx, val, out, sets, senders, cap, n_local, semiring, vtype, stream
    "scatter_combine": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # cols, w, v, out, rows, width, nq, semiring, vtype, stream
    "ell_gimv_multi": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    # m, v, out, rows, k, nq, semiring, vtype, stream
    "dense_gimv_multi": [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
    # idx, val, out, sets, senders, cap, n_local, nq, semiring, vtype, stream
    "scatter_combine_multi": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # words, val, out, sets, set_slots, senders, n_local, n_out, width, semiring, vtype, stream
    "packed_scatter_combine": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # words, val, out, sets, set_slots, senders, n_local, n_out, nq, width, semiring, vtype,
    # stream
    "packed_scatter_combine_multi": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_FNS: dict = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_all(*, verbose: bool = False) -> dict[str, Path]:
    """Compile every kernel library that is not built yet (all at once, one
    nvcc process per source) and return {name: path}.  ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler's report (registers, spills)."""
    out_dir = build_dir() / _source_hash()
    targets = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    missing = [name for name, path in targets.items() if not path.exists()]
    if not missing:
        return targets
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in missing:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        log_path = out_dir / f"{name}.{os.getpid()}.log"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / SOURCES[name])]
        log = open(log_path, "w")
        jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log, log_path)
    errors = []
    for name, (proc, tmp, log, log_path) in jobs.items():
        rc = proc.wait()
        log.close()
        text = log_path.read_text()
        log_path.unlink(missing_ok=True)
        if rc != 0:
            errors.append(f"nvcc failed for {SOURCES[name]} (exit {rc}):\n{text}")
            continue
        os.replace(tmp, targets[name])
        if verbose and text.strip():
            print(f"[nvcc {SOURCES[name]}]\n{text.rstrip()}", flush=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def load(name: str):
    """The C entry point ``name`` of its built library, with argtypes set."""
    fn = _FNS.get(name)
    if fn is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _FNS[name] = fn
    return fn


def check_rc(rc: int, name: str) -> None:
    """Raise when a kernel entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {rc}")
