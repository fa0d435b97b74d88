"""What the benches under ``tools/`` share: the card's name and power limit,
CUDA-event timing in alternating rounds, and kernel entry points built with
nvcc from a ``kernels/csrc`` directory other than this tree's (another
checkout's, or a copy with some constants changed), called through ctypes
with this tree's argument types.

Imported by ``tools/bench_*.py``, which run from the repository root on a
machine with one CUDA card; importing it also puts ``src/`` on the path.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def event_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graphed(torch, fn, calls: int):
    """A callable that replays ``calls`` back-to-back calls of ``fn``
    captured in one CUDA graph: timing it leaves out the host's work
    between launches, which at ~0.02 ms a kernel can be most of an eager
    call's time.  ``fn`` must allocate and launch only (no synchronize)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph.replay


def alternate(torch, sides, rounds: int, reps: int, label: str | None = None) -> dict:
    """{name: [ms a round]} for each (name, fn) of ``sides``, timed in
    ``rounds`` rounds where the sides take turns to go first; with a
    ``label`` one line a round is printed."""
    got = {name: [] for name, _ in sides}
    for r in range(rounds):
        k = r % len(sides)
        for name, fn in sides[k:] + sides[:k]:
            got[name].append(event_ms(torch, fn, reps))
        if label is not None:
            print(f"{label} round {r}: " + ", ".join(
                f"{name} {got[name][-1]:.4f} ms" for name, _ in sides), flush=True)
    return got


def nvcc_libs(jobs: dict[str, tuple[Path, Path]]) -> None:
    """Compile each job's source into its shared library, one nvcc each,
    all started together, with this tree's flags: ``jobs`` maps a label to
    (source .cu, library .so), and a source includes from its own
    directory."""
    from repro_torch.kernels import build

    procs = {}
    for label, (src, lib) in jobs.items():
        lib.parent.mkdir(parents=True, exist_ok=True)
        procs[label] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    for label, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {jobs[label][0]} ({label}):\n{text}")
    if failed:
        raise SystemExit("\n".join(failed))


def load_entries(trees: dict[str, Path], names, out_root: Path) -> dict[str, dict]:
    """The C entry points ``names`` built from each tree's csrc directory
    (``trees`` maps a tag to it) into ``out_root / tag``, every build at
    once: {tag: {name: ctypes function with this tree's argtypes}}.  They
    carry no launch counts and no checks."""
    from repro_torch.kernels import build

    jobs = {f"{tag}/{name}": (csrc / build.SOURCES[name], out_root / tag / f"lib{name}.so")
            for tag, csrc in trees.items() for name in names}
    nvcc_libs(jobs)
    entries = {tag: {} for tag in trees}
    for key, (_, lib) in jobs.items():
        tag, name = key.split("/")
        fn = getattr(ctypes.CDLL(str(lib)), name)
        fn.restype = ctypes.c_int
        fn.argtypes = build._ARGTYPES[name]
        entries[tag][name] = fn
    return entries
