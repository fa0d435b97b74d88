"""The Hopper kernels against their plain versions, on the card.  Marked
``cuda``: they skip on a host without a GPU, and this file imports neither
JAX nor the JAX package so that it runs where only PyTorch is installed:

    python3 -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import block_gimv, ell_spmv, scatter_combine

SEMIRINGS = ["plus_times", "min_plus", "max_plus", "min_src"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _assert_match(got, want, semiring, dtype):
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    if semiring == "plus_times" and dtype == np.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got, want)


def _values(rng, shape, dtype):
    return (rng.integers(-50, 50, shape) if dtype == np.int32 else rng.random(shape)).astype(dtype)


def _compacted(rng, sets, senders, cap, n_local):
    """Each (s, k) row: strictly ascending unique indices padded with n_local."""
    idx = np.full((sets, senders, cap), n_local, np.int32)
    for s in range(sets):
        for k in range(senders):
            cnt = int(rng.integers(0, min(cap, n_local) + 1))
            idx[s, k, :cnt] = np.sort(rng.choice(n_local, cnt, replace=False))
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_cuda_kernels_match_plain_versions(cuda_device, semiring, dtype):
    rng = np.random.default_rng(11)
    put = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    before = kernels.launch_counts()

    deg = rng.integers(0, 71, 1000)
    cols = np.where(np.arange(70)[None, :] < deg[:, None], rng.integers(0, 3000, (1000, 70)), -1)
    w = (rng.integers(1, 4, cols.shape) if dtype == np.int32 else rng.random(cols.shape))
    args = (put(cols.astype(np.int32)), put(w.astype(np.float32)), put(_values(rng, 3000, dtype)))
    _assert_match(ell_spmv.ell_gimv(*args, semiring=semiring),
                  ell_spmv.ell_gimv_ref(*args, semiring=semiring), semiring, dtype)

    m = rng.random((999, 1232))
    m = (m > 0.7) if semiring == "min_src" else (np.round(m * 6) - 3 if dtype == np.int32 else m)
    m, v = put(m.astype(np.float32)), put(_values(rng, 1232, dtype))
    _assert_match(block_gimv.dense_gimv(m, v, semiring=semiring),
                  block_gimv.dense_gimv_ref(m, v, semiring=semiring), semiring, dtype)

    idx = put(_compacted(rng, 8, 8, 300, 500))
    val = put(_values(rng, tuple(idx.shape), dtype))
    _assert_match(scatter_combine.scatter_combine_gimv(idx, val, 500, semiring=semiring),
                  scatter_combine.scatter_combine_ref(idx, val, 500, semiring=semiring),
                  semiring, dtype)
    after = kernels.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)


@pytest.mark.cuda
def test_cuda_engine_runs_on_the_kernels(cuda_device):
    """A small planned solve on the card launches the kernels and equals the
    same solve through the plain versions on the host."""
    from repro_torch.core import PMVEngine, sssp
    from repro_torch.graph import rmat

    edges = rmat(12, 8 << 12, seed=3)
    kw = dict(b=4, strategy="vertical", backend="auto", scatter="kernel", stream="off")
    kernels.reset_launch_counts()
    on_card = PMVEngine(edges, 1 << 12, device="cuda", **kw).run(sssp(0), tol=0.5)
    counts = kernels.launch_counts()
    on_host = PMVEngine(edges, 1 << 12, device="cpu", **kw).run(sssp(0), tol=0.5)
    assert counts["ell_gimv"] > 0 and counts["scatter_combine"] > 0
    np.testing.assert_array_equal(on_card.v, on_host.v)
    assert on_card.iterations == on_host.iterations
