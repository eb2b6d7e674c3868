"""The one-launch ``nb_stats`` kernel's plan and reduction, on the CPU.

The kernel's row splits are a function of ``(n, d, C)`` alone and cover
every row once; its form (register sums or shared-memory sums) follows
from ``(C, d)``; its workspace holds the ticket and one partial per split,
one buffer per (device, stream).  The plain form of its reduction
(``ref.py::grouped_stats_split``: one fp32 partial G per split, summed in
split order) agrees with ``repro``'s Pallas ``nb_stats`` in interpret mode
and with its jnp oracle at ``tests/test_kernels.py``'s tolerances (counts
exact; S rtol 1e-4 / atol 1e-3, SS atol 1e-2, per 1024 rows: fp32 sums in
another order).  ``core/naive_bayes.py::compute_gaussian_stats`` copies G
to the host once and splits it there, bitwise the old per-block copy
(``kernels/common.py::to_host``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.nb_stats import ops as jax_nb  # noqa: E402
from repro.kernels.nb_stats.ref import nb_stats_ref as jax_ref  # noqa: E402
from repro_torch.core import naive_bayes  # noqa: E402
from repro_torch.kernels.common import StreamWorkspace, cdiv, to_host  # noqa: E402
from repro_torch.kernels.nb_stats import kernel as nk  # noqa: E402
from repro_torch.kernels.nb_stats import ops  # noqa: E402
from repro_torch.kernels.nb_stats.ref import grouped_stats_split  # noqa: E402


def _data(n, d, c, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    return X, y


def _close(got, want, n):
    scale = max(1.0, n / 1024)
    counts, S, SS = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0], counts)
    np.testing.assert_allclose(got[1], S, rtol=1e-4, atol=1e-3 * scale)
    np.testing.assert_allclose(got[2], SS, rtol=1e-4, atol=1e-2 * scale)


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 13])
@pytest.mark.parametrize("d", [1, 7, 10, 15, 16, 17, 64, 129])
@pytest.mark.parametrize("n", [1, 255, 50_000, 5_000_000])
def test_split_plan_covers_every_row_once(n, d, c):
    splits, rows = nk.splits_for(n, d, c)
    assert splits >= 1 and (splits - 1) * rows < n <= splits * rows
    assert nk.splits_for(n, d, c) == (splits, rows)       # the shape alone decides
    k = c * (1 + 2 * d)
    assert nk.plan(n, d, c) == (splits, rows, int(nk.narrow(c, d)),
                                nk.TICKET_FLOATS + k * splits)
    if nk.narrow(c, d):
        assert splits <= nk.MAX_NARROW_SPLITS
        if n >= nk.SMS * nk.SPLIT_ROWS:                  # every SM has work
            assert splits >= nk.SMS
    else:
        assert splits == 1 or (splits * cdiv(d, nk.COLS) <= nk.MAX_WIDE_BLOCKS
                                and splits * k <= nk.WIDE_PARTIALS)


def test_split_plan_at_the_query_and_the_table():
    assert nk.plan(50_000, 10, 2) == (132, 379, 1, 4 + 42 * 132)
    assert nk.plan(5_000_000, 10, 2) == (264, 18940, 1, 4 + 42 * 264)


@pytest.mark.parametrize("c,d,narrow", [
    (1, 16, True), (1, 17, False), (2, 10, True), (2, 15, True), (2, 16, False),
    (3, 10, True), (3, 11, False), (4, 7, True), (4, 8, False), (5, 1, False)])
def test_narrow_form_is_what_the_register_budget_holds(c, d, narrow):
    """C·(2d+1) register sums, at most 64, d ≤ 16 and C ≤ 4: the widest d
    the kernel instantiates per C (``nb_stats.cu::narrow_d``) is 16, 15,
    10 and 7."""
    assert nk.narrow(c, d) is narrow
    assert (not narrow) or c * (2 * d + 1) <= nk.NARROW_SUMS


@pytest.mark.parametrize("c", [2, 3, 13])
@pytest.mark.parametrize("d", [5, 10, 129])
@pytest.mark.parametrize("n", [100, 4097, 70_000])
def test_split_ordered_sum_matches_jax(n, d, c):
    X, y = _data(n, d, c, n + d + c)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    G = grouped_stats_split(Xt, yt, c, *nk.splits_for(n, d, c)).numpy()
    assert G.shape == (c, 1 + 2 * d)
    want = jax_ref(jnp.asarray(X), jnp.asarray(y), c)
    _close((G[:, 0], G[:, 1:1 + d], G[:, 1 + d:]), want, n)
    if n <= 4097:                          # the interpreter walks 256-row blocks
        _close((G[:, 0], G[:, 1:1 + d], G[:, 1 + d:]),
               jax_nb.nb_stats(X, y, c, block_n=256), n)


@pytest.mark.parametrize("c", [2, 13])
@pytest.mark.parametrize("n,d", [(700, 9), (3000, 10), (1, 3)])
def test_host_split_of_G_matches_jax(n, d, c):
    X, y = _data(n, d, c, 3 * n + d)
    y[::7] = -1          # unlabelled rows (the TPU wrapper's padding) count nowhere
    st = naive_bayes.compute_gaussian_stats(torch.from_numpy(X), torch.from_numpy(y), c)
    for got in (st.counts, st.S, st.SS):
        assert got.dtype == np.float64 and got.flags.c_contiguous
    assert st.S.shape == (c, d) and st.SS.shape == (c, d) and st.counts.shape == (c,)
    got = (st.counts, st.S, st.SS)
    keep = y >= 0                     # the oracle's one-hot takes labels in [0, C)
    _close(got, jax_ref(jnp.asarray(X[keep]), jnp.asarray(y[keep]), c), n)
    _close(got, jax_nb.nb_stats(X, y, c, block_n=256), n)


@pytest.mark.parametrize("lo,hi", [(0, 4096), (1, 4097), (3, 50_003), (17, 18)])
def test_compute_stats_single_copy_is_the_old_copy_bitwise(lo, hi):
    """The engine's fetches are views at any row offset (odd ones too)."""
    X, y = _data(50_010, 10, 2, 11)
    Xt, yt = torch.from_numpy(X)[lo:hi], torch.from_numpy(y)[lo:hi]
    got = naive_bayes.compute_gaussian_stats(Xt, yt, 2)
    counts, S, SS = to_host(*ops.nb_stats(Xt, yt, 2))     # the copy it replaces
    np.testing.assert_array_equal(got.counts, counts)
    np.testing.assert_array_equal(got.S, S)
    np.testing.assert_array_equal(got.SS, SS)


@pytest.mark.parametrize("n,d,c", [(1, 3, 2), (257, 10, 2), (4097, 16, 13), (600, 130, 3)])
def test_grouped_stats_blocks_are_nb_stats_bitwise(n, d, c):
    X, y = _data(n, d, c, 13)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    G = ops.grouped_stats(Xt, yt, c)
    counts, S, SS = ops.nb_stats(Xt, yt, c)
    assert G.dtype == torch.float32 and G.shape == (c, 1 + 2 * d)
    assert torch.equal(G[:, 0], counts)
    assert torch.equal(G[:, 1:1 + d], S) and torch.equal(G[:, 1 + d:], SS)


def test_workspace_is_one_buffer_per_device_and_stream(monkeypatch):
    """Zeroed when made, reused while large enough, made anew (zeroed) when a
    call needs more, and never shared by two streams or two devices: a
    ticket left in one stream's buffer is never read by another's launch.
    The buffers are made on the CPU here, each recorded with the CUDA
    device it was asked for."""
    zeros, made = torch.zeros, []

    def on_cpu(*size, device, **kw):
        made.append(device)
        return zeros(*size, **kw)

    monkeypatch.setattr(torch, "zeros", on_cpu)
    ws = StreamWorkspace()
    a = ws.get(0, 11, nk.plan(50_000, 10, 2)[3])
    assert a.numel() == 4 + 42 * 132 and not a.any()
    a[0] = 1.0                                            # a ticket in flight
    assert ws.get(0, 11, 100) is a                        # smaller: reused
    b = ws.get(0, 22, 100)                                # another stream
    assert b is not a and not b.any()
    assert ws.get(1, 11, 100) is not a                    # another device
    big = ws.get(0, 11, nk.plan(5_000_000, 10, 2)[3])     # more: made anew
    assert big is not a and big.numel() == 4 + 42 * 264 and not big.any()
    assert ws.get(0, 11, 10) is big and ws.get(0, 22, 10) is b
    assert made == [torch.device("cuda", i) for i in (0, 0, 1, 0)]


def test_wrapper_validates_before_launch():
    X = torch.zeros((16, 4))
    with pytest.raises(ValueError, match="classes"):
        nk.grouped_stats_cuda(X, torch.zeros(16, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        nk.grouped_stats_cuda(X, torch.zeros(15, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        nk.grouped_stats_cuda(X[:0], torch.zeros(0, dtype=torch.int32), 2)
    with pytest.raises(TypeError):
        nk.grouped_stats_cuda(X.double(), torch.zeros(16, dtype=torch.int32), 2)
