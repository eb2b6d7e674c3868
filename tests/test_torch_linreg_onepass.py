"""The one-launch ``linreg_stats`` kernel's plan and reduction, on the CPU.

The kernel's row splits are a function of ``(n, d)`` alone and cover every
row once; the plain form of its reduction (``ref.py::zt_z_split``: one fp32
partial per split, summed in split order) agrees with ``repro``'s Pallas
``zt_z`` in interpret mode and with its jnp oracle at
``tests/test_kernels.py``'s tolerances (fp32 sums in another order: rtol
5e-4 fp32 / 5e-3 bf16, atol n·2e-2·rtol); and ``core/linreg.py::
compute_stats``, which now copies ``G`` to the host once, gives bitwise the
float64 statistics of the old per-block copy (``kernels/common.py::to_host``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.common import pad_axis, round_up  # noqa: E402
from repro.kernels.linreg_stats.kernel import zt_z as jax_zt_z  # noqa: E402
from repro.kernels.linreg_stats.ref import linreg_stats_ref as jax_ref  # noqa: E402
from repro_torch.core import linreg  # noqa: E402
from repro_torch.kernels.common import to_host  # noqa: E402
from repro_torch.kernels.linreg_stats import kernel as lk  # noqa: E402
from repro_torch.kernels.linreg_stats import ops  # noqa: E402
from repro_torch.kernels.linreg_stats.ref import zt_z_ref, zt_z_split  # noqa: E402



def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("d", [3, 10, 15, 127, 130])
@pytest.mark.parametrize("n", [1, 3, 255, 4097, 50_000, 5_000_000])
def test_split_plan_covers_every_row_once(n, d):
    splits, rows = lk.splits_for(n, d)
    assert splits >= 1 and (splits - 1) * rows < n <= splits * rows
    assert lk.splits_for(n, d) == (splits, rows)          # (n, d) alone decide
    assert lk.plan(n, d) == (splits, rows, int(d + 1 <= lk.NARROW_D),
                             lk.TICKET_FLOATS + lk.partial_floats(splits, d))
    if lk.narrow(d):
        assert splits <= lk.MAX_NARROW_SPLITS
        if n >= lk.SMS * lk.NARROW_SPLIT_ROWS:               # every SM has work
            assert splits >= lk.SMS
    else:
        assert splits * lk.cdiv(d + 1, lk.TILE) ** 2 <= lk.MAX_BLOCKS


def test_split_plan_at_the_query_and_the_table():
    assert lk.splits_for(50_000, 10) == (132, 379)
    assert lk.splits_for(5_000_000, 10) == (264, 18940)


def _jax_zt_z(Z):
    """``repro``'s Pallas kernel in interpret mode on the padded ``Z``."""
    n, dz = Z.shape
    Zp = pad_axis(pad_axis(jnp.asarray(Z), 1, round_up(dz, 128)), 0, round_up(max(n, 512), 512))
    return np.asarray(jax_zt_z(Zp, block_n=512, interpret=True))[:dz, :dz]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [3, 10, 15, 130])
@pytest.mark.parametrize("n", [3, 255, 4097, 50_000])
def test_split_ordered_sum_matches_jax(n, d, bf16):
    X, y = _rand((n, d), n + d), _rand((n,), n + d + 1)
    if bf16:
        X, y = X.astype(jnp.bfloat16), y.astype(jnp.bfloat16)
    dtype = torch.bfloat16 if bf16 else torch.float32
    Xt = torch.from_numpy(np.asarray(X, np.float32)).to(dtype)
    yt = torch.from_numpy(np.asarray(y, np.float32)).to(dtype)
    G = zt_z_split(Xt, yt, *lk.splits_for(n, d)).numpy()
    assert G.shape == (d + 1, d + 1)
    rtol = 5e-3 if bf16 else 5e-4
    atol = n * 2e-2 * rtol
    A, B = jax_ref(jnp.asarray(X), jnp.asarray(y))
    y64 = np.asarray(y, np.float64)
    np.testing.assert_allclose(G[:d, :d], np.asarray(A), rtol=rtol, atol=atol)
    np.testing.assert_allclose(G[:d, d], np.asarray(B), rtol=rtol, atol=atol)
    np.testing.assert_allclose(G[d, d], y64 @ y64, rtol=rtol, atol=atol)
    if n <= 4097:                          # the interpreter walks 512-row blocks
        Z = np.concatenate([np.asarray(X), np.asarray(y)[:, None]], 1)
        np.testing.assert_allclose(G, _jax_zt_z(Z), rtol=rtol, atol=atol)
    # and the CPU route of the kernel's wrapper, G assembled from A, B, yᵀy
    np.testing.assert_allclose(ops.zt_z(Xt, yt).numpy(), G, rtol=rtol, atol=atol)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,d", [(1, 3), (257, 10), (4097, 10), (3000, 15), (600, 130)])
def test_zt_z_blocks_are_linreg_stats_bitwise(n, d, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    X = torch.from_numpy(_rand((n, d), 5)).to(dtype)
    y = torch.from_numpy(_rand((n,), 6)).to(dtype)
    G = ops.zt_z(X, y)
    A, B, yty = ops.linreg_stats(X, y, with_yty=True)
    assert G.dtype == torch.float32 and G.shape == (d + 1, d + 1)
    assert torch.equal(G[:d, :d], A) and torch.equal(G[:d, d], B)
    assert torch.equal(G[d, :d], B) and torch.equal(G[d, d], yty)
    assert torch.equal(zt_z_ref(X, y), G)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("lo,hi", [(0, 4096), (1, 4097), (3, 50_003), (17, 18)])
def test_compute_stats_single_copy_is_the_old_copy_bitwise(lo, hi, bf16):
    """The engine's fetches are views at any row offset (odd ones too)."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    X = torch.from_numpy(_rand((50_010, 10), 7)).to(dtype)[lo:hi]
    y = torch.from_numpy(_rand((50_010,), 8)).to(dtype)[lo:hi]
    got = linreg.compute_stats(X, y)
    A, B = to_host(*ops.linreg_stats(X, y))          # the copy it replaces
    assert got.A.dtype == np.float64 and got.B.dtype == np.float64
    assert got.A.flags.c_contiguous and got.B.flags.c_contiguous
    np.testing.assert_array_equal(got.A, A)
    np.testing.assert_array_equal(got.B, B)
    assert float(got.n) == hi - lo
