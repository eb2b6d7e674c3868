"""The port's analytics kernels' plain versions against the JAX package.

Same numpy inputs (``np.random.default_rng``) go through ``repro``'s
oracles (``repro.kernels.*.ref``, pure jnp) over the shape sweeps of
``tests/test_kernels.py``, and once per kernel through ``repro``'s Pallas
``ops`` entry point in interpret mode; the port's wrappers get CPU tensors
and route to their plain PyTorch versions.  Tolerances are
``tests/test_kernels.py``'s own: fp32 sums taken in another order.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.linreg_stats import ops as jax_linreg  # noqa: E402
from repro.kernels.linreg_stats.ref import linreg_stats_ref  # noqa: E402
from repro.kernels.logreg_sgd import ops as jax_logreg  # noqa: E402
from repro.kernels.logreg_sgd.ref import logreg_sgd_ref  # noqa: E402
from repro.kernels.nb_stats import ops as jax_nb  # noqa: E402
from repro.kernels.nb_stats.ref import nb_stats_ref  # noqa: E402
from repro_torch.kernels.common import round_up  # noqa: E402
from repro_torch.kernels.linreg_stats import kernel as linreg_kernel  # noqa: E402
from repro_torch.kernels.linreg_stats import ops as linreg_ops  # noqa: E402
from repro_torch.kernels.logreg_sgd import kernel as logreg_kernel  # noqa: E402
from repro_torch.kernels.logreg_sgd import ops as logreg_ops  # noqa: E402
from repro_torch.kernels.nb_stats import kernel as nb_kernel  # noqa: E402
from repro_torch.kernels.nb_stats import ops as nb_ops  # noqa: E402


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a, dtype=torch.float32):
    """numpy (fp32 or ml_dtypes bf16) → torch, exactly."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _launches():
    return (linreg_kernel.KERNEL.launches, nb_kernel.KERNEL.launches,
            logreg_kernel.KERNEL.launches)


# -- linreg statistics ------------------------------------------------------

@pytest.mark.parametrize("n", [64, 513, 2048])
@pytest.mark.parametrize("d", [3, 10, 127, 130])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_linreg_stats_plain_matches_jax_oracle(n, d, bf16):
    X, y = _rand((n, d), 1), _rand((n,), 2)
    if bf16:
        X, y = X.astype(jnp.bfloat16), y.astype(jnp.bfloat16)
    dtype = torch.bfloat16 if bf16 else torch.float32
    before = _launches()
    A, B = linreg_ops.linreg_stats(_t(X, dtype), _t(y, dtype))
    assert _launches() == before                     # CPU: no kernel launch
    Ar, Br = linreg_stats_ref(jnp.asarray(X), jnp.asarray(y))
    rtol = 5e-3 if bf16 else 5e-4
    assert A.dtype == torch.float32 and A.shape == (d, d) and B.shape == (d,)
    np.testing.assert_allclose(A.numpy(), np.asarray(Ar), rtol=rtol, atol=n * 2e-2 * rtol)
    np.testing.assert_allclose(B.numpy(), np.asarray(Br), rtol=rtol, atol=n * 2e-2 * rtol)


def test_linreg_stats_plain_matches_jax_kernel_with_yty():
    X, y = _rand((500, 6), 3), _rand((500,), 4)
    A, B, yty = linreg_ops.linreg_stats(_t(X), _t(y), with_yty=True)
    Aj, Bj, ytyj = jax_linreg.linreg_stats(X, y, block_n=256, with_yty=True)
    np.testing.assert_allclose(A.numpy(), np.asarray(Aj), rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(B.numpy(), np.asarray(Bj), rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(float(yty), float(ytyj), rtol=1e-4)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 50_000, 5_000_000])
@pytest.mark.parametrize("d", [3, 10, 130])
def test_row_splits_cover_every_row_once(n, d):
    for splits_for in (linreg_kernel.splits_for, nb_kernel.splits_for):
        splits, rows = splits_for(n, d)
        assert splits >= 1 and (splits - 1) * rows < n <= splits * rows
        assert splits_for(n, d) == (splits, rows)     # shape alone decides


# -- Gaussian NB grouped statistics ---------------------------------------

@pytest.mark.parametrize("n", [100, 1024])
@pytest.mark.parametrize("d", [5, 64, 129])
@pytest.mark.parametrize("n_classes", [2, 3, 13])
def test_nb_stats_plain_matches_jax_oracle(n, d, n_classes):
    X = _rand((n, d), 5)
    y = np.random.default_rng(6).integers(0, n_classes, n).astype(np.int32)
    c, S, SS = nb_ops.nb_stats(_t(X), torch.from_numpy(y), n_classes)
    cr, Sr, SSr = nb_stats_ref(jnp.asarray(X), jnp.asarray(y), n_classes)
    np.testing.assert_array_equal(c.numpy(), np.asarray(cr))
    np.testing.assert_allclose(S.numpy(), np.asarray(Sr), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(SS.numpy(), np.asarray(SSr), rtol=1e-4, atol=1e-2)


def test_nb_stats_plain_matches_jax_kernel_and_skips_unlabelled_rows():
    X = _rand((700, 9), 7)
    y = np.random.default_rng(8).integers(0, 4, 700).astype(np.int32)
    c, S, SS = nb_ops.nb_stats(_t(X), torch.from_numpy(y), 4)
    cj, Sj, SSj = jax_nb.nb_stats(X, y, 4, block_n=256)
    np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(SS.numpy(), np.asarray(SSj), rtol=1e-4, atol=1e-2)
    # rows labelled outside [0, C) (the TPU wrapper's padding rows) count nowhere
    y_pad = np.concatenate([y, [-1, -1, 4]]).astype(np.int32)
    X_pad = np.concatenate([X, _rand((3, 9), 9)])
    c2, S2, SS2 = nb_ops.nb_stats(_t(X_pad), torch.from_numpy(y_pad), 4)
    assert torch.equal(c2, c)
    torch.testing.assert_close(S2, S, rtol=1e-6, atol=1e-5)   # BLAS blocking
    torch.testing.assert_close(SS2, SS, rtol=1e-6, atol=1e-5)


# -- chunked logistic SGD --------------------------------------------------

@pytest.mark.parametrize("n,batch", [(512, 64), (1000, 50), (4096, 128)])
@pytest.mark.parametrize("d", [8, 100])
def test_logreg_sgd_plain_matches_jax_oracle(n, batch, d):
    X = _rand((n, d), 7)
    y = (np.random.default_rng(8).random(n) > 0.5).astype(np.float32)
    w = logreg_ops.logreg_sgd(_t(X), _t(y), lam=1e-3, lr=0.3, batch=batch)
    lp = round_up(n, batch)
    Xp = jnp.pad(jnp.asarray(X), ((0, lp - n), (0, 0)))
    yp = jnp.pad(jnp.asarray(y), (0, lp - n))
    mask = jnp.pad(jnp.ones(n, jnp.float32), (0, lp - n))
    wr = logreg_sgd_ref(Xp, yp, mask, lam=1e-3, lr=0.3, batch=batch)
    assert w.shape == (d + 1,)
    np.testing.assert_allclose(w.numpy(), np.asarray(wr), rtol=2e-4, atol=2e-5)


def test_logreg_sgd_plain_matches_jax_kernel():
    X = _rand((1000, 12), 10)
    y = (np.random.default_rng(11).random(1000) > 0.5).astype(np.float32)
    w = logreg_ops.logreg_sgd(_t(X), _t(y), lam=1e-3, lr=0.5, batch=64)
    wj = jax_logreg.logreg_sgd(X, y, lam=1e-3, lr=0.5, batch=64)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=2e-4, atol=2e-5)


def test_logreg_sgd_batched_chunks_equal_single_chunks():
    X = _rand((4, 300, 10), 9)
    y = (np.random.default_rng(10).random((4, 300)) > 0.5).astype(np.float32)
    w, b = logreg_ops.logreg_sgd_batched(_t(X), _t(y), batch=64)
    assert w.shape == (4, 10) and b.shape == (4, 1)
    for i in range(4):
        wi = logreg_ops.logreg_sgd(_t(X[i]), _t(y[i]), batch=64)
        np.testing.assert_allclose(w[i].numpy(), wi[:-1].numpy(), rtol=1e-5)
        np.testing.assert_allclose(b[i].numpy(), wi[-1:].numpy(), rtol=1e-5)


def test_logreg_chunk_limit_replaces_the_vmem_budget():
    # what a block's shared memory cannot hold raises, on any device
    with pytest.raises(ValueError, match="shared memory"):
        logreg_ops.logreg_sgd(torch.zeros((64, 1000)), torch.zeros(64), batch=64)
    with pytest.raises(ValueError, match="32-bit"):
        logreg_kernel.check_chunk(2**24, 200, 1)
    # a chunk the TPU wrapper rejects for VMEM streams through here
    with pytest.raises(ValueError):
        jax_logreg.logreg_sgd(np.zeros((200_000, 128), np.float32),
                              np.zeros(200_000, np.float32), batch=64)
    logreg_kernel.check_chunk(200_000, 128, 64)


def test_cuda_wrappers_validate_before_launch():
    X = torch.zeros((16, 4))
    with pytest.raises(TypeError):
        linreg_kernel.zt_z_cuda(X, torch.zeros(16, dtype=torch.float64))
    with pytest.raises(ValueError):
        linreg_kernel.zt_z_cuda(X, torch.zeros(15))
    with pytest.raises(ValueError, match="classes"):
        nb_kernel.grouped_stats_cuda(X, torch.zeros(16, dtype=torch.int32), 65)
    with pytest.raises(TypeError):
        nb_kernel.grouped_stats_cuda(X, torch.zeros(16), 2)
    with pytest.raises(TypeError):
        logreg_kernel.sgd_chunks_cuda(X[None].double(), torch.zeros((1, 16)),
                                      lam=1e-3, lr=0.5, batch=4)
