"""The segment form of the chunked SGD kernel and the engine path that calls
it, on the CPU.

- The plain segment form (``ops.logreg_sgd_segment`` on CPU tensors, one
  call for a whole segment) gives, chunk by chunk, ``repro``'s Pallas
  ``logreg_sgd`` (interpret mode) and its jnp oracle ``logreg_sgd_ref`` on
  the same chunk, for segments of whole chunks, with a ragged last chunk
  and shorter than one chunk, at batch 64 and 50 and d 10 and 40, within
  ``tests/test_kernels.py``'s tolerance for the kernel (rtol 2e-4, atol
  2e-5: fp32 sums in another order).
- The ragged last chunk runs its own ⌈m/batch⌉ steps; padding it to l
  with masked rows would change its weights.
- ``execute`` with chunk materialisation stores the same chunk ranges under
  the same ids, in the same order, as ``repro``'s engine, with bitwise the
  same weights on the numpy path and within the kernel tolerance on CPU
  tensors; each uncovered step calls the chunked fit once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.descriptors import Range as JRange  # noqa: E402
from repro.core.engine import IncrementalAnalyticsEngine as JEngine  # noqa: E402
from repro.data.synthetic import make_classification  # noqa: E402
from repro.data.tabular import ArrayBackend as JBackend  # noqa: E402
from repro.kernels.logreg_sgd import ops as jax_logreg  # noqa: E402
from repro.kernels.logreg_sgd.ref import logreg_sgd_ref  # noqa: E402
from repro_torch.core import logreg  # noqa: E402
from repro_torch.core.descriptors import Range  # noqa: E402
from repro_torch.core.engine import IncrementalAnalyticsEngine  # noqa: E402
from repro_torch.data.tabular import ArrayBackend  # noqa: E402
from repro_torch.kernels.common import round_up  # noqa: E402
from repro_torch.kernels.logreg_sgd import kernel as logreg_kernel  # noqa: E402
from repro_torch.kernels.logreg_sgd import ops  # noqa: E402
from repro_torch.kernels.logreg_sgd.ref import sgd_chunks_ref  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5
L = 256


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) > 0.5).astype(np.int32)
    return X, y


def _oracle(X, y, batch, lr):
    """``repro``'s jnp oracle on one chunk, padded to a batch multiple."""
    m = len(y)
    mp = round_up(m, batch)
    Xp = jnp.pad(jnp.asarray(X), ((0, mp - m), (0, 0)))
    yp = jnp.pad(jnp.asarray(y, jnp.float32), (0, mp - m))
    mask = jnp.pad(jnp.ones(m, jnp.float32), (0, mp - m))
    return np.asarray(logreg_sgd_ref(Xp, yp, mask, lam=1e-3, lr=lr, batch=batch))


@pytest.mark.parametrize("n", [3 * L, 3 * L + 17, 200], ids=["whole", "ragged", "short"])
@pytest.mark.parametrize("batch", [64, 50])
@pytest.mark.parametrize("d", [10, 40])
def test_segment_plain_matches_jax_chunk_by_chunk(n, batch, d):
    X, y = _data(n, d, n + d + batch)
    W = ops.logreg_sgd_segment(torch.from_numpy(X), torch.from_numpy(y), chunk_size=L,
                               lam=1e-3, lr=0.3, batch=batch)
    p = -(-n // L)
    assert W.shape == (p, d + 1) and W.dtype == torch.float32
    for c in range(p):
        rows = slice(c * L, (c + 1) * L)
        np.testing.assert_allclose(W[c].numpy(), _oracle(X[rows], y[rows], batch, 0.3),
                                   rtol=RTOL, atol=ATOL)
        wj = jax_logreg.logreg_sgd(X[rows], y[rows].astype(np.float32), lam=1e-3, lr=0.3,
                                   batch=batch)
        np.testing.assert_allclose(W[c].numpy(), np.asarray(wj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batch", [64, 50])
def test_padding_the_last_chunk_to_l_changes_the_weights(batch):
    """The ragged tail takes its own ⌈17/batch⌉ = 1 step.  Padded to l with
    masked rows it would take l/batch steps: a fully masked step adds no
    gradient but still applies 2λw and advances t."""
    X, y = _data(3 * L + 17, 10, 5)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    tail = ops.logreg_sgd_segment(Xt, yt, chunk_size=L, batch=batch)[-1]
    np.testing.assert_allclose(tail.numpy(), _oracle(X[3 * L:], y[3 * L:], batch, 0.5),
                               rtol=RTOL, atol=ATOL)
    lp = round_up(L, batch)
    Xp = torch.zeros((1, lp, 10))
    Xp[0, :17] = Xt[3 * L:]
    yp = torch.zeros((1, lp))
    yp[0, :17] = yt[3 * L:].float()
    mask = torch.zeros((1, lp))
    mask[0, :17] = 1.0
    w, b = sgd_chunks_ref(Xp, yp, mask, lam=1e-3, lr=0.5, batch=batch)
    padded = torch.cat([w[0], b[0]])
    assert not torch.allclose(padded, tail, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.int64])
def test_segment_reads_labels_of_any_type_alike(dtype):
    X, y = _data(2 * L + 5, 10, 6)
    Xt = torch.from_numpy(X)
    want = ops.logreg_sgd_segment(Xt, torch.from_numpy(y), chunk_size=L)
    got = ops.logreg_sgd_segment(Xt, torch.from_numpy(y).to(dtype), chunk_size=L)
    assert torch.equal(got, want)


def test_single_and_batched_wrappers_are_the_segment_form():
    X, y = _data(3 * L, 10, 7)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y).float()
    W = ops.logreg_sgd_segment(Xt, yt, chunk_size=L)
    w, b = ops.logreg_sgd_batched(Xt.reshape(3, L, 10), yt.reshape(3, L))
    assert torch.equal(w, W[:, :10]) and torch.equal(b, W[:, 10:])
    assert torch.equal(ops.logreg_sgd(Xt[:L], yt[:L]),
                       ops.logreg_sgd_segment(Xt[:L], yt[:L], chunk_size=L)[0])


@pytest.mark.parametrize("d,batch,warp", [(10, 64, True), (32, 32, True), (1, 128, True),
                                          (33, 64, False), (10, 50, False),
                                          (32, 512, False)])   # a warp ring past the shared memory
def test_form_is_a_function_of_d_and_batch(d, batch, warp):
    assert logreg_kernel.warp_form(d, batch) is warp
    need = (logreg_kernel.warp_ring_bytes(d, batch) if warp
            else logreg_kernel.block_smem_bytes(d, batch))
    assert logreg_kernel.smem_bytes(d, batch) == need
    logreg_kernel.check_chunk(10_000, d, batch)


@pytest.mark.parametrize("n", [1, 2 * L, 2 * L + 1, 5 * L - 3])
def test_fit_chunks_covers_the_segment(n):
    X, y = _data(n, 10, 8)
    host = logreg.fit_chunks(X, y, L)
    dev = logreg.fit_chunks(torch.from_numpy(X), torch.from_numpy(y), L)
    sizes = [min(L, n - s) for s in range(0, n, L)]
    for got in (host, dev):
        assert [float(c.n_points) for c in got] == sizes
        assert all(float(c.n_chunks) == 1.0 and c.w_sum.dtype == np.float64 for c in got)
    for h, d in zip(host, dev):                   # float64 loop vs the fp32 kernel path
        np.testing.assert_allclose(d.w_sum, h.w_sum, rtol=1e-3, atol=1e-4)
    for s, h in zip(range(0, n, L), host):        # the numpy path is fit_chunk's, bitwise
        np.testing.assert_array_equal(h.w_sum, logreg.fit_chunk(X[s:s + L], y[s:s + L]).w_sum)
    assert logreg.fit_chunks(X[:0], y[:0], L) == []


def _engine_run(eng, R, chunk):
    """Warm two models, then queries whose plans leave steps uncovered;
    returns per query what must match exactly and its statistics."""
    eng.warm("logreg", [R(0, 1_500), R(2_000, 3_000)], chunk_size=chunk)
    out = []
    for lo, hi in ((0, 3_000), (300, 3_700), (0, 4_000), (1_000, 3_100)):
        q = eng.query("logreg", R(lo, hi), chunk_size=chunk)
        steps = [(s.rng.lo, s.rng.hi, s.sign, s.model_id) for s in q.plan.steps]
        out.append(((steps, q.used_reuse, list(q.materialized_ids)), q.stats))
    index = sorted((sid, r.lo, r.hi) for sid, r in eng.store.index("logreg").items())
    chunks = {sm.model_id: sm.stats.w_sum for sm in eng.store.models("logreg")}
    return out, index, chunks


@pytest.mark.parametrize("device", [None, "cpu"], ids=["numpy", "plain"])
def test_execute_materialises_the_chunks_of_the_reference(device):
    X, y = make_classification(4_000, d=6, n_classes=2, seed=9)
    chunk = 400
    want = _engine_run(JEngine(JBackend(X, y), materialize="chunks"), JRange, chunk)
    got = _engine_run(IncrementalAnalyticsEngine(ArrayBackend(X, y, device=device),
                                                 materialize="chunks"), Range, chunk)
    (q_got, index_got, chunks_got), (q_want, index_want, chunks_want) = got, want
    assert index_got == index_want                    # chunk ranges under the same ids
    assert any(u for (_, u, _), _ in q_want)          # reuse happened
    assert any(len(ids) > 1 for (_, _, ids), _ in q_want)  # chunks were materialised
    for (exact, stats), (want_exact, want_stats) in zip(q_got, q_want):
        assert exact == want_exact                    # plans, reuse, id order
        if device is None:
            np.testing.assert_array_equal(stats.w_sum, want_stats.w_sum)
        else:
            np.testing.assert_allclose(stats.w_sum, want_stats.w_sum, rtol=RTOL, atol=1e-3)
        assert float(stats.n_chunks) == float(want_stats.n_chunks)
    assert chunks_got.keys() == chunks_want.keys()
    for mid, w in chunks_got.items():
        if device is None:
            np.testing.assert_array_equal(w, np.asarray(chunks_want[mid]))
        else:
            np.testing.assert_allclose(w, np.asarray(chunks_want[mid]), rtol=RTOL, atol=1e-3)


@pytest.mark.parametrize("device", [None, "cpu"], ids=["numpy", "plain"])
def test_each_uncovered_step_calls_the_chunked_fit_once(device, monkeypatch):
    X, y = make_classification(4_000, d=6, n_classes=2, seed=10)
    calls, segments = [], []
    fit_chunks = logreg.fit_chunks
    segment = ops.logreg_sgd_segment

    def counted_fit(X, y, *args, **kwargs):
        calls.append(len(y))
        return fit_chunks(X, y, *args, **kwargs)

    def counted_segment(X, y, **kwargs):
        segments.append(len(y))
        return segment(X, y, **kwargs)

    monkeypatch.setattr(logreg, "fit_chunks", counted_fit)
    monkeypatch.setattr(logreg.k_ops, "logreg_sgd_segment", counted_segment)
    eng = IncrementalAnalyticsEngine(ArrayBackend(X, y, device=device), materialize="chunks")
    eng.warm("logreg", [Range(0, 1_500)], chunk_size=400)
    assert calls == [1_500]                           # a warm-up model: one call
    calls.clear()
    q = eng.query("logreg", Range(0, 3_900), chunk_size=400)
    uncovered = [s.rng.size for s in q.plan.steps if s.model_id is None]
    assert uncovered and calls == uncovered           # one call per uncovered step
    assert len(q.materialized_ids) == sum(-(-m // 400) for m in uncovered)
    calls.clear()
    eng.baseline("logreg", Range(100, 3_000), chunk_size=400)
    assert calls == [2_900]                           # a baseline query: one call
    assert segments == ([] if device is None else [1_500, *uncovered, 2_900])
