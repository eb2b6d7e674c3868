"""The port's analytics engine against the JAX package's, on the CPU.

The same numpy data (``repro.data.synthetic`` and its copy make the same
arrays from a seed) go through both packages:

- algebra: the group/monoid laws of ``tests/test_suffstats.py`` hold for
  the port's stats dataclasses;
- families: numpy-path statistics equal ``repro``'s at rtol 1e-9; the
  kernels' plain versions (CPU tensors) equal ``repro``'s
  ``backend="pallas"`` (interpret mode) at 2e-4, the kernel tests' own
  fp32 tolerance;
- engine: per family, a warm + query + ``add_data`` + ``delete_data``
  script gives ``repro``'s plans, ``used_reuse``, update actions and
  coverage, with statistics at rtol 1e-6 on the numpy path (host arrays,
  ``device=None``) and within the kernel tolerances on the plain-version
  path (``device="cpu"``);
- a store warmed in ``repro`` and carried across field by field plans
  like ``repro``'s;
- the CLI runs with ``--device cpu`` and exits non-zero without a card.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.core import families as jfam  # noqa: E402
from repro.core import logreg as jlogreg  # noqa: E402
from repro.core.descriptors import Range as JRange  # noqa: E402
from repro.core.engine import IncrementalAnalyticsEngine as JEngine  # noqa: E402
from repro.data.synthetic import make_classification, make_multinomial, make_regression  # noqa: E402
from repro.data.tabular import ArrayBackend as JBackend  # noqa: E402
from repro_torch.core import families, logreg  # noqa: E402
from repro_torch.core.descriptors import Range  # noqa: E402
from repro_torch.core.engine import IncrementalAnalyticsEngine  # noqa: E402
from repro_torch.core.optimizer import shortest_plan  # noqa: E402
from repro_torch.core.store import ModelStore  # noqa: E402
from repro_torch.core.suffstats import (  # noqa: E402
    GaussianNBStats, LinRegStats, LogRegMixtureStats, MultinomialNBStats,
    stats_from_fields)
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.tabular import ArrayBackend, RemoteStoreBackend, TabularBackend  # noqa: E402
from repro_torch.kernels.linreg_stats import kernel as linreg_kernel  # noqa: E402
from repro_torch.kernels.logreg_sgd import kernel as logreg_kernel  # noqa: E402
from repro_torch.kernels.nb_stats import kernel as nb_kernel  # noqa: E402

D, C = 4, 3
KERNEL_RTOL = 2e-4


def _stats_close(port, ref, rtol, atol=1e-8):
    for f in dataclasses.fields(port):
        np.testing.assert_allclose(np.asarray(getattr(port, f.name), np.float64),
                                   np.asarray(getattr(ref, f.name), np.float64),
                                   rtol=rtol, atol=atol, err_msg=f.name)


# -- algebra -----------------------------------------------------------------

def _data(seed, n):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, D)), rng.standard_normal(n), rng.integers(0, C, n)


sizes = st.integers(1, 40)


@given(sizes, sizes, sizes)
@settings(max_examples=25, deadline=None)
def test_linreg_group_laws(n1, n2, n3):
    a = LinRegStats.from_data(*_data(1, n1)[:2])
    b = LinRegStats.from_data(*_data(2, n2)[:2])
    c = LinRegStats.from_data(*_data(3, n3)[:2])
    assert ((a + b) + c).allclose(a + (b + c))
    assert (a + b).allclose(b + a)
    assert (a + LinRegStats.zero(D)).allclose(a)
    assert ((a + b) - b).allclose(a, rtol=1e-9, atol=1e-9)
    X1, y1, _ = _data(1, n1)
    X2, y2, _ = _data(2, n2)
    both = LinRegStats.from_data(np.vstack([X1, X2]), np.concatenate([y1, y2]))
    assert (a + b).allclose(both)


@given(sizes, sizes)
@settings(max_examples=25, deadline=None)
def test_gaussian_nb_group_laws(n1, n2):
    X1, _, y1 = _data(4, n1)
    X2, _, y2 = _data(5, n2)
    a = GaussianNBStats.from_data(X1, y1, C)
    b = GaussianNBStats.from_data(X2, y2, C)
    both = GaussianNBStats.from_data(np.vstack([X1, X2]), np.concatenate([y1, y2]), C)
    assert (a + b).allclose(both)
    assert ((a + b) - a).allclose(b, rtol=1e-9, atol=1e-9)
    assert (a + GaussianNBStats.zero(D, C)).allclose(a)


@given(sizes, sizes)
@settings(max_examples=15, deadline=None)
def test_multinomial_nb_group_laws(n1, n2):
    rng = np.random.default_rng(6)
    X1, X2 = rng.poisson(2.0, (n1, D)).astype(float), rng.poisson(2.0, (n2, D)).astype(float)
    y1, y2 = rng.integers(0, C, n1), rng.integers(0, C, n2)
    a = MultinomialNBStats.from_data(X1, y1, C)
    b = MultinomialNBStats.from_data(X2, y2, C)
    both = MultinomialNBStats.from_data(np.vstack([X1, X2]), np.concatenate([y1, y2]), C)
    assert (a + b).allclose(both)
    assert ((a + b) - b).allclose(a)


def test_logreg_monoid_no_inverse_and_type_safety():
    s = (LogRegMixtureStats.from_chunk_weights(np.ones(D + 1), 10)
         + LogRegMixtureStats.from_chunk_weights(2 * np.ones(D + 1), 10))
    assert np.allclose(s.weights, 1.5 * np.ones(D + 1))
    with pytest.raises(TypeError):
        _ = s - s
    with pytest.raises(TypeError):
        _ = LinRegStats.zero(D) + GaussianNBStats.zero(D, C)
    small = LinRegStats.from_data(*_data(7, 10)[:2])
    large = LinRegStats.from_data(*_data(8, 10_000)[:2])
    assert small.nbytes == large.nbytes == 8 * (D * D + D + 1)


def test_stats_carry_across_field_by_field():
    from repro.core.suffstats import STATS_FAMILIES as JFAMILIES

    X, y, yc = _data(9, 50)
    for family, args in (("linreg", (X, y)), ("gaussian_nb", (X, yc, C)),
                         ("multinomial_nb", (np.abs(X), yc, C))):
        ref = JFAMILIES[family].from_data(*args)
        port = stats_from_fields(family, vars(ref))
        assert type(port).__name__ == type(ref).__name__
        _stats_close(port, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="fields"):
        stats_from_fields("linreg", {"n": 1.0, "A": np.eye(2)})


def test_synthetic_data_is_the_references():
    for port_fn, ref_fn, kw in ((synthetic.make_regression, make_regression, {}),
                                (synthetic.make_classification, make_classification,
                                 {"n_classes": 3}),
                                (synthetic.make_multinomial, make_multinomial, {})):
        for a, b in zip(port_fn(300, d=5, seed=4, **kw), ref_fn(300, d=5, seed=4, **kw)):
            np.testing.assert_array_equal(a, b)


def test_mixture_bound_is_the_references():
    args = (1.0, 1e-3, 10_000, 50_000, 5)
    assert logreg.mixture_bound(*args) == jlogreg.mixture_bound(*args)


# -- families ----------------------------------------------------------------

def _family_data(name, n, seed=0):
    if name == "linreg":
        return make_regression(n, d=6, seed=seed), {}
    if name == "multinomial_nb":
        return make_multinomial(n, d=6, n_classes=3, seed=seed), {"n_classes": 3}
    X, y = make_classification(n, d=6, n_classes=2, seed=seed)
    return (X, y), ({"chunk_size": 200} if name == "logreg" else {"n_classes": 2})


@pytest.mark.parametrize("name", ["linreg", "gaussian_nb", "multinomial_nb", "logreg"])
def test_family_numpy_path_equals_reference(name):
    (X, y), params = _family_data(name, 900)
    p = {**families.get_family(name).defaults, **params}
    got = families.get_family(name).compute_stats(X, y, p)
    want = jfam.get_family(name).compute_stats(X, y, {**p, "backend": "numpy"})
    _stats_close(got, want, rtol=1e-9)
    np.testing.assert_allclose(
        _weights(families.get_family(name).solve(got, p)),
        _weights(jfam.get_family(name).solve(want, p)), rtol=1e-9)


def _weights(model):
    return model.mu if hasattr(model, "mu") else (
        model.log_theta if hasattr(model, "log_theta") else model.weights)


@pytest.mark.parametrize("name", ["linreg", "gaussian_nb", "logreg"])
def test_family_plain_versions_equal_reference_pallas(name):
    (X, y), params = _family_data(name, 600, seed=1)
    p = {**families.get_family(name).defaults, **params}
    Xt, yt = ArrayBackend(X, y, device="cpu").fetch(Range(0, len(y)))
    before = (linreg_kernel.KERNEL.launches, nb_kernel.KERNEL.launches,
              logreg_kernel.KERNEL.launches)
    got = families.get_family(name).compute_stats(Xt, yt, p)
    assert (linreg_kernel.KERNEL.launches, nb_kernel.KERNEL.launches,
            logreg_kernel.KERNEL.launches) == before
    want = jfam.get_family(name).compute_stats(X, y, {**p, "backend": "pallas"})
    _stats_close(got, want, rtol=KERNEL_RTOL, atol=1e-3)
    for f in dataclasses.fields(got):
        assert np.asarray(getattr(got, f.name)).dtype == np.float64


def test_multinomial_tensor_fetch_runs_on_the_host():
    (X, y), params = _family_data("multinomial_nb", 300)
    Xt, yt = ArrayBackend(X, y, device="cpu").fetch(Range(0, 300))
    got = families.get_family("multinomial_nb").compute_stats(Xt, yt, params)
    _stats_close(got, MultinomialNBStats.from_data(X, y, 3), rtol=1e-6)


# -- engine --------------------------------------------------------------------

def _plan(plan):
    return [(s.rng.lo, s.rng.hi, s.sign, s.model_id) for s in plan.steps]


def _script(eng, R, name, params):
    """warm + queries + add_data + delete_data: a list of (what must match
    exactly, statistics) per step."""
    out = []
    eng.warm(name, [R(0, 1_500), R(1_500, 2_600)], **params)
    for lo, hi in ((0, 2_600), (300, 2_600), (0, 1_500), (500, 3_400)):
        q = eng.query(name, R(lo, hi), **params)
        out.append(((_plan(q.plan), q.used_reuse, list(q.materialized_ids)), q.stats))
    q = eng.query(name, R(0, 3_000), **params)
    up = eng.add_data(name, [R(0, 3_000)], q.stats, R(3_000, 4_000), **params)
    up2 = eng.delete_data(name, up.coverage, up.stats, R(0, 700), **params)
    for u in (up, up2):
        out.append(((u.action, [(c.lo, c.hi) for c in u.coverage]), u.stats))
    return out


@pytest.mark.parametrize("name", ["linreg", "gaussian_nb", "logreg"])
@pytest.mark.parametrize("device", [None, "cpu"], ids=["numpy", "plain"])
def test_engine_script_matches_reference(name, device):
    if name == "linreg":
        X, y = make_regression(4_000, d=6, seed=3)
    else:
        X, y = make_classification(4_000, d=6, n_classes=3 if name == "gaussian_nb" else 2,
                                   seed=3)
    params = {"chunk_size": 500} if name == "logreg" else {}
    policy = "chunks" if name == "logreg" else "always"
    jeng = JEngine(JBackend(X, y), materialize=policy)
    eng = IncrementalAnalyticsEngine(ArrayBackend(X, y, device=device), materialize=policy)
    want = _script(jeng, JRange, name, params)
    got = _script(eng, Range, name, params)
    assert any(exact[1] for exact, _ in want[:4])               # reuse happened
    rtol, atol = (1e-6, 1e-8) if device is None else (KERNEL_RTOL, 1e-3)
    assert len(got) == len(want)
    for (exact, stats), (want_exact, want_stats) in zip(got, want):
        assert exact == want_exact
        _stats_close(stats, want_stats, rtol=rtol, atol=atol)
    assert eng.stats["reused"] == jeng.stats["reused"]
    assert eng.coverage(name) == jeng.coverage(name)


def test_engine_logreg_delete_forces_refit():
    X, y = make_classification(12_000, d=4, n_classes=C, seed=2)
    for device in (None, "cpu"):
        eng = IncrementalAnalyticsEngine(ArrayBackend(X, y, device=device),
                                         materialize="never")
        q = eng.query("logreg", Range(0, 10_000))
        up = eng.delete_data("logreg", [Range(0, 10_000)], q.stats, Range(0, 2_000))
        assert up.action == "refit" and up.coverage == [Range(2_000, 10_000)]
        ref = eng.baseline("logreg", Range(2_000, 10_000))
        _stats_close(up.stats, ref.stats, rtol=0, atol=0)
        with pytest.raises(ValueError):
            eng.add_data("logreg", [Range(0, 10_000)], q.stats, Range(5_000, 11_000))


def test_store_warmed_in_reference_plans_alike():
    X, y = make_regression(6_000, d=5, seed=7)
    jeng = JEngine(JBackend(X, y), materialize="never")
    jeng.warm("linreg", [JRange(0, 2_000), JRange(1_000, 3_500), JRange(4_000, 6_000)])
    store = ModelStore()
    for sm in jeng.store.models():
        store.put(sm.family, Range(sm.rng.lo, sm.rng.hi),
                  stats_from_fields(sm.family, vars(sm.stats)), model_id=sm.model_id)
    eng = IncrementalAnalyticsEngine(ArrayBackend(X, y, device=None), store=store,
                                     materialize="never")
    for lo, hi in ((0, 3_500), (500, 6_000), (1_000, 2_000)):
        q, jq = eng.query("linreg", Range(lo, hi)), jeng.query("linreg", JRange(lo, hi))
        assert _plan(q.plan) == _plan(jq.plan) and q.used_reuse == jq.used_reuse
        _stats_close(q.stats, jq.stats, rtol=1e-9)
        np.testing.assert_allclose(q.model.weights, jq.model.weights, rtol=1e-8)
    plan = shortest_plan(store.index("linreg"), Range(0, 6_000), eng.cost,
                         store.model_bytes("linreg"))
    assert plan.models_used


def test_model_store_budget_and_unported_persistence(tmp_path):
    X, y = make_regression(100, d=8, seed=5)
    st_ = LinRegStats.from_data(X, y)
    store = ModelStore(byte_budget=st_.nbytes * 3 + 10)
    ids = [store.put("linreg", Range(i * 100, (i + 1) * 100), st_) for i in range(6)]
    assert store.nbytes() <= store.byte_budget and store.evictions >= 3
    assert len(store) == len(store.model_bytes("linreg"))
    kept = next(iter(store.models("linreg")))
    assert store.get(kept.model_id).hits == 1
    store.drop(kept.model_id)
    assert kept.model_id not in store.index("linreg") and ids
    with pytest.raises(KeyError):
        store.put("svm", Range(0, 1), st_)
    # persistence (ported): the snapshot reloads under the same budget
    store.save(tmp_path / "s")
    loaded = ModelStore.load(tmp_path / "s", byte_budget=store.byte_budget)
    assert sorted(loaded.model_bytes("linreg")) == sorted(store.model_bytes("linreg"))
    for sm in store.models():
        np.testing.assert_array_equal(loaded.get(sm.model_id).stats.A, sm.stats.A)


def test_backends_deliver_kernel_ready_tensors(tmp_path):
    X, y = make_classification(5_000, d=6, n_classes=2, seed=6)
    ab = ArrayBackend(X, y, device="cpu")
    tb = TabularBackend.write(tmp_path / "tab", X, y, device="cpu")
    rb = RemoteStoreBackend(ab, fixed_s=0.0)
    r = Range(1234, 4321)
    (Xa, ya), (Xt, yt), (Xr, _) = ab.fetch(r), tb.fetch(r), rb.fetch(r)
    assert Xa.dtype == torch.float32 and ya.dtype == torch.int32
    assert torch.equal(Xa, Xt) and torch.equal(ya, yt) and torch.equal(Xa, Xr)
    assert ab.n_classes == tb.n_classes == rb.n_classes == 2
    assert rb.requests == 1 and rb.rows_served == r.size
    Xr_, yr_ = make_regression(100, d=3, seed=1)
    assert ArrayBackend(Xr_, yr_, device="cpu").y.dtype == torch.float32
    host = ArrayBackend(X, y, device=None).fetch(r)
    np.testing.assert_array_equal(host[0], X[1234:4321])
    with pytest.raises(IndexError):
        ab.fetch(Range(0, 5_001))


# -- CLI -------------------------------------------------------------------------

def test_cli_runs_on_cpu(capsys):
    from repro_torch.launch import analytics as cli

    cli.main(["--device", "cpu", "--points", "30000", "--queries", "4",
              "--model-size", "3000", "--query-size", "3000"])
    out = capsys.readouterr().out
    for family in ("linreg", "gaussian_nb", "logreg"):
        assert f"{family} " in out
    assert out.count("on cpu") == 3


def test_cli_store_dir_names_the_roadmap(tmp_path, capsys, monkeypatch):
    """``--store-dir`` (ported) saves each family's store to
    ``{store_dir}/{family}``; each reloads with the reported model count,
    in the port and in ``repro``, as ``python -m repro.launch.analytics``
    writes them."""
    from repro.core.store import ModelStore as JaxModelStore
    from repro.launch import analytics as jax_cli
    from repro_torch.launch import analytics as cli

    flags = ["--points", "20000", "--queries", "3", "--model-size", "2000",
             "--query-size", "2000"]
    cli.main(["--device", "cpu", "--store-dir", str(tmp_path / "t"), *flags])
    out = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["analytics", "--store-dir", str(tmp_path / "j"),
                                     *flags])
    jax_cli.main()
    jout = capsys.readouterr().out
    for family in ("linreg", "gaussian_nb", "logreg"):
        ours = ModelStore.load(tmp_path / "t" / family)
        ref = JaxModelStore.load(tmp_path / "j" / family)
        assert len(ours) > 0 and sorted(ours._models) == sorted(ref._models)
        assert ModelStore.load(tmp_path / "j" / family).nbytes() == ours.nbytes()
        assert len(JaxModelStore.load(tmp_path / "t" / family)) == len(ours)
        reused = [line.split("reused ")[1].split(" ")[0]
                  for text in (out, jout) for line in text.splitlines()
                  if line.startswith(family + " ")]
        assert reused[0] == reused[1], (family, reused)


def test_cli_without_a_card_needs_device_cpu():
    from repro_torch.launch import analytics as cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        cli.main(["--points", "1000"])
    assert "--device cpu" in str(exc.value.code)
