"""Fused Pallas kernel (ops/triton_estep.py) tests.

On the CPU the kernel runs through the Pallas interpreter (the explicit
backend='interpret' / interpret=True) and must match the XLA blockwise
engine; the Gibbs mode must draw valid labels whose one-hot statistics
are self-consistent and follow the softmax. Routing and the dense serving
path are checked against independent oracles. Tests marked `gpu` run the
compiled kernel and skip without a GPU (`pytest -m gpu` on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mimo_tpu.models.gmm import BayesianGMM
from mimo_tpu.models.ilr import BayesianILR
from mimo_tpu.ops import triton_estep as te
from mimo_tpu.ops.family_estep import (
    fused_estep_blockwise, fused_gibbs_blockwise)
from mimo_tpu.parallel import make_mesh, shard_data


def _gmm_data(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.array([[-3., 0.], [3., 0.], [0., 4.]])
    z = rng.choice(3, size=n, p=[.3, .4, .3])
    x = centers[z] + rng.standard_normal((n, 2)) / np.sqrt(2.0)
    return jnp.asarray(x, jnp.float32)


def _ilr_data(n, q, seed=3):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-2, 2, (n, q))
    ys = np.sin(xs.sum(-1, keepdims=True)) + 0.1 * rng.standard_normal((n, 1))
    return jnp.asarray(xs, jnp.float32), jnp.asarray(ys, jnp.float32)


def _problem(kind, n):
    """(model, data tuple, posterior, log_pi) with a posterior from random
    responsibilities, so components differ and every row of theta counts."""
    if kind in ('gauss', 'diag', 'hier'):
        model = BayesianGMM.make(size=8, dim=2, gating='dp', kappa=0.05,
                                 psi_scale=0.5, diag=kind == 'diag',
                                 hierarchical=kind == 'hier',
                                 dtype=jnp.float32)
        data = (_gmm_data(n),)
    else:
        model = BayesianILR.make(size=5, input_dim=1, output_dim=1,
                                 alpha=2.0, kappa=0.05,
                                 diag=kind == 'ilr_diag',
                                 tied_affine=kind == 'tied_affine',
                                 dtype=jnp.float32)
        data = _ilr_data(n, 1)
    resp = np.random.default_rng(1).dirichlet(np.ones(model.size), n)
    st = jax.jit(model._mf_update)(data, jnp.asarray(resp, jnp.float32))
    return model, data, st.components, st.gating.expected_log_pi()


@pytest.fixture
def estep_case(request):
    """A problem and the XLA engine's E-step on it (the reference)."""
    kind, n = request.param
    model, data, post, log_pi = _problem(kind, n)
    spec = model._estep_spec()
    ref = jax.jit(lambda p, l, d: fused_estep_blockwise(spec, p, l, d, n))(
        post, log_pi, data)
    return spec, data, post, log_pi, ref


@pytest.fixture
def gibbs_case(request):
    kind, n = request.param
    model, data, post, log_pi = _problem(kind, n)
    return model, data, model.family.mode_params(post), log_pi


def _assert_estep_close(got, ref):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-4),
        got.stats, ref.stats)
    np.testing.assert_allclose(np.asarray(got.counts), np.asarray(ref.counts),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(got.lse), float(ref.lse), rtol=1e-5)


_ESTEP_CASES = [('gauss', 1024), ('gauss', 777), ('diag', 1000),
                ('hier', 1000), ('ilr', 1000), ('ilr_diag', 1000),
                ('tied_affine', 1000)]


@pytest.mark.parametrize('estep_case', _ESTEP_CASES, indirect=True,
                         ids=[f'{k}-{n}' for k, n in _ESTEP_CASES])
def test_kernel_estep_matches_blockwise(estep_case):
    """Interpret-mode kernel == XLA blockwise engine for every family the
    kernel assembles features for, at an N that fills whole tiles (1024)
    and at ones that leave a masked tail."""
    spec, data, post, log_pi, ref = estep_case
    got = te.fused_estep_pallas(spec, post, log_pi, data, interpret=True)
    _assert_estep_close(got, ref)


def _fit_problem(diag):
    mu = jnp.asarray([[-3., 0.], [3., 0.], [0., 4.]], jnp.float32)
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2)).astype(jnp.float32)
    from mimo_tpu.distributions.niw import GaussParams
    x, _ = BayesianGMM.generate(jax.random.PRNGKey(0), GaussParams(mu, lm),
                                jnp.asarray([.3, .4, .3]), 4096)
    model = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                             diag=diag, kappa=0.05, psi_scale=0.5,
                             dtype=jnp.float32)
    return model, x.astype(jnp.float32)


@pytest.mark.parametrize('diag', [False, True])
def test_backend_pallas_fit_matches_xla(diag):
    """End to end through the public entry points: the kernel
    (interpret mode) and backend='xla' give the same VI fit; the
    kernel's Gibbs fit is finite and labels every point."""
    model, x = _fit_problem(diag)
    st_p, v_p = model.fit_vi_fused(x, key=1, maxiter=20, backend='interpret')
    st_x, v_x = model.fit_vi_fused(x, key=1, maxiter=20, backend='xla')
    np.testing.assert_allclose(np.asarray(v_p), np.asarray(v_x), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(st_p.gating.mean()),
                               np.asarray(st_x.gating.mean()), atol=1e-4)
    gs = model.fit_gibbs_fused(x, key=2, maxiter=20, backend='interpret')
    assert bool(jnp.all(jnp.isfinite(gs.log_pi)))
    assert int(jnp.sum(gs.labels >= 0)) == x.shape[0]


def test_ilr_backend_pallas_fit_matches_xla():
    """Mixtures of linear experts (m=10, inside the routing cap) through
    the kernel match the XLA engine end to end."""
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.uniform(-3, 3, (2048, 1)), jnp.float32)
    ys = jnp.asarray(np.sin(np.asarray(xs)) +
                     0.1 * rng.standard_normal((2048, 1)), jnp.float32)
    m = BayesianILR.make(size=8, input_dim=1, output_dim=1, alpha=2.0,
                         kappa=0.05, dtype=jnp.float32)
    m.init_transform(xs, ys)
    _, v_p = m.fit_vi_fused((xs, ys), key=1, maxiter=15,
                            backend='interpret')
    _, v_x = m.fit_vi_fused((xs, ys), key=1, maxiter=15, backend='xla')
    np.testing.assert_allclose(np.asarray(v_p), np.asarray(v_x), rtol=1e-4)
    gs = m.fit_gibbs_fused((xs, ys), key=2, maxiter=10, backend='interpret')
    assert bool(jnp.all(jnp.isfinite(gs.log_pi)))


def test_hmix_backend_pallas_fit_matches_xla():
    """Nested mixtures run the kernel with K = M*K flat rows: the fused
    nested VI (plain and hierarchical inner family) equals backend='xla',
    and the kernel's joint-label Gibbs separates the super-clusters."""
    from mimo_tpu.models.hmix import BayesianMixtureOfMixtures
    rng = np.random.default_rng(7)

    def blob(c, n):
        return c + 0.5 * rng.standard_normal((n, 2))

    x = np.vstack([blob([-5, -5], 500), blob([-5, -3], 500),
                   blob([5, 5], 500), blob([5, 3], 500)])
    x = jnp.asarray(x[rng.permutation(2000)], jnp.float32)
    m = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=2, mixture_size=3, dim=2, hierarchical=False,
        kappa=0.5, psi_scale=0.5, means=[[-5, -4], [5, 4]],
        dtype=jnp.float32)
    _, v_p = m.fit_vi_fused(x, key=0, maxiter=15, backend='interpret')
    _, v_x = m.fit_vi_fused(x, key=0, maxiter=15, backend='xla')
    np.testing.assert_allclose(np.asarray(v_p), np.asarray(v_x), rtol=1e-4)
    gs = m.fit_gibbs_fused(x, key=2, maxiter=15, backend='interpret')
    lab = np.asarray(gs.labels)
    left = np.asarray(x)[:, 0] < 0
    assert (lab[left] == lab[left][0]).mean() > 0.9
    assert (lab[~left] == lab[~left][0]).mean() > 0.9
    mh = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=2, mixture_size=3, dim=2, hierarchical=True,
        kappa=0.5, psi_scale=0.5, maxsubiter=3,
        means=[[-5, -4], [5, 4]], dtype=jnp.float32)
    vh_p = mh.fit_vi_fused(x, key=0, maxiter=10, backend='interpret')[1]
    vh_x = mh.fit_vi_fused(x, key=0, maxiter=10, backend='xla')[1]
    np.testing.assert_allclose(np.asarray(vh_p), np.asarray(vh_x),
                               rtol=1e-4)
    gsh = mh.fit_gibbs_fused(x, key=3, maxiter=8, backend='interpret')
    assert bool(jnp.all(jnp.isfinite(jax.tree.leaves(gsh.components)[0])))


def test_hmix_ilr_backend_pallas_fit_matches_xla():
    """Nested mixtures of linear experts: the product-spec assembler with
    M*K rows, kernel vs XLA end to end."""
    from mimo_tpu.models.hmix import BayesianMixtureOfMixtures
    rng = np.random.default_rng(3)
    n = 1024
    x1 = rng.uniform(-2, 0, (n // 2, 1))
    x2 = rng.uniform(0, 2, (n // 2, 1))
    y = np.vstack([1.5 * x1 + 1, -2.0 * x2 + 0.5]) \
        + 0.05 * rng.standard_normal((n, 1))
    x = jnp.asarray(np.vstack([x1, x2]), jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    m = BayesianMixtureOfMixtures.make_ilr(
        cluster_size=2, mixture_size=2, input_dim=1, output_dim=1,
        kappa=0.05, dtype=jnp.float32)
    v_p = m.fit_vi_fused((x, y), key=1, maxiter=12, backend='interpret')[1]
    v_x = m.fit_vi_fused((x, y), key=1, maxiter=12, backend='xla')[1]
    # scripts/diag_hmix_ilr.py: the per-sweep E-step error is f32
    # summation-order noise on a cancelling lse sum, which coordinate
    # ascent amplifies across sweeps; so a tight tolerance on the early
    # prefix and a looser one on the whole trace
    np.testing.assert_allclose(np.asarray(v_p[:6]), np.asarray(v_x[:6]),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(v_p), np.asarray(v_x), rtol=1e-3)
    gs = m.fit_gibbs_fused((x, y), key=2, maxiter=8, backend='interpret')
    assert int(jnp.sum(gs.labels >= 0)) == n


def test_kernel_tiles_and_padding():
    """K pads to a power of two of at least 16; the tile keeps a (Kp, T)
    block at 4096 elements within [16, 256] points."""
    assert te.tile_points(16) == 256 and te.tile_points(64) == 64
    assert te.tile_points(1024) == 16
    assert [te._next_pow2(k) for k in (1, 5, 16, 50, 64)] == [1, 8, 16,
                                                               64, 64]


@pytest.mark.parametrize('gibbs_case', [('gauss', 1000), ('ilr', 1000)],
                         indirect=True, ids=['gauss', 'ilr'])
def test_kernel_gibbs_stats_match_labels(gibbs_case):
    """Labels lie in [0, K) and the kernel's one-hot statistics equal the
    statistics of the labels it returned."""
    model, data, params, log_pi = gibbs_case
    spec = model._estep_spec()
    labels, res = te.fused_gibbs_pallas(spec, jax.random.PRNGKey(42), params,
                                        log_pi, data, interpret=True)
    lab = np.asarray(labels)
    assert lab.shape == (data[0].shape[0],)
    assert lab.min() >= 0 and lab.max() < model.size
    oh = np.eye(model.size)[lab]
    feats = np.asarray(spec.features(data), np.float64)
    acc = oh.T @ feats
    np.testing.assert_allclose(np.asarray(res.counts), acc[:, 0], atol=1e-3)
    got = jax.tree.leaves(res.stats)
    want = jax.tree.leaves(spec.unpack(jnp.asarray(acc)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize('gibbs_case', [('gauss', 2000)], indirect=True)
def test_kernel_gibbs_follows_softmax(gibbs_case):
    """Label counts of one sweep lie within a chi-square bound of the
    softmax probabilities of the plug-in log-densities."""
    from scipy import stats
    model, data, params, log_pi = gibbs_case
    spec = model._estep_spec()
    labels, _ = te.fused_gibbs_pallas(spec, jax.random.PRNGKey(7), params,
                                      log_pi, data, interpret=True)
    logp = np.asarray(jax.jit(model.log_complete_likelihood)(
        params, log_pi, data), np.float64)
    p = np.exp(logp - logp.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    expected = p.sum(0)
    counts = np.bincount(np.asarray(labels), minlength=model.size)
    keep = expected > 5
    chi2 = np.sum((counts[keep] - expected[keep]) ** 2 / expected[keep])
    assert chi2 < stats.chi2.ppf(0.999, keep.sum() - 1)
    assert counts[~keep].sum() <= max(10, 3 * expected[~keep].sum())


@pytest.mark.parametrize('gibbs_case', [('gauss', 600)], indirect=True)
def test_kernel_gibbs_same_key_same_labels(gibbs_case):
    """The draw is a function of the key: same key, same labels; another
    key, other labels."""
    model, data, params, log_pi = gibbs_case
    spec = model._estep_spec()

    def draw(seed):
        return np.asarray(te.fused_gibbs_pallas(
            spec, jax.random.PRNGKey(seed), params, log_pi, data,
            interpret=True)[0])
    a, b, c = draw(3), draw(3), draw(4)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_auto_backend_selects_xla_on_cpu():
    """'auto' picks the XLA engine where there is no GPU, and the kernel
    routing rule caps the feature width."""
    from mimo_tpu.models.mixture import KERNEL_MAX_FEATURES
    model = BayesianGMM.make(size=8, dim=2)
    assert jax.default_backend() == 'cpu'
    assert _route(model, 'auto') == 'xla'
    assert _route(model, 'interpret') == 'interpret'
    assert KERNEL_MAX_FEATURES >= 7


def _route(model, backend):
    """The engine a fused fit of `model` runs (nested mixtures route
    their flat M*K spec)."""
    from mimo_tpu.models import mixture
    spec = getattr(model, '_flat_spec', None) or model._estep_spec
    return mixture._resolve_backend(backend, spec(), model.components_prior)


def test_auto_routes_by_feature_width(monkeypatch):
    """On a GPU 'auto' takes the kernel only up to KERNEL_MAX_FEATURES
    (GMM d=2, m=7; ILR q=1, m=10) and XLA beyond (GMM d=4, m=21; ILR
    q=8, m=164), where an explicit 'pallas' or 'interpret' is refused
    rather than run slowly."""
    from mimo_tpu.models import mixture
    monkeypatch.setattr(mixture.jax, 'default_backend', lambda: 'gpu')
    gmm = BayesianGMM.make(size=50, dim=2)
    ilr1 = BayesianILR.make(size=50, input_dim=1, output_dim=1)
    for m in (gmm, ilr1):
        assert _route(m, 'auto') == 'pallas'
        assert _route(m, 'pallas') == 'pallas'
        assert _route(m, 'interpret') == 'interpret'
    for m in (BayesianGMM.make(size=50, dim=4),
              BayesianILR.make(size=50, input_dim=8, output_dim=1)):
        assert _route(m, 'auto') == 'xla'
        for b in ('pallas', 'interpret'):
            with pytest.raises(ValueError, match='KERNEL_MAX_FEATURES'):
                _route(m, b)


def test_auto_routes_by_component_count(monkeypatch):
    """The (Kp, T) tile spills above K=256: 'auto' sends larger K to XLA,
    counting a nested mixture's flat M*K rows, and the explicit kernel
    backends refuse it."""
    from mimo_tpu.models import mixture
    from mimo_tpu.models.hmix import BayesianMixtureOfMixtures
    monkeypatch.setattr(mixture.jax, 'default_backend', lambda: 'gpu')
    assert mixture.KERNEL_MAX_COMPONENTS == 256
    assert _route(BayesianGMM.make(size=256, dim=2), 'auto') == 'pallas'
    big = BayesianGMM.make(size=257, dim=2)
    assert _route(big, 'auto') == 'xla'
    with pytest.raises(ValueError, match='KERNEL_MAX_COMPONENTS'):
        _route(big, 'pallas')
    nested = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=20, mixture_size=16, dim=2, hierarchical=False)
    assert _route(nested, 'auto') == 'xla'
    small = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=4, mixture_size=16, dim=2, hierarchical=False)
    assert _route(small, 'auto') == 'pallas'


def test_pallas_backend_without_gpu_raises():
    """An explicit backend='pallas' never falls back: without a GPU it
    raises, and unknown backends are refused."""
    model = BayesianGMM.make(size=4, dim=2, dtype=jnp.float32)
    x = _gmm_data(256)
    with pytest.raises(RuntimeError, match='needs a GPU'):
        model.fit_vi_fused(x, key=0, maxiter=2, backend='pallas')
    with pytest.raises(RuntimeError, match='needs a GPU'):
        model.fit_gibbs_fused(x, key=0, maxiter=2, backend='pallas')
    with pytest.raises(ValueError, match='backend'):
        model.fit_map_fused(x, key=0, maxiter=2, backend='cuda')


@pytest.mark.parametrize('diag', [False, True], ids=['gauss', 'diag'])
def test_mesh_serving_takes_dense_path(diag):
    """Serving on the 8-device CPU mesh is the dense path: sharded inputs
    give a sharded output equal to the replicated call, and the compiled
    program holds no kernel custom call."""
    model = BayesianGMM.make(size=6, dim=2, gating='dp', kappa=0.05,
                             psi_scale=0.5, diag=diag, dtype=jnp.float32)
    x = _gmm_data(1024)
    resp = np.random.default_rng(0).dirichlet(np.ones(6), 1024)
    st = jax.jit(model._mf_update)((x,), jnp.asarray(resp, jnp.float32))
    xs = shard_data(make_mesh(), x)
    fn = jax.jit(model.log_predictive)
    compiled = fn.lower(st, xs).compile()
    assert 'custom-call' not in compiled.as_text().replace('custom-call-', '')
    lp_mesh = compiled(st, xs)
    assert len(lp_mesh.sharding.device_set) == len(jax.devices())
    np.testing.assert_allclose(np.asarray(lp_mesh), np.asarray(fn(st, x)),
                               rtol=1e-5, atol=1e-5)


def test_log_predictive_matches_scipy_multivariate_t():
    """The dense Student-t mixture density at a wide shape (d=8, K=32)
    equals scipy's multivariate_t mixture in float64."""
    from scipy import stats
    from scipy.special import logsumexp
    from mimo_tpu.distributions.niw import NIW
    from mimo_tpu.models.mixture import MFState
    rng = np.random.default_rng(11)
    n, k, d = 300, 32, 8
    x = rng.standard_normal((n, d)) * 3
    psi = np.stack([np.eye(d) * rng.uniform(0.3, 1.0) for _ in range(k)])
    post = NIW(mu=jnp.asarray(rng.standard_normal((k, d)) * 3),
               kappa=jnp.asarray(rng.uniform(1, 50, k)),
               psi=jnp.asarray(psi),
               nu=jnp.asarray(rng.uniform(d + 2, d + 40, k)))
    model = BayesianGMM.make(size=k, dim=d, dtype=jnp.float64)
    gating = model.gating_prior.update(jnp.asarray(rng.uniform(1, 9, k)))
    st = MFState(components=post, gating=gating)
    got = np.asarray(jax.jit(model.log_predictive)(st, jnp.asarray(x)))
    log_w = np.log(np.asarray(gating.mean()))
    cols = []
    for j in range(k):
        df = float(post.nu[j]) - d + 1
        # NIW posterior predictive: t with scale psi^-1 (kappa+1) /
        # (kappa df), psi the precision-side scale (niw.py)
        scale = (np.linalg.inv(np.asarray(post.psi[j]))
                 * (float(post.kappa[j]) + 1)
                 / (float(post.kappa[j]) * df))
        cols.append(stats.multivariate_t(np.asarray(post.mu[j]), scale,
                                         df=df).logpdf(x))
    want = logsumexp(np.stack(cols, axis=1) + log_w[None, :], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_predict_mode_tie_break_first_occurrence():
    """prediction='mode' on EXACT weight ties picks the FIRST tied expert:
    experts 1 and 3 duplicate expert 0 and the gating is flat, so where
    expert 0 wins the mode prediction is expert 0's own moments."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(-2, 2, (640, 1)), jnp.float64)
    y = jnp.asarray(0.5 * np.asarray(x)
                    + 0.05 * rng.standard_normal((640, 1)), jnp.float64)
    m = BayesianILR.make(size=6, input_dim=1, output_dim=1, alpha=2.0,
                         gating='dirichlet', kappa=0.05, dtype=jnp.float64)
    resp = jnp.asarray(rng.dirichlet(np.ones(6), 640))
    st = jax.jit(m._mf_update)((x, y), resp)
    bp, ep = st.components
    dup = lambda a: a.at[1].set(a[0]).at[3].set(a[0])
    st2 = st._replace(
        components=(jax.tree.map(dup, bp), jax.tree.map(dup, ep)),
        gating=jax.tree.map(jnp.ones_like, st.gating))

    @jax.jit
    def run(st, x):
        mu = m.predict(st, x, None, prediction='mode')[0]
        return mu, m.predictive_weights(st, x), m.predictive_moments(st, x)[0]
    mu, w, mus = (np.asarray(a) for a in run(st2, x))
    top = np.argmax(w, axis=-1)
    tied = np.sum(w >= w.max(-1, keepdims=True) * (1 - 1e-12), axis=-1) > 1
    assert tied.any(), 'fixture failed to create exact weight ties'
    assert (top[tied] == 0).all()
    np.testing.assert_allclose(mu[tied], mus[tied, 0], rtol=1e-10)


# -- compiled kernel on the GPU (`pytest -m gpu`; skipped elsewhere) ----------

@pytest.fixture
def gpu():
    if jax.default_backend() != 'gpu':
        pytest.skip('needs a GPU; run `pytest -m gpu tests/` on one')


@pytest.mark.gpu
@pytest.mark.parametrize('kind', ['gauss', 'diag', 'ilr'])
def test_gpu_kernel_estep_matches_blockwise(gpu, kind):
    """The compiled kernel at a tail-masked N equals the XLA engine."""
    n = 100_003
    model, data, post, log_pi = _problem(kind, n)
    spec = model._estep_spec()
    ref = jax.jit(lambda p, l, d: fused_estep_blockwise(spec, p, l, d, n))(
        post, log_pi, data)
    got = jax.jit(lambda p, l, d: te.fused_estep_pallas(spec, p, l, d))(
        post, log_pi, data)
    _assert_estep_close(got, ref)


@pytest.mark.gpu
def test_gpu_kernel_gibbs_matches_labels_and_softmax(gpu):
    """The compiled Gibbs mode: statistics match its labels, and the
    label counts follow the XLA sampler's within a chi-square bound."""
    from scipy import stats
    n = 200_000
    model, data, post, log_pi = _problem('gauss', n)
    params = model.family.mode_params(post)
    spec = model._estep_spec()
    labels, res = jax.jit(lambda k, p, l, d: te.fused_gibbs_pallas(
        spec, k, p, l, d))(jax.random.PRNGKey(5), params, log_pi, data)
    counts = np.bincount(np.asarray(labels), minlength=model.size)
    np.testing.assert_allclose(np.asarray(res.counts), counts, atol=0.5)
    lab_x, _ = jax.jit(lambda k, p, l, d: fused_gibbs_blockwise(
        spec, k, p, l, d, n))(jax.random.PRNGKey(6), params, log_pi, data)
    cx = np.bincount(np.asarray(lab_x), minlength=model.size)
    keep = (counts + cx) > 10
    table = np.stack([counts[keep], cx[keep]])
    assert stats.chi2_contingency(table)[1] > 1e-4


@pytest.mark.gpu
def test_gpu_fit_vi_fused_pallas_matches_xla(gpu):
    """End to end through the public entry point: backend='pallas' and
    backend='xla' give the same ELBO trace."""
    x = _gmm_data(200_000)
    model = BayesianGMM.make(size=16, dim=2, gating='dp', kappa=0.05,
                             psi_scale=0.5, dtype=jnp.float32)
    _, v_p = model.fit_vi_fused(x, key=1, maxiter=30, backend='pallas')
    _, v_x = model.fit_vi_fused(x, key=1, maxiter=30, backend='xla',
                                block_size=50_000)
    np.testing.assert_allclose(np.asarray(v_p), np.asarray(v_x), rtol=1e-4)
