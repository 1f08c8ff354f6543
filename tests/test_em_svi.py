"""Tests for the likelihood-only EM engine (reference max_likelihood,
gmm.py:77-103, ilr.py:82-86, tied gaussian.py:550-572) and the nested
stochastic VI of mixtures-of-mixtures (hilr.py:460-515)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mimo_tpu.models.gmm import BayesianGMM
from mimo_tpu.models.ilr import BayesianILR
from mimo_tpu.models.hmix import BayesianMixtureOfMixtures
from mimo_tpu.distributions.niw import GaussParams

TRUE_MU = np.array([[-4., 0.], [4., 0.], [0., 5.]])


@pytest.fixture(scope='module')
def gmm_data():
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    x, _ = BayesianGMM.generate(jax.random.PRNGKey(7),
                                GaussParams(jnp.asarray(TRUE_MU), lm),
                                jnp.asarray([.3, .4, .3]), 3000)
    return x.astype(jnp.float64)


def test_em_gmm_recovers(gmm_data):
    m = BayesianGMM.make(size=3, dim=2, dtype=jnp.float64)
    st, ll = m.fit_em(gmm_data, key=0, maxiter=150)
    d = np.diff(np.asarray(ll))
    assert np.all(d > -1e-6), f'EM loglik not monotone: {d.min()}'
    est = np.asarray(st.params.mu)
    for t in TRUE_MU:
        assert np.min(np.linalg.norm(est - t, axis=-1)) < 0.3


def test_em_tied_gmm(gmm_data):
    """Tied EM: shared covariance across components (gaussian.py:550-572)."""
    m = BayesianGMM.make(size=3, dim=2, tied=True, dtype=jnp.float64)
    st, ll = m.fit_em(gmm_data, key=0, maxiter=150)
    lm = np.asarray(st.params.lmbda)
    np.testing.assert_allclose(lm[0], lm[1], rtol=1e-6)
    np.testing.assert_allclose(lm[0], lm[2], rtol=1e-6)
    # the generating covariance is 0.5 I (precision 2 I)
    np.testing.assert_allclose(lm[0], 2.0 * np.eye(2), rtol=0.2, atol=0.1)


def test_em_diag_gmm(gmm_data):
    m = BayesianGMM.make(size=3, dim=2, diag=True, dtype=jnp.float64)
    st, ll = m.fit_em(gmm_data, key=0, maxiter=150)
    est = np.asarray(st.params.mu)
    for t in TRUE_MU:
        assert np.min(np.linalg.norm(est - t, axis=-1)) < 0.3


def test_em_ilr_sine():
    """EM mixture of linear experts fits a sine to near the noise floor."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(-6, 6, (2000, 1)))
    y = jnp.asarray(np.sin(np.asarray(x))
                    + 0.1 * rng.standard_normal((2000, 1)))
    m = BayesianILR.make(size=20, input_dim=1, output_dim=1,
                         dtype=jnp.float64)
    m.init_transform(x, y)
    st, ll = m.fit_em((x, y), key=1, maxiter=200)
    assert np.isfinite(np.asarray(ll)).all()
    assert float(ll[-1]) > float(ll[0])
    basis_p, expert_p = st.params
    assert np.isfinite(np.asarray(expert_p.A)).all()


def test_em_hier_raises(gmm_data):
    m = BayesianGMM.make(size=3, dim=2, hierarchical=True,
                         dtype=jnp.float64)
    with pytest.raises(NotImplementedError):
        m.fit_em(gmm_data, key=0, maxiter=5)


@pytest.mark.slow
def test_hmix_svi_runs():
    """Nested SVI keeps the two super-clusters separated."""
    rng = np.random.default_rng(0)

    def blob(c, n):
        return c + 0.5 * rng.standard_normal((n, 2))

    x = np.vstack([blob([-5, -5], 500), blob([-5, -3], 500),
                   blob([5, 5], 500), blob([5, 3], 500)])
    x = jnp.asarray(x[rng.permutation(2000)], jnp.float64)
    m = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=2, mixture_size=3, dim=2, hierarchical=True,
        kappa=0.5, psi_scale=0.5, maxsubiter=5,
        means=[[-5, -4], [5, 4]], dtype=jnp.float64)
    st, _ = m.fit_vi(x, key=0, maxiter=10, maxsubiter=2)
    st = m.fit_svi(x, key=1, maxiter=100, step_size=0.3, batch_size=256,
                   maxsubiter=2, init_state=st, randomize=False)
    resp = m.expected_responsibilities(st, (x,))
    lab = np.asarray(jnp.argmax(resp, -1))
    left = np.asarray(x)[:, 0] < 0
    assert (lab[left] == lab[left][0]).mean() > 0.9
    assert (lab[~left] == lab[~left][0]).mean() > 0.9
    assert lab[left][0] != lab[~left][0]


@pytest.mark.slow
def test_predictive_activation_and_incremental():
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.uniform(-3, 3, (400, 1)), jnp.float64)
    y = jnp.asarray(0.5 * np.asarray(x) + 0.05
                    * rng.standard_normal((400, 1)), jnp.float64)
    m = BayesianILR.make(size=5, input_dim=1, output_dim=1,
                         dtype=jnp.float64)
    m.init_transform(x, y)
    st, _ = m.fit_vi((x, y), key=0, maxiter=50)
    act = m.predictive_activation(st, x)
    assert act.shape == (400, 5)
    np.testing.assert_allclose(np.asarray(act.sum(-1)), 1.0, rtol=1e-6)
    mu, _, _, _ = m.predict(st, x)
    mu_inc, _, _, _ = m.predict(st, x, incremental=True)
    np.testing.assert_allclose(np.asarray(mu_inc), np.asarray(mu + x),
                               rtol=1e-6)


def test_em_tied_diag_gmm(gmm_data):
    """Tied diagonal EM (the reference's 'tdgmm' config): pooled per-axis
    variances shared across K (gaussian.py:865-888 analogue)."""
    m = BayesianGMM.make(size=3, dim=2, diag=True, tied=True,
                         dtype=jnp.float64)
    st, ll = m.fit_em(gmm_data, key=0, maxiter=150)
    ld = np.asarray(st.params.lmbda_diag)
    np.testing.assert_allclose(ld[0], ld[1], rtol=1e-6)
    np.testing.assert_allclose(ld[0], ld[2], rtol=1e-6)
    # generating precision is 2 per axis
    np.testing.assert_allclose(ld[0], [2.0, 2.0], rtol=0.2)
    est = np.asarray(st.params.mu)
    for t in TRUE_MU:
        assert np.min(np.linalg.norm(est - t, axis=-1)) < 0.3


def test_em_tied_diag_ilr():
    """Tied diagonal-noise linear experts: fit_em must produce
    DiagLinGaussParams with pooled lmbda_diag (regression: tied ML used to
    dispatch on the stats type, sending diag-linear stats down the full-
    covariance branch and crashing on params.lmbda_diag)."""
    from mimo_tpu.conjugate.families import (diag_linear_family,
                                             tied_family)
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.uniform(-3, 3, (1500, 1)))
    y = jnp.asarray(np.where(np.asarray(x) < 0, -1.0, 1.0) * np.asarray(x)
                    + 0.1 * rng.standard_normal((1500, 1)))
    fam = tied_family(diag_linear_family(affine=True))
    resp = jax.nn.one_hot((np.asarray(x)[:, 0] > 0).astype(int), 4,
                          dtype=x.dtype)
    stats = fam.suff_stats((x, y), resp)
    params = fam.ml_update(stats)
    ld = np.asarray(params.lmbda_diag)
    assert ld.shape == (4, 1)
    np.testing.assert_allclose(ld[0], ld[1], rtol=1e-9)  # pooled
    assert np.isfinite(ld).all() and (ld > 0).all()


def test_em_fused_matches_dense(gmm_data):
    """fit_em_fused (plug-in softmax through the fused engines) must
    reproduce fit_em's trajectory exactly: same anchor init, same ML
    updates, the E-step merely streams through blocks."""
    m = BayesianGMM.make(size=3, dim=2, dtype=jnp.float64)
    st_d, ll_d = m.fit_em(gmm_data, key=0, maxiter=40)
    m2 = BayesianGMM.make(size=3, dim=2, dtype=jnp.float64)
    st_f, ll_f = m2.fit_em_fused(gmm_data, key=0, maxiter=40,
                                 backend='xla', block_size=500)
    np.testing.assert_allclose(np.asarray(ll_f), np.asarray(ll_d),
                               rtol=1e-9)
    # params only loosely: the loglik plateau is flat along component-
    # split directions, so f64-rounding-level E-step differences drift
    # the params along it at equal loglik
    np.testing.assert_allclose(np.asarray(st_f.params.mu),
                               np.asarray(st_d.params.mu), atol=0.1)
    np.testing.assert_allclose(np.asarray(st_f.log_pi),
                               np.asarray(st_d.log_pi), atol=0.05)


def test_map_fused_matches_dense(gmm_data):
    m = BayesianGMM.make(size=4, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, dtype=jnp.float64)
    st_d, ll_d = m.fit_map(gmm_data, key=1, maxiter=40)
    m2 = BayesianGMM.make(size=4, dim=2, gating='dp', kappa=0.05,
                          psi_scale=0.5, dtype=jnp.float64)
    st_f, ll_f = m2.fit_map_fused(gmm_data, key=1, maxiter=40,
                                  backend='xla', block_size=500)
    np.testing.assert_allclose(np.asarray(ll_f), np.asarray(ll_d),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(st_f.components.mu),
                               np.asarray(st_d.components.mu), rtol=1e-7)


def test_em_map_fused_pallas_interpret(gmm_data):
    """The kernel path (interpret mode) stays finite and lands on the
    same optimum as the dense engines (f32 kernel against the f64
    dense engine)."""
    x = gmm_data.astype(jnp.float32)
    m = BayesianGMM.make(size=3, dim=2)
    st, ll = m.fit_em_fused(x, key=0, maxiter=30, backend='interpret')
    assert np.isfinite(np.asarray(ll)).all()
    m2 = BayesianGMM.make(size=3, dim=2)
    st_d, ll_d = m2.fit_em(x, key=0, maxiter=30)
    np.testing.assert_allclose(float(ll[-1]), float(np.asarray(ll_d)[-1]),
                               rtol=1e-4)
    m3 = BayesianGMM.make(size=4, dim=2, gating='dp', kappa=0.05,
                          psi_scale=0.5)
    stm, llm = m3.fit_map_fused(x, key=1, maxiter=30, backend='interpret')
    assert np.isfinite(np.asarray(llm)).all()


def test_em_fused_ilr():
    """Linear-expert families run the same plug-in fused EM."""
    rng = np.random.default_rng(3)
    xs = jnp.asarray(rng.uniform(-3, 3, (2000, 1)), jnp.float64)
    ys = jnp.asarray(np.sin(np.asarray(xs))
                     + 0.1 * rng.standard_normal((2000, 1)), jnp.float64)
    m = BayesianILR.make(size=8, input_dim=1, output_dim=1, alpha=2.0,
                         kappa=0.05, dtype=jnp.float64)
    m.init_transform(xs, ys)
    st_d, ll_d = m.fit_em((xs, ys), key=0, maxiter=30)
    m2 = BayesianILR.make(size=8, input_dim=1, output_dim=1, alpha=2.0,
                          kappa=0.05, dtype=jnp.float64)
    m2.init_transform(xs, ys)
    st_f, ll_f = m2.fit_em_fused((xs, ys), key=0, maxiter=30,
                                 backend='xla', block_size=500)
    np.testing.assert_allclose(np.asarray(ll_f), np.asarray(ll_d),
                               rtol=1e-9)
