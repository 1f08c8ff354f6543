"""Tests for chain parallelism (parallel/chains.py): fit_chains caching,
SMC-flavored population Gibbs, and its transform consistency on ILR."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mimo_tpu.models.gmm import BayesianGMM
from mimo_tpu.models.ilr import BayesianILR
from mimo_tpu.distributions.niw import GaussParams
from mimo_tpu.parallel.chains import fit_chains, best_of, smc_gibbs


def _gmm_data(n=2000):
    lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
    x, _ = BayesianGMM.generate(
        jax.random.PRNGKey(7),
        GaussParams(jnp.asarray([[-4., 0.], [4., 0.], [0., 5.]]), lm),
        jnp.asarray([.3, .4, .3]), n)
    return x.astype(jnp.float64)


def test_fit_chains_cached_and_deterministic():
    x = _gmm_data()
    m = BayesianGMM.make(size=6, dim=2, kappa=0.05, psi_scale=0.5,
                         dtype=jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    st1, v1 = fit_chains(m, 'fit_vi', x, keys, maxiter=20)
    assert ('fit_chains', 'fit_vi', (('maxiter', 20),)) in m._cache
    st2, v2 = fit_chains(m, 'fit_vi', x, keys, maxiter=20)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2))
    best_state, idx = best_of(st1, v1)
    assert 0 <= int(idx) < 4


@pytest.mark.slow
def test_smc_gibbs_gmm_improves():
    x = _gmm_data()
    m = BayesianGMM.make(size=8, dim=2, gating='dp', kappa=0.05,
                         psi_scale=0.5, dtype=jnp.float64)
    states, lls = smc_gibbs(m, x, key=0, n_chains=4, n_rounds=6,
                            sweeps_per_round=5)
    lls = np.asarray(lls)
    assert np.isfinite(lls).all()
    assert lls[-1] > lls[0]          # population log-lik improves
    assert states.labels.shape == (4, x.shape[0])


@pytest.mark.slow
def test_smc_gibbs_ilr_transform_consistency():
    """Regression: smc_gibbs used to init chains through the ILR fit_gibbs
    wrapper (standardized data) but sweep/score on raw data — two different
    posteriors in one chain. Now everything runs on the transformed data."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-6, 6, (800, 1)), jnp.float64)
    y = jnp.asarray(np.sin(np.asarray(x))
                    + 0.1 * rng.standard_normal((800, 1)), jnp.float64)
    m = BayesianILR.make(size=10, input_dim=1, output_dim=1, alpha=2.0,
                         kappa=0.05, dtype=jnp.float64)
    m.init_transform(x, y)
    states, lls = smc_gibbs(m, (x, y), key=1, n_chains=4, n_rounds=4,
                            sweeps_per_round=5)
    lls = np.asarray(lls)
    assert np.isfinite(lls).all()
    assert lls[-1] > lls[0]

@pytest.mark.slow
def test_fit_chains_pallas_backend():
    """Chains x kernels: vmapped restarts run THROUGH the fused kernel
    (interpret mode here); vmap prepends a batch axis to every kernel
    operand and a grid axis to the launch. VI traces must match
    per-chain serial fits; Gibbs chains must be finite and distinct."""
    x = _gmm_data().astype(jnp.float32)
    m = BayesianGMM.make(size=6, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    st, v = fit_chains(m, 'fit_vi_fused', x, keys, maxiter=15,
                       backend='interpret')
    for i, k in enumerate(keys):
        _, vi = m.fit_vi_fused(x, key=k, maxiter=15, backend='interpret')
        np.testing.assert_allclose(np.asarray(v)[i], np.asarray(vi),
                                   rtol=2e-5)
    gss = fit_chains(m, 'fit_gibbs_fused', x, keys, maxiter=5,
                     backend='interpret')
    lab = np.asarray(gss.labels)
    assert lab.shape == (3, x.shape[0])
    assert np.isfinite(np.asarray(gss.log_pi)).all()
    assert len({tuple(lab[i, :40]) for i in range(3)}) == 3
