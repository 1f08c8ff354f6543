"""Gaussian mixture models: maximum-likelihood GMM and Bayesian (DP-)GMM.

JAX re-design of mimo/mixtures/gmm.py. `BayesianGMM` covers the
reference's `BayesianMixtureOfGaussians` in all its example configurations:
  * gmm/dgmm:  full or diagonal covariance (NIW or Normal-Gamma components)
  * tgmm/tdgmm: tied covariance (tied_family)
  * Dirichlet or truncated stick-breaking (DP) gating.
"""


import jax
import jax.numpy as jnp

from mimo_tpu.conjugate.families import (
    gaussian_family, diag_gaussian_family, tied_family, hier_gaussian_family,
)
from mimo_tpu.distributions.gating import Dirichlet, StickBreaking
from mimo_tpu.distributions.hierarchical import HierTied
from mimo_tpu.distributions.niw import NIW, GaussParams
from mimo_tpu.distributions.ng import NG
from mimo_tpu.models.mixture import BayesianMixture, EMState
from mimo_tpu.utils.linalg import inv_psd, symmetrize
from mimo_tpu.utils.stats import normalize_log, mvn_logpdf


class BayesianGMM(BayesianMixture):
    """Bayesian mixture of Gaussians with conjugate priors.

    Args:
      gating_prior: Dirichlet or StickBreaking prior over mixture weights.
      components_prior: NIW (full covariance) or NG (diagonal) prior,
        K-batched.
      tied: share the covariance scale across components (tgmm/tdgmm).
    """

    def __init__(self, gating_prior, components_prior, tied=False,
                 maxsubiter=25):
        if isinstance(components_prior, NIW):
            family = gaussian_family()
        elif isinstance(components_prior, NG):
            family = diag_gaussian_family()
        elif isinstance(components_prior, HierTied):
            family = hier_gaussian_family(nb_iter=maxsubiter,
                                          gibbs_iter=max(1, maxsubiter // 5))
            if tied:
                raise ValueError('HierTied is already precision-tied')
        else:
            raise TypeError(f'unsupported component prior: {type(components_prior)}')
        if tied and not isinstance(components_prior, HierTied):
            family = tied_family(family)
        self.tied = tied
        super().__init__(gating_prior, components_prior, family)

    @staticmethod
    def make(size, dim, gating='dirichlet', alpha=1.0, diag=False, tied=False,
             hierarchical=False, mean=None, kappa=1e-2, psi_scale=1.0,
             nu=None, maxsubiter=25, dtype=jnp.float32):
        """Convenience constructor mirroring the reference examples' inline
        prior construction (e.g. examples/dgmm/gibbs_dgmm.py:40-55;
        hierarchical: examples/hgauss, examples/hgmm)."""
        if gating == 'dirichlet':
            g = Dirichlet.standard(size, alpha, dtype)
        elif gating in ('stick-breaking', 'dp'):
            g = StickBreaking.standard(size, alpha, dtype)
        else:
            raise ValueError(gating)
        if hierarchical:
            c = HierTied.standard(size, dim, kappa=1.0, hyper_kappa=kappa,
                                  psi_scale=psi_scale, nu=nu, dtype=dtype)
        elif diag:
            c = NG.standard(size, dim, mean=mean, kappa=kappa, dtype=dtype)
        else:
            c = NIW.standard(size, dim, mean=mean, kappa=kappa,
                             psi_scale=psi_scale, nu=nu, dtype=dtype)
        return BayesianGMM(g, c, tied=tied, maxsubiter=maxsubiter)

    def _estep_spec(self):
        from mimo_tpu.ops.family_estep import (
            gaussian_spec, diag_gaussian_spec, hier_gaussian_spec)
        if isinstance(self.components_prior, NIW):
            return gaussian_spec()
        if isinstance(self.components_prior, NG):
            return diag_gaussian_spec()
        if isinstance(self.components_prior, HierTied):
            return hier_gaussian_spec()
        return None

    # sampling synthetic data from the prior predictive of given params
    def sample(self, state, key=None, n=1, params='mode'):
        """Draw (obs, labels) from the FITTED model — the reference's
        `model.rvs(size)` on fitted likelihood params (gmm.py:50-60).

        `params`: 'mode' (MAP plug-in, the reference's post-fit default),
        'mean', or 'draw' (sample params from the posterior first —
        the full posterior predictive)."""
        import jax as _jax
        key = _jax.random.PRNGKey(key or 0) if isinstance(key, (int, type(None))) \
            else key
        k_p, k_d = _jax.random.split(key)
        if params == 'draw':
            p = self.family.sample_params(k_p, state.components)
        elif params == 'mean':
            p = self.family.mean_params(state.components)
        else:
            p = self.family.mode_params(state.components)
        if hasattr(p, 'lmbda_diag'):   # diagonal family -> full precision
            p = GaussParams(mu=p.mu, lmbda=jax.vmap(jnp.diag)(p.lmbda_diag))
        return BayesianGMM.generate(k_d, p, state.gating.mean(), n)

    @staticmethod
    def generate(key, params: GaussParams, weights, n):
        """Draw (obs, labels) from a known mixture — the reference's
        self-validating demo pattern (gmm.py:50-60), vectorized."""
        k_z, k_x = jax.random.split(key)
        labels = jax.random.categorical(
            k_z, jnp.broadcast_to(jnp.log(weights), (n, weights.shape[-1])),
            axis=-1)
        covs = inv_psd(params.lmbda)
        chol = jnp.linalg.cholesky(symmetrize(covs))
        z = jax.random.normal(k_x, (n, params.mu.shape[-1]), params.mu.dtype)
        # gather-free: one-hot contraction instead of chol[labels], which
        # would materialize an (N, d, d) tensor at N in the tens of
        # millions.
        oh = jax.nn.one_hot(labels, params.mu.shape[0], dtype=z.dtype)
        x = oh @ params.mu + jnp.einsum('nk,kde,ne->nd', oh, chol, z)
        return x, labels


class GMM:
    """Maximum-likelihood GMM via EM (reference MixtureOfGaussians,
    gmm.py:16-103). Stateless: `fit_em` returns (EMState, loglik trace)."""

    def __init__(self, size, dim):
        self.size = size
        self.dim = dim
        self._fit = None

    def log_complete_likelihood(self, state: EMState, x):
        return mvn_logpdf(x, state.params.mu, state.params.lmbda) \
            + state.log_pi[None, :]

    def log_likelihood(self, state: EMState, x):
        return jax.scipy.special.logsumexp(
            self.log_complete_likelihood(state, x), axis=-1)

    def responsibilities(self, state: EMState, x):
        resp, _ = normalize_log(self.log_complete_likelihood(state, x))
        return resp

    def sample(self, state: EMState, key=None, n=1):
        """Draw (obs, labels) from the fitted ML model (reference
        MixtureOfGaussians.rvs, gmm.py:50-60)."""
        key = jax.random.PRNGKey(key or 0) \
            if isinstance(key, (int, type(None))) else key
        return BayesianGMM.generate(key, state.params,
                                    jax.nn.softmax(state.log_pi), n)

    def _m_step(self, x, resp, jitter=1e-6):
        """Closed-form weighted ML (gaussian.py:525-542, vectorized over K)."""
        n, d = x.shape
        counts = jnp.sum(resp, axis=0)                       # (K,)
        safe = jnp.maximum(counts, 1e-8)                     # empty component
        mu = (resp.T @ x) / safe[:, None]
        xx = (x[:, :, None] * x[:, None, :]).reshape(n, d * d)
        exx = (resp.T @ xx).reshape(-1, d, d) / safe[:, None, None]
        sigma = symmetrize(exx - mu[:, :, None] * mu[:, None, :]) \
            + jitter * jnp.eye(d, dtype=x.dtype)
        params = GaussParams(mu=mu, lmbda=inv_psd(sigma))
        log_pi = jnp.log(jnp.clip(counts, 1e-37, None) / n)
        return EMState(params=params, log_pi=log_pi)

    def fit_em(self, x, key=None, maxiter=250):
        """EM from random responsibilities. Returns (EMState, loglik trace)."""
        if isinstance(key, int) or key is None:
            key = jax.random.PRNGKey(key or 0)

        if self._fit is None:
            def run(x, key, maxiter):
                nn = x.shape[0]
                r = jax.random.uniform(key, (nn, self.size), dtype=x.dtype,
                                       minval=1e-3, maxval=1.0)
                resp = r / jnp.sum(r, axis=-1, keepdims=True)

                def step(resp, _):
                    state = self._m_step(x, resp)
                    log_p = self.log_complete_likelihood(state, x)
                    resp, lognorm = normalize_log(log_p)
                    return resp, (state, jnp.sum(lognorm))

                _, (states, trace) = jax.lax.scan(step, resp, None,
                                                  length=maxiter)
                last = jax.tree.map(lambda a: a[-1], states)
                return last, trace

            self._fit = jax.jit(run, static_argnums=2)
        return self._fit(x, key, maxiter)
