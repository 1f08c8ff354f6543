"""Infinite mixture of linear regressions (ILR) — Bayesian mixture of
linear-Gaussian experts with Gaussian basis functions.

JAX re-design of mimo/mixtures/ilr.py: the joint density
p(x, y, z=k) = gating(k) * basis_k(x) * model_k(y | x) is a product
conjugate family, so all four inference engines come for free from the
generic `BayesianMixture`; this class adds the prediction machinery
(posterior-predictive weights, per-expert Student-t moments, moment-matched
mixture prediction, NLPD — ilr.py:325-430).
"""

from typing import Optional

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from mimo_tpu.conjugate.families import (
    gaussian_family, ilr_family, linear_family, diag_linear_family,
    tied_family,
)
from mimo_tpu.distributions.gating import Dirichlet, StickBreaking
from mimo_tpu.distributions import affine as _aff
from mimo_tpu.distributions import hierarchical as _hier
from mimo_tpu.distributions import niw as _niw
from mimo_tpu.distributions import mnw as _mnw
from mimo_tpu.distributions import mng as _mng
from mimo_tpu.distributions.affine import TiedAffine
from mimo_tpu.distributions.hierarchical import HierTied
from mimo_tpu.distributions.mnw import augment
from mimo_tpu.distributions.niw import NIW
from mimo_tpu.distributions.mnw import MNW
from mimo_tpu.distributions.mng import MNG
from mimo_tpu.models.mixture import BayesianMixture, MFState
from mimo_tpu.utils.data import Standardizer
from mimo_tpu.utils.stats import normalize_log


class BayesianILR(BayesianMixture):
    """Bayesian mixture of linear-Gaussian experts.

    components_prior = (basis_prior: NIW, models_prior: MNW | MNG); the
    experts are affine by default (ones column appended to x,
    lingauss.py:107-108).
    """

    def __init__(self, gating_prior, basis_prior, models_prior,
                 affine=True, maxsubiter=25):
        if isinstance(models_prior, MNW):
            diag, tied_affine = False, False
        elif isinstance(models_prior, MNG):
            diag, tied_affine = True, False
        elif isinstance(models_prior, TiedAffine):
            diag, tied_affine = False, True
            affine = True  # the offset IS the affine part
        else:
            raise TypeError(f'unsupported models prior: {type(models_prior)}')
        hier_basis = isinstance(basis_prior, HierTied)
        self.affine = affine
        self.diag = diag
        self.tied_affine = tied_affine
        self.hier_basis = hier_basis
        self.input_dim = (basis_prior.mus if hier_basis
                          else basis_prior.mu).shape[-1]
        self.output_dim = models_prior.M.shape[-2]
        family = ilr_family(affine=affine, diag=diag,
                            tied_affine=tied_affine, hier_basis=hier_basis,
                            maxsubiter=maxsubiter)
        super().__init__(gating_prior, (basis_prior, models_prior), family)
        self.input_transform: Optional[Standardizer] = None
        self.output_transform: Optional[Standardizer] = None

    @staticmethod
    def make(size, input_dim, output_dim, gating='stick-breaking', alpha=1.0,
             affine=True, diag=False, tied_affine=False, hier_basis=False,
             kappa=1e-2, K_scale=1e-2, psi_scale=1.0, basis_psi_scale=1.0,
             maxsubiter=25, dtype=jnp.float32):
        """Convenience constructor mirroring the reference examples' prior
        construction (evaluate_sine.py:88-127; hilr tied-activation:
        tied_affine=True, hier_basis=True)."""
        if gating == 'dirichlet':
            g = Dirichlet.standard(size, alpha, dtype)
        else:
            g = StickBreaking.standard(size, alpha, dtype)
        if hier_basis:
            basis = HierTied.standard(size, input_dim, kappa=1.0,
                                      hyper_kappa=kappa,
                                      psi_scale=basis_psi_scale, dtype=dtype)
        else:
            basis = NIW.standard(size, input_dim, kappa=kappa,
                                 psi_scale=basis_psi_scale, dtype=dtype)
        if tied_affine:
            models = TiedAffine.standard(size, output_dim, input_dim,
                                         K_scale=K_scale, kappa=kappa,
                                         psi_scale=psi_scale, dtype=dtype)
        elif diag:
            models = MNG.standard(size, output_dim,
                                  input_dim + (1 if affine else 0),
                                  K_scale=K_scale, dtype=dtype)
        else:
            models = MNW.standard(size, output_dim,
                                  input_dim + (1 if affine else 0),
                                  K_scale=K_scale, psi_scale=psi_scale,
                                  dtype=dtype)
        return BayesianILR(g, basis, models, affine=affine,
                           maxsubiter=maxsubiter)

    def sample(self, state, key=None, n=1, params='mode'):
        """Draw (x, y, z) from the FITTED model — the reference's
        `model.rvs(size)` (ilr.py:51-64). Samples are in ORIGINAL units
        (the standardization is inverted). `params`: 'mode' | 'mean' |
        'draw' (posterior draw of the likelihood params)."""
        key = jax.random.PRNGKey(key or 0) \
            if isinstance(key, (int, type(None))) else key
        k_p, k_d = jax.random.split(key)
        if params == 'draw':
            bp, ep = self.family.sample_params(k_p, state.components)
        elif params == 'mean':
            bp, ep = self.family.mean_params(state.components)
        else:
            bp, ep = self.family.mode_params(state.components)
        if hasattr(ep, 'lmbda_diag'):  # diagonal experts -> full precision
            from mimo_tpu.distributions.mnw import LinGaussParams
            ep = LinGaussParams(A=ep.A,
                                lmbda=jax.vmap(jnp.diag)(ep.lmbda_diag))
        x, y, z = BayesianILR.generate(k_d, bp, ep, state.gating.mean(), n,
                                       affine=self.affine)
        if self.input_transform is not None:
            x = self.input_transform.inverse_transform(x)
        if self.output_transform is not None:
            y = self.output_transform.inverse_transform(y)
        return x, y, z

    @staticmethod
    def generate(key, basis_params, expert_params, weights, n, affine=True):
        """Draw (x, y, z) from a known mixture of linear experts — the
        reference's self-validating demo generator (ilr.py:51-64),
        vectorized and gather-free."""
        from mimo_tpu.utils.linalg import inv_psd, symmetrize
        k_z, k_x, k_y = jax.random.split(key, 3)
        kk = weights.shape[-1]
        z = jax.random.categorical(
            k_z, jnp.broadcast_to(jnp.log(weights), (n, kk)), axis=-1)
        oh = jax.nn.one_hot(z, kk, dtype=weights.dtype)
        # x | z ~ N(mu_z, lmbda_z^{-1})
        bx_chol = jnp.linalg.cholesky(symmetrize(inv_psd(basis_params.lmbda)))
        ex = jax.random.normal(k_x, (n, basis_params.mu.shape[-1]),
                               weights.dtype)
        x = oh @ basis_params.mu + jnp.einsum('nk,kde,ne->nd', oh, bx_chol, ex)
        # y | x, z ~ N(A_z xt, lmbda_z^{-1})
        xa = augment(x, affine)
        mean_y = jnp.einsum('nk,kpq,nq->np', oh, expert_params.A, xa)
        ey_chol = jnp.linalg.cholesky(symmetrize(inv_psd(expert_params.lmbda)))
        ey = jax.random.normal(k_y, (n, expert_params.A.shape[-2]),
                               weights.dtype)
        y = mean_y + jnp.einsum('nk,kpr,nr->np', oh, ey_chol, ey)
        return x, y, z

    # -- standardization (ilr.py:107-127) ----------------------------------

    def init_transform(self, x, y):
        self.input_transform = Standardizer.fit(x)
        self.output_transform = Standardizer.fit(y)

    def _tx(self, x):
        return x if self.input_transform is None \
            else self.input_transform.transform(x)

    def _ty(self, y):
        return y if self.output_transform is None \
            else self.output_transform.transform(y)

    def fit_vi(self, data, **kw):
        x, y = data
        return super().fit_vi((self._tx(x), self._ty(y)), **kw)

    def fit_svi(self, data, **kw):
        x, y = data
        return super().fit_svi((self._tx(x), self._ty(y)), **kw)

    def fit_gibbs(self, data, **kw):
        x, y = data
        return super().fit_gibbs((self._tx(x), self._ty(y)), **kw)

    def fit_em(self, data, **kw):
        """Likelihood-only EM (MixtureOfLinearGaussians.max_likelihood,
        ilr.py:82-86)."""
        x, y = data
        return super().fit_em((self._tx(x), self._ty(y)), **kw)

    def _estep_spec(self):
        from mimo_tpu.ops.family_estep import ilr_spec
        return ilr_spec(self.input_dim, self.output_dim,
                        affine=self.affine, diag_expert=self.diag,
                        hier_basis=self.hier_basis,
                        tied_affine=self.tied_affine)

    def fit_vi_fused(self, data, **kw):
        """Fused blockwise VI for large-N expert mixtures (the N x K
        responsibilities and the N x (pq + q^2 + p^2) expected-stat
        tensors never exist; cf. the reference's fold=False hazard)."""
        x, y = data
        return super().fit_vi_fused((self._tx(x), self._ty(y)), **kw)

    def fit_gibbs_fused(self, data, **kw):
        """Fused blockwise Gibbs for large-N expert mixtures."""
        x, y = data
        return super().fit_gibbs_fused((self._tx(x), self._ty(y)), **kw)

    def fit_em_fused(self, data, **kw):
        """Fused blockwise likelihood-only EM (plug-in softmax E-step)."""
        x, y = data
        return super().fit_em_fused((self._tx(x), self._ty(y)), **kw)

    def fit_map_fused(self, data, **kw):
        """Fused blockwise MAP-EM (plug-in softmax at the posterior
        mode)."""
        x, y = data
        return super().fit_map_fused((self._tx(x), self._ty(y)), **kw)

    # -- prediction (ilr.py:325-430) ----------------------------------------

    def predictive_weights(self, state: MFState, x, dist='studentt'):
        """Input-conditional expert weights (ilr.py:339-347):
        softmax_k [ log E[pi_k] + log basis-predictive_k(x) ] -> (N, K)."""
        basis_post, _ = state.components
        mod = _hier if self.hier_basis else _niw
        log_basis = (mod.log_predictive_studentt(basis_post, x)
                     if dist == 'studentt'
                     else mod.log_predictive_gaussian(basis_post, x))
        log_w = log_basis + self.predictive_log_weights(state)[None, :]
        weights, _ = normalize_log(log_w)
        return weights

    def predictive_activation(self, state: MFState, x):
        """Normalized basis activations for plotting (ilr.py:325-337):
        Gaussian posterior-predictive basis responsibilities -> (N, K)."""
        return self.predictive_weights(state, self._tx(x), dist='gaussian')

    def predictive_moments(self, state: MFState, x, dist='studentt'):
        """Per-expert predictive mean (N, K, p) and covariance
        (N, K, p, p) or diagonal (N, K, p) (ilr.py:349-357)."""
        _, models_post = state.components
        xa = augment(x, self.affine)
        if self.tied_affine:
            models_post = _aff.to_packed_mnw(models_post)
        if self.diag:
            fn = (_mng.predictive_moments_studentt if dist == 'studentt'
                  else _mng.predictive_moments_gaussian)
        else:
            fn = (_mnw.predictive_moments_studentt if dist == 'studentt'
                  else _mnw.predictive_moments_gaussian)
        return fn(models_post, xa)

    @staticmethod
    def mixture_moments(mus, covars, weights, diag):
        """Moment matching of a mixture (ilr.py:364-372); weights (N, K)."""
        mu = jnp.einsum('nkp,nk->np', mus, weights)
        if diag:
            second = covars + jnp.square(mus)
            var = jnp.einsum('nkp,nk->np', second, weights) - jnp.square(mu)
            return mu, var
        second = covars + mus[..., :, None] * mus[..., None, :]
        cov = jnp.einsum('nkpr,nk->npr', second, weights) \
            - mu[..., :, None] * mu[..., None, :]
        return mu, cov

    def log_predictive_likelihood(self, state: MFState, x, y,
                                  dist='studentt'):
        """Per-expert log p(y | x) under the posterior predictive -> (N, K)
        (ilr.py:359-362)."""
        _, models_post = state.components
        xa = augment(x, self.affine)
        if self.tied_affine:
            models_post = _aff.to_packed_mnw(models_post)
        if self.diag:
            fn = (_mng.log_predictive_studentt if dist == 'studentt'
                  else _mng.log_predictive_gaussian)
        else:
            fn = (_mnw.log_predictive_studentt if dist == 'studentt'
                  else _mnw.log_predictive_gaussian)
        return fn(models_post, xa, y)

    def predict(self, state: MFState, x, y=None, prediction='average',
                dist='studentt', incremental=False):
        """Posterior-predictive regression (ilr.py:374-430).

        Returns (mean, var_diag, std, nlpd) with nlpd None unless y given.
        Handles the optional standardization round-trip. `incremental`
        adds the input back onto the prediction (delta-dynamics models,
        ilr.py:411-413)."""
        xx = self._tx(x)
        weights = self.predictive_weights(state, xx, dist)
        mus, covars = self.predictive_moments(state, xx, dist)

        if prediction == 'mode':
            k = jnp.argmax(weights, axis=-1)
            idx = jnp.arange(x.shape[0])
            mu = mus[idx, k]
            cov = covars[idx, k]
        else:
            mu, cov = self.mixture_moments(mus, covars, weights, self.diag)

        nlpd = None
        if y is not None:
            yy = self._ty(y)
            log_pl = self.log_predictive_likelihood(state, xx, yy, dist)
            log_w = jnp.log(weights + 1e-37)
            nlpd = -logsumexp(log_pl + log_w, axis=-1)
            if self.output_transform is not None:
                # change-of-variables Jacobian: p(y) = p(y_std) / prod(scale),
                # so NLPD in ORIGINAL units adds sum(log scale). (The
                # reference omits this and reports standardized-unit NLPD,
                # ilr.py:405-409 — a deliberate fix, not a parity break.)
                nlpd = nlpd + jnp.sum(jnp.log(self.output_transform.scale))

        if self.output_transform is not None:
            mu = self.output_transform.inverse_transform(mu)
            if self.diag:
                cov = cov * jnp.square(self.output_transform.scale)
            else:
                cov = self.output_transform.scale_cov(cov)

        if incremental:
            mu = mu + x[:, :mu.shape[-1]]
        var = cov if self.diag else jnp.diagonal(cov, axis1=-2, axis2=-1)
        return mu, var, jnp.sqrt(var), nlpd
