"""Normal-Wishart conjugate family for full-covariance Gaussian components.

Model (per component k): Lambda_k ~ W(psi_k, nu_k),
mu_k | Lambda_k ~ N(m_k, (kappa_k Lambda_k)^{-1});
likelihood x ~ N(mu_k, Lambda_k^{-1}).

All functions take a leading K axis on parameters and return (N, K) for
per-point quantities. This file is the JAX re-design of the
reference's GaussianWithPrecision / Wishart / NormalWishart /
StackedNormalWisharts stack (gaussian.py:251-543, composite.py:19-283) —
K components are a batch axis, not a Python list of objects.

Natural-parameter convention matches the reference (composite.py:50-72):
  nat = [kappa*m, kappa, psi^{-1} + kappa*m m^T, nu - d]
paired with Gaussian sufficient statistics
  t(x) = [x, 1, x x^T, 1].
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mimo_tpu.utils.linalg import (
    cholesky, inv_psd, symmetrize, quad_form,
)
from mimo_tpu.utils.stats import LOG2PI, mvn_logpdf, mvt_logpdf
from mimo_tpu.distributions.wishart import (
    wishart_sample, wishart_expected_logdet, wishart_log_partition,
)


class NIW(NamedTuple):
    """Normal-Wishart parameters, batched over leading axes."""
    mu: jax.Array     # (K, d)
    kappa: jax.Array  # (K,)
    psi: jax.Array    # (K, d, d)  Wishart scale, E[Lambda] = nu * psi
    nu: jax.Array     # (K,)

    @property
    def dim(self):
        return self.mu.shape[-1]

    @staticmethod
    def standard(size, dim, mean=None, kappa=1e-2, psi_scale=1.0, nu=None,
                 dtype=jnp.float32):
        """Weakly-informative prior replicated over K components."""
        mean = jnp.zeros(dim, dtype) if mean is None else jnp.asarray(mean, dtype)
        nu = float(dim + 2) if nu is None else nu
        return NIW(
            mu=jnp.broadcast_to(mean, (size, dim)).astype(dtype),
            kappa=jnp.full((size,), kappa, dtype),
            psi=jnp.broadcast_to(psi_scale * jnp.eye(dim, dtype=dtype),
                                 (size, dim, dim)),
            nu=jnp.full((size,), nu, dtype),
        )


class GaussStats(NamedTuple):
    """Weighted Gaussian sufficient statistics, aligned with NIW nat params."""
    x: jax.Array    # (K, d)     sum_n r_nk x_n
    n1: jax.Array   # (K,)       sum_n r_nk
    xxT: jax.Array  # (K, d, d)  sum_n r_nk x_n x_n^T
    n2: jax.Array   # (K,)       sum_n r_nk


class GaussParams(NamedTuple):
    """Plug-in Gaussian likelihood parameters (for Gibbs / EM / MAP)."""
    mu: jax.Array     # (K, d)
    lmbda: jax.Array  # (K, d, d) precision


# ---------------------------------------------------------------------------
# sufficient statistics
# ---------------------------------------------------------------------------

def suff_stats(x, resp):
    """Weighted statistics from data x (N, d) and resp (N, K).

    Replaces the 'kn,nd->kd' / 'nd,kn,nl->kdl' einsums of
    gaussian.py:491-505 with two matmuls: resp^T @ x and
    (x ⊗ x)^T @ resp via the shared (N, d^2) squared-feature matrix.
    """
    n, d = x.shape
    sx = resp.T @ x                                          # (K, d)
    xx = (x[:, :, None] * x[:, None, :]).reshape(n, d * d)
    sxx = (resp.T @ xx).reshape(-1, d, d)                    # (K, d, d)
    counts = jnp.sum(resp, axis=0)                           # (K,)
    return GaussStats(x=sx, n1=counts, xxT=symmetrize(sxx), n2=counts)


# ---------------------------------------------------------------------------
# natural <-> standard parameters (composite.py:50-72 convention)
# ---------------------------------------------------------------------------

def nat_from_std(p: NIW) -> GaussStats:
    d = p.dim
    kmm = p.kappa[..., None, None] * (p.mu[..., :, None] * p.mu[..., None, :])
    return GaussStats(
        x=p.kappa[..., None] * p.mu,
        n1=p.kappa,
        xxT=inv_psd(p.psi) + kmm,
        n2=p.nu - d,
    )


def std_from_nat(nat: GaussStats) -> NIW:
    d = nat.x.shape[-1]
    mu = nat.x / nat.n1[..., None]
    kmm = nat.n1[..., None, None] * (mu[..., :, None] * mu[..., None, :])
    return NIW(mu=mu, kappa=nat.n1, psi=inv_psd(nat.xxT - kmm), nu=nat.n2 + d)


# ---------------------------------------------------------------------------
# conjugate update
# ---------------------------------------------------------------------------

def posterior_update(prior: NIW, stats: GaussStats) -> NIW:
    """Closed-form conjugate update: nat(post) = nat(prior) + stats.

    Implemented directly in standard space (equivalent algebra, one
    Cholesky solve instead of two full nat round-trips):
      kappa' = kappa + n;  m' = (kappa m + s1)/kappa';  nu' = nu + n;
      psi'^{-1} = psi^{-1} + S2 + kappa m m^T - kappa' m' m'^T.
    Matches bayesian.py:220 + composite.py:67-72.
    """
    kappa_n = prior.kappa + stats.n1
    mu_n = (prior.kappa[..., None] * prior.mu + stats.x) / kappa_n[..., None]
    nu_n = prior.nu + stats.n2
    # numerically-robust centered form (algebraically identical):
    #   psi'^{-1} = psi^{-1} + (S2 - n xbar xbar^T)
    #             + (kappa n / kappa') (xbar - m)(xbar - m)^T
    # avoids the kappa m m^T - kappa' m' m'^T cancellation at float32.
    n_safe = jnp.maximum(stats.n1, jnp.asarray(1e-12, stats.n1.dtype))
    xbar = stats.x / n_safe[..., None]
    scatter = stats.xxT - stats.n1[..., None, None] * (
        xbar[..., :, None] * xbar[..., None, :])
    dm = xbar - prior.mu
    coef = prior.kappa * stats.n1 / kappa_n
    psi_inv_n = (inv_psd(prior.psi) + scatter
                 + coef[..., None, None] * (dm[..., :, None] * dm[..., None, :]))
    return NIW(mu=mu_n, kappa=kappa_n, psi=inv_psd(psi_inv_n), nu=nu_n)


def svi_blend(post: NIW, prior: NIW, stats: GaussStats, scale, step) -> NIW:
    """Natural-gradient SVI step (bayesian.py:232-238):
    nat' = (1-step)*nat(post) + step*(nat(prior) + stats/scale)."""
    n_post, n_prior = nat_from_std(post), nat_from_std(prior)
    mixed = jax.tree.map(
        lambda a, b, s: (1.0 - step) * a + step * (b + s / scale),
        n_post, n_prior, stats)
    return std_from_nat(mixed)


# ---------------------------------------------------------------------------
# expectations (the VI E-step) and ELBO terms
# ---------------------------------------------------------------------------

def expected_stats(p: NIW):
    """E_q over (mu, Lambda) of the NW sufficient statistics
    [Lambda mu, -1/2 mu^T Lambda mu, -1/2 Lambda, 1/2 logdet Lambda]
    (composite.py:106-118)."""
    d = p.dim
    psi_chol = cholesky(p.psi)
    e_lm = jnp.einsum('k,kde,ke->kd', p.nu, p.psi, p.mu)           # E[Lambda mu]
    e_mlm = -0.5 * (d / p.kappa + jnp.einsum('kd,kd->k', p.mu, e_lm))
    e_l = -0.5 * p.nu[..., None, None] * p.psi
    e_logdet = 0.5 * wishart_expected_logdet(psi_chol, p.nu)
    return e_lm, e_mlm, e_l, e_logdet


def expected_log_likelihood(p: NIW, x):
    """E_q[log N(x | mu_k, Lambda_k^{-1})] -> (N, K).

    = 1/2 E[logdet] - d/2 log 2pi - 1/2 (nu_k (x-m_k)^T psi_k (x-m_k) + d/kappa_k)

    Fused form of bayesian.py:287-301: the reference materializes the
    N x d x d `fold=False` statistics tensor; here the quadratic reduces to
    matmuls over an (N, d^2) feature matrix shared across K.
    """
    d = x.shape[-1]
    psi_chol = cholesky(p.psi)
    quad = quad_form(x, p.psi, p.mu)                         # (N, K)
    e_logdet = wishart_expected_logdet(psi_chol, p.nu)       # (K,)
    return (0.5 * (e_logdet - d * LOG2PI)
            - 0.5 * (p.nu * quad + d / p.kappa))


def log_partition(p: NIW):
    """log Z of the NW: -d/2 log kappa + logZ_Wishart(psi, nu)
    (composite.py:95-98)."""
    d = p.dim
    psi_chol = cholesky(p.psi)
    return (-0.5 * d * jnp.log(p.kappa)
            + wishart_log_partition(psi_chol, p.nu))


def kl_divergence(q: NIW, p: NIW):
    """KL(q || p) per component (K,).

    = logZ(p) - logZ(q) + <nat(q) - nat(p), E_q[t]> ; equals the reference's
    -(entropy - cross_entropy) (composite.py:120-134) — log-base terms cancel.
    """
    e_lm, e_mlm, e_l, e_logdet = expected_stats(q)
    nq, np_ = nat_from_std(q), nat_from_std(p)
    inner = (jnp.einsum('kd,kd->k', nq.x - np_.x, e_lm)
             + (nq.n1 - np_.n1) * e_mlm
             + jnp.einsum('kde,kde->k', nq.xxT - np_.xxT, e_l)
             + (nq.n2 - np_.n2) * e_logdet)
    return log_partition(p) - log_partition(q) + inner


def log_marginal_likelihood(prior: NIW, posterior: NIW, n):
    """log p(data) = logZ(post) - logZ(prior) - n*d/2 log 2pi
    (bayesian.py:262-265 omits the 2pi term; we keep it for correctness)."""
    d = prior.dim
    return (log_partition(posterior) - log_partition(prior)
            - 0.5 * n * d * LOG2PI)


# ---------------------------------------------------------------------------
# sampling / point estimates of likelihood parameters
# ---------------------------------------------------------------------------

def sample_params(key, p: NIW) -> GaussParams:
    """Draw (mu, Lambda) ~ NW(p), batched over K (composite.py:82-86)."""
    k_w, k_n = jax.random.split(key)
    lmbda = wishart_sample(k_w, p.psi, p.nu)
    # mu | Lambda ~ N(m, (kappa Lambda)^{-1}): mu = m + L^{-T} z / sqrt(kappa)
    chol = cholesky(lmbda)
    z = jax.random.normal(k_n, p.mu.shape, dtype=p.mu.dtype)
    delta = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(chol, -1, -2), z[..., None], lower=False)[..., 0]
    mu = p.mu + delta / jnp.sqrt(p.kappa)[..., None]
    return GaussParams(mu=mu, lmbda=lmbda)


def mode_params(p: NIW) -> GaussParams:
    """Joint MAP point (reference convention: Lambda = (nu - d) psi,
    composite.py:77-80)."""
    d = p.dim
    return GaussParams(mu=p.mu, lmbda=(p.nu - d)[..., None, None] * p.psi)


def mean_params(p: NIW) -> GaussParams:
    return GaussParams(mu=p.mu, lmbda=p.nu[..., None, None] * p.psi)


def ml_params(stats: GaussStats, jitter=1e-6) -> GaussParams:
    """Weighted maximum likelihood from sufficient statistics
    (gaussian.py:525-542, vectorized over K): mu = s1/n,
    Sigma = Sxx/n - mu mu^T (+ jitter I). Components whose effective
    count drops below d+1 (not enough points to estimate a d x d scatter —
    the classic EM singleton collapse) get benign standard-normal params;
    they carry ~zero mixture weight anyway."""
    d = stats.x.shape[-1]
    n = jnp.maximum(stats.n1, 1e-8)
    dead = (stats.n1 < d + 1.0)[..., None]
    mu = jnp.where(dead, 0.0, stats.x / n[..., None])
    sigma = symmetrize(stats.xxT / n[..., None, None]
                       - mu[..., :, None] * mu[..., None, :]) \
        + jitter * jnp.eye(d, dtype=mu.dtype)
    eye = jnp.eye(d, dtype=mu.dtype)
    sigma = jnp.where(dead[..., None], eye, sigma)
    return GaussParams(mu=mu, lmbda=inv_psd(sigma))


# ---------------------------------------------------------------------------
# plug-in likelihood and posterior predictive
# ---------------------------------------------------------------------------

def log_likelihood(params: GaussParams, x):
    """log N(x | mu_k, Lambda_k^{-1}) -> (N, K) (gaussian.py:510-523)."""
    return mvn_logpdf(x, params.mu, params.lmbda)


def predictive_studentt_params(p: NIW):
    """Posterior-predictive Student-t: df = nu-d+1, precision
    (df / (1 + 1/kappa)) * psi (bayesian.py:314-319)."""
    d = p.dim
    df = p.nu - d + 1.0
    c = 1.0 + 1.0 / p.kappa
    lmbda = (df / c)[..., None, None] * p.psi
    return p.mu, lmbda, df


def log_predictive_studentt(p: NIW, x):
    mu, lmbda, df = predictive_studentt_params(p)
    return mvt_logpdf(x, mu, lmbda, df)


def log_predictive_gaussian(p: NIW, x):
    """Moment-matched Gaussian approximation of the predictive
    (bayesian.py:303-312)."""
    mu, lmbda, _ = predictive_studentt_params(p)
    return mvn_logpdf(x, mu, lmbda)
