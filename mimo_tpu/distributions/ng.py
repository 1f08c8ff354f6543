"""Normal-Gamma conjugate family for diagonal-covariance Gaussian components.

Model (per component k, per dimension i): lambda_ki ~ Gamma(alpha_ki, beta_ki),
mu_ki | lambda_ki ~ N(m_ki, (kappa_ki lambda_ki)^{-1});
likelihood x_i ~ N(mu_ki, lambda_ki^{-1}).

JAX re-design of GaussianWithDiagonalPrecision / Gamma / NormalGamma
(gaussian.py:575-888, gamma.py:8-113, composite.py:286-520). Natural params
match composite.py:313-337:
  nat = [kappa*m, kappa, 2*alpha - 1, 2*beta + kappa*m^2]
paired with stats t(x) = [x, 1, 1, x^2].
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln

from mimo_tpu.utils.stats import LOG2PI, diag_mvn_logpdf


class NG(NamedTuple):
    mu: jax.Array     # (K, d)
    kappa: jax.Array  # (K, d)
    alpha: jax.Array  # (K, d)
    beta: jax.Array   # (K, d)

    @property
    def dim(self):
        return self.mu.shape[-1]

    @staticmethod
    def standard(size, dim, mean=None, kappa=1e-2, alpha=None, beta=None,
                 dtype=jnp.float32):
        mean = jnp.zeros(dim, dtype) if mean is None else jnp.asarray(mean, dtype)
        alpha = 2.0 if alpha is None else alpha
        beta = 1.0 if beta is None else beta
        full = lambda v: jnp.broadcast_to(jnp.asarray(v, dtype), (size, dim)).astype(dtype)
        return NG(mu=full(mean), kappa=full(kappa), alpha=full(alpha), beta=full(beta))


class DiagGaussStats(NamedTuple):
    """Weighted diagonal-Gaussian statistics aligned with NG nat params."""
    x: jax.Array    # (K, d)  sum_n r_nk x_n
    n1: jax.Array   # (K,)    sum_n r_nk
    n2: jax.Array   # (K,)    sum_n r_nk
    xsq: jax.Array  # (K, d)  sum_n r_nk x_n^2


class DiagGaussParams(NamedTuple):
    mu: jax.Array          # (K, d)
    lmbda_diag: jax.Array  # (K, d)


def suff_stats(x, resp):
    """x: (N, d), resp: (N, K) -> DiagGaussStats (gaussian.py:789-811)."""
    sx = resp.T @ x
    sxx = resp.T @ jnp.square(x)
    counts = jnp.sum(resp, axis=0)
    return DiagGaussStats(x=sx, n1=counts, n2=counts, xsq=sxx)


def posterior_update(prior: NG, stats: DiagGaussStats) -> NG:
    """Conjugate update (std space, equivalent to nat add):
      kappa' = kappa + n;  m' = (kappa m + s1)/kappa';
      alpha' = alpha + n/2;
      beta'  = beta + 1/2 (s2 + kappa m^2 - kappa' m'^2)."""
    n = stats.n1[..., None]
    kappa_n = prior.kappa + n
    mu_n = (prior.kappa * prior.mu + stats.x) / kappa_n
    alpha_n = prior.alpha + 0.5 * n
    beta_n = prior.beta + 0.5 * (
        stats.xsq + prior.kappa * jnp.square(prior.mu) - kappa_n * jnp.square(mu_n))
    return NG(mu=mu_n, kappa=kappa_n, alpha=alpha_n, beta=beta_n)


def svi_blend(post: NG, prior: NG, stats: DiagGaussStats, scale, step) -> NG:
    """Natural-gradient SVI step in nat space (bayesian.py:232-238 algebra):
    nat' = (1-step)*nat(post) + step*(nat(prior) + stats/scale)."""
    def blend4(post_p, prior_p, s):
        full = posterior_update(prior_p, s)
        # blend in nat coordinates; all four nat coords are affine in
        # (kappa*m, kappa, 2a-1, 2b+kappa m^2) — blend those directly.
        def nats(p):
            return (p.kappa * p.mu, p.kappa, 2 * p.alpha - 1.0,
                    2 * p.beta + p.kappa * jnp.square(p.mu))
        n_post, n_full = nats(post_p), nats(full)
        mixed = tuple((1.0 - step) * a + step * b for a, b in zip(n_post, n_full))
        kappa = mixed[1]
        mu = mixed[0] / kappa
        alpha = 0.5 * (mixed[2] + 1.0)
        beta = 0.5 * (mixed[3] - kappa * jnp.square(mu))
        return NG(mu=mu, kappa=kappa, alpha=alpha, beta=beta)

    scaled = DiagGaussStats(x=stats.x / scale, n1=stats.n1 / scale,
                            n2=stats.n2 / scale, xsq=stats.xsq / scale)
    return blend4(post, prior, scaled)


def expected_log_likelihood(p: NG, x):
    """E_q[log N(x | mu, diag(lambda)^{-1})] -> (N, K).

    = 1/2 sum_i [E[log l_i] - log2pi - E[l_i](x_i - m_i)^2 - 1/kappa_i]
    (bayesian.py:428-486 batched analogue)."""
    d = x.shape[-1]
    e_l = p.alpha / p.beta                                   # (K, d)
    e_logl = digamma(p.alpha) - jnp.log(p.beta)
    quad = (jnp.square(x) @ e_l.T
            - 2.0 * (x @ (e_l * p.mu).T)
            + jnp.sum(e_l * jnp.square(p.mu) + 1.0 / p.kappa, axis=-1))
    return 0.5 * (jnp.sum(e_logl, axis=-1) - d * LOG2PI) - 0.5 * quad


def log_partition(p: NG):
    """logZ = sum_i [-1/2 log kappa_i + log Gamma(alpha_i) - alpha_i log beta_i]
    (composite.py:359-362)."""
    return jnp.sum(-0.5 * jnp.log(p.kappa) + gammaln(p.alpha)
                   - p.alpha * jnp.log(p.beta), axis=-1)


def kl_divergence(q: NG, p: NG):
    """KL(q||p) per component, via logZ + <nat_q - nat_p, E_q[t]>."""
    e_lm = q.alpha / q.beta * q.mu
    e_mlm = -0.5 * (1.0 / q.kappa + q.mu * e_lm)
    e_logl = 0.5 * (digamma(q.alpha) - jnp.log(q.beta))
    e_l = -0.5 * q.alpha / q.beta

    def nats(t: NG):
        return (t.kappa * t.mu, t.kappa, 2 * t.alpha - 1.0,
                2 * t.beta + t.kappa * jnp.square(t.mu))

    nq, np_ = nats(q), nats(p)
    inner = jnp.sum((nq[0] - np_[0]) * e_lm + (nq[1] - np_[1]) * e_mlm
                    + (nq[2] - np_[2]) * e_logl + (nq[3] - np_[3]) * e_l,
                    axis=-1)
    return log_partition(p) - log_partition(q) + inner


def sample_params(key, p: NG) -> DiagGaussParams:
    """Draw (mu, lambda) ~ NG(p) (composite.py:345-349)."""
    k_g, k_n = jax.random.split(key)
    lmbda = jax.random.gamma(k_g, p.alpha, dtype=p.alpha.dtype) / p.beta
    z = jax.random.normal(k_n, p.mu.shape, dtype=p.mu.dtype)
    mu = p.mu + z / jnp.sqrt(p.kappa * lmbda)
    return DiagGaussParams(mu=mu, lmbda_diag=lmbda)


def mode_params(p: NG) -> DiagGaussParams:
    """Reference convention: lambda = (alpha - 1/2)/beta (composite.py:343)."""
    return DiagGaussParams(mu=p.mu, lmbda_diag=(p.alpha - 0.5) / p.beta)


def mean_params(p: NG) -> DiagGaussParams:
    return DiagGaussParams(mu=p.mu, lmbda_diag=p.alpha / p.beta)


def ml_params(stats: DiagGaussStats, jitter=1e-8) -> DiagGaussParams:
    """Weighted diagonal maximum likelihood (gaussian.py:810-830):
    mu = s1/n, var = s2/n - mu^2. Collapsed components get N(0, I)."""
    dead = (stats.n1 < 2.0)[..., None]
    n = jnp.maximum(stats.n1, 1e-8)[..., None]
    mu = jnp.where(dead, 0.0, stats.x / n)
    var = jnp.maximum(stats.xsq / n - jnp.square(mu), jitter)
    var = jnp.where(dead, 1.0, var)
    return DiagGaussParams(mu=mu, lmbda_diag=1.0 / var)


def log_likelihood(params: DiagGaussParams, x):
    return diag_mvn_logpdf(x, params.mu, params.lmbda_diag)


def predictive_studentt_params(p: NG):
    """Per-dim posterior-predictive t: df = 2 alpha, precision
    (alpha/beta) * kappa/(kappa+1)."""
    df = 2.0 * p.alpha
    lmbda = p.alpha / p.beta * p.kappa / (p.kappa + 1.0)
    return p.mu, lmbda, df


def log_predictive_studentt(p: NG, x):
    """Sum of per-dimension univariate t log-pdfs -> (N, K)."""
    mu, lmbda, df = predictive_studentt_params(p)
    xc2 = (jnp.square(x)[:, None, :] - 2.0 * x[:, None, :] * mu[None]
           + jnp.square(mu)[None])                            # (N, K, d)
    delta = lmbda[None] * xc2
    from mimo_tpu.utils.stats import gammaln_diff
    aux = (gammaln_diff(0.5 * df, 0.5)
           + 0.5 * (jnp.log(lmbda) - jnp.log(df) - jnp.log(jnp.pi).astype(x.dtype)))
    out = aux[None] - 0.5 * (df[None] + 1.0) * jnp.log1p(delta / df[None])
    return jnp.sum(out, axis=-1)


def log_predictive_gaussian(p: NG, x):
    mu, lmbda, _ = predictive_studentt_params(p)
    return diag_mvn_logpdf(x, mu, lmbda)
