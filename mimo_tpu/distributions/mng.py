"""Matrix-Normal-Gamma conjugate family: linear experts with diagonal noise.

Model (per expert k, output row i): lambda_ki ~ Gamma(alpha_ki, beta_ki),
row a_ki | lambda_ki ~ N(M_ki, (lambda_ki)^{-1} K_k^{-1});
likelihood  y_i ~ N(a_ki . xt, lambda_ki^{-1}).

JAX re-design of LinearGaussianWithDiagonalPrecision /
MatrixNormalWithDiagonalPrecision / MatrixNormalGamma
(lingauss.py:747-1130, matrix.py:178-300, composite.py:811-1075). The
column precision K is shared across output rows; alphas/betas are per-row.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln

from mimo_tpu.utils.linalg import (
    cholesky, chol_logdet, inv_psd, quad_form, solve_psd,
)
from mimo_tpu.utils.stats import LOG2PI
from mimo_tpu.distributions.mnw import LinGaussStats, augment, suff_stats  # reuse


class MNG(NamedTuple):
    M: jax.Array      # (K, p, q)
    K_: jax.Array     # (K, q, q) shared column precision
    alpha: jax.Array  # (K, p)
    beta: jax.Array   # (K, p)

    @property
    def row_dim(self):
        return self.M.shape[-2]

    @property
    def col_dim(self):
        return self.M.shape[-1]

    @staticmethod
    def standard(size, row_dim, col_dim, K_scale=1e-2, alpha=2.0, beta=1.0,
                 dtype=jnp.float32):
        return MNG(
            M=jnp.zeros((size, row_dim, col_dim), dtype),
            K_=jnp.broadcast_to(K_scale * jnp.eye(col_dim, dtype=dtype),
                                (size, col_dim, col_dim)),
            alpha=jnp.full((size, row_dim), alpha, dtype),
            beta=jnp.full((size, row_dim), beta, dtype),
        )


class DiagLinGaussParams(NamedTuple):
    A: jax.Array           # (K, p, q)
    lmbda_diag: jax.Array  # (K, p)


def posterior_update(prior: MNG, stats: LinGaussStats) -> MNG:
    """K' = K + Sxx; M' = (MK + Syx)K'^{-1}; alpha' = alpha + n/2;
    beta'_i = beta_i + 1/2 [Syy + MKM^T - M'K'M'^T]_ii."""
    k_n = prior.K_ + stats.xxT
    mk = prior.M @ prior.K_ + stats.yxT
    m_n = jnp.swapaxes(solve_psd(k_n, jnp.swapaxes(mk, -1, -2)), -1, -2)
    alpha_n = prior.alpha + 0.5 * stats.n[..., None]
    resid = (stats.yyT
             + prior.M @ prior.K_ @ jnp.swapaxes(prior.M, -1, -2)
             - m_n @ k_n @ jnp.swapaxes(m_n, -1, -2))
    beta_n = prior.beta + 0.5 * jnp.diagonal(resid, axis1=-2, axis2=-1)
    return MNG(M=m_n, K_=k_n, alpha=alpha_n, beta=beta_n)


def svi_blend(post: MNG, prior: MNG, stats: LinGaussStats, scale, step) -> MNG:
    """Natural-space blend. nat = [MK (p,q), K (q,q), 2a-1 (p,), 2b + diag(MKM^T) (p,)]."""
    def nats(t: MNG):
        mk = t.M @ t.K_
        return (mk, t.K_, 2.0 * t.alpha - 1.0,
                2.0 * t.beta + jnp.diagonal(mk @ jnp.swapaxes(t.M, -1, -2),
                                            axis1=-2, axis2=-1))
    s_nat = (stats.yxT / scale, stats.xxT / scale,
             stats.n[..., None] / scale * jnp.ones_like(post.alpha),
             jnp.diagonal(stats.yyT, axis1=-2, axis2=-1) / scale)
    n_post, n_prior = nats(post), nats(prior)
    mixed = tuple((1.0 - step) * a + step * (b + s)
                  for a, b, s in zip(n_post, n_prior, s_nat))
    k_n = mixed[1]
    m_n = jnp.swapaxes(solve_psd(k_n, jnp.swapaxes(mixed[0], -1, -2)), -1, -2)
    alpha_n = 0.5 * (mixed[2] + 1.0)
    beta_n = 0.5 * (mixed[3] - jnp.diagonal(m_n @ k_n @ jnp.swapaxes(m_n, -1, -2),
                                            axis1=-2, axis2=-1))
    return MNG(M=m_n, K_=k_n, alpha=alpha_n, beta=beta_n)


def expected_log_likelihood(p: MNG, x, y):
    """E_q[log N(y | A xt, diag(lambda)^{-1})] -> (N, K)."""
    pd = p.row_dim
    e_l = p.alpha / p.beta                                   # (K, p)
    e_logl = digamma(p.alpha) - jnp.log(p.beta)              # (K, p)
    # E[lambda_i a_i a_i^T] = K^{-1} + E[lambda_i] M_i M_i^T
    k_inv = inv_psd(p.K_)                                    # (K, q, q)
    e_ala = (pd * k_inv
             + jnp.einsum('kp,kpq,kpr->kqr', e_l, p.M, p.M))  # sum over rows
    e_la = e_l[..., None] * p.M                              # (K, p, q)

    n = x.shape[0]
    q = x.shape[-1]
    k = p.M.shape[0]
    yx = (y[:, :, None] * x[:, None, :]).reshape(n, pd * q)
    t1 = yx @ e_la.reshape(k, pd * q).T
    t2 = -0.5 * quad_form(x, e_ala, None)
    t3 = -0.5 * (jnp.square(y) @ e_l.T)
    return (t1 + t2 + t3
            + 0.5 * jnp.sum(e_logl, axis=-1) - 0.5 * pd * LOG2PI)


def log_partition(p: MNG):
    """logZ = -p/2 logdet K ... per-row gamma terms
    (composite.py diag analogue)."""
    pd = p.row_dim
    k_chol = cholesky(p.K_)
    logdet_k = chol_logdet(k_chol)
    return (-0.5 * pd * logdet_k
            + jnp.sum(gammaln(p.alpha) - p.alpha * jnp.log(p.beta), axis=-1))


def kl_divergence(q: MNG, p: MNG):
    """KL(q||p) per expert."""
    e_l = q.alpha / q.beta
    e_logl = 0.5 * (digamma(q.alpha) - jnp.log(q.beta))       # pairs 2a-1
    e_la = e_l[..., None] * q.M
    pd = q.row_dim
    k_inv = inv_psd(q.K_)
    e_ala = -0.5 * (pd * k_inv + jnp.einsum('kp,kpq,kpr->kqr', e_l, q.M, q.M))
    e_l_neg = -0.5 * e_l                                      # pairs 2b + diag(MKM)

    def nats(t: MNG):
        mk = t.M @ t.K_
        return (mk, t.K_, 2.0 * t.alpha - 1.0,
                2.0 * t.beta + jnp.diagonal(mk @ jnp.swapaxes(t.M, -1, -2),
                                            axis1=-2, axis2=-1))

    nq, np_ = nats(q), nats(p)
    inner = (jnp.einsum('kpq,kpq->k', nq[0] - np_[0], e_la)
             + jnp.einsum('kqr,kqr->k', nq[1] - np_[1], e_ala)
             + jnp.sum((nq[2] - np_[2]) * e_logl, axis=-1)
             + jnp.sum((nq[3] - np_[3]) * e_l_neg, axis=-1))
    return log_partition(p) - log_partition(q) + inner


def sample_params(key, p: MNG) -> DiagLinGaussParams:
    k_g, k_n = jax.random.split(key)
    lmbda = jax.random.gamma(k_g, p.alpha, dtype=p.alpha.dtype) / p.beta  # (K, p)
    k_chol = cholesky(p.K_)
    z = jax.random.normal(k_n, p.M.shape, dtype=p.M.dtype)
    # rows: a_i = M_i + (1/sqrt(lambda_i)) z_i Lk^{-1}; row covariance must
    # be K^{-1} = Lk^{-T} Lk^{-1}, so solve against the transposed Cholesky
    w = jnp.swapaxes(jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(k_chol, -1, -2), jnp.swapaxes(z, -1, -2),
        lower=False), -1, -2)
    a = p.M + w / jnp.sqrt(lmbda)[..., None]
    return DiagLinGaussParams(A=a, lmbda_diag=lmbda)


def mode_params(p: MNG) -> DiagLinGaussParams:
    return DiagLinGaussParams(A=p.M, lmbda_diag=(p.alpha - 0.5) / p.beta)


def mean_params(p: MNG) -> DiagLinGaussParams:
    return DiagLinGaussParams(A=p.M, lmbda_diag=p.alpha / p.beta)


def ml_params(stats, jitter=1e-8) -> DiagLinGaussParams:
    """Weighted diagonal-noise maximum likelihood (lingauss.py:884-903):
    shared A solve, per-output residual variances. Collapsed components
    get A=0, unit noise. (Direct solve — the full-covariance ml_params
    would also build and invert the p x p residual covariance only to be
    discarded here.)"""
    q = stats.xxT.shape[-1]
    n = jnp.maximum(stats.n, 1e-8)[..., None]
    dead = (stats.n < q + 1.0)[..., None]
    xxr = jnp.where(dead[..., None],
                    jnp.eye(q, dtype=stats.xxT.dtype),
                    stats.xxT + jitter * jnp.eye(q, dtype=stats.xxT.dtype))
    a = jnp.swapaxes(solve_psd(xxr, jnp.swapaxes(stats.yxT, -1, -2)), -1, -2)
    a = jnp.where(dead[..., None], 0.0, a)
    resid = jnp.maximum(
        jnp.diagonal(stats.yyT - a @ jnp.swapaxes(stats.yxT, -1, -2),
                     axis1=-2, axis2=-1) / n, jitter)
    resid = jnp.where(dead, 1.0, resid)
    return DiagLinGaussParams(A=a, lmbda_diag=1.0 / resid)


def log_likelihood(params: DiagLinGaussParams, x, y):
    """log N(y | A_k x, diag(lambda_k)^{-1}) -> (N, K)."""
    pd = y.shape[-1]
    la = params.lmbda_diag[..., None] * params.A             # (K, p, q)
    ala = jnp.einsum('kpq,kpr->kqr', la, params.A)
    n = x.shape[0]
    q = x.shape[-1]
    k = params.A.shape[0]
    yx = (y[:, :, None] * x[:, None, :]).reshape(n, pd * q)
    cross = yx @ la.reshape(k, pd * q).T
    quad_y = jnp.square(y) @ params.lmbda_diag.T
    quad_x = quad_form(x, ala, None)
    logdet = jnp.sum(jnp.log(params.lmbda_diag), axis=-1)
    return (-0.5 * (quad_y - 2.0 * cross + quad_x)
            + 0.5 * (logdet - pd * LOG2PI))


def predictive_studentt_params(p: MNG, x):
    """Per-row t predictive: df_i = 2 alpha_i, mean = M xt,
    scale_i = (beta_i/alpha_i) * c_n with c_n = 1 + xt^T K^{-1} xt."""
    df = 2.0 * p.alpha                                       # (K, p)
    mus = jnp.einsum('kpq,nq->nkp', p.M, x)
    c = 1.0 + quad_form(x, inv_psd(p.K_), None)              # (N, K)
    lmbda = (p.alpha / p.beta)[None] / c[..., None]          # (N, K, p)
    return mus, lmbda, df


def log_predictive_studentt(p: MNG, x, y):
    mus, lmbda, df = predictive_studentt_params(p, x)
    yc = y[:, None, :] - mus
    delta = lmbda * jnp.square(yc)
    from mimo_tpu.utils.stats import gammaln_diff
    aux = (gammaln_diff(0.5 * df, 0.5)
           - 0.5 * (jnp.log(df) + jnp.log(jnp.pi).astype(x.dtype)))
    out = aux[None] + 0.5 * jnp.log(lmbda) \
        - 0.5 * (df[None] + 1.0) * jnp.log1p(delta / df[None])
    return jnp.sum(out, axis=-1)


def log_predictive_gaussian(p: MNG, x, y):
    mus, lmbda, _ = predictive_studentt_params(p, x)
    yc = y[:, None, :] - mus
    out = 0.5 * (jnp.log(lmbda) - LOG2PI) - 0.5 * lmbda * jnp.square(yc)
    return jnp.sum(out, axis=-1)


def predictive_moments_studentt(p: MNG, x):
    """Mean (N, K, p) and diagonal covariance (N, K, p)."""
    mus, lmbda, df = predictive_studentt_params(p, x)
    var = (1.0 / lmbda) * (df / (df - 2.0))[None]
    return mus, var


def predictive_moments_gaussian(p: MNG, x):
    mus, lmbda, _ = predictive_studentt_params(p, x)
    return mus, 1.0 / lmbda
