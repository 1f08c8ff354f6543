"""Matrix-Normal-Wishart conjugate family for linear-Gaussian experts.

Model (per expert k): Lambda_k ~ W(psi_k, nu_k)  (p x p noise precision),
A_k | Lambda_k ~ MN(M_k, Lambda_k^{-1} (rows), K_k^{-1} (cols))  (p x q);
likelihood  y ~ N(A_k xt, Lambda_k^{-1})  with xt = [x; 1] if affine.

JAX re-design of LinearGaussianWithPrecision / MatrixNormal /
MatrixNormalWishart (lingauss.py:13-369, matrix.py:10-177,
composite.py:550-783). Natural params match composite.py:577-599:
  nat = [M K, K, psi^{-1} + M K M^T, nu - p - 1 + q]
paired with linear-Gaussian stats t(x, y) = [y xt^T, xt xt^T, y y^T, 1].

The affine handling follows lingauss.py:107-108: an all-ones column is
appended to x, so q = input_dim + 1.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mimo_tpu.utils.linalg import (
    cholesky, chol_logdet, inv_psd, symmetrize, quad_form, solve_psd,
)
from mimo_tpu.utils.stats import LOG2PI
from mimo_tpu.distributions.wishart import (
    wishart_sample, wishart_expected_logdet, wishart_log_partition,
)


class MNW(NamedTuple):
    M: jax.Array    # (K, p, q) regression-matrix mean
    K_: jax.Array   # (K, q, q) column (input) precision
    psi: jax.Array  # (K, p, p) Wishart scale, E[Lambda] = nu * psi
    nu: jax.Array   # (K,)

    @property
    def row_dim(self):  # p = output dim
        return self.M.shape[-2]

    @property
    def col_dim(self):  # q = (augmented) input dim
        return self.M.shape[-1]

    @staticmethod
    def standard(size, row_dim, col_dim, K_scale=1e-2, psi_scale=1.0, nu=None,
                 dtype=jnp.float32):
        nu = float(row_dim + 2) if nu is None else nu
        return MNW(
            M=jnp.zeros((size, row_dim, col_dim), dtype),
            K_=jnp.broadcast_to(K_scale * jnp.eye(col_dim, dtype=dtype),
                                (size, col_dim, col_dim)),
            psi=jnp.broadcast_to(psi_scale * jnp.eye(row_dim, dtype=dtype),
                                 (size, row_dim, row_dim)),
            nu=jnp.full((size,), nu, dtype),
        )


class LinGaussStats(NamedTuple):
    """Weighted linear-Gaussian statistics aligned with MNW nat params."""
    yxT: jax.Array  # (K, p, q)
    xxT: jax.Array  # (K, q, q)
    yyT: jax.Array  # (K, p, p)
    n: jax.Array    # (K,)


class LinGaussParams(NamedTuple):
    A: jax.Array      # (K, p, q)
    lmbda: jax.Array  # (K, p, p)


def augment(x, affine: bool):
    """Append the all-ones column when affine (lingauss.py:107-108)."""
    if affine:
        ones = jnp.ones(x.shape[:-1] + (1,), x.dtype)
        return jnp.concatenate([x, ones], axis=-1)
    return x


def suff_stats(x, y, resp):
    """x: (N, q) (already augmented), y: (N, p), resp: (N, K).

    Replaces lingauss.py:306-325's einsums with matmuls over shared
    (N, p*q)/(N, q*q)/(N, p*p) outer-product features.
    """
    n, q = x.shape
    p = y.shape[-1]
    yx = (y[:, :, None] * x[:, None, :]).reshape(n, p * q)
    xx = (x[:, :, None] * x[:, None, :]).reshape(n, q * q)
    yy = (y[:, :, None] * y[:, None, :]).reshape(n, p * p)
    syx = (resp.T @ yx).reshape(-1, p, q)
    sxx = (resp.T @ xx).reshape(-1, q, q)
    syy = (resp.T @ yy).reshape(-1, p, p)
    counts = jnp.sum(resp, axis=0)
    return LinGaussStats(yxT=syx, xxT=symmetrize(sxx), yyT=symmetrize(syy),
                         n=counts)


def nat_from_std(p: MNW) -> LinGaussStats:
    mk = p.M @ p.K_
    return LinGaussStats(
        yxT=mk,
        xxT=p.K_,
        yyT=inv_psd(p.psi) + mk @ jnp.swapaxes(p.M, -1, -2),
        n=p.nu - p.row_dim - 1.0 + p.col_dim,
    )


def std_from_nat(nat: LinGaussStats) -> MNW:
    p_dim = nat.yxT.shape[-2]
    q_dim = nat.yxT.shape[-1]
    # M = yxT K^{-1} (solve on the right via transpose)
    m = jnp.swapaxes(solve_psd(nat.xxT, jnp.swapaxes(nat.yxT, -1, -2)), -1, -2)
    psi = inv_psd(nat.yyT - m @ nat.xxT @ jnp.swapaxes(m, -1, -2))
    return MNW(M=m, K_=nat.xxT, psi=psi, nu=nat.n + p_dim + 1.0 - q_dim)


def posterior_update(prior: MNW, stats: LinGaussStats) -> MNW:
    """Conjugate update (composite.py:594-599 algebra, std space):
      K' = K + Sxx;  M' = (M K + Syx) K'^{-1};  nu' = nu + n;
      psi'^{-1} = psi^{-1} + Syy + M K M^T - M' K' M'^T."""
    k_n = prior.K_ + stats.xxT
    mk = prior.M @ prior.K_ + stats.yxT
    m_n = jnp.swapaxes(solve_psd(k_n, jnp.swapaxes(mk, -1, -2)), -1, -2)
    nu_n = prior.nu + stats.n
    psi_inv_n = (inv_psd(prior.psi) + stats.yyT
                 + prior.M @ prior.K_ @ jnp.swapaxes(prior.M, -1, -2)
                 - m_n @ k_n @ jnp.swapaxes(m_n, -1, -2))
    return MNW(M=m_n, K_=k_n, psi=inv_psd(symmetrize(psi_inv_n)), nu=nu_n)


def svi_blend(post: MNW, prior: MNW, stats: LinGaussStats, scale, step) -> MNW:
    """nat' = (1-step)*nat(post) + step*(nat(prior) + stats/scale)."""
    n_post, n_prior = nat_from_std(post), nat_from_std(prior)
    mixed = jax.tree.map(
        lambda a, b, s: (1.0 - step) * a + step * (b + s / scale),
        n_post, n_prior, stats)
    return std_from_nat(mixed)


def expected_stats(p: MNW):
    """E_q of [Lambda A, -1/2 A^T Lambda A, -1/2 Lambda, 1/2 logdet Lambda]
    (composite.py:635-647)."""
    pd = p.row_dim
    psi_chol = cholesky(p.psi)
    e_la = p.nu[..., None, None] * (p.psi @ p.M)             # (K, p, q)
    e_ala = -0.5 * (pd * inv_psd(p.K_)
                    + jnp.swapaxes(p.M, -1, -2) @ e_la)
    e_l = -0.5 * p.nu[..., None, None] * p.psi
    e_logdet = 0.5 * wishart_expected_logdet(psi_chol, p.nu)
    return e_la, e_ala, e_l, e_logdet


def expected_log_likelihood(p: MNW, x, y):
    """E_q[log N(y | A_k xt, Lambda_k^{-1})] -> (N, K).

    Fused form of bayesian.py:933-947 (no N x d x l stats tensor): three
    feature matmuls over (N, p*q), (N, q*q), (N, p*p).
    """
    pd = p.row_dim
    e_la, e_ala, e_l, e_logdet = expected_stats(p)
    n = x.shape[0]
    q = x.shape[-1]
    k = p.M.shape[0]
    yx = (y[:, :, None] * x[:, None, :]).reshape(n, pd * q)
    t1 = yx @ e_la.reshape(k, pd * q).T                      # <E[LA], y x^T>
    t2 = quad_form(x, e_ala, None)                           # x^T E[-1/2 A^T L A] x
    t3 = quad_form(y, e_l, None)                             # y^T E[-1/2 L] y
    return t1 + t2 + t3 + e_logdet - 0.5 * pd * LOG2PI


def log_partition(p: MNW):
    """logZ = -p/2 logdet K + logZ_Wishart(psi, nu) (composite.py:622-625)."""
    pd = p.row_dim
    psi_chol = cholesky(p.psi)
    k_chol = cholesky(p.K_)
    logdet_k = chol_logdet(k_chol)
    return -0.5 * pd * logdet_k + wishart_log_partition(psi_chol, p.nu)


def kl_divergence(q: MNW, p: MNW):
    """KL(q||p) per expert (K,)."""
    e_la, e_ala, e_l, e_logdet = expected_stats(q)
    nq, np_ = nat_from_std(q), nat_from_std(p)
    inner = (jnp.einsum('kpq,kpq->k', nq.yxT - np_.yxT, e_la)
             + jnp.einsum('kqr,kqr->k', nq.xxT - np_.xxT, e_ala)
             + jnp.einsum('kpr,kpr->k', nq.yyT - np_.yyT, e_l)
             + (nq.n - np_.n) * e_logdet)
    return log_partition(p) - log_partition(q) + inner


def sample_params(key, p: MNW) -> LinGaussParams:
    """Draw (A, Lambda) ~ MNW(p) (composite.py:609-613):
    A = M + chol(Lambda)^{-T} Z chol(K)^{-1}."""
    k_w, k_n = jax.random.split(key)
    lmbda = wishart_sample(k_w, p.psi, p.nu)
    l_chol = cholesky(lmbda)
    k_chol = cholesky(p.K_)
    z = jax.random.normal(k_n, p.M.shape, dtype=p.M.dtype)
    # left: solve L^T u = z  (rows ~ Lambda^{-1})
    u = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(l_chol, -1, -2), z, lower=False)
    # right: A-M = u @ K_chol^{-T}': column covariance must be
    # K^{-1} = Lk^{-T} Lk^{-1}, so w^T = Lk^{-T} u^T (solve against the
    # TRANSPOSED Cholesky; solving against Lk itself would give
    # (Lk^T Lk)^{-1} — wrong for any non-diagonal K)
    w = jnp.swapaxes(jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(k_chol, -1, -2), jnp.swapaxes(u, -1, -2),
        lower=False), -1, -2)
    return LinGaussParams(A=p.M + w, lmbda=lmbda)


def mode_params(p: MNW) -> LinGaussParams:
    """Reference convention: Lambda = (nu - p) psi (composite.py:604-607)."""
    return LinGaussParams(A=p.M,
                          lmbda=(p.nu - p.row_dim)[..., None, None] * p.psi)


def mean_params(p: MNW) -> LinGaussParams:
    return LinGaussParams(A=p.M, lmbda=p.nu[..., None, None] * p.psi)


def ml_params(stats: LinGaussStats, jitter=1e-6) -> LinGaussParams:
    """Weighted maximum likelihood (lingauss.py:176-184): A solves
    A Sxx = Syx; Sigma = (Syy - A Syx^T)/n (+ jitter I). Collapsed
    components (count < 1e-2) get A=0, Sigma=I instead of NaNs."""
    n = jnp.maximum(stats.n, 1e-8)
    q = stats.xxT.shape[-1]
    p_dim = stats.yyT.shape[-1]
    dead = (stats.n < q + 1.0)[..., None, None]
    xxr = jnp.where(dead, jnp.eye(q, dtype=stats.xxT.dtype),
                    stats.xxT + jitter * jnp.eye(q, dtype=stats.xxT.dtype))
    a = jnp.swapaxes(solve_psd(xxr, jnp.swapaxes(stats.yxT, -1, -2)), -1, -2)
    a = jnp.where(dead, 0.0, a)
    sigma = symmetrize(stats.yyT - a @ jnp.swapaxes(stats.yxT, -1, -2)) \
        / n[..., None, None] \
        + jitter * jnp.eye(p_dim, dtype=stats.yyT.dtype)
    sigma = jnp.where(dead, jnp.eye(p_dim, dtype=sigma.dtype), sigma)
    return LinGaussParams(A=a, lmbda=inv_psd(sigma))


def log_likelihood(params: LinGaussParams, x, y):
    """log N(y | A_k x, Lambda_k^{-1}) -> (N, K) (lingauss.py:330-352).

    Expanded so the (N, K) matrix comes from matmuls, no (N, K, p) residual:
      -1/2 [ y'Ly - 2 y'LAx + x'A'LAx ] + 1/2 logdet L - p/2 log2pi.
    """
    pd = y.shape[-1]
    la = params.lmbda @ params.A                             # (K, p, q)
    ala = jnp.swapaxes(params.A, -1, -2) @ la                # (K, q, q)
    n = x.shape[0]
    q = x.shape[-1]
    k = params.A.shape[0]
    yx = (y[:, :, None] * x[:, None, :]).reshape(n, pd * q)
    cross = yx @ la.reshape(k, pd * q).T
    quad_y = quad_form(y, params.lmbda, None)
    quad_x = quad_form(x, ala, None)
    logdet = chol_logdet(cholesky(params.lmbda))
    return (-0.5 * (quad_y - 2.0 * cross + quad_x)
            + 0.5 * (logdet - pd * LOG2PI))


def predictive_studentt_params(p: MNW, x):
    """Posterior-predictive t of y | x (bayesian.py:968-981):
      df = nu - p + 1;  mean = M xt;
      precision = (df / c_n) psi  with  c_n = 1 + xt^T K^{-1} xt.
    Returns mus (N, K, p), lmbdas (K, p, p) base, c (N, K), df (K,)."""
    pd = p.row_dim
    df = p.nu - pd + 1.0
    mus = jnp.einsum('kpq,nq->nkp', p.M, x)
    c = 1.0 + quad_form(x, inv_psd(p.K_), None)              # (N, K)
    return mus, c, df


def log_predictive_studentt(p: MNW, x, y):
    """(N, K) Student-t predictive log-densities (correct formula)."""
    pd = p.row_dim
    mus, c, df = predictive_studentt_params(p, x)
    yc = y[:, None, :] - mus                                  # (N, K, p)
    base_quad = jnp.einsum('nkp,kpr,nkr->nk', yc, p.psi, yc)
    delta = (df / c) * base_quad
    from mimo_tpu.utils.stats import gammaln_diff
    logdet_psi = chol_logdet(cholesky(p.psi))
    logdet_lmbda = pd * jnp.log(df / c) + logdet_psi          # (N, K)
    halfdfd = 0.5 * (df + pd)
    aux = (gammaln_diff(0.5 * df, 0.5 * pd)
           + 0.5 * logdet_lmbda
           - 0.5 * pd * (jnp.log(df) + jnp.log(jnp.pi).astype(x.dtype)))
    return aux - halfdfd * jnp.log1p(delta / df)


def log_predictive_gaussian(p: MNW, x, y):
    """Gaussian approximation: N(y | M xt, ((df/c) psi)^{-1})."""
    pd = p.row_dim
    mus, c, df = predictive_studentt_params(p, x)
    yc = y[:, None, :] - mus
    base_quad = jnp.einsum('nkp,kpr,nkr->nk', yc, p.psi, yc)
    quad = (df / c) * base_quad
    logdet_psi = chol_logdet(cholesky(p.psi))
    logdet = pd * jnp.log(df / c) + logdet_psi
    return 0.5 * (logdet - pd * LOG2PI) - 0.5 * quad


def predictive_moments_studentt(p: MNW, x):
    """Per-expert predictive mean (N, K, p) and covariance (N, K, p, p)
    (reference ilr.py:349-357): cov = inv(lmbda) * df/(df-2)."""
    pd = p.row_dim
    mus, c, df = predictive_studentt_params(p, x)
    psi_inv = inv_psd(p.psi)
    cov = (c / df * (df / (df - 2.0)))[..., None, None] * psi_inv[None]
    return mus, cov


def predictive_moments_gaussian(p: MNW, x):
    pd = p.row_dim
    mus, c, df = predictive_studentt_params(p, x)
    psi_inv = inv_psd(p.psi)
    cov = (c / df)[..., None, None] * psi_inv[None]
    return mus, cov
