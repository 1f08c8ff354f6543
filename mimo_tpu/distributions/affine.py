"""Tied-affine linear-Gaussian experts: K experts share one slope A and one
noise precision Lambda, but each has its own offset c_k.

Model:  Lambda ~ W(psi0, nu0);  A | Lambda ~ MN(M0, Lambda^{-1}, K0^{-1});
        c_k | Lambda ~ N(mu0_k, (kappa0_k Lambda)^{-1});
        y | x, z=k ~ N(A x + c_k, Lambda^{-1}).

JAX re-design of AffineLinearGaussianWithMatrixNormalWishart /
TiedAffineLinearGaussiansWithMatrixNormalWisharts (bayesian.py:1137-1522)
and the Affine likelihood statistics (lingauss.py:401-746). The reference's
inner Gibbs/VI loops (nb_iter) become scans; its K-averaged slope/precision
updates are reproduced verbatim (the parity tests pin them down).

Expectations / ELBO / predictives reuse the plain MNW code by repacking
into a block-diagonal stacked MNW (exactly what the reference does,
bayesian.py:1388-1522): M_k = [A | c_k], K_k = blockdiag(K_slope, kappa_k).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mimo_tpu.distributions import mnw as _mnw
from mimo_tpu.distributions.mnw import MNW, LinGaussParams
from mimo_tpu.distributions.wishart import wishart_sample
from mimo_tpu.utils.linalg import cholesky, inv_psd, symmetrize, solve_psd


class TiedAffine(NamedTuple):
    """Prior or posterior of the tied-affine expert family."""
    M: jax.Array        # (p, q) shared slope mean
    K_: jax.Array       # (q, q) shared slope column precision
    mus: jax.Array      # (K, p) offset means
    kappas: jax.Array   # (K,) offset precision coefficients
    psi: jax.Array      # (p, p) shared Wishart scale
    nu: jax.Array       # () shared Wishart dof

    @property
    def size(self):
        return self.mus.shape[0]

    @property
    def row_dim(self):
        return self.M.shape[-2]

    @property
    def col_dim(self):
        return self.M.shape[-1]

    @staticmethod
    def standard(size, row_dim, col_dim, K_scale=1e-2, kappa=1e-2,
                 psi_scale=1.0, nu=None, dtype=jnp.float32):
        nu = float(row_dim + 2) if nu is None else nu
        return TiedAffine(
            M=jnp.zeros((row_dim, col_dim), dtype),
            K_=K_scale * jnp.eye(col_dim, dtype=dtype),
            mus=jnp.zeros((size, row_dim), dtype),
            kappas=jnp.full((size,), kappa, dtype),
            psi=psi_scale * jnp.eye(row_dim, dtype=dtype),
            nu=jnp.asarray(nu, dtype),
        )


class AffineStats(NamedTuple):
    """Weighted affine linear-Gaussian statistics (lingauss.py:484-529)."""
    ym: jax.Array    # (K, p)   sum w y
    xm: jax.Array    # (K, q)   sum w x
    yxT: jax.Array   # (K, p, q)
    xxT: jax.Array   # (K, q, q)
    yyT: jax.Array   # (K, p, p)
    n: jax.Array     # (K,)


def suff_stats(x, y, resp):
    """x (N, q) RAW (no ones column — the offset is explicit), y (N, p),
    resp (N, K)."""
    n, q = x.shape
    p = y.shape[-1]
    ym = resp.T @ y
    xm = resp.T @ x
    yx = (y[:, :, None] * x[:, None, :]).reshape(n, p * q)
    xx = (x[:, :, None] * x[:, None, :]).reshape(n, q * q)
    yy = (y[:, :, None] * y[:, None, :]).reshape(n, p * p)
    return AffineStats(
        ym=ym, xm=xm,
        yxT=(resp.T @ yx).reshape(-1, p, q),
        xxT=symmetrize((resp.T @ xx).reshape(-1, q, q)),
        yyT=symmetrize((resp.T @ yy).reshape(-1, p, p)),
        n=jnp.sum(resp, axis=0))


def _slope_precision_mstep(prior: TiedAffine, stats: AffineStats, cs):
    """The reference's K-averaged slope + precision updates given current
    offsets cs (bayesian.py:1342-1359), vectorized over K."""
    k = cs.shape[0]
    m0k0 = prior.M @ prior.K_                                 # (p, q)
    cxTk = cs[:, :, None] * stats.xm[:, None, :]              # (K, p, q)
    num = m0k0[None] + stats.yxT - cxTk                       # (K, p, q)
    kk = prior.K_[None] + stats.xxT                           # (K, q, q)
    num_kinv = jnp.swapaxes(solve_psd(kk, jnp.swapaxes(num, -1, -2)), -1, -2)
    m_new = jnp.sum(num_kinv, axis=0) / k
    k_new = jnp.sum(kk, axis=0) / k

    # sum_n w (y - c_k)(y - c_k)^T = yyT - yc^T - cy^T + n cc^T
    ycT = jnp.einsum('kp,kr->kpr', stats.ym, cs)
    resid = (stats.yyT - ycT - jnp.swapaxes(ycT, -1, -2)
             + stats.n[:, None, None] * (cs[:, :, None] * cs[:, None, :]))
    dm = cs - prior.mus
    spread = jnp.einsum('k,kp,kr->kpr', prior.kappas, dm, dm)
    quad = jnp.einsum('kpq,kqr->kpr', num_kinv, jnp.swapaxes(num, -1, -2))
    psi_inv = (inv_psd(prior.psi[None])[0]
               + prior.M @ k_new @ prior.M.T
               + jnp.sum(resid, axis=0) / k
               + jnp.sum(spread, axis=0) / k
               - jnp.sum(quad, axis=0) / k)
    psi_new = inv_psd(symmetrize(psi_inv)[None])[0]
    nu_new = jnp.sum(prior.nu + stats.n + 1.0) / k
    return m_new, k_new, psi_new, nu_new


def posterior_update(prior: TiedAffine, stats: AffineStats,
                     nb_iter: int = 25) -> TiedAffine:
    """Inner mean-field coordinate ascent (bayesian.py:1321-1375)."""
    def body(_, carry):
        cs = carry.mus
        m_n, k_n, psi_n, nu_n = _slope_precision_mstep(prior, stats, cs)
        # offset e-step with the slope posterior MEAN (bayesian.py:1366-1371)
        axm = jnp.einsum('pq,kq->kp', m_n, stats.xm)
        kappas_n = prior.kappas + stats.n
        rhos = (prior.kappas[:, None] * prior.mus + stats.ym - axm) \
            / kappas_n[:, None]
        return TiedAffine(M=m_n, K_=k_n, mus=rhos, kappas=kappas_n,
                          psi=psi_n, nu=nu_n)

    return jax.lax.fori_loop(0, nb_iter, body, prior)


def gibbs_update(key, prior: TiedAffine, stats: AffineStats,
                 nb_iter: int = 25):
    """Inner blocked Gibbs (bayesian.py:1258-1319). Returns
    (posterior: TiedAffine, params: LinGaussParams in PACKED form
    [A | c_k] over the augmented input)."""
    k = prior.size
    p, q = prior.M.shape

    def body(carry, key_i):
        post, _ = carry
        k_c, k_l, k_a = jax.random.split(key_i, 3)
        # c_k ~ N(mus, (kappas * Lambda)^{-1}) with the last Lambda draw
        # (the reference uses the per-k sampled Lambda; we use a fresh draw)
        lmbdas = wishart_sample(k_l, jnp.broadcast_to(post.psi, (k, p, p)),
                                jnp.broadcast_to(post.nu, (k,)))
        chol = cholesky(lmbdas)
        z = jax.random.normal(k_c, (k, p), dtype=post.mus.dtype)
        delta = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(chol, -1, -2), z[..., None], lower=False)[..., 0]
        cs = post.mus + delta / jnp.sqrt(post.kappas)[:, None]

        m_n, k_n, psi_n, nu_n = _slope_precision_mstep(prior, stats, cs)

        # sample shared-slope draws per k: A_k ~ MN(m_n, Lambda_k^{-1}, k_n^{-1})
        k_chol = jnp.broadcast_to(cholesky(k_n[None])[0], (k, q, q))
        za = jax.random.normal(k_a, (k, p, q), dtype=m_n.dtype)
        u = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(chol, -1, -2), za, lower=False)
        # column covariance k_n^{-1} = Lk^{-T} Lk^{-1}: solve against the
        # transposed Cholesky (Lk itself would give (Lk^T Lk)^{-1})
        w = jnp.swapaxes(jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(k_chol, -1, -2), jnp.swapaxes(u, -1, -2),
            lower=False), -1, -2)
        a_s = m_n[None] + w

        axm = jnp.einsum('kpq,kq->kp', a_s, stats.xm)
        kappas_n = prior.kappas + stats.n
        rhos = (prior.kappas[:, None] * prior.mus + stats.ym - axm) \
            / kappas_n[:, None]
        post_n = TiedAffine(M=m_n, K_=k_n, mus=rhos, kappas=kappas_n,
                            psi=psi_n, nu=nu_n)
        packed_a = jnp.concatenate([a_s, cs[:, :, None]], axis=-1)
        return (post_n, LinGaussParams(A=packed_a, lmbda=lmbdas)), None

    init_params = LinGaussParams(
        A=jnp.concatenate([jnp.broadcast_to(prior.M, (k, p, q)),
                           prior.mus[:, :, None]], axis=-1),
        lmbda=jnp.broadcast_to(jnp.eye(p, dtype=prior.M.dtype), (k, p, p)))
    (post, params), _ = jax.lax.scan(body, (prior, init_params),
                                     jax.random.split(key, nb_iter))
    return post, params


def gibbs_update_exact(key, prior: TiedAffine, stats: AffineStats):
    """EXACT one-shot blocked draw from p(Lambda, A, c_{1:K} | labels,
    data) — the tied-affine model is fully conjugate, so the reference's
    inner Gibbs chain (bayesian.py:1258-1319, mirrored by `gibbs_update`
    above) is unnecessary for sampling. Completing the square in each
    offset c_k, then in the shared slope A, leaves a pure Wishart:

      s_k = 1/(kappa_k + n_k);  b_k = kappa_k mu0_k + Sy_k;  v_k = Sx_k
      K'  = K0 + sum_k (Sxx_k - s_k v_k v_k^T)
      M'  = [M0 K0 + sum_k (Syx_k - s_k b_k v_k^T)] K'^{-1}
      psi'^{-1} = Psi0^{-1} + M0 K0 M0^T - M' K' M'^T
                  + sum_k (Syy_k + kappa_k mu0_k mu0_k^T - s_k b_k b_k^T)
      nu' = nu0 + N

    Ancestral draw: Lambda ~ W(psi', nu');  A | Lambda ~
    MN(M', Lambda^{-1}, K'^{-1});  c_k | A, Lambda ~
    N(s_k (b_k - A v_k), ((kappa_k + n_k) Lambda)^{-1}).

    Certified by scripts/geweke_gibbs.py --family tied-affine. Returns
    (posterior: TiedAffine, params: LinGaussParams PACKED [A | c_k])."""
    k = prior.size
    p, q = prior.M.shape
    k_w, k_a, k_c = jax.random.split(key, 3)

    kappas_n = prior.kappas + stats.n                       # (K,)
    s = 1.0 / kappas_n                                      # (K,)
    b = prior.kappas[:, None] * prior.mus + stats.ym        # (K, p)
    v = stats.xm                                            # (K, q)

    k_n = prior.K_ + jnp.sum(
        stats.xxT - s[:, None, None] * (v[:, :, None] * v[:, None, :]),
        axis=0)                                             # (q, q)
    mk = prior.M @ prior.K_ + jnp.sum(
        stats.yxT - s[:, None, None] * (b[:, :, None] * v[:, None, :]),
        axis=0)                                             # (p, q)
    m_n = jnp.swapaxes(solve_psd(k_n[None],
                                 jnp.swapaxes(mk[None], -1, -2)),
                       -1, -2)[0]                           # (p, q)
    psi_inv = (inv_psd(prior.psi[None])[0]
               + prior.M @ prior.K_ @ prior.M.T
               - m_n @ k_n @ m_n.T
               + jnp.sum(stats.yyT
                         + prior.kappas[:, None, None]
                         * (prior.mus[:, :, None] * prior.mus[:, None, :])
                         - s[:, None, None] * (b[:, :, None] * b[:, None, :]),
                         axis=0))
    psi_n = inv_psd(symmetrize(psi_inv)[None])              # (1, p, p)
    nu_n = (prior.nu + jnp.sum(stats.n))[None]              # (1,)

    lmbda1 = wishart_sample(k_w, psi_n, nu_n)               # (1, p, p)
    chol1 = cholesky(lmbda1)
    # A | Lambda ~ MN(M', Lambda^{-1}, K'^{-1})
    za = jax.random.normal(k_a, (1, p, q), dtype=m_n.dtype)
    u = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(chol1, -1, -2), za, lower=False)
    k_chol = cholesky(k_n[None])
    w = jnp.swapaxes(jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(k_chol, -1, -2), jnp.swapaxes(u, -1, -2),
        lower=False), -1, -2)
    a_draw = m_n + w[0]                                     # (p, q)

    # c_k | A, Lambda
    c_mean = s[:, None] * (b - jnp.einsum('pq,kq->kp', a_draw, v))
    cholk = jnp.broadcast_to(chol1, (k, p, p))
    zc = jax.random.normal(k_c, (k, p), dtype=c_mean.dtype)
    dc = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(cholk, -1, -2), zc[..., None], lower=False)[..., 0]
    cs = c_mean + dc / jnp.sqrt(kappas_n)[:, None]

    post = TiedAffine(
        M=m_n, K_=k_n,
        mus=s[:, None] * (b - jnp.einsum('pq,kq->kp', m_n, v)),
        kappas=kappas_n, psi=psi_n[0], nu=nu_n[0])
    packed_a = jnp.concatenate(
        [jnp.broadcast_to(a_draw, (k, p, q)), cs[:, :, None]], axis=-1)
    lmbdas = jnp.broadcast_to(lmbda1, (k, p, p))
    return post, LinGaussParams(A=packed_a, lmbda=lmbdas)


def to_packed_mnw(p: TiedAffine) -> MNW:
    """Block-diagonal packing (bayesian.py:1388-1422): per component k,
    M_k = [M | mu_k], K_k = blockdiag(K_slope, kappa_k), shared psi/nu."""
    k = p.size
    pd, q = p.M.shape
    m = jnp.concatenate([jnp.broadcast_to(p.M, (k, pd, q)),
                         p.mus[:, :, None]], axis=-1)          # (K, p, q+1)
    k_top = jnp.concatenate([
        jnp.broadcast_to(p.K_, (k, q, q)),
        jnp.zeros((k, q, 1), p.K_.dtype)], axis=-1)
    k_bot = jnp.concatenate([
        jnp.zeros((k, 1, q), p.K_.dtype),
        p.kappas[:, None, None]], axis=-1)
    k_full = jnp.concatenate([k_top, k_bot], axis=-2)          # (K, q+1, q+1)
    return MNW(M=m, K_=k_full,
               psi=jnp.broadcast_to(p.psi, (k, pd, pd)),
               nu=jnp.broadcast_to(p.nu, (k,)))


def expected_log_likelihood(p: TiedAffine, x_aug, y):
    """ELL over the packed MNW with augmented inputs (bayesian.py:1388-1421)."""
    return _mnw.expected_log_likelihood(to_packed_mnw(p), x_aug, y)


def kl_divergence(q: TiedAffine, p: TiedAffine):
    """-(entropy - cross_entropy) of the packed MNWs (bayesian.py:1451-1483)."""
    return _mnw.kl_divergence(to_packed_mnw(q), to_packed_mnw(p))


def sample_params(key, p: TiedAffine) -> LinGaussParams:
    return _mnw.sample_params(key, to_packed_mnw(p))


def mode_params(p: TiedAffine) -> LinGaussParams:
    return _mnw.mode_params(to_packed_mnw(p))


def mean_params(p: TiedAffine) -> LinGaussParams:
    return _mnw.mean_params(to_packed_mnw(p))


def log_likelihood(params: LinGaussParams, x_aug, y):
    return _mnw.log_likelihood(params, x_aug, y)


def log_predictive_studentt(p: TiedAffine, x_aug, y):
    return _mnw.log_predictive_studentt(to_packed_mnw(p), x_aug, y)


def log_predictive_gaussian(p: TiedAffine, x_aug, y):
    return _mnw.log_predictive_gaussian(to_packed_mnw(p), x_aug, y)
