"""Hierarchically-tied Gaussian components: K means mu_k share a common
Normal-Wishart hyper-prior and a tied precision.

Model:  (tau, Lambda) ~ NW(m0, kappa0, Psi0, nu0)        [hyper prior]
        mu_k | tau, Lambda ~ N(tau, (kappa_k Lambda)^{-1})
        x | z=k ~ N(mu_k, Lambda^{-1})

JAX re-design of GaussianWithHierarchicalNormalWishart /
TiedGaussiansWithHierarchicalNormalWisharts (bayesian.py:503-793) and the
scaled-precision Gaussian prior (gaussian.py:890-1036). The inner
blocked-Gibbs chain and the inner coordinate-ascent loop become
`lax.fori_loop`s; the per-k Python loops become batched axes.

The hyper-posterior update equations reproduce the reference's
hand-derived, K-averaged forms verbatim (bayesian.py:643-656, 671-684) —
they are the observable behavior the parity tests pin down. One deliberate
difference: the reference's inner loops continue from the previous call's
hyper-posterior (hidden mutable state); here each update restarts the inner
loop from the hyper-prior, which converges to the same fixed point given
the statistics.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mimo_tpu.distributions.niw import NIW, GaussStats, GaussParams
from mimo_tpu.distributions.wishart import (
    wishart_sample, wishart_expected_logdet,
)
from mimo_tpu.distributions import niw as _niw
from mimo_tpu.utils.linalg import cholesky, chol_logdet, inv_psd, quad_form
from mimo_tpu.utils.stats import LOG2PI, mvn_logpdf, mvt_logpdf


class HierTied(NamedTuple):
    """Prior or posterior of the hierarchically-tied Gaussian family.

    As a prior: `hyper` is the NW hyper-prior (leading axis 1), `mus` is the
    hyper mean broadcast over K, `kappas == kappas0` are the per-component
    scaled-precision coefficients. As a posterior: `hyper` is the NW
    hyper-posterior, `mus` the q(mu_k) means, `kappas = kappas0 + n_k`.
    """
    hyper: NIW        # leading axis 1: (1,d), (1,), (1,d,d), (1,)
    mus: jax.Array    # (K, d)
    kappas: jax.Array   # (K,)
    kappas0: jax.Array  # (K,) constant prior coefficients

    @property
    def dim(self):
        return self.mus.shape[-1]

    @property
    def size(self):
        return self.mus.shape[0]

    @staticmethod
    def standard(size, dim, kappa=1.0, hyper_kappa=1e-2, psi_scale=1.0,
                 nu=None, dtype=jnp.float32):
        hyper = NIW.standard(1, dim, kappa=hyper_kappa, psi_scale=psi_scale,
                             nu=nu, dtype=dtype)
        return HierTied(
            hyper=hyper,
            mus=jnp.zeros((size, dim), dtype),
            kappas=jnp.full((size,), kappa, dtype),
            kappas0=jnp.full((size,), kappa, dtype),
        )


def _hyper_mstep(prior: HierTied, mus, stats: GaussStats) -> NIW:
    """The reference's hand-derived, K-averaged NW hyper-posterior update
    (bayesian.py:643-656 / 671-684), vectorized over K."""
    k = mus.shape[0]
    h = prior.hyper
    m0, kappa0 = h.mu[0], h.kappa[0]
    psi0_inv = inv_psd(h.psi)[0]
    nu0 = h.nu[0]
    kap = prior.kappas0                                     # (K,)

    rho = (jnp.sum(kap[:, None] * mus + kappa0 * m0[None, :], axis=0)
           / jnp.sum(kap + kappa0))
    kappa = jnp.sum(kap + kappa0) / k
    dm = m0[None, :] - mus                                  # (K, d)
    coef = kappa0 * kap / (kappa0 + kap)                    # (K,)
    spread = jnp.einsum('k,kd,kl->dl', coef, dm, dm) / k
    data_term = (jnp.sum(stats.xxT, axis=0)
                 - jnp.einsum('kd,kl->dl', mus, stats.x)
                 - jnp.einsum('kd,kl->dl', stats.x, mus)
                 + jnp.einsum('k,kd,kl->dl', stats.n1, mus, mus)) / k
    psi = inv_psd((psi0_inv + spread + data_term)[None])[0]
    nu = jnp.sum(nu0 + stats.n2 + 1.0) / k
    return NIW(mu=rho[None], kappa=kappa[None], psi=psi[None], nu=nu[None])


def posterior_update(prior: HierTied, stats: GaussStats,
                     nb_iter: int = 25) -> HierTied:
    """Inner mean-field coordinate ascent (bayesian.py:662-684):
    alternate q(mu_k) <- (kappa_k rho + x_k)/(kappa_k + n_k) with the
    hyper-posterior m-step until (approximately) converged."""
    kap = prior.kappas0
    kappas_n = kap + stats.n1

    def body(_, carry):
        hyper, _ = carry
        # e-step with the current hyper mean (bayesian.py:668), THEN the
        # hyper m-step — final mus are from the last e-step, matching the
        # reference's loop order exactly.
        mus = (kap[:, None] * hyper.mu + stats.x) / kappas_n[:, None]
        return _hyper_mstep(prior, mus, stats), mus

    hyper, mus = jax.lax.fori_loop(0, nb_iter, body,
                                   (prior.hyper, prior.mus))
    return HierTied(hyper=hyper, mus=mus, kappas=kappas_n, kappas0=kap)


def gibbs_update(key, prior: HierTied, stats: GaussStats,
                 nb_iter: int = 5):
    """Inner blocked Gibbs (bayesian.py:623-659): alternate sampling
    (tau_k, Lambda_k) ~ hyper-posterior (one independent draw per
    component, as the reference does, :627-630), mu_k | Lambda_k, and the
    averaged hyper-posterior update. Returns (posterior, GaussParams)."""
    kap = prior.kappas0
    kappas_n = kap + stats.n1
    k = prior.size
    d = prior.dim

    def body(carry, key_i):
        hyper, _, _ = carry
        k_hyper, k_mu = jax.random.split(key_i)
        # K independent draws from the (single) hyper posterior
        hyper_k = jax.tree.map(lambda a: jnp.broadcast_to(a, (k,) + a.shape[1:]),
                               hyper)
        hp = _niw.sample_params(k_hyper, hyper_k)           # taus (K,d), lmbdas
        m_cond = (kap[:, None] * hp.mu + stats.x) / kappas_n[:, None]
        # mu_k ~ N(m_cond, (kappa'_k Lambda_k)^{-1})
        chol = cholesky(hp.lmbda)
        z = jax.random.normal(k_mu, (k, d), dtype=m_cond.dtype)
        delta = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(chol, -1, -2), z[..., None], lower=False)[..., 0]
        mus = m_cond + delta / jnp.sqrt(kappas_n)[:, None]
        hyper_new = _hyper_mstep(prior, mus, stats)
        return (hyper_new, mus, hp.lmbda), None

    init = (prior.hyper, prior.mus, jnp.broadcast_to(
        jnp.eye(d, dtype=prior.mus.dtype), (k, d, d)))
    (hyper, mus, lmbdas), _ = jax.lax.scan(
        body, init, jax.random.split(key, nb_iter))
    post = HierTied(hyper=hyper, mus=mus, kappas=kappas_n, kappas0=kap)
    return post, GaussParams(mu=mus, lmbda=lmbdas)


def gibbs_update_exact(key, prior: HierTied, stats: GaussStats):
    """EXACT one-shot blocked draw from p(tau, Lambda, mu_{1:K} | labels,
    data) — the hierarchical model is fully conjugate, so the reference's
    inner Gibbs chain (bayesian.py:623-659, mirrored by `gibbs_update`
    above) is unnecessary for sampling: completing the square in each
    mu_k and then in tau leaves a pure Wishart in Lambda.

      c_k   = kappa_k n_k / (kappa_k + n_k)
      kap'  = kappa0 + sum_k c_k
      m'    = (kappa0 m0 + sum_k c_k xbar_k) / kap'
      psi'^{-1} = Psi0^{-1} + sum_k [S_k - n_k xbar_k xbar_k^T]
                  + kappa0 (m0 - m')(m0 - m')^T
                  + sum_k c_k (xbar_k - m')(xbar_k - m')^T      [centered]
      nu'   = nu0 + N

    Ancestral draw: Lambda ~ W(psi', nu');  tau | Lambda ~
    N(m', (kap' Lambda)^{-1});  mu_k | tau, Lambda ~
    N((kappa_k tau + s_k)/(kappa_k + n_k), ((kappa_k + n_k) Lambda)^{-1}).

    Exactness is certified by the Geweke joint-distribution test
    (scripts/geweke_gibbs.py --family hier); it is also cheaper than the
    inner chain (one Wishart draw, no fori_loop)."""
    kap = prior.kappas0
    kappas_n = kap + stats.n1
    k = prior.size
    d = prior.dim
    h = prior.hyper
    m0, kappa0 = h.mu[0], h.kappa[0]
    nu0 = h.nu[0]
    k_w, k_t, k_m = jax.random.split(key, 3)

    n_safe = jnp.maximum(stats.n1, jnp.asarray(1e-12, stats.n1.dtype))
    xbar = stats.x / n_safe[:, None]                        # (K, d)
    c = kap * stats.n1 / kappas_n                           # (K,)
    kap_h = kappa0 + jnp.sum(c)
    m_h = (kappa0 * m0 + jnp.einsum('k,kd->d', c, xbar)) / kap_h
    scatter = stats.xxT - stats.n1[:, None, None] * (
        xbar[:, :, None] * xbar[:, None, :])
    dm0 = m0 - m_h
    dmk = xbar - m_h[None, :]
    psi_inv = (inv_psd(h.psi)[0]
               + jnp.sum(scatter, axis=0)
               + kappa0 * (dm0[:, None] * dm0[None, :])
               + jnp.einsum('k,kd,ke->de', c, dmk, dmk))
    psi_h = inv_psd(psi_inv[None])                          # (1, d, d)
    nu_h = (nu0 + jnp.sum(stats.n2))[None]                  # (1,)

    lmbda = wishart_sample(k_w, psi_h, nu_h)                # (1, d, d)
    chol1 = cholesky(lmbda)
    z = jax.random.normal(k_t, (1, d), dtype=m_h.dtype)
    delta = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(chol1, -1, -2), z[..., None], lower=False)[..., 0]
    tau = m_h + delta[0] / jnp.sqrt(kap_h)

    m_cond = (kap[:, None] * tau[None, :] + stats.x) / kappas_n[:, None]
    lmbdas = jnp.broadcast_to(lmbda, (k, d, d))
    cholk = jnp.broadcast_to(chol1, (k, d, d))
    zk = jax.random.normal(k_m, (k, d), dtype=m_cond.dtype)
    dk = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(cholk, -1, -2), zk[..., None], lower=False)[..., 0]
    mus = m_cond + dk / jnp.sqrt(kappas_n)[:, None]

    post = HierTied(
        hyper=NIW(mu=m_h[None], kappa=kap_h[None], psi=psi_h, nu=nu_h),
        mus=m_cond, kappas=kappas_n, kappas0=kap)
    return post, GaussParams(mu=mus, lmbda=lmbdas)


def expected_log_likelihood(p: HierTied, x):
    """E_q[log N(x | mu_k, Lambda^{-1})] -> (N, K) (bayesian.py:731-749).

    Shared E[Lambda] = nu_bar psi_bar across K; the q(mu_k) covariance
    contributes tr(E[Lambda] Omega_k^{-1}) = d / kappa'_k."""
    d = x.shape[-1]
    h = p.hyper
    e_lmbda = (h.nu[:, None, None] * h.psi)                 # (1, d, d)
    e_lmbda_k = jnp.broadcast_to(e_lmbda, (p.size, d, d))
    quad = quad_form(x, e_lmbda_k, p.mus)                   # (N, K)
    e_logdet = wishart_expected_logdet(cholesky(h.psi), h.nu)[0]
    return (0.5 * (e_logdet - d * LOG2PI)
            - 0.5 * (quad + d / p.kappas))


def kl_divergence(q: HierTied, p: HierTied):
    """Per-component negative ELBO contribution, -(vlb_k) with vlb_k the
    k-th term of the reference's variational_lowerbound (bayesian.py:751-781)
    — including its convention of counting the hyper KL once per component."""
    d = q.dim
    h = q.hyper
    kl_hyper = _niw.kl_divergence(h, p.hyper)[0]            # scalar
    e_lmbda = (h.nu[:, None, None] * h.psi)                 # (1,d,d)
    e_logdet = wishart_expected_logdet(cholesky(h.psi), h.nu)[0]
    rho = h.mu[0]
    kappa_bar = h.kappa[0]
    dm = q.mus - rho[None, :]                               # (K,d)
    quad = jnp.einsum('kd,dl,kl->k', dm, e_lmbda[0], dm)
    logdet_e_lmbda = chol_logdet(cholesky(e_lmbda))[0]
    # entropy of q(mu_k): Omega_k = kappa'_k E[Lambda]
    ent_k = 0.5 * d * (LOG2PI + 1.0) \
        - 0.5 * (d * jnp.log(q.kappas) + logdet_e_lmbda)
    vlb_k = (-kl_hyper
             + ent_k
             - 0.5 * d * LOG2PI
             + 0.5 * d * jnp.log(q.kappas0)
             + 0.5 * e_logdet
             - 0.5 * q.kappas0 * d / kappa_bar
             - 0.5 * q.kappas0 * quad
             - 0.5 * q.kappas0 * d / q.kappas)
    return -vlb_k


def svi_blend(post: HierTied, prior: HierTied, stats: GaussStats,
              scale, step, nb_iter: int = 1) -> HierTied:
    """Stochastic inner updates (bayesian.py:691-729): blend the q(mu_k)
    nat params and the hyper-posterior nat params."""
    kap = prior.kappas0
    sx = stats.x / scale
    sn = stats.n1 / scale
    sxx = stats.xxT / scale

    def body(_, carry):
        hyper, mus, kappas = carry
        tau = hyper.mu[0]
        # q(mu_k) nat blend: nat = (kappa mu, kappa)
        nat1 = (1.0 - step) * (kappas[:, None] * mus) \
            + step * (kap[:, None] * tau[None, :] + sx)
        nat2 = (1.0 - step) * kappas + step * (kap + sn)
        mus_n = nat1 / nat2[:, None]
        scaled = GaussStats(x=sx, n1=sn, xxT=sxx, n2=sn)
        target = _hyper_mstep(prior, mus_n, scaled)
        mixed = jax.tree.map(lambda a, b: (1.0 - step) * a + step * b,
                             _niw.nat_from_std(hyper),
                             _niw.nat_from_std(target))
        hyper_n = _niw.std_from_nat(mixed)
        return hyper_n, mus_n, nat2

    hyper, mus, kappas = jax.lax.fori_loop(
        0, nb_iter, body, (post.hyper, post.mus, post.kappas))
    return HierTied(hyper=hyper, mus=mus, kappas=kappas, kappas0=kap)


def sample_params(key, p: HierTied) -> GaussParams:
    """Draw per-component (mu_k, Lambda_k): K independent hyper draws for
    Lambda, mu_k ~ q(mu_k) given that Lambda."""
    k = p.size
    d = p.dim
    k_l, k_m = jax.random.split(key)
    hyper_k = jax.tree.map(lambda a: jnp.broadcast_to(a, (k,) + a.shape[1:]),
                           p.hyper)
    lmbdas = wishart_sample(k_l, hyper_k.psi, hyper_k.nu)
    chol = cholesky(lmbdas)
    z = jax.random.normal(k_m, (k, d), dtype=p.mus.dtype)
    delta = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(chol, -1, -2), z[..., None], lower=False)[..., 0]
    mus = p.mus + delta / jnp.sqrt(p.kappas)[:, None]
    return GaussParams(mu=mus, lmbda=lmbdas)


def mode_params(p: HierTied) -> GaussParams:
    """Likelihood plug-in at the posterior mode (bayesian.py:686-689):
    mus = q-means, Lambda = hyper-mode (nu - d) psi, shared."""
    d = p.dim
    lmbda = ((p.hyper.nu - d)[:, None, None] * p.hyper.psi)
    return GaussParams(mu=p.mus,
                       lmbda=jnp.broadcast_to(lmbda, (p.size, d, d)))


def mean_params(p: HierTied) -> GaussParams:
    d = p.dim
    lmbda = (p.hyper.nu[:, None, None] * p.hyper.psi)
    return GaussParams(mu=p.mus,
                       lmbda=jnp.broadcast_to(lmbda, (p.size, d, d)))


def log_predictive_gaussian(p: HierTied, x):
    """bayesian.py:783-793: N(x | mu_k, ((nu-d+1) psi)^{-1})."""
    d = p.dim
    dfs = p.hyper.nu - d + 1.0
    lmbdas = jnp.broadcast_to(dfs[:, None, None] * p.hyper.psi,
                              (p.size, d, d))
    return mvn_logpdf(x, p.mus, lmbdas)


def log_predictive_studentt(p: HierTied, x):
    """Student-t analogue (same df/scale convention as the Gaussian one)."""
    d = p.dim
    dfs = jnp.broadcast_to(p.hyper.nu - d + 1.0, (p.size,))
    lmbdas = jnp.broadcast_to((p.hyper.nu - d + 1.0)[:, None, None] * p.hyper.psi,
                              (p.size, d, d))
    return mvt_logpdf(x, p.mus, lmbdas, dfs)
