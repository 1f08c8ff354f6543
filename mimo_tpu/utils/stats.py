"""Vectorized log-pdfs and on-device categorical sampling.

JAX counterpart of the reference's mimo/utils/stats.py. Layout
convention throughout mimo_tpu: per-point-per-component matrices are
(N, K) with the component axis LAST (the reference uses (K, N)): the
trailing axis is the contiguous one, and (N, K) is the natural output of
the feature-matmul E-step.
"""

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from mimo_tpu.utils.linalg import logdet_psd, quad_form

LOG2PI = 1.8378770664093453


def sample_categorical_from_log(key, log_p, axis=-1):
    """Sample categorical labels from unnormalized log-probabilities.

    On-device replacement of the reference's inverse-CDF sampler
    (utils/stats.py:8-21): one Gumbel-max draw per row, fully vectorized.
    """
    return jax.random.categorical(key, log_p, axis=axis)


def normalize_log(log_p, axis=-1):
    """(softmax(log_p), logsumexp(log_p)) — the E-step normalizer."""
    lognorm = jax.scipy.special.logsumexp(log_p, axis=axis)
    resp = jnp.exp(log_p - jnp.expand_dims(lognorm, axis))
    return resp, lognorm


def mvn_logpdf(x, mu, lmbda, logdet_lmbda=None):
    """Stacked multivariate normal log-pdf with precision matrices.

    Args:
      x: (N, d); mu: (K, d); lmbda: (K, d, d) precisions.
    Returns:
      (N, K) log-densities. Reference: utils/stats.py:53-66 (transposed).
    """
    d = x.shape[-1]
    if logdet_lmbda is None:
        logdet_lmbda = logdet_psd(lmbda)
    quad = quad_form(x, lmbda, mu)
    return 0.5 * (logdet_lmbda - d * LOG2PI) - 0.5 * quad


def gammaln_diff(a, h):
    """lgamma(a + h) - lgamma(a), stable for large a.

    The naive difference of two lgamma values is catastrophic in f32 once
    a is large: at a ~ 2.5e6 (a Gibbs/VI posterior's nu/2 after absorbing
    N=1e7 points) lgamma(a) ~ 3.4e7 whose f32 ulp is 4.0 — a +-4 NAT error
    on a Student-t normalizer whose true value is ~15. For a >= 100 use
    the Stirling-series difference rearranged so no large terms cancel:
      lgamma(a+h) - lgamma(a)
        = (a - 0.5) log1p(h/a) + h log(a+h) - h - h / (12 a (a+h))
    (truncation error O(1/a^3) ~ 1e-9 at the switch point, already far
    below the f32 cancellation of the direct form there)."""
    direct = gammaln(a + h) - gammaln(a)
    a_safe = jnp.maximum(a, 100.0)      # keep the unused branch finite
    stable = ((a_safe - 0.5) * jnp.log1p(h / a_safe)
              + h * jnp.log(a_safe + h) - h
              - h / (12.0 * a_safe * (a_safe + h)))
    return jnp.where(a < 100.0, direct, stable)


def mvt_logpdf(x, mu, lmbda, df):
    """Stacked multivariate Student-t log-pdf with precision-form scale.

    `lmbda` is the inverse scale matrix (Sigma^{-1}), `df` the degrees of
    freedom; shapes as in `mvn_logpdf`, df: (K,). Returns (N, K).

    Note: this implements the CORRECT density; the reference
    (utils/stats.py:69-79) drops the -(df+d)/2 multiplier on the
    log1p(delta/df) term, which is a bug we deliberately do not reproduce.
    """
    d = x.shape[-1]
    delta = quad_form(x, lmbda, mu)                          # (N, K)
    halfdfd = 0.5 * (df + d)
    aux = (gammaln_diff(0.5 * df, 0.5 * d)
           + 0.5 * logdet_psd(lmbda)
           - 0.5 * d * (jnp.log(df) + jnp.log(jnp.asarray(jnp.pi, x.dtype))))
    return aux - halfdfd * jnp.log1p(delta / df)


def diag_mvn_logpdf(x, mu, lmbda_diag):
    """Stacked diagonal-precision normal log-pdf. x:(N,d) mu,lmbda:(K,d)."""
    d = x.shape[-1]
    quad = (jnp.square(x) @ lmbda_diag.T
            - 2.0 * (x @ (lmbda_diag * mu).T)
            + jnp.sum(lmbda_diag * jnp.square(mu), axis=-1))
    logdet = jnp.sum(jnp.log(lmbda_diag), axis=-1)
    return 0.5 * (logdet - d * LOG2PI) - 0.5 * quad


def entropy_categorical(resp, axis=-1):
    """-sum resp*log(resp), NaN-safe (reference gmm.py:352-354 uses seterr)."""
    plogp = jnp.where(resp > 0, resp * jnp.log(jnp.where(resp > 0, resp, 1.0)), 0.0)
    return -jnp.sum(plogp, axis=axis)
