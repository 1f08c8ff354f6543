"""Batched PSD linear algebra helpers.

JAX counterparts of the reference's scalar SciPy/LAPACK helpers
(/root/reference/mimo/utils/matrix.py). Everything here broadcasts over
arbitrary leading batch axes (typically the K component axis) and is safe
under `jit`/`vmap`/`pjit`.
"""

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln

# At Precision.DEFAULT the GPU may run float32 matmuls in TF32;
# sufficient-statistic accumulation and the conjugate-update cancellations
# need full float32. Everything numerically critical in the package routes
# through these.
PRECISION = jax.lax.Precision.HIGHEST


def mm(a, b):
    """matmul at full float32 precision (no TF32)."""
    return jnp.matmul(a, b, precision=PRECISION)


def einsum(subscripts, *operands):
    """einsum at full float32 precision."""
    return jnp.einsum(subscripts, *operands, precision=PRECISION)


def symmetrize(a):
    """0.5 * (A + A^T) over the trailing two axes (matrix.py:53-54)."""
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


# Closed-form small-d paths. XLA's cholesky / triangular_solve are custom
# kernels whose per-call latency (~tens of us) dwarfs the work for the
# K x d x d batches that dominate this package (d is 1-3 in every reference
# workload). Unrolled elementwise formulas fuse into the surrounding
# computation instead — measured ~5x on the K=50, d=2 posterior-expectation
# chain. `d` is static under jit, so plain Python dispatch is trace-safe.
_SMALL_D = 3


def _chol_small(a):
    """Unrolled Cholesky-Crout for trailing dims d <= 3; batched."""
    d = a.shape[-1]
    e = lambda i, j: a[..., i, j]
    if d == 1:
        return jnp.sqrt(a)
    if d == 2:
        l11 = jnp.sqrt(e(0, 0))
        l21 = e(1, 0) / l11
        l22 = jnp.sqrt(e(1, 1) - l21 * l21)
        z = jnp.zeros_like(l11)
        return jnp.stack([jnp.stack([l11, z], -1),
                          jnp.stack([l21, l22], -1)], -2)
    l11 = jnp.sqrt(e(0, 0))
    l21 = e(1, 0) / l11
    l31 = e(2, 0) / l11
    l22 = jnp.sqrt(e(1, 1) - l21 * l21)
    l32 = (e(2, 1) - l31 * l21) / l22
    l33 = jnp.sqrt(e(2, 2) - l31 * l31 - l32 * l32)
    z = jnp.zeros_like(l11)
    return jnp.stack([jnp.stack([l11, z, z], -1),
                      jnp.stack([l21, l22, z], -1),
                      jnp.stack([l31, l32, l33], -1)], -2)


def _inv_small(a):
    """Adjugate inverse for trailing dims d <= 3; batched, PSD input."""
    d = a.shape[-1]
    e = lambda i, j: a[..., i, j]
    if d == 1:
        return 1.0 / a
    if d == 2:
        det = e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)
        return jnp.stack(
            [jnp.stack([e(1, 1), -e(0, 1)], -1),
             jnp.stack([-e(1, 0), e(0, 0)], -1)], -2) / det[..., None, None]
    c00 = e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1)
    c01 = e(0, 2) * e(2, 1) - e(0, 1) * e(2, 2)
    c02 = e(0, 1) * e(1, 2) - e(0, 2) * e(1, 1)
    c10 = e(1, 2) * e(2, 0) - e(1, 0) * e(2, 2)
    c11 = e(0, 0) * e(2, 2) - e(0, 2) * e(2, 0)
    c12 = e(0, 2) * e(1, 0) - e(0, 0) * e(1, 2)
    c20 = e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0)
    c21 = e(0, 1) * e(2, 0) - e(0, 0) * e(2, 1)
    c22 = e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)
    det = e(0, 0) * c00 + e(0, 1) * c10 + e(0, 2) * c20
    adj = jnp.stack([jnp.stack([c00, c01, c02], -1),
                     jnp.stack([c10, c11, c12], -1),
                     jnp.stack([c20, c21, c22], -1)], -2)
    return adj / det[..., None, None]


def cholesky(a, jitter=0.0):
    """Batched Cholesky of a PSD matrix, with optional diagonal jitter."""
    if jitter:
        a = a + jitter * jnp.eye(a.shape[-1], dtype=a.dtype)
    a = symmetrize(a)
    if a.shape[-1] <= _SMALL_D:
        return _chol_small(a)
    return jnp.linalg.cholesky(a)


def chol_logdet(chol):
    """log|A| from chol(A): 2 * sum(log(diag))."""
    diag = jnp.diagonal(chol, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(diag), axis=-1)


def logdet_psd(a):
    """log-determinant of a PSD matrix via Cholesky (batched)."""
    return chol_logdet(cholesky(a))


def inv_psd(a):
    """Inverse of a PSD matrix (batched).

    Counterpart of matrix.py:39 (`invpd`), but batched and jit-safe.
    Small d uses the fused adjugate form; larger d Cholesky + cho_solve.
    """
    if a.shape[-1] <= _SMALL_D:
        return _inv_small(symmetrize(a))
    chol = cholesky(a)
    eye = jnp.broadcast_to(jnp.eye(a.shape[-1], dtype=a.dtype), a.shape)
    return jax.scipy.linalg.cho_solve((chol, True), eye)


def solve_psd(a, b):
    """Solve A x = b for PSD A (batched over leading axes)."""
    if a.shape[-1] <= _SMALL_D:
        return jnp.matmul(_inv_small(symmetrize(a)), b,
                          precision=PRECISION)
    chol = cholesky(a)
    return jax.scipy.linalg.cho_solve((chol, True), b)


def mvdigamma(a, d):
    """Multivariate digamma: sum_{i=0..d-1} digamma(a - i/2).

    Used for E[logdet Lambda] of a Wishart: the reference computes
    `sum(digamma((nu - arange(d)) / 2))` (composite.py:115); this equals
    mvdigamma(nu/2, d).
    """
    i = jnp.arange(d, dtype=a.dtype)
    return jnp.sum(digamma((a[..., None] - 0.5 * i)), axis=-1)


def mvgammaln(a, d):
    """Multivariate log-gamma, log Gamma_d(a) (scipy.special.multigammaln)."""
    i = jnp.arange(d, dtype=a.dtype)
    const = 0.25 * d * (d - 1) * jnp.log(jnp.asarray(jnp.pi, dtype=a.dtype))
    return const + jnp.sum(gammaln(a[..., None] - 0.5 * i), axis=-1)


def quad_form(x, a, m=None):
    """Batched quadratic form (x - m)^T A (x - m) -> (N, K).

    Args:
      x: (N, d) data.
      a: (K, d, d) PSD matrices.
      m: optional (K, d) centers.

    Computed GEMM-first: the (N, d^2) "squared feature" matrix
    xx is built ONCE (independent of K) and contracted against the flattened
    matrices with a single matmul, instead of materializing an (N, K, d)
    intermediate. This is the JAX replacement of the reference's
    `fold=False` N x d x d statistics path (gaussian.py:474-485) and the
    einsum hot loop 'kd,kdl,nl->kn' (gaussian.py:510-523).
    """
    n, d = x.shape
    k = a.shape[0]
    xx = (x[:, :, None] * x[:, None, :]).reshape(n, d * d)   # (N, d^2)
    af = a.reshape(k, d * d)                                 # (K, d^2)
    quad = mm(xx, af.T)                                      # x^T A x
    if m is not None:
        am = einsum('kde,ke->kd', a, m)                      # (K, d)
        mam = einsum('kd,kd->k', m, am)                      # (K,)
        quad = quad - 2.0 * mm(x, am.T) + mam
    return quad
