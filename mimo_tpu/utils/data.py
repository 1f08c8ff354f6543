"""Data helpers: one-hot labels, minibatch sampling, standardization.

JAX counterpart of the reference's mimo/utils/data.py. The
reference's `StandardScaler` (sklearn) becomes a pure pytree transform so
it can live inside jitted prediction paths; its `batches` generator (one
random subset per epoch, data.py:9-12) becomes an on-device index draw.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp


def one_hot(labels, num_classes, dtype=jnp.float32):
    """(N,) int labels -> (N, K) one-hot. Reference: utils/data.py:160-169
    (transposed: we use (N, K) layout)."""
    return jax.nn.one_hot(labels, num_classes, dtype=dtype)


def nan_mask(*arrays):
    """Static-shape NaN handling: returns (clean_arrays, weights) where
    rows containing any NaN in ANY array get weight 0 and are zero-filled.

    The reference drops NaN rows with boolean indexing in every statistics
    and log-likelihood call (gaussian.py:191-192, lingauss.py:103-105) —
    dynamic shapes. Here the engines' `point_weights` make masked rows
    exact no-ops with static shapes; pass the returned weights in.
    """
    import jax.numpy as _jnp
    bad = None
    for a in arrays:
        b = _jnp.isnan(a).any(axis=tuple(range(1, a.ndim)))
        bad = b if bad is None else (bad | b)
    weights = _jnp.where(bad, 0.0, 1.0).astype(arrays[0].dtype)
    clean = tuple(_jnp.nan_to_num(a) for a in arrays)
    return clean if len(clean) > 1 else clean[0], weights


def sample_batch_indices(key, data_size, batch_size, replace=None):
    """One random minibatch of indices per call.

    Mirrors the semantics of the reference's `batches` (utils/data.py:9-12),
    which yields a single random `batch_size` subset per epoch — but
    without-replacement sampling in XLA costs a full `data_size`
    permutation (a sort of N random keys) PER STEP, which at N=1e7
    dominated the whole SVI step (~90 ms against a ~1 ms E-step). When
    the batch is a small fraction of the data (N > max(2^16, 32 B)) we
    sample WITH replacement instead — O(B), still an unbiased minibatch
    estimator (the textbook SVI sampling model, Hoffman et al. 2013),
    with expected duplicate fraction <= B/(2N) < 1.6%. Pass `replace`
    explicitly to force either behavior.
    """
    if replace is None:
        replace = data_size > max(1 << 16, 32 * batch_size)
    if replace:
        return jax.random.randint(key, (batch_size,), 0, data_size)
    return jax.random.choice(key, data_size, shape=(batch_size,), replace=False)


class Standardizer(NamedTuple):
    """Pure-pytree StandardScaler (mean/std over axis 0).

    Replaces sklearn.preprocessing.StandardScaler used by the reference ILR
    (ilr.py:108-127) so that scaling can run inside jit.
    """
    mean: jax.Array
    scale: jax.Array  # standard deviation

    @staticmethod
    def fit(x):
        mean = jnp.mean(x, axis=0)
        scale = jnp.std(x, axis=0)
        scale = jnp.where(scale > 0, scale, 1.0)
        return Standardizer(mean=mean, scale=scale)

    @staticmethod
    def identity(dim, dtype=jnp.float32):
        return Standardizer(mean=jnp.zeros(dim, dtype), scale=jnp.ones(dim, dtype))

    def transform(self, x):
        return (x - self.mean) / self.scale

    def inverse_transform(self, x):
        return x * self.scale + self.mean

    def scale_cov(self, cov):
        """Map covariance matrices back to the original output scale
        (reference ilr.py:413-414)."""
        return cov * (self.scale[:, None] * self.scale[None, :])
