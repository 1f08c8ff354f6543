"""Gating priors: Dirichlet and truncated stick-breaking (DP) — with their
conjugate categorical updates, expectations and ELBO terms.

JAX re-design of dirichlet.py:8-214 and the gating halves of
bayesian.py:36-179. The stick-breaking construction follows Ishwaran &
James (2001) / Blei & Jordan (2006), as the reference does
(dirichlet.py:100-106): v_k ~ Beta(gamma_k, delta_k),
pi_k = v_k prod_{j<k}(1 - v_j), truncated at K with v_K = 1.

The characteristic DP update trick (bayesian.py:132-135): the delta update
uses "accumulated counts" N>_k = sum_{j>k} N_j — an exclusive reverse
cumulative sum, sequential in K but K <= ~100 so it stays inside jit.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln, betaln


def _reverse_cumsum_exclusive(counts):
    """N>_k = sum_{j>k} N_j  (bayesian.py:132: hstack(cumsum(c[::-1])[-2::-1], 0)).

    NOT computed as `total - cumsum(counts)`: that difference of two large
    sums accumulated in different orders has f32 cancellation error ~ +-2
    at counts ~ 1e7, and a negative N>_{K-1} (exactly 0 in exact math)
    drives the Beta posterior's delta below 0 => digamma(delta) = NaN in
    the stick KL (seen as intermittent non-finite ELBO entries at N=1e7).
    The flip-cumsum-flip form makes the last entry 0 by construction; the
    clamp guards the remaining one-rounding subtraction."""
    inclusive_rev = jnp.flip(jnp.cumsum(jnp.flip(counts, -1), axis=-1), -1)
    return jnp.maximum(inclusive_rev - counts, 0.0)


class Dirichlet(NamedTuple):
    alpha: jax.Array  # (K,)

    @property
    def dim(self):
        return self.alpha.shape[-1]

    @staticmethod
    def standard(size, alpha=1.0, dtype=jnp.float32):
        return Dirichlet(alpha=jnp.full((size,), alpha, dtype))

    def update(self, counts):
        """Conjugate categorical update: alpha' = alpha + counts
        (bayesian.py:62-65; Dirichlet nat = alpha - 1)."""
        return Dirichlet(alpha=self.alpha + counts)

    def svi_blend(self, posterior, counts, scale, step):
        """nat' = (1-step) nat(post) + step (nat(prior) + counts/scale)
        (bayesian.py:85-89)."""
        nat = (1.0 - step) * (posterior.alpha - 1.0) \
            + step * (self.alpha - 1.0 + counts / scale)
        return Dirichlet(alpha=nat + 1.0)

    def mean(self):
        return self.alpha / jnp.sum(self.alpha, axis=-1, keepdims=True)

    def mode(self):
        """(alpha-1)/(sum alpha - K) (dirichlet.py:43-45)."""
        return (self.alpha - 1.0) / (jnp.sum(self.alpha, axis=-1, keepdims=True)
                                     - self.dim)

    def sample(self, key):
        return jax.random.dirichlet(key, self.alpha)

    def expected_log_pi(self):
        """E[log pi_k] = digamma(alpha_k) - digamma(sum alpha)
        (dirichlet.py:85-87)."""
        return digamma(self.alpha) - digamma(jnp.sum(self.alpha, axis=-1,
                                                     keepdims=True))

    def log_partition(self):
        return (jnp.sum(gammaln(self.alpha), axis=-1)
                - gammaln(jnp.sum(self.alpha, axis=-1)))

    def kl_divergence(self, other):
        """KL(self || other) — the gating ELBO term
        -(entropy - cross_entropy) of bayesian.py:93-96."""
        e_log = self.expected_log_pi()
        inner = jnp.sum((self.alpha - other.alpha) * e_log, axis=-1)
        return other.log_partition() - self.log_partition() + inner

    def label_elbo_terms(self, resp):
        """sum_n sum_k r_nk E[log pi_k]  (gmm.py:343-344); resp (N, K)."""
        return jnp.sum(jnp.sum(resp, axis=0) * self.expected_log_pi())


class StickBreaking(NamedTuple):
    gamma: jax.Array  # (K,)
    delta: jax.Array  # (K,)

    @property
    def dim(self):
        return self.gamma.shape[-1]

    @staticmethod
    def standard(size, alpha=1.0, dtype=jnp.float32):
        """DP(alpha) truncation: gamma = 1, delta = alpha
        (reference dp.py / examples convention)."""
        return StickBreaking(gamma=jnp.ones((size,), dtype),
                             delta=jnp.full((size,), alpha, dtype))

    def update(self, counts):
        """gamma' = gamma + N_k; delta' = delta + sum_{j>k} N_j
        (bayesian.py:132-135)."""
        return StickBreaking(gamma=self.gamma + counts,
                             delta=self.delta + _reverse_cumsum_exclusive(counts))

    def svi_blend(self, posterior, counts, scale, step):
        """bayesian.py:161-171 (blend in std space — gammas/deltas are the
        shifted nat params)."""
        acc = _reverse_cumsum_exclusive(counts)
        gamma = (1.0 - step) * posterior.gamma \
            + step * (self.gamma + counts / scale)
        delta = (1.0 - step) * posterior.delta \
            + step * (self.delta + acc / scale)
        return StickBreaking(gamma=gamma, delta=delta)

    @staticmethod
    def _probs_from_sticks(betas):
        """pi_k = beta_k * prod_{j<k}(1 - beta_j); beta_K forced to 1."""
        betas = betas.at[..., -1].set(1.0)
        log_rest = jnp.log1p(-jnp.clip(betas, 0.0, 1.0 - 1e-7))
        cum = jnp.concatenate([jnp.zeros_like(betas[..., :1]),
                               jnp.cumsum(log_rest, axis=-1)[..., :-1]], axis=-1)
        return betas * jnp.exp(cum)

    def mean(self):
        """dirichlet.py:141-150."""
        betas = self.gamma / (self.gamma + self.delta)
        return self._probs_from_sticks(betas)

    def mode(self):
        """Piecewise stick modes (dirichlet.py:152-175), vectorized with
        nested where instead of the reference's per-k if/else chain."""
        g, d = self.gamma, self.delta
        betas = jnp.where((g > 1.0) & (d > 1.0), (g - 1.0) / (g + d - 2.0),
                          jnp.where((g <= 1.0) & (d > 1.0), 0.0, 1.0))
        return self._probs_from_sticks(betas)

    def sample(self, key):
        """dirichlet.py:177-186."""
        betas = jax.random.beta(key, self.gamma, self.delta)
        return self._probs_from_sticks(betas)

    def expected_log_sticks(self):
        """(E[log v_k], E[log(1 - v_k)]) (dirichlet.py:201-204)."""
        dg_sum = digamma(self.gamma + self.delta)
        return digamma(self.gamma) - dg_sum, digamma(self.delta) - dg_sum

    def expected_log_pi(self):
        """E[log pi_k] = E[log v_k] + sum_{j<k} E[log(1-v_j)]
        (gmm.py:251-252)."""
        e_stick, e_rest = self.expected_log_sticks()
        cum = jnp.concatenate([jnp.zeros_like(e_rest[..., :1]),
                               jnp.cumsum(e_rest, axis=-1)[..., :-1]], axis=-1)
        return e_stick + cum

    def log_partition(self):
        """sum_k betaln(gamma_k, delta_k) (dirichlet.py:195-196)."""
        return jnp.sum(betaln(self.gamma, self.delta), axis=-1)

    def kl_divergence(self, other):
        e_stick, e_rest = self.expected_log_sticks()
        inner = jnp.sum((self.gamma - other.gamma) * e_stick
                        + (self.delta - other.delta) * e_rest, axis=-1)
        return other.log_partition() - self.log_partition() + inner

    def label_elbo_terms(self, resp):
        """sum_n [r_nk E[log v_k] + (sum_{j>k} r_nj) E[log(1-v_k)]]
        (gmm.py:345-350); resp (N, K)."""
        counts = jnp.sum(resp, axis=0)
        acc = _reverse_cumsum_exclusive(counts)
        e_stick, e_rest = self.expected_log_sticks()
        return jnp.sum(counts * e_stick + acc * e_rest)
