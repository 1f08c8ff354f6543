"""mimo_tpu: a JAX Bayesian mixture-model inference framework.

A from-scratch JAX/XLA/Pallas design of the capability surface of
`hanyas/mimo` (conjugate exponential-family inference in mixture models:
fixed-K GMMs, truncated Dirichlet-process mixtures, infinite mixtures of
linear experts, hierarchical/tied variants; EM/MAP, blocked Gibbs,
mean-field VI and stochastic VI engines).

Design stance (vs. the reference's ~67-class OO hierarchy, see
/root/reference/mimo): distributions are immutable pytree parameter structs
plus pure functions; K components are a batch axis (not Python lists);
inference sweeps are jitted `lax.scan` steps over a single state pytree;
data-axis scaling is `jax.sharding` over a device mesh where sufficient
statistics (fixed K*d^2 size) are the only cross-device reduction.
"""

import jax as _jax

# On the GPU, XLA may run float32 matmuls in TF32 (about three decimal
# digits); the conjugate-update algebra (psi^{-1} + S - kappa' m' m'^T
# cancellations) then goes non-PSD and Cholesky returns NaN. This is a
# numerical-inference framework: full float32 contraction precision is
# the correctness default, which this setting keeps out of TF32.
_jax.config.update('jax_default_matmul_precision', 'float32')

from mimo_tpu import distributions
from mimo_tpu import conjugate
from mimo_tpu import models
from mimo_tpu import ops
from mimo_tpu import parallel
from mimo_tpu import utils

__version__ = "0.1.0"
