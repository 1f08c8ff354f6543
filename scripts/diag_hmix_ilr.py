"""Diagnostic for test_hmix_ilr_backend_pallas_fit_matches_xla: is a
kernel-vs-xla ELBO trace divergence on nested linear experts a per-sweep
kernel error or chaotic amplification of a benign per-step summation-order
difference through the VI iteration?

Measures, at the XLA trajectory's state after i sweeps:
  - one-step E-step divergence: fused_estep_pallas vs fused_estep_blockwise
    (rel err of lse, counts, stats) from the SAME state;
  - the running trace divergence |v_p - v_x| / |v_x| per sweep.

Runs the kernel through the Pallas interpreter on the CPU; pass --gpu to
run the compiled kernel on a GPU.
"""
import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GPU = '--gpu' in sys.argv
if not GPU:
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
import jax
import jax.numpy as jnp
import numpy as np

jax.config.update('jax_enable_x64', True)

from mimo_tpu.models.hmix import BayesianMixtureOfMixtures
from mimo_tpu.ops.family_estep import fused_estep_blockwise
from mimo_tpu.ops.triton_estep import fused_estep_pallas

ENGINE = 'pallas' if GPU else 'interpret'

rng = np.random.default_rng(3)
n = 1024
x1 = rng.uniform(-2, 0, (n // 2, 1))
x2 = rng.uniform(0, 2, (n // 2, 1))
y = np.vstack([1.5 * x1 + 1, -2.0 * x2 + 0.5]) \
    + 0.05 * rng.standard_normal((n, 1))
x = jnp.asarray(np.vstack([x1, x2]), jnp.float32)
y = jnp.asarray(y, jnp.float32)
m = BayesianMixtureOfMixtures.make_ilr(
    cluster_size=2, mixture_size=2, input_dim=1, output_dim=1,
    kappa=0.05, dtype=jnp.float32)

v_p = np.asarray(m.fit_vi_fused((x, y), key=1, maxiter=12,
                                backend=ENGINE)[1])
v_x = np.asarray(m.fit_vi_fused((x, y), key=1, maxiter=12,
                                backend='xla')[1])
print('trace rel divergence per sweep:')
for i, (a, b) in enumerate(zip(v_p, v_x)):
    print(f'  sweep {i+1:2d}: v_x={b:12.4f}  rel={abs(a-b)/abs(b):.3e}')

spec = m._flat_spec()
data = (x, y)
block = 512

print('\none-step E-step divergence at the XLA state after i sweeps:')
for i in [1, 2, 4, 8, 12]:
    st, _ = m.fit_vi_fused(data, key=1, maxiter=i, backend='xla')
    lp_in = jax.vmap(lambda g: g.expected_log_pi())(st.inner_gating)
    lp = (st.outer_gating.expected_log_pi()[:, None] + lp_in).reshape(-1)
    ref = fused_estep_blockwise(spec, st.components, lp, data, block)
    got = fused_estep_pallas(spec, st.components, lp, data,
                             interpret=not GPU)
    errs = jax.tree.map(
        lambda a, b: float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                                  / (np.abs(np.asarray(b)) + 1e-30))),
        got.stats, ref.stats)
    lse_rel = abs(float(got.lse) - float(ref.lse)) / abs(float(ref.lse))
    cnt_rel = float(np.max(np.abs(np.asarray(got.counts)
                                  - np.asarray(ref.counts))
                           / (np.abs(np.asarray(ref.counts)) + 1e-30)))
    flat = max(jax.tree.leaves(errs))
    print(f'  after {i:2d} sweeps: lse rel={lse_rel:.3e} '
          f'counts rel={cnt_rel:.3e} stats max rel={flat:.3e}')
