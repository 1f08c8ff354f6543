"""VI and Gibbs rates at N=1e7, K=50, d=2 on the XLA engine and on the
fused GPU kernel (backend='pallas'); run on a machine with a GPU."""
import sys, os, time
_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _repo)
import jax
import jax.numpy as jnp
from mimo_tpu.models.gmm import BayesianGMM
from mimo_tpu.distributions.niw import GaussParams
from mimo_tpu.utils.cache import use_compile_cache

use_compile_cache()

N, K, D, ITERS = 10_000_000, 50, 2, 100
key = jax.random.PRNGKey(0)
mu = jnp.array([[-3., 0.], [3., 0.], [0., 4.]])
lm = jnp.broadcast_to(jnp.eye(2) * 2.0, (3, 2, 2))
x, _ = BayesianGMM.generate(key, GaussParams(mu, lm), jnp.array([.3, .4, .3]), N)
model = BayesianGMM.make(size=K, dim=D, gating='dp', alpha=1.0, kappa=0.05, psi_scale=0.5)

for backend in ('xla', 'pallas'):
    st, v = model.fit_vi_fused(x, key=1, maxiter=ITERS, backend=backend)
    jax.block_until_ready(v)
    best = 0.0
    for _ in range(3):
        t0 = time.time()
        st, v = model.fit_vi_fused(x, key=1, maxiter=ITERS, backend=backend)
        jax.block_until_ready(v)
        best = max(best, ITERS/(time.time()-t0))
    print(f'VI {backend}: {best:.1f} iters/s  elbo={float(v[-1]):.6g}', flush=True)

for backend in ('xla', 'pallas'):
    gs = model.fit_gibbs_fused(x, key=2, maxiter=ITERS, backend=backend)
    jax.block_until_ready(gs.labels)
    best = 0.0
    for _ in range(3):
        t0 = time.time()
        gs = model.fit_gibbs_fused(x, key=2, maxiter=ITERS, backend=backend)
        jax.block_until_ready(gs.labels)
        best = max(best, ITERS/(time.time()-t0))
    print(f'Gibbs {backend}: {best:.1f} sweeps/s', flush=True)
