"""/verify drive: flagship flows end-to-end (see .claude/skills/verify)."""
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
from mimo_tpu.utils.cache import use_compile_cache

use_compile_cache()
import numpy as np
import jax.numpy as jnp
from mimo_tpu.models import BayesianGMM, BayesianILR
from mimo_tpu.models.mixture import MFState
from mimo_tpu.distributions.niw import GaussParams

x, _ = BayesianGMM.generate(
    jax.random.PRNGKey(0),
    GaussParams(jnp.array([[-3., 0.], [3., 0.], [0., 4.]]),
                jnp.broadcast_to(jnp.eye(2) * 2., (3, 2, 2))),
    jnp.array([.3, .4, .3]), 100_000)
m = BayesianGMM.make(size=16, dim=2, gating='dp', kappa=0.05,
                     psi_scale=0.5)
st, vlb = m.fit_vi(x, key=1, maxiter=100)
assert bool(jnp.isfinite(vlb[-1])) and float(vlb[-1]) > float(vlb[0])
print('GMM VI ELBO rise:', float(vlb[0]), '->', float(vlb[-1]), flush=True)
gs = m.fit_gibbs(x, key=2, maxiter=100)
assert bool(jnp.all(jnp.isfinite(gs.log_pi)))
print('GMM Gibbs OK', flush=True)

rng = np.random.default_rng(0)
xs = jnp.asarray(rng.uniform(-6, 6, (2000, 1)), jnp.float32)
ys = jnp.asarray(np.sin(np.asarray(xs))
                 + 0.1 * rng.standard_normal((2000, 1)), jnp.float32)
ilr = BayesianILR.make(size=25, input_dim=1, output_dim=1, alpha=2.0,
                       kappa=0.05)
ilr.init_transform(xs, ys)
g = ilr.fit_gibbs((xs, ys), key=0, maxiter=25)
st, v = ilr.fit_vi((xs, ys), key=1, maxiter=200,
                   init_state=MFState(g.components, g.gating),
                   randomize=False)
mu, var, std, nlpd = ilr.predict(st, xs, ys)
rmse = float(jnp.sqrt(jnp.mean((mu - ys) ** 2)))
print('ILR RMSE', round(rmse, 4), 'NLPD', round(float(jnp.mean(nlpd)), 4),
      flush=True)
assert rmse < 0.2 and float(jnp.mean(nlpd)) < 0
print('VERIFY OK', flush=True)
