"""Statistical pinning of the fused kernel's Gibbs label draw: from ONE
fixed (params, log_pi) state, draw S independent single label sweeps
under (a) the XLA sampler (jax.random.categorical, Gumbel-max) and (b) the
kernel's inverse-CDF draw (ops/triton_estep.py), and compare the count
vectors of both samplers against the EXACT per-state expectation

    E[counts_k] = sum_n p_nk,   Var[counts_k] = sum_n p_nk (1 - p_nk)

(the labels are independent given the state, so the per-component counts
are sums of independent Bernoullis). Reports per-component z-scores of
each sampler's mean count (|z| ~< 3.5 under H0), a two-sample Welch z
between the samplers, a chi^2/df aggregate and the variance ratio. Prints
one JSON line last.

    python scripts/gibbs_twosample.py [S]                  # on a GPU
    python scripts/gibbs_twosample.py [S] --interpret      # CPU dry run
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from mimo_tpu.distributions.niw import GaussParams
from mimo_tpu.models.gmm import BayesianGMM
from mimo_tpu.ops.family_estep import gibbs_engine
from mimo_tpu.utils.cache import use_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('sweeps', type=int, nargs='?', default=256)
    ap.add_argument('--n', type=int, default=100_000)
    ap.add_argument('--interpret', action='store_true',
                    help='run the kernel through the Pallas interpreter')
    args = ap.parse_args()
    use_compile_cache()
    s_, n, k, d = args.sweeps, args.n, 50, 2

    kg = jax.random.PRNGKey(0)
    mu = jax.random.normal(jax.random.fold_in(kg, 1), (3, d)) * 4.0
    lm = jnp.broadcast_to(jnp.eye(d) * 2.0, (3, d, d))
    x, _ = BayesianGMM.generate(kg, GaussParams(mu, lm),
                                jnp.array([.3, .4, .3]), n)
    x = x.astype(jnp.float32)
    model = BayesianGMM.make(size=k, dim=d, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5)
    # one fixed mid-chain state from a short XLA chain
    gs = model.fit_gibbs_fused(x, key=3, maxiter=20, backend='xla')
    params, log_pi = gs.params, gs.log_pi
    spec = model._estep_spec()

    logp = spec.features((x,)) @ spec.theta_plugin(params).T + log_pi[None]
    p = np.asarray(jax.nn.softmax(logp.astype(jnp.float64)
                                  if jax.config.jax_enable_x64 else logp,
                                  axis=-1), np.float64)
    e_counts = p.sum(0)
    v_counts = (p * (1 - p)).sum(0)

    def sampler(engine):
        sweep = gibbs_engine(spec, engine, n)
        return jax.jit(lambda key: sweep(key, params, log_pi, (x,))[1].counts)

    xla = sampler('xla')
    ker = sampler('interpret' if args.interpret else 'pallas')
    cx = np.stack([np.asarray(xla(jax.random.PRNGKey(1000 + i)))
                   for i in range(s_)]).astype(np.float64)
    cp = np.stack([np.asarray(ker(jax.random.PRNGKey(5000 + i)))
                   for i in range(s_)]).astype(np.float64)

    sd = np.sqrt(np.maximum(v_counts, 1e-12))
    live = e_counts > 5               # z-scores meaningless for ~empty k
    zx = (cx.mean(0) - e_counts) / (sd / np.sqrt(s_))
    zp = (cp.mean(0) - e_counts) / (sd / np.sqrt(s_))
    zw = (cp.mean(0) - cx.mean(0)) / np.sqrt(cx.var(0) / s_
                                             + cp.var(0) / s_ + 1e-12)
    out = {
        'sweeps': s_, 'n': n, 'k': k, 'live': int(live.sum()),
        'xla_max_abs_z': float(np.abs(zx[live]).max()),
        'kernel_max_abs_z': float(np.abs(zp[live]).max()),
        'welch_max_abs_z': float(np.abs(zw[live]).max()),
        'xla_chi2_per_df': float(np.mean(zx[live] ** 2)),
        'kernel_chi2_per_df': float(np.mean(zp[live] ** 2)),
        'xla_var_ratio': float((cx.var(0)[live] / v_counts[live]).mean()),
        'kernel_var_ratio': float((cp.var(0)[live] / v_counts[live]).mean()),
        'device': jax.devices()[0].device_kind,
    }
    for key_, val in out.items():
        print(f'{key_:20s} {val}')
    print(json.dumps(out))


if __name__ == '__main__':
    main()
