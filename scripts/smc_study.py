"""SMC value study: when does smc_gibbs beat independent restarts?

`fit_chains` gives 16 independent Gibbs chains in one vmapped program;
`smc_gibbs` adds systematic resampling of
chain states by data log-likelihood. Resampling costs nothing extra but
kills diversity — so it only pays when independent chains get STUCK in
bad modes they cannot leave. This study measures exactly that, on a
toy built to have sticky bad modes: K well-separated clusters with
unequal weights, fit with exactly K components — a chain whose init
merges two clusters and splits another stays there for hundreds of
sweeps (label moves that un-merge a cluster must go through states the
sampler assigns ~zero probability).

Protocol (equal sweep budgets): 16 chains x R rounds x S sweeps.
  independent: fit_chains(fit_gibbs, maxiter=R*S)
  smc:         smc_gibbs(n_rounds=R, sweeps_per_round=S)
Score every chain by HELD-OUT log predictive density — each chain's
GibbsState serves through the standard surface
(MFState(gs.components, gs.gating) -> log_predictive, the
predict-after-resample workflow of examples/dgmm/gibbs_dgmm.py:60).

Prints per-arm: best / mean / worst chain, and the fraction of chains
within 1 nat/point of the best (the "rescued chains" number — the
quantity resampling actually improves). Conclusion recorded in
DESIGN.md section 12, item 5.

    python scripts/smc_study.py [--seeds 5]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from mimo_tpu.utils.cache import use_compile_cache  # noqa: E402

if jax.default_backend() == 'cpu':
    jax.config.update('jax_enable_x64', True)
use_compile_cache()

import jax.numpy as jnp
import numpy as np

from mimo_tpu.models.gmm import BayesianGMM
from mimo_tpu.models.mixture import MFState
from mimo_tpu.distributions.niw import GaussParams
from mimo_tpu.parallel.chains import fit_chains, smc_gibbs


def make_data(key, n):
    """4 tight, well-separated, unequal-weight clusters: sticky bad
    modes for a K=4 fit (merging the two heavy clusters is near-
    irreversible for single-site label Gibbs)."""
    mus = jnp.asarray([[-6., -6.], [-6., 6.], [6., -6.], [6., 6.]])
    lm = jnp.broadcast_to(jnp.eye(2) / 0.4, (4, 2, 2))   # sd ~ 0.63
    w = jnp.asarray([0.4, 0.3, 0.2, 0.1])
    x, _ = BayesianGMM.generate(key, GaussParams(mus, lm), w, n)
    return x


def score_chains(model, states, x_test):
    """Held-out log predictive per chain: every chain's GibbsState feeds
    the standard serving surface (predict-after-resample)."""
    def one(components, gating):
        st = MFState(components=components, gating=gating)
        return jnp.mean(model.log_predictive(st, x_test))
    return np.asarray(jax.jit(jax.vmap(one))(states.components,
                                             states.gating))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--seeds', type=int, default=5)
    ap.add_argument('--chains', type=int, default=16)
    ap.add_argument('--rounds', type=int, default=10)
    ap.add_argument('--sweeps', type=int, default=10)
    ap.add_argument('--n', type=int, default=2000)
    args = ap.parse_args()

    rows = []
    for seed in range(args.seeds):
        key = jax.random.PRNGKey(seed)
        k_d, k_t, k_i, k_s = jax.random.split(key, 4)
        x = make_data(k_d, args.n)
        x_test = make_data(k_t, 500)
        m = BayesianGMM.make(size=4, dim=2, gating='dirichlet', alpha=1.0,
                             kappa=0.05, psi_scale=0.5,
                             dtype=x.dtype)

        total = args.rounds * args.sweeps
        ind = fit_chains(m, 'fit_gibbs', x,
                         jax.random.split(k_i, args.chains), maxiter=total)
        s_ind = score_chains(m, ind, x_test)

        smc, _ = smc_gibbs(m, x, k_s, n_chains=args.chains,
                           n_rounds=args.rounds,
                           sweeps_per_round=args.sweeps)
        s_smc = score_chains(m, smc, x_test)

        def summ(s):
            best = s.max()
            return {'best': float(best), 'mean': float(s.mean()),
                    'worst': float(s.min()),
                    'frac_good': float(np.mean(s > best - 1.0))}

        row = {'seed': seed, 'independent': summ(s_ind),
               'smc': summ(s_smc)}
        rows.append(row)
        print(f"seed {seed}: ind best {row['independent']['best']:+.3f} "
              f"mean {row['independent']['mean']:+.3f} "
              f"frac_good {row['independent']['frac_good']:.2f} | "
              f"smc best {row['smc']['best']:+.3f} "
              f"mean {row['smc']['mean']:+.3f} "
              f"frac_good {row['smc']['frac_good']:.2f}", flush=True)

    agg = {
        arm: {k: float(np.mean([r[arm][k] for r in rows]))
              for k in ('best', 'mean', 'worst', 'frac_good')}
        for arm in ('independent', 'smc')
    }
    print(json.dumps({'seeds': args.seeds, 'chains': args.chains,
                      'budget_sweeps': args.rounds * args.sweeps,
                      'aggregate': agg}))


if __name__ == '__main__':
    main()
