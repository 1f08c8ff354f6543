"""Geweke joint-distribution test of the FULL Gibbs transition — every
sampled conditional in the framework.

The fixed-state two-sample test (scripts/gibbs_twosample.py) certifies
only the label-sampling conditional; this tests everything else too —
the conjugate posterior updates and the SAMPLED parameter conditionals:
the Bartlett Wishart path in wishart_sample, the Gaussian mean draw,
the stick-breaking Beta draws (reference anchors composite.py:82-86,
wishart.py:72-92), the Matrix-Normal expert draws (composite.py:666-683),
the Gamma draws of the diagonal families (composite.py:345-349), the
EXACT tied shared-scale draws (distributions/tied_gibbs.py), the exact
hierarchical hyper draw (hierarchical.gibbs_update_exact, replacing the
reference's inner chain bayesian.py:623-659), the exact tied-affine
draw (affine.gibbs_update_exact, replacing bayesian.py:1258-1319), and
the two-level nested sweep (hmix.fit_gibbs_fused's joint flat-label
move + vmapped sub-model draws).

Geweke (2004, "Getting it right"): if the Gibbs transition
T(theta' | theta, y) leaves p(theta | y) invariant for every y, then the
Markov chain

    y_t ~ p(y | theta_{t-1}),   theta_t ~ T(. | theta_{t-1}, y_t)

has stationary marginal theta_t ~ p(theta) — the PRIOR. So every
marginal statistic of (theta, y) must match between (a) iid prior draws
(params + weights from the prior, data generated from them) and (b) the
successive-conditional chain that regenerates the data each sweep and
applies the production transition. Any bias in ANY sampled conditional
shifts the stationary distribution and shows up as a large z-score.

For families whose Gibbs side is a Family.gibbs_update (tied, hier,
tied-affine, nested-hier), the prior draw is gibbs_update with ZERO
statistics — the exact conditional at no data IS the prior, so the two
sides are consistent by construction and the test exercises the very
code path production runs.

z = (mean_a - mean_b) / sqrt(se_a^2 + se_b^2), with se_b from batch
means (the chain autocorrelates). |z| > ~4 on any statistic indicates a
transition bug; healthy runs sit |z| < 3 (DESIGN.md, "Geweke
certification", keeps the measured values).

Usage:
    python scripts/geweke_gibbs.py                    # CPU f64 oracle
    python scripts/geweke_gibbs.py --backend pallas   # GPU f32 kernel
    python scripts/geweke_gibbs.py --family tied-affine --draws 40000
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = ['gmm', 'ilr', 'diag', 'tied', 'tied-diag', 'hier',
            'tied-affine', 'nested']


def _arcsinh_moments(arrs):
    """Variance-stabilized data moments (DESIGN.md, "Geweke
    certification": prior-predictive tails are Student-t-like; raw sample
    variances break the CLT z and can overflow f32; arcsinh is monotone
    and applied identically to both samplers)."""
    import jax.numpy as jnp
    return jnp.arcsinh(jnp.stack(arrs))


def _zero_stats(family, data_dims, kk, dtype):
    """family.suff_stats of a zero-weighted dummy point: the exact
    conditional at zero statistics is the prior, so gibbs_update(key,
    prior, zero_stats) IS a prior draw for gibbs_update families."""
    import jax.numpy as jnp
    dummy = tuple(jnp.zeros((1, d), dtype) for d in data_dims)
    resp0 = jnp.zeros((1, kk), dtype)
    return family.suff_stats(dummy, resp0)


def build_mixture_config(args, dtype):
    """Config for every flat-mixture family; returns dict with
    init/generate/transition/stats_of/names."""
    import jax
    import jax.numpy as jnp
    from mimo_tpu.ops.family_estep import gibbs_engine
    from mimo_tpu.utils.linalg import logdet_psd

    n, kk, d = args.n, args.k, args.dim
    fam = args.family
    # moderately tight priors so prior-drawn data is non-degenerate (a
    # diffuse NIW makes both samplers produce huge-variance data and the
    # test loses power, not validity)
    if fam in ('gmm', 'tied', 'hier'):
        from mimo_tpu.models.gmm import BayesianGMM
        model = BayesianGMM.make(
            size=kk, dim=d, gating='stick-breaking', alpha=1.5, kappa=2.0,
            psi_scale=1.0, nu=float(d + 3), tied=(fam == 'tied'),
            hierarchical=(fam == 'hier'), dtype=dtype)
        data_dims = (d,)

        def generate(key, params, pi):
            x, _ = BayesianGMM.generate(key, params, pi, n)
            return (x,)

        def stats_of(params, pi, data):
            (x,) = data
            lam = params.lmbda
            per_k = [params.mu[:, 0], pi]
            names = [f'mu{j}_x0' for j in range(kk)] \
                + [f'pi{j}' for j in range(kk)]
            if fam == 'gmm':
                per_k += [logdet_psd(lam),
                          jnp.trace(lam, axis1=-2, axis2=-1)]
                names += [f'logdetL{j}' for j in range(kk)] \
                    + [f'trL{j}' for j in range(kk)]
            else:
                # shared scale: one logdet/trace; for hier also the
                # spread of the means (sensitive to the tau/hyper draw)
                per_k += [logdet_psd(lam[:1]),
                          jnp.trace(lam[:1], axis1=-2, axis2=-1)]
                names += ['logdetL', 'trL']
                if fam == 'hier':
                    per_k += [jnp.mean(params.mu[:, 0])[None],
                              jnp.arcsinh(jnp.var(params.mu[:, 0]))[None]]
                    names += ['mean_mu', 'asinh_var_mu']
            vec = jnp.concatenate(per_k + [_arcsinh_moments([
                jnp.mean(x[:, 0]), jnp.var(x[:, 0]),
                jnp.mean(jnp.sum(x * x, -1))])])
            return vec, names
    elif fam in ('diag', 'tied-diag'):
        from mimo_tpu.models.gmm import BayesianGMM
        from mimo_tpu.distributions.niw import GaussParams
        model = BayesianGMM.make(
            size=kk, dim=d, gating='stick-breaking', alpha=1.5, kappa=2.0,
            diag=True, tied=(fam == 'tied-diag'), dtype=dtype)
        # tighter Gamma prior than the standard(alpha=2,beta=1): keeps
        # prior-predictive tails from dominating the data moments
        model.components_prior = model.components_prior._replace(
            alpha=jnp.full((kk, d), 3.0, dtype),
            beta=jnp.full((kk, d), 1.0, dtype))
        data_dims = (d,)

        def generate(key, params, pi):
            full = GaussParams(mu=params.mu,
                               lmbda=jax.vmap(jnp.diag)(params.lmbda_diag))
            x, _ = BayesianGMM.generate(key, full, pi, n)
            return (x,)

        def stats_of(params, pi, data):
            (x,) = data
            per_k = [params.mu[:, 0], pi]
            names = [f'mu{j}_x0' for j in range(kk)] \
                + [f'pi{j}' for j in range(kk)]
            if fam == 'diag':
                per_k += [jnp.sum(jnp.log(params.lmbda_diag), axis=-1)]
                names += [f'sumlogL{j}' for j in range(kk)]
            else:
                per_k += [jnp.sum(jnp.log(params.lmbda_diag[:1]), axis=-1)]
                names += ['sumlogL']
            vec = jnp.concatenate(per_k + [_arcsinh_moments([
                jnp.mean(x[:, 0]), jnp.var(x[:, 0]),
                jnp.mean(jnp.sum(x * x, -1))])])
            return vec, names
    elif fam in ('ilr', 'tied-affine'):
        from mimo_tpu.models.ilr import BayesianILR
        model = BayesianILR.make(
            size=kk, input_dim=d, output_dim=1, gating='stick-breaking',
            alpha=1.5, kappa=2.0, K_scale=1.0, psi_scale=1.0,
            basis_psi_scale=1.0, tied_affine=(fam == 'tied-affine'),
            dtype=dtype)
        data_dims = (d, 1)

        def generate(key, params, pi):
            bp, ep = params
            x, y, _ = BayesianILR.generate(key, bp, ep, pi, n,
                                           affine=model.affine)
            return (x, y)

        def stats_of(params, pi, data):
            x, y = data
            bp, ep = params
            from mimo_tpu.utils.linalg import logdet_psd
            per_k = [bp.mu[:, 0], logdet_psd(bp.lmbda), pi]
            names = ([f'bmu{j}' for j in range(kk)]
                     + [f'blogdet{j}' for j in range(kk)]
                     + [f'pi{j}' for j in range(kk)])
            if fam == 'ilr':
                per_k += [ep.A[:, 0, 0], ep.A[:, 0, -1],
                          jnp.log(ep.lmbda[:, 0, 0])]
                names += ([f'A{j}' for j in range(kk)]
                          + [f'c{j}' for j in range(kk)]
                          + [f'loglam{j}' for j in range(kk)])
            else:
                # shared slope + shared noise: one stat each; offsets per k
                per_k += [ep.A[:1, 0, 0], ep.A[:, 0, -1],
                          jnp.log(ep.lmbda[:1, 0, 0])]
                names += (['A_shared'] + [f'c{j}' for j in range(kk)]
                          + ['loglam'])
            vec = jnp.concatenate(per_k + [_arcsinh_moments([
                jnp.mean(x[:, 0]), jnp.var(x[:, 0]),
                jnp.mean(y[:, 0]), jnp.var(y[:, 0]),
                jnp.mean(x[:, 0] * y[:, 0])])])
            return vec, names
    else:
        raise ValueError(fam)

    spec = model._estep_spec()
    sweep_labels = gibbs_engine(spec, args.backend, n)
    gibbs_update = getattr(model.family, 'gibbs_update', None)

    def init(key):
        k1, k2 = jax.random.split(key)
        if gibbs_update is None:
            params = model.family.sample_params(k1, model.components_prior)
        else:
            _, params = gibbs_update(k1, model.components_prior,
                                     _zero_stats(model.family, data_dims,
                                                 kk, dtype))
        pi = model.gating_prior.sample(k2)
        return params, pi

    def transition(key, params, pi, data):
        """ONE production Gibbs sweep: fused label sample -> conjugate
        posterior update -> parameter + stick draws (the exact sweep body
        of fit_gibbs_fused, mixture.py)."""
        k_lab, k_par, k_pi = jax.random.split(key, 3)
        log_pi = jnp.log(jnp.clip(pi, 1e-37, None))
        _, res = sweep_labels(k_lab, params, log_pi, data)
        if gibbs_update is None:
            comps = model.family.update(model.components_prior, res.stats)
            params = model.family.sample_params(k_par, comps)
        else:
            _, params = gibbs_update(k_par, model.components_prior,
                                     res.stats)
        gating = model.gating_prior.update(res.counts)
        pi = gating.sample(k_pi)
        return params, pi

    return {'init': init, 'generate': generate, 'transition': transition,
            'stats_of': stats_of}


def build_nested_config(args, dtype):
    """The two-level nested Gibbs sweep of hmix.fit_gibbs_fused: joint
    flat (z, c) label draw over all M*K experts, then vmapped per-cluster
    sub-model draws (exact hierarchical gibbs_update per cluster) and
    both gating levels."""
    import jax
    import jax.numpy as jnp
    from mimo_tpu.models.hmix import BayesianMixtureOfMixtures
    from mimo_tpu.ops.family_estep import gibbs_engine
    from mimo_tpu.utils.linalg import logdet_psd, inv_psd, symmetrize

    n, d = args.n, args.dim
    mm, kk = args.m, args.k
    model = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=mm, mixture_size=kk, dim=d, alpha=1.5,
        inner_alpha=1.5, hierarchical=True, kappa=2.0, psi_scale=1.0,
        dtype=dtype)
    # tighten the hyper prior (as the flat legs do) so prior-predictive
    # data is non-degenerate
    spec = model._flat_spec()
    sweep_labels = gibbs_engine(spec, args.backend, n)
    gibbs_update = model.family.gibbs_update

    def init(key):
        k1, k2, k3 = jax.random.split(key, 3)
        zs = _zero_stats(model.family, (d,), kk, dtype)
        zs_m = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (mm,) + a.shape), zs)
        _, params = jax.vmap(gibbs_update)(
            jax.random.split(k1, mm), model.components_prior, zs_m)
        pi_o = model.outer_gating_prior.sample(k2)
        pi_i = jax.vmap(lambda g, k_: g.sample(k_))(
            model.inner_gating_prior, jax.random.split(k3, mm))
        return params, (pi_o, pi_i)

    def generate(key, params, pis):
        pi_o, pi_i = pis
        k_z, k_x = jax.random.split(key)
        log_flat = (jnp.log(jnp.clip(pi_o, 1e-37, None))[:, None]
                    + jnp.log(jnp.clip(pi_i, 1e-37, None))).reshape(-1)
        flat = jax.random.categorical(
            k_z, jnp.broadcast_to(log_flat, (n, mm * kk)), axis=-1)
        oh = jax.nn.one_hot(flat, mm * kk, dtype=dtype)
        mu = params.mu.reshape(mm * kk, d)
        lm = params.lmbda.reshape(mm * kk, d, d)
        chol = jnp.linalg.cholesky(symmetrize(inv_psd(lm)))
        z = jax.random.normal(k_x, (n, d), dtype)
        x = oh @ mu + jnp.einsum('nk,kde,ne->nd', oh, chol, z)
        return (x,)

    def transition(key, params, pis, data):
        pi_o, pi_i = pis
        k_lab, k_par, k_po, k_pi = jax.random.split(key, 4)
        log_pi = (jnp.log(jnp.clip(pi_o, 1e-37, None))[:, None]
                  + jnp.log(jnp.clip(pi_i, 1e-37, None))).reshape(-1)
        # spec.theta_plugin flattens the (M, K) axes itself (hmix._flat_spec)
        _, res = sweep_labels(k_lab, params, log_pi, data)
        counts, stats = model._split_flat(res)
        _, params = jax.vmap(gibbs_update)(
            jax.random.split(k_par, mm), model.components_prior, stats)
        pi_o = model.outer_gating_prior.update(
            jnp.sum(counts, axis=-1)).sample(k_po)
        pi_i = jax.vmap(lambda g, c, k_: g.update(c).sample(k_))(
            model.inner_gating_prior, counts, jax.random.split(k_pi, mm))
        return params, (pi_o, pi_i)

    def stats_of(params, pis, data):
        (x,) = data
        pi_o, pi_i = pis
        mu = params.mu.reshape(mm * kk, d)
        # shared Lambda per cluster (hierarchical inner family)
        logdets = logdet_psd(params.lmbda[:, 0])        # (M,)
        vec = jnp.concatenate([
            mu[:, 0],                                   # M*K
            logdets,                                    # M
            pi_o,                                       # M
            pi_i.reshape(-1),                           # M*K
            _arcsinh_moments([jnp.mean(x[:, 0]), jnp.var(x[:, 0]),
                              jnp.mean(jnp.sum(x * x, -1))]),
        ])
        names = ([f'mu{j}' for j in range(mm * kk)]
                 + [f'logdetL{j}' for j in range(mm)]
                 + [f'piO{j}' for j in range(mm)]
                 + [f'piI{j}' for j in range(mm * kk)]
                 + ['mean_x0', 'var_x0', 'mean_xx'])
        return vec, names

    return {'init': init, 'generate': generate, 'transition': transition,
            'stats_of': stats_of}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--backend', default='xla',
                    choices=['xla', 'pallas', 'interpret'],
                    help='pallas = the fused GPU label kernel (f32); '
                         'interpret = that kernel through the Pallas '
                         'interpreter (a CPU dry run)')
    ap.add_argument('--family', default='gmm', choices=FAMILIES)
    ap.add_argument('--draws', type=int, default=20000)
    ap.add_argument('--thin', type=int, default=2,
                    help='transitions per collected draw')
    ap.add_argument('--burn', type=int, default=500)
    ap.add_argument('--n', type=int, default=512)
    ap.add_argument('--k', type=int, default=3)
    ap.add_argument('--m', type=int, default=2,
                    help='outer clusters (nested family only)')
    ap.add_argument('--dim', type=int, default=2)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--f64', action='store_true',
                    help='force x64 (default on for the xla backend)')
    ap.add_argument('--assert-below', type=float, default=None,
                    help='exit 1 if max|z| exceeds this (CI regression '
                         'gate; use ~4.5 at 4k draws, ~3.5 at 20k)')
    args = ap.parse_args(argv)

    import jax
    if args.backend == 'xla' or args.f64:
        jax.config.update('jax_enable_x64', True)
    from mimo_tpu.utils.cache import use_compile_cache
    use_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    dtype = jnp.float64 if (args.backend == 'xla' or args.f64) \
        else jnp.float32

    if args.family == 'nested':
        cfg = build_nested_config(args, dtype)
    else:
        cfg = build_mixture_config(args, dtype)
    init, generate = cfg['init'], cfg['generate']
    transition, stats_of = cfg['transition'], cfg['stats_of']

    # trace once to get names + stat count
    key = jax.random.PRNGKey(args.seed)
    k_prior, k_succ, k0 = jax.random.split(key, 3)
    p0, pi0 = init(jax.random.fold_in(k0, 0))
    _, names = stats_of(p0, pi0, generate(jax.random.fold_in(k0, 1),
                                          p0, pi0))

    def prior_draw(key):
        k1, k3 = jax.random.split(key)
        params, pi = init(k1)
        vec, _ = stats_of(params, pi, generate(k3, params, pi))
        return vec

    def succ_step(carry, key):
        params, pi = carry
        k_d, k_t = jax.random.split(key)
        data = generate(k_d, params, pi)
        for i in range(args.thin):
            params, pi = transition(jax.random.fold_in(k_t, i),
                                    params, pi, data)
            if i + 1 < args.thin:     # fresh data between thinned sweeps
                data = generate(jax.random.fold_in(k_d, i + 1),
                                params, pi)
        vec, _ = stats_of(params, pi, data)
        return (params, pi), vec

    # (a) iid prior side
    prior_stats = jax.lax.map(prior_draw,
                              jax.random.split(k_prior, args.draws),
                              batch_size=1024)
    prior_stats = np.asarray(jax.device_get(prior_stats), np.float64)

    # (b) successive-conditional side (one jitted scan)
    @jax.jit
    def run_chain(params0, pi0, keys):
        _, s = jax.lax.scan(succ_step, (params0, pi0), keys)
        return s

    succ_stats = run_chain(p0, pi0,
                           jax.random.split(k_succ,
                                            args.burn + args.draws))
    succ_stats = np.asarray(jax.device_get(succ_stats),
                            np.float64)[args.burn:]

    # non-finite draws (possible at f32 from astronomically-deep tails
    # even after arcsinh, e.g. an inf inside a component's logdet):
    # count PER SIDE and drop, loudly — silently nan-propagating means
    # would void every z
    bad_p = ~np.isfinite(prior_stats).all(axis=1)
    bad_s = ~np.isfinite(succ_stats).all(axis=1)
    if bad_p.any() or bad_s.any():
        runs = []
        in_run = False
        for i, b in enumerate(bad_s):
            if b and not in_run:
                runs.append([i, i])
                in_run = True
            elif b:
                runs[-1][1] = i
            else:
                in_run = False
        print(f'WARNING: dropped non-finite draws: prior '
              f'{int(bad_p.sum())}/{len(bad_p)}, successive '
              f'{int(bad_s.sum())}/{len(bad_s)} in {len(runs)} run(s) '
              f'{runs[:5]}', flush=True)
    assert bad_p.mean() < 0.01 and bad_s.mean() < 0.01, \
        'too many non-finite draws — investigate before trusting z'
    prior_stats = prior_stats[~bad_p]
    succ_stats = succ_stats[~bad_s]

    def batch_means_se(a, nb=50):
        m = len(a) // nb
        bm = a[:nb * m].reshape(nb, m).mean(axis=1)
        return bm.std(ddof=1) / np.sqrt(nb)

    out = []
    for j, name in enumerate(names):
        pa, sb = prior_stats[:, j], succ_stats[:, j]
        se_a = pa.std(ddof=1) / np.sqrt(len(pa))
        se_b = batch_means_se(sb)
        z = (pa.mean() - sb.mean()) / np.sqrt(se_a ** 2 + se_b ** 2)
        out.append({'stat': name, 'prior_mean': float(pa.mean()),
                    'succ_mean': float(sb.mean()), 'z': float(z)})
        print(f'{name:<10} prior {pa.mean():+10.4f} succ {sb.mean():+10.4f}'
              f'  z {z:+6.2f}', flush=True)
    mx = max(abs(o['z']) for o in out)
    print(json.dumps({'backend': args.backend, 'family': args.family,
                      'draws': args.draws,
                      'dropped_prior': int(bad_p.sum()),
                      'dropped_succ': int(bad_s.sum()),
                      'thin': args.thin, 'max_abs_z': mx,
                      'n': args.n, 'k': args.k, 'd': args.dim,
                      'dtype': str(dtype.__name__ if hasattr(dtype,
                                   '__name__') else dtype)}))
    if args.assert_below is not None and mx >= args.assert_below:
        print(f'FAIL: max|z| {mx:.2f} >= {args.assert_below}')
        sys.exit(1)
    return mx, out


if __name__ == '__main__':
    main()
