"""Run mimo_tpu's main path once on one NVIDIA GPU and check every answer.

    python chip_smoke.py          # phases (a)-(g) on one card
    python chip_smoke.py --four   # the mesh path on four cards only

Phases (one card), each printed with its compile time, steady time and
every comparison beside its tolerance:
  (a) north-star GMM (N=1e7, K=50, d=2): fit_vi_fused on the fused
      kernel against backend='xla', plus one E-step's statistics; the
      ELBO trajectories are printed beside a one-ulp witness
      (trajectories());
  (b) fit_gibbs_fused on the kernel: finite, >= 3 occupied clusters, one
      sweep's label counts within a chi-square bound of the softmax;
  (c) fit_map_fused: finite trace whose final objective equals
      backend='xla', and one plug-in E-step equal to XLA's;
  (d) log_predictive on all N: finite, equal on 4096 points to a float64
      Student-t mixture computed with NumPy/SciPy on the host;
  (e) the ILR flagship recipe (config.flagship_fit, sine, N=1e6): RMSE;
  (f) ILR at N=1e6, K=50: at q=1 (m=10) fit_vi_fused runs the kernel,
      its ELBO trace equal to XLA's; at q=8 the feature width (m=164)
      routes it to XLA, where the kernel lost; finite, monotone ELBO;
  (g) the `gpu`-marked tests, in a child process that holds the card
      before this process touches it.
--four runs fit_vi_fused, fit_gibbs_fused, fit_map_fused and fit_svi with
mesh=make_mesh() over four cards at N=1e7, each against the one-card run
on the same data and seed (VI and MAP final objectives to 1e-4), and
nothing else.

Exits non-zero, printing no result line, when a phase fails or JAX finds
no GPU. The last line of standard output is one JSON object.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N, K, D = 10_000_000, 50, 2


class PhaseFailed(Exception):
    pass


def check(name, value, limit, ok):
    print(f'    {name}: {value:.3e} (limit {limit:.1e}) '
          f'{"ok" if ok else "FAIL"}', flush=True)
    if not ok:
        raise PhaseFailed(name)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def timed(fn):
    """(compile s, steady s, result): the first call compiles and runs,
    the second runs the compiled program."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    steady = time.perf_counter() - t0
    return max(first - steady, 0.0), steady, out


def report(phase, what, c, s):
    print(f'  [{phase}] {what}: compile {c:.2f} s, steady {s:.3f} s',
          flush=True)


def card():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True)
    return out.stdout.strip()


def gmm_data(n=N, d=D, seed=0):
    """The bench's north-star data: three Gaussians, weights .3/.4/.3."""
    import jax
    import jax.numpy as jnp
    from mimo_tpu.distributions.niw import GaussParams
    from mimo_tpu.models.gmm import BayesianGMM
    kg = jax.random.PRNGKey(seed)
    mu = jax.random.normal(jax.random.fold_in(kg, 1), (3, d)) * 4.0
    lm = jnp.broadcast_to(jnp.eye(d) * 2.0, (3, d, d))
    x, _ = BayesianGMM.generate(kg, GaussParams(mu, lm),
                                jnp.array([.3, .4, .3]), n)
    return x.astype(jnp.float32)


def gmm_model():
    from mimo_tpu.models.gmm import BayesianGMM
    return BayesianGMM.make(size=K, dim=D, gating='dp', alpha=1.0,
                            kappa=0.05, psi_scale=0.5)


def compare_estep(spec, post, log_pi, x):
    """One E-step of the kernel against the XLA engine on the same state:
    statistics to rtol 2e-4, lse to 1e-5."""
    import jax
    import jax.numpy as jnp
    from mimo_tpu.ops import triton_estep as te
    from mimo_tpu.ops.estep import pick_block_size
    from mimo_tpu.ops.family_estep import fused_estep_blockwise
    got = jax.jit(lambda p, l, d: te.fused_estep_pallas(spec, p, l, d))(
        post, log_pi, (x,))
    ref = jax.jit(lambda p, l, d: fused_estep_blockwise(
        spec, p, l, d, pick_block_size(x.shape[0])))(post, log_pi, (x,))
    worst = 0.0
    for a, b in zip(jax.tree.leaves(got.stats), jax.tree.leaves(ref.stats)):
        err = jnp.abs(a - b) - 2e-4 * jnp.abs(b)
        worst = max(worst, float(jnp.max(err / (1.0 + jnp.abs(b)))))
    check('E-step stats: max(|d| - 2e-4 |ref|)/(1+|ref|)', max(worst, 0.0),
          2e-4, worst <= 2e-4)
    check('E-step lse rel diff', rel(got.lse, ref.lse), 1e-5,
          rel(got.lse, ref.lse) <= 1e-5)


def trajectories(name, kernel, xla, xla_ulp):
    """Print, ungated, the largest mid-climb gap between the kernel's and
    XLA's objective traces beside a witness: XLA against itself with every
    x moved by one f32 ulp. The fit leaves a near-symmetric random start
    through a saddle, which amplifies f32 rounding; the witness shows that
    even one ulp of input strays past 1e-4 there, so no f32 engine with
    another rounding can be held to XLA's trace. The kernel rounds each
    point's log-density differently from XLA's GEMM, a larger perturbation
    than one ulp of x, so its gap is larger. Both meet at the final value,
    which the phases gate."""
    import numpy as np

    def gap(a, b):
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        d = d / np.abs(np.asarray(b, np.float64))
        first = int(np.argmax(d > 1e-4)) if (d > 1e-4).any() else None
        return f'{d.max():.3e} (first past 1e-4 at iteration {first})'
    print(f'    {name} trajectory max rel diff, not gated: kernel vs xla '
          f'{gap(kernel, xla)}; witness xla one-ulp x vs xla '
          f'{gap(xla_ulp, xla)}', flush=True)


def phase_a(x):
    import jax.numpy as jnp
    from mimo_tpu.models.mixture import _resolve_backend
    m = gmm_model()
    engine = _resolve_backend('auto', m._estep_spec(), m.components_prior)
    print(f'    auto -> {engine} at N={N}, K={K}, d={D}', flush=True)
    if engine != 'pallas':
        raise PhaseFailed('routing at the north star')
    c, s, (st, v) = timed(lambda: m.fit_vi_fused(x, key=1, maxiter=100,
                                                 backend='pallas'))
    report('a', 'fit_vi_fused 100 it, kernel', c, s)
    cx, sx, (_, vx) = timed(lambda: m.fit_vi_fused(x, key=1, maxiter=100,
                                                   backend='xla'))
    report('a', 'fit_vi_fused 100 it, xla', cx, sx)
    check('finite ELBO trace', float(jnp.all(jnp.isfinite(v)) == 0), 0.5,
          bool(jnp.all(jnp.isfinite(v))))
    check('final ELBO rel diff vs xla', rel(v[-1], vx[-1]), 1e-4,
          rel(v[-1], vx[-1]) <= 1e-4)
    _, vu = m.fit_vi_fused(jnp.nextafter(x, jnp.inf), key=1, maxiter=100,
                           backend='xla')
    trajectories('VI', v, vx, vu)
    spec = m._estep_spec()
    compare_estep(spec, st.components, st.gating.expected_log_pi(), x)
    return m, st


def phase_b(x):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy import stats
    from mimo_tpu.ops import triton_estep as te
    m = gmm_model()
    c, s, gs = timed(lambda: m.fit_gibbs_fused(x, key=2, maxiter=100,
                                               backend='pallas'))
    report('b', 'fit_gibbs_fused 100 sweeps, kernel', c, s)
    cx, sx, _ = timed(lambda: m.fit_gibbs_fused(x, key=2, maxiter=100,
                                                backend='xla'))
    report('b', 'fit_gibbs_fused 100 sweeps, xla', cx, sx)
    leaves = jax.tree.leaves(gs.components) + [gs.log_pi]
    finite = all(bool(jnp.all(jnp.isfinite(a))) for a in leaves)
    check('non-finite state leaves', float(not finite), 0.5, finite)
    occupied = int(np.sum(np.bincount(np.asarray(gs.labels),
                                      minlength=K) > 0))
    print(f'    occupied clusters: {occupied} (need >= 3)', flush=True)
    if occupied < 3:
        raise PhaseFailed('occupied clusters')
    spec = m._estep_spec()
    labels, _ = jax.jit(lambda k, p, l, d: te.fused_gibbs_pallas(
        spec, k, p, l, d))(jax.random.PRNGKey(9), gs.params, gs.log_pi, (x,))
    logp = m.log_complete_likelihood(gs.params, gs.log_pi, (x,))
    expected = np.asarray(jnp.sum(jax.nn.softmax(logp, axis=-1), axis=0),
                          np.float64)
    counts = np.bincount(np.asarray(labels), minlength=K)
    keep = expected > 5
    chi2 = float(np.sum((counts[keep] - expected[keep]) ** 2
                        / expected[keep]))
    bound = float(stats.chi2.ppf(1 - 1e-4, keep.sum() - 1))
    check(f'one-sweep chi2 vs softmax ({keep.sum()} clusters)', chi2,
          bound, chi2 <= bound)


def phase_c(x):
    import jax.numpy as jnp
    m = gmm_model()
    c, s, (_, tr) = timed(lambda: m.fit_map_fused(x, key=7, maxiter=50,
                                                  backend='pallas'))
    report('c', 'fit_map_fused 50 it, kernel', c, s)
    cx, sx, (st, trx) = timed(lambda: m.fit_map_fused(x, key=7, maxiter=50,
                                                      backend='xla'))
    report('c', 'fit_map_fused 50 it, xla', cx, sx)
    finite = bool(jnp.all(jnp.isfinite(tr)))
    check('non-finite trace entries', float(not finite), 0.5, finite)
    check('MAP final objective rel diff vs xla', rel(tr[-1], trx[-1]), 1e-4,
          rel(tr[-1], trx[-1]) <= 1e-4)
    _, tru = m.fit_map_fused(jnp.nextafter(x, jnp.inf), key=7, maxiter=50,
                             backend='xla')
    trajectories('MAP', tr, trx, tru)
    spec = m._estep_spec()
    compare_estep(spec._replace(theta=spec.theta_plugin),
                  m.family.mode_params(st.components),
                  jnp.log(jnp.clip(st.gating.mode(), 1e-37, None)), x)


def phase_d(x, m, st):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy import stats
    from scipy.special import logsumexp
    fn = jax.jit(m.log_predictive)
    c, s, lp = timed(lambda: fn(st, x))
    report('d', f'log_predictive on {N} points', c, s)
    finite = bool(jnp.all(jnp.isfinite(lp)))
    check('non-finite densities', float(not finite), 0.5, finite)
    xs = np.asarray(x[:4096], np.float64)
    post = jax.tree.map(lambda a: np.asarray(a, np.float64), st.components)
    log_w = np.log(np.asarray(st.gating.mean(), np.float64))
    cols = []
    for k in range(K):
        df = post.nu[k] - D + 1
        scale = (np.linalg.inv(post.psi[k]) * (post.kappa[k] + 1)
                 / (post.kappa[k] * df))
        cols.append(stats.multivariate_t(post.mu[k], scale, df=df)
                    .logpdf(xs))
    want = logsumexp(np.stack(cols, 1) + log_w[None, :], axis=1)
    got = np.asarray(lp[:4096], np.float64)
    err = float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))
    check('4096-pt max |d|/(1+|ref|) vs float64 host', err, 1e-4,
          err <= 1e-4)


def phase_e():
    import jax
    import jax.numpy as jnp
    from mimo_tpu.config import (GatingConfig, ILRConfig, TrainConfig,
                                 flagship_fit)
    kr = jax.random.PRNGKey(11)
    n = 1_000_000
    xr = jax.random.uniform(kr, (n, 1), minval=-6., maxval=6.)
    yr = jnp.sin(xr) + 0.1 * jax.random.normal(jax.random.fold_in(kr, 1),
                                               (n, 1))
    cfg = ILRConfig(size=50, input_dim=1, output_dim=1,
                    gating=GatingConfig('stick-breaking', 5.0),
                    kappa=0.05, K_scale=1e-2)
    train = TrainConfig(super_iters=2, gibbs_iters=10, svi_iters=500,
                        svi_step_size=0.5, svi_batch_size=256, seed=1)

    def run():
        model = cfg.build()
        model.init_transform(xr, yr)
        model, state = flagship_fit(model, (xr, yr), train)
        mu = model.predict(state, xr, yr)[0]
        return jnp.sqrt(jnp.mean((mu - yr) ** 2))
    c, s, rmse = timed(run)
    report('e', 'ILR sine recipe, N=1e6', c, s)
    check('RMSE (noise floor 0.1)', float(rmse), 0.12, float(rmse) <= 0.12)


def phase_f():
    phase_f_q1()
    phase_f_q8()


def phase_f_q1():
    """ILR q=1 (m=10) at N=1e6, K=50: 'auto' takes the kernel, whose ELBO
    trace equals XLA's."""
    import jax
    import jax.numpy as jnp
    from mimo_tpu.models.ilr import BayesianILR
    from mimo_tpu.models.mixture import _resolve_backend
    kr = jax.random.PRNGKey(11)
    xr = jax.random.uniform(kr, (1_000_000, 1), minval=-6., maxval=6.)
    yr = jnp.sin(xr) + 0.1 * jax.random.normal(jax.random.fold_in(kr, 1),
                                               xr.shape)
    m = BayesianILR.make(size=50, input_dim=1, output_dim=1, alpha=2.0,
                         kappa=0.05)
    m.init_transform(xr, yr)
    engine = _resolve_backend('auto', m._estep_spec(), m.components_prior)
    print(f'    ILR q=1 (m=10): auto -> {engine}', flush=True)
    if engine != 'pallas':
        raise PhaseFailed('routing at ILR q=1')
    c, s, (_, v) = timed(lambda: m.fit_vi_fused((xr, yr), key=1,
                                                maxiter=100))
    report('f', 'ILR q=1 fit_vi_fused 100 it, kernel', c, s)
    cx, sx, (_, vx) = timed(lambda: m.fit_vi_fused(
        (xr, yr), key=1, maxiter=100, backend='xla'))
    report('f', 'ILR q=1 fit_vi_fused 100 it, xla', cx, sx)
    path = float(jnp.max(jnp.abs(v - vx) / jnp.abs(vx)))
    check('ILR q=1 ELBO trace max rel diff vs xla', path, 1e-4,
          path <= 1e-4)


def phase_f_q8():
    import jax
    import jax.numpy as jnp
    from mimo_tpu.models.ilr import BayesianILR
    from mimo_tpu.models.mixture import KERNEL_MAX_FEATURES, _resolve_backend
    kg = jax.random.PRNGKey(3)
    n = 1_000_000
    xs = jax.random.uniform(kg, (n, 8), minval=-3, maxval=3)
    w = jax.random.normal(jax.random.fold_in(kg, 1), (8, 1))
    ys = jnp.sin(xs @ w) + 0.1 * jax.random.normal(jax.random.fold_in(kg, 2),
                                                   (n, 1))
    m = BayesianILR.make(size=50, input_dim=8, output_dim=1, alpha=2.0,
                         kappa=0.05)
    spec = m._estep_spec()
    width = jax.eval_shape(spec.theta, m.components_prior).shape[-1]
    engine = _resolve_backend('auto', spec, m.components_prior)
    print(f'    feature width m={width} (kernel takes m <= '
          f'{KERNEL_MAX_FEATURES}): auto -> {engine}', flush=True)
    if engine != 'xla':
        raise PhaseFailed('routing at ILR q=8')
    c, s, (_, v) = timed(lambda: m.fit_vi_fused((xs, ys), key=1, maxiter=50))
    report('f', 'ILR q=8 fit_vi_fused 50 it, auto', c, s)
    cx, sx, (_, vx) = timed(lambda: m.fit_vi_fused(
        (xs, ys), key=1, maxiter=50, backend='xla'))
    report('f', 'ILR q=8 fit_vi_fused 50 it, xla', cx, sx)
    finite = bool(jnp.all(jnp.isfinite(v)))
    check('non-finite ELBO entries', float(not finite), 0.5, finite)
    drop = float(jnp.max(v[:-1] - v[1:]) / jnp.abs(v[-1]))
    check('largest ELBO drop, relative', max(drop, 0.0), 1e-4, drop <= 1e-4)
    check('final ELBO rel diff auto vs xla', rel(v[-1], vx[-1]), 1e-4,
          rel(v[-1], vx[-1]) <= 1e-4)


def phase_g():
    """The gpu-marked tests, in a child that owns the card while this
    process has not yet touched it."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, '-m', 'pytest', '-m', 'gpu', 'tests/', '-q',
         '-p', 'no:cacheprovider', '-p', 'no:xdist', '-p', 'no:randomly',
         '-rs'], cwd=HERE, capture_output=True, text=True)
    tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ''
    print(f'  [g] pytest -m gpu: {tail} ({time.perf_counter() - t0:.1f} s)',
          flush=True)
    if out.returncode != 0 or 'passed' not in tail or 'skipped' in tail:
        print(out.stdout[-4000:], out.stderr[-4000:], sep='\n',
              file=sys.stderr)
        raise PhaseFailed('gpu tests')


def four(x):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mimo_tpu.parallel import make_mesh, shard_data
    mesh = make_mesh()
    xs = shard_data(mesh, x)
    m = gmm_model()
    print(f'  mesh {dict(mesh.shape)}', flush=True)
    for name, kw in (('fit_vi_fused', dict(maxiter=100)),
                     ('fit_map_fused', dict(maxiter=50))):
        fit = getattr(m, name)
        c, s, (_, t1) = timed(lambda: fit(x, key=1, **kw))
        report('4', f'{name}, one card', c, s)
        c, s, (_, t4) = timed(lambda: fit(xs, key=1, mesh=mesh, **kw))
        report('4', f'{name}, four cards', c, s)
        check(f'{name} final objective rel diff 4 vs 1 card',
              rel(t4[-1], t1[-1]), 1e-4, rel(t4[-1], t1[-1]) <= 1e-4)
        # the same kernel with its sums split over four cards: the climb
        # amplifies the changed f32 summation order (see trajectories()),
        # so the trajectory is printed, the final value gated
        path = float(jnp.max(jnp.abs(t4 - t1) / jnp.abs(t1)))
        print(f'    {name} trajectory max rel diff 4 vs 1 card: '
              f'{path:.3e} (not gated)', flush=True)
    c, s, gs = timed(lambda: m.fit_gibbs_fused(xs, key=2, maxiter=100,
                                               mesh=mesh))
    report('4', 'fit_gibbs_fused, four cards', c, s)
    finite = all(bool(jnp.all(jnp.isfinite(a)))
                 for a in jax.tree.leaves(gs.components) + [gs.log_pi])
    check('Gibbs non-finite leaves', float(not finite), 0.5, finite)
    print(f'    Gibbs labels shape {gs.labels.shape} (need ({N},))',
          flush=True)
    if gs.labels.shape != (N,):
        raise PhaseFailed('Gibbs labels shape')
    c, s, (st1, _) = timed(lambda: m.fit_svi(x, key=5, maxiter=500,
                                             step_size=0.5,
                                             batch_size=65536))
    report('4', 'fit_svi 500 steps, one card', c, s)
    c, s, (st4, _) = timed(lambda: m.fit_svi(xs, key=5, maxiter=500,
                                             step_size=0.5,
                                             batch_size=65536, mesh=mesh))
    report('4', 'fit_svi 500 steps, four cards', c, s)
    # per-device stratified minibatches draw other points than the
    # one-card run, so compare the fitted densities, not the states
    sub = x[:100_000]
    l1 = float(np.mean(np.asarray(m.log_predictive(st1, sub))))
    l4 = float(np.mean(np.asarray(m.log_predictive(st4, sub))))
    check('SVI mean log-density rel diff 4 vs 1 card', rel(l4, l1), 1e-2,
          rel(l4, l1) <= 1e-2)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--four', action='store_true',
                    help='run only the four-card mesh path')
    args = ap.parse_args()
    card_line = card()
    print(f'card: {card_line}', flush=True)
    if not args.four:
        phase_g()
    sys.path.insert(0, HERE)
    import jax
    if jax.default_backend() != 'gpu':
        raise SystemExit(f'no GPU: JAX backend is {jax.default_backend()}')
    from mimo_tpu.utils.cache import use_compile_cache
    use_compile_cache()
    devices = jax.devices()
    want = 4 if args.four else 1
    if len(devices) < want:
        raise SystemExit(f'needs {want} GPUs, JAX sees {len(devices)}')
    print(f'devices: {len(devices)} x {devices[0].device_kind}', flush=True)
    t0 = time.perf_counter()
    x = gmm_data()
    if args.four:
        four(x)
    else:
        m, st = phase_a(x)
        phase_b(x)
        phase_c(x)
        phase_d(x, m, st)
        phase_e()
        phase_f()
    print(f'total {time.perf_counter() - t0:.1f} s', flush=True)
    print(card_line, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform, 'kind': devices[0].device_kind,
        'count': len(devices)}}))


if __name__ == '__main__':
    try:
        main()
    except PhaseFailed as e:
        print(f'FAILED: {e}', file=sys.stderr)
        sys.exit(1)
