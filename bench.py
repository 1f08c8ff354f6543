"""Benchmark suite for the fused engines.

Headline (the ONE JSON line, stdout): DP-GMM mean-field VI sweep
throughput on the north-star workload (N=1e7 points, K=50 components,
d=2; BASELINE.md), backend='auto' (the fused kernel on a GPU).

Detail rows (stderr):
  - N=1e7 d=2 K=50: VI + Gibbs for both backends, posterior predictive
  - SVI at N=1e7 (B=256 reference-default and B=65536), and
    out-of-core fit_svi_stream fed by the native C loader (pts/s ingest)
  - the flagship recipe end-to-end (Gibbs init -> super-iters of SVI with
    prior<-posterior re-anchoring -> predict, evaluate_sine.py:131-155)
    on ILR sine at N=1e6
  - N=1e6 continuity row vs the frozen NumPy reference
  - wide shapes: d=8 K=128 (N=1e7) and d=32 K=256 (N=1e6) with
    nominal FLOP/s
  - ILR (mixture of linear experts) q=8: VI + Gibbs, auto vs xla
  - nested mixture-of-mixtures (M=2 x K=3) VI + Gibbs at N=1e6
  - chain parallelism: 16 vmapped restarts vs 1 (evaluate_sinc_parallel's
    24-process joblib pool, on-device)

`vs_baseline` compares against the reference (hanyas/mimo, NumPy) running
the same model/update on CPU, measured by scripts/measure_reference.py on
this machine (frozen below with provenance).
"""

import json
import os
import sys
import time

import jax

import jax.numpy as jnp

from mimo_tpu.models.gmm import BayesianGMM
from mimo_tpu.distributions.niw import GaussParams
from mimo_tpu.utils.cache import use_compile_cache

# Frozen CPU baseline, measured 2026-08-17/18 with
# scripts/measure_reference.py on this machine (reference @
# /root/reference, NumPy/OpenBLAS, 125 GB RAM):
#   N=1e4: VI 9.692 iters/s, Gibbs 35.229 sweeps/s
#   N=1e5: VI 0.296 iters/s, Gibbs  2.133 sweeps/s
#   N=1e6: VI 0.011 iters/s, Gibbs  0.022 sweeps/s
#   N=1e7: VI 0.00039 iters/s (2554 s/iter), Gibbs 0.00087 sweeps/s
#          (1148 s/sweep), peak RSS 43.5 GB
# (superlinear falloff: the fold=False N x d x d expected-stats path,
# gaussian.py:474-485, plus the K x N x d x d einsums going out of cache.)
REFERENCE_VI_ITERS_PER_S_1E7 = 0.00039

N, K, D = 10_000_000, 50, 2
ITERS = 100


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def best_of(fn, reps=3):
    """Wall time of fn's best rep (first call compiles)."""
    out = fn()
    jax.block_until_ready(out)
    best = float('inf')
    for _ in range(reps):
        t0 = time.time()
        out = fn()
        jax.block_until_ready(out)
        best = min(best, time.time() - t0)
    return best, out


def gauss_flops(n, d, k, iters=1):
    """Nominal FLOPs of one fused VI iteration: two (N, m) x (m, K) dots,
    m = 1 + d + d^2 (un-padded)."""
    m = 1 + d + d * d
    return 4.0 * n * m * k * iters


def bench_gmm(n, k, d, iters, key=0, backends=('auto',), gibbs=True,
              reps=3):
    kg = jax.random.PRNGKey(key)
    mu = jax.random.normal(jax.random.fold_in(kg, 1), (3, d)) * 4.0
    lm = jnp.broadcast_to(jnp.eye(d) * 2.0, (3, d, d))
    x, _ = BayesianGMM.generate(kg, GaussParams(mu, lm),
                                jnp.array([.3, .4, .3]), n)
    model = BayesianGMM.make(size=k, dim=d, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5)
    out = {}
    for backend in backends:
        dt, (st, vlb) = best_of(
            lambda b=backend: model.fit_vi_fused(x, key=1, maxiter=iters,
                                                 backend=b), reps)
        assert bool(jnp.isfinite(vlb[-1])), f'non-finite ELBO ({backend})'
        out[f'vi_{backend}'] = iters / dt
        if gibbs:
            dt, gs = best_of(
                lambda b=backend: model.fit_gibbs_fused(
                    x, key=2, maxiter=iters, backend=b), reps)
            out[f'gibbs_{backend}'] = iters / dt
    out['state'] = st
    out['model'] = model
    out['x'] = x
    out['elbo'] = float(vlb[-1])
    return out


def main():
    use_compile_cache()
    # ---- north star: N=1e7, K=50, d=2 ------------------------------------
    r = bench_gmm(N, K, D, ITERS, backends=('auto', 'xla'))
    vi_rate = r['vi_auto']

    # serving: posterior-predictive density over all N points (10-deep
    # pipelined calls, so dispatch overlaps the device)
    model, st, x = r['model'], r['state'], r['x']
    pred = jax.jit(model.log_predictive)

    def pred10():
        for _ in range(10):
            lp = pred(st, (x,))
        return lp
    dt, _ = best_of(pred10, reps=3)
    serve_rate = 10 * N / dt

    fl = gauss_flops(N, D, K)
    log(f'# [1e7/K50/d2] VI auto {vi_rate:.1f} it/s ({fl*vi_rate/1e12:.2f} '
        f"TFLOP/s) | VI xla {r['vi_xla']:.1f} | Gibbs auto "
        f"{r['gibbs_auto']:.1f} sw/s | Gibbs xla {r['gibbs_xla']:.1f} | "
        f"predictive {serve_rate/1e6:.1f}M pts/s | ELBO {r['elbo']:.4g}")

    # ---- MAP-EM / ML-EM through the same kernels -------------------------
    # (round 3: the plug-in E-steps ride the fused engines too, so all
    # four reference engines scale to HBM-resident N)
    dt, (st_map, ll_map) = best_of(
        lambda: model.fit_map_fused(x, key=7, maxiter=50), reps=2)
    assert bool(jnp.all(jnp.isfinite(ll_map)))
    m_em = BayesianGMM.make(size=K, dim=D, gating='dp', alpha=1.0,
                            kappa=0.05, psi_scale=0.5)
    dte, (st_em, ll_em) = best_of(
        lambda: m_em.fit_em_fused(x, key=7, maxiter=50), reps=2)
    assert bool(jnp.all(jnp.isfinite(ll_em)))
    log(f'# [MAP/EM 1e7/K50/d2] MAP fused {50 / dt:.1f} it/s | EM fused '
        f'{50 / dte:.1f} it/s (plug-in softmax through the fused '
        f'E-step)')

    # ---- diag (NG) family: fused training + serving ----------------------
    m_diag = BayesianGMM.make(size=K, dim=D, diag=True, kappa=0.05)
    dt, (st_d, vlb_d) = best_of(
        lambda: m_diag.fit_vi_fused(x, key=1, maxiter=ITERS), reps=2)
    assert bool(jnp.isfinite(vlb_d[-1]))
    pred_d = jax.jit(m_diag.log_predictive)

    def pred10d():
        for _ in range(10):
            lp = pred_d(st_d, (x,))
        return lp
    dts, _ = best_of(pred10d, reps=3)
    log(f'# [diag 1e7/K50/d2] VI fused {ITERS / dt:.1f} it/s | predictive '
        f'{10 * N / dts / 1e6:.1f}M pts/s')

    # ---- SVI: the scalable path (SURVEY.md §3.3) -------------------------
    # reference-default B=256 (evaluate_sine.py:46) and a large batch
    for b in (256, 65536):
        steps = 500 if b == 256 else 200
        dt, (st_svi, _) = best_of(lambda bb=b, ss=steps: model.fit_svi(
            x, key=5, maxiter=ss, step_size=0.5, batch_size=bb), reps=2)
        leaves = jax.tree.leaves(st_svi.components)
        assert all(bool(jnp.all(jnp.isfinite(a))) for a in leaves)
        log(f'# [SVI 1e7/K50/d2 B={b}] {steps / dt:.0f} steps/s '
            f'({steps / dt * b / 1e6:.1f}M pts/s through the E-step)')

    # ---- out-of-core SVI via the native C loader -------------------------
    import numpy as np
    import tempfile
    from mimo_tpu.io import MmapDataset, write_bin
    path = os.path.join(tempfile.gettempdir(), f'bench_svi_{os.getpid()}.bin')
    try:
        write_bin(path, np.asarray(x[:2_000_000], np.float32))
        ds = MmapDataset(path)
        bstream, steps_s = 65536, 100
        dt = float('inf')
        for rep in range(3):         # rep 0 pays the grouped-scan compile
            rng_np = np.random.default_rng(rep)
            # steps + 1: fit_svi_stream draws one extra init batch
            batches = ds.minibatches(rng_np, bstream, steps_s + 1)
            t0 = time.time()
            model.fit_svi_stream(lambda i: next(batches),
                                 total_size=ds.shape[0], key=6,
                                 maxiter=steps_s, step_size=0.5,
                                 batch_size=bstream)
            if rep:
                dt = min(dt, time.time() - t0)
        log(f'# [SVI-stream 2e6/B65536] {steps_s * bstream / dt / 1e6:.1f}M '
            f'pts/s ingested (C loader mmap -> host -> HBM -> nat-grad '
            f'step, {steps_s / dt:.0f} steps/s)')

        # bf16 wire transfer: halves host->device bytes; see
        # fit_svi_stream(transfer_dtype=)
        dt = float('inf')
        for rep in range(3):
            rng_np = np.random.default_rng(rep)
            batches = ds.minibatches(rng_np, bstream, steps_s + 1)
            t0 = time.time()
            model.fit_svi_stream(lambda i: next(batches),
                                 total_size=ds.shape[0], key=6,
                                 maxiter=steps_s, step_size=0.5,
                                 batch_size=bstream,
                                 transfer_dtype=jnp.bfloat16)
            if rep:
                dt = min(dt, time.time() - t0)
        log(f'# [SVI-stream bf16-wire] {steps_s * bstream / dt / 1e6:.1f}M '
            f'pts/s ingested ({steps_s / dt:.0f} steps/s; '
            f'transfer_dtype=bfloat16 halves h2d bytes)')

        # ---- out-of-core FULL-DATA engine (round 5): epoch-streamed VI —
        # each sweep reads the whole file in blocks through the fused
        # E-step; exact same math as fit_vi_fused, N bounded by disk
        bb = 500_000
        nb = ds.shape[0] // bb
        rbk = lambda i: ds.read_block(i * bb, bb)
        st_oc, _ = model.fit_vi_stream_full(rbk, nb, key=7, maxiter=2)
        dt = float('inf')
        for rep in range(2):
            t0 = time.time()
            st_oc, _ = model.fit_vi_stream_full(rbk, nb, init_state=st_oc,
                                                maxiter=10)
            dt = min(dt, time.time() - t0)
        log(f'# [VI-stream-full 2e6/B500k] {10 * ds.shape[0] / dt / 1e6:.1f}M '
            f'pts/s through the epoch-streamed fused E-step '
            f'({10 / dt:.1f} sweeps/s, data never HBM-resident)')
    finally:
        if os.path.exists(path):
            os.unlink(path)

    # ---- flagship recipe: Gibbs -> SVI super-iters -> re-anchor ----------
    from mimo_tpu.config import ILRConfig, GatingConfig, TrainConfig, \
        flagship_fit
    kr = jax.random.PRNGKey(11)
    n_rec = 1_000_000
    xr = jax.random.uniform(kr, (n_rec, 1), minval=-6., maxval=6.)
    yr = jnp.sin(xr) + 0.1 * jax.random.normal(
        jax.random.fold_in(kr, 1), (n_rec, 1))
    rec_cfg = ILRConfig(size=50, input_dim=1, output_dim=1,
                        gating=GatingConfig('stick-breaking', 5.0),
                        kappa=0.05, K_scale=1e-2)
    rec_model = rec_cfg.build()
    rec_model.init_transform(xr, yr)
    train = TrainConfig(super_iters=2, gibbs_iters=10, svi_iters=500,
                        svi_step_size=0.5, svi_batch_size=256, seed=1)
    t0 = time.time()
    rec_model, rec_state = flagship_fit(rec_model, (xr, yr), train)
    mu_p, _, _, nlpd = rec_model.predict(rec_state, xr, yr)
    rmse = float(jnp.sqrt(jnp.mean((mu_p - yr) ** 2)))
    dt = time.time() - t0
    log(f'# [recipe ILR-sine 1e6] Gibbs(10)+2x(SVI 500 B=256 + re-anchor)'
        f'+predict in {dt:.1f}s | RMSE {rmse:.4f} | mean NLPD '
        f'{float(jnp.mean(nlpd)):.4f} (compile included; '
        f'evaluate_sine.py:131-155 at 500x its N=2000)')

    # ---- continuity: N=1e6 vs reference ----------------------------------
    r6 = bench_gmm(1_000_000, K, D, ITERS, reps=2)
    log(f"# [1e6/K50/d2] VI {r6['vi_auto']:.1f} it/s "
        f"({r6['vi_auto'] / 0.011:,.0f}x ref) | Gibbs {r6['gibbs_auto']:.1f} "
        f"sw/s ({r6['gibbs_auto'] / 0.022:,.0f}x ref)")

    # ---- wide shapes ------------------------------------------------------
    r8 = bench_gmm(N, 128, 8, 50, backends=('auto', 'xla'), reps=2)
    fl = gauss_flops(N, 8, 128)
    log(f"# [1e7/K128/d8] VI auto {r8['vi_auto']:.1f} it/s "
        f"({fl*r8['vi_auto']/1e12:.2f} TFLOP/s) | "
        f"VI xla {r8['vi_xla']:.1f} | Gibbs auto {r8['gibbs_auto']:.1f} "
        f"sw/s | Gibbs xla {r8['gibbs_xla']:.1f}")

    r32 = bench_gmm(1_000_000, 256, 32, 20, backends=('auto', 'xla'),
                    gibbs=False, reps=2)
    fl = gauss_flops(1_000_000, 32, 256)
    log(f"# [1e6/K256/d32] VI auto {r32['vi_auto']:.1f} it/s "
        f"({fl*r32['vi_auto']/1e12:.2f} TFLOP/s) | "
        f"VI xla {r32['vi_xla']:.1f}")

    # ---- ILR q=8 (generic fused XLA engine) ------------------------------
    from mimo_tpu.models.ilr import BayesianILR
    kg = jax.random.PRNGKey(3)
    xs = jax.random.uniform(kg, (1_000_000, 8), minval=-3, maxval=3)
    w = jax.random.normal(jax.random.fold_in(kg, 1), (8, 1))
    ys = jnp.sin(xs @ w) + 0.1 * jax.random.normal(
        jax.random.fold_in(kg, 2), (1_000_000, 1))
    ilr = BayesianILR.make(size=50, input_dim=8, output_dim=1, alpha=2.0,
                           kappa=0.05)
    dt, (st_i, vlb_i) = best_of(
        lambda: ilr.fit_vi_fused((xs, ys), key=1, maxiter=50), reps=2)
    assert bool(jnp.isfinite(vlb_i[-1]))
    dtx, _ = best_of(
        lambda: ilr.fit_vi_fused((xs, ys), key=1, maxiter=50,
                                 backend='xla'), reps=2)
    dtg, gs_i = best_of(
        lambda: ilr.fit_gibbs_fused((xs, ys), key=2, maxiter=50), reps=2)
    assert bool(jnp.all(jnp.isfinite(gs_i.log_pi)))
    dtgx, _ = best_of(
        lambda: ilr.fit_gibbs_fused((xs, ys), key=2, maxiter=50,
                                    backend='xla'), reps=2)
    log(f'# [ILR 1e6/K50/q8] VI auto {50 / dt:.1f} it/s | VI xla '
        f'{50 / dtx:.1f} | Gibbs auto {50 / dtg:.1f} sw/s | Gibbs xla '
        f'{50 / dtgx:.1f} | ELBO {float(vlb_i[-1]):.4g}')

    # ---- ILR serving (dense predict; p=1 flagship config) -----------------
    ilr1 = BayesianILR.make(size=50, input_dim=1, output_dim=1, alpha=2.0,
                            kappa=0.05)
    n_s = 10_000_000
    xs1 = jax.random.uniform(kg, (n_s, 1), minval=-6, maxval=6)
    ys1 = jnp.sin(xs1) + 0.1 * jax.random.normal(
        jax.random.fold_in(kg, 3), (n_s, 1))
    ilr1.init_transform(xs1, ys1)
    st1, _ = ilr1.fit_vi_fused((xs1, ys1), key=1, maxiter=20)
    p1 = jax.jit(lambda s: ilr1.predict(s, xs1, ys1))

    def p10():
        for _ in range(10):
            o = p1(st1)
        return o
    dtp, _ = best_of(p10, reps=2)
    log(f'# [ILR-serve 1e7/K50/q1] {10 * n_s / dtp / 1e6:.0f}M '
        f'pts/s (predict: weights + moments + NLPD)')

    # ---- nested mixture-of-mixtures (flat M*K kernel rows) ---------------
    from mimo_tpu.models.hmix import BayesianMixtureOfMixtures
    kh = jax.random.PRNGKey(7)
    xh = jnp.concatenate([
        jax.random.normal(kh, (500_000, 2)) * 0.7 + jnp.array([-5., -4.]),
        jax.random.normal(jax.random.fold_in(kh, 1), (500_000, 2)) * 0.7
        + jnp.array([5., 4.])])
    hm = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=4, mixture_size=8, dim=2, hierarchical=False,
        kappa=0.5, psi_scale=0.5)
    dth, (hst, htr) = best_of(
        lambda: hm.fit_vi_fused(xh, key=0, maxiter=50), reps=2)
    assert bool(jnp.isfinite(htr[-1]))
    dthx, _ = best_of(
        lambda: hm.fit_vi_fused(xh, key=0, maxiter=50, backend='xla'),
        reps=2)
    dthg, hgs = best_of(
        lambda: hm.fit_gibbs_fused(xh, key=2, maxiter=50), reps=2)
    dthgx, _ = best_of(
        lambda: hm.fit_gibbs_fused(xh, key=2, maxiter=50, backend='xla'),
        reps=2)
    log(f'# [nested 1e6/M4xK8/d2] VI auto {50 / dth:.1f} it/s | VI xla '
        f'{50 / dthx:.1f} | Gibbs auto {50 / dthg:.1f} sw/s | Gibbs xla '
        f'{50 / dthgx:.1f}')

    # ---- nested MAP/EM at the north-star N=1e7 (round 4: the flat M*K
    # plug-in spec scales the last two nested engines) ---------------------
    xh7 = jnp.concatenate([
        jax.random.normal(kh, (5_000_000, 2)) * 0.7 + jnp.array([-5., -4.]),
        jax.random.normal(jax.random.fold_in(kh, 1), (5_000_000, 2)) * 0.7
        + jnp.array([5., 4.])])
    dtm7, (hm_st, hm_tr) = best_of(
        lambda: hm.fit_map_fused(xh7, key=3, maxiter=20), reps=2)
    assert bool(jnp.all(jnp.isfinite(hm_tr)))
    dte7, (he_st, he_tr) = best_of(
        lambda: hm.fit_em_fused(xh7, key=3, maxiter=20), reps=2)
    assert bool(jnp.all(jnp.isfinite(he_tr)))
    log(f'# [nested 1e7/M4xK8/d2] MAP auto {20 / dtm7:.1f} it/s | '
        f'EM auto {20 / dte7:.1f} it/s (fused plug-in M*K spec)')
    del xh7

    # ---- nested ILR serving (dense two-level predict) --------------------
    hilr = BayesianMixtureOfMixtures.make_ilr(
        cluster_size=2, mixture_size=6, input_dim=1, output_dim=1,
        kappa=0.05)
    hilr.init_transform(xs1[:200_000], ys1[:200_000])
    hst_i, _ = hilr.fit_vi((xs1[:200_000], ys1[:200_000]), key=2,
                           maxiter=30, maxsubiter=2)
    # xs1/ys1 as jit ARGUMENTS, not closed-over trace constants
    ph = jax.jit(lambda s, xs, ys: hilr.predict(
        s, xs, ys, dist='studentt')[0])

    def ph10():
        for _ in range(10):
            o = ph(hst_i, xs1, ys1)
        return o
    dtp, _ = best_of(ph10, reps=2)
    log(f'# [hilr-serve 1e7/M2xK6/q1] {10 * n_s / dtp / 1e6:.0f}M '
        f'pts/s (two-level predict: weights + moments + NLPD)')

    # ---- chain parallelism (vmapped restarts; the reference's 24-process
    # joblib pool at its own scale, evaluate_sinc_parallel.py) ------------
    from mimo_tpu.parallel.chains import fit_chains
    x5 = r6['x'][:100_000]
    m5 = BayesianGMM.make(size=16, dim=D, gating='dp', alpha=1.0,
                          kappa=0.05, psi_scale=0.5)
    chain_keys = jax.random.split(jax.random.PRNGKey(1), 16)
    rows = []
    for be in ('auto', 'xla'):       # 'auto' = the fused kernel on a GPU
        dt1, _ = best_of(lambda b=be: m5.fit_vi_fused(
            x5, key=1, maxiter=50, backend=b), reps=2)
        dt16, _ = best_of(lambda b=be: fit_chains(
            m5, 'fit_vi_fused', x5, chain_keys, maxiter=50, backend=b),
            reps=2)
        rows.append(f'{be}: 1 restart {dt1 * 1e3:.0f}ms, 16 vmapped '
                    f'{dt16 * 1e3:.0f}ms ({16 * dt1 / dt16:.1f}x '
                    f'aggregate)')
    log('# [chains 1e5/K16] ' + ' | '.join(rows))

    print(json.dumps({
        'metric': 'dpgmm_vi_iters_per_s_n1e7_k50',
        'value': round(vi_rate, 2),
        'unit': 'iters/s',
        'vs_baseline': round(vi_rate / REFERENCE_VI_ITERS_PER_S_1E7, 1),
    }))


if __name__ == '__main__':
    main()
