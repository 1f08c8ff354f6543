"""Multi-device tests on the virtual 8-device CPU mesh: sharded runs must
equal replicated runs (the fake-backend layer the reference lacks,
SURVEY.md §4 item 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mimo_tpu.distributions.niw import GaussParams
from mimo_tpu.models.gmm import BayesianGMM
from mimo_tpu.models.ilr import BayesianILR
from mimo_tpu.models.mixture import MFState
from mimo_tpu.parallel.mesh import make_mesh, shard_data, data_parallel_fit


@pytest.fixture(scope='module')
def data():
    key = jax.random.PRNGKey(3)
    mu = jnp.array([[-4., 0.], [4., 0.], [0., 5.]], dtype=jnp.float64)
    lm = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float64) * 2.0, (3, 2, 2))
    x, _ = BayesianGMM.generate(key, GaussParams(mu, lm),
                                jnp.array([.3, .4, .3]), 4096)
    return x.astype(jnp.float64)


def test_eight_devices_present():
    assert len(jax.devices()) == 8


def test_vi_sharded_equals_replicated(data):
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    ref_state, ref_vlb = m.fit_vi(data, key=1, maxiter=40)

    m2 = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                          kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    sh_state, sh_vlb = data_parallel_fit(m2, 'fit_vi', data, key=1,
                                         maxiter=40)
    np.testing.assert_allclose(np.asarray(sh_vlb), np.asarray(ref_vlb),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(sh_state.components.mu),
                               np.asarray(ref_state.components.mu), rtol=1e-8)


def test_gibbs_sharded_runs(data):
    """Gibbs with sharded data: same program, sharded labels; check shapes
    and cluster mass (exact label equality isn't expected: sampling)."""
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    state = data_parallel_fit(m, 'fit_gibbs', data, key=2, maxiter=60)
    counts = np.bincount(np.asarray(state.labels), minlength=8)
    assert counts.sum() == data.shape[0]
    assert np.sort(counts)[-4:].sum() > 0.8 * data.shape[0]


def test_suffstats_psum_equivalence(data):
    """Sharded sufficient statistics == replicated (the core reduction)."""
    from mimo_tpu.distributions.niw import suff_stats
    mesh = make_mesh()
    resp = jax.random.uniform(jax.random.PRNGKey(0),
                              (data.shape[0], 8), dtype=jnp.float64)
    want = suff_stats(data, resp)
    xs = shard_data(mesh, data)
    rs = shard_data(mesh, resp)
    got = jax.jit(suff_stats)(xs, rs)
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9)


def test_vi_fused_sharded_equals_unsharded(data):
    """shard_map fused E-step (psum'd stats accumulator) == single-device
    fused E-step; only the block accumulation order differs."""
    mesh = make_mesh()
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    ref_state, ref_vlb = m.fit_vi_fused(data, key=1, maxiter=40,
                                        block_size=512)
    xs = shard_data(mesh, data)
    sh_state, sh_vlb = m.fit_vi_fused(xs, key=1, maxiter=40,
                                      block_size=512, mesh=mesh)
    np.testing.assert_allclose(np.asarray(sh_vlb), np.asarray(ref_vlb),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(sh_state.components.mu),
                               np.asarray(ref_state.components.mu), rtol=1e-8)


def test_gibbs_fused_sharded_runs(data):
    """shard_map fused Gibbs: device-local labels + psum'd one-hot stats.
    Labels use per-device folded PRNG streams, so only check mass/recovery."""
    mesh = make_mesh()
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    xs = shard_data(mesh, data)
    state = m.fit_gibbs_fused(xs, key=2, maxiter=60, block_size=512,
                              mesh=mesh)
    counts = np.bincount(np.asarray(state.labels), minlength=8)
    assert counts.sum() == data.shape[0]
    assert np.sort(counts)[-4:].sum() > 0.8 * data.shape[0]
    assert bool(jnp.all(jnp.isfinite(state.components.mu)))


def test_chain_and_data_axes_together(data):
    """2x4 mesh: restarts sharded over 'chain' AND points over 'data' in
    one program — results equal the fully replicated run."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mimo_tpu.parallel.chains import fit_chains, best_of
    mesh = make_mesh(n_chain=2)
    assert mesh.shape == {'chain': 2, 'data': 4}
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(9), 4)
    ref_states, ref_vlbs = fit_chains(m, 'fit_vi', data, keys, maxiter=25)

    keys_sh = jax.device_put(keys, NamedSharding(mesh, P('chain')))
    data_sh = jax.device_put(data, NamedSharding(mesh, P('data')))
    sh_states, sh_vlbs = fit_chains(m, 'fit_vi', data_sh, keys_sh,
                                    maxiter=25)
    np.testing.assert_allclose(np.asarray(sh_vlbs), np.asarray(ref_vlbs),
                               rtol=1e-8)
    _, best_ref = best_of(ref_states, ref_vlbs)
    _, best_sh = best_of(sh_states, sh_vlbs)
    assert int(best_ref) == int(best_sh)


def test_ilr_sharded_vi(data):
    rng = np.random.default_rng(0)
    n = 2048
    x = jnp.asarray(rng.uniform(-6, 6, (n, 1)))
    y = jnp.asarray(np.sin(np.asarray(x)) + 0.1 * rng.standard_normal((n, 1)))
    m = BayesianILR.make(size=10, input_dim=1, output_dim=1, alpha=2.0,
                         kappa=0.05, dtype=jnp.float64)
    ref_state, ref_vlb = m.fit_vi((x, y), key=1, maxiter=30)

    m2 = BayesianILR.make(size=10, input_dim=1, output_dim=1, alpha=2.0,
                          kappa=0.05, dtype=jnp.float64)
    sh_state, sh_vlb = data_parallel_fit(m2, 'fit_vi', (x, y), key=1,
                                         maxiter=30)
    np.testing.assert_allclose(np.asarray(sh_vlb), np.asarray(ref_vlb),
                               rtol=1e-7)


def test_hmix_fused_vi_sharded_equals_unsharded():
    """Nested fused VI under shard_map == single-device nested fused VI."""
    from mimo_tpu.models.hmix import BayesianMixtureOfMixtures
    rng = np.random.default_rng(0)

    def blob(c, n):
        return c + 0.5 * rng.standard_normal((n, 2))

    x = np.vstack([blob([-5, -5], 1024), blob([5, 5], 1024)])
    x = jnp.asarray(x[rng.permutation(2048)], jnp.float64)
    mesh = make_mesh()
    m = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=2, mixture_size=3, dim=2, hierarchical=False,
        kappa=0.5, psi_scale=0.5, means=[[-5, -5], [5, 5]],
        dtype=jnp.float64)
    ref_state, ref_vlb = m.fit_vi_fused(x, key=0, maxiter=30,
                                        block_size=256)
    xs = shard_data(mesh, x)
    sh_state, sh_vlb = m.fit_vi_fused(xs, key=0, maxiter=30,
                                      block_size=256, mesh=mesh)
    np.testing.assert_allclose(np.asarray(sh_vlb), np.asarray(ref_vlb),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(sh_state.components.mu),
                               np.asarray(ref_state.components.mu),
                               rtol=1e-8)


def test_hmix_fused_gibbs_sharded_runs():
    """Nested fused Gibbs under shard_map: device-local labels, psum'd
    flat stats; cluster mass and separation only (per-device streams)."""
    from collections import Counter
    from mimo_tpu.models.hmix import BayesianMixtureOfMixtures
    rng = np.random.default_rng(0)

    def blob(c, n):
        return c + 0.5 * rng.standard_normal((n, 2))

    x = np.vstack([blob([-5, -5], 1024), blob([5, 5], 1024)])
    xp = x[rng.permutation(2048)]
    x = jnp.asarray(xp, jnp.float64)
    mesh = make_mesh()
    m = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=2, mixture_size=3, dim=2, hierarchical=False,
        kappa=0.5, psi_scale=0.5, means=[[-5, -5], [5, 5]],
        dtype=jnp.float64)
    xs = shard_data(mesh, x)
    gs = m.fit_gibbs_fused(xs, key=3, maxiter=40, block_size=256,
                           mesh=mesh)
    lab = np.asarray(gs.labels)
    assert lab.shape == (2048,)
    left = xp[:, 0] < 0
    l_major = Counter(lab[left].tolist()).most_common(1)[0]
    r_major = Counter(lab[~left].tolist()).most_common(1)[0]
    assert l_major[0] != r_major[0]
    assert l_major[1] > 950 and r_major[1] > 950


def test_vi_pallas_sharded_equals_unsharded(data):
    """The fused kernel inside shard_map (interpret mode on the CPU
    mesh): per-device kernel E-step + psum'd (K, m) accumulator must
    match both the single-device kernel run and the XLA engine. Each
    device's 500 rows end in a partial tile, so the kernel's tail
    masking is exercised too."""
    x = data[:4000].astype(jnp.float32)
    mesh = make_mesh()
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float32)
    ref_state, ref_vlb = m.fit_vi_fused(x, key=1, maxiter=25,
                                        backend='interpret')
    xla_state, xla_vlb = m.fit_vi_fused(x, key=1, maxiter=25,
                                        backend='xla')
    xs = shard_data(mesh, x)
    sh_state, sh_vlb = m.fit_vi_fused(xs, key=1, maxiter=25,
                                      backend='interpret', mesh=mesh)
    np.testing.assert_allclose(np.asarray(sh_vlb), np.asarray(ref_vlb),
                               rtol=2e-5)
    np.testing.assert_allclose(np.asarray(sh_vlb), np.asarray(xla_vlb),
                               rtol=2e-5)
    np.testing.assert_allclose(np.asarray(sh_state.components.mu),
                               np.asarray(ref_state.components.mu),
                               atol=1e-4)


def test_gibbs_pallas_sharded_runs(data):
    """The fused Gibbs kernel under shard_map (per-device uniform
    streams, interpret mode): labels are device-local, one-hot stats are
    psum'd and must be consistent with the returned labels' cluster
    mass."""
    x = data[:4000].astype(jnp.float32)
    mesh = make_mesh()
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float32)
    xs = shard_data(mesh, x)
    state = m.fit_gibbs_fused(xs, key=2, maxiter=40, backend='interpret',
                              mesh=mesh)
    counts = np.bincount(np.asarray(state.labels), minlength=8)
    assert counts.sum() == 4000
    assert np.sort(counts)[-4:].sum() > 0.8 * 4000
    assert bool(jnp.all(jnp.isfinite(state.components.mu)))


def test_ilr_pallas_sharded_equals_unsharded():
    """Mixtures of linear experts through the kernel inside shard_map
    match the single-device kernel run."""
    rng = np.random.default_rng(0)
    n = 2000                                 # odd vs 8*block: masked tails
    x = jnp.asarray(rng.uniform(-3, 3, (n, 1)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x))
                    + 0.1 * rng.standard_normal((n, 1)), jnp.float32)
    mesh = make_mesh()
    m = BayesianILR.make(size=8, input_dim=1, output_dim=1, alpha=2.0,
                         kappa=0.05, dtype=jnp.float32)
    m.init_transform(x, y)
    ref_vlb = m.fit_vi_fused((x, y), key=1, maxiter=10,
                             backend='interpret')[1]
    xys = shard_data(mesh, x), shard_data(mesh, y)
    sh_vlb = m.fit_vi_fused(xys, key=1, maxiter=10, backend='interpret',
                            mesh=mesh)[1]
    np.testing.assert_allclose(np.asarray(sh_vlb), np.asarray(ref_vlb),
                               rtol=5e-5)


def test_hmix_pallas_sharded_equals_unsharded():
    """Nested fused VI through the kernel (flat M*K rows) inside
    shard_map matches the single-device kernel run."""
    from mimo_tpu.models.hmix import BayesianMixtureOfMixtures
    rng = np.random.default_rng(0)

    def blob(c, n):
        return c + 0.5 * rng.standard_normal((n, 2))

    x = np.vstack([blob([-5, -5], 1000), blob([5, 5], 1000)])
    x = jnp.asarray(x[rng.permutation(2000)], jnp.float32)
    mesh = make_mesh()
    m = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=2, mixture_size=3, dim=2, hierarchical=False,
        kappa=0.5, psi_scale=0.5, means=[[-5, -5], [5, 5]],
        dtype=jnp.float32)
    ref_vlb = m.fit_vi_fused(x, key=0, maxiter=10, backend='interpret')[1]
    xs = shard_data(mesh, x)
    sh_vlb = m.fit_vi_fused(xs, key=0, maxiter=10, backend='interpret',
                            mesh=mesh)[1]
    np.testing.assert_allclose(np.asarray(sh_vlb), np.asarray(ref_vlb),
                               rtol=2e-5)
    gs = m.fit_gibbs_fused(xs, key=3, maxiter=10, backend='interpret',
                           mesh=mesh)
    assert np.asarray(gs.labels).shape == (2000,)


def test_svi_sharded_runs_and_recovers(data):
    """Sharded SVI: per-device stratified minibatches + psum'd stats.
    Not bitwise-comparable to the unsharded run (different sampling), so
    check recovery: posterior component means must land near the true
    cluster centers."""
    mesh = make_mesh()
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    xs = shard_data(mesh, data)
    st, _ = m.fit_svi(xs, key=4, maxiter=300, step_size=0.5,
                      batch_size=512, mesh=mesh)
    assert np.isfinite(np.asarray(st.components.mu)).all()
    # every true center has a recovered component nearby
    centers = np.array([[-4., 0.], [4., 0.], [0., 5.]])
    mu = np.asarray(st.components.mu)
    for c in centers:
        assert np.min(np.linalg.norm(mu - c, axis=-1)) < 0.5


def test_map_em_fused_sharded_equals_unsharded(data):
    """The plug-in fused engines (fit_map_fused / fit_em_fused, round 3)
    take the same shard_map path as VI: psum'd stats must reproduce the
    single-device run exactly (f64; only block summation order differs)."""
    mesh = make_mesh()
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    ref_state, ref_ll = m.fit_map_fused(data, key=1, maxiter=30,
                                        block_size=512)
    xs = shard_data(mesh, data)
    sh_state, sh_ll = m.fit_map_fused(xs, key=1, maxiter=30,
                                      block_size=512, mesh=mesh)
    np.testing.assert_allclose(np.asarray(sh_ll), np.asarray(ref_ll),
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(sh_state.components.mu),
                               np.asarray(ref_state.components.mu),
                               rtol=1e-8)

    m2 = BayesianGMM.make(size=6, dim=2, dtype=jnp.float64)
    ref_em, ref_tr = m2.fit_em_fused(data, key=0, maxiter=30,
                                     block_size=512)
    sh_em, sh_tr = m2.fit_em_fused(xs, key=0, maxiter=30, block_size=512,
                                   mesh=mesh)
    np.testing.assert_allclose(np.asarray(sh_tr), np.asarray(ref_tr),
                               rtol=1e-8)


def test_log_predictive_sharded_kernel_equals_dense(data):
    """Data-parallel serving: log_predictive on data sharded over the
    mesh (the dense path under GSPMD) matches the replicated call per
    point."""
    mesh = make_mesh()
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    st, _ = m.fit_vi_fused(data, key=1, maxiter=20, block_size=512)
    lp_dense = m.log_predictive(st, data)
    lp_mesh = m.log_predictive(st, shard_data(mesh, data))
    np.testing.assert_allclose(np.asarray(lp_mesh), np.asarray(lp_dense),
                               rtol=1e-10, atol=1e-10)


def test_hmix_log_predictive_sharded_kernel_equals_dense():
    """Nested mixtures: sharded serving == replicated dense serving."""
    from mimo_tpu.models.hmix import BayesianMixtureOfMixtures
    key = jax.random.PRNGKey(0)
    x = jnp.concatenate([
        jax.random.normal(key, (1024, 2)) * 0.7 + jnp.array([-5., -4.]),
        jax.random.normal(jax.random.fold_in(key, 1), (1024, 2)) * 0.7
        + jnp.array([5., 4.])]).astype(jnp.float64)
    hm = BayesianMixtureOfMixtures.make_gmm(
        cluster_size=2, mixture_size=3, dim=2, hierarchical=False,
        kappa=0.5, psi_scale=0.5, dtype=jnp.float64)
    st, _ = hm.fit_vi_fused(x, key=0, maxiter=20, block_size=512)
    lp_dense = hm.log_predictive(st, x)
    lp_mesh = hm.log_predictive(st, shard_data(make_mesh(), x))
    np.testing.assert_allclose(np.asarray(lp_mesh), np.asarray(lp_dense),
                               rtol=1e-10, atol=1e-10)


def test_ilr_predict_sharded_kernel_equals_dense():
    """Data-parallel ILR serving: predict on sharded inputs matches the
    replicated path — p=1 and p>1."""
    from mimo_tpu.models.ilr import BayesianILR
    rng = np.random.default_rng(23)
    mesh = make_mesh()
    n = 1600
    x = jnp.asarray(rng.uniform(-5, 5, (n, 1)), jnp.float64)
    y = jnp.asarray(np.sin(np.asarray(x))
                    + 0.1 * rng.standard_normal((n, 1)), jnp.float64)
    xs = shard_data(mesh, x)
    for p in (1, 3):
        yp = jnp.concatenate([y * (j + 1) for j in range(p)], axis=1)
        m = BayesianILR.make(size=10, input_dim=1, output_dim=p, alpha=2.0,
                             kappa=0.05, dtype=jnp.float64)
        m.init_transform(x, yp)
        st, _ = m.fit_vi((x, yp), key=1, maxiter=30)
        d_out = m.predict(st, x, yp)
        k_out = m.predict(st, xs, shard_data(mesh, yp))
        for a, b in zip(k_out[:2] + (k_out[3],), d_out[:2] + (d_out[3],)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-9, atol=1e-9)


# -- communication contract (the README pod-scaling claim, asserted) --------

def _collective_payloads(hlo_text):
    """[(instruction_line, [elem_counts...], in_loop_body), ...] for every
    collective instruction in a compiled HLO module."""
    import re
    out = []
    for line in hlo_text.splitlines():
        if not re.search(
                r'\b(all-reduce|all-gather|reduce-scatter|'
                r'collective-permute|all-to-all)(-start)?\(', line):
            continue
        head = re.split(r'\b(?:all-reduce|all-gather|reduce-scatter|'
                        r'collective-permute|all-to-all)(?:-start)?\(',
                        line)[0]
        shapes = re.findall(r'[a-z]\d+\[([\d,]*)\]', head)
        elems = [int(np.prod([int(v) for v in s.split(',') if v] or [1]))
                 for s in shapes]
        out.append((line.strip(), elems, 'while/body' in line))
    return out


def _lower_and_check(model, fit_name, checks_n, make_args, k, m_stats,
                     trace_key):
    """Lower the fit at two different N; assert (a) exactly one
    while-body all-reduce (the (K, m) stats psum), (b) every collective
    payload is tiny and INDEPENDENT of N, (c) no collective's operand
    scales with the data size."""
    payload_sets = []
    for n in checks_n:
        model._cache.clear()           # force a fresh lowering per N
        model._capture_lowered = {}
        args = make_args(n)
        getattr(model, fit_name)(*args[0], **args[1])
        low = model._capture_lowered[trace_key]
        colls = _collective_payloads(low.compile().as_text())
        assert colls, f'{fit_name}: no collective found — not sharded?'
        body = [c for c in colls if c[2]]
        # the contract: ONE all-reduce per sweep, stats-sized
        assert len(body) == 1, \
            f'{fit_name}@N={n}: expected exactly 1 while-body ' \
            f'all-reduce, got {len(body)}:\n' + '\n'.join(
                c[0][:200] for c in body)
        assert 'all-reduce' in body[0][0]
        per_dev_n = n // 8
        for line, elems, _ in colls:
            assert max(elems) < per_dev_n, \
                f'{fit_name}@N={n}: collective payload {max(elems)} ' \
                f'scales with data ({line[:160]})'
            assert max(elems) <= 4 * k * m_stats + 8, \
                f'{fit_name}@N={n}: payload {max(elems)} > O(K*m) ' \
                f'({line[:160]})'
        payload_sets.append(sorted(sum((e for _, e, _ in colls), [])))
    assert payload_sets[0] == payload_sets[1], \
        f'{fit_name}: collective payloads changed with N — ' \
        f'{payload_sets[0]} vs {payload_sets[1]}'
    model._capture_lowered = None


def test_communication_contract_vi_gibbs_svi():
    """Compiled-HLO assertion of the pod-scaling contract (README
    multi-host section): each sharded sweep's ONLY cross-device traffic
    is one all-reduce of the K x m statistics accumulator (+O(K)
    scalars); nothing N-sized ever crosses the mesh, at any N. A
    regression that silently adds an N-sized all-gather fails here even
    though every equality test would still pass."""
    mesh = make_mesh()
    kk, d = 8, 2
    m_stats = d * d + d + 3    # GaussStats leaves + lse + counts, packed
    rng = np.random.default_rng(0)

    def model():
        return BayesianGMM.make(size=kk, dim=d, gating='dp', alpha=1.0,
                                kappa=0.05, psi_scale=0.5,
                                dtype=jnp.float64)

    def vi_args(n):
        xs = shard_data(mesh, rng.normal(size=(n, d)))
        return ((xs,), dict(key=1, maxiter=3, block_size=n // 16,
                            mesh=mesh, backend='xla'))

    _lower_and_check(model(), 'fit_vi_fused', (32768, 65536), vi_args,
                     kk, m_stats, 'vi_fused')
    _lower_and_check(model(), 'fit_gibbs_fused', (32768, 65536), vi_args,
                     kk, m_stats, 'gibbs_fused')

    def svi_args(n):
        xs = shard_data(mesh, rng.normal(size=(n, d)))
        return ((xs,), dict(key=1, maxiter=3, batch_size=512, mesh=mesh))

    _lower_and_check(model(), 'fit_svi', (32768, 65536), svi_args,
                     kk, m_stats, 'svi')
