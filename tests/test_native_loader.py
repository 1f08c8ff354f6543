"""Tests for the native C++ data loader and the out-of-core SVI path."""

import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

HAVE_GXX = shutil.which('g++') is not None
pytestmark = pytest.mark.skipif(not HAVE_GXX, reason='no C++ toolchain')


@pytest.fixture(scope='module')
def dataset(tmp_path_factory, ):
    from mimo_tpu.io.loader import write_bin
    rng = np.random.default_rng(0)
    centers = np.array([[-4., 0.], [4., 0.], [0., 5.]])
    labels = rng.integers(0, 3, 20000)
    x = centers[labels] + rng.standard_normal((20000, 2))
    path = str(tmp_path_factory.mktemp('data') / 'toy.bin')
    write_bin(path, x)
    return path, x.astype(np.float32)


def test_open_and_gather(dataset):
    from mimo_tpu.io.loader import MmapDataset
    path, x = dataset
    ds = MmapDataset(path)
    assert ds.shape == x.shape
    idx = np.array([0, 5, 19999, 123, 5, 0])
    np.testing.assert_array_equal(ds.gather(idx), x[idx])
    np.testing.assert_array_equal(ds.read_block(100, 50), x[100:150])
    # out-of-range indices produce zero rows, not crashes
    got = ds.gather(np.array([-1, 20000]))
    assert (got == 0).all()
    ds.close()


def test_csv_roundtrip(tmp_path, dataset):
    from mimo_tpu.io.loader import MmapDataset, csv_to_bin
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((100, 3)).astype(np.float32)
    csv = tmp_path / 'data.csv'
    np.savetxt(csv, arr, delimiter=',', fmt='%.6f')
    binp = tmp_path / 'data.bin'
    rows = csv_to_bin(str(csv), str(binp))
    assert rows == 100
    ds = MmapDataset(str(binp))
    np.testing.assert_allclose(ds.read_block(0, 100), arr, atol=1e-5)
    ds.close()


def test_streaming_svi(dataset):
    """Out-of-core SVI from the mmap'd file recovers the cluster means."""
    from mimo_tpu.io.loader import MmapDataset
    from mimo_tpu.models.gmm import BayesianGMM
    path, x = dataset
    ds = MmapDataset(path)
    rng = np.random.default_rng(3)
    model = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                             kappa=0.05, psi_scale=0.5, dtype=jnp.float64)

    def next_batch(i):
        return jnp.asarray(ds.sample(rng, 512), jnp.float64)

    state = model.fit_svi_stream(next_batch, total_size=ds.shape[0],
                                 key=0, maxiter=300, step_size=0.5,
                                 batch_size=512)
    used = np.asarray(model.used_labels(state, (jnp.asarray(x, jnp.float64),)))
    est = np.asarray(state.components.mu)[used]
    for t in np.array([[-4., 0.], [4., 0.], [0., 5.]]):
        assert np.min(np.linalg.norm(est - t, axis=-1)) < 0.4
    ds.close()


def test_numpy_fallback_matches_native(dataset, tmp_path, monkeypatch):
    """MIMO_TPU_LOADER=numpy: the pure-NumPy mmap backend reads the
    native-written file bit-identically (same header + payload format),
    gathers/blocks agree, and write_bin/csv_to_bin round-trip — so
    `pip install mimo_tpu` without g++ degrades gracefully instead of
    raising OSError."""
    import mimo_tpu.io.loader as L
    path, x = dataset
    ds_native = L.MmapDataset(path)
    idx = np.asarray([0, 5, 19999, 7, 7], np.int64)
    g_native = ds_native.gather(idx)
    b_native = ds_native.read_block(100, 64)
    ds_native.close()

    monkeypatch.setenv('MIMO_TPU_LOADER', 'numpy')
    monkeypatch.setattr(L, '_lib', None)       # drop the cached handle
    monkeypatch.setattr(L, '_warned', False, raising=False)
    with pytest.warns(RuntimeWarning, match='NumPy'):
        ds_np = L.MmapDataset(path)
    assert ds_np.shape == (20000, 2)
    np.testing.assert_array_equal(ds_np.gather(idx), g_native)
    np.testing.assert_array_equal(ds_np.read_block(100, 64), b_native)
    with pytest.raises(IndexError):
        ds_np.gather(np.asarray([20000], np.int64))
    # fallback write_bin -> native open (format identity, other way)
    p2 = str(tmp_path / 'np_written.bin')
    L.write_bin(p2, x[:100])
    csvp = str(tmp_path / 't.csv')
    np.savetxt(csvp, x[:50], delimiter=',', fmt='%.6f')
    assert L.csv_to_bin(csvp, str(tmp_path / 't.bin')) == 50
    ds_np.close()
    monkeypatch.delenv('MIMO_TPU_LOADER')
    monkeypatch.setattr(L, '_lib', None)
    ds2 = L.MmapDataset(p2)                    # native reads numpy-written
    np.testing.assert_array_equal(ds2.read_block(0, 100), x[:100])
    ds2.close()


def test_prefetcher_order_and_errors():
    """Prefetcher yields items in order and re-raises producer errors."""
    from mimo_tpu.io.stream import Prefetcher
    with Prefetcher(lambda i: i * i, 10, depth=2) as pf:
        assert list(pf) == [i * i for i in range(10)]

    def boom(i):
        if i == 3:
            raise ValueError('bad block')
        return i

    got = []
    with pytest.raises(ValueError, match='bad block'):
        with Prefetcher(boom, 10, depth=2) as pf:
            for v in pf:
                got.append(v)
    assert got == [0, 1, 2]


def test_stream_full_equals_in_memory(dataset):
    """Epoch-streamed full-data VI over MmapDataset blocks equals the
    in-memory fused engine EXACTLY (statistics additivity): same init,
    same block partitioning -> identical posterior and ELBO trace."""
    from mimo_tpu.io.loader import MmapDataset
    from mimo_tpu.models.gmm import BayesianGMM
    path, x = dataset
    ds = MmapDataset(path)
    n = ds.shape[0]
    b = 4000
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    xj = jnp.asarray(x, jnp.float64)
    st0, _ = m.fit_vi_fused(xj, key=1, maxiter=1, block_size=b,
                            backend='xla')
    ref, vr = m.fit_vi_fused(xj, key=1, maxiter=8, block_size=b,
                             init_state=st0, randomize=False,
                             backend='xla')

    def read_block(i):
        return ds.read_block(i * b, b).astype(np.float64)

    st, vs = m.fit_vi_stream_full(read_block, n // b, maxiter=8,
                                  init_state=st0, block_size=b,
                                  backend='xla')
    for a, c in zip(jax.tree.leaves(ref), jax.tree.leaves(st)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(vr)[:len(vs)], vs, rtol=1e-9)
    ds.close()


def test_stream_full_map_em(dataset):
    """Out-of-core MAP equals the in-memory fused MAP given the same
    init (statistics additivity); out-of-core EM (block-0 anchor init)
    recovers the cluster means from disk blocks."""
    from mimo_tpu.io.loader import MmapDataset
    from mimo_tpu.models.gmm import BayesianGMM
    path, x = dataset
    ds = MmapDataset(path)
    b = 4000
    n_blocks = ds.shape[0] // b
    m = BayesianGMM.make(size=6, dim=2, gating='dirichlet', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    xj = jnp.asarray(x, jnp.float64)

    def read_block(i):
        return ds.read_block(i * b, b).astype(np.float64)

    st0, _ = m.fit_vi_fused(xj, key=1, maxiter=1, block_size=b,
                            backend='xla')
    # in-memory MAP has no warm-start arg; replicate its sweep by
    # comparing the streamed engine against a second streamed run built
    # from in-memory blocks (device-resident slices) — same code path as
    # fit_map_fused's sweep given identical stats.
    stm, lm = m.fit_map_stream_full(read_block, n_blocks, init_state=st0,
                                    maxiter=12, block_size=b,
                                    backend='xla')
    stm2, lm2 = m.fit_map_stream_full(
        lambda i: np.asarray(x[i * b:(i + 1) * b], np.float64), n_blocks,
        init_state=st0, maxiter=12, block_size=b, backend='xla')
    assert np.isfinite(lm).all() and lm[2] < lm[-1]
    np.testing.assert_allclose(lm, lm2, rtol=1e-9)
    for a, c in zip(jax.tree.leaves(stm), jax.tree.leaves(stm2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   rtol=1e-9, atol=1e-12)

    ste, le = m.fit_em_stream_full(read_block, n_blocks, key=3,
                                   maxiter=25, block_size=b,
                                   backend='xla')
    assert np.isfinite(le).all() and le[2] < le[-1]
    mu = np.asarray(ste.params.mu)
    for t in np.array([[-4., 0.], [4., 0.], [0., 5.]]):
        assert np.min(np.linalg.norm(mu - t, axis=-1)) < 0.3
    ds.close()


def test_stream_full_pallas_and_ilr(dataset, tmp_path):
    """Epoch streaming through (a) the fused kernel path (interpret
    mode on CPU) and (b) a two-array ILR dataset — the generic engine
    handles tuple blocks and every backend."""
    from mimo_tpu.io.loader import MmapDataset, write_bin
    from mimo_tpu.models.gmm import BayesianGMM
    from mimo_tpu.models.ilr import BayesianILR
    path, x = dataset
    ds = MmapDataset(path)
    b = 4000
    nb = ds.shape[0] // b

    # (a) kernel == xla backend (f32; interpret-mode kernel)
    m = BayesianGMM.make(size=8, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float32)
    rb32 = lambda i: ds.read_block(i * b, b)
    st0, _ = m.fit_vi_stream_full(rb32, nb, key=1, maxiter=1,
                                  backend='xla')
    stx, vx = m.fit_vi_stream_full(rb32, nb, init_state=st0, maxiter=4,
                                   backend='xla')
    stp, vp = m.fit_vi_stream_full(rb32, nb, init_state=st0, maxiter=4,
                                   backend='interpret')
    np.testing.assert_allclose(vx, vp, rtol=2e-4)
    np.testing.assert_allclose(np.asarray(stx.components.mu),
                               np.asarray(stp.components.mu),
                               rtol=1e-3, atol=1e-3)
    ds.close()

    # (b) ILR: (x, y) blocks from two mmap files
    rng = np.random.default_rng(5)
    xi = rng.uniform(-6, 6, (12000, 1)).astype(np.float32)
    yi = (np.sin(xi) + 0.1 * rng.standard_normal((12000, 1))
          ).astype(np.float32)
    px = str(tmp_path / 'ix.bin')
    py = str(tmp_path / 'iy.bin')
    write_bin(px, xi)
    write_bin(py, yi)
    dx, dy = MmapDataset(px), MmapDataset(py)
    bi = 3000
    nbi = 12000 // bi

    def read_xy(i):
        return (dx.read_block(i * bi, bi).astype(np.float64),
                dy.read_block(i * bi, bi).astype(np.float64))

    mi = BayesianILR.make(size=10, input_dim=1, output_dim=1, alpha=2.0,
                          kappa=0.05, dtype=jnp.float64)
    xj = jnp.asarray(xi, jnp.float64)
    yj = jnp.asarray(yi, jnp.float64)
    sti0, _ = mi.fit_vi_fused((xj, yj), key=1, maxiter=1, block_size=bi,
                              backend='xla')
    ref, vr = mi.fit_vi_fused((xj, yj), key=1, maxiter=6, block_size=bi,
                              init_state=sti0, randomize=False,
                              backend='xla')
    sti, vs = mi.fit_vi_stream_full(read_xy, nbi, init_state=sti0,
                                    maxiter=6, block_size=bi,
                                    backend='xla')
    np.testing.assert_allclose(np.asarray(vr)[:len(vs)], vs, rtol=1e-9)
    for a, c in zip(jax.tree.leaves(ref), jax.tree.leaves(sti)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                   rtol=1e-9, atol=1e-12)
    dx.close()
    dy.close()


def test_stream_transfer_dtype_bf16(dataset):
    """transfer_dtype=bfloat16: halved-wire streaming stays close to the
    full-width result (wire rounding adds only per-point random feature
    noise, which averages out of the N-summed statistics)."""
    from mimo_tpu.io.loader import MmapDataset
    from mimo_tpu.models.gmm import BayesianGMM
    path, x = dataset
    ds = MmapDataset(path)
    b = 4000
    nb = ds.shape[0] // b
    m = BayesianGMM.make(size=6, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float32)
    rb = lambda i: ds.read_block(i * b, b)
    st0, _ = m.fit_vi_stream_full(rb, nb, key=1, maxiter=1)
    stf, vf = m.fit_vi_stream_full(rb, nb, init_state=st0, maxiter=6)
    stb, vb = m.fit_vi_stream_full(rb, nb, init_state=st0, maxiter=6,
                                   transfer_dtype=jnp.bfloat16)
    np.testing.assert_allclose(vf, vb, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(stf.components.mu),
                               np.asarray(stb.components.mu),
                               atol=5e-3)
    st = m.fit_svi_stream(lambda i: ds.sample(np.random.default_rng(i),
                                              512),
                          total_size=ds.shape[0], key=2, maxiter=60,
                          step_size=0.4, batch_size=512,
                          transfer_dtype=jnp.bfloat16)
    assert bool(jnp.all(jnp.isfinite(st.components.mu)))
    ds.close()
