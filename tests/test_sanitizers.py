"""Numerical sanitizers (SURVEY.md §5 'race detection' analogue): the
reference guards with NaN row-dropping (gaussian.py:191-192), np.seterr
wraps (gmm.py:352-354) and probability clips (bayesian.py:75). Here the
equivalents are static-shape zero-weight masking plus jnp.clip, and this
module is the jax_debug_nans-gated CI job the survey calls for: whole
fits run with the NaN debugger armed, so any non-finite intermediate
fails loudly instead of silently corrupting the posterior.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mimo_tpu.distributions.niw import GaussParams
from mimo_tpu.models.gmm import BayesianGMM
from mimo_tpu.utils.data import nan_mask


@pytest.fixture(scope='module')
def data():
    key = jax.random.PRNGKey(7)
    mu = jnp.array([[-4., 0.], [4., 0.]], dtype=jnp.float64)
    lm = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float64), (2, 2, 2))
    x, _ = BayesianGMM.generate(key, GaussParams(mu, lm),
                                jnp.array([.5, .5]), 512)
    return x.astype(jnp.float64)


@pytest.fixture
def debug_nans():
    jax.config.update('jax_debug_nans', True)
    yield
    jax.config.update('jax_debug_nans', False)


def test_vi_under_debug_nans(data, debug_nans):
    m = BayesianGMM.make(size=4, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    # fresh model object: cached jitted fits would bypass the nan checker
    state, vlb = m.fit_vi(data, key=1, maxiter=15)
    assert bool(jnp.isfinite(vlb[-1]))


def test_gibbs_under_debug_nans(data, debug_nans):
    m = BayesianGMM.make(size=4, dim=2, gating='dp', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    state = m.fit_gibbs(data, key=2, maxiter=15)
    assert int(jnp.sum(jnp.bincount(state.labels, length=4))) == 512


def test_nan_mask_equals_row_dropping(data):
    """Zero-weight masked fit == fit on the clean subset (the reference's
    boolean-indexing semantics, gaussian.py:191-192, with static shapes)."""
    x = np.asarray(data).copy()
    x[::7] = np.nan                                  # corrupt 74 rows
    clean = jnp.asarray(x[~np.isnan(x).any(axis=1)])
    xm, w = nan_mask(jnp.asarray(x))
    assert float(jnp.sum(w)) == clean.shape[0]

    m = BayesianGMM.make(size=4, dim=2, gating='dirichlet', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    # one masked VI sweep from identical responsibilities
    st_masked = m._mf_update((xm,), jnp.full((x.shape[0], 4), 0.25,
                                             jnp.float64), point_weights=w)
    st_clean = m._mf_update((clean,), jnp.full((clean.shape[0], 4), 0.25,
                                               jnp.float64))
    np.testing.assert_allclose(np.asarray(st_masked.components.mu),
                               np.asarray(st_clean.components.mu), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(st_masked.components.psi),
                               np.asarray(st_clean.components.psi), rtol=1e-12)


def test_clip_guards_extreme_gating(data):
    """Degenerate stick-breaking draws stay finite (bayesian.py:75 clip)."""
    m = BayesianGMM.make(size=32, dim=2, gating='dp', alpha=1e-6,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    state = m.fit_gibbs(data, key=3, maxiter=10)
    assert bool(jnp.all(jnp.isfinite(state.log_pi)))


def test_stick_breaking_kl_finite_at_huge_counts():
    """f32 cancellation in the exclusive reverse-cumsum (total - cumsum)
    can make the LAST accumulated count slightly negative at counts ~ 1e7,
    driving the Beta posterior's delta below 0 and the stick KL to NaN
    (digamma(-1)); _reverse_cumsum_exclusive must clamp at 0."""
    from mimo_tpu.distributions.gating import (StickBreaking,
                                               _reverse_cumsum_exclusive)
    # counts engineered so the f32 running sums disagree in the last slot
    counts = jnp.asarray(
        np.r_[np.full(49, 199944.39), 173269.0], jnp.float32)
    acc = _reverse_cumsum_exclusive(counts)
    assert float(acc[-1]) == 0.0
    assert bool(jnp.all(acc >= 0.0))
    prior = StickBreaking.standard(50, 1.0, jnp.float32)
    post = prior.update(counts)
    assert bool(jnp.all(post.delta >= prior.delta))
    assert bool(jnp.isfinite(post.kl_divergence(prior)))


def test_fused_engines_nan_workflow_via_compaction(data):
    """The big-N NaN workflow for the FUSED engines: compact NaN rows
    host-side (nan_mask -> boolean drop, a one-time preprocessing cost)
    and run the fused engine on the clean subset — the fused paths
    accept any N (a tail mask, or a block dividing N), so no
    point_weights plumbing is needed in the kernels. Statistics equality: fused
    E-step on the compacted data == dense weighted suff_stats on the
    full data with zero weights on NaN rows."""
    from mimo_tpu.ops.family_estep import fused_estep_blockwise

    x = np.asarray(data).copy()
    x[::7] = np.nan
    xj = jnp.asarray(x)
    xm, w = nan_mask(xj)
    clean = jnp.asarray(x[~np.isnan(x).any(axis=1)])

    m = BayesianGMM.make(size=4, dim=2, gating='dirichlet', alpha=1.0,
                         kappa=0.05, psi_scale=0.5, dtype=jnp.float64)
    resp = jnp.full((x.shape[0], 4), 0.25, jnp.float64)
    st = m._mf_update((xm,), resp, point_weights=w)

    # dense weighted stats on the full array (masked rows zero-weight)
    resp_w = resp * w[:, None]
    stats_dense = m.family.suff_stats((xm,), resp_w)

    # fused E-step on the COMPACTED array at a fixed state
    spec = m._estep_spec()
    log_pi = st.gating.expected_log_pi()
    res = fused_estep_blockwise(spec, st.components, log_pi,
                                (clean,), block_size=73)
    # same state's dense E-step on the compacted array: responsibilities
    # then stats — both must equal (the engines' per-sweep quantities)
    resp_c = m.expected_responsibilities(st, (clean,))
    stats_c = m.family.suff_stats((clean,), resp_c)
    for a, b in zip(jax.tree.leaves(res.stats), jax.tree.leaves(stats_c)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-9)
    # and a full fused fit on the compacted subset runs and converges
    st2, vlb = m.fit_vi_fused(clean, key=1, maxiter=20, block_size=73)
    assert bool(jnp.isfinite(vlb[-1]))
    # first-sweep stat totals: compacted fused == dense masked (both
    # count exactly sum(w) effective points)
    assert np.isclose(float(jnp.sum(res.counts)), float(jnp.sum(resp_w)))


def test_finite_report_warns_and_raises(data, monkeypatch):
    """MIMO_TPU_CHECK_FINITE: a degenerate prior that NaNs the fit
    produces a LOUD RuntimeWarning naming the first bad sweep index and
    the offending state leaves ('raise' makes it fatal). Default (unset)
    is silent — the check costs a host sync, so it is opt-in."""
    from mimo_tpu.utils import sanitize
    from mimo_tpu.models.mixture import MFState

    # poisoned trace + state through the real reporting path
    m = BayesianGMM.make(size=4, dim=2, dtype=jnp.float64)
    st, _ = m.fit_vi(data, key=0, maxiter=3)
    bad_state = st._replace(
        components=st.components._replace(
            mu=st.components.mu.at[1, 0].set(jnp.nan)))
    trace = jnp.asarray([1.0, 2.0, jnp.nan, jnp.nan])

    monkeypatch.delenv('MIMO_TPU_CHECK_FINITE', raising=False)
    assert sanitize.finite_report((bad_state, trace), 'fit_vi') \
        == (bad_state, trace)          # silent by default

    monkeypatch.setenv('MIMO_TPU_CHECK_FINITE', '1')
    with pytest.warns(RuntimeWarning, match='sweep 2') as rec:
        sanitize.finite_report((bad_state, trace), 'fit_vi')
    assert 'mu' in str(rec[0].message)

    monkeypatch.setenv('MIMO_TPU_CHECK_FINITE', 'raise')
    with pytest.raises(FloatingPointError, match='fit_vi'):
        sanitize.finite_report((bad_state, trace), 'fit_vi')

    # a bare NamedTuple state (no trace) is checked as a state, not
    # unpacked as (state, trace)
    with pytest.raises(FloatingPointError, match='state leaves'):
        sanitize.finite_report(bad_state, 'fit_gibbs_fused')

    # clean results pass through untouched under 'raise'
    out = sanitize.finite_report((st, jnp.asarray([1.0, 2.0])), 'fit_vi')
    assert out[0] is st


def test_finite_report_end_to_end(data, monkeypatch):
    """The env var gates the REAL engines: a fit through fit_vi with a
    degenerate (zero-scale) prior warns loudly instead of returning
    silent NaNs."""
    monkeypatch.setenv('MIMO_TPU_CHECK_FINITE', '1')
    m = BayesianGMM.make(size=4, dim=2, psi_scale=0.0,   # degenerate
                         dtype=jnp.float64)
    with pytest.warns(RuntimeWarning, match='NON-FINITE'):
        m.fit_vi(data, key=0, maxiter=5)
