"""Chain diagnostics (split R-hat, ESS) and the Geweke
joint-distribution test of the full Gibbs transition.

The reference's only multi-run diagnostic is best-of-N ELBO selection
(examples/gmm/sine/svi_gmm.py:57-67); R-hat/ESS have no counterpart
there. Synthetic oracles here pin the implementations to their known
values (iid, shifted-chain, AR(1))."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mimo_tpu.parallel.diagnostics import (
    diagnostics, ess, split_rhat)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env():
    """Force the Geweke subprocess onto the CPU backend whatever the
    parent's platform (the x64 oracle leg runs on the CPU)."""
    env = dict(os.environ)
    env['JAX_PLATFORMS'] = 'cpu'
    return env


def test_rhat_iid_chains_near_one():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 2000))
    r = split_rhat(x)
    assert 0.99 < r < 1.01
    # rank-normalized agrees for Gaussian draws
    rr = split_rhat(x, rank_normalized=True)
    assert 0.99 < rr < 1.01


def test_rhat_detects_disagreeing_chain():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 1000))
    x[0] += 3.0                       # one chain stuck in another mode
    assert split_rhat(x) > 1.2
    # ... and a trending chain (caught by the SPLIT, not the between-
    # chain term: all chains share the trend)
    y = rng.standard_normal((4, 1000)) + np.linspace(0, 4, 1000)
    assert split_rhat(y) > 1.2


def test_rhat_constant_chain_edge_cases():
    x = np.zeros((4, 100))
    assert split_rhat(x) == 1.0       # all constant, all equal
    x[0] += 1.0
    assert np.isinf(split_rhat(x))    # constant but disagreeing


def test_ess_iid_near_total():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 2000))
    n = x.size
    assert 0.7 * n < ess(x) < 1.4 * n


def test_ess_ar1_matches_theory():
    """AR(1) with coefficient rho has ESS ~= n (1-rho)/(1+rho)."""
    rng = np.random.default_rng(3)
    rho = 0.9
    c, t = 8, 5000
    x = np.zeros((c, t))
    e = rng.standard_normal((c, t)) * np.sqrt(1 - rho ** 2)
    for i in range(1, t):
        x[:, i] = rho * x[:, i - 1] + e[:, i]
    ratio = (1 - rho) / (1 + rho)
    n_eff = ess(x)
    assert 0.5 * ratio * c * t < n_eff < 2.0 * ratio * c * t


def test_stat_axes_and_summary():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 500, 3, 2))
    assert split_rhat(x).shape == (3, 2)
    assert ess(x).shape == (3, 2)
    d = diagnostics(rng.standard_normal((4, 500)))
    assert set(d) == {'rhat', 'rhat_rank', 'ess', 'n'}
    assert d['n'] == 2000 and d['rhat'] < 1.05


@pytest.mark.slow
def test_geweke_full_gibbs_transition():
    """Geweke joint-distribution test (scripts/geweke_gibbs.py): prior
    draws vs the successive-conditional chain through the PRODUCTION
    Gibbs sweep (fused label sample -> conjugate update -> Bartlett
    Wishart / Gaussian / stick Beta draws). A bug in any sampled
    conditional shifts the stationary distribution; healthy max|z| at
    these draw counts is ~2-4 (DESIGN.md, "Geweke certification"), gross
    bugs give tens."""
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, 'scripts', 'geweke_gibbs.py'),
         '--draws', '4000', '--burn', '300', '--thin', '1'],
        cwd=REPO, capture_output=True, text=True, timeout=900,
        env=_cpu_env())
    assert p.returncode == 0, p.stdout + p.stderr
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result['max_abs_z'] < 6.0, p.stdout
    assert result['dtype'] == 'float64'


@pytest.mark.slow
@pytest.mark.parametrize('family', ['hier', 'tied-affine'])
def test_geweke_exact_draw_transitions(family):
    """Round-5 regression leg for the EXACT one-shot blocked draws
    (hierarchical Lambda->tau->mu_k; tied-affine Lambda->A->c_k) — the
    highest-risk hand-derived conditionals. Reduced draws; the full
    20k-draw certificates (CPU f64 max|z| <= 2.9 across every family)
    live in DESIGN.md, "Geweke certification"; the nightly CI matrix
    runs all 8 families."""
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, 'scripts', 'geweke_gibbs.py'),
         '--family', family, '--draws', '2500', '--burn', '200',
         '--n', '128', '--thin', '1'],
        cwd=REPO, capture_output=True, text=True, timeout=900,
        env=_cpu_env())
    assert p.returncode == 0, p.stdout + p.stderr
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result['max_abs_z'] < 6.0, p.stdout
    assert result['dropped_prior'] == 0 and result['dropped_succ'] == 0
