"""Smoke tests for the examples suite: every driver must run end-to-end
on CPU (the reference's examples are its de-facto test suite, SURVEY.md
§2.5 — here they get asserted exit codes instead of eyeballed plots).

Each example is a subprocess so its own argparse/config applies; --cpu
keeps them on the CPU, off any GPU the machine has.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

EXAMPLES = os.path.join(os.path.dirname(__file__), '..', 'examples')

DRIVERS = [
    ('gauss.py', []),
    ('lingauss.py', []),
    ('gmm_toy.py', []),
    ('dpgmm.py', []),
    ('ilr_sine.py', []),
    ('ilr_eval.py', ['--dataset', 'step']),   # one dataset; 'all' is slow
    ('hgmm.py', []),
    ('hilr.py', []),
    ('chains_smc.py', ['--chains', '4']),
    ('ilr_sinc_study.py', ['--seeds', '3', '--svi_iters', '150']),
    ('stream_svi.py', ['--n', '100000']),
    ('dp_sticks.py', ['--draws', '2000']),
]


@pytest.mark.parametrize('script,extra', DRIVERS,
                         ids=[d[0] for d in DRIVERS])
def test_example_runs(script, extra):
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)   # example sets cpu via jax.config
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, script), '--cpu'] + extra,
        capture_output=True, text=True, timeout=420, env=env)
    assert proc.returncode == 0, (
        f'{script} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}')


# frozen accuracy thresholds for the full ilr_eval benchmark set
# (reference examples/ilr/evaluate_{sinc_parallel,step,chirp,inverse,
# cmb,step_poly_features}.py). Numbers frozen from a 3-seed CPU sweep
# (seeds 0-2; the per-seed values are in DESIGN.md, "ilr_eval accuracy
# thresholds"): threshold = worst seed + margin. A regression
# that degrades any dataset to garbage now FAILS instead of exiting 0.
ILR_EVAL_THRESHOLDS = {
    # dataset: (max RMSE, max mean NLPD)
    'sine': (0.22, -0.25),        # seeds: rmse .167-.170, nlpd -.36..-.38
    'sinc': (0.26, -0.30),        # rmse .183-.205, nlpd -.38..-.45
    'step': (1.15, -0.05),        # rmse .59-.95 (seed-bimodal), nlpd -.17..-.43
    'step_poly': (3.40, 2.65),    # sigma=3 noise floor; rmse 2.67-2.87
    'chirp': (0.62, 0.65),        # rmse .44-.51, nlpd .42-.53
    'inverse': (0.26, -0.85),     # rmse .19-.21, nlpd -.99..-1.06
    'cmb': (1150.0, 8.0),         # raw CMB units; rmse 1032-1034
}


@pytest.mark.parametrize('dataset', sorted(ILR_EVAL_THRESHOLDS),
                         ids=sorted(ILR_EVAL_THRESHOLDS))
def test_ilr_eval_accuracy(dataset):
    """Run the ilr_eval driver on one benchmark dataset and assert its
    reported RMSE / NLPD against the frozen thresholds."""
    import re
    if dataset == 'cmb' and not os.path.exists(
            '/root/reference/examples/ilr/cmb.csv') and not os.path.exists(
            os.path.join(EXAMPLES, 'cmb.csv')):
        pytest.skip('CMB table not available')
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, 'ilr_eval.py'), '--cpu',
         '--dataset', dataset, '--seed', '0'],
        capture_output=True, text=True, timeout=420, env=env)
    assert proc.returncode == 0, (
        f'ilr_eval {dataset} failed:\n{proc.stdout[-2000:]}\n'
        f'{proc.stderr[-2000:]}')
    m = re.search(r'RMSE\s+([-\d.]+)\s+\|\s+mean NLPD\s+([-\d.]+)',
                  proc.stdout)
    assert m, f'no RMSE line in output:\n{proc.stdout[-2000:]}'
    rmse, nlpd = float(m.group(1)), float(m.group(2))
    max_rmse, max_nlpd = ILR_EVAL_THRESHOLDS[dataset]
    assert rmse < max_rmse, f'{dataset}: RMSE {rmse} > {max_rmse}'
    assert nlpd < max_nlpd, f'{dataset}: NLPD {nlpd} > {max_nlpd}'
