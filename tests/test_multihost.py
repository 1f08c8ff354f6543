"""Multi-host (multi-process) bring-up, actually executed.

Spawns real OS processes that call `parallel.init_distributed` (JAX
multi-process CPU), form a GLOBAL mesh, and run the four sharded
production engines on process-sharded data; asserts equality against a
1-process run over the same global mesh shape. See
scripts/multihost_cpu.py for the full contract. The reference's only
analogue is joblib over independent restarts
(evaluate_sinc_parallel.py:120-132) with no cross-process reduction.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, 'scripts', 'multihost_cpu.py')


@pytest.mark.slow
@pytest.mark.parametrize('nprocs,devices', [(2, 2), (4, 1)])
def test_multi_process_global_mesh_matches_single_process(nprocs,
                                                          devices):
    """2 procs x 2 devices AND 4 procs x 1 device — both form the same
    4-device global mesh and must equal the 1-process oracle (process-
    count invariance at two different process topologies)."""
    p = subprocess.run(
        [sys.executable, SCRIPT, '--nprocs', str(nprocs),
         '--devices', str(devices), '--timeout', '540'],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result['ok'] and result['failed'] == 0
    assert result['global_devices'] == 4
    assert set(result['engines']) == {'fit_vi_fused', 'fit_gibbs_fused',
                                      'fit_svi', 'fit_map_fused',
                                      'fit_svi_stream',
                                      'fit_vi_stream_full'}


@pytest.mark.slow
def test_multi_process_pallas_and_chain_axis():
    """The fused kernel under shard_map across processes (interpret mode
    on CPU devices) plus a fit_chains leg on a ('chain','data') = (2, 2)
    mesh with restarts sharded over processes. Both must equal the
    1-process oracle."""
    p = subprocess.run(
        [sys.executable, SCRIPT, '--nprocs', '2', '--devices', '2',
         '--backend', 'interpret', '--f32', '--n-chain', '2',
         '--timeout', '540'],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result['ok'] and result['failed'] == 0
    assert result['backend'] == 'interpret' and result['n_chain'] == 2
    assert 'fit_chains' in result['engines']
