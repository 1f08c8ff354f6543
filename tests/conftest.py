"""Test configuration: force a virtual 8-device CPU mesh so sharding tests
run without a GPU, and enable x64 so parity oracles are exact.

(The package itself is dtype-polymorphic; production runs are float32 on
the GPU. Tests use float64 CPU to separate math bugs from rounding.)

`pytest -m gpu` selects the tests that run the compiled kernels and
leaves JAX on its default platform, the GPU; every other selection runs
on the CPU. Each gpu test skips (through the `gpu` fixture) where JAX
finds no GPU. Run them in one process per card, without xdist.
"""

import os
import sys

_GPU_RUN = sys.argv[sys.argv.index('-m') + 1:][:1] == ['gpu'] \
    if '-m' in sys.argv else False

if not _GPU_RUN:
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

# Belt and braces: a pytest plugin may have imported jax before this
# conftest ran, in which case the env vars above are too late — but the
# config flags still apply as long as no backend has been initialized.
if not _GPU_RUN:
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_num_cpu_devices', 8)
jax.config.update('jax_enable_x64', True)

# Persistent compilation cache: the suite is compile-dominated, so the
# first run populates it and later runs load.
from mimo_tpu.utils.cache import use_compile_cache  # noqa: E402

use_compile_cache()
jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.3)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Fast subset: `pytest -m 'not slow'` — unit/oracle-level sanity in
# < 3 min cold on the 4-core box (the full suite is the real gate,
# ~16 min cold). Marked slow: everything in test_examples.py
# (subprocess smoke of the demo drivers) plus every test with a
# measured COLD call time >= 4 s (pytest --durations on a clean
# .jax_cache; the compile cache makes warm re-runs ~2-4x
# faster, but a fresh checkout pays the cold cost).
_SLOW = {
    'test_backend_pallas_fit_matches_xla',
    'test_chain_and_data_axes_together',
    'test_clip_guards_extreme_gating',
    'test_diag_noise_experts',
    'test_em_map_fused_pallas_interpret',
    'test_expected_log_likelihood_monte_carlo',
    'test_fit_chains_cached_and_deterministic',
    'test_fit_with_checkpoints_resume',
    'test_fused_refit_different_n',
    'test_gibbs_fused_sharded_runs',
    'test_gibbs_loglik_trace',
    'test_gibbs_pallas_sharded_runs',
    'test_gibbs_under_debug_nans',
    'test_gibbs_warm_start_continues',
    'test_gmm_fused_equals_standard',
    'test_hier_gmm_fused_equals_standard',
    'test_hier_svi_runs',
    'test_hier_vi_warm_monotone',
    'test_hmix_backend_pallas_fit_matches_xla',
    'test_hmix_log_predictive_sharded_kernel_equals_dense',
    'test_hmix_fused_gibbs_gmm',
    'test_hmix_fused_gibbs_ilr',
    'test_hmix_fused_gibbs_sharded_runs',
    'test_hmix_fused_em',
    'test_hmix_fused_em_ilr',
    'test_hmix_fused_map',
    'test_hmix_fused_vi_gmm',
    'test_hmix_fused_vi_ilr',
    'test_hmix_svi_mesh',
    'test_hmix_fused_vi_sharded_equals_unsharded',
    'test_hmix_ilr_backend_pallas_fit_matches_xla',
    'test_hmix_pallas_sharded_equals_unsharded',
    'test_hmix_svi_runs',
    'test_ilr_backend_pallas_fit_matches_xla',
    'test_ilr_fused_equals_standard',
    'test_ilr_fused_gibbs_recovers',
    'test_ilr_pallas_sharded_equals_unsharded',
    'test_ilr_predict_sharded_kernel_equals_dense',
    'test_ilr_sharded_vi',
    'test_ilr_step_end_to_end_parity',
    'test_ilr_tied_affine_and_hier_basis_fused',
    'test_iw_sampler_mean',
    'test_log_predictive_density',
    'test_log_predictive_sharded_kernel_equals_dense',
    'test_map_em_fused_sharded_equals_unsharded',
    'test_mixture_of_mixtures_gibbs_runs',
    'test_mixture_of_mixtures_ilr_predict',
    'test_mixture_of_mixtures_log_predictive',
    'test_mixture_of_mixtures_map',
    'test_mixture_of_mixtures_map_ilr',
    'test_mnw_sampler_column_covariance',
    'test_multi_output',
    'test_mvt_logpdf_huge_df_matches_gaussian_limit',
    'test_nlpd_in_original_units',
    'test_predictive_activation_and_incremental',
    'test_predictive_equals_marginal_of_one_point',
    'test_predictive_studentt_monte_carlo',
    'test_reanchor',
    'test_sample_from_fitted',
    'test_sample_from_fitted_ilr',
    'test_sample_params_moments',
    'test_save_load_roundtrip',
    'test_sine_rmse_nlpd',
    'test_smc_gibbs_gmm_improves',
    'test_smc_gibbs_ilr_transform_consistency',
    'test_stick_breaking_kl_finite_at_huge_counts',
    'test_streaming_svi',
    'test_super_iteration_reanchoring',
    'test_svi_path',
    'test_svi_robbins_monro_schedule',
    'test_svi_sharded_runs_and_recovers',
    'test_tied_affine_ell_parity',
    'test_tied_affine_experts',
    'test_tied_affine_hier_basis',
    'test_tied_gmm_vi',
    'test_vi_fused_sharded_equals_unsharded',
    'test_vi_monotone_and_recovers',
    'test_vi_pallas_sharded_equals_unsharded',
    'test_vi_sharded_equals_replicated',
    'test_vi_stick_breaking',
}


def pytest_collection_modifyitems(items):
    for item in items:
        if (item.originalname in _SLOW
                or item.fspath.basename == 'test_examples.py'):
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def key():
    return jax.random.PRNGKey(42)
