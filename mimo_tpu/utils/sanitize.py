"""Loud non-finite detection for the production engines.

Motivation (DESIGN.md section 10, the Geweke findings): a near-zero sampled
prior precision overflowed yyT at f32 and the chain NaN-absorbed from
draw 19,407 — SILENTLY: the final state carried NaNs but nothing
reported where they entered. `jax_debug_nans` catches this but recompiles
everything and fires on benign intermediate infs (log(0) guarded by
`where`), so it is not a production default.

This check is opt-in via environment variable (it forces a host sync of
the returned state/trace, which would break async dispatch pipelines if
always on):

    MIMO_TPU_CHECK_FINITE=1      warn  (RuntimeWarning, with the first
                                 bad sweep index from the trace and the
                                 offending state leaves)
    MIMO_TPU_CHECK_FINITE=raise  raise FloatingPointError instead
    unset / 0 / off              no check (default)

Every fit_* engine routes its return value through `finite_report`, so
enabling the variable covers VI/Gibbs/SVI/MAP/EM, fused or dense,
streamed or in-memory.
"""

import os
import warnings

import numpy as np

__all__ = ['finite_report', 'check_mode']


def check_mode():
    v = os.environ.get('MIMO_TPU_CHECK_FINITE', '').lower()
    if v in ('', '0', 'off', 'false'):
        return None
    return 'raise' if v == 'raise' else 'warn'


def _bad_leaves(tree):
    import jax
    bad = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(jax.device_get(leaf))
        if a.dtype.kind in 'fc' and not np.isfinite(a).all():
            n_bad = int((~np.isfinite(a)).sum())
            bad.append(f'{jax.tree_util.keystr(path)} '
                       f'({n_bad}/{a.size} non-finite)')
    return bad


def finite_report(result, engine):
    """Check a fit engine's return value (state or (state, trace)) for
    non-finite values when MIMO_TPU_CHECK_FINITE is set. Reports the
    FIRST bad sweep index from the per-sweep trace (the sweep where the
    NaN entered the ELBO/loglik) and every non-finite state leaf."""
    mode = check_mode()
    if mode is None:
        return result
    # (state, trace) pairs are plain tuples; bare states are NamedTuples
    # (MFState/GibbsState/EMState), which are tuples too — distinguish
    # by _fields
    state, trace = (result
                    if isinstance(result, tuple) and len(result) == 2
                    and not hasattr(result, '_fields')
                    else (result, None))
    msgs = []
    if trace is not None:
        t = np.asarray(np.ravel(np.asarray(trace)), np.float64)
        finite = np.isfinite(t)
        if not finite.all():
            first = int(np.argmin(finite))
            msgs.append(f'trace non-finite from sweep {first} '
                        f'({int((~finite).sum())}/{t.size} entries)')
    bad = _bad_leaves(state)
    if bad:
        msgs.append('state leaves: ' + '; '.join(bad[:8])
                    + ('; ...' if len(bad) > 8 else ''))
    if msgs:
        msg = (f'mimo_tpu.{engine}: NON-FINITE result — '
               + ' | '.join(msgs)
               + '. Common causes: degenerate prior scales (psi/beta ~ '
               ' 0), f32 overflow in yyT/xxT statistics, empty '
               'components with diffuse priors. Re-run at f64 or '
               'tighten the prior; MIMO_TPU_CHECK_FINITE=raise to make '
               'this fatal.')
        if mode == 'raise':
            raise FloatingPointError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
    return result
