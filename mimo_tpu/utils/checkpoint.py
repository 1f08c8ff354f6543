"""Checkpoint / resume: all inference state is a pytree of arrays, so
checkpointing is a single orbax save/restore.

The reference has no checkpointing (SURVEY.md §5) — its closest analogues
are deepcopy snapshots for best-of-N selection (svi_gmm.py:64-67) and the
prior<-posterior re-anchoring (evaluate_sine.py:153-155), both of which are
plain pytree operations here. This module adds durable on-disk state so
multi-host sweeps can resume after preemption.
"""

import os

import jax
import numpy as np


def save_state(path, state):
    """Save any pytree of arrays (MFState, GibbsState, priors, ...)."""
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        # orbax is optional: flat npz (single-host only)
        leaves, treedef = jax.tree.flatten(state)
        np.savez(path if path.endswith('.npz') else path + '.npz',
                 *[np.asarray(l) for l in leaves])
        return path
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(path), state, force=True)
    return path


def load_state(path, like):
    """Restore a pytree saved by `save_state`; `like` provides structure
    (and shapes/dtypes for orbax)."""
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        npz = np.load(path if path.endswith('.npz') else path + '.npz')
        leaves = [npz[k] for k in npz.files]
        treedef = jax.tree.structure(like)
        return jax.tree.unflatten(treedef, leaves)
    with ocp.StandardCheckpointer() as ckptr:
        target = jax.tree.map(ocp.utils.to_shape_dtype_struct, like) \
            if hasattr(ocp.utils, 'to_shape_dtype_struct') else like
        return ckptr.restore(os.path.abspath(path), target)


def exists(path):
    """True if a checkpoint written by save_state is present."""
    return (os.path.exists(path) or os.path.exists(path + '.npz')
            or os.path.isdir(path))


def fit_with_checkpoints(model, fit_name, data, path, total_iters,
                         chunk_iters=100, key=0, resume=True, **fit_kwargs):
    """Preemption-tolerant driver: run `model.<fit_name>` in chunks of
    `chunk_iters`, checkpointing state (+ completed-iteration count) after
    each chunk; on restart with `resume=True`, continue from the last
    checkpoint. Works for 'fit_vi' / 'fit_svi' (MFState) and 'fit_gibbs'
    (GibbsState) — every engine takes init_state + maxiter.

    Returns (final_state, iterations_run_this_call).
    """
    import json

    meta_path = path + '.meta.json'
    state, done = None, 0
    if resume and os.path.exists(meta_path):
        with open(meta_path) as f:
            done = json.load(f)['iters']
        probe = getattr(model, fit_name)(
            data, key=key, maxiter=1, **fit_kwargs)
        like = _state_of(probe)
        state = load_state(path, like)

    ran = 0
    it = done
    while it < total_iters:
        this = min(chunk_iters, total_iters - it)
        kwargs = dict(fit_kwargs)
        if state is not None:
            kwargs['init_state'] = state
            if fit_name != 'fit_gibbs':
                kwargs.setdefault('randomize', False)
        out = getattr(model, fit_name)(
            data, key=jax.random.fold_in(_key(key), it), maxiter=this,
            **kwargs)
        state = _state_of(out)
        it += this
        ran += this
        save_state(path, jax.block_until_ready(state))
        with open(meta_path, 'w') as f:
            json.dump({'iters': it, 'fit': fit_name}, f)
    return state, ran


def _state_of(out):
    """Engines return either a state NamedTuple or (state, trace)."""
    if isinstance(out, tuple) and not hasattr(out, '_fields'):
        return out[0]
    return out


def _key(key):
    if isinstance(key, int):
        return jax.random.PRNGKey(key)
    return key
