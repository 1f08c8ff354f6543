"""Chain/restart parallelism: many independent inference runs as one
vmapped on-device program, optionally sharded over the mesh 'chain' axis.

JAX replacement of the reference's only parallelism — a joblib/loky
process pool over 24 independent restarts (evaluate_sinc_parallel.py:
120-132) and the best-of-5 ELBO model selection loop
(examples/gmm/sine/svi_gmm.py:57-67). Here:

  * `fit_chains`   — vmap the whole fit over a batch of PRNG keys.
  * `best_of`      — select the chain with the best final ELBO.
  * `smc_gibbs`    — Gibbs chains interleaved with systematic resampling of
                     chain states by data log-likelihood (an SMC-flavored
                     sweep with no reference counterpart; SURVEY.md §2.6).

To spread chains over devices, shard the key batch over the mesh's 'chain'
axis — the vmapped program is embarrassingly parallel, so XLA partitions
it without collectives (the resampling all-gather being the exception).
"""

import jax
import jax.numpy as jnp



def fit_chains(model, fit_name, data, keys, **kw):
    """Run `model.<fit_name>` once per key, vmapped. Returns stacked
    results (leading chain axis).

    The jitted vmapped program — the most expensive compile in the
    package — is cached on the model per (fit_name, hashable kwargs), so
    repeated calls don't retrace."""
    data = data if isinstance(data, tuple) else (data,)

    def one(key, data):
        return getattr(model, fit_name)(data, key=key, **kw)

    try:
        cache_key = ('fit_chains', fit_name, tuple(sorted(kw.items())))
        hashable = True
    except TypeError:            # pytree kwargs (e.g. init_state)
        hashable = False
    if not hashable:
        return jax.jit(jax.vmap(one, in_axes=(0, None)))(keys, data)
    if cache_key not in model._cache:
        model._cache[cache_key] = jax.jit(
            jax.vmap(one, in_axes=(0, None)))
    return model._cache[cache_key](keys, data)


def best_of(states, vlb_traces):
    """Select the chain with the highest final ELBO (svi_gmm.py:57-67)."""
    best = jnp.argmax(vlb_traces[:, -1])
    return jax.tree.map(lambda a: a[best], states), best


def systematic_resample(key, log_w, tree):
    """Systematic resampling of a chain-stacked pytree by log-weights."""
    c = log_w.shape[0]
    w = jax.nn.softmax(log_w)
    positions = (jax.random.uniform(key, ()) + jnp.arange(c)) / c
    cum = jnp.cumsum(w)
    idx = jnp.searchsorted(cum, positions)
    idx = jnp.clip(idx, 0, c - 1)
    return jax.tree.map(lambda a: a[idx], tree), idx


def smc_gibbs(model, data, key, n_chains=8, n_rounds=10,
              sweeps_per_round=10, ess_threshold=0.5):
    """Population Gibbs with systematic chain resampling.

    Each round runs `sweeps_per_round` blocked-Gibbs sweeps per chain
    (vmapped), scores chains by complete-data log-likelihood under their
    sampled parameters, and resamples chains when the effective sample
    size drops below `ess_threshold * n_chains`. Returns the final stacked
    GibbsStates and the per-round mean log-likelihoods.
    """
    from mimo_tpu.models.mixture import BayesianMixture
    if not isinstance(model, BayesianMixture):
        raise NotImplementedError(
            'smc_gibbs drives flat BayesianMixture models (GMM/ILR); '
            'nested mixtures have a different Gibbs state')
    data = data if isinstance(data, tuple) else (data,)
    # standardize ONCE here: the sweeps and chain scoring below call
    # _gibbs_sweep / log_complete_likelihood directly, so going through the
    # ILR fit_gibbs wrapper (which transforms internally) for init only
    # would mix two different data scales across the chain
    if hasattr(model, '_tx') and len(data) == 2:
        data = (model._tx(data[0]), model._ty(data[1]))
    k_init, k_loop = jax.random.split(jax.random.PRNGKey(key)
                                      if isinstance(key, int) else key)

    def init_one(k):
        # base-class fit_gibbs: data is already transformed
        return BayesianMixture.fit_gibbs(model, data, key=k, maxiter=1)

    states = jax.jit(jax.vmap(init_one))(jax.random.split(k_init, n_chains))

    @jax.jit
    def one_round(states, k):
        k_sweep, k_res = jax.random.split(k)

        def run_chain(state, kk):
            def step(s, sk):
                new, loglik = model._gibbs_sweep(s, data, sk)
                return new, loglik
            s, lls = jax.lax.scan(step, state,
                                  jax.random.split(kk, sweeps_per_round))
            return s, lls[-1]    # score = last sweep's data log-likelihood

        states, log_w = jax.vmap(run_chain)(
            states, jax.random.split(k_sweep, n_chains))
        w = jax.nn.softmax(log_w)
        ess = 1.0 / jnp.sum(w * w)
        resampled, _ = systematic_resample(k_res, log_w, states)
        states = jax.tree.map(
            lambda a, b: jnp.where(
                jnp.reshape(ess < ess_threshold * n_chains,
                            (1,) * a.ndim), a, b),
            resampled, states)
        return states, jnp.mean(log_w)

    logliks = []
    for r in range(n_rounds):
        states, ll = one_round(states, jax.random.fold_in(k_loop, r))
        logliks.append(ll)
    return states, jnp.stack(logliks)
