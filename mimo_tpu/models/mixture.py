"""Generic Bayesian mixture engine: EM/MAP, blocked Gibbs, mean-field VI and
stochastic VI over any conjugate Family.

This single engine subsumes the loop code of the reference's four mixture
classes (gmm.py:147-371, ilr.py:87-323, hgmm.py, hilr.py): each inference
loop is a jitted `lax.scan` over an immutable state pytree; the component
axis K is batched; label sampling is one `jax.random.categorical`; all
hot reductions are matmuls that pjit can shard over a data-parallel mesh.

Update-rule contract (bayesian.py:209-238):
  MAP    : post = prior (+) stats;            params <- mode(post)
  Gibbs  : post = prior (+) stats(one-hot);   params ~  post
  VI     : post = prior (+) stats(resp)
  SVI    : nat(post) <- (1-rho) nat(post) + rho (nat(prior) + stats/scale)
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from mimo_tpu.conjugate.families import Family
from mimo_tpu.ops.estep import pick_block_size
from mimo_tpu.ops.family_estep import estep_engine, gibbs_engine
from mimo_tpu.utils.data import one_hot, sample_batch_indices
from mimo_tpu.utils.sanitize import finite_report as _finite_report
from mimo_tpu.utils.stats import (
    entropy_categorical, normalize_log, sample_categorical_from_log,
)


class MFState(NamedTuple):
    """Mean-field / MAP state: the variational posterior."""
    components: Any          # family posterior struct (K-batched)
    gating: Any              # Dirichlet or StickBreaking posterior


class GibbsState(NamedTuple):
    """Blocked-Gibbs state: current conditionals + sampled likelihood params."""
    components: Any          # component posterior (conditional on labels)
    gating: Any              # gating posterior (conditional on labels)
    params: Any              # sampled likelihood params
    log_pi: jax.Array        # log of sampled mixture weights (K,)
    labels: jax.Array        # (N,) int32


class EMState(NamedTuple):
    """Maximum-likelihood EM state (non-Bayesian, gmm.py:16-103)."""
    params: Any              # likelihood params
    log_pi: jax.Array        # (K,)


def _tree_where(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def _elbo_loop(step, carry0, maxiter, tol):
    """Run `carry, vlb = step(carry, i)` for up to `maxiter` sweeps.

    With `tol` (the reference's VI stopping rule, gmm.py:279-283:
    |vlb_t - vlb_{t-1}| < tol after at least two sweeps) the loop is a
    `lax.while_loop` that actually stops early on device; the returned
    (maxiter,) trace is constant-extended past convergence so the shape
    stays static under jit. With tol=None it is a plain `lax.scan`.

    A NaN ELBO never satisfies the stop rule (the reference's
    `abs(delta) < tol` is also False for NaN), so divergence keeps
    iterating rather than masquerading as convergence.
    """
    if tol is None:
        return jax.lax.scan(step, carry0, jnp.arange(maxiter))

    # the trace/carry slots must match the ELBO's promoted dtype (e.g. the
    # Pallas E-step accumulates in f32 regardless of the data dtype)
    _, vlb_sd = jax.eval_shape(step, carry0, jnp.zeros((), jnp.int32))
    dtype = vlb_sd.dtype
    trace0 = jnp.zeros((maxiter,), dtype)
    big = jnp.array(jnp.inf, dtype)

    def cond(c):
        i, _, prev, cur, _ = c
        converged = jnp.abs(cur - prev) < tol   # False for NaN: keep going
        return (i < maxiter) & ((i < 2) | ~converged)

    def body(c):
        i, carry, _, cur, trace = c
        carry, vlb = step(carry, i)
        return (i + 1, carry, cur, vlb, trace.at[i].set(vlb))

    i, carry, _, last, trace = jax.lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), carry0, big, -big, trace0))
    return carry, jnp.where(jnp.arange(maxiter) < i, trace, last)


class BayesianMixture:
    """A Bayesian mixture of `K` conjugate-family components with a
    Dirichlet or stick-breaking (DP) gating prior.

    Pure-functional core: `self` holds only static configuration (the
    Family's functions) and prior pytrees; every fit method is a jitted
    pure function of (priors, data, key).
    """

    def __init__(self, gating_prior, components_prior, family: Family):
        self.gating_prior = gating_prior
        self.components_prior = components_prior
        self.family = family
        self.size = gating_prior.dim
        self._cache = {}

    # -- functional pieces ------------------------------------------------

    def expected_log_complete(self, state: MFState, data):
        """E_q[log p(x, z=k)] -> (N, K) (gmm.py:244-254, ilr.py:178-189)."""
        ell = self.family.ell(state.components, data)
        return ell + state.gating.expected_log_pi()[None, :]

    def expected_responsibilities(self, state: MFState, data):
        resp, _ = normalize_log(self.expected_log_complete(state, data))
        return resp

    def log_complete_likelihood(self, params, log_pi, data):
        """log p(x, z=k) under plug-in params (gmm.py:67-70)."""
        return self.family.loglik(params, data) + log_pi[None, :]

    def _mf_update(self, data, resp, point_weights=None) -> MFState:
        """Update from responsibilities; optional per-point weights scale the
        statistics (external cluster weights in nested mixtures, hgmm.py:202,
        or zero-weight padding for static shapes)."""
        if point_weights is not None:
            resp = resp * point_weights[:, None]
        stats = self.family.suff_stats(data, resp)
        counts = jnp.sum(resp, axis=0)
        return MFState(
            components=self.family.update(self.components_prior, stats),
            gating=self.gating_prior.update(counts),
        )

    def elbo(self, state: MFState, data, resp):
        """Variational lower bound (gmm.py:338-364 decomposition):
        -KL(gating) - sum_k KL(comp_k) + data term + label terms."""
        data_term = jnp.sum(resp * self.family.ell(state.components, data))
        label_term = (state.gating.label_elbo_terms(resp)
                      + jnp.sum(entropy_categorical(resp, axis=-1)))
        kl_comp = jnp.sum(self.family.kl(state.components, self.components_prior))
        kl_gating = jnp.sum(state.gating.kl_divergence(self.gating_prior))
        return data_term + label_term - kl_comp - kl_gating

    # -- mean-field VI (gmm.py:261-297) -----------------------------------

    def _vi_sweep(self, state_resp, data, point_weights=None):
        _, resp = state_resp
        state = self._mf_update(data, resp, point_weights)
        resp = self.expected_responsibilities(state, data)
        vlb = self.elbo(state, data, resp)
        return (state, resp), vlb

    def _estep_spec(self):
        """EStepSpec for the fused engines (ops/family_estep.py); None when
        the family's expected log-likelihood is not feature-linear (e.g.
        hierarchical inner loops). Overridden by concrete models."""
        return None

    def fit_vi_fused(self, data, key=None, maxiter=250, tol=None,
                     block_size=None, init_state=None, randomize=True,
                     mesh=None, backend='auto'):
        """Mean-field VI with the fused E-step: log-densities and
        sufficient statistics come from the family's feature map in one
        pass over the data; the N x K responsibilities never exist
        (ops/family_estep.py). Works for any model whose family provides
        an EStepSpec (GMMs incl. diag/tied, mixtures of linear experts).

        With `mesh` (a ('chain','data') mesh from parallel.make_mesh), the
        E-step runs under shard_map: each device reduces its local shard
        and the (K, m) stats accumulator is psum'd over the 'data' axis —
        the multi-device hot path. Data should be sharded with
        parallel.shard_data.

        The ELBO trace reports ELBO(state_t) exactly (lse identity) —
        the standard engine's trace shifted by one sweep. `tol` stops the
        sweep loop early once |dELBO| < tol (gmm.py:279-283; trace is
        constant-extended to keep static shape).

        `backend`: see _resolve_backend ('auto', 'xla', 'pallas',
        'interpret'). `block_size` applies to the XLA engine only, whose
        per-device N must be a multiple of it.
        Returns (MFState, vlb_trace)."""
        spec = self._estep_spec()
        if spec is None:
            raise NotImplementedError(
                'no fused E-step spec for this family; use fit_vi')
        data = _as_tuple(data)
        key = _as_key(key)
        engine = _resolve_backend(backend, spec, self.components_prior)
        block_size = _fused_block_size(data[0].shape[0], mesh, engine,
                                       block_size, 'fit_vi')
        estep = estep_engine(spec, engine, block_size, mesh)
        fn = self._jitted('vi_fused', maxiter=maxiter, block_size=block_size,
                          randomize=randomize, tol=tol is not None,
                          warm=init_state is not None, mesh=mesh,
                          engine=engine)

        def run(data, key, init_state, tol):
            # n from the traced data, NOT the enclosing scope: the jitted
            # closure is cached per static key and reused across datasets
            n = data[0].shape[0]
            if randomize or init_state is None:
                resp = _random_resp(key, n, self.size, data[0].dtype)
                state = self._mf_update(data, resp)
            else:
                state = init_state

            def step(state, _):
                res = estep(state.components,
                            state.gating.expected_log_pi(), data)
                vlb = (res.lse
                       - jnp.sum(self.family.kl(state.components,
                                                self.components_prior))
                       - jnp.sum(state.gating.kl_divergence(
                           self.gating_prior)))
                new = MFState(
                    components=self.family.update(self.components_prior,
                                                  res.stats),
                    gating=self.gating_prior.update(res.counts))
                return new, vlb

            state, vlb = _elbo_loop(step, state, maxiter, tol)
            return state, vlb

        return _finite_report(fn(run, data, key, init_state, tol), 'fit_vi_fused')

    def fit_gibbs_fused(self, data, key=None, maxiter=100, block_size=None,
                        mesh=None, backend='auto'):
        """Blocked Gibbs with a fused label sweep: plug-in log-densities,
        the label draw and the one-hot statistics come from the family
        feature map in one pass over the data — the N x K log-probs never
        exist (ops/family_estep.py). Works for any model whose family
        provides an EStepSpec with plug-in natural params. Returns the
        final GibbsState.

        With `mesh`, the label sweep runs under shard_map over the 'data'
        axis: labels stay device-local, the (K, m) one-hot statistics
        accumulator is psum'd, and each device samples from its own folded
        PRNG stream.

        `backend`/`block_size`: as in fit_vi_fused."""
        spec = self._estep_spec()
        if spec is None or spec.theta_plugin is None:
            raise NotImplementedError(
                'no fused Gibbs spec for this family; use fit_gibbs')
        data = _as_tuple(data)
        key = _as_key(key)
        engine = _resolve_backend(backend, spec, self.components_prior)
        block_size = _fused_block_size(data[0].shape[0], mesh, engine,
                                       block_size, 'fit_gibbs')
        sweep_labels = gibbs_engine(spec, engine, block_size, mesh)
        fn = self._jitted('gibbs_fused', maxiter=maxiter,
                          block_size=block_size, mesh=mesh, engine=engine)

        def run(data, key):
            n = data[0].shape[0]     # from traced data, not enclosing scope
            dtype = data[0].dtype
            comp = self.components_prior
            gating = self.gating_prior
            params0 = self.family.mode_params(comp)
            log_pi0 = jnp.log(jnp.full((self.size,), 1.0 / self.size,
                                       dtype))
            labels0 = jnp.zeros((n,), jnp.int32)
            gibbs_update = getattr(self.family, 'gibbs_update', None)

            def sweep(carry, k):
                comp, gating, params_prev, _, _ = carry
                k_par, k_pi, k_lab = jax.random.split(k, 3)
                if gibbs_update is None:
                    params = self.family.sample_params(k_par, comp)
                    # pin dtypes: under enable_x64 the param/stick samplers
                    # promote to f64, which would flip the scan carry type
                    params = jax.tree.map(lambda a, p0: a.astype(p0.dtype),
                                          params, params0)
                else:
                    # families with their own blocked-Gibbs M-side (e.g.
                    # hierarchical inner chains) produced params below
                    params = params_prev
                probs = gating.sample(k_pi)
                log_pi = jnp.log(jnp.clip(probs, 1e-37, None)).astype(dtype)
                labels, res = sweep_labels(k_lab, params, log_pi, data)
                if gibbs_update is None:
                    comp = self.family.update(self.components_prior,
                                              res.stats)
                else:
                    comp, params = gibbs_update(k_par,
                                                self.components_prior,
                                                res.stats)
                    params = jax.tree.map(lambda a, p0: a.astype(p0.dtype),
                                          params, params0)
                gating = self.gating_prior.update(res.counts)
                return (comp, gating, params, log_pi, labels), None

            (comp, gating, params, log_pi, labels), _ = jax.lax.scan(
                sweep, (comp, gating, params0, log_pi0, labels0),
                jax.random.split(key, maxiter))
            return GibbsState(components=comp, gating=gating, params=params,
                              log_pi=log_pi, labels=labels)

        return _finite_report(fn(run, data, key), 'fit_gibbs_fused')

    def fit_em(self, data, key=None, maxiter=250):
        """Likelihood-only EM (the reference's max_likelihood engine,
        gmm.py:77-103 and ilr.py:82-86): plug-in E-step + closed-form
        weighted ML M-step, no priors involved. Returns
        (EMState(params, log_pi), loglik trace). Requires the family to
        provide an ml_update (all four base families and their
        products/tied variants do; hierarchical families do not)."""
        if self.family.ml_update is None:
            raise NotImplementedError(
                'this family has no maximum-likelihood update; use fit_map')
        data = _as_tuple(data)
        key = _as_key(key)
        fn = self._jitted('em', maxiter=maxiter)

        def run(data, key):
            n = data[0].shape[0]
            # random-anchor init (sklearn-style 'random' k-means seeding):
            # soft assignment by distance to K random data points. A flat
            # random-resp init collapses tied/shared-scale EM onto the
            # symmetric fixed point (all means = data mean).
            x0 = data[0]
            idx = jax.random.choice(key, n, (self.size,), replace=False)
            anchors = x0[idx]                               # (K, d)
            scale2 = jnp.maximum(jnp.mean(jnp.var(x0, axis=0)), 1e-6)
            d2 = jnp.sum((x0[:, None, :] - anchors[None, :, :]) ** 2, -1)
            resp, _ = normalize_log(-0.5 * d2 / scale2)

            def step(resp, _):
                counts = jnp.sum(resp, axis=0)
                params = self.family.ml_update(
                    self.family.suff_stats(data, resp))
                # clip: an empty component (counts=0 after f32 underflow)
                # must not poison the fit with log(0) = -inf
                log_pi = jnp.log(jnp.clip(counts, 1e-37, None) / n)
                log_p = self.log_complete_likelihood(params, log_pi, data)
                resp, lognorm = normalize_log(log_p)
                return resp, (EMState(params, log_pi), jnp.sum(lognorm))

            _, (states, trace) = jax.lax.scan(step, resp, None,
                                              length=maxiter)
            return jax.tree.map(lambda a: a[-1], states), trace

        return _finite_report(fn(run, data, key), 'fit_em')

    def fit_em_fused(self, data, key=None, maxiter=250, block_size=None,
                     mesh=None, backend='auto'):
        """fit_em through the fused blockwise engines: the EM E-step is a
        plug-in softmax (reference gmm.py:67-75), i.e. exactly the fused
        E-step kernel fed spec.theta_plugin(ml_params) — so EM scales to
        HBM-resident N like VI/Gibbs (the N x K responsibilities exist
        only inside the kernel; the anchor INIT still materializes one
        (N, K) distance matrix + dense stats, a one-time cost shared with
        the standard engines). mesh/backend as in fit_vi_fused. Returns
        (EMState(params, log_pi), loglik trace)."""
        if self.family.ml_update is None:
            raise NotImplementedError(
                'this family has no maximum-likelihood update; use '
                'fit_map_fused')
        spec = self._estep_spec()
        if spec is None or spec.theta_plugin is None:
            raise NotImplementedError(
                'no fused plug-in spec for this family; use fit_em')
        data = _as_tuple(data)
        key = _as_key(key)
        engine = _resolve_backend(backend, spec, self.components_prior)
        block_size = _fused_block_size(data[0].shape[0], mesh, engine,
                                       block_size, 'fit_em')
        fn = self._jitted('em_fused', maxiter=maxiter,
                          block_size=block_size, mesh=mesh, engine=engine)
        # EM E-steps are plug-in softmaxes: the fused engines call
        # spec.theta(post), so rebind it to the plug-in map
        estep = estep_engine(spec._replace(theta=spec.theta_plugin), engine,
                             block_size, mesh)

        def run(data, key):
            n = data[0].shape[0]
            # same random-anchor init as fit_em (k-means-style seeding)
            x0 = data[0]
            idx = jax.random.choice(key, n, (self.size,), replace=False)
            anchors = x0[idx]
            scale2 = jnp.maximum(jnp.mean(jnp.var(x0, axis=0)), 1e-6)
            d2 = jnp.sum((x0[:, None, :] - anchors[None, :, :]) ** 2, -1)
            resp, _ = normalize_log(-0.5 * d2 / scale2)
            counts = jnp.sum(resp, axis=0)
            params = self.family.ml_update(self.family.suff_stats(data, resp))
            log_pi = jnp.log(jnp.clip(counts, 1e-37, None) / n)

            def step(carry, _):
                params, log_pi = carry
                res = estep(params, log_pi, data)
                params = self.family.ml_update(res.stats)
                log_pi = jnp.log(jnp.clip(res.counts, 1e-37, None) / n)
                return (params, log_pi), res.lse

            (params, log_pi), trace = jax.lax.scan(
                step, (params, log_pi), None, length=maxiter)
            return EMState(params, log_pi), trace

        return _finite_report(fn(run, data, key), 'fit_em_fused')

    def fit_map_fused(self, data, key=None, maxiter=250, block_size=None,
                      randomize=True, mesh=None, backend='auto'):
        """fit_map through the fused blockwise engines: the MAP E-step is
        a plug-in softmax at the posterior mode (reference gmm.py:176-204),
        i.e. the fused E-step kernel fed spec.theta_plugin(mode_params) —
        MAP-EM at HBM-resident N without the N x K responsibilities.
        mesh/backend as in fit_vi_fused. Returns (MFState, loglik trace)."""
        spec = self._estep_spec()
        if spec is None or spec.theta_plugin is None:
            raise NotImplementedError(
                'no fused plug-in spec for this family; use fit_map')
        data = _as_tuple(data)
        key = _as_key(key)
        engine = _resolve_backend(backend, spec, self.components_prior)
        block_size = _fused_block_size(data[0].shape[0], mesh, engine,
                                       block_size, 'fit_map')
        fn = self._jitted('map_fused', maxiter=maxiter,
                          block_size=block_size, randomize=randomize,
                          mesh=mesh, engine=engine)
        estep = estep_engine(spec._replace(theta=spec.theta_plugin), engine,
                             block_size, mesh)

        def run(data, key):
            n = data[0].shape[0]
            dtype = data[0].dtype
            resp = _random_resp(key, n, self.size, dtype)
            state = self._mf_update(data, resp)

            def step(state, _):
                params = self.family.mode_params(state.components)
                log_pi = jnp.log(jnp.clip(state.gating.mode(), 1e-37,
                                          None)).astype(dtype)
                res = estep(params, log_pi, data)
                new = MFState(
                    components=self.family.update(self.components_prior,
                                                  res.stats),
                    gating=self.gating_prior.update(res.counts))
                return new, res.lse

            state, trace = jax.lax.scan(step, state, None, length=maxiter)
            return state, trace

        return _finite_report(fn(run, data, key), 'fit_map_fused')

    def fit_vi(self, data, key=None, maxiter=250, tol=None, init_state=None,
               randomize=True, point_weights=None):
        """Mean-field coordinate ascent. Returns (MFState, vlb_trace).

        `randomize=True` starts from random responsibilities (gmm.py:266-268);
        pass `init_state` (e.g. from Gibbs) with randomize=False to warm-start.
        `tol` stops the sweep loop early once |dELBO| < tol (the reference's
        rule, gmm.py:279-283, default there 1e-8; here None = fixed maxiter);
        the trace keeps static shape (maxiter,) — constant-extended past
        convergence.
        `point_weights` (N,) scales each point's statistics (nested-mixture
        cluster weights, hgmm.py:202, or zero-weight padding).
        """
        data = _as_tuple(data)
        key = _as_key(key)
        fn = self._jitted('vi', maxiter=maxiter, randomize=randomize,
                          tol=tol is not None,
                          warm=init_state is not None,
                          weighted=point_weights is not None)

        def run(data, key, init_state, point_weights, tol):
            n = data[0].shape[0]
            if randomize or init_state is None:
                resp = _random_resp(key, n, self.size, data[0].dtype)
            else:
                resp = self.expected_responsibilities(init_state, data)
            state = self._mf_update(data, resp, point_weights)

            def step(carry, _):
                return self._vi_sweep(carry, data, point_weights)

            (state, resp), vlb = _elbo_loop(
                step, (state, self.expected_responsibilities(state, data)),
                maxiter, tol)
            return state, vlb

        return _finite_report(fn(run, data, key, init_state, point_weights, tol), 'fit_vi')

    # -- stochastic VI (gmm.py:300-336) ------------------------------------

    def fit_svi(self, data, key=None, maxiter=500, step_size=1e-2,
                batch_size=128, init_state=None, randomize=True,
                track_elbo=False, forgetting=None, delay=1.0, mesh=None):
        """Stochastic natural-gradient VI: one random minibatch per step
        (matching the reference's `batches` semantics, data.py:9-12),
        nat-space blending. Returns (MFState, vlb_trace) where the trace
        is full-data ELBO per step if track_elbo else zeros.

        The reference uses a fixed step size rho (bayesian.py:235-236) —
        that stays the default. Pass `forgetting` in (0.5, 1] for the
        Robbins–Monro schedule rho_t = step_size * (t + 1 + delay)^(-forgetting)
        (Hoffman et al. 2013, eq. 26), which the stochastic-approximation
        convergence theory actually requires; `step_size=1.0` gives the
        textbook rule.

        With `mesh` (a ('chain','data') mesh; shard data over 'data'
        first), each step runs under shard_map: every device draws
        batch_size // n_devices points from its LOCAL shard (stratified
        minibatch — unbiased when shards are randomly distributed, and the
        gather never crosses devices), computes local statistics, and one
        (K, m)-sized psum crosses the mesh; the nat-space blend is
        replicated K-sized math. track_elbo is unsupported with mesh
        (full-data ELBO inside the step defeats the point)."""
        data = _as_tuple(data)
        key = _as_key(key)
        if mesh is not None:
            if track_elbo:
                raise ValueError('track_elbo with mesh= is unsupported')
            n_dev = mesh.shape['data']
            if batch_size % n_dev:
                raise ValueError(f'batch_size={batch_size} must be a '
                                 f'multiple of the data-mesh size {n_dev}')
        fn = self._jitted('svi', maxiter=maxiter, batch_size=batch_size,
                          randomize=randomize, track_elbo=track_elbo,
                          scheduled=forgetting is not None,
                          warm=init_state is not None, mesh=mesh)

        def _batch_stats(state, k_batch, data, n):
            """(stats, counts) of one minibatch: global gather, or
            stratified per-device gather + psum under shard_map."""
            if mesh is None:
                idx = sample_batch_indices(k_batch, n, batch_size)
                batch = tuple(d[idx] for d in data)
                resp = self.expected_responsibilities(state, batch)
                return (self.family.suff_stats(batch, resp),
                        jnp.sum(resp, axis=0))

            from jax.sharding import PartitionSpec as P
            local_b = batch_size // mesh.shape['data']

            def local(state, key, *shard):
                k = jax.random.fold_in(key, jax.lax.axis_index('data'))
                idx = sample_batch_indices(k, shard[0].shape[0], local_b)
                batch = tuple(d[idx] for d in shard)
                resp = self.expected_responsibilities(state, batch)
                stats = self.family.suff_stats(batch, resp)
                counts = jnp.sum(resp, axis=0)
                return jax.lax.psum((stats, counts), 'data')

            return jax.shard_map(
                local, mesh=mesh,
                in_specs=(P(), P()) + tuple(P('data') for _ in data),
                out_specs=P())(state, k_batch, *data)

        def run(data, key, init_state, step_size, forgetting, delay):
            n = data[0].shape[0]
            scale = batch_size / n
            k_init, k_loop = jax.random.split(key)
            if init_state is None:
                resp0 = _random_resp(k_init, n, self.size, data[0].dtype)
                state = self._mf_update(data, resp0)
            else:
                state = init_state

            def step(carry, kt):
                state = carry
                k, t = kt
                if forgetting is None:
                    rho = step_size
                else:
                    rho = step_size * (t.astype(data[0].dtype)
                                       + 1.0 + delay) ** -forgetting
                k_batch, k_resp = jax.random.split(k)
                stats, counts = _batch_stats(state, k_batch, data, n)
                new = MFState(
                    components=self.family.svi_blend(
                        state.components, self.components_prior,
                        stats, scale, rho),
                    gating=self.gating_prior.svi_blend(
                        state.gating, counts, scale, rho),
                )
                if track_elbo:
                    full_resp = self.expected_responsibilities(new, data)
                    vlb = self.elbo(new, data, full_resp)
                else:
                    vlb = jnp.zeros((), data[0].dtype)
                return new, vlb

            keys = jax.random.split(k_loop, maxiter)
            state, vlb = jax.lax.scan(step, state,
                                      (keys, jnp.arange(maxiter)))
            return state, vlb

        if forgetting is None:
            forgetting = delay = None   # keep cache key/tracing minimal
        return _finite_report(fn(run, data, key, init_state, step_size, forgetting, delay), 'fit_svi')

    def fit_svi_stream(self, next_batch, total_size, key=None, maxiter=500,
                       step_size=1e-2, batch_size=128, init_state=None,
                       forgetting=None, delay=1.0, group=16, mesh=None,
                       prefetch=2, transfer_dtype=None):
        """Out-of-core SVI: the host supplies minibatches (e.g. from
        io.MmapDataset over a file bigger than RAM/HBM); jitted
        natural-gradient steps run per batch.

        `next_batch(i) -> array or tuple of arrays` with leading dim
        batch_size; `total_size` is N for the stochastic scale B/N.
        `forgetting`/`delay` enable the Robbins–Monro step schedule
        (see fit_svi). Returns the final MFState.

        `group`: number of host batches stacked into ONE device call (a
        lax.scan over the group). Each device call costs a dispatch
        round-trip that dwarfs the math at reference batch sizes, so
        the grouped stream runs ~group x the per-batch rate;
        group x batch_size x dim floats must fit in host RAM and device
        memory (group=16 of B=65536 x d=2 f32 is 8 MB).

        `prefetch`: depth of the background reader queue — group reads
        (`next_batch` + stack) run on a reader thread so disk IO
        overlaps the device step and the h2d put of the previous group
        (io.stream.Prefetcher). Batch ORDER is unchanged, so results
        are bit-identical to the unprefetched loop.

        `transfer_dtype` (e.g. jnp.bfloat16): cast batches on the HOST
        before the device put, halving host->device bytes where the link
        binds. The step upcasts back to the state's dtype on device; bf16
        rounding is a per-point random perturbation of the data, so it
        changes the fit by a small, data-dependent amount. Off by default
        — exactness tests and f64 oracles use full-width transfer.

        With `mesh`, out-of-core meets multi-chip: every PROCESS streams
        its own shard of the file and `next_batch(i)` returns this
        process's local rows — batch_size * (local devices / total
        devices) of them, ordered by the process's devices in mesh
        order. The local stacks are assembled into global arrays via
        jax.make_array_from_process_local_data (host shards -> device
        shards, no cross-host data movement) and the jitted step's
        stats contraction reduces over the sharded batch axis under
        GSPMD — only the (K, m) statistics cross the mesh.
        `total_size`/`batch_size` stay GLOBAL. See
        scripts/multihost_cpu.py --stream for the executed 2-process
        flow."""
        key = _as_key(key)
        scale = batch_size / total_size
        group = max(1, min(group, maxiter))
        step_key = ('svi_stream', group, transfer_dtype is not None)
        if step_key not in self._cache:
            # scale/rhos are traced args, NOT closure captures: the
            # jitted step is cached once per model and reused across
            # calls with different total_size/batch_size/schedule
            def run_group(state, batches, scale, rhos):
                def one_step(state, br):
                    batch, rho = br
                    cdt = jax.tree.leaves(state)[0].dtype
                    batch = tuple(b.astype(cdt) for b in batch)
                    resp = self.expected_responsibilities(state, batch)
                    stats = self.family.suff_stats(batch, resp)
                    counts = jnp.sum(resp, axis=0)
                    return MFState(
                        components=self.family.svi_blend(
                            state.components, self.components_prior,
                            stats, scale, rho),
                        gating=self.gating_prior.svi_blend(
                            state.gating, counts, scale, rho)), None
                return jax.lax.scan(one_step, state, (batches, rhos))[0]
            self._cache[step_key] = jax.jit(run_group)
        step_fn = self._cache[step_key]

        import numpy as _np
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            batch_sh = NamedSharding(mesh, P('data'))
            stack_sh = NamedSharding(mesh, P(None, 'data'))

        if init_state is None:
            batch0 = _as_tuple(next_batch(0))
            if mesh is None:
                n0 = batch0[0].shape[0]
                resp0 = _random_resp(key, n0, self.size, batch0[0].dtype)
                state = self._mf_update(batch0, resp0)
            else:
                batch0 = tuple(jax.make_array_from_process_local_data(
                    batch_sh, _np.asarray(b)) for b in batch0)
                state = jax.jit(lambda b, k: self._mf_update(
                    b, _random_resp(k, b[0].shape[0], self.size,
                                    b[0].dtype)))(batch0, key)
        else:
            state = init_state

        def make_group(gi):
            """Read + stack one group of host batches (runs on the
            Prefetcher's reader thread, overlapping the device step and
            h2d put of the previous group)."""
            g0 = gi * group
            g = min(group, maxiter - g0)
            bs = [_as_tuple(next_batch(g0 + j)) for j in range(g)]
            if g < group:        # ragged tail: repeat last, zero its rho
                bs = bs + [bs[-1]] * (group - g)
            local = tuple(_np.stack([_np.asarray(b[a]) for b in bs])
                          for a in range(len(bs[0])))
            if transfer_dtype is not None:
                # jnp.bfloat16 is a numpy-registered ml_dtypes scalar
                # type, so host-side astype works directly
                local = tuple(a.astype(transfer_dtype) for a in local)
            if forgetting is None:
                rhos = _np.full(group, step_size, _np.float32)
            else:
                t = _np.arange(g0, g0 + group, dtype=_np.float32)
                rhos = (step_size * (t + 1.0 + delay) ** -forgetting
                        ).astype(_np.float32)
            rhos[g:] = 0.0       # padded tail steps are no-ops
            return local, rhos

        from mimo_tpu.io.stream import Prefetcher
        n_groups = -(-maxiter // group)
        with Prefetcher(make_group, n_groups, depth=prefetch) as pf:
            for local, rhos in pf:
                if mesh is None:
                    stacked = tuple(jnp.asarray(a) for a in local)
                else:
                    stacked = tuple(jax.make_array_from_process_local_data(
                        stack_sh, a) for a in local)
                state = step_fn(state, stacked, scale, jnp.asarray(rhos))
        return _finite_report(jax.block_until_ready(state),
                              'fit_svi_stream')

    # -- out-of-core FULL-DATA engines (epoch streaming) --------------------

    def _fit_epoch_stream(self, read_block, n_blocks, kind, key, maxiter,
                          init_state, prefetch, backend, block_size,
                          transfer_dtype=None, mesh=None):
        """Shared engine for fit_{vi,map,em}_stream_full: each sweep is a
        full pass over the on-disk dataset in host-supplied blocks; the
        (K, m) statistics accumulator is additive across blocks (the
        statistics are sums over points), so the streamed sweep computes
        EXACTLY the in-memory fused sweep — N is bounded by disk, not
        HBM. A background reader thread (io.stream.Prefetcher) overlaps
        the next block's disk read with the current block's h2d transfer
        and device compute (dispatch is async).

        With `mesh` (out-of-core x multi-process): every PROCESS streams
        its own shard of the file — `read_block(i)` returns THIS
        process's local rows of global block i (rows ordered by the
        process's devices in mesh order, as in fit_svi_stream(mesh=)).
        The local rows are assembled into a global array sharded over
        'data' via jax.make_array_from_process_local_data, the jitted
        per-block E-step contracts over the sharded axis under GSPMD
        (one O(K*m) all-reduce per block), and the accumulator +
        m-step stay replicated. Executed 2-process by
        scripts/multihost_cpu.py --epoch-stream."""
        from mimo_tpu.io.stream import Prefetcher

        spec = self._estep_spec()
        if spec is None:
            raise NotImplementedError(
                'no fused E-step spec for this family')
        if kind in ('map', 'em') and spec.theta_plugin is None:
            raise NotImplementedError(
                'no fused plug-in spec for this family')
        if kind == 'em' and self.family.ml_update is None:
            raise NotImplementedError(
                'this family has no maximum-likelihood update')
        key = _as_key(key)
        engine = _resolve_backend(backend, spec, self.components_prior)
        pspec = spec if kind == 'vi' else spec._replace(
            theta=spec.theta_plugin)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            _block_sh = NamedSharding(mesh, P('data'))

        def block_estep(theta_src, log_pi, *block):
            if transfer_dtype is not None:
                block = tuple(b.astype(jnp.float32) for b in block)
            bs = None
            if engine == 'xla':
                # one block per call; the scan block must divide the
                # per-device rows
                local_n = block[0].shape[0]
                if mesh is not None:
                    n_dev = mesh.shape['data']
                    if local_n % n_dev:
                        raise ValueError(
                            f'global block rows {local_n} must be a '
                            f'multiple of the data-mesh size {n_dev}')
                    local_n //= n_dev
                bs = block_size or pick_block_size(local_n)
                if local_n % bs:
                    bs = local_n
            return estep_engine(pspec, engine, bs, mesh)(theta_src, log_pi,
                                                         block)

        @jax.jit
        def accum(acc, theta_src, log_pi, *block):
            res = block_estep(theta_src, log_pi, *block)
            return jax.tree.map(jnp.add, acc, res)

        def _read(i):
            blk = _as_tuple(read_block(i))
            if transfer_dtype is not None:
                # halve host->device bytes (see fit_svi_stream's
                # transfer_dtype doc); block_estep computes in the
                # params dtype after an on-device upcast
                import numpy as _np
                blk = tuple(_np.asarray(b).astype(transfer_dtype)
                            for b in blk)
            return blk

        def _assemble(blk):
            """Host rows -> global sharded arrays (main thread: device
            puts stay off the reader thread)."""
            if mesh is None:
                return blk
            import numpy as _np
            return tuple(jax.make_array_from_process_local_data(
                _block_sh, _np.asarray(b)) for b in blk)

        def sweep_estep(theta_src, log_pi):
            """One full pass over the dataset -> summed FusedEStep."""
            acc = None
            with Prefetcher(_read, n_blocks, depth=prefetch) as pf:
                for blk in pf:
                    blk = _assemble(blk)
                    if acc is None:
                        # zero accumulator with the right structure
                        shapes = jax.eval_shape(
                            lambda *b: block_estep(theta_src, log_pi, *b),
                            *blk)
                        acc = jax.tree.map(
                            lambda s: jnp.zeros(s.shape, s.dtype), shapes)
                    acc = accum(acc, theta_src, log_pi, *blk)
            return acc

        # ---- init ----
        if init_state is not None:
            state = init_state
        elif kind in ('vi', 'map'):
            # blockwise random-responsibility init (the in-memory engines'
            # _random_resp over the full data, streamed; per-block fold_in
            # keys, so the RNG layout differs from the in-memory init —
            # pass init_state for bit-equality with fit_vi_fused)
            @jax.jit
            def init_accum(acc, k, *block):
                nb = block[0].shape[0]
                if transfer_dtype is not None:
                    block = tuple(b.astype(jnp.float32) for b in block)
                resp = _random_resp(k, nb, self.size, block[0].dtype)
                stats = self.family.suff_stats(block, resp)
                counts = jnp.sum(resp, axis=0)
                return jax.tree.map(jnp.add, acc, (stats, counts))

            acc = None
            with Prefetcher(_read, n_blocks, depth=prefetch) as pf:
                for i, blk in enumerate(pf):
                    blk = _assemble(blk)
                    if acc is None:
                        shapes = jax.eval_shape(
                            lambda *b: (self.family.suff_stats(
                                b, jnp.zeros((b[0].shape[0], self.size),
                                             b[0].dtype)),
                                jnp.zeros((self.size,), b[0].dtype)), *blk)
                        acc = jax.tree.map(
                            lambda s: jnp.zeros(s.shape, s.dtype), shapes)
                    acc = init_accum(acc, jax.random.fold_in(key, i), *blk)
            stats, counts = acc
            state = jax.jit(lambda s, c: MFState(
                components=self.family.update(self.components_prior, s),
                gating=self.gating_prior.update(c)))(stats, counts)
        else:  # em: anchor init from block 0
            if mesh is not None:
                raise NotImplementedError(
                    'em anchor init is process-local; pass init_state '
                    'with mesh= (e.g. from a probe-subset fit)')
            blk0 = _as_tuple(read_block(0))
            x0 = jnp.asarray(blk0[0])
            idx = jax.random.choice(key, x0.shape[0], (self.size,),
                                    replace=False)
            anchors = x0[idx]
            scale2 = jnp.maximum(jnp.mean(jnp.var(x0, axis=0)), 1e-6)

            @jax.jit
            def em_init_accum(acc, *block):
                if transfer_dtype is not None:
                    block = tuple(b.astype(jnp.float32) for b in block)
                xb = block[0]
                d2 = jnp.sum((xb[:, None, :] - anchors[None]) ** 2, -1)
                resp, _ = normalize_log(-0.5 * d2 / scale2)
                stats = self.family.suff_stats(block, resp)
                counts = jnp.sum(resp, axis=0)
                return jax.tree.map(jnp.add, acc, (stats, counts))

            acc = None
            total = 0
            with Prefetcher(_read, n_blocks, depth=prefetch) as pf:
                for blk in pf:
                    blk = _assemble(blk)
                    total += blk[0].shape[0]
                    if acc is None:
                        shapes = jax.eval_shape(
                            lambda *b: (self.family.suff_stats(
                                b, jnp.zeros((b[0].shape[0], self.size),
                                             b[0].dtype)),
                                jnp.zeros((self.size,), b[0].dtype)), *blk)
                        acc = jax.tree.map(
                            lambda s: jnp.zeros(s.shape, s.dtype), shapes)
                    acc = em_init_accum(acc, *blk)
            stats, counts = acc
            params = jax.jit(self.family.ml_update)(stats)
            log_pi = jnp.log(jnp.clip(counts, 1e-37, None) / total)
            state = EMState(params, log_pi)

        # ---- jitted per-sweep heads/tails ----
        if kind == 'vi':
            @jax.jit
            def theta_of(state):
                return state.components, state.gating.expected_log_pi()

            @jax.jit
            def mstep(state, res):
                vlb = (res.lse
                       - jnp.sum(self.family.kl(state.components,
                                                self.components_prior))
                       - jnp.sum(state.gating.kl_divergence(
                           self.gating_prior)))
                new = MFState(
                    components=self.family.update(self.components_prior,
                                                  res.stats),
                    gating=self.gating_prior.update(res.counts))
                return new, vlb
        elif kind == 'map':
            @jax.jit
            def theta_of(state):
                params = self.family.mode_params(state.components)
                log_pi = jnp.log(jnp.clip(state.gating.mode(), 1e-37,
                                          None))
                return params, log_pi

            @jax.jit
            def mstep(state, res):
                new = MFState(
                    components=self.family.update(self.components_prior,
                                                  res.stats),
                    gating=self.gating_prior.update(res.counts))
                return new, res.lse
        else:
            @jax.jit
            def theta_of(state):
                return state.params, state.log_pi

            @jax.jit
            def mstep(state, res):
                params = self.family.ml_update(res.stats)
                n_tot = jnp.sum(res.counts)
                log_pi = jnp.log(jnp.clip(res.counts, 1e-37, None)
                                 / n_tot)
                return EMState(params, log_pi), res.lse

        trace = []
        for _ in range(maxiter):
            theta_src, log_pi = theta_of(state)
            res = sweep_estep(theta_src, log_pi)
            state, t = mstep(state, res)
            trace.append(t)   # device scalar — no per-sweep host sync
        import numpy as _np
        jax.block_until_ready(state)
        return _finite_report(
            (state, _np.asarray(jax.device_get(trace), _np.float64)),
            f'fit_{kind}_stream_full')

    def fit_vi_stream_full(self, read_block, n_blocks, key=None,
                           maxiter=50, init_state=None, prefetch=2,
                           backend='auto', block_size=None,
                           transfer_dtype=None, mesh=None):
        """OUT-OF-CORE full-data VI: identical math to fit_vi_fused, with
        the dataset streamed from disk each sweep instead of resident in
        HBM — statistics additivity makes the streamed E-step exact, so
        N is bounded by disk, not device memory (the in-memory engines
        require data[0] to fit in HBM; this one needs only one block).

        `read_block(i) -> (N_i, d) array or tuple of arrays` for
        i in range(n_blocks) — e.g. `lambda i: ds.read_block(i * B, B)`
        over an io.MmapDataset. Blocks may be ragged. A background
        reader thread (prefetch deep) overlaps disk reads with device
        compute. Returns (MFState, vlb_trace ndarray).

        With init_state + the same block partitioning, the result equals
        fit_vi_fused on the same data to float tolerance
        (tests/test_native_loader.py::test_stream_full_equals_in_memory)."""
        return self._fit_epoch_stream(read_block, n_blocks, 'vi', key,
                                      maxiter, init_state, prefetch,
                                      backend, block_size, transfer_dtype,
                                      mesh)

    def fit_map_stream_full(self, read_block, n_blocks, key=None,
                            maxiter=50, init_state=None, prefetch=2,
                            backend='auto', block_size=None,
                            transfer_dtype=None, mesh=None):
        """OUT-OF-CORE full-data MAP-EM (fit_map_fused streamed from
        disk; see fit_vi_stream_full). Returns (MFState, loglik trace)."""
        return self._fit_epoch_stream(read_block, n_blocks, 'map', key,
                                      maxiter, init_state, prefetch,
                                      backend, block_size, transfer_dtype,
                                      mesh)

    def fit_em_stream_full(self, read_block, n_blocks, key=None,
                           maxiter=50, init_state=None, prefetch=2,
                           backend='auto', block_size=None,
                           transfer_dtype=None, mesh=None):
        """OUT-OF-CORE full-data likelihood EM (fit_em_fused streamed
        from disk; anchor init draws the K anchors from block 0).
        Returns (EMState, loglik trace)."""
        return self._fit_epoch_stream(read_block, n_blocks, 'em', key,
                                      maxiter, init_state, prefetch,
                                      backend, block_size, transfer_dtype,
                                      mesh)

    # -- blocked Gibbs (gmm.py:207-237) -------------------------------------

    def _gibbs_sweep(self, state: GibbsState, data, key, point_weights=None):
        """components | labels -> gating | labels -> labels | params."""
        resp = one_hot(state.labels, self.size, dtype=data[0].dtype)
        if point_weights is not None:
            resp = resp * point_weights[:, None]
        stats = self.family.suff_stats(data, resp)
        counts = jnp.sum(resp, axis=0)
        k_comp, k_gate, k_lab = jax.random.split(key, 3)
        gibbs_update = getattr(self.family, 'gibbs_update', None)
        if gibbs_update is not None:
            comp_post, params = gibbs_update(k_comp, self.components_prior,
                                             stats)
        else:
            comp_post = self.family.update(self.components_prior, stats)
            params = self.family.sample_params(k_comp, comp_post)
        gating_post = self.gating_prior.update(counts)
        probs = gating_post.sample(k_gate)
        log_pi = jnp.log(jnp.clip(probs, 1e-37, None))  # bayesian.py:75 clip

        log_p = self.log_complete_likelihood(params, log_pi, data)
        labels = sample_categorical_from_log(k_lab, log_p, axis=-1)
        new = GibbsState(components=comp_post, gating=gating_post,
                         params=params, log_pi=log_pi, labels=labels)
        # data log-likelihood under the sweep's sampled params — free given
        # log_p; used by fit_gibbs(track_loglik=) and smc_gibbs scoring
        loglik = jnp.sum(jax.scipy.special.logsumexp(log_p, axis=-1))
        return new, loglik

    def fit_gibbs(self, data, key=None, maxiter=100, init_labels='prior',
                  point_weights=None, init_state=None, track_loglik=False):
        """Blocked Gibbs sampling. Returns the final GibbsState, or
        (GibbsState, loglik_trace) with track_loglik=True — the per-sweep
        data log-likelihood under the sampled params (mixing diagnostic;
        the reference's tqdm loop exposes nothing).

        Pass a previous GibbsState as `init_state` to continue a chain
        (checkpoint/resume; preemption recovery)."""
        data = _as_tuple(data)
        key = _as_key(key)
        fn = self._jitted('gibbs', maxiter=maxiter, init_labels=init_labels,
                          weighted=point_weights is not None,
                          track=track_loglik,
                          warm=init_state is not None)

        def run(data, key, point_weights, init_state):
            n = data[0].shape[0]
            k_init, k_loop = jax.random.split(key)
            if init_state is not None:
                state = init_state
            else:
                if init_labels == 'random':
                    labels = jax.random.randint(k_init, (n,), 0, self.size)
                else:  # 'prior'
                    k_pi, k_z = jax.random.split(k_init)
                    probs = self.gating_prior.sample(k_pi)
                    labels = jax.random.categorical(
                        k_z, jnp.broadcast_to(
                            jnp.log(jnp.clip(probs, 1e-37, None)),
                            (n, self.size)), axis=-1)
                state = GibbsState(
                    components=self.components_prior,
                    gating=self.gating_prior,
                    params=self.family.mode_params(self.components_prior),
                    log_pi=jnp.log(jnp.full((self.size,), 1.0 / self.size,
                                            data[0].dtype)),
                    labels=labels)

            def step(state, k):
                new, loglik = self._gibbs_sweep(state, data, k,
                                                point_weights)
                return new, (loglik if track_loglik else None)

            keys = jax.random.split(k_loop, maxiter)
            state, trace = jax.lax.scan(step, state, keys)
            return (state, trace) if track_loglik else state

        return _finite_report(fn(run, data, key, point_weights, init_state), 'fit_gibbs')

    # -- MAP EM (gmm.py:176-204) --------------------------------------------

    def fit_map(self, data, key=None, maxiter=250, randomize=True):
        """MAP expectation-maximization: posterior update + mode plug-in.
        Returns (MFState, log-posterior-ish trace of complete-data loglik)."""
        data = _as_tuple(data)
        key = _as_key(key)
        fn = self._jitted('map', maxiter=maxiter, randomize=randomize)

        def run(data, key):
            n = data[0].shape[0]
            resp = _random_resp(key, n, self.size, data[0].dtype)

            def step(resp, _):
                state = self._mf_update(data, resp)
                params = self.family.mode_params(state.components)
                log_pi = jnp.log(jnp.clip(state.gating.mode(), 1e-37, None))
                log_p = self.log_complete_likelihood(params, log_pi, data)
                new_resp, lognorm = normalize_log(log_p)
                return new_resp, jnp.sum(lognorm)

            resp, trace = jax.lax.scan(step, resp, None, length=maxiter)
            state = self._mf_update(data, resp)
            return state, trace

        return _finite_report(fn(run, data, key), 'fit_map')

    # -- prediction & diagnostics -------------------------------------------

    def predictive_log_weights(self, state: MFState):
        """log E_q[pi] — posterior-mean mixture weights (ilr.py:343)."""
        return jnp.log(jnp.clip(state.gating.mean(), 1e-37, None))

    def log_predictive(self, state: MFState, data, dist='studentt'):
        """Posterior-predictive mixture log-density of full observations:
        logsumexp_k [log E[pi_k] + log pred_k(data)] -> (N,).

        One dense pass: a GEMM into (N, K), then log1p and logsumexp,
        which XLA fuses into the reduction. Inputs sharded over a mesh
        give an output sharded the same way (GSPMD)."""
        data = _as_tuple(data)
        log_w = self.predictive_log_weights(state)
        lp = (self.family.log_predictive(state.components, data)
              if dist == 'studentt'
              else self.family.log_predictive_gaussian(state.components, data))
        return jax.scipy.special.logsumexp(lp + log_w[None, :], axis=-1)

    def used_labels(self, state: MFState, data, threshold=0):
        """Bincount of argmax responsibilities (gmm.py:168-173)."""
        data = _as_tuple(data)
        resp = self.expected_responsibilities(state, data)
        labels = jnp.argmax(resp, axis=-1)
        usage = jnp.bincount(labels, length=self.size)
        return usage > threshold

    @property
    def nb_params(self):
        """Number of free likelihood parameters (reference gmm.py:31-34,
        ilr.py:40-42): gating (K-1, categorical.py:23) + per-component
        likelihood params (Gaussian: d + d(d+1)/2, gaussian.py:144;
        diagonal: 2d, :676; linear: pq + p(p+1)/2, lingauss.py:37;
        diag linear: pq + p, :771). For BIC/AIC-style model selection."""
        from mimo_tpu.distributions import niw as _n, ng as _g
        from mimo_tpu.distributions import mnw as _w, mng as _m

        def comp_params(prior):
            if isinstance(prior, _n.NIW):
                k, d = prior.mu.shape
                return k * (d + d * (d + 1) // 2)
            if isinstance(prior, _g.NG):
                k, d = prior.mu.shape
                return k * 2 * d
            if isinstance(prior, _w.MNW):
                k, p, q = prior.M.shape
                return k * (p * q + p * (p + 1) // 2)
            if isinstance(prior, _m.MNG):
                k, p, q = prior.M.shape
                return k * (p * q + p)
            if isinstance(prior, tuple):          # product family (ILR)
                return sum(comp_params(p) for p in prior)
            raise NotImplementedError(
                f'nb_params undefined for {type(prior).__name__} (the '
                f'reference also leaves tied/hierarchical undefined)')

        return (self.size - 1) + comp_params(self.components_prior)

    def with_priors(self, state: MFState) -> 'BayesianMixture':
        """New model whose priors are this state's posteriors — the
        prior <- posterior re-anchoring API (evaluate_sine.py:153-155)."""
        return type(self)._from_parts(state.gating, state.components,
                                      self.family, like=self)

    @classmethod
    def _from_parts(cls, gating_prior, components_prior, family, like=None):
        obj = cls.__new__(cls)
        BayesianMixture.__init__(obj, gating_prior, components_prior, family)
        if like is not None:
            obj.__dict__.update({k: v for k, v in like.__dict__.items()
                                 if k not in obj.__dict__})
        return obj

    # -- jit plumbing --------------------------------------------------------

    def _jitted(self, name, **statics):
        """Cache a jitted runner per (method, static-config). The runner's
        first argument is the (non-hashable) python closure `run`; we wrap so
        jit only sees array pytrees."""
        key = (name, tuple(sorted(statics.items())))
        if key not in self._cache:
            dispatcher = {}

            def wrapper(run, *args):
                if 'fn' not in dispatcher:
                    dispatcher['fn'] = jax.jit(run)
                cap = getattr(self, '_capture_lowered', None)
                if cap is not None:
                    # communication-contract introspection (tests/
                    # test_sharding.py::test_communication_contract):
                    # expose the lowered program so the collective count
                    # and payload sizes can be asserted against the
                    # README's pod-scaling claim
                    cap[name] = dispatcher['fn'].lower(*args)
                return dispatcher['fn'](*args)

            self._cache[key] = wrapper
        return self._cache[key]


# Largest feature width m and component count K (after flattening nested
# mixtures) the fused kernel takes (see _resolve_backend).
KERNEL_MAX_FEATURES = 10
KERNEL_MAX_COMPONENTS = 256


def _kernel_refusal(spec, prior):
    """Why the fused kernel does not take this model, or None."""
    if getattr(spec, 'feature_rows', None) is None:
        return ('the fused kernel supports families with a kernel-side '
                'feature assembler (full/diag/tied/hierarchical GMMs and '
                'mixtures of linear experts) only')
    k, m = jax.eval_shape(spec.theta, prior).shape
    if m > KERNEL_MAX_FEATURES:
        return (f'feature width {m} > KERNEL_MAX_FEATURES='
                f'{KERNEL_MAX_FEATURES}: the kernel loses to XLA there')
    if k > KERNEL_MAX_COMPONENTS:
        return (f'{k} components > KERNEL_MAX_COMPONENTS='
                f'{KERNEL_MAX_COMPONENTS}: the kernel loses to XLA there')
    return None


def _resolve_backend(backend, spec, prior):
    """Engine for the fused fits: 'xla' (blockwise lax.scan), 'pallas'
    (the fused GPU kernel, ops/triton_estep.py) or 'interpret' (that
    kernel through the Pallas interpreter — tests on machines without a
    GPU). 'pallas' and 'interpret' take only the models the kernel takes
    (_kernel_refusal), and 'pallas' needs a GPU; each raises otherwise,
    never falling back.

    'auto' picks the kernel on a GPU where it measured faster than XLA,
    and the XLA engine everywhere else. The rule: feature width
    m <= KERNEL_MAX_FEATURES = 10 (full-covariance GMMs to d=2, diagonal
    ones to d=4, mixtures of linear experts with one input and one
    output) and K <= KERNEL_MAX_COMPONENTS = 256. Measured end to end on
    one H100 80GB HBM3 at 700 W (PERF.md, "Bring-up measurements"),
    kernel against XLA:
      m=7,  N=1e7, K=50:  fit_vi_fused 442 it/s vs 65.2,
                          fit_gibbs_fused 273 sweeps/s vs 52.6;
      m=7,  N=1e7, K=128: fit_vi_fused 196.8 it/s vs 69.9;
      m=7,  N=1e7, K=256: 100.6 it/s vs 40.1;
      m=7,  N=1e7, K=512: 9.5 it/s vs 22.1 (the (Kp, 16) tile spills);
      m=10, N=1e6, K=50 (ILR q=1): 1847.5 it/s vs 596.9;
      m=21, N=1e7, K=50 (GMM d=4): 46.8 it/s vs 104.1;
      m=164, N=1e6, K=50 (ILR q=8): one E-step 136.8 ms vs 2.85 ms,
                          after 326 s of compilation.
    Widths 11..20 were not measured and go to XLA. The kernel holds
    m x Kp theta values, m feature rows and a (Kp, T) tile in registers,
    so it wins only while m and K are small; wide specs are GEMMs, which
    XLA's library calls do well."""
    if backend == 'xla':
        return 'xla'
    if backend not in ('auto', 'pallas', 'interpret'):
        raise ValueError(f'unknown backend: {backend!r}')
    refusal = _kernel_refusal(spec, prior)
    if backend == 'auto':
        if refusal is None and jax.default_backend() == 'gpu':
            return 'pallas'
        return 'xla'
    if refusal is not None:
        raise ValueError(f"{refusal}; use backend='auto' or 'xla'")
    if backend == 'pallas' and jax.default_backend() != 'gpu':
        raise RuntimeError(
            "backend='pallas' needs a GPU; use backend='xla' (or "
            "'interpret' to run the kernel through the Pallas "
            'interpreter)')
    return backend


def _fused_block_size(n, mesh, engine, block_size, alt_engine):
    """Scan block for the XLA engine (None for the kernel, which takes any
    N): `block_size`, or pick_block_size of the per-device rows, which
    must be a multiple of it."""
    if engine != 'xla':
        return None
    local_n = n if mesh is None else n // mesh.shape['data']
    if block_size is None:
        block_size = pick_block_size(local_n)
    if local_n % block_size:
        raise ValueError(
            f'per-device N={local_n} must be a multiple of '
            f'block_size={block_size}; pass a block_size dividing it '
            f'(any divisor works for the XLA engine), or use {alt_engine}')
    return block_size


def _as_tuple(data):
    return data if isinstance(data, tuple) else (data,)


def _as_key(key):
    if key is None:
        return jax.random.PRNGKey(0)
    if isinstance(key, int):
        return jax.random.PRNGKey(key)
    return key


def _random_resp(key, n, k, dtype):
    """Random normalized responsibilities (gmm.py:266-268)."""
    r = jax.random.uniform(key, (n, k), dtype=dtype, minval=1e-3, maxval=1.0)
    return r / jnp.sum(r, axis=-1, keepdims=True)
