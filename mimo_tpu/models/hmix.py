"""Two-level nested mixtures: an outer mixture over M clusters, each
cluster holding its own inner mixture of K components.

JAX re-design of BayesianMixtureOfMixtureOfGaussians (hgmm.py:298-)
and BayesianMixtureOfMixtureOfLinearGaussians (hilr.py:293-). Key design
changes vs the reference:

  * The M inner models are a **vmapped batch axis**, not a Python list —
    every inner update runs for all clusters at once.
  * Hard assignment (`obs[labels == m]`, hgmm.py:355-361 — dynamic shapes)
    becomes **weighted (masked) updates**: outer responsibilities/one-hot
    labels scale each point's statistics in every inner model. This is
    exact for the conjugate updates (statistics are linear in the weights)
    and keeps all shapes static for XLA.
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from mimo_tpu.conjugate.families import Family
from mimo_tpu.utils.data import one_hot, sample_batch_indices
from mimo_tpu.utils.sanitize import finite_report as _finite_report
from mimo_tpu.utils.stats import (
    normalize_log, sample_categorical_from_log,
)


class HMixState(NamedTuple):
    """Mean-field state of the nested mixture."""
    outer_gating: Any   # Dirichlet | StickBreaking posterior over M
    inner_gating: Any   # M-stacked gating posterior over K
    components: Any     # M-stacked family posterior (M, K, ...)


class HMixGibbsState(NamedTuple):
    outer_gating: Any
    inner_gating: Any
    components: Any
    labels: jax.Array       # (N,) outer cluster labels


class HMixEMState(NamedTuple):
    """Likelihood-only (ML) nested-mixture state (hgmm.py:16, hilr.py:18)."""
    params: Any                 # (M, K, ...) likelihood params
    inner_log_pi: jax.Array     # (M, K)
    outer_log_pi: jax.Array     # (M,)


class BayesianMixtureOfMixtures:
    """Outer gating over M clusters; each cluster an inner conjugate
    mixture over K components (same family across clusters)."""

    def __init__(self, outer_gating_prior, inner_gating_prior,
                 components_prior, family: Family, kind='gmm', affine=True):
        """inner_gating_prior and components_prior carry a leading M axis."""
        self.outer_gating_prior = outer_gating_prior
        self.inner_gating_prior = inner_gating_prior
        self.components_prior = components_prior
        self.family = family
        self.kind = kind
        self.affine = affine
        self.input_transform = None
        self.output_transform = None
        self.cluster_size = outer_gating_prior.dim
        self.mixture_size = jax.tree.leaves(inner_gating_prior)[0].shape[-1]
        self._cache = {}

    @staticmethod
    def make_gmm(cluster_size, mixture_size, dim, alpha=1.0,
                 inner_alpha=1.0, hierarchical=True, kappa=1e-2,
                 psi_scale=1.0, maxsubiter=5, means=None,
                 dtype=jnp.float32):
        """Mixture of (hierarchical) GMMs (examples/hgmm). Inner priors are
        replicated across the M clusters; optional `means` (M, dim) gives
        each cluster's hyper-prior its own center (the reference examples
        build informative per-cluster priors inline the same way)."""
        from mimo_tpu.conjugate.families import (
            gaussian_family, hier_gaussian_family)
        from mimo_tpu.distributions.gating import Dirichlet
        from mimo_tpu.distributions.hierarchical import HierTied
        from mimo_tpu.distributions.niw import NIW

        outer = Dirichlet.standard(cluster_size, alpha, dtype)
        inner_g = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (cluster_size,) + a.shape),
            Dirichlet.standard(mixture_size, inner_alpha, dtype))
        if hierarchical:
            comp = HierTied.standard(mixture_size, dim, kappa=1.0,
                                     hyper_kappa=kappa, psi_scale=psi_scale,
                                     dtype=dtype)
            fam = hier_gaussian_family(nb_iter=maxsubiter,
                                       gibbs_iter=max(1, maxsubiter // 2))
        else:
            comp = NIW.standard(mixture_size, dim, kappa=kappa,
                                psi_scale=psi_scale, dtype=dtype)
            fam = gaussian_family()
        comp_m = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (cluster_size,) + a.shape), comp)
        if means is not None:
            means = jnp.asarray(means, dtype)             # (M, dim)
            if hierarchical:
                comp_m = comp_m._replace(
                    hyper=comp_m.hyper._replace(
                        mu=means[:, None, :]),
                    mus=jnp.broadcast_to(means[:, None, :],
                                         (cluster_size, mixture_size, dim)))
            else:
                comp_m = comp_m._replace(
                    mu=jnp.broadcast_to(means[:, None, :],
                                        (cluster_size, mixture_size, dim)))
        return BayesianMixtureOfMixtures(outer, inner_g, comp_m, fam)

    @staticmethod
    def make_ilr(cluster_size, mixture_size, input_dim, output_dim,
                 alpha=1.0, inner_alpha=1.0, affine=True, kappa=1e-2,
                 K_scale=1e-2, psi_scale=1.0, dtype=jnp.float32):
        """Mixture of mixtures of linear experts (examples/hilr)."""
        from mimo_tpu.conjugate.families import ilr_family
        from mimo_tpu.distributions.gating import Dirichlet
        from mimo_tpu.distributions.niw import NIW
        from mimo_tpu.distributions.mnw import MNW

        outer = Dirichlet.standard(cluster_size, alpha, dtype)
        inner_g = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (cluster_size,) + a.shape),
            Dirichlet.standard(mixture_size, inner_alpha, dtype))
        q = input_dim + (1 if affine else 0)
        comp = (NIW.standard(mixture_size, input_dim, kappa=kappa,
                             psi_scale=psi_scale, dtype=dtype),
                MNW.standard(mixture_size, output_dim, q, K_scale=K_scale,
                             psi_scale=psi_scale, dtype=dtype))
        comp_m = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (cluster_size,) + a.shape), comp)
        return BayesianMixtureOfMixtures(outer, inner_g, comp_m,
                                         ilr_family(affine=affine),
                                         kind='ilr', affine=affine)

    # -- expectations -------------------------------------------------------

    def _inner_elc(self, state: HMixState, data):
        """(M, N, K): per-cluster inner expected log complete likelihood."""
        def per_cluster(comp, gating):
            return self.family.ell(comp, data) + gating.expected_log_pi()[None, :]
        return jax.vmap(per_cluster)(state.components, state.inner_gating)

    def expected_cluster_loglik(self, state: HMixState, data):
        """(N, M): marginal inner loglik per cluster (hgmm.py:363-366)."""
        elc = self._inner_elc(state, data)            # (M, N, K)
        return logsumexp(elc, axis=-1).T              # (N, M)

    def expected_responsibilities(self, state: HMixState, data):
        """Outer responsibilities (N, M)."""
        log_p = (self.expected_cluster_loglik(state, data)
                 + state.outer_gating.expected_log_pi()[None, :])
        resp, _ = normalize_log(log_p)
        return resp

    # -- updates ------------------------------------------------------------

    def _inner_update(self, data, inner_resp, outer_resp):
        """Weighted inner m-step for all clusters at once.

        inner_resp: (M, N, K) within-cluster responsibilities;
        outer_resp: (N, M) cluster weights scaling each point's stats."""
        weighted = inner_resp * outer_resp.T[:, :, None]    # (M, N, K)

        def per_cluster(prior_c, prior_g, w):
            stats = self.family.suff_stats(data, w)
            counts = jnp.sum(w, axis=0)
            return self.family.update(prior_c, stats), prior_g.update(counts)

        comps, gatings = jax.vmap(per_cluster, in_axes=(0, 0, 0))(
            self.components_prior, self.inner_gating_prior, weighted)
        return comps, gatings

    def _vi_sweep(self, state: HMixState, data, maxsubiter):
        outer_resp = self.expected_responsibilities(state, data)

        def sub(j, st):
            elc = self._inner_elc(st, data)                  # (M, N, K)
            inner_resp = jax.nn.softmax(elc, axis=-1)
            comps, gatings = self._inner_update(data, inner_resp, outer_resp)
            return HMixState(outer_gating=st.outer_gating,
                             inner_gating=gatings, components=comps)

        state = jax.lax.fori_loop(0, maxsubiter, sub, state)
        outer_gating = self.outer_gating_prior.update(
            jnp.sum(outer_resp, axis=0))
        return state._replace(outer_gating=outer_gating)

    def _tx_data(self, data):
        data = data if isinstance(data, tuple) else (data,)
        if self.kind == 'ilr' and self.input_transform is not None:
            data = (self.input_transform.transform(data[0]),
                    self.output_transform.transform(data[1]))
        return data

    def fit_vi(self, data, key=None, maxiter=100, maxsubiter=3,
               randomize=True):
        """Nested mean-field coordinate ascent (hgmm.py:382-431)."""
        data = self._tx_data(data)
        key = _as_key(key)
        fn = self._jit('vi', maxiter=maxiter, maxsubiter=maxsubiter,
                       randomize=randomize)

        def run(data, key):
            n = data[0].shape[0]
            m = self.cluster_size
            r = jax.random.uniform(key, (n, m), dtype=data[0].dtype,
                                   minval=1e-3, maxval=1.0)
            outer_resp = r / jnp.sum(r, axis=-1, keepdims=True)
            # bootstrap: random inner resp, one weighted update
            k2 = jax.random.fold_in(key, 1)
            ir = jax.random.uniform(
                k2, (m, n, self.mixture_size), dtype=data[0].dtype,
                minval=1e-3, maxval=1.0)
            inner_resp = ir / jnp.sum(ir, axis=-1, keepdims=True)
            comps, gatings = self._inner_update(data, inner_resp, outer_resp)
            state = HMixState(
                outer_gating=self.outer_gating_prior.update(
                    jnp.sum(outer_resp, axis=0)),
                inner_gating=gatings, components=comps)

            def step(st, _):
                st = self._vi_sweep(st, data, maxsubiter)
                ll = jnp.sum(logsumexp(
                    self.expected_cluster_loglik(st, data)
                    + st.outer_gating.expected_log_pi()[None, :], axis=-1))
                return st, ll

            state, trace = jax.lax.scan(step, state, None, length=maxiter)
            return state, trace

        return _finite_report(fn(run, data, key), 'fit_vi')

    def _flat_spec(self):
        """EStepSpec over the FLAT M*K expert axis: the two-level joint
        responsibility r_{n,m,k} factors exactly into outer_{n,m} *
        inner_{n,m,k} with joint logits log pi_m + log pi_mk + ell_mk, so
        the generic fused machinery (family_estep) applies with the
        (M, K)-stacked posteriors/params flattened."""
        from mimo_tpu.ops.family_estep import (
            EStepSpec, gaussian_spec, hier_gaussian_spec, ilr_spec)
        from mimo_tpu.distributions.hierarchical import HierTied
        mm, kk = self.cluster_size, self.mixture_size
        cp = self.components_prior
        if self.kind == 'ilr':
            base = ilr_spec(cp[0].mu.shape[-1], cp[1].M.shape[-2],
                            affine=self.affine)
        elif isinstance(cp, HierTied):
            base = hier_gaussian_spec()
        else:
            base = gaussian_spec()
        return EStepSpec(
            features=base.features,
            theta=lambda comps: jax.vmap(base.theta)(comps).reshape(
                mm * kk, -1),
            unpack=base.unpack,
            theta_plugin=None if base.theta_plugin is None else
            (lambda params: jax.vmap(base.theta_plugin)(params).reshape(
                mm * kk, -1)),
            # the kernel-side feature assembler is label-agnostic, so the
            # flat M*K spec inherits it — nested fused engines run on the
            # same kernel as the flat models
            feature_rows=base.feature_rows)

    def _split_flat(self, res):
        """Reshape a flat M*K FusedEStep back to (M, K)-stacked counts and
        stats."""
        mm, kk = self.cluster_size, self.mixture_size
        counts = res.counts.reshape(mm, kk)
        stats = jax.tree.map(
            lambda a: a.reshape((mm, kk) + a.shape[1:]), res.stats)
        return counts, stats

    def fit_vi_fused(self, data, key=None, maxiter=100, block_size=None,
                     randomize=True, tol=None, mesh=None, backend='auto'):
        """Fused blockwise nested VI for big N: the two-level E-step runs
        as one FLAT softmax over all M*K experts (see _flat_spec); the
        M-step splits the flat counts back into per-cluster inner updates
        plus the outer update. Equivalent to fit_vi's coordinate ascent
        at maxsubiter=1.

        With `mesh` (a ('chain','data') mesh from parallel.make_mesh) the
        E-step runs under shard_map over the 'data' axis — each device
        scans its local shard's blocks and one (M*K, m) psum crosses the
        mesh per sweep (ops/family_estep.fused_estep_sharded).

        `backend`/`block_size`: as in BayesianMixture.fit_vi_fused — the
        flat M*K spec inherits the family's kernel-side feature
        assembler, so the fused kernel runs with K = M*K rows.

        Returns (HMixState, trace); the trace is the nested ELBO
        (lse identity + KL terms), unlike fit_vi's expected-complete
        log-likelihood trace. `tol` stops early on |dELBO| < tol."""
        from mimo_tpu.ops.family_estep import estep_engine
        from mimo_tpu.models.mixture import (
            _elbo_loop, _fused_block_size, _resolve_backend)

        data = self._tx_data(data)
        key = _as_key(key)
        mm, kk = self.cluster_size, self.mixture_size
        spec = self._flat_spec()
        engine = _resolve_backend(backend, spec, self.components_prior)
        block_size = _fused_block_size(data[0].shape[0], mesh, engine,
                                       block_size, 'fit_vi')
        estep = estep_engine(spec, engine, block_size, mesh)
        fn = self._jit('vi_fused', maxiter=maxiter, block_size=block_size,
                       randomize=randomize, tol=tol is not None, mesh=mesh,
                       engine=engine)

        def run(data, key, tol):
            n = data[0].shape[0]
            r = jax.random.uniform(key, (n, mm), dtype=data[0].dtype,
                                   minval=1e-3, maxval=1.0)
            outer_resp = r / jnp.sum(r, axis=-1, keepdims=True)
            k2 = jax.random.fold_in(key, 1)
            ir = jax.random.uniform(k2, (mm, n, kk), dtype=data[0].dtype,
                                    minval=1e-3, maxval=1.0)
            inner_resp = ir / jnp.sum(ir, axis=-1, keepdims=True)
            comps, gatings = self._inner_update(data, inner_resp,
                                                outer_resp)
            state = HMixState(
                outer_gating=self.outer_gating_prior.update(
                    jnp.sum(outer_resp, axis=0)),
                inner_gating=gatings, components=comps)

            def step(st, _):
                lp_in = jax.vmap(lambda g: g.expected_log_pi())(
                    st.inner_gating)                          # (M, K)
                lp = (st.outer_gating.expected_log_pi()[:, None]
                      + lp_in).reshape(-1)
                res = estep(st.components, lp, data)
                counts, stats = self._split_flat(res)
                comps, gatings = jax.vmap(
                    lambda pc, pg, s, c: (self.family.update(pc, s),
                                          pg.update(c)))(
                    self.components_prior, self.inner_gating_prior,
                    stats, counts)
                outer = self.outer_gating_prior.update(
                    jnp.sum(counts, axis=-1))
                kl_c = jnp.sum(jax.vmap(self.family.kl)(
                    st.components, self.components_prior))
                kl_gi = jnp.sum(jax.vmap(lambda q, p: q.kl_divergence(p))(
                    st.inner_gating, self.inner_gating_prior))
                kl_go = jnp.sum(st.outer_gating.kl_divergence(
                    self.outer_gating_prior))
                vlb = res.lse - kl_c - kl_gi - kl_go
                return HMixState(outer_gating=outer, inner_gating=gatings,
                                 components=comps), vlb

            return _elbo_loop(step, state, maxiter, tol)

        return _finite_report(fn(run, data, key, tol), 'fit_vi_fused')

    def fit_gibbs_fused(self, data, key=None, maxiter=100, block_size=None,
                        mesh=None, backend='auto'):
        """Fused blockwise nested Gibbs for big N: the (outer, inner)
        labels are sampled JOINTLY as one flat categorical over all M*K
        experts per point — a valid blocked-Gibbs move on (z_n, c_n) given
        the sampled params, with better mixing than the reference's
        z-then-c schedule (hgmm.py:326-361) — so the whole label sweep is
        the generic fused two-matmul kernel (ops/family_estep) and the
        dense (M, N, K) log-prob tensor of fit_gibbs never exists.

        With `mesh`, labels stay device-local and one (M*K, m) psum
        crosses the mesh per sweep (fused_gibbs_sharded).

        Returns HMixGibbsState (labels are the OUTER cluster labels,
        = flat_label // K, matching fit_gibbs).

        `backend`/`block_size`: as in BayesianMixture.fit_vi_fused."""
        from mimo_tpu.ops.family_estep import gibbs_engine
        from mimo_tpu.models.mixture import (
            _fused_block_size, _resolve_backend)

        data = self._tx_data(data)
        key = _as_key(key)
        mm, kk = self.cluster_size, self.mixture_size
        spec = self._flat_spec()
        if spec.theta_plugin is None:
            raise NotImplementedError(
                'no fused Gibbs spec for this family; use fit_gibbs')
        engine = _resolve_backend(backend, spec, self.components_prior)
        block_size = _fused_block_size(data[0].shape[0], mesh, engine,
                                       block_size, 'fit_gibbs')
        sweep_labels = gibbs_engine(spec, engine, block_size, mesh)
        fn = self._jit('gibbs_fused', maxiter=maxiter,
                       block_size=block_size, mesh=mesh, engine=engine)
        gibbs_update = getattr(self.family, 'gibbs_update', None)

        def run(data, key):
            dtype = data[0].dtype
            comps0 = self.components_prior
            gatings0 = self.inner_gating_prior
            outer0 = self.outer_gating_prior
            params0 = jax.vmap(self.family.mode_params)(comps0)

            def sweep(carry, k):
                comps, gatings, outer, params_prev, _ = carry
                k_par, k_po, k_pi, k_lab = jax.random.split(k, 4)
                if gibbs_update is None:
                    params = jax.vmap(self.family.sample_params)(
                        jax.random.split(k_par, mm), comps)
                else:
                    # hierarchical-style families sample params inside
                    # their own gibbs_update below; reuse last sweep's
                    params = params_prev
                pi_o = outer.sample(k_po)
                pi_i = jax.vmap(lambda g, kk_: g.sample(kk_))(
                    gatings, jax.random.split(k_pi, mm))       # (M, K)
                log_pi = (jnp.log(jnp.clip(pi_o, 1e-37, None))[:, None]
                          + jnp.log(jnp.clip(pi_i, 1e-37, None))
                          ).reshape(-1)
                labels, res = sweep_labels(k_lab, params, log_pi, data)
                counts, stats = self._split_flat(res)
                if gibbs_update is None:
                    comps = jax.vmap(
                        lambda p, s: self.family.update(p, s))(
                        self.components_prior, stats)
                else:
                    comps, params = jax.vmap(gibbs_update)(
                        jax.random.split(k_par, mm),
                        self.components_prior, stats)
                gatings = jax.vmap(lambda p, c: p.update(c))(
                    self.inner_gating_prior, counts)
                outer = self.outer_gating_prior.update(
                    jnp.sum(counts, axis=-1))
                # labels ride the carry (stacking them as a scan output
                # would materialize (maxiter, N) in HBM)
                return (comps, gatings, outer, params, labels), None

            n = data[0].shape[0]
            labels0 = jnp.zeros((n,), jnp.int32)
            (comps, gatings, outer, _, labels), _ = jax.lax.scan(
                sweep, (comps0, gatings0, outer0, params0, labels0),
                jax.random.split(key, maxiter))
            return HMixGibbsState(outer_gating=outer, inner_gating=gatings,
                                  components=comps,
                                  labels=labels // kk)

        return _finite_report(fn(run, data, key), 'fit_gibbs_fused')

    # -- likelihood-only EM (hgmm.py:59-88, hilr.py:39-78) ------------------

    def _em_inner_loglik(self, state: HMixEMState, data):
        """(M, N, K): plug-in inner complete log-likelihood."""
        def per_cluster(params, log_pi):
            return self.family.loglik(params, data) + log_pi[None, :]
        return jax.vmap(per_cluster)(state.params, state.inner_log_pi)

    def cluster_log_likelihood(self, state: HMixEMState, data):
        """(N, M): marginal inner log-likelihood per cluster under plug-in
        parameters (hgmm.py:47-52 log_complete_likelihood)."""
        data = self._tx_data(data)
        return logsumexp(self._em_inner_loglik(state, data), axis=-1).T

    def log_likelihood(self, state: HMixEMState, data):
        """(N,): marginal log-likelihood (hgmm.py:42-44)."""
        return logsumexp(self.cluster_log_likelihood(state, data)
                         + state.outer_log_pi[None, :], axis=-1)

    def responsibilities(self, state: HMixEMState, data):
        """(N, M) outer responsibilities under plug-in params
        (hgmm.py:54-57)."""
        log_p = (self.cluster_log_likelihood(state, data)
                 + state.outer_log_pi[None, :])
        resp, _ = normalize_log(log_p)
        return resp

    def fit_em(self, data, key=None, maxiter=100, maxsubiter=5):
        """Nested likelihood-only EM (the reference's
        MixtureOfMixtureOfGaussians.max_likelihood, hgmm.py:59-88, and its
        ILR analogue hilr.py:39-78): outer E-step over clusters, then per
        cluster `maxsubiter` weighted inner EM iterations (the reference
        calls components[m].max_likelihood(weights=resp[m]) — here all M
        clusters run vmapped at once). Requires the family to provide an
        ml_update (hierarchical families don't; build with
        hierarchical=False). Returns (HMixEMState, loglik trace)."""
        if self.family.ml_update is None:
            raise NotImplementedError(
                'this family has no maximum-likelihood update; build the '
                'model with hierarchical=False or use fit_vi/fit_gibbs')
        data = self._tx_data(data)
        key = _as_key(key)
        fn = self._jit('em', maxiter=maxiter, maxsubiter=maxsubiter)

        def m_step(inner_resp, outer_resp):
            """Weighted ML for all clusters: params + inner mixing."""
            weighted = inner_resp * outer_resp.T[:, :, None]    # (M, N, K)

            def per_cluster(w):
                params = self.family.ml_update(
                    self.family.suff_stats(data, w))
                counts = jnp.sum(w, axis=0)
                log_pi = jnp.log(jnp.clip(
                    counts / jnp.clip(jnp.sum(counts), 1e-37, None),
                    1e-37, None))
                return params, log_pi

            return jax.vmap(per_cluster)(weighted)

        def run(data, key):
            n = data[0].shape[0]
            m, kk = self.cluster_size, self.mixture_size
            # anchor-seeded responsibilities at BOTH levels (sklearn-style
            # 'random' k-means seeding, as in BayesianMixture.fit_em): the
            # reference's flat-random outer init (hgmm.py:63-65) relies on
            # each sub-model randomizing independently to break symmetry;
            # with vmapped inner updates a flat init is an exact symmetric
            # fixed point, so seed by distance to random data points.
            x0 = data[0]
            idx = jax.random.choice(key, n, (m, kk), replace=False)
            anchors = x0[idx]                                   # (M, K, d)
            scale2 = jnp.maximum(jnp.mean(jnp.var(x0, axis=0)), 1e-6)
            d2 = jnp.sum((x0[None, :, None, :]
                          - anchors[:, None, :, :]) ** 2, axis=-1)
            inner_resp = jax.nn.softmax(-0.5 * d2 / scale2, axis=-1)
            # outer resp from the same anchors: best-matching anchor in
            # each cluster
            outer_resp = jax.nn.softmax(
                -0.5 * jnp.min(d2, axis=-1).T / scale2, axis=-1)  # (N, M)

            def step(carry, _):
                inner_resp, outer_resp = carry

                def sub(j, ir):
                    params, ilp = m_step(ir, outer_resp)
                    elc = (jax.vmap(lambda p:
                                    self.family.loglik(p, data))(params)
                           + ilp[:, None, :])
                    return jax.nn.softmax(elc, axis=-1)

                inner_resp = jax.lax.fori_loop(0, maxsubiter, sub,
                                               inner_resp)
                params, inner_log_pi = m_step(inner_resp, outer_resp)
                outer_counts = jnp.sum(outer_resp, axis=0)
                outer_log_pi = jnp.log(jnp.clip(outer_counts / n,
                                                1e-37, None))
                state = HMixEMState(params, inner_log_pi, outer_log_pi)
                log_p = (logsumexp(self._em_inner_loglik(state, data),
                                   axis=-1).T
                         + outer_log_pi[None, :])
                outer_resp, lognorm = normalize_log(log_p)
                return (inner_resp, outer_resp), (state,
                                                  jnp.sum(lognorm))

            (_, _), (states, trace) = jax.lax.scan(
                step, (inner_resp, outer_resp), None, length=maxiter)
            return jax.tree.map(lambda a: a[-1], states), trace

        return _finite_report(fn(run, data, key), 'fit_em')

    def fit_em_fused(self, data, key=None, maxiter=100, block_size=None,
                     mesh=None, backend='auto'):
        """Nested likelihood-only EM through the fused blockwise engines:
        the two-level plug-in E-step is one FLAT softmax over all M*K
        experts (the joint responsibility factors exactly, see
        _flat_spec), fed spec.theta_plugin(ml_params) — so nested EM
        scales to HBM-resident N like the fused VI/Gibbs (the (M, N, K)
        responsibility tensor of fit_em never exists; the anchor INIT
        still materializes one (N, M*K) distance matrix + dense stats, a
        one-time cost shared with the flat engine). Equivalent to
        fit_em's coordinate ascent at maxsubiter=1 with jointly-updated
        outer weights. mesh/backend as in fit_vi_fused. Returns
        (HMixEMState, loglik trace). Reference anchor: hgmm.py:59-88 /
        hilr.py:39-78 (the dense nested ML loop)."""
        from mimo_tpu.ops.family_estep import estep_engine
        from mimo_tpu.models.mixture import (
            _fused_block_size, _resolve_backend)
        from mimo_tpu.utils.stats import normalize_log as _nl
        if self.family.ml_update is None:
            raise NotImplementedError(
                'this family has no maximum-likelihood update; build the '
                'model with hierarchical=False or use fit_vi/fit_gibbs')
        data = self._tx_data(data)
        key = _as_key(key)
        mm, kk = self.cluster_size, self.mixture_size
        spec = self._flat_spec()
        if spec.theta_plugin is None:
            raise NotImplementedError(
                'no fused plug-in spec for this family; use fit_em')
        engine = _resolve_backend(backend, spec, self.components_prior)
        block_size = _fused_block_size(data[0].shape[0], mesh, engine,
                                       block_size, 'fit_em')
        fn = self._jit('em_fused', maxiter=maxiter, block_size=block_size,
                       mesh=mesh, engine=engine)
        estep = estep_engine(spec._replace(theta=spec.theta_plugin), engine,
                             block_size, mesh)

        def run(data, key):
            n = data[0].shape[0]
            # flat M*K anchor seeding (as BayesianMixture.fit_em_fused;
            # a flat random init is a symmetric fixed point under vmap)
            x0 = data[0]
            idx = jax.random.choice(key, n, (mm * kk,), replace=False)
            anchors = x0[idx]
            scale2 = jnp.maximum(jnp.mean(jnp.var(x0, axis=0)), 1e-6)
            d2 = jnp.sum((x0[:, None, :] - anchors[None, :, :]) ** 2, -1)
            resp, _ = _nl(-0.5 * d2 / scale2)            # (N, M*K)
            stats_flat = self.family.suff_stats(data, resp)
            stats = jax.tree.map(
                lambda a: a.reshape((mm, kk) + a.shape[1:]), stats_flat)
            counts = jnp.sum(resp, axis=0).reshape(mm, kk)
            params = jax.vmap(self.family.ml_update)(stats)

            def log_pis(counts):
                csum = jnp.sum(counts, axis=-1)                   # (M,)
                ilp = jnp.log(jnp.clip(
                    counts / jnp.clip(csum[:, None], 1e-37, None),
                    1e-37, None))
                olp = jnp.log(jnp.clip(csum / n, 1e-37, None))
                return ilp, olp

            ilp, olp = log_pis(counts)

            def step(carry, _):
                params, ilp, olp = carry
                log_pi = (olp[:, None] + ilp).reshape(-1).astype(dtype)
                res = estep(params, log_pi, data)
                counts, stats = self._split_flat(res)
                params = jax.vmap(self.family.ml_update)(stats)
                ilp, olp = log_pis(counts)
                return (params, ilp, olp), res.lse

            (params, ilp, olp), trace = jax.lax.scan(
                step, (params, ilp, olp), None, length=maxiter)
            return HMixEMState(params, ilp, olp), trace

        return _finite_report(fn(run, data, key), 'fit_em_fused')

    # -- MAP EM --------------------------------------------------------------

    def fit_map(self, data, key=None, maxiter=100, maxsubiter=5):
        """Nested MAP expectation-maximization: posterior update + mode
        plug-in at BOTH levels, weight-masked inner updates.

        The reference declares but never implements this engine — its
        nested-ILR `max_aposteriori` raises NotImplementedError
        (hilr.py:341-344) and the nested GMM omits it entirely — so this
        fills the one engine x model hole: the natural composition of the
        flat MAP-EM (gmm.py:176-204) with the nested weighted E-step
        (hgmm.py:422-431). Per sweep: outer responsibilities under plug-in
        mode params -> `maxsubiter` inner MAP iterations (posterior <-
        prior (+) weighted stats; params <- mode) -> outer gating MAP.
        Returns (HMixState, complete-data log-posterior-ish trace)."""
        data = self._tx_data(data)
        key = _as_key(key)
        fn = self._jit('map', maxiter=maxiter, maxsubiter=maxsubiter)

        def m_step(inner_resp, outer_resp):
            """Weighted MAP at both levels -> (HMixState, plug-in params,
            inner log_pi (M, K))."""
            weighted = inner_resp * outer_resp.T[:, :, None]    # (M, N, K)

            def per_cluster(prior_c, prior_g, w):
                stats = self.family.suff_stats(data, w)
                counts = jnp.sum(w, axis=0)
                comp = self.family.update(prior_c, stats)
                gating = prior_g.update(counts)
                params = self.family.mode_params(comp)
                log_pi = jnp.log(jnp.clip(gating.mode(), 1e-37, None))
                return comp, gating, params, log_pi

            comps, gatings, params, ilp = jax.vmap(per_cluster)(
                self.components_prior, self.inner_gating_prior, weighted)
            outer = self.outer_gating_prior.update(
                jnp.sum(outer_resp, axis=0))
            state = HMixState(outer_gating=outer, inner_gating=gatings,
                              components=comps)
            return state, params, ilp

        def run(data, key):
            n = data[0].shape[0]
            m, kk = self.cluster_size, self.mixture_size
            # anchor-seeded responsibilities at both levels (see fit_em:
            # a flat random init is a symmetric fixed point under vmap)
            x0 = data[0]
            idx = jax.random.choice(key, n, (m, kk), replace=False)
            anchors = x0[idx]                                   # (M, K, d)
            scale2 = jnp.maximum(jnp.mean(jnp.var(x0, axis=0)), 1e-6)
            d2 = jnp.sum((x0[None, :, None, :]
                          - anchors[:, None, :, :]) ** 2, axis=-1)
            inner_resp0 = jax.nn.softmax(-0.5 * d2 / scale2, axis=-1)
            outer_resp0 = jax.nn.softmax(
                -0.5 * jnp.min(d2, axis=-1).T / scale2, axis=-1)  # (N, M)

            def plug_in_elc(params, ilp):
                """(M, N, K) complete loglik under plug-in mode params."""
                return (jax.vmap(lambda p: self.family.loglik(p, data))(
                    params) + ilp[:, None, :])

            def step(carry, _):
                inner_resp, outer_resp = carry

                def sub(j, ir):
                    _, params, ilp = m_step(ir, outer_resp)
                    return jax.nn.softmax(plug_in_elc(params, ilp), axis=-1)

                inner_resp = jax.lax.fori_loop(0, maxsubiter, sub,
                                               inner_resp)
                state, params, ilp = m_step(inner_resp, outer_resp)
                outer_log_pi = jnp.log(jnp.clip(
                    state.outer_gating.mode(), 1e-37, None))
                log_p = (logsumexp(plug_in_elc(params, ilp), axis=-1).T
                         + outer_log_pi[None, :])
                outer_resp, lognorm = normalize_log(log_p)
                return (inner_resp, outer_resp), (state, jnp.sum(lognorm))

            (_, _), (states, trace) = jax.lax.scan(
                step, (inner_resp0, outer_resp0), None, length=maxiter)
            return jax.tree.map(lambda a: a[-1], states), trace

        return _finite_report(fn(run, data, key), 'fit_map')

    def fit_map_fused(self, data, key=None, maxiter=100, block_size=None,
                      mesh=None, backend='auto'):
        """Nested MAP-EM through the fused blockwise engines: the
        two-level plug-in E-step at the posterior MODE runs as one flat
        M*K softmax (spec.theta_plugin(mode_params)), the M-step splits
        the flat counts/stats back into per-cluster MAP updates plus the
        outer gating MAP — nested MAP at HBM-resident N without the
        (M, N, K) responsibilities. Equivalent to fit_map's coordinate
        ascent at maxsubiter=1 with jointly-updated outer weights.
        mesh/backend as in fit_vi_fused. Returns (HMixState, trace).
        Reference anchor: the engine the reference declares but never
        implements (hilr.py:341-344) — see fit_map."""
        from mimo_tpu.ops.family_estep import estep_engine
        from mimo_tpu.models.mixture import (
            _fused_block_size, _resolve_backend)
        data = self._tx_data(data)
        key = _as_key(key)
        mm, kk = self.cluster_size, self.mixture_size
        spec = self._flat_spec()
        if spec.theta_plugin is None:
            raise NotImplementedError(
                'no fused plug-in spec for this family; use fit_map')
        engine = _resolve_backend(backend, spec, self.components_prior)
        block_size = _fused_block_size(data[0].shape[0], mesh, engine,
                                       block_size, 'fit_map')
        fn = self._jit('map_fused', maxiter=maxiter, block_size=block_size,
                       mesh=mesh, engine=engine)
        estep = estep_engine(spec._replace(theta=spec.theta_plugin), engine,
                             block_size, mesh)

        def run(data, key):
            n = data[0].shape[0]
            dtype = data[0].dtype
            # random two-level responsibilities -> posterior init (as
            # fit_vi_fused)
            r = jax.random.uniform(key, (n, mm), dtype=dtype,
                                   minval=1e-3, maxval=1.0)
            outer_resp = r / jnp.sum(r, axis=-1, keepdims=True)
            ir = jax.random.uniform(jax.random.fold_in(key, 1),
                                    (mm, n, kk), dtype=dtype,
                                    minval=1e-3, maxval=1.0)
            inner_resp = ir / jnp.sum(ir, axis=-1, keepdims=True)
            comps, gatings = self._inner_update(data, inner_resp,
                                                outer_resp)
            state = HMixState(
                outer_gating=self.outer_gating_prior.update(
                    jnp.sum(outer_resp, axis=0)),
                inner_gating=gatings, components=comps)

            def step(st, _):
                params = jax.vmap(self.family.mode_params)(st.components)
                lp_in = jax.vmap(lambda g: jnp.log(jnp.clip(
                    g.mode(), 1e-37, None)))(st.inner_gating)     # (M, K)
                log_pi = (jnp.log(jnp.clip(st.outer_gating.mode(),
                                           1e-37, None))[:, None]
                          + lp_in).reshape(-1).astype(dtype)
                res = estep(params, log_pi, data)
                counts, stats = self._split_flat(res)
                comps, gatings = jax.vmap(
                    lambda pc, pg, s, c: (self.family.update(pc, s),
                                          pg.update(c)))(
                    self.components_prior, self.inner_gating_prior,
                    stats, counts)
                outer = self.outer_gating_prior.update(
                    jnp.sum(counts, axis=-1))
                return HMixState(outer_gating=outer, inner_gating=gatings,
                                 components=comps), res.lse

            return jax.lax.scan(step, state, None, length=maxiter)

        return _finite_report(fn(run, data, key), 'fit_map_fused')

    # -- stochastic VI (hilr.py:460-515, hgmm analogue) ---------------------

    def fit_svi(self, data, key=None, maxiter=500, step_size=1e-2,
                batch_size=128, maxsubiter=2, init_state=None,
                randomize=True, mesh=None):
        """Nested stochastic natural-gradient VI: per step, one random
        minibatch; outer + inner responsibilities on the batch; blend of
        inner components/gatings and the outer gating with stochastic
        scale B/N (nat <- (1-rho) nat + rho (prior + stats/scale),
        bayesian.py:232-238 applied at both levels).

        With `mesh` (a ('chain','data') mesh; shard data over 'data'
        first), each step runs under shard_map: every device draws
        batch_size // n_devices points from its LOCAL shard (stratified
        minibatch, the flat fit_svi's scheme), the (M, K, m) inner stats
        and outer counts are psum'd once per inner sub-iteration, and
        the nat-space blends are replicated M*K-sized math on every
        device."""
        data = self._tx_data(data)
        key = _as_key(key)
        if mesh is not None and batch_size % mesh.shape['data']:
            raise ValueError(f'batch_size={batch_size} must be a multiple '
                             f"of the data-mesh size {mesh.shape['data']}")
        fn = self._jit('svi', maxiter=maxiter, batch_size=batch_size,
                       maxsubiter=maxsubiter, randomize=randomize,
                       warm=init_state is not None, mesh=mesh)

        def run(data, key, init_state, step_size):
            # n/scale from the traced data and step_size as a traced arg,
            # not enclosing-scope captures: the jitted closure is cached
            # per static key and reused across calls
            n = data[0].shape[0]
            scale = batch_size / n
            m = self.cluster_size
            if randomize or init_state is None:
                k1, k2, key = jax.random.split(key, 3)
                r = jax.random.uniform(k1, (n, m), dtype=data[0].dtype,
                                       minval=1e-3, maxval=1.0)
                outer_resp = r / jnp.sum(r, axis=-1, keepdims=True)
                ir = jax.random.uniform(
                    k2, (m, n, self.mixture_size), dtype=data[0].dtype,
                    minval=1e-3, maxval=1.0)
                inner_resp = ir / jnp.sum(ir, axis=-1, keepdims=True)
                comps, gatings = self._inner_update(data, inner_resp,
                                                    outer_resp)
                state = HMixState(
                    outer_gating=self.outer_gating_prior.update(
                        jnp.sum(outer_resp, axis=0)),
                    inner_gating=gatings, components=comps)
            else:
                state = init_state

            def body(st, k, *local_data):
                """One SVI step over `local_data` (the full arrays, or a
                device's shard under shard_map — `sharded` selects the
                psum'd reductions)."""
                sharded = mesh is not None
                if sharded:
                    k = jax.random.fold_in(k, jax.lax.axis_index('data'))
                    b = batch_size // mesh.shape['data']
                else:
                    b = batch_size
                idx = sample_batch_indices(jax.random.fold_in(k, 0),
                                           local_data[0].shape[0], b)
                batch = tuple(a[idx] for a in local_data)
                outer_resp = self.expected_responsibilities(st, batch)

                def sub(j, st):
                    inner_resp = jax.nn.softmax(
                        self._inner_elc(st, batch), axis=-1)    # (M, B, K)
                    weighted = inner_resp * outer_resp.T[:, :, None]

                    def per_cluster(w):
                        return (self.family.suff_stats(batch, w),
                                jnp.sum(w, axis=0))

                    stats, counts = jax.vmap(per_cluster)(weighted)
                    if sharded:
                        stats, counts = jax.lax.psum((stats, counts),
                                                     'data')
                    comps, gatings = jax.vmap(
                        lambda pc, pg, qc, qg, s, c: (
                            self.family.svi_blend(qc, pc, s, scale,
                                                  step_size),
                            pg.svi_blend(qg, c, scale, step_size)))(
                        self.components_prior, self.inner_gating_prior,
                        st.components, st.inner_gating, stats, counts)
                    return st._replace(components=comps,
                                       inner_gating=gatings)

                st = jax.lax.fori_loop(0, maxsubiter, sub, st)
                oc = jnp.sum(outer_resp, axis=0)
                if sharded:
                    oc = jax.lax.psum(oc, 'data')
                outer_g = self.outer_gating_prior.svi_blend(
                    st.outer_gating, oc, scale, step_size)
                return st._replace(outer_gating=outer_g)

            if mesh is None:
                def step(st, k):
                    return body(st, k, *data), None
            else:
                from jax.sharding import PartitionSpec as P
                smapped = jax.shard_map(
                    body, mesh=mesh,
                    in_specs=(P(), P()) + tuple(P('data') for _ in data),
                    out_specs=P())

                def step(st, k):
                    return smapped(st, k, *data), None

            state, _ = jax.lax.scan(step, state,
                                    jax.random.split(key, maxiter))
            return state

        return _finite_report(fn(run, data, key, init_state, step_size), 'fit_svi')

    # -- Gibbs (hgmm.py:326-361, masked instead of hard-sliced) -------------

    def _gibbs_sweep(self, state: HMixGibbsState, data, key, maxsubiter):
        n = data[0].shape[0]
        outer_w = one_hot(state.labels, self.cluster_size,
                          dtype=data[0].dtype)                 # (N, M)
        k_in, k_out, k_gate = jax.random.split(key, 3)

        # inner Gibbs chains, all clusters at once
        def sub(carry, k_j):
            comps, gatings = carry

            def per_cluster(prior_c, prior_g, comp, gating, w, kk):
                k_lab, k_par, k_pi = jax.random.split(kk, 3)
                params = self.family.sample_params(k_par, comp)
                probs = gating.sample(k_pi)
                logp = (self.family.loglik(params, data)
                        + jnp.log(jnp.clip(probs, 1e-37, None))[None, :])
                z = sample_categorical_from_log(k_lab, logp, axis=-1)
                wk = one_hot(z, self.mixture_size,
                             dtype=data[0].dtype) * w[:, None]
                stats = self.family.suff_stats(data, wk)
                counts = jnp.sum(wk, axis=0)
                return (self.family.update(prior_c, stats),
                        prior_g.update(counts), logp)

            ks = jax.random.split(k_j, self.cluster_size)
            comps, gatings, logp_m = jax.vmap(per_cluster)(
                self.components_prior, self.inner_gating_prior,
                comps, gatings, outer_w.T, ks)
            return (comps, gatings), logp_m

        (comps, gatings), logp_all = jax.lax.scan(
            sub, (state.components, state.inner_gating),
            jax.random.split(k_in, maxsubiter))

        # outer labels from marginal loglik under the inner posteriors
        logp_m = logp_all[-1]                                  # (M, N, K)
        marg = logsumexp(logp_m, axis=-1).T                    # (N, M)
        outer_gating = self.outer_gating_prior.update(
            jnp.sum(outer_w, axis=0))
        pi = outer_gating.sample(k_gate)
        log_p_outer = marg + jnp.log(jnp.clip(pi, 1e-37, None))[None, :]
        labels = sample_categorical_from_log(k_out, log_p_outer, axis=-1)
        return HMixGibbsState(outer_gating=outer_gating,
                              inner_gating=gatings, components=comps,
                              labels=labels)

    def fit_gibbs(self, data, key=None, maxiter=100, maxsubiter=2,
                  init_labels='prior'):
        data = self._tx_data(data)
        key = _as_key(key)
        fn = self._jit('gibbs', maxiter=maxiter, maxsubiter=maxsubiter,
                       init_labels=init_labels)

        def run(data, key):
            n = data[0].shape[0]
            k_init, k_loop = jax.random.split(key)
            if init_labels == 'random':
                labels = jax.random.randint(k_init, (n,), 0,
                                            self.cluster_size)
            else:  # 'prior': labels from sampled outer gating weights
                k_pi, k_z = jax.random.split(k_init)
                probs = self.outer_gating_prior.sample(k_pi)
                labels = jax.random.categorical(
                    k_z, jnp.broadcast_to(
                        jnp.log(jnp.clip(probs, 1e-37, None)),
                        (n, self.cluster_size)), axis=-1)
            state = HMixGibbsState(
                outer_gating=self.outer_gating_prior,
                inner_gating=self.inner_gating_prior,
                components=self.components_prior,
                labels=labels)

            def step(st, k):
                return self._gibbs_sweep(st, data, k, maxsubiter), None

            state, _ = jax.lax.scan(step, state,
                                    jax.random.split(k_loop, maxiter))
            return state

        return _finite_report(fn(run, data, key), 'fit_gibbs')

    # -- prediction (hilr.py:527-609, hgmm two-level predictive density) ----

    def _log_mix_weights(self, state: HMixState):
        """(M, K) log [E[pi_outer]_m * E[pi_inner]_{m,k}] from posterior
        means (hilr.py:541-550 uses posterior.mean() at both levels)."""
        log_out = jnp.log(jnp.clip(state.outer_gating.mean(), 1e-37, None))
        log_in = jnp.log(jnp.clip(
            jax.vmap(lambda g: g.mean())(state.inner_gating), 1e-37, None))
        return log_out[:, None] + log_in

    def log_predictive(self, state: HMixState, data, dist='studentt'):
        """Marginal posterior-predictive log density, (N,): logsumexp over
        all (M, K) of mixture weights x component predictive (the dense
        path, as BayesianMixture.log_predictive)."""
        data = data if isinstance(data, tuple) else (data,)
        fn = (self.family.log_predictive if dist == 'studentt'
              else self.family.log_predictive_gaussian)
        log_p = jax.vmap(lambda post: fn(post, data))(
            state.components)                               # (M, N, K)
        log_w = self._log_mix_weights(state)                # (M, K)
        return logsumexp(log_p + log_w[:, None, :], axis=(0, 2))

    def init_transform(self, x, y):
        """Optional input/output standardization (hilr.py:527-536)."""
        from mimo_tpu.utils.data import Standardizer
        self.input_transform = Standardizer.fit(x)
        self.output_transform = Standardizer.fit(y)

    def predictive_weights(self, state: HMixState, x, dist='gaussian'):
        """(N, M, K) joint input-conditional weights (hilr.py:541-551):
        softmax over both levels of log E[pi_out] + log E[pi_in] +
        basis-predictive logpdf."""
        from mimo_tpu.distributions import niw as _niw
        basis_post, _ = state.components
        fn = (_niw.log_predictive_gaussian if dist == 'gaussian'
              else _niw.log_predictive_studentt)
        log_basis = jax.vmap(lambda p: fn(p, x))(basis_post)   # (M, N, K)
        log_w = log_basis + self._log_mix_weights(state)[:, None, :]
        log_w = jnp.moveaxis(log_w, 0, 1)                      # (N, M, K)
        flat = log_w.reshape(log_w.shape[0], -1)
        w = jax.nn.softmax(flat, axis=-1)
        return w.reshape(log_w.shape)

    def predictive_activation(self, state: HMixState, x):
        """Normalized two-level basis activations (hilr.py:526-539)."""
        xx = x if self.input_transform is None \
            else self.input_transform.transform(x)
        return self.predictive_weights(state, xx, dist='gaussian')

    def predictive_moments(self, state: HMixState, x, dist='gaussian'):
        """Per-(cluster, expert) predictive mean (N, M, K, p) and
        covariance (N, M, K, p, p) (hilr.py:553-560)."""
        from mimo_tpu.distributions import mnw as _mnw
        from mimo_tpu.distributions.mnw import augment
        _, models_post = state.components
        xa = augment(x, self.affine)
        fn = (_mnw.predictive_moments_gaussian if dist == 'gaussian'
              else _mnw.predictive_moments_studentt)
        mus, covs = jax.vmap(lambda p: fn(p, xa))(models_post)  # (M, N, K, ..)
        return jnp.moveaxis(mus, 0, 1), jnp.moveaxis(covs, 0, 1)

    def predict(self, state: HMixState, x, y=None, prediction='average',
                dist='gaussian', incremental=False):
        """Two-level posterior-predictive regression (hilr.py:573-609):
        mode picks the argmax over all M*K experts, average moment-matches
        the full two-level mixture. Returns (mean, var, std, nlpd)."""
        if self.kind != 'ilr':
            raise ValueError('predict() is for make_ilr models; use '
                             'log_predictive for density models')
        from mimo_tpu.models.ilr import BayesianILR
        xx = x if self.input_transform is None \
            else self.input_transform.transform(x)
        n = x.shape[0]
        weights = self.predictive_weights(state, xx, dist)   # (N, M, K)
        mus, covs = self.predictive_moments(state, xx, dist)
        j = self.cluster_size * self.mixture_size
        w_f = weights.reshape(n, j)
        mus_f = mus.reshape(n, j, -1)
        covs_f = covs.reshape(n, j, mus_f.shape[-1], mus_f.shape[-1])
        if prediction == 'mode':
            k = jnp.argmax(w_f, axis=-1)
            idx = jnp.arange(n)
            mu, cov = mus_f[idx, k], covs_f[idx, k]
        else:
            mu, cov = BayesianILR.mixture_moments(mus_f, covs_f, w_f,
                                                  diag=False)
        nlpd = None
        if y is not None:
            from mimo_tpu.distributions import mnw as _mnw
            from mimo_tpu.distributions.mnw import augment
            yy = y if self.output_transform is None \
                else self.output_transform.transform(y)
            xa = augment(xx, self.affine)
            fn = (_mnw.log_predictive_gaussian if dist == 'gaussian'
                  else _mnw.log_predictive_studentt)
            log_pl = jax.vmap(lambda p: fn(p, xa, yy))(
                state.components[1])                          # (M, N, K)
            log_pl = jnp.moveaxis(log_pl, 0, 1).reshape(n, j)
            nlpd = -logsumexp(log_pl + jnp.log(w_f + 1e-37), axis=-1)
            if self.output_transform is not None:
                # change-of-variables Jacobian: NLPD in original units
                # (see BayesianILR.predict)
                nlpd = nlpd + jnp.sum(jnp.log(self.output_transform.scale))
        if self.output_transform is not None:
            mu = self.output_transform.inverse_transform(mu)
            cov = self.output_transform.scale_cov(cov)
        if incremental:
            mu = mu + x[:, :mu.shape[-1]]
        var = jnp.diagonal(cov, axis1=-2, axis2=-1)
        return mu, var, jnp.sqrt(var), nlpd

    # -- plumbing -----------------------------------------------------------

    def _jit(self, name, **statics):
        key = (name, tuple(sorted(statics.items())))
        if key not in self._cache:
            dispatcher = {}

            def wrapper(run, *args):
                if 'fn' not in dispatcher:
                    dispatcher['fn'] = jax.jit(run)
                return dispatcher['fn'](*args)

            self._cache[key] = wrapper
        return self._cache[key]


def _as_key(key):
    if key is None:
        return jax.random.PRNGKey(0)
    if isinstance(key, int):
        return jax.random.PRNGKey(key)
    return key
