"""Generic fused mixture E-step for ANY conjugate family.

Every exponential-family expected log-likelihood in this package is linear
in a fixed feature map of the data:

    E_q[log p(data | params_k)]  =  t(data) @ theta_k

with t(data) of width m independent of K (for a Gaussian,
t = [1, x, x(x)x], m = 1+d+d^2; for a linear expert,
t = [1, y(x)xt, xt(x)xt, y(x)y]). The VI E-step for a whole mixture is
then TWO matmuls per data block:

    logp  = F @ Theta^T                      (B, K)
    stats = ex^T @ (F / denom)               (K, m)  — softmax-normalized
                                             FEATURES, responsibilities
                                             never materialized

where the second matmul simultaneously accumulates the sufficient
statistics of every constituent family (the first feature column is the
constant 1, so column 0 of the accumulator is the responsibilities' sum =
counts). Product families (e.g. ILR experts = basis(x) x model(y|x))
concatenate feature maps and theta blocks.

This subsumes ops/estep.py's GMM-specific kernels and extends the fused
path to mixtures of linear experts and diagonal variants (the reference's
hot loops bayesian.py:287-301, 933-947 + gmm.py:256-259, ilr.py:191-194
collapsed into two matmuls).
"""

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from mimo_tpu.distributions import mnw as _mnw
from mimo_tpu.distributions import ng as _ng
from mimo_tpu.distributions import niw as _niw
from mimo_tpu.distributions.mnw import augment
from mimo_tpu.utils.linalg import logdet_psd
from mimo_tpu.utils.stats import LOG2PI


class EStepSpec(NamedTuple):
    """Fused-E-step description of a conjugate family (or product)."""
    features: Callable[[Any], jax.Array]   # data tuple -> (N, m), col 0 == 1
    theta: Callable[[Any], jax.Array]      # posterior -> (K, m), E_q[nats]
    unpack: Callable[[jax.Array], Any]     # (K, m) accumulator -> stats
    # plug-in natural params for Gibbs label sweeps:
    # likelihood params -> (K, m) with log p(data|params_k) = t(data)·row_k
    theta_plugin: Any = None
    # kernel-side feature assembler (ops/triton_estep.py): maps a tuple
    # (one entry per data array) of lists of (T,) column vectors to the
    # list of m (T,) feature rows, rows[j] == features(data)[:, j] — traced
    # INSIDE the kernel, so the N x m feature tensor never exists in HBM.
    # None = kernel path unavailable.
    feature_rows: Any = None


class FusedEStep(NamedTuple):
    stats: Any         # family stats struct (product: tuple of structs)
    lse: jax.Array     # () sum_n logsumexp_k
    counts: jax.Array  # (K,)


def _outer(a, b):
    n = a.shape[0]
    return (a[:, :, None] * b[:, None, :]).reshape(n, -1)


# -- kernel-side feature assemblers -------------------------------------------
# Row order MUST mirror the spec's `features` exactly. Each returns a list
# of (T,) rows: Triton lowers no general concatenate, and a list lets the
# kernel consume each row as it is made.

def _rows_outer(a, b):
    """Row-list _outer: row i*len(b)+j = a_i b_j."""
    return [ai * bj for ai in a for bj in b]


def gauss_feature_rows(cols):
    (xs,) = cols
    return [jnp.ones_like(xs[0])] + list(xs) + _rows_outer(xs, xs)


def diag_gauss_feature_rows(cols):
    (xs,) = cols
    return [jnp.ones_like(xs[0])] + list(xs) + [x * x for x in xs]


def linear_feature_rows(affine):
    def assemble(cols):
        xs, ys = cols
        one = jnp.ones_like(xs[0])
        xa = list(xs) + [one] if affine else list(xs)
        return ([one] + _rows_outer(ys, xa) + _rows_outer(xa, xa)
                + _rows_outer(ys, ys))
    return assemble


def _product_feature_rows(specs, data_slices):
    members = [s.feature_rows for s in specs]
    if any(m is None for m in members):
        return None

    def assemble(cols):
        blocks = [m(tuple(cols[i] for i in sl))
                  for m, sl in zip(members, data_slices)]
        # drop duplicate constant rows beyond the first (as in features)
        return blocks[0] + [r for b in blocks[1:] for r in b[1:]]
    return assemble


# -- Gaussian | NIW ----------------------------------------------------------

def gaussian_spec() -> EStepSpec:
    def features(data):
        x = data[0]
        n = x.shape[0]
        return jnp.concatenate(
            [jnp.ones((n, 1), x.dtype), x, _outer(x, x)], axis=-1)

    def theta(post):
        e_lm, e_mlm, e_l, e_logdet = _niw.expected_stats(post)
        d = post.mu.shape[-1]
        c = e_mlm + e_logdet - 0.5 * d * LOG2PI
        return jnp.concatenate(
            [c[:, None], e_lm, e_l.reshape(-1, d * d)], axis=-1)

    def theta_plugin(params):
        mu, lm = params.mu, params.lmbda
        d = mu.shape[-1]
        lmu = jnp.einsum('kde,ke->kd', lm, mu)
        logdet = logdet_psd(lm)
        c = (-0.5 * jnp.einsum('kd,kd->k', mu, lmu) + 0.5 * logdet
             - 0.5 * d * LOG2PI)
        return jnp.concatenate(
            [c[:, None], lmu, -0.5 * lm.reshape(-1, d * d)], axis=-1)

    return EStepSpec(features, theta, _unpack_gauss, theta_plugin,
                     gauss_feature_rows)


def _unpack_gauss(acc):
    m = acc.shape[-1]
    # m = 1 + d + d^2  =>  d = (-1 + sqrt(1 + 4(m-1))) / 2
    d = int((-1 + (1 + 4 * (m - 1)) ** 0.5) / 2)
    counts = acc[:, 0]
    return _niw.GaussStats(x=acc[:, 1:1 + d], n1=counts,
                           xxT=acc[:, 1 + d:].reshape(-1, d, d), n2=counts)


# -- hierarchically-tied Gaussian | NW hyper-prior ----------------------------

def hier_gaussian_spec() -> EStepSpec:
    """HierTied expected log-likelihood (hierarchical.py:153-167) is also
    feature-linear in [1, x, x (x) x]: shared E[Lambda] = nu_bar psi_bar,
    per-component h1_k = E[Lambda] mus_k, and the q(mu_k)-covariance term
    d / kappa'_k folds into the constant — so the fused big-N engines work
    for hierarchical GMMs too. Same features/unpack/plug-in as
    gaussian_spec; stats are plain GaussStats (the hierarchical inner loop
    lives in the family's update/gibbs_update)."""
    from mimo_tpu.distributions.wishart import wishart_expected_logdet
    from mimo_tpu.utils.linalg import cholesky
    g = gaussian_spec()

    def theta(post):
        h = post.hyper
        d = post.mus.shape[-1]
        k = post.mus.shape[0]
        e_l = (h.nu[:, None, None] * h.psi)[0]               # (d, d)
        e_logdet = wishart_expected_logdet(cholesky(h.psi), h.nu)[0]
        h1 = post.mus @ e_l                                  # (K, d)
        c = (-0.5 * jnp.einsum('kd,kd->k', post.mus, h1)
             - 0.5 * d / post.kappas
             + 0.5 * e_logdet - 0.5 * d * LOG2PI)
        h2 = jnp.broadcast_to((-0.5 * e_l).reshape(1, d * d), (k, d * d))
        return jnp.concatenate([c[:, None], h1, h2], axis=-1)

    return EStepSpec(g.features, theta, g.unpack, g.theta_plugin,
                     gauss_feature_rows)


# -- diagonal Gaussian | NG --------------------------------------------------

def diag_gaussian_spec() -> EStepSpec:
    def features(data):
        x = data[0]
        n = x.shape[0]
        return jnp.concatenate(
            [jnp.ones((n, 1), x.dtype), x, jnp.square(x)], axis=-1)

    def theta(post):
        from jax.scipy.special import digamma
        e_l = post.alpha / post.beta                       # (K, d)
        e_logl = digamma(post.alpha) - jnp.log(post.beta)
        d = post.mu.shape[-1]
        c = 0.5 * (jnp.sum(e_logl, axis=-1) - d * LOG2PI) \
            - 0.5 * jnp.sum(e_l * jnp.square(post.mu) + 1.0 / post.kappa,
                            axis=-1)
        return jnp.concatenate(
            [c[:, None], e_l * post.mu, -0.5 * e_l], axis=-1)

    def unpack(acc):
        d = (acc.shape[-1] - 1) // 2
        counts = acc[:, 0]
        return _ng.DiagGaussStats(x=acc[:, 1:1 + d], n1=counts, n2=counts,
                                  xsq=acc[:, 1 + d:])

    def theta_plugin(params):
        mu, l = params.mu, params.lmbda_diag
        d = mu.shape[-1]
        c = 0.5 * jnp.sum(jnp.log(l) - l * jnp.square(mu), axis=-1) \
            - 0.5 * d * LOG2PI
        return jnp.concatenate([c[:, None], l * mu, -0.5 * l], axis=-1)

    return EStepSpec(features, theta, unpack, theta_plugin,
                     diag_gauss_feature_rows)


# -- linear expert | MNW -----------------------------------------------------

def linear_spec(affine: bool = True, p_dim: int = None,
                q_dim: int = None) -> EStepSpec:
    """data = (x, y); x augmented internally when affine. p_dim/q_dim are
    needed only by unpack and are captured from theta's posterior when
    used through fused_estep_* (passed explicitly here for standalone
    use)."""

    def features(data):
        xt = augment(data[0], affine)
        y = data[1]
        n = xt.shape[0]
        return jnp.concatenate(
            [jnp.ones((n, 1), xt.dtype), _outer(y, xt), _outer(xt, xt),
             _outer(y, y)], axis=-1)

    def theta(post):
        e_la, e_ala, e_l, e_logdet = _mnw.expected_stats(post)
        pd, qd = post.row_dim, post.col_dim
        c = e_logdet - 0.5 * pd * LOG2PI
        return jnp.concatenate(
            [c[:, None], e_la.reshape(-1, pd * qd),
             e_ala.reshape(-1, qd * qd), e_l.reshape(-1, pd * pd)], axis=-1)

    def unpack(acc, p=p_dim, q=q_dim):
        counts = acc[:, 0]
        o1 = 1 + p * q
        o2 = o1 + q * q
        return _mnw.LinGaussStats(
            yxT=acc[:, 1:o1].reshape(-1, p, q),
            xxT=acc[:, o1:o2].reshape(-1, q, q),
            yyT=acc[:, o2:].reshape(-1, p, p),
            n=counts)

    def theta_plugin(params):
        a, lm = params.A, params.lmbda
        pd, qd = a.shape[-2], a.shape[-1]
        la = lm @ a                                        # (K, p, q)
        ala = jnp.swapaxes(a, -1, -2) @ la                 # (K, q, q)
        c = 0.5 * logdet_psd(lm) - 0.5 * pd * LOG2PI
        return jnp.concatenate(
            [c[:, None], la.reshape(-1, pd * qd),
             -0.5 * ala.reshape(-1, qd * qd),
             -0.5 * lm.reshape(-1, pd * pd)], axis=-1)

    return EStepSpec(features, theta, unpack, theta_plugin,
                     linear_feature_rows(affine))


def diag_linear_spec(affine: bool = True, p_dim: int = None,
                     q_dim: int = None) -> EStepSpec:
    """Diagonal-noise linear expert | MNG. Shares linear_spec's feature
    map (full y(x)y block; E[lambda] embeds as a diagonal matrix) so the
    accumulator unpacks to the same LinGaussStats the MNG update takes."""
    base = linear_spec(affine, p_dim, q_dim)

    def theta(post):
        from jax.scipy.special import digamma
        pd, qd = post.row_dim, post.col_dim
        e_l = post.alpha / post.beta                          # (K, p)
        e_logl = digamma(post.alpha) - jnp.log(post.beta)
        from mimo_tpu.utils.linalg import inv_psd
        k_inv = inv_psd(post.K_)
        e_ala = pd * k_inv + jnp.einsum('kp,kpq,kpr->kqr', e_l, post.M,
                                        post.M)
        e_la = e_l[..., None] * post.M
        e_l_mat = jax.vmap(jnp.diag)(e_l)                     # (K, p, p)
        c = 0.5 * jnp.sum(e_logl, axis=-1) - 0.5 * pd * LOG2PI
        return jnp.concatenate(
            [c[:, None], e_la.reshape(-1, pd * qd),
             -0.5 * e_ala.reshape(-1, qd * qd),
             -0.5 * e_l_mat.reshape(-1, pd * pd)], axis=-1)

    def theta_plugin(params):
        a, l = params.A, params.lmbda_diag               # (K,p,q), (K,p)
        pd, qd = a.shape[-2], a.shape[-1]
        la = l[..., None] * a                            # diag(l) A
        ala = jnp.swapaxes(a, -1, -2) @ la
        l_mat = jax.vmap(jnp.diag)(l)
        c = 0.5 * jnp.sum(jnp.log(l), axis=-1) - 0.5 * pd * LOG2PI
        return jnp.concatenate(
            [c[:, None], la.reshape(-1, pd * qd),
             -0.5 * ala.reshape(-1, qd * qd),
             -0.5 * l_mat.reshape(-1, pd * pd)], axis=-1)

    return EStepSpec(base.features, theta, base.unpack, theta_plugin,
                     base.feature_rows)


# -- products (ILR: basis(x) x expert(y|x)) ----------------------------------

def product_spec(specs, data_slices, widths) -> EStepSpec:
    """Concatenate member feature maps (each member keeps its own constant
    column; the joint constant is member 0's) and theta blocks. `widths`
    are the member feature widths (incl. their constant col)."""

    def features(data):
        blocks = [s.features(tuple(data[i] for i in sl))
                  for s, sl in zip(specs, data_slices)]
        # drop duplicate constant columns beyond the first
        blocks = [blocks[0]] + [b[:, 1:] for b in blocks[1:]]
        return jnp.concatenate(blocks, axis=-1)

    def theta(posts):
        thetas = [s.theta(post) for s, post in zip(specs, posts)]
        # fold the members' constant columns into the first block's
        c_total = sum(th[:, 0] for th in thetas)
        blocks = [jnp.concatenate([c_total[:, None], thetas[0][:, 1:]], -1)]
        blocks += [th[:, 1:] for th in thetas[1:]]
        return jnp.concatenate(blocks, axis=-1)

    def unpack(acc):
        counts = acc[:, 0]
        out = []
        off = 0
        for i, (s, w) in enumerate(zip(specs, widths)):
            w_eff = w if i == 0 else w - 1
            block = acc[:, off:off + w_eff]
            if i > 0:
                block = jnp.concatenate([counts[:, None], block], axis=-1)
            out.append(s.unpack(block))
            off += w_eff
        return tuple(out)

    def theta_plugin(params_tuple):
        thetas = [s.theta_plugin(pp) for s, pp in zip(specs, params_tuple)]
        c_total = sum(th[:, 0] for th in thetas)
        blocks = [jnp.concatenate([c_total[:, None], thetas[0][:, 1:]], -1)]
        blocks += [th[:, 1:] for th in thetas[1:]]
        return jnp.concatenate(blocks, axis=-1)

    return EStepSpec(features, theta, unpack, theta_plugin,
                     _product_feature_rows(specs, data_slices))


def gauss_width(d):
    return 1 + d + d * d


def diag_gauss_width(d):
    return 1 + 2 * d


def linear_width(p, q):
    return 1 + p * q + q * q + p * p


def tied_affine_spec(input_dim, output_dim) -> EStepSpec:
    """Tied-affine experts: the ELL is the packed-MNW ell over augmented
    inputs (affine.py:211-213), so the linear spec applies with theta /
    theta_plugin on the packed posterior; unpack converts the augmented
    LinGaussStats accumulator into the AffineStats the family's
    update/gibbs_update consume (ym / xm are the augmentation column's
    sub-blocks)."""
    from mimo_tpu.distributions import affine as _aff
    q = input_dim
    base = linear_spec(True, output_dim, q + 1)

    def theta(post):
        return base.theta(_aff.to_packed_mnw(post))

    def unpack(acc):
        lg = base.unpack(acc)
        return _aff.AffineStats(
            ym=lg.yxT[..., :, q], xm=lg.xxT[..., :q, q],
            yxT=lg.yxT[..., :, :q], xxT=lg.xxT[..., :q, :q],
            yyT=lg.yyT, n=lg.n)

    return EStepSpec(base.features, theta, unpack, base.theta_plugin,
                     base.feature_rows)


def ilr_spec(input_dim, output_dim, affine=True, diag_basis=False,
             diag_expert=False, hier_basis=False, tied_affine=False):
    """The ILR joint family's fused spec: data = (x, y). Covers every
    expert/basis combination, including the hierarchically-tied basis and
    tied-affine experts (both feature-linear; see hier_gaussian_spec /
    tied_affine_spec)."""
    if hier_basis:
        b = hier_gaussian_spec()
        bw = gauss_width(input_dim)
    elif diag_basis:
        b, bw = diag_gaussian_spec(), diag_gauss_width(input_dim)
    else:
        b, bw = gaussian_spec(), gauss_width(input_dim)
    if tied_affine:
        e = tied_affine_spec(input_dim, output_dim)
        ew = linear_width(output_dim, input_dim + 1)
    else:
        q = input_dim + (1 if affine else 0)
        e = (diag_linear_spec(affine, output_dim, q) if diag_expert
             else linear_spec(affine, output_dim, q))
        ew = linear_width(output_dim, q)
    return product_spec((b, e), ((0,), (0, 1)), (bw, ew))


# -- the fused sweep ---------------------------------------------------------

def fused_estep_dense(spec: EStepSpec, post, log_pi, data) -> FusedEStep:
    """Single-shot fused E-step (all N at once)."""
    feats = spec.features(data)
    logp = feats @ spec.theta(post).T + log_pi[None, :]
    m = jnp.max(logp, axis=-1)
    ex = jnp.exp(logp - m[:, None])
    denom = jnp.sum(ex, axis=-1)
    lse = m + jnp.log(denom)
    acc = ex.T @ (feats / denom[:, None])
    stats = spec.unpack(acc)
    return FusedEStep(stats=stats, lse=jnp.sum(lse), counts=acc[:, 0])


def fused_estep_blockwise(spec: EStepSpec, post, log_pi, data,
                          block_size=65536) -> FusedEStep:
    """Streamed fused E-step: O(B*(K+m)) live memory, any family with an
    EStepSpec. N must be a multiple of block_size."""
    n = data[0].shape[0]
    nb = n // block_size
    assert nb * block_size == n, 'pad N to a multiple of block_size'
    theta = spec.theta(post)
    mdim = theta.shape[-1]
    k = theta.shape[0]
    blocks = tuple(a.reshape((nb, block_size) + a.shape[1:]) for a in data)

    def body(carry, blk):
        acc, lse_acc = carry
        feats = spec.features(blk)
        logp = feats @ theta.T + log_pi[None, :]
        m = jnp.max(logp, axis=-1)
        ex = jnp.exp(logp - m[:, None])
        denom = jnp.sum(ex, axis=-1)
        lse = m + jnp.log(denom)
        acc = acc + ex.T @ (feats / denom[:, None])
        return (acc, lse_acc + jnp.sum(lse)), None

    zero = jnp.zeros((k, mdim), data[0].dtype)
    (acc, lse), _ = jax.lax.scan(body, (zero, jnp.zeros((), data[0].dtype)),
                                 blocks)
    return FusedEStep(stats=spec.unpack(acc), lse=lse, counts=acc[:, 0])


def fused_estep_sharded(spec: EStepSpec, post, log_pi, data, block_size,
                        mesh, axis='data') -> FusedEStep:
    """Multi-chip fused E-step via shard_map over the mesh's data axis:
    every device scans its LOCAL shard's blocks (same two-matmul body as
    fused_estep_blockwise), then one psum of the (K, m) accumulator + lse
    crosses the mesh. The collective payload is K*m floats, independent of N
    — the scaling-book recipe for statistics that are additive over data
    (SURVEY.md §5 'long-context analogue').

    data arrays must be sharded (or shardable) over `axis` with per-device
    rows a multiple of block_size."""
    from jax.sharding import PartitionSpec as P

    theta = spec.theta(post)
    mdim, k = theta.shape[-1], theta.shape[0]
    n_shards = mesh.shape[axis]
    n = data[0].shape[0]
    local_n = n // n_shards
    assert local_n * n_shards == n, 'pad N to a multiple of the mesh size'
    assert local_n % block_size == 0, \
        f'per-device N={local_n} must be a multiple of block_size'

    data_specs = tuple(P(axis) for _ in data)

    def local(theta, log_pi, *shard):
        nb = local_n // block_size
        blocks = tuple(a.reshape((nb, block_size) + a.shape[1:])
                       for a in shard)

        def body(carry, blk):
            acc, lse_acc = carry
            feats = spec.features(blk)
            logp = feats @ theta.T + log_pi[None, :]
            m = jnp.max(logp, axis=-1)
            ex = jnp.exp(logp - m[:, None])
            denom = jnp.sum(ex, axis=-1)
            lse = m + jnp.log(denom)
            acc = acc + ex.T @ (feats / denom[:, None])
            return (acc, lse_acc + jnp.sum(lse)), None

        # the carry is device-varying (each device accumulates its own
        # shard), so mark the zero init as varying over the mesh axis
        zero = jax.lax.pcast(jnp.zeros((k, mdim), shard[0].dtype),
                             (axis,), to='varying')
        zlse = jax.lax.pcast(jnp.zeros((), shard[0].dtype),
                             (axis,), to='varying')
        (acc, lse), _ = jax.lax.scan(body, (zero, zlse), blocks)
        return jax.lax.psum(acc, axis), jax.lax.psum(lse, axis)

    acc, lse = jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P()) + data_specs,
        out_specs=(P(), P()))(theta, log_pi, *data)
    return FusedEStep(stats=spec.unpack(acc), lse=lse, counts=acc[:, 0])


def fused_gibbs_sharded(spec: EStepSpec, key, params, log_pi, data,
                        block_size, mesh, axis='data'):
    """Multi-chip fused Gibbs label sweep: labels stay device-local
    (sharded over `axis`), the one-hot statistics accumulator is psum'd.
    Per-device PRNG streams are derived by folding the device's axis
    index into the sweep key."""
    from jax.sharding import PartitionSpec as P

    theta = spec.theta_plugin(params)
    mdim, k = theta.shape[-1], theta.shape[0]
    n_shards = mesh.shape[axis]
    n = data[0].shape[0]
    local_n = n // n_shards
    assert local_n * n_shards == n, 'pad N to a multiple of the mesh size'
    assert local_n % block_size == 0, \
        f'per-device N={local_n} must be a multiple of block_size'

    data_specs = tuple(P(axis) for _ in data)

    def local(theta, log_pi, key, *shard):
        nb = local_n // block_size
        blocks = tuple(a.reshape((nb, block_size) + a.shape[1:])
                       for a in shard)
        keys = jax.random.split(
            jax.random.fold_in(key, jax.lax.axis_index(axis)), nb)

        def body(acc, inp):
            blk, kb = inp[:-1], inp[-1]
            feats = spec.features(blk)
            logp = feats @ theta.T + log_pi[None, :]
            labels = jax.random.categorical(kb, logp,
                                            axis=-1).astype(jnp.int32)
            oh = jax.nn.one_hot(labels, k, dtype=feats.dtype)
            return acc + oh.T @ feats, labels

        zero = jax.lax.pcast(jnp.zeros((k, mdim), shard[0].dtype),
                             (axis,), to='varying')
        acc, labels = jax.lax.scan(body, zero, blocks + (keys,))
        return jax.lax.psum(acc, axis), labels.reshape(local_n)

    acc, labels = jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P(), P()) + data_specs,
        out_specs=(P(), P(axis)))(theta, log_pi, key, *data)
    return labels, FusedEStep(
        stats=spec.unpack(acc), lse=jnp.zeros((), data[0].dtype),
        counts=acc[:, 0])


def fused_gibbs_blockwise(spec: EStepSpec, key, params, log_pi, data,
                          block_size=65536):
    """Generic fused Gibbs label sweep: per block, plug-in log-densities
    (one matmul over the family feature map) -> categorical labels ->
    one-hot statistics (one matmul). Neither the N x K log-probs nor the
    one-hot ever exist at full N. Returns (labels (N,) int32, FusedEStep
    with lse = 0)."""
    theta = spec.theta_plugin(params)
    k = theta.shape[0]
    n = data[0].shape[0]
    nb = n // block_size
    assert nb * block_size == n, 'pad N to a multiple of block_size'
    blocks = tuple(a.reshape((nb, block_size) + a.shape[1:]) for a in data)
    keys = jax.random.split(key, nb)

    def body(acc, inp):
        blk, kb = inp[:-1], inp[-1]
        feats = spec.features(blk)
        logp = feats @ theta.T + log_pi[None, :]
        labels = jax.random.categorical(kb, logp, axis=-1).astype(jnp.int32)
        oh = jax.nn.one_hot(labels, k, dtype=feats.dtype)
        return acc + oh.T @ feats, labels

    zero = jnp.zeros((k, theta.shape[-1]), data[0].dtype)
    acc, labels = jax.lax.scan(body, zero, blocks + (keys,))
    return labels.reshape(n), FusedEStep(
        stats=spec.unpack(acc), lse=jnp.zeros((), data[0].dtype),
        counts=acc[:, 0])


# -- engine dispatch -----------------------------------------------------------

def estep_engine(spec: EStepSpec, engine, block_size=None, mesh=None):
    """Return estep(post, log_pi, data) -> FusedEStep on `engine`: 'xla'
    (the blockwise scan above; per-device N a multiple of block_size),
    'pallas' (the fused GPU kernel, ops/triton_estep.py; any N) or
    'interpret' (that kernel through the Pallas interpreter, for tests on
    machines without a GPU). With `mesh` the work is sharded over its
    'data' axis and one (K, m) psum crosses the mesh."""
    if engine == 'xla':
        if mesh is None:
            return lambda post, log_pi, data: fused_estep_blockwise(
                spec, post, log_pi, data, block_size)
        return lambda post, log_pi, data: fused_estep_sharded(
            spec, post, log_pi, data, block_size, mesh)
    from mimo_tpu.ops import triton_estep as te
    interpret = engine == 'interpret'
    if mesh is None:
        return lambda post, log_pi, data: te.fused_estep_pallas(
            spec, post, log_pi, data, interpret=interpret)
    return lambda post, log_pi, data: te.fused_estep_pallas_sharded(
        spec, post, log_pi, data, mesh, interpret=interpret)


def gibbs_engine(spec: EStepSpec, engine, block_size=None, mesh=None):
    """Return sweep(key, params, log_pi, data) -> (labels (N,) int32,
    FusedEStep with one-hot statistics) on `engine` (see estep_engine)."""
    if engine == 'xla':
        if mesh is None:
            return lambda key, params, log_pi, data: fused_gibbs_blockwise(
                spec, key, params, log_pi, data, block_size)
        return lambda key, params, log_pi, data: fused_gibbs_sharded(
            spec, key, params, log_pi, data, block_size, mesh)
    from mimo_tpu.ops import triton_estep as te
    interpret = engine == 'interpret'
    if mesh is None:
        return lambda key, params, log_pi, data: te.fused_gibbs_pallas(
            spec, key, params, log_pi, data, interpret=interpret)
    return lambda key, params, log_pi, data: te.fused_gibbs_pallas_sharded(
        spec, key, params, log_pi, data, mesh, interpret=interpret)
