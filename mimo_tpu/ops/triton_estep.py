"""Fused mixture E-step and Gibbs label sweep as one Pallas kernel on the
Triton route (NVIDIA GPUs).

Per tile of T points, for any family whose spec has a `feature_rows`
assembler (ops/family_estep.py):

    rows  = feature_rows(columns of the tile)       m vectors of (T,)
    logp  = theta @ rows                            (Kp, T), f32 FMAs
    ex    = exp(logp - max_k logp)                  (Kp, T)
    E-step: acc_j += sum_t ex[:, t] rows_j[t] / denom[t],  lse += lse_t
    Gibbs : label_t = inverse CDF of ex[:, t] at one uniform u_t,
            acc_j += sum_t onehot(label)[:, t] rows_j[t]

so the (N, K) log-densities, responsibilities and one-hots never leave
registers; x is read once per sweep in its natural (N, d) layout.

Grid: a fixed number of programs, each looping over every G-th tile and
writing its own partial (Kp, Mp) accumulator and partial lse; XLA sums the
partials. No atomics, so results are deterministic. Any N works: the tail
tile is masked. K is padded to a power of two, the padded rows' constant
column set to -inf so they take no mass.

Precision: exact f32 throughout, no TF32. The log-densities are f32
multiply-adds against theta's columns (at d=2 the contraction depth m=7
is below the dot's minimum of 16). The statistics are one dot per tile,
(Kp, T) weights against the (Mp, T) feature rows padded to Mp >= 16, at
Precision.HIGHEST, which the Triton route lowers to IEEE f32 products.
TF32 would round theta's constant column (magnitude ~60 at convergence)
and shift each component's log-density by up to ~0.03 nats.

The Gibbs draw takes one uniform per point from jax.random outside the
kernel (4 bytes per point) and inverts the row's CDF: label = #{k :
cumsum_k(ex) < u * sum(ex)} with u in (0, 1], an exact categorical draw.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Programs per launch: four per SM of an H100 (132 SMs) fill the card in
# one wave at the kernel's register footprint.
PROGRAMS = 528


def _next_pow2(v):
    return 1 << max(0, int(v) - 1).bit_length()


def tile_points(kp):
    """Points per tile: a (Kp, T) f32 tile of 4096 elements, T in
    [16, 256] and a power of two as Triton requires. Larger tiles spill
    registers (PERF.md, "Bring-up measurements")."""
    return max(16, min(256, 4096 // kp))


def _kernel(gibbs, feature_rows, widths, k_valid, n, tile, n_prog, mp,
            *refs):
    nx = len(widths)
    x_refs = refs[:nx]
    if gibbs:
        u_ref, theta_ref, acc_ref, lab_ref = refs[nx:]
    else:
        theta_ref, acc_ref, lse_ref = refs[nx:]
    m, kp = theta_ref.shape
    pid = pl.program_id(0)
    kiota = jnp.arange(kp, dtype=jnp.int32)
    miota = jnp.arange(mp, dtype=jnp.int32)
    thetas = [theta_ref[j, :] for j in range(m)]     # loop-invariant

    def body(i, carry):
        acc, lse_acc = carry
        start = (pid + i * n_prog) * tile
        idx = start + jnp.arange(tile, dtype=jnp.int32)
        valid = idx < n
        cols = tuple(
            [plgpu.load(r.at[idx, c], mask=valid, other=0.0)
             for c in range(w)]
            for r, w in zip(x_refs, widths))
        rows = feature_rows(cols)
        # rows[0] is the constant feature
        logp = thetas[0][:, None] + thetas[1][:, None] * rows[1][None, :]
        for j in range(2, m):
            logp = logp + thetas[j][:, None] * rows[j][None, :]
        mx = jnp.max(logp, axis=0)                       # (T,)
        ex = jnp.exp(logp - mx[None, :])                 # (Kp, T)
        if gibbs:
            u = plgpu.load(u_ref.at[idx], mask=valid, other=1.0)
            cum = jnp.cumsum(ex, axis=0)
            thresh = u * jnp.max(cum, axis=0)
            lab = jnp.sum(cum < thresh[None, :], axis=0, dtype=jnp.int32)
            plgpu.store(lab_ref.at[idx], lab)
            w = (kiota[:, None] == lab[None, :]).astype(jnp.float32)
            scale = valid.astype(jnp.float32)
        else:
            denom = jnp.sum(ex, axis=0)
            scale = jnp.where(valid, 1.0 / denom, 0.0)
            lse_acc = lse_acc + jnp.where(valid, mx + jnp.log(denom), 0.0)
            w = ex
        feats = sum(jnp.where(miota[:, None] == j, r[None, :], 0.0)
                    for j, r in enumerate(rows))         # (Mp, T)
        acc = acc + pl.dot(w * scale[None, :], feats, trans_b=True,
                           precision=jax.lax.Precision.HIGHEST)
        return acc, lse_acc

    n_tiles = pl.cdiv(n, tile)
    n_iter = (n_tiles - pid + n_prog - 1) // n_prog
    acc, lse_acc = jax.lax.fori_loop(
        0, n_iter, body, (jnp.zeros((kp, mp), jnp.float32),
                          jnp.zeros((tile,), jnp.float32)))
    acc_ref[pid] = acc
    if not gibbs:
        lse_ref[pid, :] = lse_acc


def _launch(spec, theta, data, u=None, interpret=False):
    """Run the kernel over `data` (tuple of (N, d_i) arrays, any N) with
    log_pi already folded into theta's column 0. Returns (acc (K, m),
    lse scalar or None, labels (N,) int32 or None)."""
    k, m = theta.shape
    n = data[0].shape[0]
    kp = max(16, _next_pow2(k))
    mp = max(16, _next_pow2(m))
    tile = tile_points(kp)
    n_tiles = -(-n // tile)
    n_prog = max(1, min(PROGRAMS, n_tiles))
    data = tuple(a.astype(jnp.float32) for a in data)
    widths = tuple(a.shape[1] for a in data)
    # (m, Kp): rows of theta^T are contiguous; padded components get a
    # -inf constant so exp() gives them no mass
    theta_t = jnp.full((m, kp), 0.0, jnp.float32).at[:, :k].set(
        theta.T.astype(jnp.float32)).at[0, k:].set(-jnp.inf)
    gibbs = u is not None
    out_shape = [jax.ShapeDtypeStruct((n_prog, kp, mp), jnp.float32)]
    if gibbs:
        # padded to whole tiles so every store is in bounds
        out_shape.append(
            jax.ShapeDtypeStruct((n_tiles * tile,), jnp.int32))
        args = data + (u.astype(jnp.float32), theta_t)
    else:
        out_shape.append(jax.ShapeDtypeStruct((n_prog, tile), jnp.float32))
        args = data + (theta_t,)
    kernel = functools.partial(_kernel, gibbs, spec.feature_rows, widths,
                               k, n, tile, n_prog, mp)
    acc, second = pl.pallas_call(
        kernel, grid=(n_prog,), out_shape=out_shape,
        backend='triton', interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        name='mixture_gibbs' if gibbs else 'mixture_estep',
    )(*args)
    acc = jnp.sum(acc, axis=0)[:k, :m]                   # (K, m)
    if gibbs:
        return acc, None, second[:n]
    return acc, jnp.sum(second), None


def _result(spec, acc, lse, dtype):
    from mimo_tpu.ops.family_estep import FusedEStep
    res = FusedEStep(stats=spec.unpack(acc), lse=lse, counts=acc[:, 0])
    return jax.tree.map(lambda a: a.astype(dtype), res)


def _fold(theta, log_pi):
    return theta.at[:, 0].add(log_pi.astype(theta.dtype))


def fused_estep_pallas(spec, post, log_pi, data, interpret=False):
    """Fused E-step on the kernel: a drop-in for
    family_estep.fused_estep_blockwise, any N, no block size. Returns a
    FusedEStep in the data's dtype."""
    theta = _fold(spec.theta(post), log_pi)
    acc, lse, _ = _launch(spec, theta, data, interpret=interpret)
    return _result(spec, acc, lse, data[0].dtype)


def fused_gibbs_pallas(spec, key, params, log_pi, data, interpret=False):
    """Fused Gibbs label sweep on the kernel: a drop-in for
    family_estep.fused_gibbs_blockwise. Returns (labels (N,) int32,
    FusedEStep with one-hot statistics and lse = 0)."""
    theta = _fold(spec.theta_plugin(params), log_pi)
    u = 1.0 - jax.random.uniform(key, (data[0].shape[0],), jnp.float32)
    acc, _, labels = _launch(spec, theta, data, u, interpret)
    return labels, _result(spec, acc, jnp.zeros((), jnp.float32),
                           data[0].dtype)


def _local_n(data, mesh, axis):
    n_shards = mesh.shape[axis]
    n = data[0].shape[0]
    if n % n_shards:
        raise ValueError(f'N={n} must be a multiple of the data-mesh size '
                         f'{n_shards}')
    return n // n_shards


def fused_estep_pallas_sharded(spec, post, log_pi, data, mesh, axis='data',
                               interpret=False):
    """Multi-device fused E-step: shard_map over the mesh's `axis`, the
    kernel on each device's local rows, then one psum of the (K, m)
    accumulator and lse — the payload of fused_estep_sharded."""
    from jax.sharding import PartitionSpec as P
    _local_n(data, mesh, axis)
    theta = _fold(spec.theta(post), log_pi)

    def local(theta, *shard):
        acc, lse, _ = _launch(spec, theta, shard, interpret=interpret)
        return jax.lax.psum(acc, axis), jax.lax.psum(lse, axis)

    # check_vma=False: pallas_call's out_shape carries no varying-axes
    # annotation, so the checker cannot see through it
    acc, lse = jax.shard_map(
        local, mesh=mesh, in_specs=(P(),) + tuple(P(axis) for _ in data),
        out_specs=(P(), P()), check_vma=False)(theta, *data)
    return _result(spec, acc, lse, data[0].dtype)


def fused_gibbs_pallas_sharded(spec, key, params, log_pi, data, mesh,
                               axis='data', interpret=False):
    """Multi-device fused Gibbs sweep: labels stay device-local, each
    device draws its uniforms from the sweep key folded with its axis
    index, and one psum of the one-hot statistics crosses the mesh."""
    from jax.sharding import PartitionSpec as P
    local_n = _local_n(data, mesh, axis)
    theta = _fold(spec.theta_plugin(params), log_pi)

    def local(theta, key, *shard):
        k = jax.random.fold_in(key, jax.lax.axis_index(axis))
        u = 1.0 - jax.random.uniform(k, (local_n,), jnp.float32)
        acc, _, labels = _launch(spec, theta, shard, u, interpret)
        return jax.lax.psum(acc, axis), labels

    acc, labels = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P()) + tuple(P(axis) for _ in data),
        out_specs=(P(), P(axis)), check_vma=False)(theta, key, *data)
    return labels, _result(spec, acc, jnp.zeros((), jnp.float32),
                           data[0].dtype)
