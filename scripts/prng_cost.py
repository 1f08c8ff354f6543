"""Isolate the cost of categorical label sampling at N=1e7, K=50:
full Gumbel-max (N x K bits) vs inverse-CDF (N bits + cumsum), the two
draws the XLA Gibbs engine and the fused kernel (ops/triton_estep.py)
use."""

import sys
import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

N, K = 10_000_000, 50
BS = 500_000


def timeit(f, *a):
    o = f(*a)
    jax.block_until_ready(o)
    best = 1e9
    for _ in range(3):
        t0 = time.time()
        o = f(*a)
        jax.block_until_ready(o)
        best = min(best, time.time() - t0)
    return best


def main():
    key = jax.random.PRNGKey(0)
    logp = jax.random.normal(key, (N, K), jnp.float32)
    nb = N // BS
    logpb = logp.reshape(nb, BS, K)
    keys = jax.random.split(key, nb)

    @jax.jit
    def gumbel_scan(logpb, keys):
        def body(c, inp):
            lp, kb = inp
            lab = jax.random.categorical(kb, lp, axis=-1)
            return c + jnp.sum(lab), None
        return jax.lax.scan(body, jnp.zeros((), jnp.int32),
                            (logpb, keys))[0]

    @jax.jit
    def invcdf_scan(logpb, keys):
        def body(c, inp):
            lp, kb = inp
            m = jnp.max(lp, axis=-1, keepdims=True)
            ex = jnp.exp(lp - m)
            cdf = jnp.cumsum(ex, axis=-1)
            u = jax.random.uniform(kb, (lp.shape[0], 1)) * cdf[:, -1:]
            lab = jnp.sum((cdf < u).astype(jnp.int32), axis=-1)
            return c + jnp.sum(lab), None
        return jax.lax.scan(body, jnp.zeros((), jnp.int32),
                            (logpb, keys))[0]

    @jax.jit
    def bits_only(keys):
        # the uint32 sum wraps around and its value is meaningless — the
        # reduction exists only to keep the bits materialized (defeat DCE);
        # we time bit GENERATION here, not the sum
        def body(c, kb):
            b = jax.random.bits(kb, (BS, K), jnp.uint32)
            return c + jnp.sum(b.astype(jnp.uint32)), None
        return jax.lax.scan(body, jnp.zeros((), jnp.uint32), keys)[0]

    print(f'gumbel categorical: {timeit(gumbel_scan, logpb, keys)*1e3:.1f} ms',
          flush=True)
    print(f'inverse-cdf:        {timeit(invcdf_scan, logpb, keys)*1e3:.1f} ms',
          flush=True)
    print(f'NxK raw bits:       {timeit(bits_only, keys)*1e3:.1f} ms',
          flush=True)


if __name__ == '__main__':
    main()
