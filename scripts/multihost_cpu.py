"""Executed evidence for the multi-host path (parallel.init_distributed).

The reference has no distributed backend at all (SURVEY.md §2.6); ours is
`jax.distributed.initialize` + XLA collectives, and this script actually
RUNS it: it spawns N OS processes on this machine (JAX multi-process CPU,
gloo collectives), each process calls
`parallel.init_distributed('localhost:<port>', nprocs, proc_id)`, builds
the GLOBAL ('chain','data') mesh spanning every process's devices, shards
the data across processes, and runs the production sharded engines:

    fit_vi_fused(mesh=)    — psum'd (K, m) stats accumulator
    fit_gibbs_fused(mesh=) — per-device folded PRNG label sweep
    fit_svi(mesh=)         — stratified per-device minibatch + psum
    fit_map_fused(mesh=)   — plug-in fused MAP-EM
    fit_chains over a ('chain','data') = (C, P*D/C) mesh — restarts
      sharded over processes AND points sharded over devices in one
      program (--n-chain)

`--backend interpret` drives the vi/gibbs/map legs through the fused
kernel path (fused_*_pallas_sharded under shard_map across the
multi-process mesh, the kernel in interpret mode on CPU devices, exactly
as test_sharding runs it single-process) — certifying that "fused kernel
under shard_map across hosts" composes with jax.distributed process
topology.

The oracle is a 1-process run over the SAME global mesh shape (1 proc x
2P devices vs P procs x 2 devices): every engine derives its per-device
PRNG stream and reduction layout from the mesh coordinates, not the
process topology, so the two runs must agree — ELBO/loglik traces, label
counts, and every posterior leaf. The launcher asserts exactly that.

Usage:
    python scripts/multihost_cpu.py                   # 2-process vs 1-process
    python scripts/multihost_cpu.py --nprocs 4        # wider
    python scripts/multihost_cpu.py --f32             # f32 tolerances

Nearest reference analogue: joblib seed-parallelism over INDEPENDENT
restarts (evaluate_sinc_parallel.py:120-132) — model-level, not
data-level; it has no cross-process reduction to test at all.
"""

import argparse
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- worker

def worker(args):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_num_cpu_devices', args.devices)
    if not args.f32:
        jax.config.update('jax_enable_x64', True)
    sys.path.insert(0, REPO)
    from mimo_tpu.utils.cache import use_compile_cache
    use_compile_cache()
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.3)

    from mimo_tpu.parallel.mesh import init_distributed, make_mesh, shard_data

    if args.nprocs > 1:
        pid, pcount = init_distributed(f'localhost:{args.port}',
                                       num_processes=args.nprocs,
                                       process_id=args.proc_id)
        assert (pid, pcount) == (args.proc_id, args.nprocs)
    assert jax.device_count() == args.nprocs * args.devices, \
        f'global mesh did not form: {jax.device_count()} devices'

    import numpy as np
    import jax.numpy as jnp
    from mimo_tpu.models.gmm import BayesianGMM

    mesh = make_mesh()          # ('chain','data') = (1, nprocs*devices)
    n_dev = mesh.shape['data']
    backend = args.backend

    # identical data on every process (shard_data slices each process's
    # local rows out of the same global array)
    rng = np.random.default_rng(0)
    n, d, k = 512, 2, 8
    centers = rng.normal(size=(4, d)) * 3.0
    x = (centers[rng.integers(0, 4, size=n)]
         + rng.normal(size=(n, d)) * 0.5)
    dtype = np.float32 if args.f32 else np.float64
    xs = shard_data(mesh, x.astype(dtype))

    model = BayesianGMM.make(size=k, dim=d, gating='stick-breaking',
                             alpha=1.0, kappa=0.05, psi_scale=0.5,
                             dtype=jnp.dtype(dtype))

    def fetch(a):
        """Host value of a replicated global array (multi-process safe)."""
        return np.asarray(jax.device_get(a.addressable_data(0)))

    out = {}
    # the kernel takes any N and no block size
    bs = None if backend == 'interpret' else 64

    st_vi, tr_vi = model.fit_vi_fused(xs, key=1, maxiter=6, block_size=bs,
                                      mesh=mesh, backend=backend)
    out['vi_trace'] = fetch(tr_vi).tolist()
    out['vi_leaves'] = [fetch(a).ravel().tolist()
                        for a in jax.tree.leaves(st_vi)]

    gs = model.fit_gibbs_fused(xs, key=2, maxiter=6, block_size=bs,
                               mesh=mesh, backend=backend)
    counts = jax.jit(lambda l: jnp.sum(jax.nn.one_hot(l, k, dtype=jnp.int32),
                                       axis=0))(gs.labels)
    out['gibbs_counts'] = fetch(counts).tolist()
    out['gibbs_leaves'] = [fetch(a).ravel().tolist()
                           for a in jax.tree.leaves(gs.components)]

    st_svi, _ = model.fit_svi(xs, key=3, maxiter=12, step_size=0.5,
                              batch_size=16 * n_dev, mesh=mesh)
    out['svi_leaves'] = [fetch(a).ravel().tolist()
                         for a in jax.tree.leaves(st_svi)]

    st_map, ll_map = model.fit_map_fused(xs, key=4, maxiter=4,
                                         block_size=bs, mesh=mesh,
                                         backend=backend)
    out['map_trace'] = fetch(ll_map).tolist()

    # chain axis x process topology: restarts sharded over 'chain' (across
    # processes) AND points over 'data' in ONE program. Chain-sharded
    # outputs live on different processes, so the asserted values are
    # all-gathered to replicated inside jit first.
    if args.n_chain > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from mimo_tpu.parallel.chains import fit_chains
        mesh_c = make_mesh(n_chain=args.n_chain)
        keys = jax.random.split(jax.random.PRNGKey(11), args.n_chain * 2)
        keys_sh = jax.device_put(keys, NamedSharding(mesh_c, P('chain')))
        xs_c = jax.device_put(x.astype(dtype),
                              NamedSharding(mesh_c, P('data')))
        _, vlbs = fit_chains(model, 'fit_vi', xs_c, keys_sh, maxiter=8)
        gathered = jax.jit(
            lambda v: v.astype(jnp.float64),
            out_shardings=NamedSharding(mesh_c, P()))(vlbs)
        out['chain_vlbs'] = fetch(gathered)[:, -1].tolist()

    if backend == 'interpret':
        # the svi/stream legs are XLA engines (no kernel path to certify);
        # the kernel leg certifies vi/gibbs/map + the chain axis
        out['proc_id'] = args.proc_id
        out['global_devices'] = jax.device_count()
        with open(args.out, 'w') as f:
            json.dump(out, f)
        print(f'[worker {args.proc_id}/{args.nprocs}] OK pallas '
              f'({jax.device_count()} global devices)', flush=True)
        return

    # out-of-core x multi-process: every process streams ITS shard of
    # the dataset from disk (io.MmapDataset), fit_svi_stream assembles
    # the local rows into global arrays via
    # make_array_from_process_local_data. Deterministic block schedule
    # so the 1-process oracle reads the SAME global batches.
    import tempfile
    from mimo_tpu.io.loader import MmapDataset, write_bin
    n_dev_total = args.nprocs * args.devices
    s = n // n_dev_total                       # rows per device shard
    b = 16                                     # batch rows per device
    first_dev = args.proc_id * args.devices
    local_rows = x.astype(np.float32)[
        first_dev * s:(first_dev + args.devices) * s]
    shard_path = os.path.join(tempfile.gettempdir(),
                              f'mimo_mh_shard_{os.getpid()}.bin')
    write_bin(shard_path, local_rows)
    ds = MmapDataset(shard_path)

    def next_batch(i):
        i_mod = i % (s // b)
        return np.concatenate(
            [ds.read_block(k * s + i_mod * b, b)
             for k in range(args.devices)]).astype(dtype)

    st_str = model.fit_svi_stream(next_batch, total_size=n, key=5,
                                  maxiter=24, step_size=0.3,
                                  batch_size=b * n_dev_total, group=8,
                                  mesh=mesh)
    out['stream_leaves'] = [fetch(a).ravel().tolist()
                            for a in jax.tree.leaves(st_str)]

    # out-of-core FULL-DATA engine x multi-process (round 5): every
    # process streams its shard of each global block; the per-block
    # E-step contracts over the sharded axis (fused_estep_sharded) and
    # the epoch accumulator stays replicated — must equal the 1-process
    # oracle exactly.
    n_blocks = 4
    sb = s // n_blocks                         # rows per device per block

    def read_block(i):
        return np.concatenate(
            [ds.read_block(k * s + i * sb, sb)
             for k in range(args.devices)]).astype(dtype)

    st_ep0, _ = model.fit_vi_stream_full(read_block, n_blocks, key=8,
                                         maxiter=1, mesh=mesh)
    st_ep, tr_ep = model.fit_vi_stream_full(read_block, n_blocks,
                                            init_state=st_ep0, maxiter=4,
                                            mesh=mesh)
    out['epoch_trace'] = np.asarray(tr_ep).tolist()
    out['epoch_leaves'] = [fetch(a).ravel().tolist()
                           for a in jax.tree.leaves(st_ep)]
    ds.close()
    os.unlink(shard_path)

    out['proc_id'] = args.proc_id
    out['global_devices'] = jax.device_count()
    with open(args.out, 'w') as f:
        json.dump(out, f)
    print(f'[worker {args.proc_id}/{args.nprocs}] OK '
          f'({jax.device_count()} global devices)', flush=True)


# -------------------------------------------------------------- launcher

def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(extra, out):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--worker',
         '--out', out] + extra,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def launcher(args):
    import numpy as np
    import tempfile
    tmp = tempfile.mkdtemp(prefix='mimo_multihost_')
    f32 = ['--f32'] if args.f32 else []
    extra = f32 + ['--backend', args.backend,
                   '--n-chain', str(args.n_chain)]
    world = args.nprocs * args.devices

    # 1-process oracle over the SAME global mesh shape
    ref_out = os.path.join(tmp, 'ref.json')
    p = _spawn(['--nprocs', '1', '--proc-id', '0',
                '--devices', str(world)] + extra, ref_out)
    log, _ = p.communicate(timeout=args.timeout)
    if p.returncode != 0:
        print(log)
        raise SystemExit(f'single-process oracle failed rc={p.returncode}')

    # the real multi-process run
    port = _free_port()
    procs, outs = [], []
    for i in range(args.nprocs):
        o = os.path.join(tmp, f'proc{i}.json')
        outs.append(o)
        procs.append(_spawn(
            ['--nprocs', str(args.nprocs), '--proc-id', str(i),
             '--port', str(port), '--devices', str(args.devices)]
            + extra, o))
    logs = []
    failed = False
    for p in procs:
        try:
            log, _ = p.communicate(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            for q in procs:       # kill OUR exact child PIDs only
                q.kill()
            raise
        logs.append(log)
        failed |= p.returncode != 0
    if failed:
        for log in logs:
            print(log)
        raise SystemExit('multi-process run failed')

    ref = json.load(open(ref_out))
    runs = [json.load(open(o)) for o in outs]

    rtol = 1e-4 if args.f32 else 1e-8
    checks = []

    def close(name, a, b):
        a, b = np.asarray(a, float), np.asarray(b, float)
        ok = a.shape == b.shape and np.allclose(a, b, rtol=rtol,
                                                atol=rtol * 10)
        err = float(np.max(np.abs(a - b))) if a.shape == b.shape else np.inf
        checks.append((name, ok, err))
        return ok

    r0 = runs[0]
    close('vi_trace', ref['vi_trace'], r0['vi_trace'])
    for j, (la, lb) in enumerate(zip(ref['vi_leaves'], r0['vi_leaves'])):
        close(f'vi_leaf{j}', la, lb)
    close('gibbs_counts', ref['gibbs_counts'], r0['gibbs_counts'])
    for j, (la, lb) in enumerate(zip(ref['gibbs_leaves'],
                                     r0['gibbs_leaves'])):
        close(f'gibbs_leaf{j}', la, lb)
    for j, (la, lb) in enumerate(zip(ref['svi_leaves'], r0['svi_leaves'])):
        close(f'svi_leaf{j}', la, lb)
    close('map_trace', ref['map_trace'], r0['map_trace'])
    if 'chain_vlbs' in ref:
        close('chain_vlbs', ref['chain_vlbs'], r0['chain_vlbs'])
    if 'stream_leaves' in ref:
        for j, (la, lb) in enumerate(zip(ref['stream_leaves'],
                                         r0['stream_leaves'])):
            close(f'stream_leaf{j}', la, lb)
    if 'epoch_trace' in ref:
        close('epoch_trace', ref['epoch_trace'], r0['epoch_trace'])
        for j, (la, lb) in enumerate(zip(ref['epoch_leaves'],
                                         r0['epoch_leaves'])):
            close(f'epoch_leaf{j}', la, lb)
    # every process must report the same replicated values
    for i, r in enumerate(runs[1:], 1):
        close(f'proc{i}_vi_trace', r0['vi_trace'], r['vi_trace'])
        close(f'proc{i}_map_trace', r0['map_trace'], r['map_trace'])

    bad = [c for c in checks if not c[1]]
    for name, ok, err in checks:
        print(f'  {"OK " if ok else "FAIL"} {name:<16} max|diff|={err:.3g}')
    engines = ['fit_vi_fused', 'fit_gibbs_fused', 'fit_svi',
               'fit_map_fused']
    if args.n_chain > 1:
        engines.append('fit_chains')
    if args.backend != 'interpret':
        engines.append('fit_svi_stream')
        engines.append('fit_vi_stream_full')
    result = {
        'ok': not bad, 'nprocs': args.nprocs,
        'devices_per_proc': args.devices, 'global_devices': world,
        'backend': args.backend, 'n_chain': args.n_chain,
        'checks': len(checks), 'failed': len(bad),
        'engines': engines,
    }
    print(json.dumps(result))
    if bad:
        raise SystemExit(1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--worker', action='store_true')
    ap.add_argument('--nprocs', type=int, default=2)
    ap.add_argument('--proc-id', type=int, default=0)
    ap.add_argument('--port', type=int, default=0)
    ap.add_argument('--devices', type=int, default=2,
                    help='local CPU devices per process')
    ap.add_argument('--out', default='')
    ap.add_argument('--f32', action='store_true')
    ap.add_argument('--backend', default='xla',
                    choices=['xla', 'interpret'],
                    help='interpret = the fused kernel path under '
                         'shard_map (interpret mode on CPU devices)')
    ap.add_argument('--n-chain', type=int, default=1,
                    help='>1 adds a fit_chains leg on a (n_chain, '
                         'world/n_chain) mesh — restarts sharded across '
                         'processes')
    ap.add_argument('--timeout', type=float, default=600.0)
    args = ap.parse_args()
    if args.worker:
        worker(args)
    else:
        launcher(args)


if __name__ == '__main__':
    main()
