"""Device mesh & sharding layer: data-parallel (and chain-parallel) scaling.

The reference has NO distributed backend (SURVEY.md §2.6) — its only
parallelism is a joblib process pool over independent restarts
(evaluate_sinc_parallel.py:120-132). Here scaling is native:

  * mesh axes ('chain', 'data'): data points sharded over 'data',
    independent chains/restarts sharded over 'chain'.
  * Sufficient statistics have fixed size K*(d^2+d+2) regardless of N, and
    they are produced by matmuls contracting over the data axis — under
    pjit with inputs sharded on 'data', XLA inserts the psum/reduce-scatter
    automatically. No hand-written collectives are needed for VI/SVI/EM.
  * Gibbs label sampling is elementwise over N (embarrassingly sharded).

So "multi-chip" here is: shard the data arrays, replicate the priors, and
call the exact same jitted fit functions.
"""

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Multi-host bring-up: one call per host before any jax use.

    Wraps `jax.distributed.initialize`. On GPU hosts nothing announces
    the cluster, so pass `coordinator_address` ('host:port' of process
    0), `num_processes` and `process_id` explicitly. After this,
    `jax.devices()` is the GLOBAL device list, so `make_mesh()` spans
    every host: XLA hands the psum'd statistics (fixed K*m floats, the
    only cross-device traffic per sweep) to NCCL, over NVLink between the
    cards of a host and the network between hosts. The reference has no
    distributed backend at all (SURVEY.md §2.6); this is the whole of
    ours — no hand-written collectives.

    No-op if already initialized (safe to call from every entry point);
    a genuinely failed bring-up (unreachable coordinator, backend already
    started) raises rather than silently degrading the pod to N
    independent single-host jobs.
    """
    if not jax.distributed.is_initialized():
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    return jax.process_index(), jax.process_count()


def make_mesh(n_data=None, n_chain=1, devices=None):
    """Create a ('chain', 'data') mesh. Defaults to all devices on 'data'."""
    devices = jax.devices() if devices is None else devices
    if n_data is None:
        n_data = len(devices) // n_chain
    auto = jax.sharding.AxisType.Auto
    return jax.make_mesh((n_chain, n_data), ('chain', 'data'),
                         devices=devices[:n_chain * n_data],
                         axis_types=(auto, auto))


def shard_data(mesh, *arrays):
    """Place arrays with leading axis N sharded over the 'data' mesh axis."""
    out = tuple(
        jax.device_put(a, NamedSharding(mesh, P('data')))
        for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh, tree):
    """Replicate a parameter pytree over the whole mesh."""
    return jax.device_put(tree, NamedSharding(mesh, P()))


def data_parallel_fit(model, fit_name, data, mesh=None, **kw):
    """Run `model.<fit_name>` with data sharded over the mesh's 'data' axis.

    The fit functions are already pure jitted programs; sharded inputs are
    all XLA needs to produce a data-parallel program with psum'd statistics.
    """
    mesh = make_mesh() if mesh is None else mesh
    data = data if isinstance(data, tuple) else (data,)
    n = data[0].shape[0]
    n_shards = mesh.shape['data']
    if n % n_shards != 0:
        raise ValueError(
            f'N={n} not divisible by data-mesh size {n_shards}; pad first')
    # Auto (GSPMD) mode: sharded inputs + jit is all XLA needs; the
    # statistics contractions over the data axis lower to reduce-scatter/
    # all-reduce automatically. (Explicit mode via jax.set_mesh would
    # require per-op sharding annotations — unnecessary here.)
    data = tuple(shard_data(mesh, d) for d in data)
    return getattr(model, fit_name)(data if len(data) > 1 else data[0], **kw)


def pad_to_multiple(x, multiple, axis=0):
    """Pad with zeros so shape[axis] is a multiple; returns (padded, n_valid).

    Use together with a weight mask: all engines accept weighted
    responsibilities, so padded points with zero weight are exact no-ops
    (the static-shape replacement for the reference's NaN-masking,
    gaussian.py:191-192)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return jnp.pad(x, pad), n
