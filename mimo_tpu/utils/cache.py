"""Where JAX keeps its persistent compilation cache."""

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_compile_cache():
    """Keep compiled programs across processes. Where
    JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing is
    set here; otherwise the cache goes to the fixed <checkout>/.jax_cache,
    so that every process of this checkout finds it again. Returns the
    directory in use."""
    path = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if not path:
        path = os.path.join(CHECKOUT, '.jax_cache')
        jax.config.update('jax_compilation_cache_dir', path)
    return path
