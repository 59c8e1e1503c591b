"""The JAX package's functions as the port's tests call them for a
reference: jitted once for each function and set of non-array arguments, so
that a call repeated on one shape compiles once. An eager call compiles a
shard_map anew each time (3.5-6 times as long on the CPU as a jitted one)
and traces every leaf's loop of the embedding drivers anew."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cholesky_tpu.parallel.blockcyclic import BlockCyclic


def _is_array(a):
    return isinstance(a, (np.ndarray, jax.Array))


@functools.lru_cache(maxsize=None)
def _jitted(fn, static, kw):
    """fn with the arguments ``static`` ((position, value), ...) and the
    keywords ``kw`` fixed, jitted over the others."""
    def f(*arrays):
        full = list(arrays)
        for i, a in static:
            full.insert(i, a)
        return fn(*full, **dict(kw))

    return jax.jit(f)


def jcall(fn, *args, **kw):
    """fn(*args, **kw), jitted over its array arguments."""
    static = tuple((i, a) for i, a in enumerate(args) if not _is_array(a))
    return _jitted(fn, static, tuple(sorted(kw.items())))(
        *(jnp.asarray(a) for a in args if _is_array(a)))


def _shards(out):
    return out.local if isinstance(out, BlockCyclic) else out


def _on_shards(fn, mesh, n, nb, axis, local, *args, **kw):
    out = fn(BlockCyclic(local=local, n=n, nb=nb, mesh=mesh, axis=axis),
             *args, **kw)
    return tuple(map(_shards, out)) if isinstance(out, tuple) else _shards(out)


def on_shards(fn, bc, *args, **kw):
    """fn(bc, *args, **kw) for a BlockCyclic ``bc``, jitted over its shards
    and the array arguments; a BlockCyclic in the result comes back as its
    shards (``dataclasses.replace(bc, local=...)`` rewraps them)."""
    return jcall(_on_shards, fn, bc.mesh, bc.n, bc.nb, bc.axis, bc.local,
                 *args, **kw)
