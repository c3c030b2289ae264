"""The JAX package's multi-device programs on 8 fake CPU devices, with
``tests/md_programs.py``'s inputs, writing their outputs for the port's
tests to hold its mesh layer against.

  python tests/jax_mesh_reference.py <out.npz>

``flash_decode`` (an (8,) "model" mesh), ``compressed_psum`` (a (2, 4)
pod x data mesh, k = 1.0; every device's result) and ``pipeline`` (a (4,)
"stage" mesh).
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.launch.mesh import make_mesh  # noqa: E402
from repro.parallel.collectives import (compressed_psum,  # noqa: E402
                                        flash_decode_shardmap)
from repro.parallel.pipeline import mlp_stage, pipeline_forward  # noqa: E402


def flash_decode():
    mesh = make_mesh((8,), ("model",))
    rng = np.random.default_rng(1)
    b, h, t, d = 2, 4, 64, 16
    q = jnp.asarray(rng.standard_normal((b, h, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, t, h, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, t, h, d)), jnp.float32)
    with mesh:
        return np.asarray(jax.jit(flash_decode_shardmap(mesh, "model"))(
            q, k, v))


def psum():
    mesh = make_mesh((2, 4), ("pod", "data"))
    rng = np.random.default_rng(2)
    g = jnp.asarray(rng.standard_normal((2, 4, 64)), jnp.float32)
    errs = jnp.zeros((2, 4, 64), jnp.float32)
    reducer = compressed_psum(mesh, pod_axis="pod", inner_axes=("data",),
                              k_fraction=1.0)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P("pod", "data"), P("pod", "data")),
                       out_specs=(P("pod", "data"), P("pod", "data")),
                       check_rep=False)
    def run(g_local, e_local):
        gg, ee = reducer({"g": g_local[0, 0]}, {"g": e_local[0, 0]})
        return gg["g"][None, None], ee["g"][None, None]

    with mesh:
        out, err = jax.jit(run)(g, errs)
    return np.asarray(out), np.asarray(err)


def pipeline():
    mesh = make_mesh((4,), ("stage",))
    rng = np.random.default_rng(0)
    s, m, mb, d = 4, 6, 8, 16
    params = {"w1": jnp.asarray(rng.standard_normal((s, d, d)) * 0.3,
                                jnp.float32),
              "w2": jnp.asarray(rng.standard_normal((s, d, d)) * 0.3,
                                jnp.float32)}
    xs = jnp.asarray(rng.standard_normal((m, mb, d)), jnp.float32)
    with mesh:
        return np.asarray(jax.jit(pipeline_forward(mlp_stage, mesh,
                                                   "stage"))(params, xs))


if __name__ == "__main__":
    out, err = psum()
    np.savez(sys.argv[1], flash_decode=flash_decode(), psum=out,
             psum_err=err, pipeline=pipeline())
