"""Multi-host data parallelism across hosts (SURVEY.md §2.6 target; the
reference's only multi-machine story is launching N processes
with per-run seeds and averaging the outputs, reference
doppler_tutorials/src/program_runner.py:15-23).

Two modes, matching the two ways the reference workloads scale out:

``render_multihost(..., mode="lanes")``
    One GLOBAL 1-D mesh over every device of every process; the wavefront
    shards over it exactly as in `render.render_sharded` (whose sample
    body and layout contract are reused verbatim — global lane ids keep
    RNG correlation groups intact, so the result is bit-identical to the
    single-device render of the same seed). Host-local inputs are lifted
    to global arrays with `jax.make_array_from_callback`; the film halo
    exchange rides the device interconnect within a host and the network
    across hosts, and the developed film is allgathered back to every
    process.

``render_multihost(..., mode="passes")``
    The reference's program_runner pattern: host h renders passes
    seed0 + h, seed0 + h + n_hosts, ... entirely on its LOCAL devices
    (no cross-host traffic during rendering), and the per-host
    accumulation blocks are summed across hosts once at the end. Linear
    scaling for the paper's 4096-16384 spp animation workloads where a
    single pass already fills a host.

Process bootstrap is `init_multihost`, a thin wrapper over
`jax.distributed.initialize`; tests drive a 2-process x 4-virtual-CPU
topology through subprocesses (tests/test_multihost.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_multihost(coordinator_address: str = None,
                   num_processes: int = None, process_id: int = None,
                   local_device_count: int = None) -> None:
    """Initialize jax.distributed for a multi-process run. Pass the
    coordinator address, process count and id explicitly unless a cluster
    environment JAX recognises provides them. ``local_device_count`` forces N virtual
    CPU devices per process (test topologies)."""
    if local_device_count is not None:
        import os
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={local_device_count}")
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def render_multihost(integrator, scene, spp: int = 0, seed: int = 0,
                     mode: str = "lanes", axis: str = "data",
                     develop_film: bool = True):
    """Render across every process/device of the jax.distributed job."""
    from jax.experimental import multihost_utils

    if mode == "passes":
        return _render_pass_split(integrator, scene, spp, seed,
                                  develop_film)

    from .render import render_sharded
    mesh = Mesh(np.array(jax.devices()), (axis,))
    out = render_sharded(integrator, scene, mesh=mesh, spp=spp, seed=seed,
                         develop_film=develop_film)
    return multihost_utils.process_allgather(out, tiled=True)


def host_pass_seeds(seed0: int, n_passes: int, host_id: int = None,
                    n_hosts: int = None):
    """This host's pass seeds under the reference's seed=i split
    (program_runner.py:15-23): host h takes seeds h, h+n_hosts, ..."""
    if host_id is None:
        host_id = jax.process_index()
    if n_hosts is None:
        n_hosts = jax.process_count()
    return list(range(seed0 + host_id, seed0 + n_passes, n_hosts))


def _render_pass_split(integrator, scene, spp: int, seed: int,
                       develop_film: bool):
    """program_runner-style: each host renders its share of the passes on
    local devices only; accumulation blocks sum across DCN at the end."""
    from jax.experimental import multihost_utils
    from .render import render_sharded, make_mesh
    from ..films import develop

    sampler = scene.sensor.sampler
    if spp:
        sampler.set_sample_count(spp)
    spp = sampler.sample_count
    n_hosts = jax.process_count()
    # pass split: spp divides into n_passes single-seed renders
    n_passes = n_hosts
    while spp % n_passes != 0:
        n_passes += 1
        if n_passes > spp:
            n_passes = spp
            break
    spp_pass = spp // n_passes

    local_mesh = make_mesh(jax.local_devices())
    block = None
    for s in host_pass_seeds(seed, n_passes):
        part = render_sharded(integrator, scene, mesh=local_mesh,
                              spp=spp_pass, seed=s, develop_film=False)
        block = part if block is None else block + part
    if block is None:                       # more hosts than passes
        probe = render_sharded(integrator, scene, mesh=local_mesh,
                               spp=spp_pass, seed=seed, develop_film=False)
        block = jnp.zeros_like(probe)
    total = multihost_utils.process_allgather(block)  # (n_hosts, ...)
    total = jnp.sum(jnp.asarray(total), axis=0)
    if develop_film:
        film = scene.sensor.film
        return develop(total, film.has_alpha, film.weight_index)
    return total


__all__ = ["init_multihost", "render_multihost", "host_pass_seeds"]
