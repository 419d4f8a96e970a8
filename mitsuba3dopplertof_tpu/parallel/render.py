"""shard_map render: data-parallel wavefront over a 1-D device mesh.

Layout contract (SURVEY.md §2.6): the wavefront is pixel-major, shards are
contiguous lane ranges aligned to pixel ROW boundaries, so RNG correlation
groups (time_correlate_number consecutive lanes) never straddle devices.
Each device splats its pixel rows into a local canvas; one psum over the
mesh axis merges films — the counterpart of the reference's atomic film
scatter (reference src/render/imageblock.cpp:119-127), but deterministic.

Feature parity: the per-lane sampling body is the SAME
``integrators._build_sample_fn`` the single-device render uses — aperture
draws, spectral hero wavelengths, polarized Stokes, AOVs and specfilm SRF
binning all work sharded, and real pixels keep their global lane ids so
output is bit-identical to the single-device render. Arbitrary film heights
are handled by padding rows up to a multiple of the device count (the
padded lanes render inactive).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..films import block_create, block_splat_wavefront, develop

_PAD = 4   # rows of film padding above/below each shard (max filter radius)


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def render_sharded(integrator, scene, mesh: Mesh = None, sensor=None,
                   seed: int = 0, spp: int = 0, develop_film: bool = True,
                   max_lanes_per_device: int = 1 << 21):
    """Render with the wavefront sharded over ``mesh`` (axis 0)."""
    from ..integrators import _build_sample_fn

    if mesh is None:
        mesh = make_mesh()
    axis = mesh.axis_names[0]
    D = int(mesh.devices.size)

    if sensor is None:
        sensor = scene.sensor
    film = sensor.film
    sampler = sensor.sampler
    if spp:
        sampler.set_sample_count(spp)
    spp = sampler.sample_count

    W, H = film.crop_size
    rows_local = -(-H // D)            # ceil: arbitrary H supported
    Hp = rows_local * D

    spp_per_pass = spp
    while (W * Hp * spp_per_pass) // D > max_lanes_per_device and spp_per_pass > 1:
        d = spp_per_pass - 1
        while spp % d != 0:
            d -= 1
        spp_per_pass = d
    n_passes = spp // spp_per_pass
    wavefront = W * Hp * spp_per_pass
    n_real = W * H * spp_per_pass      # lanes that exist single-device

    sampler.set_samples_per_wavefront(spp_per_pass)
    state = sampler.seed(seed, wavefront)   # (wavefront,) state, shardable

    sa = scene.compile()
    n_ch = film.channel_count + len(integrator.aov_names())
    rfilter = film.rfilter
    n_local = wavefront // D

    sample_fn = _build_sample_fn(integrator, sensor, sampler, film, W, H,
                                 spp_per_pass)

    # film merge strategy: a reconstruction filter only spills _PAD rows
    # past a shard's own row range, so the full-canvas psum (all-reduce
    # bytes ~ n_ch*Hp*W per device regardless of the 1/D rows each device
    # wrote) is replaced by a HALO EXCHANGE: each device keeps its body
    # rows sharded and ppermutes only the 2*_PAD spill rows to its
    # neighbours. Per-device traffic drops from O(H) to O(H/D + _PAD)
    # rows, and the result is bit-identical: every pixel row receives
    # exactly the same set of addends (its shard's body plus at most one
    # neighbour's spill; psum's other terms were exact zeros). Shards
    # shorter than the filter pad fall back to the psum path.
    use_halo = rows_local >= _PAD and D > 1

    def shard_pass(sa, state, dev_lane0):
        lane0 = dev_lane0[0]
        lane = lane0 + jnp.arange(n_local, dtype=jnp.uint32)
        active = lane < jnp.uint32(n_real)    # padded rows render inactive
        values, put_x, put_y, active, state = sample_fn(sa, state, lane,
                                                        active)

        # splat local pixel rows into a padded local canvas (row offset
        # removed so the local range starts at canvas row _PAD)
        row0 = (lane0 // jnp.uint32(spp_per_pass)
                // jnp.uint32(W)).astype(jnp.int32)
        local = block_splat_wavefront(
            jnp.zeros((n_ch, rows_local + 2 * _PAD, W), jnp.float32),
            rfilter, put_x, put_y - row0.astype(jnp.float32),
            values, active, W, rows_local, spp_per_pass, pad_rows=_PAD)

        if use_halo:
            # neighbour spill: my top pad rows belong to the previous
            # shard's range, my bottom pad rows to the next shard's
            up = [(i, i - 1) for i in range(1, D)]      # send towards dev 0
            down = [(i, i + 1) for i in range(D - 1)]   # send towards dev D-1
            from_next = jax.lax.ppermute(local[:, :_PAD], axis, up)
            from_prev = jax.lax.ppermute(
                local[:, _PAD + rows_local:], axis, down)
            body = local[:, _PAD:_PAD + rows_local]
            body = body.at[:, :_PAD].add(from_prev)
            body = body.at[:, rows_local - _PAD:].add(from_next)
            return body, state                      # stays row-sharded

        # fallback: place on a padded full canvas, all-reduce over the mesh
        canvas = jnp.zeros((n_ch, Hp + 2 * _PAD, W), jnp.float32)
        canvas = jax.lax.dynamic_update_slice(canvas, local, (0, row0, 0))
        canvas = jax.lax.psum(canvas, axis)
        return canvas[:, _PAD:_PAD + H, :], state

    # sampler-state leaves: per-lane arrays shard over the mesh axis,
    # scalar indices replicate
    from ..samplers import SamplerStateT
    from ..core.rng import PCG32State
    pc = PCG32State(P(axis), P(axis), P(axis), P(axis))
    state_spec = SamplerStateT(rng=pc, rng_time=pc, rng_path=pc,
                               permutation_seed=P(axis),
                               sample_index=P(), dimension_index=P(),
                               lane=P(axis), seed_value=P())
    film_spec = P(None, axis, None) if use_halo else P()
    shard_fn = shard_map(
        shard_pass, mesh=mesh,
        in_specs=(P(), state_spec, P(axis)),
        out_specs=(film_spec, state_spec),
        check_vma=False)

    dev_lane0 = jnp.arange(D, dtype=jnp.uint32) * jnp.uint32(n_local)
    jitted = jax.jit(shard_fn)

    # multi-host meshes (jax.distributed): host-local inputs must become
    # global arrays before they can cross the jit boundary, and every op
    # that touches a non-fully-addressable result must itself be jitted
    spans_hosts = len({d.process_index for d in mesh.devices.flat}) > 1
    if spans_hosts:
        from jax.sharding import NamedSharding

        def lift(x, spec):
            x = np.asarray(x)
            sh = NamedSharding(mesh, spec)
            return jax.make_array_from_callback(x.shape, sh,
                                                lambda idx: x[idx])
        sa = jax.tree_util.tree_map(lambda x: lift(x, P()), sa)
        dev_lane0 = lift(dev_lane0, P(axis))
        state = jax.tree_util.tree_map(lift, state, state_spec)
        first = jax.jit(lambda p: p[:, :H] if use_halo else p)
        accum = jax.jit(lambda b, p: b + (p[:, :H] if use_halo else p))
        advance = jax.jit(sampler.advance)
        dev = jax.jit(lambda b: develop(b, film.has_alpha,
                                        film.weight_index))
        block = None
        for _ in range(n_passes):
            part, state = jitted(sa, state, dev_lane0)
            block = first(part) if block is None else accum(block, part)
            state = advance(state)
        return dev(block) if develop_film else block

    block = block_create(W, H, n_ch)
    for _ in range(n_passes):
        part, state = jitted(sa, state, dev_lane0)
        block = block + (part[:, :H] if use_halo else part)
        state = sampler.advance(state)

    if develop_film:
        return develop(block, film.has_alpha, film.weight_index)
    return block


__all__ = ["render_sharded", "make_mesh", "render_reference_layout"]


def render_reference_layout(integrator, scene, sensor=None, seed: int = 0,
                            spp: int = 0, chunk_rows: int = 16,
                            develop_film: bool = True):
    """Render with the reference's exact wavefront layout: ONE logical pass
    of W*H*spp lanes (the reference renders 1024 spp in a single wavefront,
    integrator.cpp:227-263), processed in row-chunks with global lane ids.
    With the sampler streams being bitwise PCG32/TEA replicas, each lane
    draws the same random numbers the reference's lane draws — this mode
    exists for sample-exact cross-validation against reference outputs."""
    import jax.numpy as jnp
    from ..films import block_create, block_splat_wavefront, develop
    from ..sensors import sample_ray_kind

    if sensor is None:
        sensor = scene.sensor
    film = sensor.film
    sampler = sensor.sampler
    if spp:
        sampler.set_sample_count(spp)
    spp = sampler.sample_count
    W, H = film.crop_size

    sampler.set_samples_per_wavefront(spp)   # single logical pass
    sa = scene.compile()
    n_ch = film.channel_count
    sp = sensor.device_params()
    lens = (sensor.device_lens_params()
            if hasattr(sensor, "device_lens_params") else None)
    rfilter = film.rfilter
    has_alpha = film.has_alpha
    shutter_open = float(sensor.shutter_open)
    shutter_time = float(sensor.shutter_open_time)
    is_doppler = integrator.is_doppler
    correlate_pixel = integrator.path_correlation_depth > 0

    n_local = chunk_rows * W * spp
    n_chunks = H // chunk_rows
    assert H % chunk_rows == 0

    def chunk_fn(sa, state, lane0, row0):
        n = n_local
        lane = lane0 + jnp.arange(n, dtype=jnp.uint32)
        pix = lane // jnp.uint32(spp)
        py = (pix // jnp.uint32(W)).astype(jnp.float32)
        px = (pix % jnp.uint32(W)).astype(jnp.float32)
        active = jnp.ones((n,), bool)
        if is_doppler:
            off, state = sampler.next_2d_correlate(state, active,
                                                   correlate_pixel)
        else:
            off, state = sampler.next_2d(state, active)
        sx = px + off[0]
        sy = py + off[1]
        ap_x = ap_y = jnp.full((n,), 0.5, jnp.float32)
        time = jnp.full((n,), shutter_open, jnp.float32)
        if shutter_time > 0.0:
            if is_doppler:
                ts, state = sampler.next_1d_time(
                    state, active, integrator.time_sampling_method,
                    integrator.antithetic_shift,
                    integrator.use_stratified_sampling_for_each_interval)
            else:
                ts, state = sampler.next_1d(state, active)
            time = time + ts * shutter_time
        ray, rw = sample_ray_kind(sp, lens, time, sx / W, sy / H, ap_x, ap_y)
        spec, valid, state = integrator.sample(sa, sampler, state, ray,
                                               active)
        spec = spec * rw
        one = jnp.ones((n,), jnp.float32)
        if has_alpha:
            values = [spec.x, spec.y, spec.z, jnp.where(valid, 1.0, 0.0), one]
        else:
            values = [spec.x, spec.y, spec.z, one]
        put_x = px if rfilter.is_box else sx
        put_y = py if rfilter.is_box else sy
        local = block_splat_wavefront(
            jnp.zeros((n_ch, chunk_rows + 2 * _PAD, W), jnp.float32),
            rfilter, put_x, put_y - row0.astype(jnp.float32),
            values, active, W, chunk_rows, spp, pad_rows=_PAD)
        return local

    # note: lane0 is always a multiple of spp, so current_sample_index's
    # (lane % spp) is chunk-invariant — no per-chunk retrace needed
    jitted = jax.jit(chunk_fn)
    canvas = np.zeros((n_ch, H + 2 * _PAD, W), np.float32)
    for c in range(n_chunks):
        state = sampler.seed(seed, n_local, lane0=c * n_local)
        local = np.asarray(jitted(sa, state, jnp.uint32(c * n_local),
                                  jnp.int32(c * chunk_rows)))
        r0 = c * chunk_rows
        canvas[:, r0:r0 + chunk_rows + 2 * _PAD] += local
    block = jnp.asarray(canvas[:, _PAD:_PAD + H])
    if develop_film:
        return develop(block, has_alpha)
    return block
