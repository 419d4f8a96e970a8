"""Integrator plugins + render orchestration.

Rebuild of the reference's integrator stack:

  * render orchestration (wavefront sizing, multi-pass, film)
      — reference src/render/integrator.cpp:104-347
  * doppler branch of render_sample (correlated pixel/aperture/time draws)
      — reference integrator.cpp:399-543
  * ``path`` MIS path tracer — reference src/integrators/path.cpp
  * ``dopplertofpath``       — reference src/integrators/dopplertofpath.cpp
  * ``velocity``             — reference src/integrators/velocity.cpp:125-137
  * ``depth``                — reference src/integrators/depth.cpp

Design: one jitted pass-function renders W*H*spp_per_pass lanes: pixel
decode -> sampler draws -> camera ray -> unrolled bounce loop (static
max_depth, masked lanes — the XLA analog of the reference's recorded
dr::Loop megakernel) -> scatter-free film accumulation. All per-lane state
is component-wise (N,) arrays (core/vec.py). The Python pass loop re-invokes
the same compiled program with advanced sampler state, mirroring the
reference's multi-pass splitting (integrator.cpp:227-308).
"""

from __future__ import annotations

import math
import os
import time as _time
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..core.properties import Properties, register_plugin
from ..core.vec import Vec3, dot, normalize, where3, vmax
from ..core.waveform import (WAVEFORM_TYPES, eval_modulation,
                             eval_modulation_low_pass)
from ..render.types import Ray, SurfaceInteraction, DirectionSample
from ..render.scene import SceneArrays, ray_intersect, ray_test, gather_small
from ..samplers import TIME_SAMPLING_METHODS, TIME_ANTITHETIC
from ..bsdfs import eval_pdf_sample as bsdf_eval_pdf_sample, FLAG_SMOOTH
from .. import emitters as em_mod
from ..films import (block_create, block_splat_wavefront, develop,
                     filter_reach)
from ..sensors import sample_ray_kind as sensor_sample_ray_kind

# Default lane budget per pass (HBM-derived chunking; the reference's
# analogous limit is the 2^32 wavefront cap, integrator.cpp:227-245)
DEFAULT_MAX_LANES = 1 << 20

# render/ad.py flips this while tracing gradients: reverse-mode AD needs
# the statically-bounded fori_loop bounce loop (while_loop has no VJP)
_STATIC_BOUNCE_LOOP = False


def bounce_loop(bounce, carry, iterations, allow_early_exit=True):
    """Run the per-bounce body up to ``iterations`` times; when allowed,
    exit as soon as every lane has terminated (dr::Loop's implicit
    behavior). ``carry[-1]`` must be the active mask.

    Draw-for-draw identical to the full fori_loop: PCG32 draws advance
    only where active (core/rng.py pcg32_next_u32), so an all-dead
    iteration is a state no-op, and nothing draws after the loop within a
    pass (advance() re-derives per-pass streams and resets
    dimension_index) — this is what keeps the correlated/doppler
    antithetic pair replay bitwise intact (tests/test_doppler_variance).
    Disabled under reverse-mode AD (_STATIC_BOUNCE_LOOP — while_loop has
    no VJP) and with MI_NO_EARLY_EXIT=1."""
    if (allow_early_exit and not _STATIC_BOUNCE_LOOP
            and not os.environ.get("MI_NO_EARLY_EXIT")):
        return jax.lax.while_loop(
            lambda c: (c[0] < iterations) & jnp.any(c[1][-1]),
            lambda c: (c[0] + 1, bounce(c[0], c[1])),
            (jnp.int32(0), carry))[1]
    return jax.lax.fori_loop(0, iterations, bounce, carry)


def mis_weight(pdf_a, pdf_b):
    """Power heuristic with the reference's non-finite guard
    (reference dopplertofpath.cpp:296-301)."""
    a2 = pdf_a * pdf_a
    w = a2 / (a2 + pdf_b * pdf_b)
    return jnp.where(jnp.isfinite(w), w, 0.0)


class Integrator:
    # tpu_spectral support: "hero" = draws hero wavelengths and evaluates
    # spectrally; "neutral" = purely geometric output, wavelength-free;
    # None = not supported under the spectral variant.
    spectral_mode = None
    """Base (reference integrator.cpp:22-28)."""

    def __init__(self, props: Properties):
        self.id = props.id
        # cooperative cancellation budget in seconds (reference
        # integrator.cpp:24,48-50): checked between passes
        self.timeout = props.get_float("timeout", -1.0)
        self.hide_emitters = props.get_bool("hide_emitters", False)
        self._cancel = False

    def cancel(self):
        """Request cooperative cancellation (reference Integrator::cancel,
        integrator.cpp:48-50): the render loop stops at the next pass
        boundary and develops the partial film."""
        self._cancel = True

    def should_stop(self, start_time: float) -> bool:
        return self._cancel or (self.timeout > 0.0
                                and _time.time() - start_time > self.timeout)

    def aov_names(self):
        return []


class SamplingIntegrator(Integrator):
    """Adds the fork's Doppler/time-sampling knobs
    (reference integrator.cpp:54-100)."""

    is_doppler = False

    def __init__(self, props: Properties):
        super().__init__(props)
        self.is_doppler = (props.get_bool("is_doppler_integrator", False)
                           or self.is_doppler)
        tsm = props.get_string("time_sampling_method", "antithetic")
        if tsm not in TIME_SAMPLING_METHODS:
            raise RuntimeError(f"Unknown time_sampling_method '{tsm}'")
        self.time_sampling_method = TIME_SAMPLING_METHODS[tsm]
        default_shift = 0.5 if self.time_sampling_method == TIME_ANTITHETIC else 0.0
        self.antithetic_shift = props.get_float("antithetic_shift", default_shift)
        self.use_stratified_sampling_for_each_interval = props.get_bool(
            "use_stratified_sampling_for_each_interval", True)
        self.path_correlation_depth = props.get_int("path_correlation_depth", 0)
        props.get_int("block_size", 0)
        self.samples_per_pass = props.get_int("samples_per_pass", -1)

    def sample(self, sa: SceneArrays, sampler, state, ray: Ray, active):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # render orchestration (reference integrator.cpp:104-347)
    # ------------------------------------------------------------------
    def render(self, scene, sensor=None, seed: int = 0, spp: int = 0,
               develop_film: bool = True, max_lanes: int = DEFAULT_MAX_LANES,
               checkpoint_path: str = None, checkpoint_every: int = 16):
        """Render; if ``checkpoint_path`` is given, the accumulated film and
        pass counter persist every ``checkpoint_every`` passes and a
        restarted render resumes from the last checkpoint (pass-level
        restartability: each pass is deterministic given (scene, seed) —
        the counter-based generalization of the reference tutorials'
        exit-if-exists resume, program_runner.py:110-112)."""
        if sensor is None:
            sensor = scene.sensor
        film = sensor.film
        sampler = sensor.sampler
        if spp:
            sampler.set_sample_count(spp)
        spp = sampler.sample_count

        W, H = film.crop_size
        # Wavefront sizing. Preferred split: STRIP passes — each pass
        # renders the next few pixel ROWS at FULL spp (lane = global
        # pixel*spp + s). A sorted lane block then holds a handful of
        # pixels' complete sample sets instead of ~64 pixels' slices,
        # which shrinks the traversal kernels' per-block visit-list
        # unions several-fold (the round-5 union lab: camera blocks at
        # 16 spp/pass needed ~210 of 1264 scene units; per-pixel sample
        # sets nearly coincide). RNG/stratification are windowed from
        # one global wavefront (sampler.seed(lane0)/advance_window), so
        # the partitioning is invisible to every sampling contract.
        # Fallback (MI_SPP_SLICE_PASSES=1, explicit samples_per_pass, or
        # spp*W > max_lanes): the reference-style spp slicing, largest
        # divisor of spp with W*H*d <= max_lanes (integrator.cpp:227-245).
        spp_per_pass = spp if self.samples_per_pass < 0 else min(
            self.samples_per_pass, spp)
        rows_per_pass = max_lanes // max(W * spp, 1)
        # timeout renders keep spp slicing: their partial film must be a
        # full (noisy) image, not a strip region (reference semantics,
        # integrator.cpp:248-255 + tests/test_observability.py)
        strip_mode = (self.samples_per_pass < 0 and self.timeout <= 0.0
                      and W * H * spp > max_lanes and rows_per_pass >= 1
                      and not os.environ.get("MI_SPP_SLICE_PASSES"))
        if strip_mode:
            spp_per_pass = spp
            rows_per_pass = min(rows_per_pass, H)
            n_passes = -(-H // rows_per_pass)
            n_lanes = rows_per_pass * W * spp
        else:
            while W * H * spp_per_pass > max_lanes and spp_per_pass > 1:
                d = spp_per_pass - 1
                while spp % d != 0:
                    d -= 1
                spp_per_pass = d
            n_passes = spp // spp_per_pass
            n_lanes = W * H * spp_per_pass

        sampler.set_samples_per_wavefront(spp_per_pass)
        state = sampler.seed(seed, n_lanes)

        sa = scene.compile()
        n_channels = film.channel_count + len(self.aov_names())
        if strip_mode:
            # canvas: filter-reach pads + virtual rows rounding H up to
            # whole strips (ragged last strip renders inactive lanes);
            # develop slices the [pad, pad+H) center back out
            pad_k = filter_reach(film.rfilter)
            block = block_create(W, pad_k * 2 + n_passes * rows_per_pass,
                                 n_channels)
        else:
            pad_k = 0
            block = block_create(W, H, n_channels)
        strip_rows = rows_per_pass if strip_mode else None
        pass_fn = self._get_pass_fn(sensor, sampler, film, W, H,
                                    spp_per_pass, strip_rows, pad_k)

        start_pass = 0
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            ck = np.load(checkpoint_path)
            ck_strip = ("strip" in ck.files) and bool(ck["strip"])
            if (int(ck["seed"]) == seed and int(ck["spp"]) == spp
                    and ck_strip == strip_mode
                    and ck["block"].shape == tuple(block.shape)):
                start_pass = int(ck["pass_idx"])
                block = jnp.asarray(ck["block"])
                if strip_mode:
                    # windowed streams depend only on (seed, lane): jump
                    # straight to the resume strip's lane window
                    state = sampler.seed(seed, n_lanes,
                                         lane0=start_pass * n_lanes)
                else:
                    # replay sampler advancement (cheap scalar updates)
                    for _ in range(start_pass):
                        state = sampler.advance(state)

        from ..core import logger as _log
        self._cancel = False
        t_start = _time.time()
        show_progress = (os.environ.get("MI_SHOW_PROGRESS")
                         or _log.log_level() <= _log.DEBUG)
        reporter = _log.ProgressReporter(
            f"Rendering {W}x{H}@{spp}spp", enabled=bool(show_progress))

        if (checkpoint_path is None and n_passes > 1 and self.timeout <= 0.0
                and not show_progress
                and not os.environ.get("MI_NO_FUSED_PASSES")):
            # fuse the whole pass loop into one device dispatch; the pass
            # count is a traced loop bound, so one compilation serves any
            # number of passes
            multi = self._get_multi_pass_fn(sensor, sampler, film, W, H,
                                            spp_per_pass,
                                            strip_rows=strip_rows,
                                            pad_rows=pad_k)
            t0 = _time.time()
            block, state = multi(sa, block, state, jnp.int32(n_passes))
            jax.block_until_ready(block)
            _log.log(_log.DEBUG, "render: %d fused passes in %.3fs "
                     "(incl. compile on first call)", n_passes,
                     _time.time() - t0)
        else:
            t_first = None
            for p in range(start_pass, n_passes):
                block, state = pass_fn(sa, block, state)
                state = (sampler.advance_window(state) if strip_mode
                         else sampler.advance(state))
                if p == start_pass:
                    jax.block_until_ready(block)
                    t_first = _time.time() - t_start
                if (checkpoint_path is not None
                        and ((p + 1) % checkpoint_every == 0
                             or p + 1 == n_passes)):
                    np.savez(checkpoint_path, block=np.asarray(block),
                             pass_idx=p + 1, seed=seed, spp=spp,
                             strip=strip_mode)
                reporter.update((p + 1 - start_pass)
                                / max(n_passes - start_pass, 1))
                if p + 1 < n_passes and self.should_stop(t_start):
                    # cooperative cancellation (integrator.cpp:48-50):
                    # develop the partial accumulation, scaled correctly
                    # by the weight channel
                    _log.log(_log.WARN,
                             "render cancelled after %d/%d passes (%s)",
                             p + 1, n_passes,
                             "timeout" if not self._cancel else "cancel()")
                    break
            if t_first is not None and n_passes - start_pass > 1:
                jax.block_until_ready(block)
                total = _time.time() - t_start
                per_pass = (total - t_first) / max(n_passes - start_pass - 1,
                                                   1)
                # compile-vs-execute split (reference integrator.cpp:312-339
                # logs graph-record time separately from execution)
                _log.log(_log.DEBUG,
                         "render: first pass %.3fs (compile+exec), "
                         "steady-state %.3fs/pass, total %.3fs",
                         t_first, per_pass, total)

        if strip_mode:
            # slice the image region back out of the padded strip canvas
            block = block[:, pad_k:pad_k + H]
        if develop_film:
            return develop(block, film.has_alpha, film.weight_index)
        return block

    def _get_multi_pass_fn(self, sensor, sampler, film, W, H, spp_per_pass,
                           strip_rows: int = None, pad_rows: int = 0):
        """One compiled program running a DYNAMIC number of fused passes:
        the fori_loop bound is a traced argument, so a single compilation
        serves any pass count. Film and sampler state are donated unless
        MI_NO_DONATE is set."""
        key = ("multi", id(sensor), id(sampler), id(film), W, H,
               spp_per_pass, sampler.sample_count,
               sampler.samples_per_wavefront, strip_rows)
        cache = self._pass_fn_cache if hasattr(self, "_pass_fn_cache") else {}
        self._pass_fn_cache = cache
        if key not in cache:
            raw = self._get_pass_fn(sensor, sampler, film, W, H,
                                    spp_per_pass, strip_rows, pad_rows).raw
            strip = strip_rows is not None

            def run_passes(sa, block, state, n):
                def body(_, carry):
                    blk, st = carry
                    blk, st = raw(sa, blk, st)
                    return blk, (sampler.advance_window(st) if strip
                                 else sampler.advance(st))
                return jax.lax.fori_loop(0, n, body, (block, state))

            dn = () if os.environ.get("MI_NO_DONATE") else (1, 2)
            cache[key] = jax.jit(run_passes, donate_argnums=dn)
        return cache[key]

    def _get_pass_fn(self, sensor, sampler, film, W, H, spp_per_pass,
                     strip_rows: int = None, pad_rows: int = 0):
        # sample_count participates: interval stratification divides [0,1)
        # into sample_count/Tc strata at TRACE time (correlated.cpp:109-125)
        key = (id(sensor), id(sampler), id(film), W, H, spp_per_pass,
               sampler.sample_count, sampler.samples_per_wavefront,
               strip_rows)
        cache = getattr(self, "_pass_fn_cache", None)
        if cache is None:
            cache = {}
            self._pass_fn_cache = cache
        if key not in cache:
            cache[key] = _build_pass_fn(self, sensor, sampler, film, W, H,
                                        spp_per_pass, strip_rows, pad_rows)
        return cache[key]


def _scene_depolarizing(sa) -> bool:
    """True when polarized transport provably equals scalar transport, so
    the Mueller 4x4 chain (~1.6x arithmetic) can be skipped wholesale:
    every BSDF is an exact depolarizer (diffuse=0 / null=1, Mueller
    m = f*E00 — one ideal-depolarizer bounce zeroes S1..S3 and S0 follows
    the scalar estimator term-for-term), all emitters in this framework
    emit unpolarized (reference parity), media transmittance is diagonal,
    and every phase function except Rayleigh depolarizes. The polarized
    variant's film image is the S0 component, so on such scenes the
    scalar integrator IS the polarized result (S1..S3 identically 0).
    Disable with MI_NO_DEPOL_FASTPATH=1 (A/B harness)."""
    if os.environ.get("MI_NO_DEPOL_FASTPATH"):
        return False
    if set(sa.bsdf_types_present) - {0, 1}:
        return False
    if getattr(sa, "any_rayleigh", False):
        return False
    return True


def _build_sample_fn(integrator, sensor, sampler, film, W, H, spp_per_pass):
    """Build the per-lane wavefront sampling body — pixel decode, sampler
    draws, camera ray, integrator dispatch (rgb / spectral-hero / polarized
    / specfilm / AOV), film channel assembly. Shared by the single-device
    pass function and the sharded render (parallel/render.py), so every
    feature works identically under shard_map.

    Returns ``sample_wavefront(sa, state, lane, active) ->
    (values, put_x, put_y, active, state)`` with ``lane`` the GLOBAL lane
    ids (lane // spp = pixel, row-major) — identical ids produce identical
    RNG streams on any device layout (the correlation-group contract,
    SURVEY.md §2.6)."""
    sensor_params = sensor.device_params()
    lens_params = (sensor.device_lens_params()
                   if hasattr(sensor, "device_lens_params") else None)
    rfilter = film.rfilter
    has_alpha = film.has_alpha
    shutter_open = float(sensor.shutter_open)
    shutter_time = float(sensor.shutter_open_time)
    is_doppler = integrator.is_doppler
    correlate_pixel = integrator.path_correlation_depth > 0
    if hasattr(integrator, "set_sensor"):
        integrator.set_sensor(sensor)

    def sample_wavefront(sa: SceneArrays, state, lane, active):
        n = lane.shape[0]
        pix = lane // jnp.uint32(spp_per_pass)
        py = (pix // jnp.uint32(W)).astype(jnp.float32)
        px = (pix % jnp.uint32(W)).astype(jnp.float32)

        # ---- position / aperture / time draws (integrator.cpp:399-543) --
        if is_doppler:
            off, state2 = sampler.next_2d_correlate(state, active,
                                                    correlate_pixel)
        else:
            off, state2 = sampler.next_2d(state, active)
        state = state2
        sx = px + off[0]
        sy = py + off[1]
        adj_x = sx * (1.0 / W)
        adj_y = sy * (1.0 / H)

        if sensor.needs_aperture_sample:
            if is_doppler:
                ap, state = sampler.next_2d_correlate(state, active,
                                                      correlate_pixel)
            else:
                ap, state = sampler.next_2d(state, active)
            ap_x, ap_y = ap
        else:
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

        ray, ray_weight = sensor_sample_ray_kind(
            sensor_params, lens_params, time, adj_x, adj_y, ap_x, ap_y)

        spectral = bool(sa.spectral) and integrator.spectral_mode == "hero"
        if sa.spectral and integrator.spectral_mode is None:
            raise RuntimeError(
                f"integrator '{type(integrator).__name__}' does not support "
                "the tpu_spectral variant yet (path / dopplertofpath / "
                "velocity / depth do)")
        if getattr(sa, "polarized", False) and hasattr(integrator,
                                                       "sample_stokes") \
                and type(integrator).__name__ != "StokesIntegrator" \
                and not _scene_depolarizing(sa):
            # polarized variants: path-style integrators trace Mueller
            # throughput; the film image is the S0 component. Under
            # tpu_spectral_polarized the Stokes components carry hero-
            # wavelength samples, converted to sRGB below like the scalar
            # spectral path
            if spectral:
                from ..core.cie import LAMBDA_MIN, LAMBDA_RANGE
                if is_doppler:
                    wls, state = sampler.next_1d_correlate(
                        state, active, correlate_pixel)
                else:
                    wls, state = sampler.next_1d(state, active)

                def hero_p(k):
                    u = wls + k * (1.0 / 3.0)
                    u = u - jnp.floor(u)
                    return LAMBDA_MIN + u * LAMBDA_RANGE
                wavelengths = Vec3(hero_p(0), hero_p(1), hero_p(2))
                S, valid, state = integrator.sample_stokes(
                    sa, sampler, state, ray, active,
                    wavelengths=wavelengths)
                from ..core.cie import hero_to_srgb
                out = (hero_to_srgb(S[0], wavelengths), valid, state)
                spectral = False        # conversion already applied
            else:
                S, valid, state = integrator.sample_stokes(
                    sa, sampler, state, ray, active)
                out = (S[0], valid, state)
        elif spectral:
            # hero-wavelength sampling: one uniform draw -> 3 rotated
            # wavelengths riding the Vec3 channels (the reference's
            # spectral variants draw wavelength_sample right after the
            # sensor-sample draws, integrator.cpp:497-499 — with the pixel
            # correlation gate under the doppler sampler)
            from ..core.cie import LAMBDA_MIN, LAMBDA_RANGE
            if is_doppler:
                wls, state = sampler.next_1d_correlate(state, active,
                                                       correlate_pixel)
            else:
                wls, state = sampler.next_1d(state, active)

            def hero(k):
                u = wls + k * (1.0 / 3.0)
                u = u - jnp.floor(u)
                return LAMBDA_MIN + u * LAMBDA_RANGE
            wavelengths = Vec3(hero(0), hero(1), hero(2))
            out = integrator.sample(sa, sampler, state, ray, active,
                                    wavelengths=wavelengths)
        else:
            out = integrator.sample(sa, sampler, state, ray, active)
        spec, valid, state = out[0], out[1], out[2]
        aovs = out[3] if len(out) > 3 else []
        spec = spec * ray_weight

        srf_values = None
        if spectral and getattr(film, "srfs", None):
            # specfilm: bin the spectral samples into one channel per
            # sensor response function (specfilm.cpp develop semantics):
            # ch_k = (range/3) * sum_i v_i * SRF_k(lambda_i)
            from ..core import cie as _cie
            K = _cie.LAMBDA_RANGE / 3.0
            srf_values = []
            for lam_tab, val_tab in film.srf_tables():
                lt = jnp.asarray(lam_tab, jnp.float32)
                vt = jnp.asarray(val_tab, jnp.float32)
                ch = 0.0
                for lam, v in ((wavelengths.x, spec.x),
                               (wavelengths.y, spec.y),
                               (wavelengths.z, spec.z)):
                    ch = ch + v * jnp.interp(lam, lt, vt, left=0.0,
                                             right=0.0)
                srf_values.append(K * ch)
        elif spectral:
            from ..core.cie import hero_to_srgb
            spec = hero_to_srgb(spec, wavelengths)

        one = jnp.ones((n,), jnp.float32)
        if srf_values is not None:
            values = srf_values + [one] + list(aovs)
        elif has_alpha:
            values = [spec.x, spec.y, spec.z,
                      jnp.where(valid, 1.0, 0.0), one] + list(aovs)
        else:
            values = [spec.x, spec.y, spec.z, one] + list(aovs)

        # box filter: accumulate into the sample's own pixel
        # (imageblock.cpp:471 comment)
        put_x = px if rfilter.is_box else sx
        put_y = py if rfilter.is_box else sy
        return values, put_x, put_y, active, state

    return sample_wavefront


def _build_pass_fn(integrator, sensor, sampler, film, W, H, spp_per_pass,
                   strip_rows: int = None, pad_rows: int = 0):
    """Build + jit the single-pass wavefront program. With ``strip_rows``
    the pass covers pixel rows [row0, row0 + strip_rows) at full spp,
    where row0 derives from the sampler state's lane window (strip-pass
    rendering; see SamplingIntegrator.render)."""
    sample_fn = _build_sample_fn(integrator, sensor, sampler, film, W, H,
                                 spp_per_pass)
    rfilter = film.rfilter
    strip = strip_rows is not None
    n = (strip_rows * W if strip else W * H) * spp_per_pass

    def pass_fn_raw(sa: SceneArrays, block, state):
        lane = state.lane
        if strip:
            # ragged last strip: lanes past the real frame are inactive
            active = lane < jnp.uint32(W * H * spp_per_pass)
            row0 = (lane[0] // jnp.uint32(W * spp_per_pass)).astype(
                jnp.int32)
        else:
            active = jnp.ones((n,), bool)
            row0 = 0
        values, put_x, put_y, active, state = sample_fn(
            sa, state, lane, active)
        with jax.named_scope("ImageBlockPut"):
            block = block_splat_wavefront(block, rfilter, put_x, put_y,
                                          values, active, W, H,
                                          spp_per_pass, pad_rows=pad_rows,
                                          row0=row0, strip_rows=strip_rows)
        return block, state

    pass_fn = jax.jit(pass_fn_raw, donate_argnums=(1, 2))
    pass_fn.raw = pass_fn_raw
    return pass_fn


class MonteCarloIntegrator(SamplingIntegrator):
    """reference integrator.cpp:568-588."""

    def __init__(self, props: Properties):
        super().__init__(props)
        md = props.get_int("max_depth", -1)
        if md < 0 and md != -1:
            raise RuntimeError("max_depth must be -1 or >= 0")
        self.max_depth = 2 ** 31 if md == -1 else md
        self.rr_depth = props.get_int("rr_depth", 5)
        if self.rr_depth <= 0:
            raise RuntimeError("rr_depth must be > 0")
        # pure-BSDF-sampling mode (no NEE/MIS); the default True matches
        # the reference's path integrator, False its prb_basic
        self.use_nee = props.get_bool("use_nee", True)

    @property
    def loop_iterations(self) -> int:
        # static unroll bound for the wavefront loop
        return min(self.max_depth, 64)


# ---------------------------------------------------------------------------
# The shared MIS path-tracing loop (path.cpp == dopplertofpath.cpp modulo the
# modulation weight and correlate-gated draws)
# ---------------------------------------------------------------------------

def _apply_normal_maps(sa, si):
    """Perturb shading frames by tangent-space normal textures (reference
    src/bsdfs/normalmap.cpp) or height-map gradients (bumpmap.cpp:
    dp_du' = dp_du + n * dh/du, normal from the perturbed tangents) at
    interaction time."""
    from ..bsdfs import P_NMAP_TEX, P_BMAP_SCALE
    from ..textures import eval_texture
    from ..core.vec import normalize as _norm
    lane_bsdf = gather_small(sa.inst_bsdf, jnp.maximum(si.inst, 0))
    nm_tex = gather_small(sa.bsdf_params[P_NMAP_TEX],
                          lane_bsdf).astype(jnp.int32)
    bscale = gather_small(sa.bsdf_params[P_BMAP_SCALE], lane_bsdf)
    has = (nm_tex >= 0) & si.valid
    c = eval_texture(sa, nm_tex, si.uv_u, si.uv_v, p=si.p, b_u=si.b_u, b_v=si.b_v, prim=si.prim)
    is_bump = bscale > 0.0
    # bumpmap: central-difference height gradients in uv
    eps = 1e-3
    def lum(v):
        return (v.x + v.y + v.z) * (1.0 / 3.0)
    hu1 = lum(eval_texture(sa, nm_tex, si.uv_u + eps, si.uv_v))
    hu0 = lum(eval_texture(sa, nm_tex, si.uv_u - eps, si.uv_v))
    hv1 = lum(eval_texture(sa, nm_tex, si.uv_u, si.uv_v + eps))
    hv0 = lum(eval_texture(sa, nm_tex, si.uv_u, si.uv_v - eps))
    dhdu = bscale * (hu1 - hu0) * (0.5 / eps)
    dhdv = bscale * (hv1 - hv0) * (0.5 / eps)
    # normalmap: tangent-space normal from the texel
    tx = jnp.where(is_bump, -dhdu, 2.0 * c.x - 1.0)
    ty = jnp.where(is_bump, -dhdv, 2.0 * c.y - 1.0)
    tz = jnp.where(is_bump, 1.0, 2.0 * c.z - 1.0)
    new_n = _norm(si.sh_s * tx + si.sh_t * ty + si.sh_n * tz)
    from ..core.vec import coordinate_system as _cs
    ns = where3(has, new_n, si.sh_n)
    sh_s, sh_t = _cs(ns)
    wi_world = si.to_world(si.wi)
    wi = Vec3(dot(wi_world, sh_s), dot(wi_world, sh_t), dot(wi_world, ns))
    return si._replace(sh_n=ns, sh_s=sh_s, sh_t=sh_t, wi=wi)


def _path_loop(integrator, sa: SceneArrays, sampler, state, ray: Ray, active,
               modulation_weight=None, use_correlate=False, wavelengths=None):
    n = ray.o.x.shape[0]
    f32 = jnp.float32

    throughput = Vec3.ones((n,))
    result = Vec3.zeros((n,))
    path_length = jnp.zeros((n,), f32)
    eta = jnp.ones((n,), f32)
    depth = jnp.zeros((n,), jnp.uint32)
    has_env = sa.has_environment and not integrator.hide_emitters
    valid_ray = jnp.full((n,), bool(has_env))
    env_r, env_g, env_b = sa.env_radiance

    prev_p = ray.o
    prev_bsdf_pdf = jnp.ones((n,), f32)
    prev_bsdf_delta = jnp.ones((n,), bool)
    active = jnp.asarray(active)

    bsdf_flags = jnp.asarray(np.asarray(sa.bsdf_flags_host, np.int32))
    pcd = jnp.uint32(integrator.path_correlation_depth)

    def weight_fn(t, pl):
        if modulation_weight is None:
            return 1.0
        return modulation_weight(t, pl)

    def draw_1d(state, active, correlate):
        if use_correlate:
            return sampler.next_1d_correlate(state, active, correlate)
        return sampler.next_1d(state, active)

    def draw_2d(state, active, correlate):
        if use_correlate:
            return sampler.next_2d_correlate(state, active, correlate)
        return sampler.next_2d(state, active)

    any_emission = (sa.n_emitters > 0) or has_env
    # use_nee=False (reference prb_basic.py behavior): pure BSDF sampling —
    # no emitter-direction draws, no shadow rays, and emitter hits are NOT
    # MIS-weighted (there is no competing strategy)
    nee_on = (sa.n_emitters > 0) and getattr(integrator, "use_nee", True)

    def bounce(_, carry):
        (state, ray, throughput, result, path_length, eta, depth, valid_ray,
         prev_p, prev_bsdf_pdf, prev_bsdf_delta, active) = carry
        correlate = (depth + 1) < pcd

        # profiler phases (reference ScopedPhase, profiler.h:20-49):
        # named scopes annotate the HLO for Perfetto traces (mi.trace_to)
        with jax.named_scope("RayIntersect"):
            si = ray_intersect(sa, ray, active)

        if sa.any_nmap:
            si = _apply_normal_maps(sa, si)

        path_length = path_length + jnp.where(si.valid, si.t * eta, 0.0)

        # ---------------- direct emission (path.cpp:150-168) -------------
        lane_emitter = jnp.where(
            si.valid, gather_small(sa.inst_emitter,
                                   jnp.maximum(si.inst, 0)), -1)
        if any_emission:
            if sa.n_emitters > 0:
                em_val = em_mod.eval_emitter_hit(sa, si.sh_n, -ray.d,
                                                 lane_emitter,
                                                 wavelengths=wavelengths,
                                                 uv_u=si.uv_u,
                                                 uv_v=si.uv_v)
            else:
                em_val = Vec3.zeros((n,))
            if has_env:
                miss_env = (~si.valid) & active
                if sa.env_kind == "envmap":
                    env_val = em_mod.envmap_eval(sa, ray.d,
                                                 wavelengths=wavelengths)
                else:
                    env_val = Vec3.full((n,), env_r, env_g, env_b)
                em_val = where3(miss_env, env_val, em_val)
                emit_mask = active & ((lane_emitter >= 0) | miss_env)
            else:
                emit_mask = active & (lane_emitter >= 0)

            # MIS pdf of NEE-sampling this hit from the previous vertex
            d_seg = si.p - prev_p
            dist = jnp.sqrt(jnp.maximum(dot(d_seg, d_seg), 1e-20))
            ds_hit = DirectionSample(
                p=si.p, n=si.sh_n, d=d_seg * (1.0 / dist), dist=dist,
                pdf=jnp.zeros((n,), f32), delta=jnp.zeros((n,), bool),
                emitter=lane_emitter)
            if nee_on:
                em_pdf = jnp.where(prev_bsdf_delta, 0.0,
                                   em_mod.pdf_direction(sa, ds_hit,
                                                        prim=si.prim,
                                                        time=ray.time))
            else:
                em_pdf = jnp.zeros((n,), f32)
            if has_env and nee_on:
                # MIS pdf for rays escaping to the environment (NEE can
                # sample the env, so env hits must be MIS-weighted too)
                if sa.env_kind == "envmap":
                    env_pdf = em_mod.envmap_pdf_direction(sa, ray.d)
                else:
                    env_pdf = jnp.full((n,), 1.0 / (4.0 * np.pi), f32)
                env_pdf = env_pdf * (1.0 / max(sa.n_emitters, 1))
                em_pdf = jnp.where(miss_env & ~prev_bsdf_delta, env_pdf,
                                   em_pdf)
            mis_bsdf = mis_weight(prev_bsdf_pdf, em_pdf)
            lw = weight_fn(ray.time, path_length)
            scale = jnp.where(emit_mask, mis_bsdf * lw, 0.0)
            result = result + throughput * em_val * scale

        active_next = ((depth + 1) < jnp.uint32(
            min(integrator.max_depth, 2 ** 31 - 1))) & si.valid & active

        lane_bsdf = gather_small(sa.inst_bsdf, jnp.maximum(si.inst, 0))
        smooth = (gather_small(bsdf_flags, lane_bsdf) & FLAG_SMOOTH) != 0

        # ---------------- emitter sampling / NEE (path.cpp:178-201) ------
        active_em = active_next & smooth
        nee, state = draw_2d(state, active, correlate)
        if nee_on:
            with jax.named_scope("SampleEmitterDirection"):
                ds, em_weight = em_mod.sample_direction(
                    sa, si.p, ray.time, nee[0], nee[1],
                    wavelengths=wavelengths)
            active_em = active_em & (ds.pdf != 0.0)
            shadow_ray = si.spawn_ray_to(ds.p)
            with jax.named_scope("RayTest"):
                occluded = ray_test(sa, shadow_ray, active_em)
            nee_ok = active_em & ~occluded
            wo_nee = si.to_local(ds.d)
        else:
            z = jnp.zeros((n,), f32)
            ds = DirectionSample(Vec3(z, z, z), Vec3(z, z, z), Vec3(z, z, z),
                                 z, z, z > 1.0, jnp.full((n,), -1, jnp.int32))
            em_weight = Vec3(z, z, z)
            wo_nee = Vec3(z, z, z)
            nee_ok = active_em & False

        # ------------- BSDF eval & sample (path.cpp:204-210) -------------
        s1, state = draw_1d(state, active, correlate)
        s2, state = draw_2d(state, active, correlate)

        if sa.n_textures > 0:
            from ..bsdfs import P_REFL_TEX
            from ..textures import eval_texture
            lane_tex = gather_small(
                sa.bsdf_params[P_REFL_TEX], lane_bsdf).astype(jnp.int32)
            tex_mask = lane_tex >= 0
            tex_refl = eval_texture(sa, lane_tex, si.uv_u, si.uv_v,
                                    p=si.p, b_u=si.b_u, b_v=si.b_v,
                                    prim=si.prim, wavelengths=wavelengths)
        else:
            tex_mask = tex_refl = None
        with jax.named_scope("BSDFEvalPdfSample"):
            bs = bsdf_eval_pdf_sample(sa, lane_bsdf, si.wi, wo_nee,
                                      s1, s2[0], s2[1], tex_refl, tex_mask,
                                      wavelengths=wavelengths)

        # ------------- NEE contribution (path.cpp:212-226) ---------------
        if sa.n_emitters > 0:
            mis_em = jnp.where(ds.delta, 1.0, mis_weight(ds.pdf, bs.pdf_nee))
            lw = weight_fn(ray.time, path_length + ds.dist)
            scale = jnp.where(nee_ok, mis_em * lw, 0.0)
            result = result + throughput * bs.val_nee * em_weight * scale

        # ------------- next ray (path.cpp:228-258) ------------------------
        wo_world = si.to_world(bs.wo)
        new_ray = si.spawn_ray(wo_world)

        throughput = where3(active_next, throughput * bs.weight, throughput)
        eta = eta * jnp.where(active_next, bs.eta, 1.0)
        valid_ray = valid_ray | (active & si.valid & ~bs.sampled_null)

        prev_p = where3(si.valid, si.p, prev_p)
        prev_bsdf_pdf = jnp.where(active_next, bs.pdf, prev_bsdf_pdf)
        prev_bsdf_delta = jnp.where(active_next, bs.sampled_delta,
                                    prev_bsdf_delta)

        depth = depth + jnp.where(si.valid & active, 1, 0).astype(jnp.uint32)

        # ------------- russian roulette (path.cpp:260-276) ----------------
        throughput_max = vmax(throughput)
        rr_prob = jnp.minimum(throughput_max * eta * eta, 0.95)
        rr_active = depth >= jnp.uint32(integrator.rr_depth)
        rr_draw, state = draw_1d(state, active, correlate)
        rr_continue = rr_draw < rr_prob
        rr_scale = jnp.where(rr_active, 1.0 / jnp.maximum(rr_prob, 1e-8), 1.0)
        throughput = throughput * rr_scale

        active = (active_next & (~rr_active | rr_continue)
                  & (throughput_max != 0.0))

        ray = Ray(where3(active_next, new_ray.o, ray.o),
                  where3(active_next, wo_world, ray.d),
                  ray.time, new_ray.maxt)
        return (state, ray, throughput, result, path_length, eta, depth,
                valid_ray, prev_p, prev_bsdf_pdf, prev_bsdf_delta, active)

    # device loop: one compiled bounce body (the XLA analog of the
    # reference's recorded dr::Loop megakernel, dopplertofpath.cpp:121-128
    # with set_max_iterations) — compile time stays O(1) in max_depth.
    # Primal uncorrelated renders exit as soon as every lane terminated
    # (dr::Loop's implicit behavior): with RR the mean depth is far below
    # max_depth, so deep-path scenes stop paying for empty bounces. The
    # static fori_loop stays for (a) correlated/doppler transport, whose
    # antithetic pair replay requires lockstep draw positions, and (b)
    # reverse-mode AD, where while_loop has no VJP (_STATIC_BOUNCE_LOOP,
    # set by render/ad.py while tracing gradients).
    carry = (state, ray, throughput, result, path_length, eta, depth,
             valid_ray, prev_p, prev_bsdf_pdf, prev_bsdf_delta, active)
    carry = bounce_loop(bounce, carry, integrator.loop_iterations)
    (state, ray, throughput, result, path_length, eta, depth, valid_ray,
     prev_p, prev_bsdf_pdf, prev_bsdf_delta, active) = carry

    spec = where3(valid_ray, result, Vec3.zeros((n,)))
    return spec, valid_ray, state


@register_plugin("integrator", "path")
class PathIntegrator(MonteCarloIntegrator):
    """MIS path tracer (reference src/integrators/path.cpp)."""

    spectral_mode = "hero"

    def sample(self, sa, sampler, state, ray, active, wavelengths=None):
        return _path_loop(self, sa, sampler, state, ray, active,
                          modulation_weight=None, use_correlate=False,
                          wavelengths=wavelengths)

    def sample_stokes(self, sa, sampler, state, ray, active,
                      wavelengths=None):
        from .polarized import _path_loop_polarized
        return _path_loop_polarized(self, sa, sampler, state, ray, active,
                                    modulation_weight=None,
                                    use_correlate=False,
                                    wavelengths=wavelengths)


@register_plugin("integrator", "dopplertofpath")
class DopplerToFPathIntegrator(MonteCarloIntegrator):
    """Doppler ToF path tracer (reference src/integrators/dopplertofpath.cpp).

    Parameter surface and semantics match dopplertofpath.cpp:19-77:
    time (exposure), w_g/g_1/g_0/w_s/sensor_phase_offset, hetero_offset /
    hetero_frequency sugar, wave_function_type, low_frequency_component_only.
    """
    is_doppler = True

    def __init__(self, props: Properties):
        props.mark_queried("is_doppler_integrator")
        super().__init__(props)
        self.time = props.get_float("time", 0.0015)
        self.w_g = props.get_float("w_g", 30.0)
        self.g_1 = props.get_float("g_1", 0.5)
        self.g_0 = props.get_float("g_0", 0.5)
        self.w_s = props.get_float("w_s", 30.0)
        self.sensor_phase_offset = props.get_float("sensor_phase_offset", 0.0)
        if props.has_property("hetero_offset"):
            self.sensor_phase_offset = (props.get_float("hetero_offset")
                                        * 2.0 * math.pi)
        if props.has_property("hetero_frequency"):
            self.hetero_frequency = props.get_float("hetero_frequency")
            self.w_s = self.w_g + self.hetero_frequency / self.time * 1e-6
        else:
            self.hetero_frequency = (self.w_s - self.w_g) * 1e6 * self.time
        wft = props.get_string("wave_function_type", "sinusoidal")
        if wft not in WAVEFORM_TYPES:
            raise RuntimeError(f"Unknown wave_function_type '{wft}'")
        self.wave_function_type = WAVEFORM_TYPES[wft]
        self.low_frequency_component_only = props.get_bool(
            "low_frequency_component_only", True)

    def eval_modulation_weight(self, ray_time, path_length):
        """reference dopplertofpath.cpp:60-77."""
        w_g = 2.0 * math.pi * self.w_g * 1e6
        w_d = 2.0 * math.pi / self.time * self.hetero_frequency
        phi = (2.0 * math.pi * self.w_g) / 300.0 * path_length
        if self.low_frequency_component_only:
            t = w_d * ray_time + self.sensor_phase_offset + phi
            return 0.5 * self.g_1 * eval_modulation_low_pass(
                t, self.wave_function_type)
        t1 = w_g * ray_time - phi
        t2 = (w_g + w_d) * ray_time + self.sensor_phase_offset
        g_t = self.g_1 * eval_modulation(t1, self.wave_function_type) + self.g_0
        s_t = eval_modulation(t2, self.wave_function_type)
        return s_t * g_t

    spectral_mode = "hero"

    def sample(self, sa, sampler, state, ray, active, wavelengths=None):
        # ray-time wrap into [0, T) (dopplertofpath.cpp:93)
        wrapped = jnp.where(ray.time < self.time, ray.time,
                            ray.time - self.time)
        ray = ray._replace(time=wrapped)
        return _path_loop(self, sa, sampler, state, ray, active,
                          modulation_weight=self.eval_modulation_weight,
                          use_correlate=True,
                          wavelengths=wavelengths)

    def sample_stokes(self, sa, sampler, state, ray, active,
                      wavelengths=None):
        from .polarized import _path_loop_polarized
        wrapped = jnp.where(ray.time < self.time, ray.time,
                            ray.time - self.time)
        ray = ray._replace(time=wrapped)
        return _path_loop_polarized(self, sa, sampler, state, ray, active,
                                    modulation_weight=self.eval_modulation_weight,
                                    use_correlate=True,
                                    wavelengths=wavelengths)


@register_plugin("integrator", "velocity")
class VelocityIntegrator(MonteCarloIntegrator):
    """Ground-truth radial velocity (reference velocity.cpp:125-137)."""

    spectral_mode = "neutral"

    def __init__(self, props: Properties):
        super().__init__(props)
        self.time = props.get_float("time", 0.0015)

    def sample(self, sa, sampler, state, ray, active):
        si1 = ray_intersect(sa, ray._replace(
            time=jnp.zeros_like(ray.time)), active)
        si2 = ray_intersect(sa, ray._replace(
            time=jnp.full(ray.time.shape, self.time, ray.time.dtype)), active)
        velocity = (jnp.where(si2.valid, si2.t, 0.0)
                    - jnp.where(si1.valid, si1.t, 0.0)) / self.time
        valid = si1.valid & si2.valid
        v = jnp.where(valid, velocity, 0.0)
        return Vec3(v, v, v), valid, state


@register_plugin("integrator", "depth")
class DepthIntegrator(SamplingIntegrator):
    """reference src/integrators/depth.cpp — first-hit distance."""

    spectral_mode = "neutral"

    def sample(self, sa, sampler, state, ray, active):
        si = ray_intersect(sa, ray, active)
        v = jnp.where(si.valid, si.t, 0.0)
        return Vec3(v, v, v), si.valid, state


from . import extras  # noqa: E402,F401  (registers direct/aov/moment)
from . import polarized as _polarized  # noqa: E402,F401  (registers stokes)
from . import volpath as _volpath  # noqa: E402,F401  (registers volpath/volpathmis)
from . import ptracer as _ptracer  # noqa: E402,F401  (registers ptracer)

__all__ = [
    "Integrator", "SamplingIntegrator", "MonteCarloIntegrator",
    "PathIntegrator", "DopplerToFPathIntegrator", "VelocityIntegrator",
    "DepthIntegrator", "mis_weight",
]
