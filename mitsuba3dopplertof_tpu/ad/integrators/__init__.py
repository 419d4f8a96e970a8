"""AD integrators (reference src/python/python/ad/integrators/*.py).

The reference builds Path Replay Backpropagation on Dr.Jit's tape: the
forward pass records nothing, and the backward pass *replays* each path
with the same RNG to reconstruct per-bounce state in O(1) memory
(prb.py, prb_basic.py). The analog here: the whole render pass is a
pure jitted function of the scene tables, so reverse-mode AD through the
lax.fori_loop bounce loop gives the SAME detached-sampling gradient
estimator; `jax.checkpoint` (rematerialization) over the pass body is the
XLA-native counterpart of path replay — activations inside a bounce are
recomputed from the loop carry instead of stored, trading FLOPs for HBM
exactly like PRB does.

Gradients cover the continuous shading parameters (reflectance, emission,
textures: render.ad.DIFF_FIELDS) plus — through the reparameterized family
below — geometry (render.ad.GEOM_DIFF_FIELDS) including the
silhouette/visibility boundary terms via warped-area reparameterization
(ad/reparam.py, validated against finite differences in
tests/test_reparam.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ...core.properties import Properties, register_plugin
from ...render.ad import (render_grad, value_and_render_grad, DIFF_FIELDS,
                          _render_image_fn, DEFAULT_GRAD_LANES)


from ...integrators import Integrator as _Integrator


class ADIntegrator(_Integrator):
    """Common AD-integrator surface (reference common.py ADIntegrator):
    render / render_forward / render_backward over a nested sampling
    integrator."""

    nested_type = "path"
    nested_extra: dict = {}
    boundary_terms = False

    def __init__(self, props: Properties):
        super().__init__(props)
        from ... import load_dict
        cfg = {"type": self.nested_type, **self.nested_extra}
        for k in ("max_depth", "rr_depth"):
            if props.has_property(k):
                cfg[k] = props.get_int(k)
        if props.has_property("use_nee"):
            cfg["use_nee"] = props.get_bool("use_nee")
        self.nested = load_dict(cfg)
        for k in list(props.keys()):
            props.mark_queried(k)

    # -- plain rendering (primal) -----------------------------------------
    def render(self, scene, sensor=None, seed: int = 0, spp: int = 0,
               **kw):
        return self.nested.render(scene, sensor=sensor, seed=seed, spp=spp,
                                  **kw)

    def aov_names(self):
        return []

    # -- reverse mode ------------------------------------------------------
    def render_backward(self, scene, params=None, grad_in=None, sensor=None,
                        seed: int = 0, spp: int = 4,
                        max_lanes: int = DEFAULT_GRAD_LANES, remat=True):
        """d<grad_in, image>/d(scene tables) — the PRB backward pass
        (reference common.py render_backward). ``grad_in``: adjoint image.
        Returns {field: grad}; if ``params`` is a SceneParameters, the
        grads are also attached as ``params.grad``."""
        f, sa = _render_image_fn(self.nested, scene, sensor, spp, seed,
                                 max_lanes)
        if remat:
            # rematerialize the pass body: the XLA-native path replay
            f = jax.checkpoint(f)
        g_img = jnp.asarray(grad_in)

        def objective(p):
            return jnp.sum(f(p) * g_img)

        diff = {k: getattr(sa, k) for k in DIFF_FIELDS}
        grads = jax.grad(objective)(diff)
        if params is not None:
            params.grad = grads
        return grads

    def render_forward(self, scene, params=None, sensor=None, seed: int = 0,
                       spp: int = 4, tangents=None,
                       max_lanes: int = DEFAULT_GRAD_LANES):
        """JVP of the image w.r.t. the scene tables (reference
        render_forward). ``tangents``: {field: tangent array}; defaults to
        ones (the reference's convention of seeding dr.forward with 1)."""
        f, sa = _render_image_fn(self.nested, scene, sensor, spp, seed,
                                 max_lanes)
        diff = {k: getattr(sa, k) for k in DIFF_FIELDS}
        if tangents is None:
            tangents = {k: jnp.ones_like(v) for k, v in diff.items()}
        else:
            base = {k: jnp.zeros_like(v) for k, v in diff.items()}
            base.update({k: jnp.asarray(v) for k, v in tangents.items()})
            tangents = base
        img, dimg = jax.jvp(f, (diff,), (tangents,))
        return dimg


@register_plugin("integrator", "prb_basic")
class BasicPRBIntegrator(ADIntegrator):
    """Basic PRB: BSDF sampling only, no NEE (reference prb_basic.py).
    Wraps `path` with use_nee=False so the VARIANCE behavior is
    cross-checkable against the reference's prb_basic, not just the
    gradient (which is estimator-agnostic); pass use_nee=true to get the
    round-2 NEE+MIS wrapping back."""
    nested_type = "path"
    nested_extra = {"use_nee": False}


@register_plugin("integrator", "prb")
class PRBIntegrator(ADIntegrator):
    """PRB with NEE + MIS (reference prb.py)."""
    nested_type = "path"


@register_plugin("integrator", "prbvolpath")
class PRBVolpathIntegrator(ADIntegrator):
    """PRB through participating media (reference prbvolpath.py)."""
    nested_type = "volpath"


def _reparam_path_sample(integ, sa, sampler, state, ray, active,
                         max_depth: int):
    """Reparameterized path estimator (reference direct_reparam.py:109-215,
    prb_reparam.py): detached sampling decisions, attached re-evaluation,
    warped-area ray reparameterization (ad/reparam.py) on every ray whose
    depth < reparam_max_depth, with the Jacobian determinants multiplying
    the contributions. PRIMAL-IDENTICAL to the plain estimator (the
    reparameterization is the identity in primal mode), so one code path
    serves rendering, jax.grad and jax.jvp."""
    import jax.numpy as jnp
    from ...core.vec import Vec3, dot, normalize, where3, vmax
    from ...render.types import Ray, DirectionSample, RAY_EPSILON
    from ...render.scene import (_hit_reference, build_si, ray_test,
                                 gather_small)
    from ...bsdfs import (eval_pdf_sample as bsdf_eval_pdf_sample,
                          FLAG_SMOOTH)
    from ...integrators import mis_weight
    from ... import emitters as em_mod
    from ..reparam import reparameterize_ray, _followshape_position, _sg3
    import numpy as np

    sg = jax.lax.stop_gradient
    n = ray.o.x.shape[0]
    f32 = jnp.float32
    rmax = integ.reparam_max_depth
    rp_kw = dict(num_rays=integ.reparam_rays, kappa=integ.reparam_kappa,
                 exponent=integ.reparam_exp,
                 antithetic=integ.reparam_antithetic)
    bsdf_flags = jnp.asarray(np.asarray(sa.bsdf_flags_host, np.int32))

    has_env = sa.has_environment and not integ.hide_emitters
    env_r, env_g, env_b = sa.env_radiance

    # ---- depth-0 (camera ray) reparameterization ------------------------
    if rmax > 0:
        d0, det_cam, state = reparameterize_ray(sa, sampler, state, ray,
                                                active, **rp_kw)
    else:
        d0, det_cam = _sg3(ray.d), jnp.ones((n,), f32)
    ray = ray._replace(d=d0)

    L = Vec3.zeros((n,))
    throughput = Vec3.ones((n,))
    valid_ray = jnp.full((n,), bool(has_env))
    act = jnp.asarray(active)
    prev_bsdf_pdf = jnp.ones((n,), f32)
    prev_delta = jnp.ones((n,), bool)

    for depth in range(max(max_depth, 1)):
        hit = _hit_reference(sa, ray)
        si = build_si(sa, ray, hit, act)

        # ---- emission at the hit (attached through the warped ray) ------
        lane_emitter = jnp.where(
            si.valid, gather_small(sa.inst_emitter,
                                   jnp.maximum(si.inst, 0)), -1)
        if sa.n_emitters > 0 or has_env:
            if sa.n_emitters > 0:
                em_val = em_mod.eval_emitter_hit(sa, si.sh_n, -ray.d,
                                                 lane_emitter,
                                                 uv_u=si.uv_u,
                                                 uv_v=si.uv_v)
            else:
                em_val = Vec3.zeros((n,))
            if has_env:
                miss_env = (~si.valid) & act
                if sa.env_kind == "envmap":
                    env_val = em_mod.envmap_eval(sa, ray.d)
                else:
                    env_val = Vec3.full((n,), env_r, env_g, env_b)
                em_val = where3(miss_env, env_val, em_val)
                emit_mask = act & ((lane_emitter >= 0) | miss_env)
            else:
                emit_mask = act & (lane_emitter >= 0)
            d_seg = si.p - ray.o
            dist = jnp.sqrt(jnp.maximum(dot(d_seg, d_seg), 1e-20))
            ds_hit = DirectionSample(
                p=si.p, n=si.sh_n, d=d_seg * (1.0 / dist), dist=dist,
                pdf=jnp.zeros((n,), f32), delta=jnp.zeros((n,), bool),
                emitter=lane_emitter)
            if sa.n_emitters > 0:
                em_pdf = jnp.where(prev_delta, 0.0,
                                   sg(em_mod.pdf_direction(
                                       sa, ds_hit, prim=si.prim,
                                       time=ray.time)))
            else:
                em_pdf = jnp.zeros((n,), f32)
            mis_b = sg(mis_weight(prev_bsdf_pdf, em_pdf))
            L = L + throughput * em_val * jnp.where(emit_mask, mis_b, 0.0)

        valid_ray = valid_ray | (act & si.valid)
        active_next = act & si.valid & (depth + 1 < max_depth)
        if depth + 1 >= max_depth and depth > 0:
            break

        # follow-shape origin for the secondary reparameterizations, with a
        # detached normal offset against self-intersection
        p_follow = _followshape_position(sa, hit, ray.time,
                                         ray_o=ray.o, ray_d=ray.d)
        eps = jnp.maximum(jnp.abs(si.t), 1.0) * RAY_EPSILON
        off = _sg3(si.n) * jnp.where(dot(si.n, si.wi) >= 0.0, eps, -eps)
        p_follow = p_follow + off

        lane_bsdf = gather_small(sa.inst_bsdf, jnp.maximum(si.inst, 0))
        smooth = (gather_small(bsdf_flags, lane_bsdf) & FLAG_SMOOTH) != 0

        # ---- NEE: detached draw, attached re-eval, reparam shadow ray ----
        nee, state = sampler.next_2d(state, act)
        if sa.n_emitters > 0:
            ds, em_weight = em_mod.sample_direction(
                sa, _sg3(si.p), ray.time, nee[0], nee[1])
            active_em = active_next & smooth & (ds.pdf != 0.0)
            shadow_ray = si.spawn_ray_to(_sg3(ds.p))
            occluded = ray_test(sa, jax.tree_util.tree_map(sg, shadow_ray),
                                active_em)
            vis = active_em & ~occluded
            d_em = normalize(_sg3(ds.p) - p_follow)
            if depth + 1 < rmax:
                sh_rp = Ray(p_follow, _sg3(d_em), ray.time,
                            jnp.full((n,), np.inf, f32))
                d_em, det_em, state = reparameterize_ray(
                    sa, sampler, state, sh_rp, active_em, **rp_kw)
            else:
                det_em = jnp.ones((n,), f32)
            wo_nee = si.to_local(d_em)
        else:
            z = jnp.zeros((n,), f32)
            ds = DirectionSample(Vec3(z, z, z), Vec3(z, z, z),
                                 Vec3(z, z, z), z, z, z > 1.0,
                                 jnp.full((n,), -1, jnp.int32))
            em_weight = Vec3.zeros((n,))
            wo_nee = Vec3(z, z, z)
            vis = active_next & False
            det_em = jnp.ones((n,), f32)

        # ---- BSDF eval + detached sample ---------------------------------
        s1, state = sampler.next_1d(state, act)
        s2, state = sampler.next_2d(state, act)
        if sa.n_textures > 0:
            from ...bsdfs import P_REFL_TEX
            from ...textures import eval_texture
            lane_tex = gather_small(
                sa.bsdf_params[P_REFL_TEX], lane_bsdf).astype(jnp.int32)
            tex_mask = lane_tex >= 0
            tex_refl = eval_texture(sa, lane_tex, si.uv_u, si.uv_v, p=si.p, b_u=si.b_u, b_v=si.b_v, prim=si.prim)
        else:
            tex_mask = tex_refl = None
        bs = bsdf_eval_pdf_sample(sa, lane_bsdf, si.wi, wo_nee,
                                  s1, s2[0], s2[1], tex_refl, tex_mask)

        if sa.n_emitters > 0:
            mis_em = sg(jnp.where(ds.delta, 1.0,
                                  mis_weight(ds.pdf, bs.pdf_nee)))
            scale = jnp.where(vis, mis_em, 0.0) * det_em
            L = L + throughput * bs.val_nee * em_weight * scale

        # ---- next ray: detached direction, reparam, attached trace ------
        wo_world = si.to_world(_sg3(bs.wo))
        if depth + 1 < rmax:
            b_rp = Ray(p_follow, _sg3(wo_world), ray.time,
                       jnp.full((n,), np.inf, f32))
            d_b, det_b, state = reparameterize_ray(
                sa, sampler, state, b_rp, active_next, **rp_kw)
        else:
            d_b, det_b = wo_world, jnp.ones((n,), f32)

        throughput = where3(active_next, throughput * bs.weight * det_b,
                            throughput)
        prev_bsdf_pdf = jnp.where(active_next, sg(bs.pdf), prev_bsdf_pdf)
        prev_delta = jnp.where(active_next, bs.sampled_delta, prev_delta)
        act = active_next & (vmax(sg(throughput)) != 0.0)
        ray = Ray(p_follow, d_b, ray.time,
                  jnp.full((n,), np.inf, f32))

    L = L * det_cam
    spec = where3(valid_ray, L, Vec3.zeros((n,)))
    return spec, valid_ray, state


class _ReparamBase(ADIntegrator):
    """Shared surface of the reparameterized family: a real sample() with
    the warped-area estimator (primal-identical), plus AD entry points that
    differentiate through it with the geometry tables attached."""

    reparam_default_depth = 2

    def __init__(self, props: Properties):
        # reparam knobs (reference prb_reparam.py:34-60)
        self.reparam_max_depth = props.get_int(
            "reparam_max_depth", self.reparam_default_depth)
        self.reparam_rays = props.get_int("reparam_rays", 8)
        self.reparam_kappa = props.get_float("reparam_kappa", 1e5)
        self.reparam_exp = props.get_float("reparam_exp", 3.0)
        self.reparam_antithetic = props.get_bool("reparam_antithetic",
                                                 False)
        self.max_depth_cfg = props.get_int("max_depth", 2)
        super().__init__(props)
        self.hide_emitters = False
        self.is_doppler = False
        self.path_correlation_depth = 0
        self.samples_per_pass = -1
        self.spectral_mode = None

    # SamplingIntegrator-compatible surface so _render_image_fn /
    # _build_pass_fn can drive this integrator directly
    def sample(self, sa, sampler, state, ray, active):
        return _reparam_path_sample(self, sa, sampler, state, ray, active,
                                    max_depth=max(self.max_depth_cfg, 2))

    def _get_pass_fn(self, sensor, sampler, film, W, H, spp_per_pass):
        from ...integrators import SamplingIntegrator
        return SamplingIntegrator._get_pass_fn(
            self, sensor, sampler, film, W, H, spp_per_pass)

    def render_backward(self, scene, params=None, grad_in=None, sensor=None,
                        seed: int = 0, spp: int = 4,
                        max_lanes: int = DEFAULT_GRAD_LANES, remat=True):
        from ...render.ad import GEOM_DIFF_FIELDS
        f, sa = _render_image_fn(self, scene, sensor, spp, seed, max_lanes)
        if remat:
            f = jax.checkpoint(f)
        g_img = jnp.asarray(grad_in)

        def objective(p):
            return jnp.sum(f(p) * g_img)

        diff = {k: getattr(sa, k) for k in DIFF_FIELDS + GEOM_DIFF_FIELDS}
        grads = jax.grad(objective)(diff)
        if params is not None:
            params.grad = grads
        return grads

    def render_forward(self, scene, params=None, sensor=None, seed: int = 0,
                       spp: int = 4, tangents=None,
                       max_lanes: int = DEFAULT_GRAD_LANES):
        from ...render.ad import GEOM_DIFF_FIELDS
        f, sa = _render_image_fn(self, scene, sensor, spp, seed, max_lanes)
        diff = {k: getattr(sa, k) for k in DIFF_FIELDS + GEOM_DIFF_FIELDS}
        base = {k: jnp.zeros_like(v) for k, v in diff.items()}
        if tangents is not None:
            base.update({k: jnp.asarray(v) for k, v in tangents.items()})
        else:
            base = {k: jnp.ones_like(v) for k, v in diff.items()}
        img, dimg = jax.jvp(f, (diff,), (base,))
        return dimg


@register_plugin("integrator", "prb_reparam")
class PRBReparamIntegrator(_ReparamBase):
    """Reparameterized PRB (reference prb_reparam.py): multi-bounce path
    estimator with warped-area reparameterization up to reparam_max_depth;
    detached sampling + attached re-evaluation throughout."""
    reparam_default_depth = 2

    def __init__(self, props: Properties):
        props_md = props.get_int("max_depth", 6) if props.has_property(
            "max_depth") else 6
        super().__init__(props)
        self.max_depth_cfg = props_md


@register_plugin("integrator", "direct_reparam")
class DirectReparamIntegrator(_ReparamBase):
    """Reparameterized direct illumination (reference direct_reparam.py):
    two path segments, camera + one NEE/BSDF bounce."""
    reparam_default_depth = 2

    def __init__(self, props: Properties):
        super().__init__(props)
        self.max_depth_cfg = 2


@register_plugin("integrator", "emission_reparam")
class EmissionReparamIntegrator(_ReparamBase):
    """Reparameterized emission-only rendering (reference
    emission_reparam.py): camera-ray reparam, direct emission term only."""
    reparam_default_depth = 1

    def __init__(self, props: Properties):
        super().__init__(props)
        self.max_depth_cfg = 1
        self.reparam_max_depth = min(self.reparam_max_depth, 1)


__all__ = ["ADIntegrator", "PRBIntegrator", "BasicPRBIntegrator",
           "PRBVolpathIntegrator", "PRBReparamIntegrator",
           "DirectReparamIntegrator", "EmissionReparamIntegrator",
           "render_grad", "value_and_render_grad"]
