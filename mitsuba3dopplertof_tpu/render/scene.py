"""Scene assembly and compilation into device SoA arrays.

The reference assembles an object graph then uploads acceleration structures
(reference src/render/scene.cpp:22-101, scene_optix.inl / scene_embree.inl).
Here the host compiles the shape graph into flat *component-wise* triangle
/ instance / BSDF / emitter tables (each column a packed (T,) array, see
core/vec.py), and ray queries are programs over those tables inside the
integrator's bounce loop.

Ray queries (``ray_query_route``): on the GPU, small scenes take one fused
Pallas kernel (ops/intersect_kernel.py). Everything else takes the XLA
path: a lax.scan with one triangle per step over (N,)-shaped lanes, and the
stackless BVH / per-instance BLAS of ops/bvh.py above BVH_THRESHOLD
(SURVEY.md §7 "hard parts" #1).

Motion blur: every shape is an instance with two keyframe matrices; rays are
transformed by the *exact* inverse of the lerped matrix at their own time
(the semantics of Embree 2-step instance motion / OptixMatrixMotionTransform
+ reference src/shapes/instance.cpp:155-250, transform.h:458-466).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.vec import (Vec3, dot, cross, normalize, coordinate_system,
                        cmat_lerp, cmat_inverse, cmat_apply_point,
                        cmat_apply_vector, cmat_apply_transpose_vector)
from .types import Ray, SurfaceInteraction, HitRecord, SPH_SLOT_BASE

# triangle component columns (all (T,) arrays)
_TRI_COLS = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z",
             "n0x", "n0y", "n0z", "n1x", "n1y", "n1z", "n2x", "n2y", "n2z",
             "uv0u", "uv0v", "uv1u", "uv1v", "uv2u", "uv2v")
_TRI_INT_COLS = ("inst", "prim")


class SceneArrays:
    """Pytree of device arrays + static metadata (aux)."""

    ARRAY_FIELDS = (
        ["s_" + c for c in _TRI_COLS] + ["s_" + c for c in _TRI_INT_COLS]
        + ["a_" + c for c in _TRI_COLS] + ["a_" + c for c in _TRI_INT_COLS]
        + ["inst_m0c", "inst_m1c", "inst_t0", "inst_t1",
           "inst_bsdf", "inst_emitter", "inst_nsign",
           "bsdf_type", "bsdf_params",      # bsdf_params: (P, B) column-major
           "emitter_type", "emitter_params", "emitter_m",  # (P, E), (12, E)
           "tex_type", "tex_params", "tex_h",
           "tex_atlas_r", "tex_atlas_g", "tex_atlas_b",
           "tex_atlas_c0", "tex_atlas_c1", "tex_atlas_c2",
           "sph_m0c", "sph_m1c", "sph_t0", "sph_t1", "sph_inst",
           "env_img_r", "env_img_g", "env_img_b", "env_pdf", "env_cdf",
           "env_alias", "env_aprob",
           "env_rot", "env_rot_fwd", "env_coeff", "em_tri_cdf",
           "med_params", "inst_int_medium", "med_grid", "med_w2g",
           "sggx_grid", "sggx_w2g",
           "bvh", "anim_blas", "mesh_attr", "measured",
           "measured_pol",
           "bsphere_radius", "bsphere_center"]
    )
    META_FIELDS = [
        "n_static_tris", "n_anim_tris", "anim_ranges", "bsdf_types_present",
        "emitter_types_present", "n_emitters", "has_environment",
        "env_radiance", "bsdf_flags_host", "tex_types_present", "n_textures",
        "n_spheres", "sphere_animated", "env_kind", "env_shape", "env_index",
        "mesh_em_meta", "sensor_medium", "n_media", "spectral",
        "polarized", "any_hetero", "any_sggx", "any_sggx_grid",
        "any_rayleigh", "any_flip", "any_nmap",
        "tab_phase_tables", "measured_pol_wls", "ior_spectra",
        "bsdf_ior_host", "max_optical_depth_hint",
    ]

    def __init__(self, **kw):
        for k in self.ARRAY_FIELDS + self.META_FIELDS:
            setattr(self, k, kw.get(k))

    def tree_flatten(self):
        children = tuple(getattr(self, k) for k in self.ARRAY_FIELDS)
        aux = tuple(getattr(self, k) for k in self.META_FIELDS)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls()
        for k, v in zip(cls.ARRAY_FIELDS, children):
            setattr(obj, k, v)
        for k, v in zip(cls.META_FIELDS, aux):
            setattr(obj, k, v)
        return obj

    # -- convenience accessors -------------------------------------------
    def tri(self, prefix: str, col: str):
        return getattr(self, prefix + "_" + col)

    def inst_cmat(self, which: int, inst):
        arr = self.inst_m0c if which == 0 else self.inst_m1c  # (12, I)
        return tuple(arr[j, inst] for j in range(12))

    @property
    def has_accel(self) -> bool:
        """True when any BVH exists (static TLAS or an animated BLAS)."""
        return self.bvh is not None or any(
            b is not None for b in (self.anim_blas or ()))


jax.tree_util.register_pytree_node(
    SceneArrays, SceneArrays.tree_flatten, SceneArrays.tree_unflatten)


class Scene:
    """Host-side object graph (reference src/render/scene.cpp:22-101)."""

    def __init__(self, shapes, emitters, sensors, integrator=None):
        self.shapes = shapes
        self.emitters = emitters
        self.sensors = sensors
        self.integrator = integrator
        self._compiled: Optional[SceneArrays] = None

    @property
    def sensor(self):
        return self.sensors[0]

    def environment(self):
        for e in self.emitters:
            if e.is_environment:
                return e
        return None

    # ------------------------------------------------------------------
    def compile(self) -> SceneArrays:
        if self._compiled is not None:
            return self._compiled

        from ..bsdfs import Diffuse, N_BSDF_PARAMS
        from ..emitters import N_EMITTER_PARAMS, E_AREA
        from ..media import M_MAXD
        from ..core.properties import Properties

        import mitsuba3dopplertof_tpu as _mi0
        spectral = _mi0.variant() in ("tpu_spectral",
                                      "tpu_spectral_polarized")
        mono = _mi0.variant() == "tpu_mono"
        polarized = _mi0.variant() in ("tpu_rgb_polarized",
                                       "tpu_spectral_polarized")

        def _lum(rgb3):
            # ITU-R BT.709 luminance, the reference's luminance() used when
            # its mono variants collapse rgb inputs (spectrum.h)
            return 0.2126 * rgb3[0] + 0.7152 * rgb3[1] + 0.0722 * rgb3[2]

        # --- BSDF table (deduplicated by identity) -----------------------
        bsdf_objs: List[Any] = []
        bsdf_index: Dict[int, int] = {}

        def add_bsdf(b):
            if id(b) not in bsdf_index:
                bsdf_index[id(b)] = len(bsdf_objs)
                bsdf_objs.append(b)
            return bsdf_index[id(b)]

        for sh in self.shapes:
            b = sh.bsdf
            if b is None:
                b = Diffuse(Properties("diffuse"))
                sh.bsdf = b
            add_bsdf(b)

        # expand wrappers: nested rows must exist in the table; mask also
        # needs a shared plain-null row
        from ..bsdfs import Mask as _Mask, BlendBSDF as _Blend, Null as _Null
        null_row = None
        for b in list(bsdf_objs):
            if isinstance(b, _Mask):
                b.nested_index = add_bsdf(b.nested_bsdf)
                if null_row is None:
                    null_row = add_bsdf(_Null(Properties("null")))
                b.null_index = null_row
            elif isinstance(b, _Blend):
                b.nested_indices = (add_bsdf(b.nested[0]),
                                    add_bsdf(b.nested[1]))
        # --- texture table + bitmap atlas --------------------------------
        from ..textures import N_TEX_PARAMS, T_ATLAS, TEX_BITMAP
        tex_objs = []
        tex_index = {}
        def add_tex(t):
            if id(t) not in tex_index:
                tex_index[id(t)] = len(tex_objs)
                tex_objs.append(t)
            return tex_index[id(t)]

        for b in bsdf_objs:
            t = getattr(b, "reflectance_tex", None)
            if t is None and hasattr(b, "nested"):
                t = getattr(b.nested, "reflectance_tex", None)
            if t is not None:
                b.tex_index = add_tex(t)
                if hasattr(b, "nested"):
                    b.nested.tex_index = b.tex_index
            nm = getattr(b, "normalmap_tex", None)
            if nm is not None:
                b.nmap_index = add_tex(nm)
        for em in self.emitters:
            t = getattr(em, "irradiance_tex", None)
            if t is not None:
                em.tex_index = add_tex(t)
        from ..textures import TEX_VOLUME, TEX_MESHATTR
        tex_rows, tex_types, tex_h = [], [], []
        atlas = []
        atlas_off = 0
        for t in tex_objs:
            row = t.params_row()
            if t.type_id == TEX_BITMAP:
                img = t.image
                row[T_ATLAS] = float(atlas_off)
                row[T_ATLAS + 1] = float(img.shape[1])
                tex_h.append(img.shape[0])
                atlas.append(img.reshape(-1, 3))
                atlas_off += img.shape[0] * img.shape[1]
            elif t.type_id == TEX_VOLUME:
                # volume texture grids ride the same flat rgb atlas
                g = t.grid_rgb()
                row[T_ATLAS] = float(atlas_off)
                tex_h.append(0)
                atlas.append(g.reshape(-1, 3))
                atlas_off += g.shape[0] * g.shape[1] * g.shape[2]
            else:
                tex_h.append(0)
            tex_rows.append(row)
            tex_types.append(t.type_id)
        # names requested by mesh_attribute textures (packed per triangle
        # during the shape sweep below)
        mesh_attr_names = [t.name for t in tex_objs
                           if t.type_id == TEX_MESHATTR]
        s_attr_rows, a_attr_rows = [], []
        tex_params = (np.stack(tex_rows).T if tex_rows
                      else np.zeros((N_TEX_PARAMS, 1)))
        tex_type_arr = (np.array(tex_types, np.int32) if tex_types
                        else np.zeros(1, np.int32))
        tex_h_arr = (np.array(tex_h, np.int32) if tex_h
                     else np.zeros(1, np.int32))
        atlas_np = (np.concatenate(atlas, axis=0) if atlas
                    else np.zeros((1, 3), np.float32))
        if mono and atlas:
            la = (0.2126 * atlas_np[:, 0] + 0.7152 * atlas_np[:, 1]
                  + 0.0722 * atlas_np[:, 2])
            atlas_np = np.stack([la, la, la], axis=1)
        # per-texel spectral upsampling: a parallel atlas of sigmoid-
        # polynomial coefficients (reference ext/rgb2spec tables +
        # src/core/srgb.cpp) so textured reflectance is a real spectrum
        # under tpu_spectral instead of an rgb tint; interpolated from the
        # disk-cached coefficient lattice (core/cie.py), so scene compile
        # adds only a trilinear lookup per texel
        if spectral and atlas:
            from ..core.cie import upsample_rgb_array
            atlas_coeff = upsample_rgb_array(atlas_np)
        else:
            atlas_coeff = np.zeros((1, 3), np.float32)


        if not bsdf_objs:
            bsdf_objs.append(Diffuse(Properties("diffuse")))
        bsdf_type = np.array([b.type_id for b in bsdf_objs], np.int32)
        bsdf_flags = np.array([b.flags for b in bsdf_objs], np.int32)
        from ..bsdfs import Measured as _Measured
        from ..bsdfs import MeasuredPolarized as _MeasuredPol
        measured_tables = []
        measured_pol_tables = []
        measured_pol_wls = []
        for b in bsdf_objs:
            if isinstance(b, _MeasuredPol):
                b.measured_index = len(measured_pol_tables)
                measured_pol_tables.append(b.tables)
                measured_pol_wls.append(tuple(b.pol_wavelengths()))
            elif isinstance(b, _Measured):
                b.measured_index = len(measured_tables)
                measured_tables.append(b.tables)
        bsdf_params = np.stack([b.params_row() for b in bsdf_objs]).T
        # rows without a normal/bump map must carry -1 in the texture slot
        # (0 would alias texture row 0 in _apply_normal_maps)
        from ..bsdfs import P_NMAP_TEX as _P_NMAP
        for bi, b in enumerate(bsdf_objs):
            if getattr(b, "nmap_index", -1) < 0:
                bsdf_params[_P_NMAP, bi] = -1.0

        if mono:
            from ..bsdfs import P_REFL
            for bi in range(len(bsdf_objs)):
                rgb = bsdf_params[P_REFL:P_REFL + 3, bi]
                if rgb.max() > 0:
                    bsdf_params[P_REFL:P_REFL + 3, bi] = _lum(rgb)
        # spectral conductor eta/k: map bsdf rows with a named material to
        # an entry in the static ior_spectra tuple (ior.h complex_ior
        # analog; used by bsdfs.eval_pdf_sample under tpu_spectral)
        ior_spectra = []
        ior_by_name = {}
        bsdf_ior_host = []
        from ..bsdfs.ior_data import CONDUCTOR_SPECTRA as _CSPEC
        for b in bsdf_objs:
            mat = getattr(b, "material", None)
            if spectral and mat in _CSPEC:
                if mat not in ior_by_name:
                    ior_by_name[mat] = len(ior_spectra)
                    ior_spectra.append(_CSPEC[mat])
                bsdf_ior_host.append(ior_by_name[mat])
            else:
                bsdf_ior_host.append(-1)

        if spectral:
            # replace reflectance rgb with sigmoid-upsampling coefficients
            # (JH'19 method, core/cie.py) — P_REFL columns hold (c0, c1, c2)
            # for diffuse albedo / plastic diffuse / principled base color;
            # remaining types (conductors get real eta/k spectra; dielectric
            # tints are ~1) read P_REFL as an rgb tint. Texture lookups stay
            # rgb-as-3-wavelength (atlases are too large to fit per-texel).
            from ..core import cie as _cie
            from ..bsdfs import P_REFL, SPECTRAL_UPSAMPLED_TYPES
            for bi, b in enumerate(bsdf_objs):
                if b.type_id not in SPECTRAL_UPSAMPLED_TYPES:
                    continue
                rgb = bsdf_params[P_REFL:P_REFL + 3, bi]
                if rgb.max() > 0:
                    bsdf_params[P_REFL:P_REFL + 3, bi] = \
                        _cie.fit_reflectance_coeffs(rgb)

        # --- emitter table ------------------------------------------------
        from ..emitters import EMITTER_AREA_RECT, EMITTER_AREA_MESH
        from ..shapes import RectangleShape
        emitter_rows, emitter_types, emitter_mats = [], [], []
        mesh_emitter_shapes = {}     # emitter idx -> shape (CDF built later)
        for ei, em in enumerate(self.emitters):
            row = em.params_row()
            mat = np.eye(4)
            etype = em.type_id
            if hasattr(em, "to_world") and em.shape is None:
                mat = np.asarray(em.to_world, np.float64)
            if em.shape is not None:
                m0, _, _, _ = em.shape.to_world.matrices()
                mat = m0
                sh_animated = em.shape.to_world.animated
                if getattr(em.shape, "is_analytic_sphere", False):
                    # analytic sphere emitter: cone-sampled NEE
                    # (emitters EMITTER_AREA_SPHERE; sphere.cpp semantics).
                    # Animated spheres record their sphere-table slot at
                    # param 9 so the cone is re-centered per lane at the
                    # ray's own time (extension beyond the reference, which
                    # forbids emitters on instanced shapes, instance.cpp:48)
                    from ..emitters import EMITTER_AREA_SPHERE, E_POS, E_CUTOFF
                    etype = EMITTER_AREA_SPHERE
                    r_w = float(np.linalg.norm(m0[:3, 0]))
                    row[E_POS:E_POS + 3] = m0[:3, 3]
                    row[E_CUTOFF] = r_w
                    row[E_AREA] = 4.0 * np.pi * r_w * r_w
                    sph_slot = sum(
                        1 for s in self.shapes[:self.shapes.index(em.shape)]
                        if getattr(s, "is_analytic_sphere", False))
                    row[9] = float(sph_slot) if sh_animated else -1.0
                else:
                    row[E_AREA] = float(
                        np.sum(em.shape.mesh.surface_areas(m0)))
                if (etype == EMITTER_AREA_RECT
                        and (not isinstance(em.shape, RectangleShape)
                             or sh_animated)
                        and not getattr(em.shape, "is_analytic_sphere",
                                        False)):
                    # animated rect emitters also ride the mesh-CDF path so
                    # their sampled positions track the keyframe lerp
                    etype = EMITTER_AREA_MESH
                    mesh_emitter_shapes[ei] = em.shape
            emitter_rows.append(row)
            emitter_types.append(etype)
            emitter_mats.append(mat[:3, :4].reshape(-1))
        n_emitters = len(self.emitters)
        emitter_params = (np.stack(emitter_rows).T if emitter_rows
                          else np.zeros((N_EMITTER_PARAMS, 0)))
        if mono and n_emitters:
            from ..emitters import E_INTENSITY
            for ei in range(n_emitters):
                rgb = emitter_params[E_INTENSITY:E_INTENSITY + 3, ei]
                emitter_params[E_INTENSITY:E_INTENSITY + 3, ei] = _lum(rgb)
        if spectral and n_emitters:
            # emission spectra: scale * S(coeffs) * D65n; coeffs fit the
            # chromaticity, scale restores the luminance (srgb.cpp emission)
            from ..core import cie as _cie
            from ..emitters import E_INTENSITY
            for ei in range(n_emitters):
                rgb = emitter_params[E_INTENSITY:E_INTENSITY + 3, ei]
                peak = max(float(rgb.max()), 1e-9)
                coeffs = _cie.fit_reflectance_coeffs(rgb / peak)
                emitter_params[12:15, ei] = coeffs
                emitter_params[15, ei] = peak
        emitter_type = np.array(emitter_types, np.int32)
        emitter_m = (np.stack(emitter_mats).T if emitter_mats
                     else np.zeros((12, 0)))

        env = self.environment()
        env_radiance = (np.asarray(env.radiance, np.float32)
                        if env is not None else np.zeros(3, np.float32))
        env_kind = None
        env_index = -1
        env_img = np.zeros((1, 1, 3), np.float32)
        env_pdf = np.ones(1, np.float32)
        env_cdf = np.ones(1, np.float32)
        env_alias = np.zeros(1, np.int32)
        env_aprob = np.ones(1, np.float32)
        env_rot = np.eye(3).reshape(-1)
        env_rot_fwd = np.eye(3).reshape(-1)
        if env is not None:
            env_index = self.emitters.index(env)
            from ..emitters import EnvmapEmitter
            if isinstance(env, EnvmapEmitter):
                env_kind = "envmap"
                env_img = env.image
                env_pdf = env.texel_pdf.reshape(-1)
                env_cdf = env.texel_cdf
                env_alias = env.texel_alias
                env_aprob = env.texel_aprob
                R = env.to_world[:3, :3]
                env_rot_fwd = R.reshape(-1)
                env_rot = np.linalg.inv(R).reshape(-1)
            else:
                env_kind = "constant"
        env_coeff = np.zeros((4, 1), np.float32)
        if spectral and env_kind == "envmap":
            # per-texel emission spectra for the environment (the envmap
            # analog of the per-texel rgb2spec reflectance atlases):
            # coeffs fit the chromaticity, peak restores the radiance
            # (srgb.cpp emission upsampling)
            from ..core import cie as _cie
            flat = env_img.reshape(-1, 3).astype(np.float64)
            peak = np.maximum(flat.max(axis=1), 1e-9)
            coeffs = _cie.fit_reflectance_coeffs_batch(flat / peak[:, None])
            env_coeff = np.concatenate(
                [np.asarray(coeffs, np.float32).T,
                 peak[None, :].astype(np.float32)], axis=0)   # (4, T)

        # --- media table ---------------------------------------------------
        from ..media import N_MED_PARAMS
        media_objs = []
        media_index = {}

        def add_medium(m):
            if m is None:
                return -1
            if id(m) not in media_index:
                media_index[id(m)] = len(media_objs)
                media_objs.append(m)
            return media_index[id(m)]

        sensor_medium = add_medium(getattr(self.sensor, "medium", None))
        inst_int_medium = [add_medium(getattr(sh, "interior_medium", None))
                           for sh in self.shapes]
        med_params = (np.stack([m.params_row() for m in media_objs]).T
                      if media_objs else np.zeros((N_MED_PARAMS, 1)))
        if spectral and media_objs:
            # upsample sigma_t (peak-normalized) and albedo to sigmoid
            # coefficients, mirroring the emitter/reflectance treatment
            from ..core import cie as _cie
            from ..media import M_SIGMA_T as _MST, M_ALBEDO as _MAL, \
                M_ST_PEAK as _MPK
            for mi_ in range(len(media_objs)):
                st = med_params[_MST:_MST + 3, mi_]
                peak = max(float(st.max()), 1e-9)
                med_params[_MST:_MST + 3, mi_] = \
                    _cie.fit_reflectance_coeffs(st / peak)
                med_params[_MPK, mi_] = peak
                al = med_params[_MAL:_MAL + 3, mi_]
                if al.max() > 0:
                    med_params[_MAL:_MAL + 3, mi_] = \
                        _cie.fit_reflectance_coeffs(al)
        # flat density atlas + world->grid transforms for heterogeneous rows
        from ..media import M_GRID_OFF, M_MAXD
        med_grid_parts = []
        med_w2g = np.zeros((12, max(len(media_objs), 1)))
        grid_off = 0
        any_hetero = False
        for mi_, m in enumerate(media_objs):
            g = getattr(m, "grid", None)
            if g is None:
                continue
            any_hetero = True
            data = g.scalar_grid().ravel()          # (z*y*x,), index (z*ny+y)*nx+x
            med_params[M_GRID_OFF, mi_] = grid_off
            med_grid_parts.append(data)
            grid_off += data.size
            w2g = np.linalg.inv(np.asarray(g.to_world, np.float64))
            med_w2g[:, mi_] = w2g[:3, :4].reshape(-1)
        med_grid = (np.concatenate(med_grid_parts)
                    if med_grid_parts else np.zeros(1, np.float32))
        # spatially-varying SGGX: pack 6-channel S grids into a row atlas
        # (V, 6) evaluated per interaction (reference sggx.cpp
        # eval_ndf_params -> gridvolume eval_6); M_SGGX_NX == 0 keeps the
        # constant-S path (M_SGGX entries)
        from ..media import M_SGGX_OFF, M_SGGX_NX, M_SGGX_NY, M_SGGX_NZ
        sggx_parts = []
        sggx_w2g = np.zeros((12, max(len(media_objs), 1)))
        sggx_row_off = 0
        for mi_, m in enumerate(media_objs):
            sg = getattr(m.phase, "S_grid", None)
            if sg is None:
                continue
            rows = np.ascontiguousarray(
                sg.data[..., :6].reshape(-1, 6), np.float32)
            med_params[M_SGGX_OFF, mi_] = sggx_row_off
            med_params[M_SGGX_NX, mi_] = sg.data.shape[2]
            med_params[M_SGGX_NY, mi_] = sg.data.shape[1]
            med_params[M_SGGX_NZ, mi_] = sg.data.shape[0]
            sggx_parts.append(rows)
            sggx_row_off += rows.shape[0]
            sggx_w2g[:, mi_] = np.linalg.inv(np.asarray(
                sg.to_world, np.float64))[:3, :4].reshape(-1)
        sggx_grid = (np.concatenate(sggx_parts, axis=0)
                     if sggx_parts else np.zeros((1, 6), np.float32))
        any_sggx_grid = bool(sggx_parts)

        # --- instances & triangles -----------------------------------------
        inst_m0, inst_m1, inst_t0, inst_t1 = [], [], [], []
        inst_bsdf, inst_emitter, inst_nsign = [], [], []
        s_cols = {c: [] for c in _TRI_COLS + _TRI_INT_COLS}
        a_cols = {c: [] for c in _TRI_COLS + _TRI_INT_COLS}
        anim_ranges: List[Tuple[int, int, int]] = []
        all_pts = []

        sph_m0, sph_m1, sph_t0, sph_t1, sph_inst = [], [], [], [], []
        sphere_animated = []
        static_ranges = {}           # instance -> (tri start, count)

        for ii, sh in enumerate(self.shapes):
            m0, m1, t0, t1 = sh.to_world.matrices()
            animated = sh.to_world.animated
            inst_m0.append(m0[:3, :4].reshape(-1))
            inst_m1.append(m1[:3, :4].reshape(-1))
            inst_t0.append(t0)
            inst_t1.append(t1)
            inst_bsdf.append(bsdf_index[id(sh.bsdf)])
            inst_emitter.append(
                self.emitters.index(sh.emitter) if sh.emitter is not None else -1)
            inst_nsign.append(
                -1.0 if getattr(sh, "flip_normals", False) else 1.0)

            if getattr(sh, "is_analytic_sphere", False):
                sph_m0.append(m0[:3, :4].reshape(-1))
                sph_m1.append(m1[:3, :4].reshape(-1))
                sph_t0.append(t0)
                sph_t1.append(t1)
                sph_inst.append(ii)
                sphere_animated.append(animated)
                # bounds for the scene bsphere
                for mm in ((m0, m1) if animated else (m0,)):
                    c = mm[:3, 3]
                    r = float(np.linalg.norm(mm[:3, :3], 2))
                    all_pts.append(c[None, :] + np.array(
                        [[-r, -r, -r], [r, r, r]]))
                continue

            mesh = sh.mesh
            f = mesh.faces
            v = mesh.vertices
            nt = f.shape[0]

            if animated:
                cols = a_cols
                vv = v
                for mm in (m0, m1):
                    all_pts.append(v @ mm[:3, :3].T + mm[:3, 3])
            else:
                cols = s_cols
                vv = v @ m0[:3, :3].T + m0[:3, 3]
                all_pts.append(vv)
                static_ranges[ii] = (sum(a.shape[0] for a in s_cols["inst"]),
                                     nt)

            p0 = vv[f[:, 0]]
            p1 = vv[f[:, 1]]
            p2 = vv[f[:, 2]]
            e1 = p1 - p0
            e2 = p2 - p0

            if mesh.normals is not None:
                if animated:
                    nrm = mesh.normals
                else:
                    inv_t = np.linalg.inv(m0[:3, :3]).T
                    nrm = mesh.normals @ inv_t.T
                    nrm = nrm / np.maximum(
                        np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
                n0, n1, n2 = nrm[f[:, 0]], nrm[f[:, 1]], nrm[f[:, 2]]
            else:
                gn = np.cross(e1, e2)
                gn = gn / np.maximum(
                    np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
                n0 = n1 = n2 = gn

            if mesh.uvs is not None:
                uv0, uv1, uv2 = mesh.uvs[f[:, 0]], mesh.uvs[f[:, 1]], mesh.uvs[f[:, 2]]
            else:
                uv0 = uv1 = uv2 = np.zeros((nt, 2))

            if mesh_attr_names:
                att = None
                for nm_ in mesh_attr_names:
                    att = getattr(mesh, "attributes", {}).get(nm_)
                    if att is not None:
                        break
                if att is None:
                    rows9 = np.full((nt, 9), 0.5, np.float32)
                else:
                    att = np.asarray(att, np.float32)
                    if att.ndim == 1:
                        att = att[:, None]
                    if att.shape[1] == 1:
                        att = np.repeat(att, 3, axis=1)
                    rows9 = np.concatenate(
                        [att[f[:, k]][:, :3] for k in range(3)], axis=1)
                (a_attr_rows if animated else s_attr_rows).append(rows9)

            data = {
                "v0x": p0[:, 0], "v0y": p0[:, 1], "v0z": p0[:, 2],
                "e1x": e1[:, 0], "e1y": e1[:, 1], "e1z": e1[:, 2],
                "e2x": e2[:, 0], "e2y": e2[:, 1], "e2z": e2[:, 2],
                "n0x": n0[:, 0], "n0y": n0[:, 1], "n0z": n0[:, 2],
                "n1x": n1[:, 0], "n1y": n1[:, 1], "n1z": n1[:, 2],
                "n2x": n2[:, 0], "n2y": n2[:, 1], "n2z": n2[:, 2],
                "uv0u": uv0[:, 0], "uv0v": uv0[:, 1],
                "uv1u": uv1[:, 0], "uv1v": uv1[:, 1],
                "uv2u": uv2[:, 0], "uv2v": uv2[:, 1],
                "inst": np.full(nt, ii, np.int32),
                "prim": np.arange(nt, dtype=np.int32),
            }
            for c in _TRI_COLS + _TRI_INT_COLS:
                cols[c].append(data[c])
            if animated:
                start = sum(r[2] for r in anim_ranges)
                anim_ranges.append((ii, start, nt))

        def pack(cols):
            nt = sum(a.shape[0] for a in cols["inst"]) if cols["inst"] else 0
            out = {}
            for c in _TRI_COLS + _TRI_INT_COLS:
                if nt > 0:
                    cat = np.concatenate(cols[c], axis=0)
                else:
                    cat = np.zeros((1,))
                dtype = np.int32 if c in _TRI_INT_COLS else np.float32
                if nt == 0 and c in _TRI_INT_COLS:
                    cat = np.full((1,), -1)
                out[c] = jnp.asarray(cat, dtype=dtype)
            return out, nt

        s, n_static = pack(s_cols)
        a, n_anim = pack(a_cols)

        # BVH over the static triangles above the linear-scan sweet spot
        # (ops/bvh.py; the reference's Embree/OptiX acceleration role)
        from ..ops.bvh import build_bvh, BVH_THRESHOLD
        bvh = None
        if n_static > BVH_THRESHOLD:
            sv = {c: np.concatenate(s_cols[c], axis=0)
                  for c in ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z",
                            "e2x", "e2y", "e2z")}
            bvh = build_bvh([sv["v0x"], sv["v0y"], sv["v0z"]],
                            [sv["e1x"], sv["e1y"], sv["e1z"]],
                            [sv["e2x"], sv["e2y"], sv["e2z"]])

        # per-instance object-space BLAS for large animated meshes — the
        # analog of the reference's motion IAS over per-shapegroup GASes
        # (scene_optix.inl:91 + optix/shapes.h:232-258): the BLAS is
        # time-invariant because rays enter object space through the
        # per-lane lerped-inverse transform
        anim_blas = []
        if anim_ranges:
            av = {c: np.concatenate(a_cols[c], axis=0)
                  for c in ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z",
                            "e2x", "e2y", "e2z")}
            for (inst, start, count) in anim_ranges:
                if count > BVH_THRESHOLD:
                    sl = slice(start, start + count)
                    anim_blas.append(build_bvh(
                        [av["v0x"][sl], av["v0y"][sl], av["v0z"][sl]],
                        [av["e1x"][sl], av["e1y"][sl], av["e1z"][sl]],
                        [av["e2x"][sl], av["e2y"][sl], av["e2z"][sl]]))
                else:
                    anim_blas.append(None)

        # mesh-area-emitter triangle CDFs. Animated shapes sample their
        # object-space CDF and transform per lane at the ray's time — an
        # extension beyond the reference, which forbids emitters on
        # instanced/animated shapes outright (instance.cpp:48).
        # meta: (emitter_idx, tri_start, count, cdf_off, animated, inst_idx)
        mesh_em_meta = []
        cdf_parts = []
        cdf_off = 0
        for ei, shp in mesh_emitter_shapes.items():
            ii = self.shapes.index(shp)
            if shp.to_world.animated:
                rng_a = next(r for r in anim_ranges if r[0] == ii)
                start, cnt = rng_a[1], rng_a[2]
                areas = shp.mesh.surface_areas(np.eye(4))
                anim = 1
            else:
                start, cnt = static_ranges[ii]
                m0 = shp.to_world.matrices()[0]
                areas = shp.mesh.surface_areas(m0)
                anim = 0
            cdf = np.cumsum(areas / max(areas.sum(), 1e-20)).astype(np.float32)
            mesh_em_meta.append((ei, start, cnt, cdf_off, anim, ii))
            cdf_parts.append(cdf)
            cdf_off += cnt
        em_tri_cdf = (np.concatenate(cdf_parts) if cdf_parts
                      else np.ones(1, np.float32))

        pts = np.concatenate(all_pts, axis=0) if all_pts else np.zeros((1, 3))
        center = 0.5 * (pts.min(0) + pts.max(0))
        radius = float(np.linalg.norm(pts - center, axis=-1).max()) + 1e-3

        kw = {}
        for c in _TRI_COLS + _TRI_INT_COLS:
            kw["s_" + c] = s[c]
            kw["a_" + c] = a[c]

        kw["bvh"] = bvh
        kw["anim_blas"] = tuple(anim_blas)
        if mesh_attr_names and (s_attr_rows or a_attr_rows):
            # (9, T_total) per-vertex attribute table in global slot order
            kw["mesh_attr"] = jnp.asarray(
                np.concatenate(s_attr_rows + a_attr_rows, axis=0).T,
                jnp.float32)
        else:
            kw["mesh_attr"] = None

        self._compiled = SceneArrays(
            inst_m0c=jnp.asarray(
                np.stack(inst_m0).T if inst_m0 else np.zeros((12, 1)),
                jnp.float32),
            inst_m1c=jnp.asarray(
                np.stack(inst_m1).T if inst_m1 else np.zeros((12, 1)),
                jnp.float32),
            inst_t0=jnp.asarray(inst_t0 if inst_t0 else [0.0], jnp.float32),
            inst_t1=jnp.asarray(inst_t1 if inst_t1 else [1.0], jnp.float32),
            inst_bsdf=jnp.asarray(inst_bsdf if inst_bsdf else [0], jnp.int32),
            inst_emitter=jnp.asarray(
                inst_emitter if inst_emitter else [-1], jnp.int32),
            inst_nsign=jnp.asarray(
                inst_nsign if inst_nsign else [1.0], jnp.float32),
            any_flip=any(s < 0.0 for s in inst_nsign),
            any_nmap=any(getattr(b, "nmap_index", -1) >= 0
                         for b in bsdf_objs),
            bsdf_type=jnp.asarray(bsdf_type),
            bsdf_params=jnp.asarray(bsdf_params, jnp.float32),
            emitter_type=jnp.asarray(emitter_type),
            emitter_params=jnp.asarray(emitter_params, jnp.float32),
            emitter_m=jnp.asarray(emitter_m, jnp.float32),
            tex_type=jnp.asarray(tex_type_arr),
            tex_params=jnp.asarray(tex_params, jnp.float32),
            tex_h=jnp.asarray(tex_h_arr),
            tex_atlas_r=jnp.asarray(atlas_np[:, 0], jnp.float32),
            tex_atlas_g=jnp.asarray(atlas_np[:, 1], jnp.float32),
            tex_atlas_b=jnp.asarray(atlas_np[:, 2], jnp.float32),
            tex_atlas_c0=jnp.asarray(atlas_coeff[:, 0], jnp.float32),
            tex_atlas_c1=jnp.asarray(atlas_coeff[:, 1], jnp.float32),
            tex_atlas_c2=jnp.asarray(atlas_coeff[:, 2], jnp.float32),
            sph_m0c=jnp.asarray(
                np.stack(sph_m0).T if sph_m0 else np.zeros((12, 1)), jnp.float32),
            sph_m1c=jnp.asarray(
                np.stack(sph_m1).T if sph_m1 else np.zeros((12, 1)), jnp.float32),
            sph_t0=jnp.asarray(sph_t0 if sph_t0 else [0.0], jnp.float32),
            sph_t1=jnp.asarray(sph_t1 if sph_t1 else [1.0], jnp.float32),
            sph_inst=jnp.asarray(sph_inst if sph_inst else [-1], jnp.int32),
            env_img_r=jnp.asarray(env_img[..., 0].reshape(-1), jnp.float32),
            env_img_g=jnp.asarray(env_img[..., 1].reshape(-1), jnp.float32),
            env_img_b=jnp.asarray(env_img[..., 2].reshape(-1), jnp.float32),
            env_pdf=jnp.asarray(env_pdf, jnp.float32),
            env_cdf=jnp.asarray(env_cdf, jnp.float32),
            env_alias=jnp.asarray(env_alias, jnp.int32),
            env_aprob=jnp.asarray(env_aprob, jnp.float32),
            env_rot=jnp.asarray(env_rot, jnp.float32),
            env_rot_fwd=jnp.asarray(env_rot_fwd, jnp.float32),
            env_coeff=jnp.asarray(env_coeff, jnp.float32),
            em_tri_cdf=jnp.asarray(em_tri_cdf, jnp.float32),
            med_params=jnp.asarray(med_params, jnp.float32),
            med_grid=jnp.asarray(med_grid, jnp.float32),
            med_w2g=jnp.asarray(med_w2g, jnp.float32),
            sggx_grid=jnp.asarray(sggx_grid, jnp.float32),
            sggx_w2g=jnp.asarray(sggx_w2g, jnp.float32),
            inst_int_medium=jnp.asarray(
                inst_int_medium if inst_int_medium else [-1], jnp.int32),
            bsphere_radius=jnp.float32(radius),
            bsphere_center=jnp.asarray(center, jnp.float32),
            n_static_tris=n_static,
            n_anim_tris=n_anim,
            anim_ranges=tuple(anim_ranges),
            bsdf_types_present=tuple(sorted(set(int(t) for t in bsdf_type))),
            emitter_types_present=tuple(sorted(set(int(t) for t in emitter_type))),
            n_emitters=n_emitters,
            has_environment=env is not None,
            env_radiance=(lambda e: ((_lum(e),) * 3 if mono else e))(
                tuple(float(x) for x in env_radiance)),
            bsdf_flags_host=tuple(int(f) for f in bsdf_flags),
            tex_types_present=tuple(sorted(set(int(t) for t in tex_types))),
            n_textures=len(tex_objs),
            n_spheres=len(sph_inst),
            sphere_animated=tuple(sphere_animated),
            env_kind=env_kind,
            env_shape=(int(env_img.shape[0]), int(env_img.shape[1])),
            env_index=env_index,
            mesh_em_meta=tuple(mesh_em_meta),
            sensor_medium=sensor_medium,
            n_media=len(media_objs),
            any_hetero=any_hetero,
            any_rayleigh=any(getattr(m.phase, "type_id", 0) == 2
                             for m in media_objs),
            tab_phase_tables=tuple(
                (tuple(float(x) for x in m.phase.values)
                 if getattr(m.phase, "type_id", 0) == 4 else None)
                for m in media_objs),
            any_sggx=any(getattr(m.phase, "type_id", 0) == 3
                         for m in media_objs),
            any_sggx_grid=any_sggx_grid,
            spectral=spectral,
            polarized=polarized,
            measured=tuple(measured_tables),
            measured_pol=tuple(measured_pol_tables),
            measured_pol_wls=tuple(measured_pol_wls),
            ior_spectra=tuple(ior_spectra),
            bsdf_ior_host=tuple(bsdf_ior_host),
            max_optical_depth_hint=float(
                max((max(float(np.max(m.params_row()[M_MAXD:M_MAXD + 1])),
                         float(np.max(m.params_row()[:3])))
                     for m in media_objs), default=0.0) * 2.0 * radius),
            **kw,
        )
        return self._compiled


# ---------------------------------------------------------------------------
# Ray intersection: lax.scan, one triangle per step, all-(N,) math
# ---------------------------------------------------------------------------

def _intersect_scan(o: Vec3, d: Vec3, maxt, cols, start: int, count: int,
                    best, any_hit: bool = False):
    """Möller-Trumbore over triangles [start, start+count).

    ``cols``: dict of (T,) arrays; per scan step the triangle's 9 floats are
    scalars broadcast against (N,) lanes. ``best``: (t, idx) carry.
    Returns (t, idx).
    """
    sl = slice(start, start + count)
    xs = (cols["v0x"][sl], cols["v0y"][sl], cols["v0z"][sl],
          cols["e1x"][sl], cols["e1y"][sl], cols["e1z"][sl],
          cols["e2x"][sl], cols["e2y"][sl], cols["e2z"][sl],
          jnp.arange(start, start + count, dtype=jnp.int32))

    def step(carry, tri):
        bt, bi = carry
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, tid = tri
        # pvec = d x e2
        px = d.y * e2z - d.z * e2y
        py = d.z * e2x - d.x * e2z
        pz = d.x * e2y - d.y * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = jnp.abs(det) > 1e-12
        inv_det = 1.0 / jnp.where(ok, det, 1.0)
        tx = o.x - v0x
        ty = o.y - v0y
        tz = o.z - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        # qvec = tvec x e1
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (d.x * qx + d.y * qy + d.z * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > 0.0) & (t < maxt) & (t < bt))
        bt = jnp.where(hit, t, bt)
        bi = jnp.where(hit, tid, bi)
        return (bt, bi), None

    (bt, bi), _ = jax.lax.scan(step, best, xs)
    return bt, bi


def _anim_object_ray(sa: SceneArrays, inst: int, ray: Ray):
    """Ray into animated instance's object space at each ray's own time."""
    c0 = sa.inst_cmat(0, inst)
    c1 = sa.inst_cmat(1, inst)
    t0 = sa.inst_t0[inst]
    t1 = sa.inst_t1[inst]
    span = t1 - t0
    denom = jnp.where(span != 0.0, span, 1.0)
    u = jnp.clip((ray.time - t0) / denom, 0.0, 1.0)
    c_t = cmat_lerp(c0, c1, u)
    inv = cmat_inverse(c_t)
    return cmat_apply_point(inv, ray.o), cmat_apply_vector(inv, ray.d), c_t, inv


def _gather_tri(sa: SceneArrays, prefix: str, idx, names):
    return tuple(sa.tri(prefix, c)[idx] for c in names)


def _hit_reference(sa: SceneArrays, ray: Ray, include_static: bool = True):
    """Plain XLA closest hit: scanned brute force (BVH/BLAS above
    BVH_THRESHOLD) producing the same fat payload as the GPU kernel
    ops.intersect_kernel.closest_hit — also the oracle for kernel tests
    (the 'scalar variant' of SURVEY.md §4)."""
    n = ray.o.x.shape[0]
    dt = ray.o.x.dtype
    best_t = jnp.full((n,), jnp.inf, dt)
    best_idx = jnp.full((n,), -1, jnp.int32)

    s_cols = {c: sa.tri("s", c) for c in ("v0x", "v0y", "v0z", "e1x", "e1y",
                                          "e1z", "e2x", "e2y", "e2z")}
    a_cols = {c: sa.tri("a", c) for c in ("v0x", "v0y", "v0z", "e1x", "e1y",
                                          "e1z", "e2x", "e2y", "e2z")}

    if sa.n_static_tris > 0 and include_static:
        if sa.bvh is not None:
            from ..ops.bvh import bvh_closest
            best_t, best_idx = bvh_closest(sa.bvh, s_cols, ray.o, ray.d,
                                           ray.maxt, (best_t, best_idx))
        else:
            best_t, best_idx = _intersect_scan(
                ray.o, ray.d, ray.maxt, s_cols, 0, sa.n_static_tris,
                (best_t, best_idx))

    o_objs = {}
    is_anim = jnp.zeros((n,), bool)
    for a, (inst, start, count) in enumerate(sa.anim_ranges):
        o_obj, d_obj, _, _ = _anim_object_ray(sa, inst, ray)
        o_objs[inst] = (o_obj, d_obj)
        blas = sa.anim_blas[a] if sa.anim_blas else None
        if blas is not None:
            # large animated mesh: object-space BLAS traversal at the
            # per-lane transformed ray (see compile(): time-invariant BLAS)
            from ..ops.bvh import bvh_closest
            sub = {c: a_cols[c][start:start + count] for c in a_cols}
            t_a, i_loc = bvh_closest(blas, sub, o_obj, d_obj, ray.maxt,
                                     (best_t, jnp.full((n,), -1, jnp.int32)))
            i_a = jnp.where(i_loc >= 0, i_loc + start, -1)
        else:
            t_a, i_a = _intersect_scan(
                o_obj, d_obj, ray.maxt, a_cols, start, count,
                (best_t, jnp.full((n,), -1, jnp.int32)))
        took = i_a >= 0
        # global slot convention: [0, n_static) static, then animated
        best_idx = jnp.where(took, i_a + sa.n_static_tris, best_idx)
        best_t = jnp.where(took, t_a, best_t)
        is_anim = jnp.where(took, True, is_anim)

    idx = jnp.maximum(best_idx, 0)
    a_idx = jnp.maximum(best_idx - sa.n_static_tris, 0)
    names = _TRI_COLS + _TRI_INT_COLS
    gs = _gather_tri(sa, "s", jnp.minimum(idx, sa.tri("s", "inst").shape[0] - 1), names)
    ga = _gather_tri(sa, "a", jnp.minimum(a_idx, sa.tri("a", "inst").shape[0] - 1), names)
    g = {c: jnp.where(is_anim, a_, s_) for c, s_, a_ in zip(names, gs, ga)}
    v0 = Vec3(g["v0x"], g["v0y"], g["v0z"])
    e1 = Vec3(g["e1x"], g["e1y"], g["e1z"])
    e2 = Vec3(g["e2x"], g["e2y"], g["e2z"])

    o_hit, d_hit = ray.o, ray.d
    from ..core.vec import where3
    for (inst, start, count) in sa.anim_ranges:
        o_obj, d_obj = o_objs[inst]
        m = is_anim & (g["inst"] == inst)
        o_hit = where3(m, o_obj, o_hit)
        d_hit = where3(m, d_obj, d_hit)

    # barycentrics of the winner in hit space
    pv = cross(d_hit, e2)
    det = dot(e1, pv)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    tv = o_hit - v0
    u = dot(tv, pv) * inv_det
    qv = cross(tv, e1)
    v = dot(d_hit, qv) * inv_det
    w = 1.0 - u - v

    gn = cross(e1, e2)
    ns = Vec3(w * g["n0x"] + u * g["n1x"] + v * g["n2x"],
              w * g["n0y"] + u * g["n1y"] + v * g["n2y"],
              w * g["n0z"] + u * g["n1z"] + v * g["n2z"])
    uv_u = w * g["uv0u"] + u * g["uv1u"] + v * g["uv2u"]
    uv_v = w * g["uv0v"] + u * g["uv1v"] + v * g["uv2v"]

    # animated hits: normals to world via inverse-transpose of lerped matrix
    if sa.anim_ranges:
        inst_id = jnp.maximum(g["inst"], 0)
        c0 = tuple(sa.inst_m0c[j, inst_id] for j in range(12))
        c1 = tuple(sa.inst_m1c[j, inst_id] for j in range(12))
        t0g = sa.inst_t0[inst_id]
        t1g = sa.inst_t1[inst_id]
        span = t1g - t0g
        uu = jnp.clip((ray.time - t0g) / jnp.where(span != 0.0, span, 1.0),
                      0.0, 1.0)
        c_t = cmat_lerp(c0, c1, uu)
        inv_t = cmat_inverse(c_t)
        gn = where3(is_anim, cmat_apply_transpose_vector(inv_t, gn), gn)
        ns = where3(is_anim, cmat_apply_transpose_vector(inv_t, ns), ns)

    inst_out = jnp.where(best_idx >= 0, g["inst"], -1)
    hit = HitRecord(best_t, best_idx, inst_out, u, v,
                    gn.x, gn.y, gn.z, ns.x, ns.y, ns.z, uv_u, uv_v)
    if sa.n_spheres:
        hit = _spheres_reference(sa, ray, hit)
    return hit


def _spheres_reference(sa: SceneArrays, ray: Ray, hit):
    """Analytic spheres for the oracle path (unit sphere in object space,
    reference src/shapes/sphere.cpp)."""
    import math as _m
    out = hit
    for s in range(sa.n_spheres):
        c0 = tuple(sa.sph_m0c[j, s] for j in range(12))
        if sa.sphere_animated[s]:
            c1 = tuple(sa.sph_m1c[j, s] for j in range(12))
            span = sa.sph_t1[s] - sa.sph_t0[s]
            denom = jnp.where(span != 0.0, span, 1.0)
            uu = jnp.clip((ray.time - sa.sph_t0[s]) / denom, 0.0, 1.0)
            c_t = cmat_lerp(c0, c1, uu)
        else:
            c_t = c0
        inv = cmat_inverse(c_t)
        o = cmat_apply_point(inv, ray.o)
        d = cmat_apply_vector(inv, ray.d)
        a = dot(d, d)
        b = 2.0 * dot(o, d)
        c = dot(o, o) - 1.0
        disc = b * b - 4.0 * a * c
        ok = disc >= 0.0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        q = -0.5 * (b + jnp.where(b >= 0.0, sq, -sq))
        t0 = q / jnp.where(a != 0.0, a, 1.0)
        t1 = c / jnp.where(q != 0.0, q, 1.0)
        tn = jnp.minimum(t0, t1)
        tf = jnp.maximum(t0, t1)
        t = jnp.where(tn > 0.0, tn, tf)
        hit_m = ok & (t > 0.0) & (t < ray.maxt) & (t < out.t)
        pn = o + d * t          # object-space normal = hit point
        wn = cmat_apply_transpose_vector(inv, pn)
        phi = jnp.arctan2(pn.y, pn.x)
        u = phi * (0.5 / _m.pi)
        u = jnp.where(u < 0.0, u + 1.0, u)
        v = jnp.arccos(jnp.clip(pn.z, -1.0, 1.0)) * (1.0 / _m.pi)
        out = out._replace(
            t=jnp.where(hit_m, t, out.t),
            prim=jnp.where(hit_m, SPH_SLOT_BASE + s, out.prim),
            inst=jnp.where(hit_m, sa.sph_inst[s], out.inst),
            u=jnp.where(hit_m, 0.0, out.u),
            v=jnp.where(hit_m, 0.0, out.v),
            gnx=jnp.where(hit_m, wn.x, out.gnx),
            gny=jnp.where(hit_m, wn.y, out.gny),
            gnz=jnp.where(hit_m, wn.z, out.gnz),
            nsx=jnp.where(hit_m, wn.x, out.nsx),
            nsy=jnp.where(hit_m, wn.y, out.nsy),
            nsz=jnp.where(hit_m, wn.z, out.nsz),
            uv_u=jnp.where(hit_m, u, out.uv_u),
            uv_v=jnp.where(hit_m, v, out.uv_v))
    return out


# Scenes with at most this many triangles (static + animated) take the
# fused GPU kernel on the GPU; every other scene, and every other platform,
# takes the XLA path (_hit_reference, the BVH/BLAS of ops/bvh.py).
SMALL_SCENE_THRESHOLD = 192

# render/ad.py clears this while tracing gradients: the GPU kernel defines
# no VJP, so differentiated renders run the XLA path on every platform.
USE_CUSTOM_KERNEL = True


def query_platform() -> str:
    """Platform the ray queries are traced for: the default device's if
    one is set (``jax.default_device``), else the default backend's."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def ray_query_route(sa: SceneArrays, platform: str = None) -> str:
    """'kernel' (ops/intersect_kernel.py, GPU only) or 'xla'."""
    platform = platform or query_platform()
    if (USE_CUSTOM_KERNEL and platform == "gpu"
            and sa.n_static_tris + sa.n_anim_tris <= SMALL_SCENE_THRESHOLD):
        return "kernel"
    return "xla"


def _closest_hit(sa: SceneArrays, ray: Ray):
    if ray_query_route(sa) == "kernel":
        from ..ops.intersect_kernel import closest_hit
        return closest_hit(sa, ray)
    return _hit_reference(sa, ray)


def build_si(sa: SceneArrays, ray: Ray, hit, active=None) -> SurfaceInteraction:
    """Assemble the SurfaceInteraction from the fat hit payload — pure
    elementwise, zero gathers (reference compute_surface_interaction)."""
    valid = hit.prim >= 0
    if active is not None:
        valid = valid & active
    t = jnp.where(valid, hit.t, jnp.inf)
    p = ray.o + ray.d * jnp.where(valid, hit.t, 0.0)
    ng = normalize(Vec3(hit.gnx, hit.gny, hit.gnz))
    ns = normalize(Vec3(hit.nsx, hit.nsy, hit.nsz))
    if getattr(sa, "any_flip", False):
        # per-instance flip_normals (reference shape.cpp): negate both
        # normals — the shading frame and sidedness flip with them
        sgn = gather_small(sa.inst_nsign, jnp.maximum(hit.inst, 0))
        ng = Vec3(ng.x * sgn, ng.y * sgn, ng.z * sgn)
        ns = Vec3(ns.x * sgn, ns.y * sgn, ns.z * sgn)
    sh_s, sh_t = coordinate_system(ns)
    wi_world = -ray.d
    wi = Vec3(dot(wi_world, sh_s), dot(wi_world, sh_t), dot(wi_world, ns))
    return SurfaceInteraction(
        valid=valid, t=t, p=p, n=ng, sh_n=ns, sh_s=sh_s, sh_t=sh_t,
        uv_u=hit.uv_u, uv_v=hit.uv_v, wi=wi,
        inst=jnp.where(valid, hit.inst, -1),
        prim=jnp.where(valid, hit.prim, -1), time=ray.time,
        b_u=hit.u, b_v=hit.v)


def ray_intersect(sa: SceneArrays, ray: Ray, active=None) -> SurfaceInteraction:
    """Full surface-interaction query (reference scene.cpp:125-137)."""
    hit = _closest_hit(sa, ray)
    return build_si(sa, ray, hit, active)


def ray_test(sa: SceneArrays, ray: Ray, active=None):
    """Shadow/any-hit query (reference scene.cpp ray_test)."""
    if ray_query_route(sa) == "kernel":
        from ..ops.intersect_kernel import any_hit
        occluded = any_hit(sa, ray)
    elif sa.has_accel:
        if sa.bvh is not None:
            from ..ops.bvh import bvh_any
            s_cols = {c: sa.tri("s", c) for c in
                      ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z",
                       "e2x", "e2y", "e2z")}
            occluded = bvh_any(sa.bvh, s_cols, ray.o, ray.d, ray.maxt)
            if sa.anim_ranges or sa.n_spheres:
                # animated instances go through the oracle sweep, which
                # itself routes large ones onto their object-space BLAS
                occluded = occluded | (_hit_reference(
                    sa, ray, include_static=False).prim >= 0)
        else:
            occluded = _hit_reference(sa, ray).prim >= 0
    else:
        hit = _hit_reference(sa, ray)
        occluded = hit.prim >= 0
    if active is not None:
        occluded = occluded & active
    return occluded


def gather_small(table, idx, size: int = None):
    """Lookup into a tiny (size,) table by (N,) indices via unrolled selects
    (per-lane material/emitter ids); a real gather for larger tables."""
    if size is None:
        size = int(table.shape[0])
    if size > 32:
        return table[idx]
    out = jnp.broadcast_to(table[0], idx.shape)
    for k in range(1, size):
        out = jnp.where(idx == k, table[k], out)
    return out


__all__ = ["Scene", "SceneArrays", "ray_intersect", "ray_test", "build_si", "gather_small"]
