"""Generate variance-aware golden references (reference protocol
src/render/tests/test_renders.py + src/integrators/moment.cpp): for each
variant, render the canonical scene through the `moment` integrator at
high spp and store per-pixel mean + variance. tests/test_renders.py
Z-tests every future render against these.

Usage: python scripts/gen_render_refs.py [--spp N] [--res N]
Writes tests/data/renders/ref_<variant>.npz
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


CANONICAL = "/root/reference/configs_example/scene.xml"

# the canonical scene's integrator parameters (configs_example/scene.xml)
# re-declared so the moment integrator can wrap the same child
CHILD = {
    "type": "dopplertofpath", "max_depth": 4,
    "w_g": 30.0, "hetero_frequency": 1.0, "hetero_offset": 0.0,
    "antithetic_shift": 0.5, "path_correlation_depth": 4,
    "time_sampling_method": "antithetic", "time": 0.0015,
}

VARIANTS = ["tpu_rgb", "tpu_spectral", "tpu_mono",
            "tpu_rgb_polarized", "tpu_spectral_polarized"]


def _load_scene(mi, scene_name: str, res: int, spp: int):
    if scene_name == "hero":
        from mitsuba3dopplertof_tpu.utils.hero_scene import hero_scene_dict
        d = hero_scene_dict(spp=spp, res=res)
        child = d.pop("integrator")
        return mi.load_dict(d | {"integrator": child}), child
    return mi.load_file(CANONICAL, resx=res, resy=res), dict(CHILD)


def render_moments(mi, res: int, spp: int, seed: int = 0,
                   scene_name: str = "canonical"):
    scene, child = _load_scene(mi, scene_name, res, spp)
    minteg = mi.load_dict({"type": "moment", "child": child})
    img = np.asarray(minteg.render(scene, spp=spp, seed=seed))
    n = img.shape[-1] // 2
    mean, m2 = img[..., :n], img[..., n:]
    return mean, np.maximum(m2 - mean * mean, 0.0)


def render_empirical(mi, res: int, spp: int, k: int = 32, seed0: int = 100):
    """Mean + per-sample variance from K independent renders: for variants
    whose splatted value is a nonlinear function of the integrator sample
    (tpu_spectral converts hero-wavelength triplets to sRGB inside the
    sample body), the moment AOVs measure pre-conversion moments — the
    per-pixel variance of the actual channel estimator must be measured
    across independent realizations instead."""
    spp_per = max(16, spp // k)
    scene = mi.load_file(CANONICAL, resx=res, resy=res)
    imgs = np.stack([np.asarray(mi.render(scene, spp=spp_per,
                                          seed=seed0 + i))
                     for i in range(k)])
    mean = imgs.mean(axis=0)
    var = imgs.var(axis=0, ddof=1) * spp_per   # per-sample variance
    return mean, var


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=4096)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--variants", default=None,
                    help="comma-separated subset (default: all)")
    ap.add_argument("--scene", default="canonical",
                    choices=["canonical", "hero"],
                    help="hero writes ref_hero_<variant>.npz (generate "
                    "on the GPU with MI_GPU_TESTS=1; the hero scene is "
                    "too slow for CPU golden generation)")
    args = ap.parse_args()
    chosen = (args.variants.split(",") if args.variants else VARIANTS)
    if args.scene == "hero" and args.variants is None:
        chosen = ["tpu_rgb"]

    # references are CPU-canonical unless MI_GPU_TESTS=1
    if not os.environ.get("MI_GPU_TESTS"):
        import jax
        jax.config.update("jax_platforms", "cpu")
    import mitsuba3dopplertof_tpu as mi
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "data", "renders")
    os.makedirs(out_dir, exist_ok=True)
    prefix = "ref_" if args.scene == "canonical" else f"ref_{args.scene}_"
    for variant in chosen:
        mi.set_variant(variant)
        if variant in ("tpu_spectral", "tpu_spectral_polarized"):
            mean, var = render_empirical(mi, args.res, args.spp)
        else:
            mean, var = render_moments(mi, args.res, args.spp,
                                       scene_name=args.scene)
        path = os.path.join(out_dir, f"{prefix}{variant}.npz")
        np.savez_compressed(path, mean=mean.astype(np.float32),
                            var=var.astype(np.float32),
                            spp=np.int64(args.spp), res=np.int64(args.res))
        print(f"{variant}: mean |x|={np.abs(mean).mean():.5f} "
              f"var mean={var.mean():.6f} -> {path}", flush=True)


if __name__ == "__main__":
    main()
