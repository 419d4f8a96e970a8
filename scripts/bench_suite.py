"""Benchmark breadth (VERDICT round-1 item 9): throughput across scene
scales and variants, on the real chip. bench.py stays the driver's
single-line headline; this suite writes BENCH_TABLE.md with the full matrix:

  * canonical doppler scene (reference configs_example/scene.xml)
  * animated-mesh scenes at 2k / 10k / 40k triangles (streamed Pallas
    kernel with chunk culling — the paper-animation-scale workloads,
    reference doppler_tutorials/src/utils/common_configs.py)
  * static 50k-triangle mesh
  * volumetric (homogeneous volpath)
  * spectral + polarized canonical variants

Usage: python scripts/bench_suite.py [--quick]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def uvsphere_obj(path, nu, nv):
    lines = []
    for j in range(nv + 1):
        for i in range(nu):
            th, ph = np.pi * j / nv, 2 * np.pi * i / nu
            lines.append(f"v {np.sin(th)*np.cos(ph):.6f} {np.cos(th):.6f} "
                         f"{np.sin(th)*np.sin(ph):.6f}")

    def vid(i, j):
        return j * nu + (i % nu) + 1
    for j in range(nv):
        for i in range(nu):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            lines.append(f"f {a} {b} {c}")
            lines.append(f"f {a} {c} {d}")
    open(path, "w").write("\n".join(lines))
    return 2 * nu * nv


def animated_mesh_scene(mi, tf, AnimatedTransform, nu, nv, spp, res=256):
    path = f"/tmp/bench_sph_{nu}x{nv}.obj"
    ntri = uvsphere_obj(path, nu, nv)
    return ntri, mi.load_dict({
        "type": "scene",
        "mesh": {"type": "obj", "filename": path,
                 "to_world": AnimatedTransform([
                     (0.0, tf.translate([-0.6, 0, 0])),
                     (0.0015, tf.translate([0.6, 0, 0]))])},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1.2, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([6, 6, 1])},
        "light": {"type": "point", "position": [0, 4, -4],
                  "intensity": {"type": "rgb", "value": 40.0}},
        "sensor": {"type": "perspective", "fov": 45,
                   "shutter_open": 0.0, "shutter_close": 0.0015,
                   "to_world": tf.look_at([0, 0.5, -4], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "correlated", "sample_count": spp,
                               "time_correlate_number": 2,
                               "path_correlate_number": 2}},
        "integrator": {"type": "dopplertofpath", "max_depth": 4,
                       "time": 0.0015, "w_g": 150.0,
                       "hetero_frequency": 1.0,
                       "time_sampling_method": "antithetic",
                       "path_correlation_depth": 2},
    })


def static_mesh_scene(mi, tf, nu, nv, spp, res=256):
    path = f"/tmp/bench_static_{nu}x{nv}.obj"
    ntri = uvsphere_obj(path, nu, nv)
    return ntri, mi.load_dict({
        "type": "scene",
        "mesh": {"type": "obj", "filename": path},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1.2, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([6, 6, 1])},
        "light": {"type": "point", "position": [0, 4, -4],
                  "intensity": {"type": "rgb", "value": 40.0}},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0.5, -4], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "integrator": {"type": "path", "max_depth": 4},
    })


def volpath_scene(mi, tf, spp, res=256):
    return mi.load_dict({
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 6},
        "medium_box": {"type": "cube",
                       "to_world": tf.scale([1.2] * 3),
                       "bsdf": {"type": "null"},
                       "interior": {"type": "homogeneous",
                                    "sigma_t": {"type": "rgb", "value": 1.5},
                                    "albedo": {"type": "rgb", "value": 0.8}}},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1.5, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([6, 6, 1])},
        "light": {"type": "point", "position": [0, 4, -4],
                  "intensity": {"type": "rgb", "value": 40.0}},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0.5, -4], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
    })


def deep_path_scene(mi, tf, spp, res=256):
    """Enclosed diffuse box, max_depth 48 with RR: the early-exit bounce
    loop's showcase (mean path depth << bound)."""
    return mi.load_dict({
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 48, "rr_depth": 5},
        "box": {"type": "cube", "to_world": tf.scale([3.0] * 3),
                "bsdf": {"type": "twosided",
                         "nested": {"type": "diffuse",
                                    "reflectance": {"type": "rgb",
                                                    "value": 0.6}}}},
        "light": {"type": "sphere", "radius": 0.4,
                  "to_world": tf.translate([0, 2.2, 0]),
                  "emitter": {"type": "area",
                              "radiance": {"type": "rgb", "value": 12.0}}},
        "sensor": {"type": "perspective", "fov": 60,
                   "to_world": tf.look_at([0, 0, -2.6], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
    })


def measure(mi, scene, spp, repeats=None):
    """Median of >=5 timed repeats (+ min-max spread as a fraction of the
    median). Sub-2s renders time a BURST of back-to-back frames per
    repeat (like bench.py)."""
    if repeats is None:
        repeats = int(os.environ.get("BENCH_REPEATS", "5"))
    img = np.asarray(mi.render(scene, spp=spp, seed=0))   # compile+warm
    t0 = time.time()
    np.asarray(mi.render(scene, spp=spp, seed=10**6))     # warm, no compile
    dt_est = time.time() - t0
    assert np.isfinite(img).all()
    burst = max(1, min(4, int(3.0 / max(dt_est, 1e-3))))
    times = []
    for i in range(repeats):
        t0 = time.time()
        for b in range(burst):
            np.asarray(mi.render(scene, spp=spp, seed=1 + i * burst + b))
        times.append((time.time() - t0) / burst)
    dt = float(np.median(times))
    w, h = scene.sensor.film.size
    spread = (max(times) - min(times)) / dt
    return w * h * spp / dt / 1e6, dt, spread


def main():
    quick = "--quick" in sys.argv
    import mitsuba3dopplertof_tpu as mi
    from mitsuba3dopplertof_tpu.core import transform as tf
    from mitsuba3dopplertof_tpu.core.transform import AnimatedTransform
    import jax
    backend = jax.default_backend()

    spp = 64 if quick else 256
    rows = []

    def record(name, tris, msps, dt, spread):
        rows.append((name, tris, msps, dt, spread))
        print(json.dumps({"bench": name, "tris": tris,
                          "Msamples_per_s": round(msps, 2),
                          "seconds": round(dt, 2),
                          "spread_frac": round(spread, 3)}))

    # canonical doppler (the headline; bench.py measures the same scene)
    sc = mi.load_file("/root/reference/configs_example/scene.xml")
    msps, dt, sp = measure(mi, sc, 1024 if not quick else 128)
    record("canonical dopplertofpath 256x256", 70, msps, dt, sp)

    for nu, nv, label in [(32, 32, "2k"), (72, 70, "10k"), (144, 140, "40k"),
                          (360, 140, "100k")]:
        ntri, sc = animated_mesh_scene(mi, tf, AnimatedTransform, nu, nv, spp)
        msps, dt, sp = measure(mi, sc, spp)
        record(f"animated mesh {label} dopplertofpath 256x256",
               ntri, msps, dt, sp)

    ntri, sc = static_mesh_scene(mi, tf, 160, 158, spp)
    msps, dt, sp = measure(mi, sc, spp)
    record("static mesh 50k path 256x256", ntri, msps, dt, sp)

    # bundled hero validation scene (10.7k-tri animated knot + animated
    # mirror + textures + envmap + heterogeneous smoke)
    from mitsuba3dopplertof_tpu.utils.hero_scene import load_hero_scene
    sc = load_hero_scene(res=256, spp=spp)
    msps, dt, sp = measure(mi, sc, spp)
    record("hero scene dopplertofpath 256x256", 11616, msps, dt, sp)

    sc = volpath_scene(mi, tf, spp)
    msps, dt, sp = measure(mi, sc, spp)
    record("volpath homogeneous 256x256", 12, msps, dt, sp)

    sc = deep_path_scene(mi, tf, spp)
    msps, dt, sp = measure(mi, sc, spp)
    record("deep path max_depth=48 RR 256x256", 12, msps, dt, sp)

    # light tracing on the canonical geometry (sorted segment-sum splat)
    sc = mi.load_file("/root/reference/configs_example/scene.xml")
    sc.integrator = mi.load_dict({"type": "ptracer", "max_depth": 4})
    msps, dt, sp = measure(mi, sc, 1024 if not quick else 64)
    record("ptracer canonical 256x256", 70, msps, dt, sp)

    # variant rows at the SAME 1024 spp as the headline, so the fixed
    # per-render cost (host pass loop + dispatch + transfers) weighs the
    # same in every row
    for variant in ("tpu_spectral", "tpu_rgb_polarized"):
        mi.set_variant(variant)
        sc = mi.load_file("/root/reference/configs_example/scene.xml")
        msps, dt, sp = measure(mi, sc, 1024 if not quick else 64)
        record(f"canonical dopplertofpath {variant}", 70, msps, dt, sp)
    mi.set_variant("tpu_rgb")

    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "BENCH_TABLE.md"), "w") as f:
        f.write("# Benchmark table (%s)\n\n" % backend)
        f.write("Each row is the median of %s timed repeats; spread = "
                "(max-min)/median.\n\n"
                % os.environ.get("BENCH_REPEATS", "5"))
        f.write("| Scene | Triangles | Msamples/s/chip | seconds | spread |\n")
        f.write("|---|---|---|---|---|\n")
        for name, tris, msps, dt, sp in rows:
            f.write(f"| {name} | {tris} | {msps:.2f} | {dt:.2f} "
                    f"| {sp*100:.0f}% |\n")
    print("wrote BENCH_TABLE.md")


if __name__ == "__main__":
    main()
