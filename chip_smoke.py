#!/usr/bin/env python3
"""Smoke test of the Doppler ToF render path on NVIDIA GPUs.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded render only

Phases on one card, all through the user entry points (``mi.load_file``,
``mi.render``) and all in this one process:

  kernel     the small-scene ray-query kernel as compiled for the card,
             against the XLA reference on the same card, on 1M camera
             rays and 1M first-bounce rays of the canonical-shaped scene;
  canonical  scenes/canonical_cbox.xml at 256x256 @ 1024 spp (timed), and
             the same scene at 64x64 @ 64 spp rendered on the card and on
             the host CPU with one seed, compared;
  hero       the hero scene (10.7k-triangle animated knot through its
             BLAS, animated mirror sphere, textures, envmap, smoke) at
             256x256 @ 64 spp (timed), and a Z-test against the committed
             Monte Carlo golden tests/data/renders/ref_hero_tpu_rgb.npz.

``--four`` renders the canonical-shaped scene at 256x256 @ 1024 spp with
``parallel.render_sharded`` over a 1-D mesh of four cards and compares it
with the single-card render of the same seed and pass layout on card 0.

Any failed check raises, so the run exits non-zero. The script refuses to
run without a GPU. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CANONICAL = os.path.join(REPO, "scenes", "canonical_cbox.xml")
HERO_REF = os.path.join(REPO, "tests", "data", "renders",
                        "ref_hero_tpu_rgb.npz")

# kernel parity: the kernel and the XLA reference run the same Möller
# arithmetic in the same triangle order, so any difference is a bug except
# at exact near-ties between two primitives
PRIM_AGREE_MIN = 0.9999
TIE_REL = 1e-5            # |t_kernel - t_ref| / t_ref at a prim mismatch
T_REL = 1e-5              # where prim agrees
PAYLOAD_ABS = 1e-4        # unit normals, barycentrics and uv
# card vs host CPU: same PCG32 streams, so only float reassociation (FMA
# contraction, reduction order) separates them. Doppler ToF pixels are
# signed and cross zero, so each pixel is measured against the larger of
# its own magnitude and the image's mean magnitude.
CPU_MEAN_REL = 1e-3
CPU_PIX_REL = 1e-3
CPU_PIX_FRAC = 0.99
# four cards vs one: identical lanes and RNG streams; the film reduce adds
# the same addends in another order
FOUR_MAX_REL = 1e-5       # max |diff| over max |single|
ZTEST_ACCEPT = 0.9975     # tests/test_renders.py ACCEPT_FRACTION


def log(*a):
    print(*a, flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu():
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX found {devs[0].platform}"
                         f" devices: {devs}); refusing to run")
    return devs


def peak_bytes(device=None):
    import jax
    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------- rays --

def camera_rays(scene, n, seed=0):
    """n camera rays at uniform film positions and shutter times."""
    import numpy as np
    import jax.numpy as jnp
    from mitsuba3dopplertof_tpu.sensors import sample_ray_kind
    sensor = scene.sensor
    rng = np.random.default_rng(seed)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    t = f32(float(sensor.shutter_open)
            + rng.random(n) * float(sensor.shutter_open_time))
    half = f32(np.full(n, 0.5))
    lens = (sensor.device_lens_params()
            if hasattr(sensor, "device_lens_params") else None)
    ray, _ = sample_ray_kind(sensor.device_params(), lens, t,
                             f32(rng.random(n)), f32(rng.random(n)),
                             half, half)
    return ray


def bounce_rays(sa, ray, seed=1):
    """Cosine-distributed first-bounce rays from the camera rays' hits;
    lanes whose camera ray missed get maxt = -1 (dead)."""
    import numpy as np
    import jax.numpy as jnp
    from mitsuba3dopplertof_tpu.core import warp
    from mitsuba3dopplertof_tpu.core.vec import coordinate_system, dot
    from mitsuba3dopplertof_tpu.render.scene import _hit_reference, build_si
    from mitsuba3dopplertof_tpu.render.types import Ray
    si = build_si(sa, ray, _hit_reference(sa, ray))
    rng = np.random.default_rng(seed)
    n = ray.o.x.shape[0]
    local = warp.square_to_cosine_hemisphere(
        jnp.asarray(rng.random((n, 2)), jnp.float32))
    lx, ly, lz = local[:, 0], local[:, 1], local[:, 2]
    # about the geometric normal, turned to face the incoming ray
    nn = si.n * jnp.where(dot(si.n, ray.d) > 0.0, -1.0, 1.0)
    s, t = coordinate_system(nn)
    new = si._replace(n=nn).spawn_ray(s * lx + t * ly + nn * lz)
    return Ray(new.o, new.d, ray.time, jnp.where(si.valid, new.maxt, -1.0))


def compare_hits(hk, hr) -> dict:
    """Kernel hit record ``hk`` against the reference ``hr``; raises if a
    tolerance is exceeded."""
    import numpy as np
    hk = type(hk)(*[np.asarray(x) for x in hk])
    hr = type(hr)(*[np.asarray(x) for x in hr])
    both_miss = (hk.prim < 0) & (hr.prim < 0)
    same = hk.prim == hr.prim
    m = same & ~both_miss
    bad = ~same & ~both_miss

    def rel(a, b):
        return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)

    def unit(h, pre):
        v = np.stack([getattr(h, pre + c)[m] for c in "xyz"], -1)
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                              1e-20)
    payload = [np.abs(getattr(hk, f)[m] - getattr(hr, f)[m])
               for f in ("u", "v", "uv_u", "uv_v")]
    payload += [np.abs(unit(hk, p) - unit(hr, p)) for p in ("gn", "ns")]
    out = dict(lanes=int(hk.prim.size), hit_frac=float((hr.prim >= 0).mean()),
               prim_agree=float(same.mean()), mismatches=int(bad.sum()),
               mismatch_t_rel=float(rel(hk.t[bad], hr.t[bad]).max())
               if bad.any() else 0.0,
               t_rel=float(rel(hk.t[m], hr.t[m]).max()) if m.any() else 0.0,
               inst_agree=bool((hk.inst[m] == hr.inst[m]).all()),
               payload_abs=max(float(p.max()) if p.size else 0.0
                               for p in payload))
    assert out["prim_agree"] >= PRIM_AGREE_MIN, out
    assert out["mismatch_t_rel"] <= TIE_REL, out
    assert out["t_rel"] <= T_REL, out
    assert out["inst_agree"], out
    assert out["payload_abs"] <= PAYLOAD_ABS, out
    return out


def kernel_parity(n=1 << 20, interpret=False) -> dict:
    """The GPU kernel and the XLA reference on the same rays, closest and
    any hit, camera and first-bounce rays of the canonical-shaped scene."""
    import numpy as np
    import jax
    import mitsuba3dopplertof_tpu as mi
    from mitsuba3dopplertof_tpu.ops import intersect_kernel as ik
    from mitsuba3dopplertof_tpu.render.scene import _hit_reference
    sc = mi.load_file(CANONICAL)
    sa = sc.compile()
    cam = camera_rays(sc, n)
    rays = {"camera": cam,
            "bounce": jax.jit(lambda sa, r: bounce_rays(sa, r))(sa, cam)}
    closest = jax.jit(lambda sa, r: ik.closest_hit(sa, r, interpret))
    anyhit = jax.jit(lambda sa, r: ik.any_hit(sa, r, interpret))
    ref = jax.jit(_hit_reference)
    out = {}
    for name, ray in rays.items():
        hr = ref(sa, ray)
        out[name] = compare_hits(closest(sa, ray), hr)
        occ = np.asarray(anyhit(sa, ray))
        agree = float((occ == (np.asarray(hr.prim) >= 0)).mean())
        assert agree >= PRIM_AGREE_MIN, (name, "any-hit", agree)
        out[name]["any_agree"] = agree
    return out


# ------------------------------------------------------------ renders --

def timed_render(scene, spp, seed=0):
    """First call (compile + run) and a warm call; returns (image, stats)."""
    import numpy as np
    import mitsuba3dopplertof_tpu as mi
    t0 = time.perf_counter()
    np.asarray(mi.render(scene, spp=spp, seed=seed))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = np.asarray(mi.render(scene, spp=spp, seed=seed))
    warm = time.perf_counter() - t0
    W, H = scene.sensor.film.crop_size
    assert img.shape == (H, W, 3) and np.isfinite(img).all(), img.shape
    return img, dict(res=f"{W}x{H}", spp=spp, compile_s=first - warm,
                     render_s=warm, msamples_per_s=W * H * spp / warm / 1e6,
                     peak_bytes_in_use=peak_bytes())


def compare_devices(img, ref) -> dict:
    """Render ``img`` against ``ref`` of the same scene, seed and spp on
    another device; raises if a tolerance is exceeded."""
    import numpy as np
    diff = np.abs(img - ref)
    scale = np.maximum(np.abs(ref), np.abs(ref).mean())
    pix_ok = (diff <= CPU_PIX_REL * scale).all(axis=-1)
    out = dict(mean_rel=float(diff.mean() / max(np.abs(ref).mean(), 1e-30)),
               max_abs=float(diff.max()),
               pix_within=float(pix_ok.mean()))
    assert out["mean_rel"] <= CPU_MEAN_REL, out
    assert out["pix_within"] >= CPU_PIX_FRAC, out
    return out


def canonical(res=256, spp=1024, cmp_res=64, cmp_spp=64) -> dict:
    import jax
    import numpy as np
    import mitsuba3dopplertof_tpu as mi
    sc = mi.load_file(CANONICAL, resx=res, resy=res)
    _, stats = timed_render(sc, spp)
    small = dict(resx=cmp_res, resy=cmp_res)
    img = np.asarray(mi.render(mi.load_file(CANONICAL, **small),
                               spp=cmp_spp, seed=5))
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(mi.render(mi.load_file(CANONICAL, **small),
                                   spp=cmp_spp, seed=5))
    stats["vs_cpu"] = compare_devices(img, ref)
    stats["vs_cpu"]["res"] = f"{cmp_res}x{cmp_res}@{cmp_spp}"
    return stats


def hero(res=256, spp=64) -> dict:
    import numpy as np
    import mitsuba3dopplertof_tpu as mi
    from mitsuba3dopplertof_tpu.test.util import run_z_test
    from mitsuba3dopplertof_tpu.utils.hero_scene import load_hero_scene
    _, stats = timed_render(load_hero_scene(res=res, spp=spp), spp)
    # the golden test's own resolution and spp (tests/test_renders.py)
    d = np.load(HERO_REF)
    ref, var, zres = d["mean"], d["var"], int(d["res"])
    zspp = max(16, int(5e5) // (zres * zres))
    img = np.asarray(mi.render(load_hero_scene(res=zres, spp=zspp),
                               spp=zspp, seed=7))
    frac, alpha, p = run_z_test(img, zspp, ref, var)
    stats["ztest"] = dict(res=zres, spp=zspp, accepted=frac,
                          min_p=float(p.min()), alpha=alpha)
    assert frac >= ZTEST_ACCEPT, stats["ztest"]
    return stats


def four_cards(res=256, spp=1024, spp_per_pass=128) -> dict:
    """Sharded render over a 1-D mesh of four cards against the single-card
    render on card 0 with the same lanes, seed and passes."""
    import jax
    import numpy as np
    import mitsuba3dopplertof_tpu as mi
    from mitsuba3dopplertof_tpu.parallel import make_mesh, render_sharded
    devs = jax.devices()
    assert len(devs) >= 4, f"--four needs four GPUs, found {devs}"
    lanes = res * res * spp_per_pass
    sc = mi.load_file(CANONICAL, resx=res, resy=res)
    mesh = make_mesh(devs[:4])
    render = lambda: np.asarray(render_sharded(
        sc.integrator, sc, mesh=mesh, spp=spp, seed=0,
        max_lanes_per_device=lanes // 4))
    t0 = time.perf_counter()
    render()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = render()
    warm = time.perf_counter() - t0
    per_device = [dict(device=str(d), bytes_in_use=s.get("bytes_in_use"),
                       peak_bytes_in_use=s.get("peak_bytes_in_use"))
                  for d in devs[:4] for s in [d.memory_stats() or {}]]
    one = mi.load_file(CANONICAL, resx=res, resy=res)
    one.integrator.samples_per_pass = spp_per_pass     # same pass layout
    single = np.asarray(one.integrator.render(one, spp=spp, seed=0,
                                              max_lanes=lanes))
    diff = np.abs(sharded - single)
    out = dict(res=f"{res}x{res}", spp=spp, compile_s=first - warm,
               render_s=warm, msamples_per_s=res * res * spp / warm / 1e6,
               per_device=per_device,
               max_rel=float(diff.max() / max(np.abs(single).max(), 1e-30)),
               mean_rel=float(diff.mean()
                              / max(np.abs(single).mean(), 1e-30)))
    assert np.isfinite(sharded).all() and sharded.shape == single.shape
    assert out["max_rel"] <= FOUR_MAX_REL, out
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded render")
    args = ap.parse_args(argv)
    devs = require_gpu()
    sys.path.insert(0, REPO)
    log(f"device: {devs[0].device_kind} x{len(devs)}")
    if args.four:
        log("four_cards:", json.dumps(four_cards()))
    else:
        for name, phase in (("kernel", kernel_parity),
                            ("canonical", canonical), ("hero", hero)):
            t0 = time.perf_counter()
            res = phase()
            log(f"{name} ({time.perf_counter() - t0:.1f} s):",
                json.dumps(res))
    log(card_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
