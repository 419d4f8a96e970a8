"""Command-line renderer — the equivalent of the reference's `mitsuba`
binary (reference src/mitsuba/mitsuba.cpp:150-424).

    python -m mitsuba3dopplertof_tpu.cli scene.xml -o out.exr -D spp=256

Flags mirror the reference: -D key=value scene parameter overrides,
-o output, -s SENSOR INDEX, -a extra file-resolver paths, -v verbosity,
-m variant (reference names map onto this package's variants: *_rgb -> tpu_rgb,
*_spectral -> tpu_spectral, *_mono -> tpu_mono, *_polarized ->
tpu_rgb_polarized), -u rewrites the scene XML through the loader
(version upgrade). -t/--threads is accepted and ignored (XLA owns
scheduling; the reference's JIT flags -O/-W/-V likewise have no
analog). Extras beyond the reference: --spp, --seed, --png.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _map_variant(name: str) -> str:
    if name.startswith("tpu_"):
        return name
    if name.endswith("_polarized") or "_polarized_" in name:
        return "tpu_rgb_polarized"
    if name.endswith("_spectral") or "_spectral_" in name:
        return "tpu_spectral"
    if name.endswith("_mono"):
        return "tpu_mono"
    return "tpu_rgb"


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mitsuba3dopplertof-tpu",
        description="Doppler ToF renderer")
    ap.add_argument("scene", help="scene XML file")
    ap.add_argument("-o", "--output", default=None,
                    help="output EXR (default: scene name .exr)")
    ap.add_argument("-D", "--define", action="append", default=[],
                    metavar="key=value", help="scene parameter override")
    ap.add_argument("-m", "--mode", default="tpu_rgb",
                    help="variant (tpu_* or a reference variant name)")
    ap.add_argument("-s", "--sensor", type=int, default=0,
                    help="sensor index (reference -s semantics)")
    ap.add_argument("-a", "--append", action="append", default=[],
                    help="';'-separated extra file resolver search paths")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="-v: Debug log level, -vv: Trace")
    ap.add_argument("-t", "--threads", type=int, default=0,
                    help="accepted for compatibility; XLA owns scheduling")
    ap.add_argument("-u", "--update", action="store_true",
                    help="rewrite the scene XML through the loader "
                         "(version upgrade)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spp", type=int, default=0,
                    help="override samples per pixel")
    ap.add_argument("--png", action="store_true",
                    help="also write a tonemapped PNG")
    args = ap.parse_args(argv)

    import numpy as np
    import mitsuba3dopplertof_tpu as mi
    from mitsuba3dopplertof_tpu.io.bitmap import write_exr_rgb, write_png

    if args.verbose >= 2:
        mi.set_log_level(mi.TRACE)
    elif args.verbose == 1:
        mi.set_log_level(mi.DEBUG)
    for group in args.append:
        for path in group.split(";"):
            if path:
                mi.file_resolver().append(path)
    mi.set_variant(_map_variant(args.mode))

    params = {}
    for d in args.define:
        k, sep, v = d.partition("=")
        if not sep:
            ap.error("-D/--define: expect key=value pair!")
        params[k] = v

    if args.update:
        # reference -u: parse and re-serialize at the current version
        d = mi.xml_to_dict(args.scene, {k: str(v) for k, v in
                                        params.items()}, is_file=True)
        out_xml = args.output or args.scene
        with open(out_xml, "w") as f:
            f.write(mi.dict_to_xml(d))
        print(f"[update] wrote {out_xml}", file=sys.stderr)
        return

    t0 = time.time()
    scene = mi.load_file(args.scene, **params)
    print(f"[load] {time.time() - t0:.2f}s", file=sys.stderr)

    t0 = time.time()
    img = np.asarray(mi.render(scene, spp=args.spp, seed=args.seed,
                               sensor=scene.sensors[args.sensor]))
    dt = time.time() - t0
    w, h = scene.sensors[args.sensor].film.size
    spp = args.spp or scene.sensors[args.sensor].sampler.sample_count
    print(f"[render] {dt:.2f}s  {w * h * spp / dt / 1e6:.1f} Msamples/s",
          file=sys.stderr)

    out = args.output or os.path.splitext(args.scene)[0] + ".exr"
    fmt = getattr(scene.sensors[args.sensor].film, "component_format",
                  "float16")
    write_exr_rgb(out, img[..., :3], half=(fmt != "float32"))
    print(f"[write] {out}", file=sys.stderr)
    if args.png:
        from mitsuba3dopplertof_tpu.utils.image import to_ldr_image
        write_png(os.path.splitext(out)[0] + ".png",
                  to_ldr_image(img[..., :3]), gamma=False)


if __name__ == "__main__":
    main()
