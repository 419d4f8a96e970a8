"""One-command reproduction of the paper experiment grid (Exp0-3,
reference doppler_tutorials/src/main_experiment.py) on the bundled hero
validation scene, plus the main_plot metric table.

Usage:
    python scripts/run_hero_experiments.py                # toy scale
    python scripts/run_hero_experiments.py --full         # paper scale
    python scripts/run_hero_experiments.py --res 128 --spp 256 --grid 3

Writes .npy images under --out (resumable: existing files are skipped,
the reference's exit_if_file_exists protocol) and prints the
method x correlation-depth metric table vs the Exp0 ground truth."""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from mitsuba3dopplertof_tpu.core.fresolver import cache_dir  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=cache_dir("hero_experiments"))
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--spp", type=int, default=64,
                    help="total spp for method runs (Exp1-3)")
    ap.add_argument("--gt-spp", type=int, default=256,
                    help="total spp for the Exp0 ground truth")
    ap.add_argument("--grid", type=int, default=2,
                    help="frequency/offset grid resolution per axis")
    ap.add_argument("--full", action="store_true",
                    help="paper scale: res 256, spp from common_configs, "
                    "11x11 grid")
    args = ap.parse_args()

    import mitsuba3dopplertof_tpu as mi
    mi.set_variant("tpu_rgb")
    from mitsuba3dopplertof_tpu.utils.common_configs import (
        get_scene_configs, load_scene)
    from mitsuba3dopplertof_tpu.utils import experiments as E

    cfg = get_scene_configs()["hero"]
    if args.full:
        args.res, args.grid = 256, 11
        args.spp, args.gt_spp = cfg["spp"], cfg["reference_spp"]

    # The experiment harness swaps integrators per run; load the scene once
    # with a neutral doppler integrator (run_scene_doppler_tof overrides it).
    scene = load_scene("hero", res=args.res, spp=min(args.spp, 1024))
    grid = E.frequency_offset_grid(args.grid)
    md = cfg["max_depth"]
    os.makedirs(args.out, exist_ok=True)

    print(f"hero experiments: res={args.res} grid={args.grid}x{args.grid} "
          f"spp={args.spp} gt_spp={args.gt_spp} -> {args.out}", flush=True)

    gt = E.run_ground_truth(scene, args.out, scene_name="hero", grid=grid,
                            total_spp=args.gt_spp, max_depth=md)
    print("Exp0 ground truth done", flush=True)

    exp1 = E.run_method_grid(scene, args.out, scene_name="hero", grid=grid,
                             total_spp=args.spp, max_depth=md)
    print("Exp1 method grid done", flush=True)

    exp2 = E.run_method_grid(
        scene, args.out, scene_name="hero", grid=grid, total_spp=args.spp,
        use_stratified_sampling_for_each_interval=False, max_depth=md)
    print("Exp2 (no interval stratification) done", flush=True)

    shifts = np.linspace(0, 1, 11 if args.full else 3)
    exp3 = E.run_shift_sweep(scene, args.out, scene_name="hero",
                             shifts=shifts, total_spp=args.spp, max_depth=md)
    print("Exp3 shift sweep done", flush=True)

    for label, run in (("Exp1", exp1), ("Exp2", exp2)):
        m = E.metrics_vs_gt(run, gt)
        print(f"\n{label} metrics vs GT (RMSE | PSNR):")
        for key in sorted(m, key=str):
            row = m[key]
            print(f"  {str(key):40s} rmse={row['rmse']:.5f} "
                  f"psnr={row['psnr']:.2f}")
    # Exp3 runs at (freq=1, offset=0); compare each shift to that GT cell
    m3 = E.metrics_vs_gt(exp3, {float(s): gt[(1.0, 0.0)] for s in exp3})
    print("\nExp3 metrics vs GT:")
    for key in sorted(m3, key=str):
        print(f"  {str(key):40s} rmse={m3[key]['rmse']:.5f}")
    print("\nall experiments complete; images under", args.out)


if __name__ == "__main__":
    main()
