"""Headline benchmark: dopplertofpath on the canonical-shaped scene
(scenes/canonical_cbox.xml, built from the structure of the reference's
configs_example/scene.xml — 256x256, correlated sampler, antithetic time
sampling, path_correlation_depth=4, 2 animated boxes).

Prints ONE JSON line: {"metric", "value", "unit", "device", ...}.
No H100 baseline has been recorded yet.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    import numpy as np
    import mitsuba3dopplertof_tpu as mi

    scene = mi.load_file(os.environ.get(
        "BENCH_SCENE", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "scenes", "canonical_cbox.xml")))
    spp = int(os.environ.get("BENCH_SPP", "1024"))  # canonical scene.xml spp

    # warm up / compile at the SAME spp (the pass program specializes on
    # sample_count for interval stratification, so a different-spp warmup
    # would leave the measured run paying the compile)
    img = np.asarray(mi.render(scene, spp=spp, seed=0))
    assert np.isfinite(img).all()

    # >=5 timed repeats, report the median and the spread; each repeat
    # renders BURST back-to-back frames (sustained multi-frame throughput,
    # which is also what the reference's benchmarks report)
    repeats = int(os.environ.get("BENCH_REPEATS", "5"))
    burst = int(os.environ.get("BENCH_BURST", "4"))
    times = []
    for i in range(repeats):
        t0 = time.time()
        for b in range(burst):
            np.asarray(mi.render(scene, spp=spp, seed=1 + i * burst + b))
        times.append((time.time() - t0) / burst)
    dt = float(np.median(times))

    w, h = scene.sensor.film.size
    msps = w * h * spp / dt / 1e6
    spread = (max(times) - min(times)) / dt
    import jax
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "dopplertofpath_throughput",
        "value": round(msps, 3),
        "unit": "Msamples/s/device",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "repeats": repeats,
        "spread_frac": round(spread, 3),
    }))


if __name__ == "__main__":
    main()
