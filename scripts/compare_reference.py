"""Sample-exact comparison against the reference's checked-in EXR.

Renders the canonical scene in reference-layout mode (one logical 1024-spp
wavefront, global lane ids — matching the reference's single-pass wavefront,
integrator.cpp:227-263) and quantifies agreement:
  * relRMSE vs the reference and vs an independent-seed self-render
  * high-pass (5x5-residual) noise correlation — bitwise-draw parity evidence
  * smooth (9x9-mean) residual — systematic differences

Image statistics of a run (relRMSE, noise correlation, smooth residual)
are device-independent; no run on the H100 has been recorded yet.
"""

import numpy as np

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mitsuba3dopplertof_tpu as mi
from mitsuba3dopplertof_tpu.parallel.render import render_reference_layout
from mitsuba3dopplertof_tpu.io.bitmap import read_exr_rgb


def main():
    scene = mi.load_file("/root/reference/configs_example/scene.xml")
    ref = read_exr_rgb("/root/reference/configs_example/scene.exr")
    img0 = np.asarray(render_reference_layout(scene.integrator, scene,
                                              spp=1024, seed=0, chunk_rows=4))
    img1 = np.asarray(render_reference_layout(scene.integrator, scene,
                                              spp=1024, seed=1, chunk_rows=4))
    s = np.sqrt(np.mean(ref ** 2))

    def rel(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)) / s * 100)

    print(f"relRMSE ours(seed0) vs reference : {rel(img0, ref):.1f}%")
    print(f"relRMSE ours(seed0) vs ours(seed1): {rel(img0, img1):.1f}%  "
          f"(independent-realization floor)")

    from numpy.lib.stride_tricks import sliding_window_view

    def noise(img):
        x = img.mean(-1)
        pad = np.pad(x, 2, mode="edge")
        sw = sliding_window_view(pad, (5, 5))
        return x - sw.mean(axis=(-1, -2))

    na, nb = noise(img0), noise(ref)
    print("high-pass noise correlation vs reference:",
          round(float(np.corrcoef(na.ravel(), nb.ravel())[0, 1]), 3))


if __name__ == "__main__":
    main()
