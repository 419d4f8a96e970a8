"""Film plugins + the wavefront image accumulation.

The reference accumulates weighted samples with atomic scatter_reduce
(reference src/render/imageblock.cpp:119-127,174-400) and develops
rgb = value / weight (reference src/films/hdrfilm.cpp:305+).

Design: NO scatters. The wavefront is pixel-major (lane =
pixel*spp + s), so per-pixel accumulation is a *reshape + reduce* — a dense
segment sum XLA turns into a single pass. Reconstruction-filter footprints
reach only pixels within ceil(radius) of the sample's own pixel, so the
splat decomposes into (2K+1)^2 shifted dense images added with static
offsets. Deterministic by construction (fixed reduction order), which the
reference's atomics are not.

Block layout is (C, H, W): one dense (H, W) plane per channel, the film's
analog of the component-wise wavefront layout (see core/vec.py).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.properties import Properties, register_plugin


class Film:
    def __init__(self, props: Properties):
        self.id = props.id
        self.width = props.get_int("width", 768)
        self.height = props.get_int("height", 576)
        self.pixel_format = props.get_string("pixel_format", "rgb")
        self.file_format = props.get_string("file_format", "openexr")
        # consumed by EXR writers: float16 -> HALF, float32 -> FLOAT
        self.component_format = props.get_string("component_format",
                                                 "float16")
        if self.component_format not in ("float16", "float32"):
            raise RuntimeError(
                f"film: unknown component_format '{self.component_format}'")
        self.crop_offset = (props.get_int("crop_offset_x", 0),
                            props.get_int("crop_offset_y", 0))
        self.crop_size = (props.get_int("crop_width", self.width),
                          props.get_int("crop_height", self.height))
        self.sample_border = props.get_bool("sample_border", False)
        self.rfilter = None
        from ..rfilters import ReconstructionFilter
        for key, v in props.objects():
            if isinstance(v, ReconstructionFilter):
                self.rfilter = v
        if self.rfilter is None:
            from ..rfilters import GaussianFilter
            self.rfilter = GaussianFilter(Properties("gaussian"))

    @property
    def size(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def has_alpha(self) -> bool:
        return "a" in self.pixel_format.lower()

    @property
    def channel_count(self) -> int:
        # RGB + [A] + W (reference hdrfilm develop: base_ch = alpha ? 5 : 4)
        return 5 if self.has_alpha else 4

    @property
    def weight_index(self) -> int:
        return 4 if self.has_alpha else 3


@register_plugin("film", "hdrfilm")
class HDRFilm(Film):
    pass


@register_plugin("film", "specfilm")
class SpecFilm(Film):
    """Spectral film (reference src/films/specfilm.cpp): one channel per
    sensor response function (SRF), each accumulating the MC estimate of
    integral L(lambda) * SRF_k(lambda) d lambda. Requires the tpu_spectral
    variant (hero wavelengths); in tpu_rgb it degrades to hdrfilm
    behavior. SRFs are regular/irregular spectrum children, channels in
    alphabetical key order (specfilm.cpp:148-167)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..spectra import Spectrum
        srfs = []
        for key, v in props.objects():
            if isinstance(v, Spectrum) and hasattr(v, "srf_table"):
                srfs.append((key, v))
        srfs.sort(key=lambda kv: kv[0])
        self.srf_names = [k for k, _ in srfs]
        self.srfs = [v for _, v in srfs]

    def srf_tables(self):
        return [srf.srf_table() for srf in self.srfs]

    @property
    def channel_count(self) -> int:
        if not self.srfs:
            return super().channel_count
        return len(self.srfs) + 1          # K SRF channels + weight

    @property
    def weight_index(self) -> int:
        if not self.srfs:
            return super().weight_index
        return len(self.srfs)


# ---------------------------------------------------------------------------
# Device-side accumulation
# ---------------------------------------------------------------------------

def block_create(width: int, height: int, n_channels: int, dtype=jnp.float32):
    return jnp.zeros((n_channels, height, width), dtype=dtype)


def filter_reach(rfilter) -> int:
    """Max pixel-offset a sample's filter footprint can reach (the K of
    the (2K+1)^2 shifted-image splat decomposition)."""
    if rfilter.is_box:
        return 0
    count = int(math.ceil(2.0 * float(rfilter.radius)))
    return count // 2 + (count % 2)


def block_splat_wavefront(block, rfilter, pos_x, pos_y, values: List,
                          active, W: int, H: int, spp: int,
                          pad_rows: int = 0, row0=0, strip_rows: int = None):
    """Accumulate a pixel-major wavefront into the block.

    ``pos_x/pos_y``: continuous GLOBAL sample positions (N,). ``values``:
    list of C (N,) channel arrays. ``block`` has rows + 2*pad_rows rows;
    ``pad_rows > 0`` keeps cross-row filter taps for shard-boundary merging
    (parallel/render.py) instead of clipping them.

    Strip mode (``strip_rows`` set): the wavefront covers only pixel rows
    [row0, row0 + strip_rows) of the frame — lane i belongs to global
    pixel row0*W + i // spp. ``row0`` may be a traced scalar (the fused
    strip-pass loop); requires ``pad_rows >= filter_reach(rfilter)`` so
    cross-strip taps land in canvas rows without data-dependent clipping
    (they are either merged by the neighboring strip's own writes — both
    strips add into the same canvas — or fall into the discarded pad,
    matching the full-frame path's border clipping).

    Implements the reference's filter-footprint weighting
    (imageblock.cpp:263-344, continuous JIT path) without scatters.
    """
    C = block.shape[0]
    HC = block.shape[1]         # canvas rows
    n = pos_x.shape[0]
    values = [jnp.where(active, v, 0.0) for v in values]

    strip = strip_rows is not None
    rows = strip_rows if strip else H
    lpix = jnp.arange(n, dtype=jnp.uint32) // jnp.uint32(spp)
    pix_x = (lpix % jnp.uint32(W)).astype(jnp.int32)
    pix_y = (lpix // jnp.uint32(W)).astype(jnp.int32)
    if strip:
        pix_y = pix_y + jnp.int32(row0)

    def segsum(v):
        return v.reshape(rows * W, spp).sum(axis=-1).reshape(rows, W)

    def window_add(blk, imgs, y0, x0: int, w: int):
        """blk[:, y0:y0+rows, x0:x0+w] += imgs (y0 may be traced)."""
        if not strip:
            return blk.at[:, y0:y0 + rows, x0:x0 + w].add(imgs)
        win = jax.lax.dynamic_slice(blk, (0, y0, x0), (C, rows, w))
        return jax.lax.dynamic_update_slice(blk, win + imgs, (0, y0, x0))

    y_base = pad_rows + jnp.int32(row0) if strip else pad_rows

    if rfilter.is_box:
        # samples land in their own pixel (the integrator passes pixel
        # centers for box, reference imageblock.cpp:471)
        imgs = jnp.stack([segsum(v) for v in values])
        return window_add(block, imgs, y_base, 0, W)

    radius = float(rfilter.radius)
    count = int(math.ceil(2.0 * radius))
    K = count // 2 + (count % 2)  # max |offset| from own pixel
    if strip and pad_rows < K:
        raise ValueError(
            f"strip splat needs pad_rows >= {K} for this filter")

    pos_fx = pos_x - 0.5
    pos_fy = pos_y - 0.5
    lo_x = jnp.ceil(pos_fx - radius).astype(jnp.int32)
    lo_y = jnp.ceil(pos_fy - radius).astype(jnp.int32)
    hi_x = jnp.floor(pos_fx + radius).astype(jnp.int32)
    hi_y = jnp.floor(pos_fy + radius).astype(jnp.int32)

    # filter weights for each tap (dy, dx in [0, count))
    wx = [rfilter.eval(lo_x.astype(pos_x.dtype) - pos_fx + k)
          for k in range(count)]
    wy = [rfilter.eval(lo_y.astype(pos_y.dtype) - pos_fy + k)
          for k in range(count)]
    vx = [(lo_x + k <= hi_x) for k in range(count)]
    vy = [(lo_y + k <= hi_y) for k in range(count)]

    rel_x = lo_x - pix_x        # in [-K, K]
    rel_y = lo_y - pix_y

    for dy_off in range(-K, K + 1):
        # weight along y for taps landing at pixel offset dy_off
        wsum_y = None
        for k in range(count):
            m = (rel_y + k == dy_off) & vy[k]
            term = jnp.where(m, wy[k], 0.0)
            wsum_y = term if wsum_y is None else wsum_y + term
        for dx_off in range(-K, K + 1):
            wsum_x = None
            for k in range(count):
                m = (rel_x + k == dx_off) & vx[k]
                term = jnp.where(m, wx[k], 0.0)
                wsum_x = term if wsum_x is None else wsum_x + term
            wgt = wsum_y * wsum_x
            # dense per-pixel partial image, then shifted add: a sample in
            # source row r lands at canvas row pad_rows + r + δ; clip to the
            # canvas (with pad_rows >= K no y-clipping occurs)
            sx0 = max(0, -dx_off)
            wdt = W - abs(dx_off)
            if strip:
                imgs = jnp.stack([segsum(v * wgt)[:, sx0:sx0 + wdt]
                                  for v in values])
                block = window_add(block, imgs, y_base + dy_off,
                                   max(0, dx_off), wdt)
                continue
            dlo_y = max(0, pad_rows + dy_off)
            dhi_y = min(pad_rows + H + dy_off, HC)
            slo_y = dlo_y - (pad_rows + dy_off)
            dst_y = slice(dlo_y, dhi_y)
            src_y = slice(slo_y, slo_y + (dhi_y - dlo_y))
            dst_x = slice(max(0, dx_off), W + min(0, dx_off))
            src_x = slice(sx0, sx0 + wdt)
            for c in range(C):
                img = segsum(values[c] * wgt)
                block = block.at[c, dst_y, dst_x].add(img[src_y, src_x])
    return block


def block_splat_scatter(block, px, py, values: List, active,
                        W: int, H: int, row0: int = 0):
    """Scatter-free random-pixel splat (the light-tracer's ImageBlock::put,
    reference imageblock.cpp:119-127): sort the records by flat pixel id,
    segment-sum via cumulative sums, and add the dense per-pixel image.

    One variadic sort + cumsum + a sort-based searchsorted replaces a
    scatter-add and, unlike atomics, is deterministic. ``values`` is a list of
    C (N,) channel arrays added to block[c, row0+py, px]."""
    C = len(values)
    n = px.shape[0]
    npix = W * H
    pid = jnp.where(active, py * W + px, npix).astype(jnp.int32)
    ops = [pid] + [jnp.where(active, v, 0.0).astype(jnp.float32)
                   for v in values]
    sorted_ops = jax.lax.sort(ops, num_keys=1)
    pid_s = sorted_ops[0]
    # end index (exclusive) of every pixel's segment in the sorted order
    ends = jnp.searchsorted(pid_s, jnp.arange(npix, dtype=jnp.int32),
                            side="right", method="sort")
    for c in range(C):
        csum = jnp.cumsum(sorted_ops[1 + c])
        tot = jnp.concatenate([jnp.zeros(1, csum.dtype), csum])[ends]
        per_pix = jnp.diff(jnp.concatenate([jnp.zeros(1, tot.dtype), tot]))
        block = block.at[c, row0:row0 + H].add(per_pix.reshape(H, W))
    return block


def develop(block, has_alpha: bool, weight_idx: int = None):
    """value / weight per channel (reference hdrfilm.cpp:305+); the weight
    channel itself is dropped. Returns (H, W, C-1) with AOV channels (if
    any) after RGB[A]."""
    if weight_idx is None:
        weight_idx = 4 if has_alpha else 3
    w = block[weight_idx]
    safe = jnp.where(w > 0.0, w, 1.0)
    keep = jnp.concatenate([block[:weight_idx], block[weight_idx + 1:]],
                           axis=0)
    vals = keep / safe[None]
    vals = jnp.where((w > 0.0)[None], vals, 0.0)
    return jnp.moveaxis(vals, 0, -1)


__all__ = ["Film", "HDRFilm", "SpecFilm", "block_create",
           "block_splat_wavefront", "block_splat_scatter", "develop"]
