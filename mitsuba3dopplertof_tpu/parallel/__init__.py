"""Multi-chip scale-out.

The reference is single-device; its only "collective" is an in-device
atomic scatter into the film (reference src/render/imageblock.cpp:119-127).
The layout (SURVEY.md §2.6): pure data parallelism over pixels x spp on
a 1-D device mesh — each device renders a contiguous
pixel-major lane range (correlation groups never straddle shards because
shards split on pixel boundaries and time_correlate_number divides spp),
accumulates its rows of the film, and a halo exchange with its neighbours
(or one psum) merges films at develop time. Deterministic: fixed tree-reduction order, unlike
the reference's atomics.

Multi-host runs use the same program under jax.distributed with per-host
seed offsets, mirroring the reference's multi-pass seed=i pattern
(reference doppler_tutorials/src/program_runner.py:15-23).
"""

from .render import render_sharded, make_mesh
from .multihost import init_multihost, render_multihost, host_pass_seeds

__all__ = ["render_sharded", "make_mesh", "init_multihost",
           "render_multihost", "host_pass_seeds"]
