"""mitsuba3dopplertof_tpu — a Doppler Time-of-Flight renderer in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
juhyeonkim95/Mitsuba3DopplerToF ("Doppler Time-of-Flight Rendering",
SIGGRAPH Asia 2023): a Monte Carlo path tracer whose radiance is weighted by
the time-correlation of amplitude-modulated illumination against a sensor
modulation waveform, with correlated/antithetic time sampling and rigid-body
motion blur — redesigned for accelerators (SoA wavefronts, masked type
dispatch, counter-exact functional RNG, shard_map scale-out) rather than
ported. It runs on NVIDIA GPUs and, more slowly, on the CPU.

Public API mirrors the reference's Python surface:

    import mitsuba3dopplertof_tpu as mi
    scene = mi.load_file("scene.xml")
    img = mi.render(scene, spp=64, seed=0)
"""

from __future__ import annotations

__version__ = "0.1.0"

import os as _os

# Persistent XLA compilation cache. A render program takes tens of seconds
# to compile; the cache makes that a once-per-scene-shape cost across
# processes. Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself
# and nothing is set here; otherwise the cache lives at a fixed directory
# inside the checkout (a fixed path, so later processes find it again).
# Opt out with MI_NO_COMPILE_CACHE=1.
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _compile_cache_dir(environ=_os.environ):
    """Directory this package sets as JAX's compile cache (None: leave the
    cache to JAX's own settings)."""
    if environ.get("MI_NO_COMPILE_CACHE") or environ.get(
            "JAX_COMPILATION_CACHE_DIR"):
        return None
    return COMPILE_CACHE_DIR


if _compile_cache_dir() is not None:
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", _compile_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

# NaN sanitizer (SURVEY §5 race/sanitizer analog, in place of running the
# reference under compute-sanitizer): with MI_DEBUG_NANS=1 every jitted
# program that produces a NaN re-runs op-by-op and raises at the first
# NaN-producing primitive. Combine with MI_NO_FUSED_PASSES=1 to bisect by
# pass.
if _os.environ.get("MI_DEBUG_NANS"):
    import jax as _jax_dbg

    _jax_dbg.config.update("jax_debug_nans", True)

# plugin registration side effects
from . import shapes as _shapes            # noqa: F401
from . import bsdfs as _bsdfs              # noqa: F401
from . import emitters as _emitters        # noqa: F401
from . import sensors as _sensors          # noqa: F401
from . import films as _films              # noqa: F401
from . import rfilters as _rfilters        # noqa: F401
from . import samplers as _samplers        # noqa: F401
from . import integrators as _integrators  # noqa: F401
from . import ad                            # noqa: F401  (AD integrators)
from . import textures as _textures        # noqa: F401
from . import spectra as _spectra          # noqa: F401
from . import media as _media              # noqa: F401
from . import volumes as _volumes          # noqa: F401

from .io.dict_loader import load_dict
from .io.xml import xml_to_dict
from .io.xml_writer import dict_to_xml
from .utils.params import traverse, SceneParameters
from .render.ad import (render_grad, value_and_render_grad,
                        render_doppler_grad)
from .render.scene import Scene
from .core.properties import Properties, registered_plugins
from .core.fresolver import file_resolver, resolve_filename
from .core.stream import (Stream, FileStream, MemoryStream, ZStream,
                          DummyStream, MemoryMappedFile)
from .utils.polvis import polvis
from .utils import plots
from . import util                          # mi.util.write_bitmap etc.
from .util import (cornell_box, Thread, TensorXf, Point2f,
                   Point3f, Vector3f, Color3f, ScalarPoint2f,
                   ScalarPoint3f, ScalarVector3f, ScalarColor3f)
from .core.transform import (Transform4f, ScalarTransform4f,
                             AnimatedTransform)
from .core import mueller                   # mi.mueller.* (reference parity)
from .core import microfacet
from .core import math as math              # mi.math.rlgamma etc.
from .core.fresnel import (fresnel_dielectric, fresnel_conductor,
                           reflect, refract)
from .core.mueller import fresnel_polarized
from .core.struct import Struct, StructConverter, FieldFlags
from .bitmap_compat import Bitmap          # mi.Bitmap tutorial-compat
from .utils.denoiser import Denoiser
from .core.logger import (set_log_level, log_level, log, trace_to,
                          profile_phase, ProgressReporter,
                          TRACE, DEBUG, INFO, WARN, ERROR)


def load_file(path: str, **params):
    """Parse + build a scene from Mitsuba XML (reference xml.cpp:1483).
    The scene file's directory is scoped onto the file resolver so
    relative asset filenames resolve against the scene location."""
    import os as _os
    str_params = {k: str(v) for k, v in params.items()}
    with file_resolver().scoped(_os.path.dirname(_os.path.abspath(path))):
        return load_dict(xml_to_dict(path, str_params, is_file=True))


def load_string(text: str, **params):
    """reference xml.cpp:1437 load_string."""
    str_params = {k: str(v) for k, v in params.items()}
    return load_dict(xml_to_dict(text, str_params, is_file=False))


def render(scene: Scene, spp: int = 0, seed: int = 0, sensor=None,
           integrator=None):
    """Render a scene; ``integrator`` may override the scene's own
    (the reference allows the same, §3.2 of SURVEY.md)."""
    integ = integrator if integrator is not None else scene.integrator
    if integ is None:
        raise RuntimeError("No integrator: pass one or add it to the scene")
    return integ.render(scene, sensor=sensor, seed=seed, spp=spp)


_VARIANT = "tpu_rgb"

_KNOWN_VARIANTS = ["tpu_rgb", "tpu_spectral", "tpu_mono",
                   "tpu_rgb_polarized", "tpu_spectral_polarized"]


def variants():
    return list(_KNOWN_VARIANTS)


def variant():
    return _VARIANT


def set_variant(*names):
    """Select the rendering variant (the reference's mitsuba.set_variant):
    tpu_rgb (default), tpu_spectral (hero-wavelength triplets with sigmoid
    spectral upsampling + analytic CIE conversion), tpu_mono (luminance),
    tpu_rgb_polarized (Mueller transport), tpu_spectral_polarized (both).
    Affects scenes compiled afterwards."""
    global _VARIANT
    for n in names:
        if n in _KNOWN_VARIANTS:
            _VARIANT = n
            return n
    raise RuntimeError(f"No supported variant in {names}; "
                       f"available: {_KNOWN_VARIANTS}")


__all__ = ["load_file", "load_string", "load_dict", "render", "Scene", "variant",
           "Properties", "registered_plugins", "variants", "set_variant",
           "xml_to_dict", "dict_to_xml", "traverse", "SceneParameters",
           "render_grad", "value_and_render_grad", "render_doppler_grad",
           "util", "cornell_box", "Thread", "TensorXf", "Point3f",
           "Vector3f", "Color3f", "ScalarPoint3f", "ScalarVector3f",
           "ScalarColor3f", "Point2f", "ScalarPoint2f",
           "Transform4f", "ScalarTransform4f", "AnimatedTransform",
           "Bitmap", "mueller", "microfacet", "math", "fresnel_dielectric",
           "fresnel_conductor", "fresnel_polarized", "reflect", "refract",
           "__version__"]
