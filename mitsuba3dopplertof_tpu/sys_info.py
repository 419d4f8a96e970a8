"""System-configuration report for bug reports and issue triage
(the role of reference src/python/python/sys_info.py, rebuilt for the
JAX/GPU stack): python -m mitsuba3dopplertof_tpu.sys_info
"""

from __future__ import annotations

import os
import platform
import sys


def collect() -> str:
    lines = []
    add = lines.append
    add("mitsuba3dopplertof_tpu system info")
    add("-" * 40)
    import mitsuba3dopplertof_tpu as mi
    add(f"package version  : {mi.__version__}")
    add(f"variants         : {', '.join(mi.variants())}")
    add(f"python           : {sys.version.split()[0]} "
        f"({platform.python_implementation()})")
    add(f"platform         : {platform.platform()}")
    add(f"machine          : {platform.machine()}, "
        f"{os.cpu_count()} logical CPUs")
    try:
        import jax
        import jaxlib
        add(f"jax / jaxlib     : {jax.__version__} / {jaxlib.__version__}")
        add(f"default backend  : {jax.default_backend()}")
        try:
            devs = jax.devices()
            add(f"devices          : {[str(d) for d in devs]}")
        except Exception as e:                       # no usable backend
            add(f"devices          : unavailable ({type(e).__name__})")
        cache = jax.config.jax_compilation_cache_dir
        add(f"xla compile cache: {cache or 'disabled'}")
        flags = os.environ.get("XLA_FLAGS", "")
        if flags:
            add(f"XLA_FLAGS        : {flags}")
    except Exception as e:
        add(f"jax              : import failed ({e})")
    for pkg in ("numpy", "flax", "optax"):
        try:
            add(f"{pkg:<17}: "
                f"{__import__(pkg).__version__}")
        except Exception:
            add(f"{pkg:<17}: not available")
    toggles = [k for k in os.environ
               if k.startswith("MI_") or k == "JAX_PLATFORMS"]
    if toggles:
        add("env toggles      : "
            + ", ".join(f"{k}={os.environ[k]}" for k in sorted(toggles)))
    return "\n".join(lines)


def main() -> None:
    print(collect())


if __name__ == "__main__":
    main()
