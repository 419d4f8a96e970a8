"""Multi-host data parallelism (SURVEY.md §2.6; reference
program_runner.py:15-23 seed-split pattern): a 2-process x 4-virtual-CPU
jax.distributed topology driven through subprocesses, in both modes:

  * lanes  — one global 8-device mesh; result must be bit-identical to
             the single-process 8-device render (global lane ids keep the
             correlated RNG layout contract).
  * passes — each host renders its share of the seeds locally and blocks
             sum across DCN; result must equal the same pass-split run
             single-process.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, os, sys
import numpy as np
mode, port, pid = sys.argv[1], sys.argv[2], int(sys.argv[3])
# distributed init must precede ANY backend touch, including the package
# import (it enables the persistent compilation cache); the platform is
# forced through jax.config so the workers stay on the CPU
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4")
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                           num_processes=2, process_id=pid)
sys.path.insert(0, %(repo)r)
from mitsuba3dopplertof_tpu.parallel.multihost import render_multihost
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
import mitsuba3dopplertof_tpu as mi
scene = mi.load_file("/root/reference/configs_example/scene.xml",
                     resx=16, resy=16)
img = render_multihost(scene.integrator, scene, spp=8, seed=3, mode=mode)
if pid == 0:
    np.save(os.environ["MI_MH_OUT"], np.asarray(img))
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _run_pair(mode, tmp_path):
    port = str(_free_port())
    out = str(tmp_path / f"mh_{mode}.npy")
    env = dict(os.environ, MI_MH_OUT=out, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    script = _WORKER % {"repo": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, mode, port, str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-4000:]
    return np.load(out)


@pytest.fixture(scope="module")
def single_process_ref():
    """8-virtual-device single-process render of the same scene."""
    port = None
    script = r"""
import os, sys
import numpy as np
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, %(repo)r)
import jax
jax.config.update("jax_platforms", "cpu")
import mitsuba3dopplertof_tpu as mi
from mitsuba3dopplertof_tpu.parallel import render_sharded, make_mesh
scene = mi.load_file("/root/reference/configs_example/scene.xml",
                     resx=16, resy=16)
img = render_sharded(scene.integrator, scene,
                     mesh=make_mesh(jax.devices()), spp=8, seed=3)
np.save(os.environ["MI_MH_OUT"], np.asarray(img))
""" % {"repo": REPO}
    import tempfile
    out = tempfile.mktemp(suffix=".npy")
    env = dict(os.environ, MI_MH_OUT=out)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, timeout=600)
    assert r.returncode == 0, r.stderr.decode(errors="replace")[-4000:]
    return np.load(out)


def test_multihost_lanes_matches_single_process(single_process_ref,
                                                tmp_path):
    img = _run_pair("lanes", tmp_path)
    assert img.shape == single_process_ref.shape
    np.testing.assert_allclose(img, single_process_ref, rtol=1e-6,
                               atol=1e-7)


def test_multihost_pass_split_runs(tmp_path):
    img = _run_pair("passes", tmp_path)
    assert np.isfinite(img).all()
    assert img.max() > 0


def test_host_pass_seeds_partition():
    from mitsuba3dopplertof_tpu.parallel.multihost import host_pass_seeds
    a = host_pass_seeds(10, 6, host_id=0, n_hosts=2)
    b = host_pass_seeds(10, 6, host_id=1, n_hosts=2)
    assert sorted(a + b) == [10, 11, 12, 13, 14, 15]
