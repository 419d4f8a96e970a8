"""chip_smoke.py: it refuses to run without a GPU or outside the repo, and
its phases and checks work at a tiny size on the CPU (kernel in interpret
mode, virtual devices for the four-card path)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_gpu(tmp_path, alone):
    """No accelerator (and, alone, no repo): non-zero exit, no result."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    out = _run(tmp_path, str(script))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_parity_phase_interpreted():
    res = cs.kernel_parity(n=1024, interpret=True)
    for name in ("camera", "bounce"):
        assert res[name]["lanes"] == 1024
        assert res[name]["prim_agree"] == 1.0
        assert res[name]["any_agree"] == 1.0
    assert 0.0 < res["bounce"]["hit_frac"] <= 1.0


def test_canonical_phase_tiny():
    res = cs.canonical(res=8, spp=4, cmp_res=8, cmp_spp=4)
    assert res["res"] == "8x8" and res["render_s"] > 0.0
    assert res["vs_cpu"]["pix_within"] == 1.0


def test_compare_hits_rejects_wrong_payload():
    import jax.numpy as jnp
    from mitsuba3dopplertof_tpu.render.types import HitRecord
    n = 16
    z = jnp.zeros(n)
    h = HitRecord(jnp.ones(n), jnp.arange(n), jnp.zeros(n, jnp.int32),
                  z, z, z, z, z + 1, z, z, z + 1, z, z)
    assert cs.compare_hits(h, h)["prim_agree"] == 1.0
    with pytest.raises(AssertionError):
        cs.compare_hits(h._replace(uv_u=z + 0.5), h)
    with pytest.raises(AssertionError):
        cs.compare_hits(h._replace(prim=jnp.arange(n)[::-1]), h)


@pytest.mark.parametrize("noise,ok", [(0.0, True), (1e-6, True),
                                      (1e-1, False)])
def test_compare_devices_tolerance(noise, ok):
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(8, 8, 3)).astype(np.float32)
    img = ref * (1.0 + noise * rng.normal(size=ref.shape))
    if ok:
        assert cs.compare_devices(img, ref)["pix_within"] >= 0.99
    else:
        with pytest.raises(AssertionError):
            cs.compare_devices(img, ref)


def test_four_card_path_on_virtual_devices():
    """The --four phase on four of the suite's virtual CPU devices."""
    res = cs.four_cards(res=16, spp=8, spp_per_pass=2)
    assert len(res["per_device"]) == 4
    assert res["max_rel"] <= cs.FOUR_MAX_REL


def test_last_line_contract(monkeypatch, capsys):
    """With the device check and phases stubbed, main() prints the card
    line and then exactly one JSON object."""
    class Dev:
        platform, device_kind = "gpu", "Stub H100"
    monkeypatch.setattr(cs, "require_gpu", lambda: [Dev()])
    monkeypatch.setattr(cs, "card_name_and_power", lambda: "Stub, 700 W")
    for name in ("kernel_parity", "canonical", "hero"):
        monkeypatch.setattr(cs, name, lambda: {"stub": True})
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "Stub, 700 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "Stub H100", "count": 1}}
