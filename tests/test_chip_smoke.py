"""chip_smoke.py's phases at tiny size on the CPU, and its refusal to run
without a GPU. The full-size run happens on the card."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as C  # noqa: E402

from complex_prompt_diffusion_tpu.pipeline import ModelBundle  # noqa: E402


@pytest.fixture(scope="module")
def bundles():
    b32 = ModelBundle.random("tiny", seed=0)
    return b32, b32.cast("float32")


def test_devices_phase():
    info = C.phase_devices()
    assert info == {"platform": "cpu", "kind": "cpu", "count": len(jax.devices())}


def test_card_line_is_one_line():
    line = C.card_line()
    assert isinstance(line, str) and "\n" not in line


def test_kernels_phase_tiny():
    rows = C.phase_kernels(C.TINY)
    assert len(rows) == len(C.TINY.attn) + len(C.TINY.gn)
    assert all(r["ok"] for r in rows)
    # the CPU takes the plain route everywhere
    assert {r["route"] for r in rows if r["op"] == "attention"} == {"xla"}


def test_kernels_phase_fails_outside_tolerance(monkeypatch):
    monkeypatch.setattr(C, "ATTN_TOL", 0.0)
    with pytest.raises(C.SmokeFailure, match="outside tolerance"):
        C.phase_kernels(C.TINY)


def test_txt2img_phase_tiny(bundles):
    _, b = bundles
    out = C.phase_txt2img(b, C.TINY)
    assert out["compile_and_first_s"] > 0 and len(out["request_s"]) == 2
    assert out["temp_size_in_bytes"] is not None


def test_parity_phase_tiny(bundles):
    b32, b = bundles
    row = C.phase_parity(b32, b, C.TINY)
    # f32 against f32 on the CPU: the two paths agree to rounding
    assert row["latent_rel_l2"] < 1e-4 and row["u8_max"] <= 1


def test_multichip_phase_on_four_virtual_devices(bundles):
    b32, b = bundles
    rows = C.phase_multichip(b32, b, C.TINY, jax.devices()[:4])
    paths = [r for r in rows if "what" in r]
    faults = [r for r in rows if "planted_fault" in r]
    assert [r["rel_l2"] < C.TINY.multi_tol for r in paths] == [True] * 3
    assert [r["rel_l2"] > C.TINY.multi_tol for r in faults] == [True] * 3


def test_multichip_phase_fails_when_a_planted_fault_passes(bundles):
    # a bound too loose to see a one-shard fault is itself a failure
    b32, b = bundles
    loose = dataclasses.replace(C.TINY, multi_tol=1e9)
    with pytest.raises(C.SmokeFailure, match="planted fault"):
        C.phase_multichip(b32, b, loose, jax.devices()[:4])


def test_gpu_tests_phase_refuses_when_none_ran():
    # off the GPU every gpu-marked test skips: the phase must not pass
    with pytest.raises(C.SmokeFailure, match="no gpu test ran"):
        C.phase_gpu_tests()


def _run(cmd, cwd, env_extra=None):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **(env_extra or {})}
    return subprocess.run(
        cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


@pytest.mark.parametrize("args", [[], ["--chips", "4"]])
def test_exits_nonzero_without_gpu(args):
    r = _run([sys.executable, str(REPO / "chip_smoke.py"), *args], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no accelerator" in r.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run([sys.executable, "chip_smoke.py"], tmp_path,
             {"PYTHONPATH": ""})
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
