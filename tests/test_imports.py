"""The main path imports nothing beyond JAX, numpy and the guaranteed
packages: a tiny txt2img runs with the optional ones blocked."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

BLOCKED = ("lark", "regex", "PIL", "cv2", "torch", "yaml", "safetensors", "orbax")


def test_main_path_runs_with_optional_packages_blocked():
    code = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None  # any import of it raises ImportError
        from complex_prompt_diffusion_tpu.pipeline import (
            ModelBundle, RenderConfig, txt2img)
        from complex_prompt_diffusion_tpu.manager import DiffusionModelManager
        from complex_prompt_diffusion_tpu.prompts.compose import (
            CompositionalPrompt)
        b = ModelBundle.random("tiny")
        imgs, _ = txt2img(b, "a cat", cfg=RenderConfig(
            steps=2, width=32, height=32))
        assert imgs.shape == (1, 8, 8, 3), imgs.shape
        p = CompositionalPrompt("a forest", bundle=b)
        p.add_masked_filter("the sun", "left_third_valid", strength=0.7)
        imgs, _ = p.render(steps=2, width=32, height=32)
        assert imgs.shape == (1, 8, 8, 3), imgs.shape
        img = DiffusionModelManager(bundle=b).process_txt2img(
            {{"prompt": "a dog", "render": {{"steps": 2, "W": 32, "H": 32}}}})
        assert img.shape == (1, 8, 8, 3), img.shape
        for name in {BLOCKED!r}:
            assert sys.modules[name] is None, name
        print("main path ok")
    """)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "main path ok" in r.stdout


def test_schedule_grammar_names_its_package_when_lark_is_missing():
    code = textwrap.dedent("""
        import sys
        sys.modules["lark"] = None
        from complex_prompt_diffusion_tpu.prompts import expand_schedule
        try:
            expand_schedule("[a:b:0.5]", 10)
        except ImportError as e:
            assert "lark" in str(e), e
            print("named")
    """)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "named" in r.stdout
