"""Multi-chip sharding tests.

These run in a SUBPROCESS on an 8-device virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8), the standard way to
validate multi-device programs without the devices (SURVEY.md §4.5); the
subprocess gets a fresh backend whatever the parent process initialised.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

_ENV = {
    **os.environ,
    "JAX_PLATFORMS": "cpu",
    "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
    "HF_HUB_OFFLINE": "1",
}


REPO = Path(__file__).resolve().parents[1]


def _run(code: str, timeout=520):
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        env=_ENV, capture_output=True, text=True, timeout=timeout,
        cwd=REPO,
    )


class TestMultichip:
    def test_dryrun_training_step(self):
        r = _run(
            """
            import importlib.util, jax
            assert jax.device_count() == 8, jax.devices()
            spec = importlib.util.spec_from_file_location("graft", "__graft_entry__.py")
            g = importlib.util.module_from_spec(spec); spec.loader.exec_module(g)
            g.dryrun_multichip(8)
            """
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert "dryrun_multichip ok" in r.stdout

    def test_data_parallel_render(self):
        r = _run(
            """
            import jax, numpy as np
            from jax.sharding import NamedSharding, PartitionSpec as P
            from complex_prompt_diffusion_tpu.parallel import make_mesh, replicate, shard_batch
            from complex_prompt_diffusion_tpu.pipeline import ModelBundle, RenderConfig, sample_latents, make_guidance_spec

            mesh = make_mesh(data=8, model=1)
            b = ModelBundle.random("tiny")
            # replicate weights, shard the 8-frame batch over the data axis
            import dataclasses
            b = dataclasses.replace(b, unet_params=replicate(mesh, b.unet_params))
            spec = make_guidance_spec(b, "a cat walking")
            cfg = RenderConfig(steps=2, width=32, height=32, batch_size=8)
            import jax.numpy as jnp
            x_T = jax.random.normal(jax.random.PRNGKey(0), (8, 4, 4, 4), jnp.float32)
            x_T = jax.device_put(x_T, NamedSharding(mesh, P("data")))
            with mesh:
                lat = sample_latents(b, spec, cfg, x_init=x_T)
            lat = np.asarray(lat)
            assert lat.shape == (8, 4, 4, 4)
            assert np.isfinite(lat).all()
            print("data-parallel render ok")
            """
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert "data-parallel render ok" in r.stdout

    def test_data_parallel_render_with_token_reduction(self):
        """Token reduction (ops/tome.py) is pure XLA (pool/gather/matmul),
        so it must compose with the sharded render path — GSPMD partitions
        the batch dim through the merge machinery."""
        r = _run(
            """
            import jax, numpy as np, dataclasses
            from jax.sharding import NamedSharding, PartitionSpec as P
            from complex_prompt_diffusion_tpu.parallel import make_mesh, replicate
            from complex_prompt_diffusion_tpu.pipeline import ModelBundle, RenderConfig, sample_latents, make_guidance_spec

            mesh = make_mesh(data=8, model=1)
            b = ModelBundle.random("tiny")
            b = dataclasses.replace(
                b,
                unet_params=replicate(mesh, b.unet_params),
                unet_cfg=dataclasses.replace(b.unet_cfg, tome_min_seq=16),
            )
            spec = make_guidance_spec(b, "a cat walking")
            import jax.numpy as jnp
            for mode in ("downsample", "merge"):
                # fresh init per run: sample_latents donates the buffer
                x_T = jax.random.normal(jax.random.PRNGKey(0), (8, 4, 4, 4), jnp.float32)
                x_T = jax.device_put(x_T, NamedSharding(mesh, P("data")))
                cfg = RenderConfig(steps=2, width=32, height=32, batch_size=8,
                                   tome_ratio=0.4, tome_mode=mode)
                with mesh:
                    lat = sample_latents(b, spec, cfg, x_init=x_T)
                lat = np.asarray(lat)
                assert lat.shape == (8, 4, 4, 4)
                assert np.isfinite(lat).all()
                print("sharded render +" + mode + " ok")
            """
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert "sharded render +downsample ok" in r.stdout
        assert "sharded render +merge ok" in r.stdout

    def test_data_parallel_render_with_deepcache(self):
        """Advisor r3: the lax.cond-carried deep feature under GSPMD was an
        untested combination. DP mesh: the deepcache render must match the
        single-device deepcache render (weights replicated, batch sharded);
        TP: same property with the UNet weights sharded over "model"."""
        r = _run(
            """
            import jax, numpy as np, dataclasses
            import jax.numpy as jnp
            from jax.sharding import NamedSharding, PartitionSpec as P
            from complex_prompt_diffusion_tpu.parallel import make_mesh, replicate
            from complex_prompt_diffusion_tpu.parallel.tp import shard_bundle
            from complex_prompt_diffusion_tpu.pipeline import (
                ModelBundle, RenderConfig, sample_latents, make_guidance_spec)

            b = ModelBundle.random("tiny")
            spec = make_guidance_spec(b, "a cat walking")
            cfg = RenderConfig(steps=4, width=32, height=32, batch_size=8,
                               deepcache_interval=2)
            rs = np.random.RandomState(0)
            noises = jnp.asarray(rs.randn(4, 8, 4, 4, 4), np.float32)
            x_T0 = jnp.asarray(rs.randn(8, 4, 4, 4), np.float32)
            ref = np.asarray(sample_latents(
                b, spec, cfg, x_init=jnp.array(x_T0), noises=noises))

            mesh = make_mesh(data=8, model=1)
            db = dataclasses.replace(b, unet_params=replicate(mesh, b.unet_params))
            x_T = jax.device_put(jnp.array(x_T0), NamedSharding(mesh, P("data")))
            with mesh:
                lat = np.asarray(sample_latents(
                    db, spec, cfg, x_init=x_T, noises=noises))
            d = float(np.abs(lat - ref).max())
            assert d < 2e-4, d
            print("dp deepcache ok", d)

            tb = shard_bundle(b, make_mesh(model=2))
            lat_tp = np.asarray(sample_latents(
                tb, spec, cfg, x_init=jnp.array(x_T0), noises=noises))
            d = float(np.abs(lat_tp - ref).max())
            assert d < 2e-3, d
            print("tp deepcache ok", d)
            """
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert "dp deepcache ok" in r.stdout
        assert "tp deepcache ok" in r.stdout

    @pytest.mark.slow  # full SD-1.5 compile in a subprocess (minutes)
    def test_entry_compiles(self):
        r = _run(
            """
            import importlib.util, jax
            spec = importlib.util.spec_from_file_location("graft", "__graft_entry__.py")
            g = importlib.util.module_from_spec(spec); spec.loader.exec_module(g)
            fn, args = g.entry()
            lowered = jax.jit(fn).lower(*args)
            compiled = lowered.compile()
            print("entry compiled ok")
            """,
            timeout=540,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        assert "entry compiled ok" in r.stdout


class TestTensorParallel:
    def test_tp_matches_single_device(self):
        r = _run("""
            import numpy as np, jax
            from jax.sharding import PartitionSpec as P
            from complex_prompt_diffusion_tpu.pipeline import (
                ModelBundle, RenderConfig, txt2img)
            from complex_prompt_diffusion_tpu.parallel.mesh import make_mesh
            from complex_prompt_diffusion_tpu.parallel.tp import (
                shard_bundle, unet_tp_shardings)

            b = ModelBundle.random("tiny")
            cfg = RenderConfig(steps=3, width=32, height=32, seed=5)
            _, ref = txt2img(b, "a cat", cfg=cfg, decode=False)

            mesh = make_mesh(model=4)  # 2 x 4 over 8 CPU devices
            sh = unet_tp_shardings(b.unet_params, mesh)
            blk = sh["input_blocks"][1][1]["blocks"][0]
            assert blk["attn1"]["to_q"]["kernel"].spec == P(None, "model"), blk
            assert blk["attn1"]["to_out"]["kernel"].spec == P("model", None)
            assert blk["ff"]["proj"]["kernel"].spec == P(None, "model")
            assert blk["norm1"]["scale"].spec == P()

            tb = shard_bundle(b, mesh)
            k = tb.unet_params["input_blocks"][1][1]["blocks"][0]["attn1"]["to_q"]["kernel"]
            assert len(k.sharding.device_set) == 8
            _, tp = txt2img(tb, "a cat", cfg=cfg, decode=False)
            d = float(np.abs(np.asarray(ref) - np.asarray(tp)).max())
            assert d < 2e-4, d
            print("OK maxdiff", d)
        """)
        assert "OK" in r.stdout, (r.stdout[-500:], r.stderr[-2000:])

    def test_tp_pallas_kernels_compose(self):
        # every op partitions under tensor parallelism without a shard_map
        # wrapper: shard_bundle records the mesh on the bundle, and the
        # render with heads=2 sharded over model=2 matches the
        # single-device render
        r = _run("""
            import numpy as np
            from complex_prompt_diffusion_tpu.pipeline import (
                ModelBundle, RenderConfig, txt2img)
            from complex_prompt_diffusion_tpu.parallel.mesh import make_mesh
            from complex_prompt_diffusion_tpu.parallel.tp import shard_bundle

            b = ModelBundle.random("tiny")
            cfg = RenderConfig(steps=2, width=32, height=32, seed=3)
            _, ref = txt2img(b, "a cat", cfg=cfg, decode=False)

            mesh = make_mesh(model=2)  # 4 x 2: heads=2 shard over model
            tb = shard_bundle(b, mesh)
            assert tb.mesh is mesh and b.mesh is None
            _, tp = txt2img(tb, "a cat", cfg=cfg, decode=False)
            d = float(np.abs(np.asarray(ref) - np.asarray(tp)).max())
            assert d < 2e-3, d
            print("OK tp maxdiff", d)
        """)
        assert "OK" in r.stdout, (r.stdout[-500:], r.stderr[-2000:])

    def test_tp_conv_split_matches_single_device(self):
        # Cin-split conv kernels + GSPMD psum must stay numerically
        # equivalent
        r = _run("""
            import numpy as np
            from jax.sharding import PartitionSpec as P
            from complex_prompt_diffusion_tpu.pipeline import (
                ModelBundle, RenderConfig, txt2img)
            from complex_prompt_diffusion_tpu.parallel.mesh import make_mesh
            from complex_prompt_diffusion_tpu.parallel.tp import (
                shard_bundle, unet_tp_shardings)

            b = ModelBundle.random("tiny")
            cfg = RenderConfig(steps=2, width=32, height=32, seed=6)
            _, ref = txt2img(b, "a cat", cfg=cfg, decode=False)

            mesh = make_mesh(model=2)
            sh = unet_tp_shardings(b.unet_params, mesh, conv_split=True)
            k = sh["input_blocks"][1][0]["in_conv"]["kernel"]
            assert k.spec == P(None, None, "model", None), k.spec

            tb = shard_bundle(b, mesh, conv_split=True)
            _, tp = txt2img(tb, "a cat", cfg=cfg, decode=False)
            d = float(np.abs(np.asarray(ref) - np.asarray(tp)).max())
            assert d < 2e-4, d
            print("OK conv-split maxdiff", d)
        """)
        assert "OK" in r.stdout, (r.stdout[-500:], r.stderr[-2000:])

    def test_tp_uneven_shard_rejected(self):
        # tiny UNet inner dims (32/64) don't divide by 3 — but meshes are
        # powers of two here; verify a 8-way model shard of a 64-wide ff
        # still works (64 % 8 == 0) and produces finite output
        r = _run("""
            import numpy as np
            from complex_prompt_diffusion_tpu.pipeline import (
                ModelBundle, RenderConfig, txt2img)
            from complex_prompt_diffusion_tpu.parallel.mesh import make_mesh
            from complex_prompt_diffusion_tpu.parallel.tp import shard_bundle

            b = ModelBundle.random("tiny")
            tb = shard_bundle(b, make_mesh(model=8))
            _, lat = txt2img(tb, "a cat", cfg=RenderConfig(steps=2, width=32, height=32), decode=False)
            assert np.isfinite(np.asarray(lat)).all()
            print("OK")
        """)
        assert "OK" in r.stdout, (r.stdout[-500:], r.stderr[-2000:])


class TestCollectiveCounts:
    """VERDICT r3 item 5: pin the collective counts GSPMD inserts, so a
    future sharding-rule edit can't silently double the comm chain while
    every CPU-mesh correctness test still passes. Counts may shrink
    (improvement); growth fails."""

    # counted on the TP-8 SD-1.5 CFG UNet step on the CPU mesh: 48 ARs
    # (3 per transformer block) + 272 permutes + 112 all-to-alls from GSPMD
    # resharding between column-sharded attention activations and the
    # replicated conv path.
    TP8_SD15_MAX = {"all-reduce": 48, "collective-permute": 272,
                    "all-to-all": 112}

    def test_tp8_sd15_step_collectives_pinned(self):
        r = _run(
            """
            import re, jax, jax.numpy as jnp
            from complex_prompt_diffusion_tpu.models import unet as unet_mod
            from complex_prompt_diffusion_tpu.parallel.mesh import make_mesh
            from complex_prompt_diffusion_tpu.parallel.tp import shard_bundle
            from complex_prompt_diffusion_tpu.pipeline import ModelBundle

            tb = shard_bundle(ModelBundle.random("sd15"), make_mesh(model=8))
            cfg = tb.unet_cfg
            dt = cfg.compute_dtype
            x = jnp.zeros((2, 32, 32, cfg.in_channels), dt)
            t = jnp.zeros((2,), jnp.int32)
            ctx = jnp.zeros((2, 77, cfg.context_dim), dt)
            hlo = jax.jit(
                lambda p, x, t, c: unet_mod.unet_apply(cfg, p, x, t, c)
            ).lower(tb.unet_params, x, t, ctx).compile().as_text()
            for op in ("all-reduce", "collective-permute", "all-to-all"):
                n = len(re.findall(rf" {op}(?:-start)?\\(", hlo))
                print(f"count {op} {n}")
            """,
            timeout=560,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        counts = dict(
            (m.group(1), int(m.group(2)))
            for m in re.finditer(r"count (\S+) (\d+)", r.stdout)
        )
        assert set(counts) == set(self.TP8_SD15_MAX), counts
        assert counts["all-reduce"] > 0, counts  # sanity: TP really shards
        for op, mx in self.TP8_SD15_MAX.items():
            assert counts[op] <= mx, (
                f"{op} grew: {counts[op]} > pinned {mx} — a sharding-rule "
                f"edit added collectives to the TP-8 critical path"
            )

    # DeepCache retrieval (shallow level-0) step under TP-8, weights passed
    # as jit arguments as the pipeline passes them: the 5 level-0
    # transformer blocks of the full step's 16, so 5/16 of its collectives
    # (counted on the CPU mesh). The same program built with the earlier
    # shard_map attention wrappers counts the same 15/85/35; with the
    # weights closed over instead, those wrappers left 5/45/20 and the
    # plain GSPMD path leaves 0 (the weights compile replicated, which
    # is not how the pipeline runs). Pinned so the cached path can't silently
    # grow collectives (VERDICT r4 item 10).
    TP8_SD15_SHALLOW_MAX = {"all-reduce": 15, "collective-permute": 85,
                            "all-to-all": 35}

    def test_tp8_deepcache_shallow_collectives_pinned(self):
        r = _run(
            """
            import re, jax, jax.numpy as jnp
            from complex_prompt_diffusion_tpu import models as M
            from complex_prompt_diffusion_tpu.parallel.mesh import make_mesh
            from complex_prompt_diffusion_tpu.parallel.tp import shard_bundle
            from complex_prompt_diffusion_tpu.pipeline import ModelBundle

            tb = shard_bundle(ModelBundle.random("sd15"), make_mesh(model=8))
            cfg = tb.unet_cfg
            dt = cfg.compute_dtype
            x = jnp.zeros((2, 32, 32, cfg.in_channels), dt)
            t = jnp.zeros((2,), jnp.float32)
            ctx = jnp.zeros((2, 77, cfg.context_dim), dt)
            unet_full, _ = M.make_deepcache_unets(cfg, tb.unet_params, None)
            deep_sd = jax.eval_shape(lambda xx: unet_full(xx, t, ctx)[1], x)
            deep0 = jnp.zeros(deep_sd.shape, deep_sd.dtype)

            def shallow(p, xx, st):
                return M.make_deepcache_unets(cfg, p, None)[1](xx, t, ctx, st)

            hlo = jax.jit(shallow).lower(
                tb.unet_params, x, deep0).compile().as_text()
            for op in ("all-reduce", "collective-permute", "all-to-all"):
                n = len(re.findall(rf" {op}(?:-start)?\\(", hlo))
                print(f"count {op} {n}")
            """,
            timeout=900,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        counts = dict(
            (m.group(1), int(m.group(2)))
            for m in re.finditer(r"count (\S+) (\d+)", r.stdout)
        )
        assert set(counts) == set(self.TP8_SD15_SHALLOW_MAX), counts
        assert counts["all-reduce"] > 0, counts
        for op, mx in self.TP8_SD15_SHALLOW_MAX.items():
            assert counts[op] <= mx, (
                f"{op} grew: {counts[op]} > pinned {mx} (DeepCache shallow "
                f"TP-8 step picked up collectives)"
            )

    def test_dp_render_step_no_collectives(self):
        # pure data parallelism: replicated weights + batch-sharded latents
        # must compile to ZERO cross-device collectives in the UNet step
        r = _run(
            """
            import re, dataclasses, jax, jax.numpy as jnp
            from jax.sharding import NamedSharding, PartitionSpec as P
            from complex_prompt_diffusion_tpu.models import unet as unet_mod
            from complex_prompt_diffusion_tpu.parallel import make_mesh, replicate
            from complex_prompt_diffusion_tpu.pipeline import ModelBundle

            mesh = make_mesh(data=8, model=1)
            b = ModelBundle.random("tiny")
            params = replicate(mesh, b.unet_params)
            cfg = b.unet_cfg
            x = jax.device_put(
                jnp.zeros((16, 8, 8, 4), jnp.float32),
                NamedSharding(mesh, P("data")),
            )
            t = jnp.zeros((16,), jnp.int32)
            ctx = jax.device_put(
                jnp.zeros((16, 7, cfg.context_dim), jnp.float32),
                NamedSharding(mesh, P("data")),
            )
            hlo = jax.jit(
                lambda p, x, t, c: unet_mod.unet_apply(cfg, p, x, t, c)
            ).lower(params, x, t, ctx).compile().as_text()
            n = len(re.findall(
                r" (?:all-reduce|collective-permute|all-to-all|all-gather|"
                r"reduce-scatter)(?:-start)?\\(", hlo))
            print("dp collectives", n)
            """
        )
        assert r.returncode == 0, r.stderr[-2000:]
        m = re.search(r"dp collectives (\d+)", r.stdout)
        assert m, r.stdout
        assert int(m.group(1)) == 0, r.stdout
