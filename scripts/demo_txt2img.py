"""Demo + real-weights day-1 drill: end-to-end txt2img from a checkpoint.

Usage:
  python scripts/demo_txt2img.py --ckpt sd-v1-5.ckpt --prompt "a cat" \
      --steps 50 --sampler "DPM++ 2m" --out out.png
Without --ckpt, runs a random-weight SD-1.5 (structure demo only).

Golden-latent drill (BASELINE north star: bit-stable latents vs the
reference at fixed seed, with INJECTED noise — the RNG contract, SURVEY §7
hard-part 2: torch and JAX PRNGs differ, so x_T and any per-step noises
travel in the golden file, never get re-drawn):

  # 1. record goldens (run once, e.g. against the reference's latents or a
  #    known-good build):
  python scripts/demo_txt2img.py --ckpt sd-v1-5.ckpt --save-golden g.npz
  # 2. day-1 check on any machine/build — one command, PASS/FAIL exit code:
  python scripts/demo_txt2img.py --ckpt sd-v1-5.ckpt --golden g.npz

The procedure itself is CI-tested in the slow tier against the synthesized
full-scale SD-1.5 checkpoint (tests/test_fullscale.py::test_golden_drill).
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

from complex_prompt_diffusion_tpu.device import (  # noqa: E402
    compute_dtype,
    enable_compile_cache,
)
from complex_prompt_diffusion_tpu.pipeline import (  # noqa: E402
    ModelBundle,
    RenderConfig,
    txt2img,
)
from complex_prompt_diffusion_tpu.utils import save_image  # noqa: E402


def golden_render(bundle, args, x_T, noises=None):
    cfg = RenderConfig(
        steps=args.steps, sampler=args.sampler, guidance_scale=args.scale,
        width=args.size, height=args.size, seed=args.seed, eta=args.eta,
        sigma_schedule="karras" if args.sampler.lower().startswith("dpm")
        else "default",
    )
    import jax.numpy as jnp

    _, lat = txt2img(
        bundle, args.prompt, args.negative, cfg,
        x_T=jnp.asarray(x_T),
        noises=jnp.asarray(noises) if noises is not None else None,
        decode=False,
    )
    return np.asarray(lat, np.float32)


def save_golden(bundle, args):
    rng = np.random.default_rng(args.seed)
    x_T = rng.standard_normal(
        (1, args.size // 8, args.size // 8, 4), np.float32
    )
    noises = None
    if args.eta > 0:
        from complex_prompt_diffusion_tpu import schedules as S

        it = S.make_inference_tables(bundle.tables, args.steps, eta=args.eta)
        noises = rng.standard_normal(
            (it.num_steps, 1, args.size // 8, args.size // 8, 4), np.float32
        )
    lat = golden_render(bundle, args, x_T, noises)
    payload = {
        "x_T": x_T, "latents": lat, "prompt": args.prompt,
        "negative": args.negative, "steps": args.steps,
        "sampler": args.sampler, "scale": args.scale, "size": args.size,
        "eta": args.eta,
    }
    if noises is not None:
        payload["noises"] = noises
    np.savez(args.save_golden, **payload)
    print(f"wrote goldens to {args.save_golden} "
          f"(latents mean {lat.mean():+.5f} std {lat.std():.5f})")


def check_golden(bundle, args):
    g = np.load(args.golden, allow_pickle=True)
    # the golden file pins the render config — command-line args must not
    # silently change what is being compared
    for k in ("prompt", "negative", "sampler"):
        setattr(args, k, str(g[k]))
    for k, cast in (("steps", int), ("scale", float), ("size", int),
                    ("eta", float)):
        setattr(args, k, cast(g[k]))
    lat = golden_render(
        bundle, args, g["x_T"], g["noises"] if "noises" in g else None
    )
    ref = g["latents"]
    err = float(np.abs(lat - ref).max())
    rel = err / (float(np.abs(ref).max()) + 1e-12)
    ok = err <= args.tol
    print(f"golden check: max|Δlatent| = {err:.3e} (rel {rel:.3e}) "
          f"tol {args.tol:g} -> {'PASS' if ok else 'FAIL'}")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--prompt", default="a photograph of an astronaut riding a horse")
    ap.add_argument("--negative", default="")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--sampler", default="DDIM")
    ap.add_argument("--scale", type=float, default=7.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--out", default="out.png")
    ap.add_argument(
        "--dtype", default=None,
        help="compute dtype for the demo render (e.g. bfloat16); golden "
        "runs default to f32 for bit-stability",
    )
    ap.add_argument(
        "--golden", default=None,
        help="npz of pinned (x_T[, noises], config, latents): render with "
        "the injected noise and PASS/FAIL against the stored latents",
    )
    ap.add_argument(
        "--save-golden", dest="save_golden", default=None,
        help="record a golden npz from this checkpoint+config",
    )
    ap.add_argument("--tol", type=float, default=5e-3)
    args = ap.parse_args(argv)
    enable_compile_cache()

    golden_mode = args.golden or args.save_golden
    if args.ckpt:
        bundle = ModelBundle.from_checkpoint(args.ckpt, dtype=args.dtype)
    else:
        if golden_mode:
            print("golden modes require --ckpt", file=sys.stderr)
            return 2
        print("no --ckpt: using RANDOM weights (output will be noise)")
        bundle = ModelBundle.random("sd15").cast(
            args.dtype or compute_dtype(jax.default_backend()), donate=True
        )

    if args.save_golden:
        save_golden(bundle, args)
        return 0
    if args.golden:
        return 0 if check_golden(bundle, args) else 1

    cfg = RenderConfig(
        steps=args.steps, sampler=args.sampler, guidance_scale=args.scale,
        width=args.size, height=args.size, seed=args.seed,
        sigma_schedule="karras" if args.sampler.lower().startswith("dpm") else "default",
    )
    images, _ = txt2img(bundle, args.prompt, args.negative, cfg)
    save_image(images[0], args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
