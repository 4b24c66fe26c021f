"""How much a sample's latents depend on the batch it is rendered in.

    python scripts/batch_dependence.py            # needs the GPU
    python scripts/batch_dependence.py --small    # tiny model, any backend

Renders eight seeded x_T at 512x512 with DDIM (1 and 3 steps, CFG 7.5) as
one batch of 8, and their first rows again as batches of 2 and 4, in f32
under "highest" and in bf16, and prints the relative L2 of each row block
against the same rows of the batch-8 render. A sharded path that hands each
device fewer samples differs from device 0 by at least this much. For
scale it also prints planted one-shard faults: rows 2:4 of the batch-8
render taken from a render with the CFG halves swapped, or with another
prompt. ``chip_smoke.py --chips 4`` sets its bound between the two.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from complex_prompt_diffusion_tpu.device import (  # noqa: E402
    compute_dtype,
    enable_compile_cache,
    require_accelerator,
)
from complex_prompt_diffusion_tpu.pipeline import (  # noqa: E402
    ModelBundle,
    RenderConfig,
    make_guidance_spec,
    sample_latents,
)

SMALL = "--small" in sys.argv
PROMPT, OTHER = "a bowl of ramen on a wooden table", "a red fox in fresh snow"


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main():
    if not SMALL:
        require_accelerator()
    enable_compile_cache()
    b32 = ModelBundle.random("tiny" if SMALL else "sd15", seed=0)
    width = 32 if SMALL else 512
    x = np.asarray(jax.random.normal(
        jax.random.PRNGKey(5), (8, width // 8, width // 8, 4), jnp.float32))

    def render(b, rows, steps, prompt=PROMPT, negative=""):
        cfg = RenderConfig(steps=steps, sampler="DDIM", width=width,
                           height=width, batch_size=len(rows))
        spec = make_guidance_spec(b, prompt, negative)
        return np.asarray(sample_latents(b, spec, cfg, x_init=jnp.asarray(rows)))

    variants = [("float32", b32, "highest")]
    if not SMALL:
        variants.append((compute_dtype(jax.default_backend()),
                         b32.cast(compute_dtype(jax.default_backend())), None))
    for dtype, b, precision in variants:
        for steps in (1, 3):
            with jax.default_matmul_precision(precision):
                r8 = render(b, x, steps)
                row = {
                    "batch 2 rows 0:2": rel(render(b, x[:2], steps), r8[:2]),
                    "batch 2 rows 2:4": rel(render(b, x[2:4], steps), r8[2:4]),
                    "batch 4 rows 0:4": rel(render(b, x[:4], steps), r8[:4]),
                }
                for what, kw in (("swapped CFG", dict(prompt="", negative=PROMPT)),
                                 ("other prompt", dict(prompt=OTHER))):
                    faulty = r8.copy()
                    faulty[2:4] = render(b, x, steps, **kw)[2:4]
                    row[f"planted {what} on rows 2:4"] = rel(faulty, r8)
            print(f"{dtype} DDIM-{steps}: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in row.items()), flush=True)


if __name__ == "__main__":
    main()
