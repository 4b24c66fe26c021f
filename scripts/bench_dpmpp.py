"""Secondary benchmark: SD-1.5 512x512, DPM-Solver++(2M) Karras 20 steps,
sampling scan only. Needs the GPU."""
import json
import time
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from complex_prompt_diffusion_tpu.device import (  # noqa: E402
    enable_compile_cache,
    require_accelerator,
)

require_accelerator()
enable_compile_cache()

from complex_prompt_diffusion_tpu import models as M, samplers as SA, schedules as S
from complex_prompt_diffusion_tpu.guidance import GuidanceSpec, make_denoiser, GuidanceConfig

unet_cfg = M.UNetConfig.sd15()
key = jax.random.PRNGKey(0)
params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), M.init_unet(key, unet_cfg))
tables = S.make_diffusion_tables()
sigmas = S.make_sigma_schedule("karras", 20, sigma_min=float(tables.sigmas[0]), sigma_max=float(tables.sigmas[-1]))
spec = GuidanceSpec.single(jax.random.normal(key, (77, 768)), jnp.zeros((77, 768)))

@jax.jit
def run(p, x, k):
    def unet_eps(xx, t, c):
        return M.unet_apply(unet_cfg, p, xx, t, c)
    _, den = make_denoiser(unet_eps, spec, gcfg=GuidanceConfig(),
                           model_sigmas=jnp.asarray(tables.sigmas))
    x0, _ = SA.sample_dpmpp_2m(den, x, sigmas, 7.5, key=k)
    return x0

B = 4
def make_x(i):
    return jax.random.normal(jax.random.fold_in(key, i), (B, 64, 64, 4), jnp.float32) * float(sigmas[0])

jax.block_until_ready(run(params, make_x(0), jax.random.PRNGKey(1)))  # compile
ts = []
for i in range(2):
    x = jax.block_until_ready(make_x(i + 1))
    t0 = time.perf_counter()
    jax.block_until_ready(run(params, x, jax.random.PRNGKey(2 + i)))
    ts.append(time.perf_counter() - t0)
dt = min(ts)
print(json.dumps({
    "metric": "images/sec scan SD1.5 512x512 DPM++2M Karras-20 CFG7.5",
    "value": round(B / dt, 4), "unit": "images/sec",
    "per_step_ms": round(dt / 20 * 1000, 2), "batch": B,
    "platform": jax.devices()[0].platform,
    "device_kind": jax.devices()[0].device_kind,
}))
