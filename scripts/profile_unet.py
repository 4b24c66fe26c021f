"""Capture a device trace of three SD-1.5 UNet CFG calls (UNet batch 8,
bf16) and print the top events by total duration.

    python scripts/profile_unet.py [TRACE_DIR]

TRACE_DIR defaults to <checkout>/traces/profile_unet. Needs the GPU."""
import glob
import gzip
import json
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

from complex_prompt_diffusion_tpu import models as M  # noqa: E402

LOGDIR = (
    sys.argv[1] if len(sys.argv) > 1
    else str(Path(__file__).resolve().parents[1] / "traces" / "profile_unet")
)

cfg = M.UNetConfig.sd15()
params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                      M.init_unet(jax.random.PRNGKey(0), cfg))
f = jax.jit(lambda p, x, t, c: M.unet_apply(cfg, p, x, t, c))
x = jax.random.normal(jax.random.PRNGKey(1), (8, 64, 64, 4), jnp.float32)
t = jnp.ones((8,))
c = jax.random.normal(jax.random.PRNGKey(2), (8, 77, 768), jnp.float32)

jax.block_until_ready(f(params, x, t, c))  # compile

jax.profiler.start_trace(LOGDIR, create_perfetto_trace=True)
for i in range(3):
    out = f(params, x, t, c)
jax.block_until_ready(out)
jax.profiler.stop_trace()

# summarize trace events by name
files = glob.glob(f"{LOGDIR}/**/perfetto_trace.json.gz", recursive=True)
if not files:
    print("no trace files under", LOGDIR)
else:
    with gzip.open(sorted(files)[-1], "rt") as fh:
        trace = json.load(fh)
    totals = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and "dur" in ev:
            name = ev.get("name", "?")[:60]
            totals[name] = totals.get(name, 0) + ev["dur"]
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:25]
    print(f"{'us total':>12}  op")
    for name, dur in top:
        print(f"{dur:12.0f}  {name}")
