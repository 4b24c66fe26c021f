"""Exact FLOP count of the SD-1.5 CFG step per op class, enumerated from
the UNet build plan (batch 8 = batch 4 with CFG, 512x512), and the least
time each class could take at the card's published bf16 peak
(``bench.PEAKS``). Device-independent counts; the bound is a floor, not a
measurement.

Run: python scripts/roofline.py [DEVICE_KIND]   (host only, no device
needed; DEVICE_KIND defaults to "NVIDIA H100 80GB HBM3")
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import peaks  # noqa: E402
from complex_prompt_diffusion_tpu import models as M  # noqa: E402
from complex_prompt_diffusion_tpu.models.unet import build_plan  # noqa: E402

cfg = M.UNetConfig.sd15()
B = 8           # CFG megabatch at bench batch 4
HW0 = 64        # 512px latent grid
KV = 77
CTX = 768

fl = {"attn_self": 0, "attn_cross": 0, "ff": 0, "proj": 0,
      "conv3": 0, "upconv": 0, "conv1": 0, "emb": 0}

ib, mid, ob = build_plan(cfg)


def res_flops(cin, cout, hw, mode):
    hw_out = hw * 2 if mode == "up" else (hw // 2 if mode == "down" else hw)
    c3 = 2 * 9 * hw * hw * cin * cout + 2 * 9 * hw_out * hw_out * cout * cout
    c1 = 2 * hw * hw * cin * cout if cin != cout else 0
    emb = 2 * 4 * cfg.model_channels * cout  # per-sample time-emb linear
    return c3, c1, emb


def attn_flops(ch, heads, dh, depth, hw):
    S = hw * hw
    proj = 2 * 2 * S * ch * ch  # proj_in + proj_out (1x1 as matmul)
    per_block = 0
    self_mm = 0
    cross_mm = 0
    ff = 0
    for _ in range(depth):
        proj += 2 * S * ch * (3 * ch)          # fused qkv
        proj += 2 * S * ch * ch                # self out-proj
        self_mm += 2 * 2 * S * S * ch          # scores + att@V
        proj += 2 * S * ch * ch                # cross q
        proj += 2 * 2 * KV * CTX * ch          # cross k, v (hoisted, tiny)
        cross_mm += 2 * 2 * S * KV * ch
        proj += 2 * S * ch * ch                # cross out-proj
        ff += 2 * S * ch * (8 * ch) + 2 * S * (4 * ch) * ch  # GEGLU
    return self_mm, cross_mm, ff, proj + per_block


def walk(blocks, hw):
    for block in blocks:
        for d in block:
            kind = d[0]
            if kind == "conv_in":
                fl["conv3"] += 2 * 9 * hw * hw * cfg.in_channels * cfg.model_channels
            elif kind == "res":
                c3, c1, emb = res_flops(d[1], d[2], hw, "none")
                fl["conv3"] += c3
                fl["conv1"] += c1
                fl["emb"] += emb
            elif kind == "attn":
                s, c, f, p = attn_flops(d[1], d[2], d[3], d[4], hw)
                fl["attn_self"] += s
                fl["attn_cross"] += c
                fl["ff"] += f
                fl["proj"] += p
            elif kind == "down":
                fl["conv3"] += 2 * 9 * (hw // 2) ** 2 * d[1] * d[1]
                hw //= 2
            elif kind == "up":
                # nearest-2x upsample, then a dense 3x3 conv on the big plane
                fl["upconv"] += 2 * 9 * (hw * 2) ** 2 * d[1] * d[1]
                hw *= 2
    return hw


hw = walk(ib, HW0)
hw = walk([mid], hw)
walk(ob, hw)
fl["conv3"] += 2 * 9 * HW0 * HW0 * cfg.model_channels * cfg.out_channels  # conv_out

for k in fl:
    fl[k] *= B

total_tf = sum(fl.values()) / 1e12
print(f"total: {total_tf:.3f} TF per CFG step (batch {B})  "
      f"[0.68 TF/img x2 sanity: {0.68 * B:.2f}]")

kind = sys.argv[1] if len(sys.argv) > 1 else "NVIDIA H100 80GB HBM3"
peak = peaks(kind)["bf16_flops"]
print(f"lower bound at {kind} bf16 peak {peak / 1e12:.0f} TF/s "
      f"({peaks(kind)['source']})")
print(f"{'class':12s} {'TF/step':>8s} {'floor ms':>9s}")
for k, v in fl.items():
    print(f"{k:12s} {v / 1e12:8.3f} {v / peak * 1e3:9.3f}")
print(f"{'sum':12s} {total_tf:8.3f} {total_tf * 1e12 / peak * 1e3:9.3f}")
print(f"per image-step, CFG included: {total_tf / (B // 2):.4f} TF")
