#!/usr/bin/env python3
"""K10 (the int8 convolution, ``buddy_tpu_torch/csrc/qconv_sm90.cu`` and
``csrc/qconv.cu``) on one CUDA card: two checkouts in turns, or the two
routes of this checkout in turns.

    python3 k10_compare.py <checkout A> <checkout B> [pairs]
    python3 k10_compare.py --routes [pairs]

Each run is a process of its own: A, B, B, A, ... for ``pairs`` pairs, each
checkout on the route its ``int8_conv`` picks; with ``--routes``, this
checkout with the route forced, sm90, mma, mma, sm90, ... (two runs of one
route give the A/A spread).  A run builds its checkout's kernels, holds the
convolution bit for bit to its plain versions (int32 sums and the bf16
dequantized output) at the main-path shapes below (B=8, bf16: the int8
U-Net's top-level 3x3 and 1x1, a 3x3 of the second level, the fused
four-phase 3x3 and 1x1 of an up-block, a bottleneck 3x3), and prints one
JSON line: each shape's device us a launch (CUDA events, the median of 20
launches, each after an L2 flush), the card, the checkout and the route.
The last line, ``SUMMARY``, holds each checkout's (route's) means over its
runs; the whole goes to chiprun_out/k10_compare.json.
"""

import json
import os
import subprocess
import sys

# kind, C_in, C_out, H, W (the input's grid)
SHAPES = [("3x3", 128, 128, 256, 528), ("1x1", 384, 128, 256, 528), ("3x3", 256, 256, 128, 264),
          ("up3x3", 256, 256, 128, 264), ("up1x1", 256, 256, 128, 264), ("3x3", 512, 256, 32, 66)]

CHILD = r"""
import json, subprocess, sys
import torch
sys.path.insert(0, ".")
from buddy_tpu_torch.ops import _build, qconv as Q
_build.build([n for n in ("qconv", "qconv_sm90") if n in _build.SOURCES])
shapes, route = json.loads(sys.argv[1]), sys.argv[3]
forced = {} if route == "auto" else {"route": route}
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
l2 = torch.cuda.get_device_properties(0).L2_cache_size
flush = torch.zeros(2 * l2, dtype=torch.uint8, device=dev)
gen = torch.Generator().manual_seed(10)
out = {"checkout": sys.argv[2], "route": route, "card": subprocess.run(
    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
    capture_output=True, text=True).stdout.strip(), "us": {}}
for kind, cin, cout, h, w in shapes:
    k = 3 if kind.endswith("3x3") else 1
    x = torch.randn((8, cin, h, w), generator=gen).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    wt = (torch.randn((cout, cin, k, k), generator=gen) / (cin * k * k) ** 0.5).to(dev)
    b = (torch.randn(cout, generator=gen) * 0.1).to(dev)
    with torch.no_grad():
        xq, sx = Q.quantize_act(x)
        wq, sw = Q.quantize_weight(Q._derived(wt, kind).contiguous())
        acc0 = Q.int8_conv_plain(xq, wq, kind)
        assert torch.equal(Q.int8_conv(xq, wq, sw, kind, raw=True, **forced), acc0), kind
        call = lambda: Q.int8_conv(xq, wq, sw, kind, out_dtype=torch.bfloat16, s_x=sx, bias=b,
                                   **forced)
        y0 = Q.dequant_plain(acc0, torch.bfloat16, sx * sw, b)
        assert torch.equal(call().permute(0, 2, 3, 1), y0), kind
        del acc0, y0
        for _ in range(3):
            call()
        times = []
        for _ in range(20):
            flush.bitwise_not_()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            call()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1) * 1e3)
    out["us"][f"{kind} {cin}->{cout} {h}x{w}"] = sorted(times)[len(times) // 2]
    del x, xq, wq
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--routes"]:
        pairs = int(args[1]) if len(args) > 1 else 2
        runs_of = [(".", r) for r in ("sm90", "mma", "mma", "sm90") * ((pairs + 1) // 2)]
        key = lambda run: run["route"]
        labels = ("sm90", "mma")
    elif len(args) >= 2:
        a, b = args[0], args[1]
        pairs = int(args[2]) if len(args) > 2 else 2
        runs_of = [(d, "auto") for d in (a, b, b, a) * ((pairs + 1) // 2)]
        key = lambda run: run["checkout"]
        labels = (a, b)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for d, route in runs_of[:2 * pairs]:
        r = subprocess.run([sys.executable, "-c", CHILD, json.dumps(SHAPES), d, route], cwd=d,
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        line = r.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    summary = {}
    for label in labels:
        mine = [r["us"] for r in runs if key(r) == label]
        summary[label] = {k: sum(m[k] for m in mine) / len(mine) for k in mine[0]}
    print("SUMMARY " + json.dumps(summary), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "k10_compare.json"), "w") as f:
        json.dump({"runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
