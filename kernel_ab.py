#!/usr/bin/env python3
"""Time this tree's CUDA grid-sample kernels against another tree's, in
turns, in one process on one card.

    python3 kernel_ab.py OTHER_TREE [--rounds 4]

OTHER_TREE is a checkout whose kernels have the same C interface, for
example the parent commit unpacked with ``git archive``.  Its
``pwstablenet_tpu_torch/csrc`` is built with this tree's nvcc flags, and
both libraries are driven through this tree's wrappers (their library
swapped) at ``chip_smoke.py``'s shapes: each kernel on its main path's
smooth grid, on a random grid and on a (1,8,8,3) frame, timed with
``chip_smoke.time_launches``.  The two libraries' outputs must agree
exactly before any timing.  Rounds alternate the libraries' order.

Prints one JSON line a round, the card's name and power limit, then the
median over rounds of every time.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

from chip_smoke import nvidia_smi, smooth_grid, time_launches


def main() -> int:
    import torch
    import torch.nn.functional as F

    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="root of a tree with the same kernel C interface")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from pwstablenet_tpu_torch.kernels import _build
    from pwstablenet_tpu_torch.kernels import grid_sample as K

    other = os.path.join(os.path.abspath(args.other), "pwstablenet_tpu_torch", "csrc")
    libs = {"this": _build.library(), "other": _build.library(other)}

    def use(name):
        K.library = lambda: libs[name]

    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.rand(8, 256, 256, 3, device="cuda", generator=gen)
    img16 = torch.rand(16, 256, 256, 3, device="cuda", generator=gen)
    cot16 = torch.randn(16, 256, 256, 3, device="cuda", generator=gen)
    u8 = torch.randint(0, 256, (8, 720, 1280, 3), dtype=torch.uint8, device="cuda",
                       generator=gen)
    sgrid = smooth_grid(torch, 8, 256, 256, 0.2, gen)
    sgrid16 = smooth_grid(torch, 16, 256, 256, 0.2, gen)
    ugrid = smooth_grid(torch, 8, 720, 1280, 0.2, gen)
    rgrid = torch.rand(8, 256, 256, 2, device="cuda", generator=gen) * 2.4 - 1.2
    rgrid16 = torch.rand(16, 256, 256, 2, device="cuda", generator=gen) * 2.4 - 1.2
    urand = torch.rand(8, 720, 1280, 2, device="cuda", generator=gen) * 2.4 - 1.2
    fimg = torch.rand(1, 8, 8, 3, device="cuda", generator=gen)
    fu8 = torch.randint(0, 256, (1, 8, 8, 3), dtype=torch.uint8, device="cuda", generator=gen)
    fcot = torch.randn(1, 8, 8, 3, device="cuda", generator=gen)
    fgrid = smooth_grid(torch, 1, 8, 8, 0.2, gen)
    cases = {
        "f32(8,256,256)": lambda: K.grid_sample_f32(img, sgrid),
        "f32(16,256,256)": lambda: K.grid_sample_f32(img16, sgrid16),
        "f32_random_grid": lambda: K.grid_sample_f32(img, rgrid),
        "f32_floor": lambda: K.grid_sample_f32(fimg, fgrid),
        "packed(8,720,1280)": lambda: K.grid_sample_packed_u8(u8, ugrid),
        "packed_random_grid": lambda: K.grid_sample_packed_u8(u8, urand),
        "packed_floor": lambda: K.grid_sample_packed_u8(fu8, fgrid),
        "grad(16,256,256)": lambda: K.grid_sample_grad_f32(img16, sgrid16, cot16),
        "grad_random_grid": lambda: K.grid_sample_grad_f32(img16, rgrid16, cot16),
        "grad_floor": lambda: K.grid_sample_grad_f32(fimg, fgrid, fcot),
    }
    img_nchw = img.permute(0, 3, 1, 2).contiguous()
    img16_nchw = img16.permute(0, 3, 1, 2).contiguous()
    library = {
        "F.grid_sample(8,256,256)": lambda: F.grid_sample(
            img_nchw, sgrid, "bilinear", "border", True),
        "F.grid_sample(16,256,256)": lambda: F.grid_sample(
            img16_nchw, sgrid16, "bilinear", "border", True),
    }

    diffs = {}
    for k, fn in cases.items():
        outs = []
        for name in libs:
            use(name)
            outs.append(fn().float())
        diffs[k] = (outs[0] - outs[1]).abs().max().item()
    print(json.dumps({"max_abs_diff_this_vs_other": diffs}), flush=True)
    if any(d != 0.0 for d in diffs.values()):
        print("kernel_ab: the two trees' kernels disagree", file=sys.stderr)
        return 1

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    names = list(libs)
    rounds = []
    for r in range(args.rounds):
        order = names if r % 2 == 0 else names[::-1]
        ms = {}
        for name in order:
            use(name)
            ms[name] = {k: time_launches(torch, fn, 50, flush) for k, fn in cases.items()}
        ms["library"] = {k: time_launches(torch, fn, 50, flush) for k, fn in library.items()}
        rounds.append(ms)
        print(json.dumps({"round": r, "order": order, "ms": ms}), flush=True)
    print(nvidia_smi(), flush=True)
    median = {n: {k: statistics.median(rd[n][k] for rd in rounds) for k in rounds[0][n]}
              for n in rounds[0]}
    print(json.dumps({"median_ms": median}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
