"""Time the tile shapes of polyphase.cu (the port's float32 polyphase
kernel) on one CUDA card, the record its fixed constants were chosen by,
and show where the fixed kernel's time goes.

    python3 tools/polyphase_blocks.py

1. Tile shapes. For each instantiation (stage 1: 8 complex taps per
   phase; stage 2: 30 real taps per phase) and each candidate (frames per
   tile, frames per thread), the source is copied with that
   instantiation's two constants rewritten.
2. Parts. The source as it is, and three copies with one part of the
   kernel left out: the slab's global loads (the FMAs then run on
   whatever shared memory holds), the FMAs, or the cross-phase sum (one
   value per thread is stored instead). The differences say what each
   part adds to the call; a one-element ``add_`` gives the timer's floor.

Every copy is built with nvcc (all at once, ``-Xptxas -v`` for its
registers), run through the port's own wrapper (``polyphase_decimate``)
at the front end's shapes of its stage and timed with chip_smoke.py's
device timer, twice, the copies in forward then reverse order. Each
candidate shape and the unchanged source are held against the plain
version (max |diff| <= 1e-3). Prints one line per copy and shape, then
every number as one JSON line, then the card's name and power limit.
Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rtlsdr_wsprd_tpu_torch.buildlib import BUILD_DIR, nvcc_path  # noqa: E402
from rtlsdr_wsprd_tpu_torch.frontend import polyphase  # noqa: E402
from rtlsdr_wsprd_tpu_torch.frontend.decimate import (  # noqa: E402
    STAGE1,
    STAGE2,
)

# (frames per tile, frames per thread); at most 1024 threads a block
CANDIDATES = {
    "stage1": [(32, 4), (32, 8), (64, 8), (64, 16), (128, 16), (128, 32)],
    "stage2": [(32, 8), (32, 16), (64, 8), (64, 16), (128, 16), (128, 32)],
}
# (C, frames): the front end's calls (8 lanes, and one lane)
SHAPES = {
    "stage1": [(8, 8000), (1, 300_000)],
    "stage2": [(8, 3700), (8, 99), (1, 3750)],
}
FILTERS = {"stage1": STAGE1, "stage2": STAGE2}
SOURCE = (polyphase._CSRC / "polyphase.cu").read_text()

# part left out -> (the source from this line ..., to this one, in its place)
LOADS = ("  // 1. the slab of both planes", "  __syncthreads();\n\n  // 2.")
FMAS = ("#pragma unroll\n  for (int j = 0;", "  __syncthreads();  // every")
SUM = ("  // 3. cross-phase sum", "}\n\ntemplate <int kTpp, bool kComplex")
PARTS = {
    "as it is": None,
    "no global loads": (*LOADS, "  if (tid == 0) s_slab[0] = 0.0f;\n"),
    "no FMAs": (*FMAS, "  aI[0] = sI[0];\n  aQ[0] = sQ[0];\n"),
    "no phase sum": (*SUM, (
        "  if (r == 0 && m0 + grp * kGroup < n_frames) {\n"
        "    float y = 0.0f;\n"
        "    for (int i = 0; i < kGroup; ++i) y += aI[i] + aQ[i];\n"
        "    yI[c * out_stride + m0 + grp * kGroup] = y;\n  }\n")),
}


def shape_source(stage: str, frames: int, group: int) -> str:
    src = SOURCE
    n = stage[-1]
    for key, val in (("Frames", frames), ("Group", group)):
        src, k = re.subn(rf"constexpr int kStage{n}{key} = \d+;",
                         f"constexpr int kStage{n}{key} = {val};", src)
        if k != 1:
            sys.exit(f"kStage{n}{key} not found once in polyphase.cu")
    return src


def part_source(cut) -> str:
    if cut is None:
        return SOURCE
    begin, end, new = cut
    a = SOURCE.find(begin)
    b = SOURCE.find(end, a)
    if a < 0 or b < 0 or SOURCE.count(begin) != 1:
        sys.exit(f"part {begin!r} .. {end!r} not found in polyphase.cu")
    return SOURCE[:a] + new + SOURCE[b:]


def build(label: str, src: str):
    """Build one copy; returns (library, {tpp: [registers, spill store
    bytes]} of each instantiation, from ptxas)."""
    out = BUILD_DIR / "blocks"
    out.mkdir(parents=True, exist_ok=True)
    stem = out / f"polyphase_{re.sub(r'\W+', '_', label)}"
    stem.with_suffix(".cu").write_text(src)
    proc = subprocess.run(
        [nvcc_path(), *polyphase.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        sys.exit(f"nvcc {stem.name}: {proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(stem.with_suffix(".so")))
    _, _, fn, argtypes = polyphase._KERNELS["direct"]
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
    # ptxas reports each entry function: its name (tpp is its first
    # template argument), then its spills and registers
    report = {}
    for entry in proc.stderr.split("Compiling entry function")[1:]:
        tpp = re.search(r"polyphase_kernelILi(\d+)E", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        if tpp and regs and spill:
            report[int(tpp[1])] = [int(regs[1]), int(spill[1])]
    return lib, report


def time_copies(stage, C, n, copies, built, rng, check):
    """Each copy's device ms (twice, forward then reverse order) and max
    |diff| against the plain version at one shape; exits if a copy in
    ``check`` is off by more than 1e-3."""
    filt = FILTERS[stage]
    dev = torch.device("cuda")
    L = n * filt.R + filt.T - filt.R
    xI, xQ = (torch.from_numpy(
        rng.normal(0, 10.0, (C, L)).astype(np.float32)).to(dev)
        for _ in range(2))
    pI, pQ = polyphase.polyphase_plain(xI, xQ, filt, n)
    times = {c: [] for c in copies}
    errs = {}
    for order in (copies, copies[::-1]):
        for key in order:
            polyphase._libs["direct"] = built[key][0]
            kI, kQ = polyphase.polyphase_decimate(xI, xQ, filt, n)
            torch.cuda.synchronize()
            errs[key] = max(float((kI - pI).abs().max()),
                            float((kQ - pQ).abs().max()))
            if key in check and not errs[key] <= 1e-3:
                sys.exit(f"{key} C={C} x {n}: max |diff| {errs[key]} > 1e-3")
            times[key].append(chip_smoke.cuda_ms(
                lambda: polyphase.polyphase_decimate(xI, xQ, filt, n)))
    polyphase._libs.pop("direct", None)
    return times, errs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    jobs = {(st, f, g): shape_source(st, f, g)
            for st, cands in CANDIDATES.items() for f, g in cands}
    jobs.update({part: part_source(cut) for part, cut in PARTS.items()})
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda kv: build(str(kv[0]), kv[1]), jobs.items())))
    rng = np.random.default_rng(7)
    results = []
    for stage, shapes in SHAPES.items():
        tpp = FILTERS[stage].tpp
        cands = CANDIDATES[stage]
        for C, n in shapes:
            keys = [(stage, f, g) for f, g in cands]
            times, errs = time_copies(stage, C, n, keys, built, rng, keys)
            for key in keys:
                _, f, g = key
                row = dict(stage=stage, C=C, frames=n, tile_frames=f,
                           group=g, threads=80 * f // g,
                           ptxas=built[key][1][tpp],
                           max_abs_err=errs[key], ms=times[key])
                results.append(row)
                print(f"[blocks] {stage} C={C} x {n}: {f} frames a tile, "
                      f"{g} a thread ({row['threads']} threads, registers "
                      f"and spill bytes {row['ptxas']}): {times[key][0]:.4f}"
                      f" / {times[key][1]:.4f} ms, max |diff| "
                      f"{errs[key]:.3g}", flush=True)
    x = torch.zeros(1, device="cuda")
    floor = chip_smoke.cuda_ms(lambda: x.add_(1))
    print(f"[parts] timer floor (a one-element add_): {floor:.4f} ms")
    parts = list(PARTS)
    for stage, shapes in SHAPES.items():
        for C, n in shapes:
            times, errs = time_copies(stage, C, n, parts, built, rng,
                                      parts[:1])
            results.append(dict(stage=stage, C=C, frames=n, parts=times,
                                floor_ms=floor))
            print(f"[parts] {stage} C={C} x {n}: " + "; ".join(
                f"{p} {sum(times[p]) / 2:.4f} ms" for p in parts),
                flush=True)
    print(json.dumps({"card": card, "device": name, "rows": results}))
    print(card)


if __name__ == "__main__":
    main()
