"""Time the block size of fano.cu (the port's Fano kernel) on one CUDA
card: how the call's time follows the threads a block (so the SMs a call
spreads over) and the lanes a call.

    python3 tools/fano_blocks.py

For each candidate number of threads a block, the source is copied with
its ``kThreads`` rewritten and built with nvcc (all at once,
``-Xptxas -v`` for registers and stack). Each copy runs through the
port's own wrapper (``batched_fano``, its library swapped in) on
chip_smoke.py's synthetic mix (clean, noisy and random lanes, 16 padding
lanes a 512) at 512 and 4,096 lanes and budgets 16, 64 and 256, timed
with chip_smoke.py's device timer, twice, the copies in forward then
reverse order. Every copy's outputs must equal the unchanged source's
bit for bit. Prints one line per copy and case, then every number as one
JSON line, then the card's name and power limit. Needs a card; imports
nothing of JAX.
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

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rtlsdr_wsprd_tpu_torch.buildlib import BUILD_DIR, nvcc_path  # noqa: E402
from rtlsdr_wsprd_tpu_torch.ops import fano  # noqa: E402

THREADS = (32, 64, 128, 256)
LANES = (512, 4096)
BUDGETS = (16, 64, 256)
FIELDS = ("data", "success", "metric", "cycles", "maxnp")
SOURCE = fano._SOURCE.read_text()


def build(threads: int):
    """Build the copy with ``threads`` a block; returns (library,
    [registers, stack bytes] from ptxas)."""
    src, k = re.subn(r"constexpr int kThreads = \d+;",
                     f"constexpr int kThreads = {threads};", SOURCE)
    if k != 1:
        sys.exit("kThreads not found once in fano.cu")
    out = BUILD_DIR / "blocks"
    out.mkdir(parents=True, exist_ok=True)
    stem = out / f"fano_t{threads}"
    stem.with_suffix(".cu").write_text(src)
    proc = subprocess.run(
        [nvcc_path(), *fano.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        sys.exit(f"nvcc {stem.name}: {proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(stem.with_suffix(".so")))
    lib.fano_decode_lanes.argtypes = fano._ARGTYPES
    lib.fano_decode_lanes.restype = ctypes.c_int
    regs = re.search(r"Used (\d+) registers", proc.stderr)
    stack = re.search(r"(\d+) bytes stack frame", proc.stderr)
    return lib, [int(regs[1]) if regs else -1,
                 int(stack[1]) if stack else -1]


def run_with(lib, s, m, v, mc):
    fano._lib = lib
    return fano.batched_fano(s, m, 60, mc, v)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    with ThreadPoolExecutor(len(THREADS)) as ex:
        built = dict(zip(THREADS, ex.map(build, THREADS)))
    for t, (_, rep) in built.items():
        print(f"[build] {t} threads a block: {rep[0]} registers, "
              f"{rep[1]} bytes stack", flush=True)
    m = torch.from_numpy(fano.METTAB).to(dev)
    results = []
    for n in LANES:
        syms, valid = chip_smoke.fano_mix(n=n, n_pad=16 * n // 512)
        s = torch.from_numpy(syms).to(dev)
        v = torch.from_numpy(valid).to(dev)
        for mc in BUDGETS:
            ref = run_with(built[128][0], s, m, v, mc)
            for t, (lib, _) in built.items():
                got = run_with(lib, s, m, v, mc)
                torch.cuda.synchronize()
                if not all(torch.equal(getattr(got, f), getattr(ref, f))
                           for f in FIELDS):
                    sys.exit(f"{t} threads a block differs at {n} lanes, "
                             f"budget {mc}")
            times = {t: [] for t in THREADS}
            for order in (THREADS, THREADS[::-1]):
                for t in order:
                    lib = built[t][0]
                    times[t].append(chip_smoke.cuda_ms(
                        lambda: run_with(lib, s, m, v, mc), reps=5))
            for t in THREADS:
                ms = sum(times[t]) / 2
                results.append(dict(threads=t, lanes=n, maxcycles=mc,
                                    ms=ms, runs=times[t],
                                    blocks=-(-n // t),
                                    registers=built[t][1][0],
                                    stack_bytes=built[t][1][1]))
                print(f"[fano] {t:3d} threads a block, {n} lanes "
                      f"({-(-n // t)} blocks), budget {mc}: {ms:.4f} ms "
                      f"({', '.join(f'{x:.4f}' for x in times[t])})",
                      flush=True)
    fano._lib = None
    print(json.dumps({"fano_blocks": results, "card": smi}))
    print(smi)


if __name__ == "__main__":
    main()
