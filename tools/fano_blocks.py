"""Time the block size of fano.cu (the port's Fano kernel) on one CUDA
card: how the call's time follows the lanes a block (so the SMs a call
spreads over) and the lanes a call.

    python3 tools/fano_blocks.py

For each candidate number of lanes a block (``kLanes``, one thread a
lane), the source is copied with its ``kLanes`` rewritten and built with
nvcc (all at once, ``-Xptxas -v``). Per copy it prints what ptxas
reports (registers, stack frame, spills, static shared memory), the
dynamic shared memory its launcher asks for, and the instructions of
the search loop (the SASS loop that holds the node stack's 128-bit
shared load), read with cuobjdump. Each copy runs through the port's
own wrapper (``batched_fano``, its library swapped in) on three inputs:
the calibration's probe (32 random-symbol lanes, ops/calibrate.py) and
chip_smoke.py's synthetic mix (clean, noisy and random lanes, 16 padding
lanes a 512) at 512 and 4,096 lanes, at budgets 16, 64 and 256, timed
with chip_smoke.py's device timer, twice, the copies in forward then
reverse order. Every copy's outputs, flat step counts included, must
equal the plain version's (``batched_fano_plain`` on the card, run once
an input and budget). Prints one line per copy and case, then every
number as one JSON line, then the card's name and power limit. Needs a
card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rtlsdr_wsprd_tpu_torch.buildlib import BUILD_DIR, nvcc_path  # noqa: E402
from rtlsdr_wsprd_tpu_torch.config import NBITS  # noqa: E402
from rtlsdr_wsprd_tpu_torch.ops import fano  # noqa: E402

LANES_A_BLOCK = fano.LANES_A_BLOCK
BUDGETS = (16, 64, 256)
FIELDS = ("data", "success", "metric", "cycles", "maxnp", "steps")
SOURCE = fano._SOURCE.read_text()


def loop_instructions(sass: str) -> int:
    """Instructions of fano_kernel's search loop: the body of the
    backward branch that holds the node stack's 128-bit shared load
    (LDS.128), from its target to the branch."""
    code = {}  # address -> instruction
    for ln in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s*([^;]*);", ln)
        if m:
            code[int(m[1], 16)] = m[2].strip()
    best = -1
    for addr, ins in code.items():
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if m and int(m[1], 16) < addr:
            body = [x for a, x in code.items() if int(m[1], 16) <= a <= addr]
            if any("LDS.128" in x for x in body):
                best = max(best, len(body))
    return best


def build(lanes: int):
    """Build the copy with ``lanes`` a block; returns (library, report)
    with ptxas's registers, stack frame, spills and static shared bytes,
    the launcher's dynamic shared bytes and the search loop's SASS
    instruction count."""
    src, k = re.subn(r"constexpr int kLanes = \d+;",
                     f"constexpr int kLanes = {lanes};", SOURCE)
    if k != 1:
        sys.exit("kLanes not found once in fano.cu")
    out = BUILD_DIR / "blocks"
    out.mkdir(parents=True, exist_ok=True)
    stem = out / f"fano_l{lanes}"
    stem.with_suffix(".cu").write_text(src)
    so = str(stem.with_suffix(".so"))
    proc = subprocess.run(
        [nvcc_path(), *fano.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
         str(stem.with_suffix(".cu"))],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        sys.exit(f"nvcc {stem.name}: {proc.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    lib.fano_decode_lanes.argtypes = fano._ARGTYPES
    lib.fano_decode_lanes.restype = ctypes.c_int
    lib.fano_shared_bytes.restype = ctypes.c_int
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    # the library's one kernel (its name is mangled)
    sass = subprocess.run([str(cuobjdump), "-sass", so], capture_output=True,
                          text=True, timeout=300).stdout \
        if cuobjdump.exists() else ""
    (stem.with_suffix(".sass")).write_text(sass)

    def num(pattern):
        m = re.search(pattern, proc.stderr)
        return int(m[1]) if m else -1

    return lib, dict(registers=num(r"Used (\d+) registers"),
                     stack_frame_bytes=num(r"(\d+) bytes stack frame"),
                     spill_store_bytes=num(r"(\d+) bytes spill stores"),
                     spill_load_bytes=num(r"(\d+) bytes spill loads"),
                     static_smem_bytes=num(r"(\d+) bytes smem"),
                     dynamic_smem_bytes=lib.fano_shared_bytes(),
                     loop_sass_instructions=loop_instructions(sass),
                     ptxas=[ln.strip() for ln in proc.stderr.splitlines()
                            if "fano_kernel" in ln or "Used" in ln
                            or "stack frame" in ln])


def run_with(lib, s, m, v, mc, steps=False):
    fano._lib = lib
    return fano.batched_fano(s, m, 60, mc, v, steps=steps)


def inputs():
    """(label, symbols, valid) of each input, on the host."""
    rng = np.random.default_rng(20260821)  # ops/calibrate.py's probe
    probe = rng.integers(0, 256, (32, 2 * NBITS), dtype=np.uint8)
    yield "calibration probe", probe, np.ones(32, bool)
    for n in (512, 4096):
        yield (f"synthetic mix {n}",
               *chip_smoke.fano_mix(n=n, n_pad=16 * n // 512))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    with ThreadPoolExecutor(len(LANES_A_BLOCK)) as ex:
        built = dict(zip(LANES_A_BLOCK, ex.map(build, LANES_A_BLOCK)))
    for n, (_, rep) in built.items():
        print(f"[build] {n} lanes a block: {rep['registers']} registers, "
              f"{rep['stack_frame_bytes']} bytes stack frame, spills "
              f"{rep['spill_store_bytes']}/{rep['spill_load_bytes']} bytes, "
              f"{rep['static_smem_bytes']} bytes static + "
              f"{rep['dynamic_smem_bytes']} bytes dynamic shared; search "
              f"loop {rep['loop_sass_instructions']} SASS instructions; "
              f"ptxas: {rep['ptxas']}", flush=True)
    m = fano.device_mettab(dev)
    results = []
    for label, syms, valid in inputs():
        s = torch.from_numpy(syms).to(dev)
        v = torch.from_numpy(valid).to(dev)
        n = syms.shape[0]
        for mc in BUDGETS:
            ref = fano.batched_fano_plain(s, m, 60, mc, v, steps=True)
            for lanes, (lib, _) in built.items():
                got = run_with(lib, s, m, v, mc, steps=True)
                torch.cuda.synchronize()
                bad = [f for f in FIELDS
                       if not torch.equal(getattr(got, f), getattr(ref, f))]
                if bad:
                    sys.exit(f"{lanes} lanes a block differs from the plain "
                             f"version at {label}, budget {mc}: {bad}")
            steps_max = int(ref.steps.max())
            times = {k: [] for k in LANES_A_BLOCK}
            for order in (LANES_A_BLOCK, LANES_A_BLOCK[::-1]):
                for lanes in order:
                    lib = built[lanes][0]
                    times[lanes].append(chip_smoke.cuda_ms(
                        lambda: run_with(lib, s, m, v, mc), reps=5))
            for lanes in LANES_A_BLOCK:
                ms = sum(times[lanes]) / 2
                rep = built[lanes][1]
                results.append(dict(
                    lanes_a_block=lanes, input=label, lanes=n, maxcycles=mc,
                    ms=ms, runs=times[lanes], blocks=-(-n // lanes),
                    steps_max_lane=steps_max,
                    **{k: v for k, v in rep.items() if k != "ptxas"}))
                print(f"[fano] {lanes:3d} lanes a block, {label} "
                      f"({-(-n // lanes)} blocks), budget {mc}: {ms:.4f} ms "
                      f"({', '.join(f'{x:.4f}' for x in times[lanes])}); "
                      f"slowest lane {steps_max} steps; equal to plain",
                      flush=True)
    fano._lib = None
    print(json.dumps({"fano_blocks": results, "card": smi}))
    print(smi)


if __name__ == "__main__":
    main()
