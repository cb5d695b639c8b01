"""The control: the plain reference put in the program's place at the
precision below the one the deployments state, compared as a run is.

The port computes in float32 with TF32 off (rtlsdr_wsprd_tpu_torch/
device.py); the control computes the same reference with TF32 inputs
to every matrix product (``reference/precision.py``), the front end in
float32 instead of float64. A
limit sits between the readings sound runs give and the least reading
the control gives, so a change that drops the decode to TF32 fails.

    python3 wsprbench/control.py --workload <name> --seeds 1 2 3

prints one JSON line a seed with the numbers ``compare.py`` compares.
It runs on the first CUDA card, or with ``--device cpu`` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from wsprbench import compare, gen  # noqa: E402
from wsprbench.run import load_cell, reference_spots, sample_windows  # noqa: E402


def readings(cell, seed: int, device="cuda:0") -> dict:
    """The control's numbers on one seed at the cell's own sizes."""
    checked = sample_windows(cell.mix, seed)
    numbers: dict = {}
    if cell.config["feed"] == "device_raw":
        from wsprbench.reference import precision
        from wsprbench.reference.frontend import steady_window
        pool = gen.raw_capture(cell.mix, seed, device, only=checked)
        ref_in, ctl_in = {}, {}
        err = 0.0
        for row, w in enumerate(checked):
            ri, rq = steady_window(pool.raw_i[row], pool.raw_q[row],
                                   dtype=torch.float64)
            with precision.tf32():
                ci, cq = steady_window(pool.raw_i[row], pool.raw_q[row],
                                       dtype=torch.float32)
            err = max(err, float((ci - ri).abs().max()),
                      float((cq - rq).abs().max()))
            ref_in[w] = (ri.cpu().numpy(), rq.cpu().numpy())
            ctl_in[w] = (ci.cpu().numpy(), cq.cpu().numpy())
        numbers["baseband_err"] = err / 0.5
    else:
        from wsprbench.reference.decode import quantize
        pool = gen.baseband(cell.mix, seed, device=device)
        q = cell.config["transfer_dtype"] == "int8"
        ref_in = {w: ((quantize(pool.wi[w]), quantize(pool.wq[w])) if q
                      else (pool.wi[w], pool.wq[w])) for w in checked}
        ctl_in = ref_in
    ref = reference_spots(ref_in, cell.config)
    ctl = reference_spots(ctl_in, cell.config, tf32=True)
    numbers.update(compare.spot_numbers(list(ctl.items()), ref))
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    dev = torch.device(args.device)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings(cell, seed, device=dev)
        out.update(seed=seed, seconds=time.perf_counter() - t, card=card)
        print(json.dumps({"control": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
