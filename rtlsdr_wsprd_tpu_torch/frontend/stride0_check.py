"""Hold the one-filter polyphase calls bit for bit against the kernels
from before the filter-bank form.

    python -m rtlsdr_wsprd_tpu_torch.frontend.stride0_check OLD_CHECKOUT

``OLD_CHECKOUT`` is an unpack of a commit whose ``polyphase.cu`` and
``polyphase_tc.cu`` take no per-row filter stride (for example
``git archive 14fd0ba | tar -x -C DIR``). Both of its kernels are built
from that checkout's sources (into ``_build/``, under names of their
own) and called through their old C interfaces; this checkout's
``polyphase_decimate`` runs with one filter (row stride 0 of the filter
tables) on the same seeded inputs at the one-filter shapes
``chip_smoke.py``'s kernel phase checks. Every output must be equal,
bit for bit. Needs the CUDA card; exits 1 on any difference.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

from ..buildlib import build_shared, nvcc_path
from .decimate import STAGE1, STAGE2
from .polyphase import NVCC_FLAGS, _route, polyphase_decimate

_vp, _ll, _ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# route -> (source, C function, its argument types before the stride)
_OLD = {
    "direct": ("polyphase.cu", "polyphase_decimate",
               [_vp, _vp, _ll, _ll, _ci, _vp, _vp, _ci, _ci, _ll, _vp, _vp,
                _ll, _vp]),
    "tc": ("polyphase_tc.cu", "polyphase_tc_decimate",
           [_vp, _vp, _ll, _ll, _ci, _vp, _ll, _vp, _vp, _ll, _vp]),
}
# stage, input dtype, rows, frames, row offset in elements
CASES = [
    ("stage1", "uint8", 8, 296000, 0), ("stage1", "uint8", 8, 304000, 0),
    ("stage1", "uint8", 8, 7997, 0), ("stage1", "uint8", 8, 8000, 0),
    ("stage1", "uint8", 8, 129, 0), ("stage1", "uint8", 8, 1, 0),
    ("stage1", "uint8", 8, 8000, 1), ("stage1", "uint8", 8, 120000, 0),
    ("stage1", "uint8", 2, 120000, 0),
    ("stage1", "float32", 8, 8000, 0), ("stage1", "float32", 8, 8000, 1),
    ("stage1", "float32", 1, 300000, 0), ("stage1", "float32", 1, 30000, 0),
    ("stage2", "float32", 8, 3700, 0), ("stage2", "float32", 8, 3800, 0),
    ("stage2", "float32", 8, 99, 0), ("stage2", "float32", 8, 100, 0),
    ("stage2", "float32", 8, 3700, 1), ("stage2", "float32", 1, 3750, 0),
    ("stage2", "float32", 1, 375, 0), ("stage2", "float32", 8, 1500, 0),
]


def old_kernels(checkout: Path) -> dict:
    """The old checkout's two kernels, built and bound, by route."""
    fns = {}
    for route, (src, fn, argtypes) in _OLD.items():
        path = checkout / "rtlsdr_wsprd_tpu_torch/frontend/csrc" / src
        lib = ctypes.CDLL(str(build_shared(
            f"{path.stem}_one_filter", nvcc_path(), [path], NVCC_FLAGS)))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _ci
        fns[route] = getattr(lib, fn)
    return fns


def old_call(fns, xI, xQ, filt, n_frames, route):
    """One old kernel launch with the wrapper's alignment rule."""
    rows = xI.shape[0]
    out = torch.empty((2, rows, n_frames), dtype=torch.float32,
                      device=xI.device)
    row_bytes = xI.stride(0) * xI.element_size() if rows > 1 else 0
    vec = int((xI.data_ptr() | xQ.data_ptr() | row_bytes) % 16 == 0)
    tabs = filt.tensors(xI.device)
    stream = torch.cuda.current_stream(xI.device).cuda_stream
    if route == "tc":
        rc = fns[route](xI.data_ptr(), xQ.data_ptr(), rows, xI.stride(0),
                        vec, tabs.b_frag.data_ptr(), n_frames,
                        out[0].data_ptr(), out[1].data_ptr(), n_frames,
                        stream)
    else:
        rc = fns[route](xI.data_ptr(), xQ.data_ptr(), rows, xI.stride(0),
                        vec, tabs.gr.data_ptr(), tabs.gi.data_ptr(), filt.T,
                        filt.R, n_frames, out[0].data_ptr(),
                        out[1].data_ptr(), n_frames, stream)
    if rc != 0:
        raise RuntimeError(f"old {route} kernel: error {rc}")
    return out[0], out[1]


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__)
        return 2
    fns = old_kernels(Path(argv[0]).resolve())
    rng = np.random.default_rng(1)
    differ = 0
    for stage, dt, C, n, off in CASES:
        filt = STAGE1 if stage == "stage1" else STAGE2
        L = n * filt.R + filt.T - filt.R
        if dt == "uint8":
            h = rng.integers(0, 256, (2, C, L + off), dtype=np.uint8)
        else:
            h = rng.normal(0, 10, (2, C, L + off)).astype(np.float32)
        xI, xQ = (torch.from_numpy(a).cuda()[:, off:] for a in h)
        route = _route("cuda", xI.dtype, filt)
        kI, kQ = polyphase_decimate(xI, xQ, filt, n)
        oI, oQ = old_call(fns, xI, xQ, filt, n, route)
        same = torch.equal(kI, oI) and torch.equal(kQ, oQ)
        differ += not same
        print(f"{route} {stage} {dt} C={C} x {n} frames, row offset {off}: "
              f"bit-equal to the old kernel: {same}")
    print(f"stride0_check: {len(CASES) - differ} of {len(CASES)} shapes "
          "bit-equal")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
