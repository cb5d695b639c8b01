"""The search kernels against an earlier checkout's, in turns on one card.

    python3 tools/torch_search_ab.py [OLD_CHECKOUT] [--ptxas] [--variants]
                                     [--out PATH]

``OLD_CHECKOUT`` (default ``_checkout/parent``) is an unpack of an
earlier commit (for example ``git archive d25edeb | tar -x -C
_checkout/parent``). Its kernels are built from that checkout's sources
(into ``_build/``, under names of their own) and called through their C
interfaces; this checkout's run through ``power_rows``, ``coarse_rows``
and ``tone_correlator``. ``ops/csrc/stft.cu`` (a commit from d25edeb on)
is called through ``stft_power``, whose interface has not changed. An
old ``coarse.cu`` or ``correlator.cu`` whose source equals this
checkout's is not built again (its rows time this checkout's kernel
alone); one that differs is taken to be d7ed36f's, whose ``coarse.cu``
takes a (9, 162) int32 table of drift offsets and pr3 bits and whose
``correlator.cu`` takes the (2, 256, 4) tone table.

At each shape ``chip_smoke.py``'s search phase checks, on the port's
copy of bench.py's batch: the STFT at B=128, a dense chunk of 4 windows
with the last zero and decode_window's one, held to the plain version
(rtol 1e-4, atol 1e-6 x each window's peak, a zero window exactly 0)
and timed beside the plain version and one ``torch.stft`` call (cuFFT,
the library yardstick); stage A's coarse grid at B=128 at maxdrift 4, 0
and a (B,) tensor 0..4, the dense chunk (last window at maxdrift 0) and
decode_window's one (rtol 1e-5, atol 1e-6, and its rows equal to the
old kernel's bit for bit); stage B's correlator on 128 staged lanes at
L = 33, 17, 43, 1 and the dense chunk's 800 lanes at L = 33, 43 (rtol
2e-4, atol 2e-3). Old and new are timed in turns (old, new, new, old;
each the median of 25 calls between CUDA events, tools/torch_measure.py
cuda_ms), beside the bound of the kernel's own form (``stft_work``,
``coarse_work``, ``correlator_work``) and the direct form's
(``*_direct_work``). ``--ptxas`` first prints ptxas's registers, spills
and shared memory for this checkout's three sources. ``--variants``
then times, in turns with this checkout's kernels, the designs the
sources chose against, each of which must give the same outputs bit
for bit: stft.cu with a block a tile (no persistent walk, so no copy
overlaps its own block's frames), with tiles of 16 frames on 8 warps,
8 on 8 or 2 on 2 instead of 4 on 4, with 3 staged tiles instead of 2,
with registers capped for 20 or 24 warps an SM instead of 16, and with
16-byte stores through the warp's scratch (at B=128, 4 and 1);
coarse.cu's wide tiles as 4 warps of 8 rows a thread and as 4 warps of
4 rows instead of 8 warps of 4 (``kWideWarps``, ``kWideRows``; B=128 at
maxdrift 4 and 0); and correlator.cu with separate cosf and sinf
instead of sincosf (128 and 800 lanes, 43 jitters). With them, at B=128
in turns with this checkout's kernel, stft.cu with part of its work
taken out, to show what bounds it (the outputs are not compared): no
stores; no FFT (its loads and stores alone); no FFT and no loads (its
stores alone); no stores and no loads (its FFT alone); beside the
card's own write of the powers' bytes (``fill_``). One JSON line a
shape, and the card's name and power limit. Needs the CUDA card; exits
1 on any disagreement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parent.parent)]

from torch_measure import (  # noqa: E402
    coarse_direct_work,
    coarse_work,
    correlator_direct_work,
    correlator_work,
    cuda_ms,
    make_batch,
    nvidia_smi_card,
    polyphase_bound,
    stft_direct_work,
    stft_work,
)

from rtlsdr_wsprd_tpu_torch.buildlib import (  # noqa: E402
    BUILD_DIR,
    build_shared,
    nvcc_path,
)
from rtlsdr_wsprd_tpu_torch.device import const  # noqa: E402
from rtlsdr_wsprd_tpu_torch.ops import coarse, stft, sync  # noqa: E402
from rtlsdr_wsprd_tpu_torch.ops.fano import NVCC_FLAGS  # noqa: E402

CSRC = "rtlsdr_wsprd_tpu_torch/ops/csrc"
COARSE_RTOL, COARSE_ATOL = 1e-5, 1e-6
CORR_RTOL, CORR_ATOL = 2e-4, 2e-3
STFT_RTOL, STFT_ATOL_OF_PEAK = 1e-4, 1e-6
_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# stft_power(xi, xq, stride_i, stride_q, hann, cos_sin, n, out, stream)
_STFT_ARGS = [_vp, _vp, _cll, _cll, _vp, _vp, _ci, _vp, _vp]


def ptxas_report() -> None:
    """nvcc -Xptxas -v on this checkout's three search sources."""
    root = Path(__file__).resolve().parent.parent
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    failed = False
    for src in ("stft.cu", "coarse.cu", "correlator.cu"):
        r = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(BUILD_DIR / f"ptxas_{src}.so"), str(root / CSRC / src)],
            capture_output=True, text=True, timeout=600)
        lines = [ln for ln in r.stderr.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln
                 or "error" in ln]
        print(f"ptxas {src} (rc {r.returncode}):\n  " + "\n  ".join(lines))
        failed |= r.returncode != 0
    if failed:
        sys.exit(1)


def old_kernels(checkout: Path) -> dict:
    """The old checkout's stft_power, coarse_rows and tone_correlator,
    built and bound, by source name; None for a coarse or correlator
    source equal to this checkout's."""
    here = Path(__file__).resolve().parent.parent / CSRC
    fns = {}
    for src, fn, argtypes in (
            ("stft.cu", "stft_power", _STFT_ARGS),
            ("coarse.cu", "coarse_rows", [_vp, _vp, _vp, _ci, _vp, _vp, _vp]),
            ("correlator.cu", "tone_correlator",
             [_vp, _vp, _vp, _vp, _vp, _ci, _vp, ctypes.c_float, _ci, _vp,
              _vp])):
        path = checkout / CSRC / src
        if src != "stft.cu" and path.read_bytes() == (here / src).read_bytes():
            fns[src] = None
            continue
        lib = ctypes.CDLL(str(build_shared(
            f"{path.stem}_old", nvcc_path(), [path], NVCC_FLAGS)))
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _ci
        fns[src] = getattr(lib, fn)
    return fns


def call_stft(fn, si, sq):
    """An stft_power entry point (old, or a variant) on the planes:
    (B, 347, 512) row-major, as ``stft.power_rows`` returns."""
    dev = si.device
    # the wrapper's own tables, uploaded once: no copy inside a timed call
    hann, cos_sin = const(stft.HANN, dev), const(stft.TWIDDLE, dev)
    out = torch.empty((si.shape[0], stft.BLOCKS, 512), dtype=torch.float32,
                      device=dev)
    rc = fn(si.data_ptr(), sq.data_ptr(), si.stride(0), sq.stride(0),
            hann.data_ptr(), cos_sin.data_ptr(), si.shape[0], out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"stft_power: CUDA error {rc}")
    return out


def old_coarse(fn, ps, md):
    B = ps.shape[0]
    dev = ps.device
    table = torch.from_numpy(np.ascontiguousarray(
        2 * coarse._fd_int().T + coarse.PR3_VECTOR[None, :],
        np.int32)).to(dev)
    val = torch.empty((B, 512), dtype=torch.float32, device=dev)
    arg = torch.empty((B, 512), dtype=torch.int32, device=dev)
    rc = fn(ps.data_ptr(), table.data_ptr(), md.data_ptr(), B,
            val.data_ptr(), arg.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"old coarse kernel: CUDA error {rc}")
    return val, arg


def old_correlator(fn, wr, wi, freq, drift, offs):
    G, L = wr.shape[0], len(offs)
    dev = wr.device
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    etone = torch.from_numpy(np.stack([sync.E_TONE_R, sync.E_TONE_I])).to(dev)
    out = torch.empty((G, 162, L, 4), dtype=torch.float32, device=dev)
    rc = fn(wr.data_ptr(), wi.data_ptr(), freq.data_ptr(), drift.data_ptr(),
            offs_t.data_ptr(), L, etone.data_ptr(),
            float(np.float32(sync.TWOPIDT)), G, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"old correlator kernel: CUDA error {rc}")
    return out


# (source, C function, argument types, [(text, replacement)]): the
# designs the sources chose against
VARIANTS = {
    "stft, a block a tile": (
        "stft.cu", "stft_power", _STFT_ARGS,
        [("  stft_kernel<<<total < fit ? total : fit, kThreads,",
          "  stft_kernel<<<total, kThreads,")]),
    "stft, tiles of 16 frames, 8 warps": (
        "stft.cu", "stft_power", _STFT_ARGS,
        [("constexpr int kTile = 4;", "constexpr int kTile = 16;"),
         ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")]),
    "stft, tiles of 8 frames, 8 warps": (
        "stft.cu", "stft_power", _STFT_ARGS,
        [("constexpr int kTile = 4;", "constexpr int kTile = 8;"),
         ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")]),
    "stft, tiles of 2 frames, 2 warps": (
        "stft.cu", "stft_power", _STFT_ARGS,
        [("constexpr int kTile = 4;", "constexpr int kTile = 2;"),
         ("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")]),
    "stft, 3 staged tiles": (
        "stft.cu", "stft_power", _STFT_ARGS,
        [("constexpr int kSlots = 2;", "constexpr int kSlots = 3;")]),
    "stft, 20 warps an SM": (
        "stft.cu", "stft_power", _STFT_ARGS,
        [("__launch_bounds__(kThreads, 16 / kWarps)",
          "__launch_bounds__(kThreads, 20 / kWarps)")]),
    "stft, 24 warps an SM": (
        "stft.cu", "stft_power", _STFT_ARGS,
        [("__launch_bounds__(kThreads, 16 / kWarps)",
          "__launch_bounds__(kThreads, 24 / kWarps)")]),
    "stft, 16-byte stores": (
        "stft.cu", "stft_power", _STFT_ARGS,
        [("  fft16(a);\n  // the last radix 2",
          "  fft16(a);\n  __syncwarp();\n  // the last radix 2"),
         ("    ob[16 * k + 256] = z0.re * z0.re + z0.im * z0.im;\n"
          "    ob[16 * k] = z1.re * z1.re + z1.im * z1.im;\n"
          "  }\n",
          # column c at c + 16 (c / 128) of the scratch, then 4 columns a
          # lane to the frame's row
          "    const int m = m1 + 16 * (k + 8 * v);\n"
          "    float* pw = reinterpret_cast<float*>(scr);\n"
          "    pw[m + 256 + 16 * ((m + 256) >> 7)] = "
          "z0.re * z0.re + z0.im * z0.im;\n"
          "    pw[m + 16 * (m >> 7)] = z1.re * z1.re + z1.im * z1.im;\n"
          "  }\n"
          "  __syncwarp();\n"
          "#pragma unroll\n"
          "  for (int j = 0; j < 4; ++j)\n"
          "    reinterpret_cast<float4*>(o)[lane + 32 * j] =\n"
          "        reinterpret_cast<const float4*>(scr)[lane + 36 * j];\n")]),
    "coarse, 4 warps x 8 rows": (
        "coarse.cu", "coarse_rows", [_vp, _vp, _vp, _ci, _vp, _vp, _vp],
        [("constexpr int kWideRows = 4;", "constexpr int kWideRows = 8;"),
         ("constexpr int kWideWarps = 8;", "constexpr int kWideWarps = 4;")]),
    "coarse, 4 warps x 4 rows": (
        "coarse.cu", "coarse_rows", [_vp, _vp, _vp, _ci, _vp, _vp, _vp],
        [("constexpr int kWideWarps = 8;", "constexpr int kWideWarps = 4;")]),
    "correlator, cosf and sinf": (
        "correlator.cu", "tone_correlator",
        [_vp, _vp, _vp, _vp, _vp, _ci, _ci, _vp, ctypes.c_float, _ci, _vp,
         _vp],
        [("      float sn, ecr;\n      sincosf(ph, &sn, &ecr);\n"
          "      const float eci = -sn;",
          "      const float ecr = cosf(ph);\n"
          "      const float eci = -sinf(ph);")]),
}


# stft.cu with a part of its work taken out, to see what bounds it: the
# stores kept only under a condition no value meets; the FFT replaced by
# a lane's 16 staged samples written to the frame's row (the same
# stores); the copies of the staged tiles never issued
_STORES = ("    ob[16 * k + 256] = z0.re * z0.re + z0.im * z0.im;\n"
           "    ob[16 * k] = z1.re * z1.re + z1.im * z1.im;\n")
_NO_STORES = (_STORES, "    if (z0.re == 1234.5f && z1.im == 77.0f) {\n"
              + _STORES + "    }\n")
_FFT = "  Cx a[kPoints];\n  // pass 1"
_NO_FFT = (_FFT, "  for (int r = 0; r < kPoints; ++r)\n"
           "    o[lane + 32 * r] =\n"
           "        si[lane + 32 * r] * w[r] + sq[lane + 32 * r];\n"
           "  return;\n" + _FFT)
_NO_LOADS = [
    ("    if (p + s * step < total) stage(p + s * step, s);",
     "    if (p + s * step < 0) stage(p + s * step, s);"),
    ("    if (ahead < total) stage(ahead, (i + kSlots - 1) % kSlots);",
     "    if (ahead < 0) stage(ahead, (i + kSlots - 1) % kSlots);")]
PROBES = {
    "stft, no stores": ("stft.cu", "stft_power", _STFT_ARGS, [_NO_STORES]),
    "stft, no FFT": ("stft.cu", "stft_power", _STFT_ARGS, [_NO_FFT]),
    "stft, no FFT, no loads": ("stft.cu", "stft_power", _STFT_ARGS,
                               [_NO_FFT, *_NO_LOADS]),
    "stft, no stores, no loads": ("stft.cu", "stft_power", _STFT_ARGS,
                                  [_NO_STORES, *_NO_LOADS]),
}


def variant_kernel(key: str):
    """This checkout's source of ``key`` (a variant or a probe) with its
    replacements, built and bound."""
    src, fn, argtypes, subs = {**VARIANTS, **PROBES}[key]
    text = (Path(__file__).resolve().parent.parent / CSRC / src).read_text()
    for a, b in subs:
        if text.count(a) != 1:
            raise RuntimeError(f"{src}: {a!r} not found once")
        text = text.replace(a, b)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"variant_{src}"
    path.write_text(text)
    lib = ctypes.CDLL(str(build_shared(f"variant_{path.stem}", nvcc_path(),
                                       [path], NVCC_FLAGS)))
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = _ci
    return getattr(lib, fn)


def in_turns(old, new) -> dict:
    """old, new, new, old: each the median of 25 calls."""
    t = [cuda_ms(f) for f in (old, new, new, old)]
    return dict(old_ms=[t[0], t[3]], new_ms=[t[1], t[2]])


def timed(old, new) -> dict:
    """``in_turns`` when there is an old kernel, else new alone."""
    return in_turns(old, new) if old else dict(new_ms=[cuda_ms(new)])


def bounds(name, work, direct) -> dict:
    b = polyphase_bound(*work, "cuda", name)
    d = polyphase_bound(*direct, "cuda", name)
    return dict(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                direct_bound_ms=d["bound_ms"], direct_bound_by=d["bound_by"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkout", nargs="?", default="_checkout/parent")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--out", default=None,
                    help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from rtlsdr_wsprd_tpu_torch.config import DecoderOptions
    from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc

    card = nvidia_smi_card()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    if args.ptxas:
        ptxas_report()
    old = old_kernels(Path(args.checkout))
    old_stft, old_rows, old_corr = (old[k] for k in (
        "stft.cu", "coarse.cu", "correlator.cu"))
    dev = torch.device("cuda", 0)
    opts = DecoderOptions()
    wi, wq, _ = make_batch(128)
    rows, bad = [], []
    variants = {}

    def variant_fn(key):
        if key not in variants:
            variants[key] = variant_kernel(key)
        return variants[key]

    W = mc.DENSE_WINDOWS
    # the STFT at its launch shapes: the staged decode's batch, a dense
    # chunk whose last window is zero, decode_window's one
    for B, label in ((128, "the staged decode's batch"),
                     (W, f"dense chunk, window {W - 1} zero"),
                     (1, "decode_window")):
        si = torch.from_numpy(wi[:B]).to(dev)
        sq = torch.from_numpy(wq[:B]).to(dev)
        if B == W:
            si[-1], sq[-1] = 0.0, 0.0
        got = stft.power_rows(si, sq)
        was = call_stft(old_stft, si, sq)
        plain = stft.power_spectrogram_plain(si, sq).transpose(1, 2)
        torch.cuda.synchronize()
        peak = plain.amax(dim=(1, 2))
        err = (got - plain).abs()
        zero = peak == 0
        ok = bool((err <= STFT_RTOL * plain.abs()
                   + STFT_ATOL_OF_PEAK * peak[:, None, None]).all()
                  and not (got[zero] != 0).any())
        x = torch.complex(si[:, :stft.SPAN], sq[:, :stft.SPAN])
        hann = torch.from_numpy(stft.HANN).to(dev)
        row = dict(kernel="stft", shape=f"B={B}, {label}",
                   max_abs_err=float(err.max()),
                   max_abs_err_old=float((was - plain).abs().max()),
                   max_abs_diff_old=float((got - was).abs().max()),
                   zero_windows=int(zero.sum()),
                   **in_turns(lambda: call_stft(old_stft, si, sq),
                              lambda: stft.power_rows(si, sq)),
                   plain_ms=cuda_ms(
                       lambda: stft.power_spectrogram_plain(si, sq)),
                   library_ms=cuda_ms(lambda: torch.stft(
                       x, n_fft=512, hop_length=128, window=hann,
                       center=False, return_complex=True)),
                   **bounds(name, stft_work(B), stft_direct_work(B)))
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not ok:
            bad.append(row["shape"])
        del x, plain, err, was
        for key in (VARIANTS if args.variants else ()):
            if not key.startswith("stft"):
                continue
            fn = variant_fn(key)
            vout = call_stft(fn, si, sq)
            torch.cuda.synchronize()
            vrow = dict(kernel="stft", variant=key.split(", ", 1)[1],
                        shape=row["shape"], equal=bool(torch.equal(vout, got)),
                        **in_turns(lambda: call_stft(fn, si, sq),
                                   lambda: stft.power_rows(si, sq)))
            vrow["variant_ms"] = vrow.pop("old_ms")
            rows.append(vrow)
            print(json.dumps(vrow), flush=True)
            if not vrow["equal"]:
                bad.append(f"variant {key} {vrow['shape']}")
        if args.variants and B == 128:
            # the card's own write of as many bytes as the powers
            sink = torch.empty_like(got)
            row = dict(kernel="stft", probe="torch fill_ of the powers",
                       shape=f"B={B}", ms=cuda_ms(lambda: sink.fill_(1.0)))
            rows.append(row)
            print(json.dumps(row), flush=True)
            for key in PROBES:
                fn = variant_fn(key)
                row = dict(kernel="stft", probe=key.split(", ", 1)[1],
                           shape=f"B={B}",
                           **in_turns(lambda: call_stft(fn, si, sq),
                                      lambda: stft.power_rows(si, sq)))
                row["probe_ms"] = row.pop("old_ms")
                rows.append(row)
                print(json.dumps(row), flush=True)
        del got
        torch.cuda.empty_cache()

    md_chunk = torch.full((W,), opts.maxdrift, dtype=torch.int32, device=dev)
    md_chunk[-1] = 0
    cases = [(128, torch.full((128,), 4, dtype=torch.int32, device=dev),
              "maxdrift 4"),
             (128, torch.zeros(128, dtype=torch.int32, device=dev),
              "maxdrift 0"),
             (128, torch.arange(128, dtype=torch.int32, device=dev) % 5,
              "maxdrift (B,) 0..4"),
             (W, md_chunk, f"dense chunk, window {W - 1} zero-padded"),
             (1, torch.full((1,), 4, dtype=torch.int32, device=dev),
              "decode_window, maxdrift (1,) 4")]
    for B, md, label in cases:
        si = torch.from_numpy(wi[:B]).to(dev)
        sq = torch.from_numpy(wq[:B]).to(dev)
        if B == W:
            si[-1], sq[-1] = 0.0, 0.0
        ps = stft.power_spectrogram(si, sq)
        val, arg = coarse.coarse_rows(ps, md)
        pval, _ = coarse._row_max_plain(ps, md)
        same = True
        if old_rows:
            oval, oarg = old_coarse(old_rows, ps, md)
            same = bool(torch.equal(val, oval) and torch.equal(arg, oarg))
        torch.cuda.synchronize()
        err = float((val - pval).abs().max())
        ok_plain = bool(((val - pval).abs()
                         <= COARSE_RTOL * pval.abs() + COARSE_ATOL).all())
        mdh = md.cpu().numpy()
        row = dict(kernel="coarse", shape=f"B={B}, {label}",
                   max_abs_err=err, equal_to_old=same if old_rows else None,
                   **timed(old_rows and (
                       lambda: old_coarse(old_rows, ps, md)),
                           lambda: coarse.coarse_rows(ps, md)),
                   **bounds(name, coarse_work(B, mdh),
                            coarse_direct_work(B, mdh)))
        rows.append(row)
        print(json.dumps(row), flush=True)
        if not (ok_plain and same):
            bad.append(row["shape"])
        for key in (VARIANTS if args.variants and B == 128 and label in (
                "maxdrift 4", "maxdrift 0") else ()):
            if not key.startswith("coarse"):
                continue
            fn = variant_fn(key)
            sign = torch.from_numpy(coarse._PR3_SIGN).to(dev)
            vval = torch.empty_like(val)
            varg = torch.empty_like(arg)

            def run_variant():
                rc = fn(ps.data_ptr(), sign.data_ptr(), md.data_ptr(), B,
                        vval.data_ptr(), varg.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
                if rc:
                    raise RuntimeError(f"variant: CUDA error {rc}")

            run_variant()
            torch.cuda.synchronize()
            vrow = dict(kernel="coarse", variant=key.split(", ")[1],
                        shape=f"B={B}, {label}",
                        equal=bool(torch.equal(vval, val)
                                   and torch.equal(varg, arg)),
                        **in_turns(run_variant,
                                   lambda: coarse.coarse_rows(ps, md)))
            vrow["variant_ms"] = vrow.pop("old_ms")
            rows.append(vrow)
            print(json.dumps(vrow), flush=True)
            if not vrow["equal"]:
                bad.append(f"variant {key} {vrow['shape']}")

    # stage-B lanes as chip_smoke.py's search phase makes them
    B = 128
    si = torch.from_numpy(wi[:B]).to(dev)
    sq = torch.from_numpy(wq[:B]).to(dev)
    md4 = torch.full((B,), opts.maxdrift, dtype=torch.int32, device=dev)
    sA = mc._stage_a_packed(si, sq, md4, fmin=opts.fmin, fmax=opts.fmax)
    w_idx, c_idx = torch.nonzero(sA[:, 1] != 0, as_tuple=True)
    w_idx, c_idx = w_idx[:128], c_idx[:128]
    pi, pq = sync._padded_signals(si, sq)
    lanes = {
        "staged": (w_idx, sA[w_idx, 2, c_idx], sA[w_idx, 3, c_idx],
                   sA[w_idx, 4, c_idx]),
        "dense chunk": (torch.arange(W, device=dev).repeat_interleave(
            sA.shape[2]), *(sA[:W, k].reshape(-1) for k in (2, 3, 4)))}
    sets = {33: sync._rel_lags(8), 17: sync._rel_lags(16),
            43: sync.jitter_offsets(3, False), 1: sync.jitter_offsets(3, True)}
    for label, (lw, freq, shift, drift) in lanes.items():
        wr_, wi_ = sync._lane_windows(pi, pq, lw, shift.to(torch.int32))
        freq, drift = freq.contiguous(), drift.contiguous()
        G = wr_.shape[0]
        for L in ((33, 17, 43, 1) if label == "staged" else (33, 43)):
            offs = tuple(int(r) + sync.HALF_SPAN for r in sets[L])
            got = sync.tone_correlator(wr_, wi_, freq, drift, offs)
            want = sync._tone_mags_offsets_plain(wr_, wi_, freq, drift, offs)
            err_old = None
            if old_corr:
                err_old = float((old_correlator(
                    old_corr, wr_, wi_, freq, drift, offs) - want).abs().max())
            torch.cuda.synchronize()
            err = (got - want).abs()
            ok = bool((err <= CORR_RTOL * want.abs() + CORR_ATOL).all())
            row = dict(
                kernel="correlator", shape=f"{G} lanes ({label}), L={L}",
                max_abs_err=float(err.max()), max_abs_err_old=err_old,
                **timed(
                    old_corr and (lambda: old_correlator(
                        old_corr, wr_, wi_, freq, drift, offs)),
                    lambda: sync.tone_correlator(wr_, wi_, freq, drift,
                                                 offs)),
                **bounds(name, correlator_work(G, L),
                         correlator_direct_work(G, L)))
            rows.append(row)
            print(json.dumps(row), flush=True)
            if not ok:
                bad.append(row["shape"])
            if args.variants and L == 43:
                fn = variant_fn("correlator, cosf and sinf")
                plan, n_slots = sync._correlator_plan(offs)
                plan_t = torch.from_numpy(plan).to(dev)
                etone = torch.from_numpy(sync._prefix_tone_table()).to(dev)
                vout = torch.empty_like(got)

                def run_variant():
                    rc = fn(wr_.data_ptr(), wi_.data_ptr(), freq.data_ptr(),
                            drift.data_ptr(), plan_t.data_ptr(), L, n_slots,
                            etone.data_ptr(), float(np.float32(sync.TWOPIDT)),
                            G, vout.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
                    if rc:
                        raise RuntimeError(f"variant: CUDA error {rc}")

                run_variant()
                torch.cuda.synchronize()
                vrow = dict(kernel="correlator", variant="cosf and sinf",
                            shape=row["shape"],
                            equal=bool(torch.equal(vout, got)),
                            **in_turns(run_variant,
                                       lambda: sync.tone_correlator(
                                           wr_, wi_, freq, drift, offs)))
                vrow["variant_ms"] = vrow.pop("old_ms")
                rows.append(vrow)
                print(json.dumps(vrow), flush=True)
                if not vrow["equal"]:
                    bad.append(f"variant {vrow['shape']}")
    print(f"card: {card}")
    if args.out:
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    if bad:
        print(f"disagreements: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
