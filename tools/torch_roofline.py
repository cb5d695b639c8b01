"""Roofline accounting of the PyTorch/CUDA port's device phases.

The counterpart of tools/roofline.py: one row per device phase at the
bench shapes (the port's copy of bench.py's ``make_batch``):

- stage A (``_stage_a_packed``: STFT, candidates, coarse grid) on B
  windows;
- stage B (``_stage_b_packed``: fine sync at lagstep 8 and the soft
  symbols of the 43-jitter schedule, FEC gates) on one lane a window;
- the front end's stage 1 on uint8 C=128 x 9,375 frames (polyphase_tc.cu
  on the card);
- the channelizer's folded step (``channelize._folded_frontend_step``)
  at K=4 dials over one raw stream.

Each row: device ms (CUDA events, the card spinning while the host
enqueues: torch_measure.cuda_ms), GFLOP, GB, achieved TFLOP/s and GB/s,
arithmetic intensity, and the shares of the card's published FP32 peak
and memory rate (torch_measure.PEAKS). Then the measured streaming
bandwidth (a 256 MB axpy and a 256 MB sum), candidate syncs/s (the
coarse grid's B x 512 x 32 x 9 scores over stage A's time), the front
end's Msps and the channelizer's decoded dials per card.

PyTorch has no cost analysis of a compiled program, so the work is
counted here (``WorkCounter``): a ``TorchDispatchMode`` sees every aten
op of the phase; a matrix product costs what
``torch.utils.flop_counter`` says (2 m k n for ``mm``), any other op one
FLOP an output element; its bytes are its inputs plus its outputs, views
and allocations costing nothing. That is the traffic of unfused ops, an
upper bound on the HBM bytes. The hand-written kernels are called
through ctypes, which the dispatcher never sees: their calls on the card
are counted with the formulas chip_smoke.py's kernel rows use
(``torch_measure.polyphase_work``, ``stft_work`` for stage A's power
spectrogram, ``coarse_work`` for its coarse grid, ``correlator_work``
for stage B's tone correlator: the work of the kernels' own forms).
Beside each row, the same phase with those three kernels counted in
their direct form (``stft_direct_work``, the plain version's four DFT
products; ``coarse_direct_work``, ``correlator_direct_work``: every
grid point's tone reads, every offset's 256-term dot products), for
rows comparable across designs.

Usage: python tools/torch_roofline.py [B] [--device DEV]
B windows (default 128); ``--device`` defaults to the CUDA card
(``cpu`` runs the plain PyTorch versions, timed by the host clock, with
no shares of a peak). Prints the table beside the card's name and power
limit, then one JSON line. On the card it also traces one stage A call
under torch.profiler: the device ms of its kernels, of the STFT and
coarse kernels, of ``smoothed_spectrum``'s ``ps.sum(dim=-1)`` and of the
rest of its torch ops (``stage_a_profile`` in the JSON line).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rtlsdr_wsprd_tpu_torch.config import DecoderOptions  # noqa: E402
from rtlsdr_wsprd_tpu_torch.device import resolve_device  # noqa: E402
from rtlsdr_wsprd_tpu_torch.frontend import channelize, decimate  # noqa: E402
from rtlsdr_wsprd_tpu_torch.frontend.filters import (  # noqa: E402
    R1,
    STAGE1_TAPS,
)
from rtlsdr_wsprd_tpu_torch.ops import coarse, stft, sync  # noqa: E402
from rtlsdr_wsprd_tpu_torch.ops.sync import jitter_offsets  # noqa: E402
from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc  # noqa: E402
from torch_measure import (  # noqa: E402
    card_peaks,
    coarse_direct_work,
    coarse_work,
    correlator_direct_work,
    correlator_work,
    cuda_ms,
    device_banner,
    make_batch,
    polyphase_work,
    stft_direct_work,
    stft_work,
)

# ops that move no data: allocations and metadata-only results (by
# name: not every PyTorch release has each)
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::_unsafe_view", "aten::_reshape_alias",
               "aten::detach", "aten::lift_fresh"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class WorkCounter(TorchDispatchMode):
    """FLOPs and bytes of the aten ops run under it (see the module
    docstring), plus the hand-written kernels' calls noted by
    ``counting``: ``mm_flops`` (matrix products), ``other_flops``,
    ``bytes``, ``kernel_flops``, ``kernel_bytes``, and the kernels' work
    with the search kernels in their direct form, ``direct_kernel_flops``
    and ``direct_kernel_bytes``."""

    def __init__(self):
        super().__init__()
        self.mm_flops = 0
        self.other_flops = 0
        self.bytes = 0
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self.direct_kernel_flops = 0
        self.direct_kernel_bytes = 0

    @property
    def flops(self) -> int:
        return self.mm_flops + self.other_flops + self.kernel_flops

    @property
    def total_bytes(self) -> int:
        return self.bytes + self.kernel_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func.name().split(".")[0] in _NO_TRAFFIC:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.mm_flops += int(formula(*args, **kwargs, out_val=out))
        else:
            self.other_flops += sum(t.numel() for t in outs)
        return out


@contextlib.contextmanager
def counting():
    """A WorkCounter over the block, with the hand-written kernels'
    calls on the card counted by their formulas: the front end's and the
    channelizer's polyphase calls, stage A's power spectrogram and
    coarse grid and stage B's tone correlator (on the CPU they run the
    plain versions, whose aten ops the counter sees)."""
    real = decimate.polyphase_decimate
    real_rows, real_corr = coarse.coarse_rows, sync.tone_correlator
    real_stft = stft.power_rows
    counter = WorkCounter()

    def add(work, direct=None):
        counter.kernel_bytes += work[0]
        counter.kernel_flops += work[1]
        direct = direct or work
        counter.direct_kernel_bytes += direct[0]
        counter.direct_kernel_flops += direct[1]

    def noting_rows(ps, maxdrift):
        if ps.device.type == "cuda":
            md = maxdrift.cpu().numpy() if torch.is_tensor(maxdrift) \
                else maxdrift
            add(coarse_work(ps.shape[0], md),
                coarse_direct_work(ps.shape[0], md))
        return real_rows(ps, maxdrift)

    def noting_stft(i, q):
        add(stft_work(i.shape[0]), stft_direct_work(i.shape[0]))
        return real_stft(i, q)

    def noting_corr(wr, wi, freq, drift, offsets):
        add(correlator_work(wr.shape[0], len(offsets)),
            correlator_direct_work(wr.shape[0], len(offsets)))
        return real_corr(wr, wi, freq, drift, offsets)

    def noting(xI, xQ, filt, n_frames):
        if xI.device.type == "cuda":
            bank = isinstance(filt, (list, tuple))
            C = xI.shape[0] if xI.dim() == 2 else 1
            add(polyphase_work(filt, C, xI.shape[-1], n_frames,
                               xI.element_size(), one_stream=bank))
        return real(xI, xQ, filt, n_frames)

    decimate.polyphase_decimate = noting
    channelize.polyphase_decimate = noting
    coarse.coarse_rows, sync.tone_correlator = noting_rows, noting_corr
    stft.power_rows = noting_stft
    try:
        with counter:
            yield counter
    finally:
        decimate.polyphase_decimate = real
        channelize.polyphase_decimate = real
        coarse.coarse_rows, sync.tone_correlator = real_rows, real_corr
        stft.power_rows = real_stft


def work(fn) -> WorkCounter:
    """The counted work of one call of ``fn``."""
    with counting() as counter:
        fn()
    return counter


def phase_ms(fn, dev) -> float:
    """One call's time: device ms on the card, host ms on the CPU."""
    if dev.type == "cuda":
        return cuda_ms(fn)
    fn()
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def stage_a_fn(si, sq, md, options: DecoderOptions):
    return lambda: mc._stage_a_packed(si, sq, md, fmin=options.fmin,
                                      fmax=options.fmax)


def stage_a_profile(fn, B: int) -> dict:
    """One stage A call (``fn``, on the card, after a warm one) under
    torch.profiler: the device ms of every kernel it ran, by name; of
    ``smoothed_spectrum``'s ``ps.sum(dim=-1)`` (``aten::sum`` on the
    (B, 512, 347) spectrogram); of the STFT and coarse kernels; and of
    the rest of stage A's torch ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, ps_sum = {}, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
        elif (e.name == "aten::sum" and e.input_shapes
              and list(e.input_shapes[0]) == [B, 512, stft.BLOCKS]):
            ps_sum += e.device_time_total / 1e3
    total = sum(kernels.values())
    ours = {k: sum(v for n, v in kernels.items() if k in n)
            for k in ("stft_kernel", "coarse_rows_kernel")}
    return dict(device_ms=total, stft_ms=ours["stft_kernel"],
                coarse_ms=ours["coarse_rows_kernel"], ps_sum_ms=ps_sum,
                rest_ms=total - sum(ours.values()) - ps_sum,
                kernels=sorted(kernels.items(), key=lambda kv: -kv[1]))


def stage_b_fn(si, sq, options: DecoderOptions):
    """Stage B on one lane a window (the JAX tool's lanes)."""
    dev = si.device
    L = si.shape[0]
    lane_w = torch.arange(L, dtype=torch.int64, device=dev)
    freq = torch.from_numpy(np.linspace(-80, 80, L).astype(np.float32))
    shift = torch.from_numpy((np.arange(L) * 97 % 4000).astype(np.int32))
    drift = torch.from_numpy(np.linspace(-3, 3, L).astype(np.float32))
    args = (lane_w, freq.to(dev), shift.to(dev), drift.to(dev),
            torch.ones(L, dtype=torch.bool, device=dev))
    return lambda: mc._stage_b_packed(
        si, sq, *args, lagstep=8, iifac=options.iifac, quickmode=False,
        symfac=options.symfac, minsync1=options.minsync1,
        minsync2=options.minsync2, minrms=options.minrms)


def frontend_fn(dev, C: int = 128, n_frames: int = 9_375):
    L = n_frames * R1 + STAGE1_TAPS - R1
    rng = np.random.default_rng(3)
    xI, xQ = (torch.from_numpy(rng.integers(0, 256, (C, L), np.uint8))
              .to(dev) for _ in range(2))
    return lambda: decimate.decimate_stage1(xI, xQ, n_frames, device=dev)


CHAN_OFFSETS = (0.0, 50_000.0, -200_000.0, 1_000_000.0)


def channelizer_fn(dev, K: int = 4):
    """One folded step of the device channelizer at K dials over one
    uint8 raw stream of its work quantum."""
    cz = channelize.ChannelizingStreamingDecimator(
        list(CHAN_OFFSETS[:K]), placement="device", device=dev)
    n_mid = cz.QUANT1
    Lc = n_mid * R1 + STAGE1_TAPS - R1
    rng = np.random.default_rng(3)
    cI, cQ = (torch.from_numpy(rng.integers(0, 256, (Lc,), np.uint8))
              .to(dev) for _ in range(2))
    rotC, rotS = cz._rot_tables(n_mid)
    ph1 = torch.ones((K, 1), dtype=torch.float32, device=dev)
    ph0 = torch.zeros((K, 1), dtype=torch.float32, device=dev)
    return n_mid, lambda: channelize._folded_frontend_step(
        cI, cQ, cz._bank, rotC, rotS, ph1, ph0, cz._m2I, cz._m2Q, n_mid)


def streaming_gbps(dev) -> tuple[float, float]:
    """(read GB/s of a 256 MB sum, read+write GB/s of a 256 MB axpy)."""
    big = torch.arange(64 << 20, dtype=torch.float32, device=dev)
    nb = _nbytes(big)
    rs = phase_ms(lambda: big.sum(), dev)
    ax = phase_ms(lambda: torch.add(big, big, alpha=1e-6), dev)
    return nb / rs / 1e6, 2 * nb / ax / 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=128)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    B = args.B
    banner = device_banner(args.device)
    dev = resolve_device(args.device)
    peak_f = peak_b = None
    if dev.type == "cuda":
        peak_f, _tf32, peak_b = card_peaks(torch.cuda.get_device_name(dev))
    options = DecoderOptions()
    wi, wq, _calls = make_batch(B)
    si = torch.from_numpy(wi).to(dev)
    sq = torch.from_numpy(wq).to(dev)
    md = torch.full((B,), options.maxdrift, dtype=torch.int32, device=dev)
    unit = "device" if dev.type == "cuda" else "host"
    peaks = ("none (not a card)" if peak_f is None else
             f"{peak_f / 1e12:g} FP32 TFLOP/s, {peak_b / 1e9:g} GB/s "
             f"(published)")
    print(f"device {banner} B={B}; ms are {unit} ms; FLOPs and bytes "
          f"counted over the phase's aten ops (bytes: the unfused ops' "
          f"inputs + outputs, an upper bound on HBM traffic) plus the "
          f"hand-written kernels' formulas; peaks: {peaks}")
    rd, rw = streaming_gbps(dev)
    print(f"measured streaming: {rd:.1f} GB/s read (256 MB sum), "
          f"{rw:.1f} GB/s read+write (256 MB axpy) ({banner})")

    nj = len(jitter_offsets(options.iifac, False))
    n_mid, chan = channelizer_fn(dev)
    fe_C, fe_frames = 128, 9_375
    phases = [
        ("stage A (STFT+cand+coarse)", stage_a_fn(si, sq, md, options)),
        (f"stage B (fine+{nj}-jitter demod)", stage_b_fn(si, sq, options)),
        ("front end stage-1 (u8 in)", frontend_fn(dev, fe_C, fe_frames)),
        (f"channelizer ({len(CHAN_OFFSETS)} dials, fused)", chan)]
    rows = []
    for name, fn in phases:
        w = work(fn)
        ms = phase_ms(fn, dev)
        rows.append({"phase": name, "ms": ms, "flop": w.flops,
                     "mm_flop": w.mm_flops, "kernel_flop": w.kernel_flops,
                     "bytes": w.total_bytes,
                     "flop_direct_form": (w.mm_flops + w.other_flops
                                          + w.direct_kernel_flops),
                     "bytes_direct_form": (w.bytes
                                           + w.direct_kernel_bytes)})
    print(f"{'phase':34s} {'ms':>10} {'GFLOP':>9} {'GB':>8} {'TFLOP/s':>8} "
          f"{'GB/s':>8} {'AI':>6} {'%peakF':>7} {'%peakB':>7}")
    for r in rows:
        s = r["ms"] / 1e3
        tf = r["flop"] / s / 1e12
        gb = r["bytes"] / s / 1e9
        r.update(tflops=tf, gbps=gb, ai=r["flop"] / max(r["bytes"], 1))
        if peak_f is not None:
            r.update(pct_peak_flops=100 * tf * 1e12 / peak_f,
                     pct_peak_bytes=100 * gb * 1e9 / peak_b)
        pf = f"{r['pct_peak_flops']:6.2f}%" if peak_f else "    n/a"
        pb = f"{r['pct_peak_bytes']:6.2f}%" if peak_f else "    n/a"
        print(f"{r['phase']:34s} {r['ms']:10.4f} {r['flop'] / 1e9:9.3f} "
              f"{r['bytes'] / 1e9:8.3f} {tf:8.3f} {gb:8.1f} {r['ai']:6.2f} "
              f"{pf} {pb}")
    for r in rows:
        if r["flop_direct_form"] == r["flop"]:
            continue
        s = r["ms"] / 1e3
        pf = (f", {100 * r['flop_direct_form'] / s / peak_f:.2f}% of the "
              f"FP32 peak" if peak_f else "")
        print(f"{r['phase']}: with the stage A and B kernels counted in "
              f"their direct form {r['flop_direct_form'] / 1e9:.3f} GFLOP, "
              f"{r['bytes_direct_form'] / 1e9:.3f} GB{pf}")
    syncs = B * 512 * 32 * 9 / (rows[0]["ms"] / 1e3)
    fe_msps = fe_C * fe_frames * R1 / (rows[2]["ms"] / 1e3) / 1e6
    caps = n_mid * R1 / (rows[3]["ms"] / 1e3) / 2.4e6
    K = len(CHAN_OFFSETS)
    print(f"candidate syncs/s: {syncs:,.0f} ({banner})")
    print(f"front-end sustained: {fe_msps:,.1f} Msps "
          f"({fe_msps / 2.4:,.1f} realtime channels) ({banner})")
    print(f"channelizer sustained: {caps:,.2f} realtime captures x {K} "
          f"dials = {K * caps:,.1f} decoded dials a card ({banner})")
    line = {"metric": "roofline", "B": B, "device": banner,
            "streaming_gbps": {"read": rd, "read_write": rw},
            "rows": rows, "candidate_syncs_per_s": syncs,
            "frontend_msps": fe_msps, "channelizer_dials": K * caps}
    if dev.type == "cuda":
        prof = stage_a_profile(phases[0][1], B)
        print(f"stage A under torch.profiler, one call at B={B}: device "
              f"{prof['device_ms']:.4f} ms = stft {prof['stft_ms']:.4f} + "
              f"coarse {prof['coarse_ms']:.4f} + smoothed_spectrum's "
              f"ps.sum(dim=-1) {prof['ps_sum_ms']:.4f} + the rest "
              f"{prof['rest_ms']:.4f} ({banner})")
        for name, ms in prof["kernels"][:12]:
            print(f"  {ms:9.4f} ms  {name[:100]}")
        line["stage_a_profile"] = prof
    print(json.dumps(line))


if __name__ == "__main__":
    main()
