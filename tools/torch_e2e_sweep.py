"""The device-resident ingest -> spots chain of the PyTorch/CUDA port,
and the sweep of its front-end step quantum.

The counterpart of bench.py's ``measure_e2e_device`` (:59-183) and of
tools/e2e_sweep.py. Raw uint8 for DC channels is made once on the card
and replayed every step: ``_fused_frontend_step`` (uint8 stage 1 on
polyphase_tc.cu, stage 2 on polyphase.cu) runs ``45000 / (N_MID/80)``
times a 120 s window, in a Python loop, the mid-rate carry staying on
the card; the window is assembled on the card (the front end's noise
scaled to 1/8 of its row peak and added to the caller's content
windows, uploaded once, then each row scaled to a 0.5 peak), wrapped by
``prepare_windows_device`` (one handle a card, the rows split across
cards as bench.py splits them) and decoded by
``decode_channels_pipelined_multidevice`` with the full schedule. The
baseband never reaches the host. Front-end cost does not depend on the
samples, decode cost does: hence the replayed noise over real content.

The sweep runs the chain at N_MID = 60k, 120k, 240k and 360k stage-1
frames a step (60, 30, 15 and 10 steps a window) and fits the seconds
a window as ``t(S) = t_card + S * c_step``: ``c_step`` is what one more
step of the Python loop costs, ``t_card`` the rest.

Usage: python tools/torch_e2e_sweep.py [DC] [DWIN] [--device DEV]
DC channels (default 128), DWIN timed windows a point (default 4);
``--device`` defaults to the CUDA card (and then every visible card
decodes a shard), ``cpu`` runs the plain PyTorch versions. Prints a row
a point beside the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rtlsdr_wsprd_tpu_torch.config import (  # noqa: E402
    SIGNAL_SAMPLES,
    DecoderOptions,
)
from rtlsdr_wsprd_tpu_torch.device import (  # noqa: E402
    resolve_device,
    resolve_devices,
)
from rtlsdr_wsprd_tpu_torch.frontend.decimate import (  # noqa: E402
    _fused_frontend_step,
)
from rtlsdr_wsprd_tpu_torch.frontend.filters import (  # noqa: E402
    R1,
    R2,
    STAGE1_TAPS,
    STAGE2_TAPS,
)
from rtlsdr_wsprd_tpu_torch.parallel.multichannel import (  # noqa: E402
    decode_channels_pipelined_multidevice,
    prepare_windows_device,
)
from torch_measure import device_banner, make_batch  # noqa: E402

REF_WINDOWS_PER_S = 2.0  # the reference on an i7-5820K (bench.py)
# N_MID must be a multiple of 80 whose baseband step divides 45000
N_MIDS = (60_000, 120_000, 240_000, 360_000)
# a quantum whose raw block would take more than this share of the
# card's free memory is skipped (the decode needs the rest)
RAW_SHARE = 0.5


def steps_per_window(n_mid: int) -> int:
    """Fused front-end steps a 120 s window takes at ``n_mid`` stage-1
    frames a step."""
    if n_mid % R2 or SIGNAL_SAMPLES % (n_mid // R2):
        raise ValueError(f"N_MID={n_mid}: need a multiple of {R2} whose "
                         f"baseband step divides {SIGNAL_SAMPLES}")
    return SIGNAL_SAMPLES // (n_mid // R2)


def raw_bytes(DC: int, n_mid: int) -> int:
    """Bytes of the raw uint8 block: two planes of DC rows."""
    return 2 * DC * (n_mid * R1 + STAGE1_TAPS - R1)


def raw_block(DC: int, n_mid: int, seed: int, device):
    """The raw uint8 planes (DC, n_mid*R1 + STAGE1_TAPS - R1), uniform
    bytes made on ``device`` from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    shape = (DC, n_mid * R1 + STAGE1_TAPS - R1)
    return tuple(torch.randint(0, 256, shape, generator=g,
                               dtype=torch.uint8, device=device)
                 for _ in range(2))


def frontend_steps(ri, rq, m2i, m2q, n_mid: int, steps: int):
    """``steps`` fused front-end steps over the same raw block:
    (baseband I, Q (DC, steps * n_mid/80), new carry I, Q)."""
    ois, oqs = [], []
    for _ in range(steps):
        oi, oq, m2i, m2q = _fused_frontend_step(ri, rq, m2i, m2q, n_mid)
        ois.append(oi)
        oqs.append(oq)
    return torch.cat(ois, dim=1), torch.cat(oqs, dim=1), m2i, m2q


def assemble_win(bb_i, bb_q, ci, cq):
    """One window on the device: the front end's output scaled to 1/8 of
    its row peak, added to the content rows (ci, cq), then each row
    scaled to a 0.5 peak (the -3 dB normalization,
    rtlsdr_wsprd.c:291-305)."""
    m = torch.maximum(bb_i.abs().amax(dim=1), bb_q.abs().amax(dim=1))
    s = (0.125 / torch.clamp(m, min=1e-24))[:, None]
    zi = ci + bb_i * s
    zq = cq + bb_q * s
    mx = torch.maximum(zi.abs().amax(dim=1), zq.abs().amax(dim=1))
    sc = (0.5 / torch.clamp(mx, min=1e-24))[:, None]
    return zi * sc, zq * sc


def device_windows(cont_i: torch.Tensor, cont_q: torch.Tensor,
                   n_windows: int, seed: int, n_mid: int, devices):
    """Yield ``n_windows`` rounds of the chain: the front end and the
    assembly on the content's device, then a ``prepare_windows_device``
    handle, or with several ``devices`` a list of one handle a device
    over contiguous row shards (bench.py:160-170)."""
    dev = cont_i.device
    DC = cont_i.shape[0]
    steps = steps_per_window(n_mid)
    ri, rq = raw_block(DC, n_mid, seed, dev)
    m2i = torch.zeros((DC, STAGE2_TAPS - R2), dtype=torch.float32,
                      device=dev)
    m2q = torch.zeros_like(m2i)
    D = len(devices)
    for _ in range(n_windows):
        bb_i, bb_q, m2i, m2q = frontend_steps(ri, rq, m2i, m2q, n_mid, steps)
        dwi, dwq = assemble_win(bb_i, bb_q, cont_i, cont_q)
        if D == 1:
            yield prepare_windows_device(dwi, dwq, device_batch=DC,
                                         device=devices[0])
            continue
        bounds = [DC * k // D for k in range(D + 1)]
        yield [prepare_windows_device(
            dwi[s0:s1].to(d), dwq[s0:s1].to(d), device_batch=s1 - s0,
            device=d)
            for d, s0, s1 in zip(devices, bounds[:-1], bounds[1:])
            if s1 > s0]


def _synchronize(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def chain_devices(device=None):
    """(the front end's device, the decode's devices): ``device=None``
    is the current card for the front end and every visible card for
    the decode; a named device is both."""
    dev = resolve_device(device)
    return dev, resolve_devices(None) if device is None else [dev]


def run_chain(cont_i, cont_q, options: DecoderOptions, n_windows: int,
              seed: int, n_mid: int, devices) -> float:
    """Seconds from the first step to the last window's spots."""
    t0 = time.perf_counter()
    for _ in decode_channels_pipelined_multidevice(
            device_windows(cont_i, cont_q, n_windows, seed, n_mid, devices),
            options, device_batch=cont_i.shape[0], devices=devices):
        pass
    _synchronize(devices)
    return time.perf_counter() - t0


def measure_e2e_device(wi, wq, options: DecoderOptions, DC: int = 128,
                       DWIN: int = 4, N_MID: int = 120_000, device=None):
    """The chain on the first DC content windows of (wi, wq): one warm
    window (seed 0), then DWIN timed windows (seed 1). Returns
    (realtime channels per card: the channels decoded in real time over
    all cards, divided by their number; seconds; steps per window;
    cards)."""
    steps = steps_per_window(N_MID)
    dev, devices = chain_devices(device)
    cont_i = torch.from_numpy(np.ascontiguousarray(wi[:DC])).to(dev)
    cont_q = torch.from_numpy(np.ascontiguousarray(wq[:DC])).to(dev)
    run_chain(cont_i, cont_q, options, 1, 0, N_MID, devices)
    secs = run_chain(cont_i, cont_q, options, DWIN, 1, N_MID, devices)
    return (DC * DWIN * 120.0 / secs / len(devices), secs, steps,
            len(devices))


def fit(points: list[dict], DC: int) -> dict:
    """The affine fit t(S) = t_card + S * c_step over the measured
    points, with each point's residual."""
    if len(points) < 2:
        return {}
    S = np.array([p["steps_per_window"] for p in points], float)
    T = np.array([p["s_per_window"] for p in points], float)
    c_step, t_card = np.polyfit(S, T, 1)
    resid = T - (t_card + c_step * S)
    return {"per_step_ms": 1e3 * c_step,
            "card_s_per_window": t_card,
            "card_realtime_channels": DC * 120.0 / max(t_card, 1e-9),
            "resid_ms": [1e3 * float(r) for r in resid],
            "vs_baseline": DC * 120.0 / max(t_card, 1e-9) / 120.0
            / REF_WINDOWS_PER_S}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("DC", nargs="?", type=int, default=128)
    ap.add_argument("DWIN", nargs="?", type=int, default=4)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    banner = device_banner(args.device)
    dev, devices = chain_devices(args.device)
    print(f"device {banner}; decode on {[str(d) for d in devices]}")
    wi, wq, _calls = make_batch(args.DC)
    options = DecoderOptions()
    points = []
    for n_mid in N_MIDS:
        need = raw_bytes(args.DC, n_mid)
        if dev.type == "cuda":
            free = torch.cuda.mem_get_info(dev)[0]
            if need > RAW_SHARE * free:
                print(f"skipping N_MID={n_mid}: its raw block needs "
                      f"{need / 1e9:.2f} GB, more than {RAW_SHARE} of the "
                      f"{free / 1e9:.1f} GB free")
                continue
        channels, secs, steps, n_dev = measure_e2e_device(
            wi, wq, options, DC=args.DC, DWIN=args.DWIN, N_MID=n_mid,
            device=args.device)
        points.append({"n_mid": n_mid, "steps_per_window": steps,
                       "raw_gb": need / 1e9, "seconds": secs,
                       "s_per_window": secs / args.DWIN,
                       "realtime_channels_per_card": channels,
                       "cards": n_dev})
        print(f"N_MID={n_mid} ({steps} steps a window, raw block "
              f"{need / 1e9:.2f} GB): {args.DWIN} windows of {args.DC} "
              f"channels in {secs:.4f} s, {secs / args.DWIN:.4f} s a "
              f"window, {channels:.1f} realtime channels a card "
              f"on {n_dev} card(s) ({banner})", flush=True)
    print(json.dumps({"metric": "e2e_device_step_overhead", "DC": args.DC,
                      "DWIN": args.DWIN, "device": banner,
                      "points": points, "fit": fit(points, args.DC)}))


if __name__ == "__main__":
    main()
