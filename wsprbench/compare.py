"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, as numbers each held to its own limit. A cell
compares the numbers its ``limits/<cell>.json`` names; the rest are
printed beside them.

* ``spots_differ``: over every yield of a sampled window in the measured
  window, the spots whose message the program and the reference do not
  both report (a multiset difference, both ways). Exact: limit 0.
* ``snr_gap_median_db``: the median, over every matched spot (a
  message the program and the reference both report in one window), of
  the gap between their SNRs (the spectrogram, the candidate pick and
  the noise floor behind it).
* ``sync_gap_median``: the same for the fine-sync metric (stage B's
  correlations).
* ``freq_gap_hz``, ``dt_gap_s``, ``drift_gap``: over every matched
  spot, the widest gap in the fields a spot reports besides its message
  (frequency in Hz, time offset, drift). Both sides work them out from
  the same grid indices: exact, limit 0.
* ``baseband_err`` (device-fed cells): the widest gap between a sampled
  channel's window as the program's front end made it and as the
  reference makes it, over the window's 0.5 peak.

Medians, not the widest gaps: where two candidates of one signal tie
within rounding, the program and the reference may report the message
from different ones, whose SNR and sync differ by more than a change of
precision moves the rest; where a cell samples few spots even the
median can fall on such a pair, and the cell leaves the medians out.
The widest gaps (``snr_gap_db``, ``sync_gap``) and ``cycles_differ``
are only printed.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

def as_dict(spot) -> dict:
    if isinstance(spot, dict):
        return spot
    return {"message": spot.message, "freq": spot.freq, "snr": spot.snr,
            "dt": spot.dt, "drift": spot.drift, "sync": spot.sync,
            "jitter": spot.jitter, "cycles": spot.cycles}


def spot_numbers(yields, ref: dict) -> dict:
    """``yields``: (window key, spot list) of every program answer to
    judge; ``ref``: window key -> the reference's spots."""
    out = {"spots_differ": 0, "snr_gap_db": 0.0, "sync_gap": 0.0,
           "freq_gap_hz": 0.0,
           "dt_gap_s": 0.0, "drift_gap": 0.0, "cycles_differ": 0,
           "spots_judged": 0}
    snr_gaps, sync_gaps = [], []
    for key, spots in yields:
        got = [as_dict(s) for s in spots]
        want = ref[key]
        cg = Counter(s["message"] for s in got)
        cw = Counter(s["message"] for s in want)
        out["spots_differ"] += sum(((cg - cw) + (cw - cg)).values())
        out["spots_judged"] += len(want)
        wm = {s["message"]: s for s in want}
        for s in got:
            r = wm.get(s["message"])
            if r is None:
                continue
            snr_gaps.append(abs(s["snr"] - r["snr"]))
            sync_gaps.append(abs(s["sync"] - r["sync"]))
            out["freq_gap_hz"] = max(out["freq_gap_hz"],
                                     1e6 * abs(s["freq"] - r["freq"]))
            out["dt_gap_s"] = max(out["dt_gap_s"], abs(s["dt"] - r["dt"]))
            out["drift_gap"] = max(out["drift_gap"],
                                   abs(s["drift"] - r["drift"]))
            out["cycles_differ"] += int(s["cycles"] != r["cycles"])
    for name, gaps in (("snr_gap", snr_gaps), ("sync_gap", sync_gaps)):
        widest = name + "_db" if name == "snr_gap" else name
        out[widest] = float(max(gaps, default=0.0))
        out[name + ("_median_db" if name == "snr_gap" else "_median")] = (
            float(np.median(gaps)) if gaps else 0.0)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name (``limits/<cell>.json``); a number above its limit, or
    one the run did not read, is not correct. A cell without limits is
    not correct."""
    checks = {name: {"value": numbers.get(name), "limit": lim}
              for name, lim in limits.items()}
    ok = bool(checks) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
