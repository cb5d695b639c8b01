"""Spot reporting: console format and WSPRnet posting.

A copy of ``rtlsdr_wsprd_tpu/runtime/reporting.py`` on the port's
``Spot``: the console lines and the URLs are the JAX package's, byte
for byte. It preserves the reference's two external contracts exactly:
* console spot lines (printSpots, rtlsdr_wsprd.c:447-474; file-decode
  table, :691-701; self-test table, :770-780), used as test goldens;
* the wsprnet.org URL schema (postSpots, rtlsdr_wsprd.c:366-444):
  ``function=wspr`` per spot, ``function=wsprstat`` heartbeat when a
  window produced nothing.

Divergences (SURVEY.md section 5): failed posts go to a bounded retry
queue instead of being dropped on the floor like the C's curl errors
(rtlsdr_wsprd.c:404-405,437-438); and the daemons post from a
BACKGROUND thread (``background=True``) so a slow wsprnet can never
eat into the 2-minute window cadence — the C blocks its decoder
thread on curl for up to its timeout per spot (rtlsdr_wsprd.c:324,
366-444). Every discarded report (retry exhaustion or queue overflow)
is counted in ``dropped`` and announced on stderr — stdout is the
spot-line contract and must stay machine-parseable.
"""

from __future__ import annotations

import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import deque
from dataclasses import dataclass

from .. import __version__ as _pkg_version
from ..models.decoder import Spot

# reference reports its own app version to wsprnet (rtlsdr_wsprd.c:122)
WSPRNET_APP_VERSION = f"rtlsdr-tpu-{_pkg_version}"
WSPRNET_BASE = "https://wsprnet.org/post"


def format_spot_line(spot: Spot, gtm: time.struct_time) -> str:
    """printSpots per-spot line (rtlsdr_wsprd.c:461-473)."""
    return ("Spot :  %04d-%02d-%02d %02d:%02dz %6.2f %6.2f %10.6f %2d "
            "%7s %6s %2s" % (
                gtm.tm_year, gtm.tm_mon, gtm.tm_mday, gtm.tm_hour,
                gtm.tm_min, spot.snr, spot.dt, spot.freq,
                int(spot.drift), spot.call, spot.loc, spot.pwr))


def format_no_spot_line(gtm: time.struct_time) -> str:
    """printSpots empty-window line (rtlsdr_wsprd.c:448-455)."""
    return "No spot %04d-%02d-%02d %02d:%02dz" % (
        gtm.tm_year, gtm.tm_mon, gtm.tm_mday, gtm.tm_hour, gtm.tm_min)


def format_table_header() -> str:
    """File-decode/self-test table header (rtlsdr_wsprd.c:691)."""
    return "        SNR      DT        Freq Dr    Call    Loc Pwr"


def format_table_line(spot: Spot) -> str:
    """File-decode table row (rtlsdr_wsprd.c:692-701)."""
    return "Spot : %6.2f %6.2f %10.6f %2d %7s %6s %2s" % (
        spot.snr, spot.dt, spot.freq, int(spot.drift),
        spot.call, spot.loc, spot.pwr)


def print_spots(spots: list[Spot], gtm: time.struct_time) -> None:
    if not spots:
        print(format_no_spot_line(gtm))
        return
    for s in spots:
        if not s.noprint:
            print(format_spot_line(s, gtm))


def spot_url(spot: Spot, rcall: str, rloc: str, gtm: time.struct_time) -> str:
    """function=wspr URL for one spot (rtlsdr_wsprd.c:414-431)."""
    q = {
        "function": "wspr",
        "rcall": rcall,
        "rgrid": rloc,
        "rqrg": "%.6f" % spot.freq,
        "date": "%02d%02d%02d" % (gtm.tm_year - 2000, gtm.tm_mon,
                                  gtm.tm_mday),
        "time": "%02d%02d" % (gtm.tm_hour, gtm.tm_min),
        "sig": "%.0f" % spot.snr,
        "dt": "%.1f" % spot.dt,
        "tqrg": "%.6f" % spot.freq,
        "tcall": spot.call,
        "tgrid": spot.loc,
        "dbm": spot.pwr,
        "version": WSPRNET_APP_VERSION,
        "mode": "2",
    }
    return WSPRNET_BASE + "?" + urllib.parse.urlencode(q)


def heartbeat_url(rcall: str, rloc: str, dialfreq_hz: float) -> str:
    """function=wsprstat URL for an empty window (rtlsdr_wsprd.c:390-397)."""
    q = {
        "function": "wsprstat",
        "rcall": rcall,
        "rgrid": rloc,
        "rqrg": "%.6f" % (dialfreq_hz / 1e6),
        "tpct": "%.2f" % 0.0,
        "tqrg": "%.6f" % (dialfreq_hz / 1e6),
        "dbm": "0",
        "version": WSPRNET_APP_VERSION,
        "mode": "2",
    }
    return WSPRNET_BASE + "?" + urllib.parse.urlencode(q)


@dataclass
class _Pending:
    url: str
    attempts: int = 0


class WsprnetReporter:
    """HTTP GET poster with a bounded retry queue.

    ``noreport`` mirrors -x (rtlsdr_wsprd.c:373-376). ``transport`` is
    injectable for tests (callable url -> None, raising on failure).

    ``background=True`` moves delivery to a daemon worker thread:
    ``post()`` only enqueues (microseconds) and the worker drains the
    queue, retrying failures with exponential backoff (RETRY_INTERVAL_S
    doubling up to RETRY_MAX_INTERVAL_S) — so a slow or down wsprnet
    never stalls the decode loop that produced the spots (the
    reference's decoder thread blocks on curl per spot,
    rtlsdr_wsprd.c:324), while queued spots survive a multi-minute
    outage (~12 min at the default schedule — at least as long as the
    old inline flush-per-window scheme's 3 tries at 2-minute cadence).
    ``close()`` joins the worker after a final delivery attempt; the
    daemons call it on shutdown.

    ``dropped`` counts reports discarded forever — retry exhaustion or
    queue overflow (the deque evicts its oldest when full). The daemons
    surface it in their stats lines.
    """

    MAX_QUEUE = 256
    MAX_ATTEMPTS = 10
    RETRY_INTERVAL_S = 5.0
    RETRY_MAX_INTERVAL_S = 120.0

    def __init__(self, rcall: str, rloc: str, dialfreq_hz: float,
                 noreport: bool = False, transport=None,
                 timeout: float = 10.0, background: bool = False):
        self.rcall = rcall
        self.rloc = rloc
        self.dialfreq_hz = dialfreq_hz
        self.noreport = noreport
        self.timeout = timeout
        self._transport = transport or self._http_get
        self._queue: deque[_Pending] = deque(maxlen=self.MAX_QUEUE)
        self.dropped = 0
        self._backoff = self.RETRY_INTERVAL_S
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if background and not noreport:
            self._thread = threading.Thread(
                target=self._worker, daemon=True, name="wsprnet-reporter")
            self._thread.start()

    def _http_get(self, url: str) -> None:
        req = urllib.request.Request(url, method="HEAD")
        with urllib.request.urlopen(req, timeout=self.timeout):
            pass

    def post(self, spots: list[Spot], gtm: time.struct_time) -> None:
        """Queue this window's report(s) (postSpots,
        rtlsdr_wsprd.c:366-444); delivery is inline unless the
        reporter runs a background worker."""
        if self.noreport:
            return
        urls = ([heartbeat_url(self.rcall, self.rloc, self.dialfreq_hz)]
                if not spots else
                [spot_url(s, self.rcall, self.rloc, gtm) for s in spots])
        with self._lock:
            for url in urls:
                if len(self._queue) == self.MAX_QUEUE:
                    # the bounded deque evicts its oldest pending report
                    self.dropped += 1
                    print("report dropped: retry queue full "
                          f"({self.MAX_QUEUE})", file=sys.stderr)
                self._queue.append(_Pending(url))
        if self._thread is not None:
            self._wake.set()
        else:
            self.flush()

    def _drain_once(self) -> int:
        """Attempt every currently-queued URL once; keep failures for
        later (bounded). Returns number delivered."""
        delivered = 0
        failed = 0
        with self._lock:
            n = len(self._queue)
        for _ in range(n):
            with self._lock:
                if not self._queue:
                    break
                item = self._queue.popleft()
            try:
                self._transport(item.url)
                delivered += 1
            except (urllib.error.URLError, OSError, TimeoutError) as exc:
                item.attempts += 1
                failed += 1
                if item.attempts < self.MAX_ATTEMPTS:
                    with self._lock:
                        self._queue.append(item)
                else:
                    with self._lock:
                        self.dropped += 1
                    print(f"report dropped after {item.attempts} attempts: "
                          f"{exc}", file=sys.stderr)
        # exponential backoff while wsprnet is down; reset on recovery
        self._backoff = (min(self._backoff * 2, self.RETRY_MAX_INTERVAL_S)
                         if failed else self.RETRY_INTERVAL_S)
        return delivered

    def _worker(self) -> None:
        while not self._stop.is_set():
            timeout = self._backoff if self.pending else None
            self._wake.wait(timeout=timeout)
            self._wake.clear()
            if self._stop.is_set():
                break
            if self.pending:
                self._drain_once()

    def flush(self) -> int:
        """One delivery attempt over the queue. With a background
        worker this runs inline too (idempotent with the worker's own
        drains; items are popped under the lock)."""
        return self._drain_once()

    def close(self, final_attempt: bool = True) -> None:
        """Stop the background worker (join-on-shutdown), then make one
        last inline delivery attempt for anything still queued. If the
        worker overruns the join timeout (a transport call wedged past
        its own timeout), the inline attempt is SKIPPED so only one
        drainer is ever active."""
        if self._thread is not None:
            self._stop.set()
            self._wake.set()
            self._thread.join(timeout=self.timeout + 5.0)
            if self._thread.is_alive():
                # abandoned worker may still be mid-drain; don't race it
                print("reporter worker did not stop in time; skipping "
                      "final delivery attempt", file=sys.stderr)
                self._thread = None
                return
            self._thread = None
        if final_attempt and self.pending:
            self._drain_once()

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)
