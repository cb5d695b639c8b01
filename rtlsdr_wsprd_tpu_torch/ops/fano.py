"""Batched Fano sequential decoder for the WSPR K=32 r=1/2 code: a
hand-written CUDA kernel and its plain PyTorch version.

``batched_fano`` is the wrapper. For a CPU tensor it runs the plain
version; for a CUDA tensor it launches ``csrc/fano.cu`` or raises: there
is no fallback. Both replace ``rtlsdr_wsprd_tpu/ops/fano.py``
``batched_fano``, an XLA while-loop program (no Pallas kernel), and
both are bit-exact with the reference's wsprd/fano.c, as the native host
decoder (``native.fano_decode``) is: success, path metric, cycle count
and deepest node on every lane, decoded bytes on every lane that
succeeded.

- ``csrc/fano.cu`` runs one lane per thread, as the flattened state
  machine below: one converged flat step of every live lane a loop
  iteration, the current node in registers, the node stack and the
  lane's precomputed branch metrics (int16) in shared memory laid out
  [node][lane]. Its table must keep a sum of two entries within int16:
  tables with entries outside [-2^14, 2^14) raise on the card.
- ``batched_fano_plain`` is the JAX package's lane-parallel state
  machine in torch: (B, 82) node tensors, one flat step (a forward look
  or one backtrack move per lane, chosen by ``back``) per iteration of a
  Python loop that runs until every lane is done.

One deliberate difference from the JAX program: ``data`` of a lane that
did not succeed is all zeros here (kernel and plain version alike), as
the native decoder writes it; the JAX program leaves stale encoder-state
bytes there. No caller reads ``data`` where ``success`` is False.

``build_mettab`` and ``_c_roundf`` are copied from the JAX package's
``ops/fano.py``. ``METTAB`` is the port's one live metric table: the
decode, the straggler finish and ``convert.state_dict`` (as
``ops.fano.mettab``) all read this array.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..buildlib import load_library, nvcc_path
from ..config import NBITS
from ..device import derived_const, resolve_device
from ..utils.channel import POLY1, POLY2
from ..utils.metric_tables import METRIC_TABLES

N_NODES = NBITS + 1  # 82: nodes[0..80] + the final position
TAIL = NBITS - 31    # 50: first node of the all-zero tail (fano.c:112)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "fano.cu"
# the values of the source's kLanes (lanes a block) that
# tools/fano_blocks.py times and tests/test_torch_fano.py checks; the
# source keeps the first
LANES_A_BLOCK = (32, 64, 96)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_vp, _ci, _cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# fano_decode_lanes(symbols, valid, mettab, n, delta, maxcycles, data,
#                   success, metric, cycles, maxnp, steps, stream)
_ARGTYPES = [_vp, _vp, _vp, _ci, _ci, _cu, _vp, _vp, _vp, _vp, _vp, _vp, _vp]

_lib = None
_lock = threading.Lock()


def _c_roundf(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero."""
    return np.trunc(x + np.copysign(0.5, x))


def build_mettab(bias: float = 0.45) -> np.ndarray:
    """Integer branch metric table (2, 256) int32 (wsprd/wsprd.c:467-473):
    mettab[0][i] = roundf(10*(metric_tables[2][i] - bias)), mettab[1]
    uses the reversed index."""
    t2 = np.asarray(METRIC_TABLES[2], dtype=np.float32)
    sub0 = (t2 - np.float32(bias)).astype(np.float32)
    sub1 = (t2[::-1] - np.float32(bias)).astype(np.float32)
    # C: roundf(10.0 * (float)(v - bias)) — the double product converts
    # to float32 at the roundf call boundary (e.g. -4.4999999 -> -4.5f
    # -> -5), so narrow before rounding.
    m0 = _c_roundf((10.0 * sub0.astype(np.float64)).astype(np.float32))
    m1 = _c_roundf((10.0 * sub1.astype(np.float64)).astype(np.float32))
    return np.stack([m0, m1]).astype(np.int32)


METTAB = build_mettab()


class FanoResult(NamedTuple):
    data: torch.Tensor     # uint8[B, 11] decoded bytes (last byte 0; all
    #                        zeros where success is False)
    success: torch.Tensor  # bool[B] (C: fano() == 0)
    metric: torch.Tensor   # int32[B] final path metric
    cycles: torch.Tensor   # int32[B] cycle count (C *cycles semantics:
    #                        break iteration + 1, or maxcycles*81 + 2 on
    #                        timeout); int32 holds every such count
    maxnp: torch.Tensor    # int32[B] deepest node reached
    # int32[B] flat steps each lane took (forward looks + backtrack
    # moves), only when asked for (``steps=True``); None otherwise
    steps: torch.Tensor | None = None


def build_kernel() -> str:
    """Build (if needed) and load ``csrc/fano.cu``; returns its path."""
    return _load_kernel()._name


def _load_kernel():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = load_library("fano", nvcc_path(), [_SOURCE],
                                   NVCC_FLAGS)
                lib.fano_decode_lanes.argtypes = _ARGTYPES
                lib.fano_decode_lanes.restype = _ci
                _lib = lib
    return _lib


def _parity32(x: torch.Tensor) -> torch.Tensor:
    """Parity of the low 32 bits of an int64 tensor (0 or 1)."""
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


def _encode_sym(encstate: torch.Tensor) -> torch.Tensor:
    """The ENCODE macro (wsprd/fano.h:35-44): 2-bit symbol from the
    parities of encstate & POLY1 / POLY2."""
    return (_parity32(encstate & POLY1) << 1) | _parity32(encstate & POLY2)


def _take_at(arr: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """arr[b, pos[b]] for (B, N_NODES) tensors."""
    return torch.gather(arr, 1, pos[:, None])[:, 0]


def _set_at(arr: torch.Tensor, pos: torch.Tensor, val: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """arr[b, pos[b]] = val[b] where mask[b], for (B, N_NODES) tensors."""
    nodes = torch.arange(arr.shape[1], device=arr.device)[None, :]
    hit = (nodes == pos[:, None]) & mask[:, None]
    return torch.where(hit, val[:, None].to(arr.dtype), arr)


def batched_fano_plain(symbols: torch.Tensor, mettab: torch.Tensor,
                       delta: int = 60, maxcycles: int = 10000,
                       valid: torch.Tensor | None = None,
                       steps: bool = False) -> FanoResult:
    """Plain PyTorch version: the JAX package's flattened lane-parallel
    state machine (rtlsdr_wsprd_tpu/ops/fano.py:137-261). Each flat step
    is a forward look for lanes with ``back`` False and one backtrack
    move for lanes with ``back`` True; ``cyc`` counts forward looks
    only, one per C loop iteration. Runs until every lane is done; a
    step changes nothing on a done lane, so doneness is polled every 8
    steps. Encoder states are kept as int64 holding 32-bit values."""
    dev = symbols.device
    B = symbols.shape[0]
    i64 = torch.int64
    max_total = maxcycles * NBITS
    mask32 = 0xFFFFFFFF

    sym = symbols.to(i64)
    s0, s1 = sym[:, 0::2], sym[:, 1::2]  # (B, 81)
    mt = mettab.to(i64)
    m_t0, m_t1 = mt[0], mt[1]
    # branch metrics per node, indexed by the 2-bit tx symbol
    # (wsprd/fano.c:118-124)
    metrics = torch.stack(
        [m_t0[s0] + m_t0[s1], m_t0[s0] + m_t1[s1],
         m_t1[s0] + m_t0[s1], m_t1[s0] + m_t1[s1]], dim=-1)  # (B, 81, 4)

    # ---- root node init (wsprd/fano.c:126-150) ----
    m0 = metrics[:, 0, 0]            # lsym = ENCODE(0) = 0
    m1 = metrics[:, 0, 3]            # complementary branch (3 ^ 0)
    swap0 = m0 <= m1                 # C: if (m0 > m1) keep else swap
    zeros = torch.zeros((B, N_NODES), dtype=i64, device=dev)
    gamma = zeros.clone()
    encstate = zeros.clone()
    encstate[:, 0] = swap0.to(i64)
    tm0 = zeros.clone()
    tm0[:, 0] = torch.where(swap0, m1, m0)
    tm1 = zeros.clone()
    tm1[:, 0] = torch.where(swap0, m0, m1)
    ii = zeros.clone()

    zb = torch.zeros(B, dtype=i64, device=dev)
    pos, t, cyc, maxnp = zb.clone(), zb.clone(), zb.clone(), zb.clone()
    metric, cycles_out, nsteps = zb.clone(), zb.clone(), zb.clone()
    fb = torch.zeros(B, dtype=torch.bool, device=dev)
    done = fb.clone() if valid is None else ~valid.to(torch.bool)
    back, success = fb.clone(), fb.clone()

    k = 0
    while True:
        if k % 8 == 0 and bool(done.all()):
            break
        k += 1
        nsteps = nsteps + (~done).to(i64)
        fwd_mode = ~done & ~back
        i_now = cyc + 1  # the C cycle index if this forward look runs

        maxnp = torch.where(fwd_mode & (pos > maxnp), pos, maxnp)

        g_p = _take_at(gamma, pos)
        i_p = _take_at(ii, pos)
        tm_p = torch.where(i_p == 0, _take_at(tm0, pos), _take_at(tm1, pos))
        ngamma = g_p + tm_p
        fwd = fwd_mode & (ngamma >= t)

        # ---- forward move (wsprd/fano.c:158-197) ----
        first_visit = g_p < t + delta
        t_tight = t + delta * torch.div(ngamma - t, delta,
                                        rounding_mode="floor")
        t = torch.where(fwd & first_visit, t_tight, t)

        newpos = torch.where(fwd, pos + 1, pos)
        es_p = _take_at(encstate, pos)
        es_new = (es_p << 1) & mask32
        gamma = _set_at(gamma, newpos, ngamma, fwd)
        encstate = _set_at(encstate, newpos, es_new, fwd)

        finished = fwd & (newpos == NBITS)
        advancing = fwd & ~finished

        # new node's sorted branch metrics (wsprd/fano.c:178-196)
        np_c = newpos.clamp(0, NBITS - 1)
        lsym = _encode_sym(es_new)
        met_node = torch.gather(
            metrics, 1, np_c[:, None, None].expand(B, 1, 4))[:, 0]  # (B, 4)
        mm0 = torch.gather(met_node, 1, lsym[:, None])[:, 0]
        mm1 = torch.gather(met_node, 1, (3 ^ lsym)[:, None])[:, 0]
        in_tail = np_c >= TAIL
        swap = (~in_tail) & (mm0 <= mm1)
        new_tm0 = torch.where(in_tail, mm0, torch.where(swap, mm1, mm0))
        new_tm1 = torch.where(swap, mm0, mm1)  # tail: tm1 stale (never read)
        write_tm1 = advancing & ~in_tail
        tm0 = _set_at(tm0, newpos, new_tm0, advancing)
        tm1 = _set_at(tm1, newpos, new_tm1, write_tm1)
        encstate = _set_at(encstate, newpos, es_new + swap.to(i64),
                           advancing & swap)
        ii = _set_at(ii, newpos, torch.zeros_like(newpos), advancing)
        pos = torch.where(fwd, newpos, pos)

        # forward look failed: enter the backtrack walk (same C cycle)
        back = back | (fwd_mode & ~fwd & (ngamma < t))

        # ---- one backtrack step (wsprd/fano.c:199-219) ----
        walk = ~done & back & ~fwd_mode  # lanes already walking this step
        g_prev = _take_at(gamma, (pos - 1).clamp(min=0))
        relax = walk & ((pos == 0) | (g_prev < t))
        t = torch.where(relax, t - delta, t)
        i_cur = _take_at(ii, pos)
        flip = relax & (i_cur != 0)
        ii = _set_at(ii, pos, torch.zeros_like(pos), flip)
        encstate = _set_at(encstate, pos, _take_at(encstate, pos) ^ 1, flip)
        back = back & ~relax  # relax exits the walk

        stepping = walk & ~relax
        pos = torch.where(stepping, pos - 1, pos)
        i_b = _take_at(ii, pos)
        can_try = stepping & (pos < TAIL) & (i_b != 1)
        ii = _set_at(ii, pos, i_b + 1, can_try)
        encstate = _set_at(encstate, pos, _take_at(encstate, pos) ^ 1,
                           can_try)
        back = back & ~can_try  # alternate branch found: walk ends

        # ---- bookkeeping: completion & timeout ----
        cyc = torch.where(fwd_mode, i_now, cyc)
        # the C records the timeout state AFTER the final iteration's
        # backtrack walk completes (wsprd/fano.c:149,222-231), so a lane
        # times out only once it is back out of the walk
        timeout = ~done & ~back & ~finished & (cyc >= max_total)
        metric = torch.where(finished, ngamma,
                             torch.where(timeout, _take_at(gamma, pos),
                                         metric))
        # C: *cycles = i + 1 with i = break iteration on success, or
        # maxcycles*81 + 2 on natural exit (wsprd/fano.c:231)
        cycles_out = torch.where(
            finished, i_now + 1,
            torch.where(timeout, torch.full_like(cyc, max_total + 2),
                        cycles_out))
        # success requires i < maxcycles*81 at exit (wsprd/fano.c:234-235)
        success = success | (finished & (i_now < max_total))
        done = done | finished | timeout

    # decoded bytes from nodes 7, 15, ..., 79 (wsprd/fano.c:224-230),
    # zero where the lane did not succeed (as native/hostdsp.cpp)
    byte_nodes = 7 + 8 * torch.arange(NBITS >> 3, device=dev)  # (10,)
    data10 = (encstate[:, byte_nodes] & 0xFF) * success[:, None].to(i64)
    data = torch.cat([data10, torch.zeros((B, 1), dtype=i64, device=dev)],
                     dim=1).to(torch.uint8)
    i32 = torch.int32
    return FanoResult(data=data, success=success, metric=metric.to(i32),
                      cycles=cycles_out.to(i32), maxnp=maxnp.to(i32),
                      steps=nsteps.to(i32) if steps else None)


_TABLE_LIMIT = 2 ** 14  # |entry| bound that keeps a branch metric int16


def _check_table_range(mettab):
    """``mettab`` (numpy or torch), or ValueError unless every entry
    lies in [-2^14, 2^14): the kernel keeps branch metrics (sums of two
    entries) as int16."""
    lo, hi = int(mettab.min()), int(mettab.max())
    if lo < -_TABLE_LIMIT or hi >= _TABLE_LIMIT:
        raise ValueError(f"metric table entries must lie in [-{_TABLE_LIMIT}, "
                         f"{_TABLE_LIMIT}) for the kernel's int16 branch "
                         f"metrics, got [{lo}, {hi}]")
    return mettab


def device_mettab(device) -> torch.Tensor:
    """``METTAB`` on ``device``, checked on the host and uploaded once
    (until ``device.clear_consts``). ``batched_fano`` takes this tensor
    without reading it back; any other table costs a read-back a call.
    ``cuda`` names the current card, as a tensor's device names it."""
    dev = resolve_device(device)
    return derived_const(_check_table_range, (METTAB,), dev)


def batched_fano(symbols: torch.Tensor, mettab: torch.Tensor,
                 delta: int = 60, maxcycles: int = 10000,
                 valid: torch.Tensor | None = None,
                 steps: bool = False) -> FanoResult:
    """Decode B deinterleaved soft-symbol streams at once.

    symbols: uint8[B, 162]; mettab: int32[2, 256], on one device;
    ``maxcycles`` is per bit like the C (total budget maxcycles * 81,
    wsprd/fano.c:149). ``valid`` (bool[B], optional) marks live lanes:
    padding lanes start done (success False, every output 0).
    ``steps=True`` also returns each lane's flat step count.

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/fano.cu`` and count the launch in ``batched_fano.launches``;
    any other device raises."""
    if not 0 < maxcycles * NBITS + 2 < 2 ** 31 or not 0 < delta < 2 ** 31:
        raise ValueError(f"bad delta {delta} or maxcycles {maxcycles}")
    dev = symbols.device
    if mettab.device != dev or (valid is not None and valid.device != dev):
        raise ValueError("symbols, mettab and valid on different devices")
    if dev.type == "cpu":
        return batched_fano_plain(symbols, mettab, delta, maxcycles, valid,
                                  steps)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if symbols.dtype != torch.uint8 or symbols.dim() != 2 or \
            symbols.shape[1] != 2 * NBITS:
        raise ValueError(f"symbols must be uint8[B, {2 * NBITS}], got "
                         f"{symbols.dtype}{tuple(symbols.shape)}")
    if mettab.dtype != torch.int32 or tuple(mettab.shape) != (2, 256):
        raise ValueError(f"mettab must be int32[2, 256], got "
                         f"{mettab.dtype}{tuple(mettab.shape)}")
    B = symbols.shape[0]
    if valid is not None and (valid.dtype != torch.bool
                              or tuple(valid.shape) != (B,)):
        raise ValueError(f"valid must be bool[{B}], got "
                         f"{valid.dtype}{tuple(valid.shape)}")
    if mettab is not device_mettab(dev):
        _check_table_range(mettab)
    symbols = symbols.contiguous()
    mettab = mettab.contiguous()
    valid = None if valid is None else valid.contiguous()
    i32 = torch.int32
    data = torch.empty((B, 11), dtype=torch.uint8, device=dev)
    success = torch.empty(B, dtype=torch.bool, device=dev)
    metric = torch.empty(B, dtype=i32, device=dev)
    cycles = torch.empty(B, dtype=i32, device=dev)
    maxnp = torch.empty(B, dtype=i32, device=dev)
    nsteps = torch.empty(B, dtype=i32, device=dev) if steps else None
    if B == 0:
        return FanoResult(data, success, metric, cycles, maxnp, nsteps)
    lib = _load_kernel()
    # launch in the tensors' device, whatever the calling thread's is
    with torch.cuda.device(dev):
        rc = lib.fano_decode_lanes(
            symbols.data_ptr(), None if valid is None else valid.data_ptr(),
            mettab.data_ptr(), B, delta, maxcycles, data.data_ptr(),
            success.data_ptr(), metric.data_ptr(), cycles.data_ptr(),
            maxnp.data_ptr(), None if nsteps is None else nsteps.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fano kernel launch failed: CUDA error {rc}")
    batched_fano.launches += 1
    return FanoResult(data, success, metric, cycles, maxnp, nsteps)


batched_fano.launches = 0
