"""Both polyphase kernels' host side on the CPU: the tensor-core stage-1
kernel's split TF32 tables, its arithmetic and tile walk, and the float32
kernel's slab and per-phase register-tile walk, each emulated in
numpy/torch against the plain version and the JAX package; the routing
between them; and the tables following ``convert.load_state_dict``. The
kernels themselves run only on a card
(``test_torch_frontend.py::test_kernel_matches_plain_on_cuda`` and
``chip_smoke.py``)."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtlsdr_wsprd_tpu.frontend import decimate as jdec
from rtlsdr_wsprd_tpu.frontend.filters import R1, STAGE1_TAPS
from rtlsdr_wsprd_tpu.frontend.pallas_decimate import decimate_stage1_pallas
from rtlsdr_wsprd_tpu_torch import convert
from rtlsdr_wsprd_tpu_torch.frontend import decimate as pdec
from rtlsdr_wsprd_tpu_torch.frontend.polyphase import (
    _KERNELS,
    PolyphaseFilter,
    _route,
    polyphase_plain,
    tf32_round,
    tf32_split,
)

from torch_parity import CPU

TPP = STAGE1_TAPS // R1
# polyphase_tc.cu's block: 8 warps x 2 tiles of 16 input rows
KERNEL_TILE_ROWS = 8 * 2 * 16


def _low13(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) & np.uint32(0x1FFF)


def test_split_tables_are_tf32_and_sum_to_the_taps():
    """B_hi and B_lo have their low 13 mantissa bits zero (exact TF32
    operands) and B_hi + B_lo equals [Htop; Hbot] within 2^-22 |B|."""
    hi, lo = tf32_split(pdec.STAGE1.htop, pdec.STAGE1.hbot)
    b = np.concatenate([pdec.STAGE1.htop, pdec.STAGE1.hbot])
    assert hi.shape == lo.shape == b.shape == (2 * R1, 2 * TPP)
    assert not _low13(hi).any() and not _low13(lo).any()
    err = np.abs(hi.astype(np.float64) + lo - b)
    assert (err <= 2.0 ** -22 * np.abs(b)).all()
    # one TF32 rounding alone is off by far more
    assert np.abs(hi.astype(np.float64) - b).max() > 100 * err.max()


def _b_from_fragments(frag: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(B_hi, B_lo) read back from the fragment table by the kernel's
    index: bfrag[(s*2 + j)*32 + 4g + t] = (B_hi[8s+t, 8j+g],
    B_hi[8s+t+4, 8j+g], B_lo[8s+t, 8j+g], B_lo[8s+t+4, 8j+g])."""
    f = frag.reshape(2 * R1 // 8, 2, 8, 4, 4)   # s, j, g, t, value
    out = []
    for v in (0, 2):
        b = np.zeros((2 * R1 // 8, 8, 2, 8), np.float32)   # s, kk, j, g
        b[:, :4] = f[..., v].transpose(0, 3, 1, 2)
        b[:, 4:] = f[..., v + 1].transpose(0, 3, 1, 2)
        out.append(b.reshape(2 * R1, 2 * TPP))
    return out[0], out[1]


def _tc_emulate(u8I, u8Q, frag, n, tile_rows):
    """polyphase_tc.cu's walk in torch float32: per (row, tile) block the
    A tile of tile_rows input rows centred by xor 0x80 (rows past the
    input's end 0), P = A @ B_hi + A @ B_lo with B read from the
    fragment table, then the diagonal sums of tile_rows - 7 frames."""
    b_hi, b_lo = (torch.from_numpy(b) for b in _b_from_fragments(frag))
    frames = tile_rows - (TPP - 1)
    C = u8I.shape[0]
    y = np.zeros((2, C, n), np.float32)
    for c in range(C):
        for m0 in range(0, n, frames):
            rv = min(tile_rows, n + TPP - 1 - m0)
            a = np.zeros((tile_rows, 2 * R1), np.int8)
            for k, plane in enumerate((u8I, u8Q)):
                seg = plane[c, m0 * R1:(m0 + rv) * R1] ^ np.uint8(0x80)
                a[:rv, k * R1:(k + 1) * R1] = seg.view(np.int8).reshape(rv, R1)
            af = torch.from_numpy(a.astype(np.float32))
            P = (af @ b_hi + af @ b_lo).numpy()
            m = np.arange(min(frames, n - m0))
            for comp in (0, 1):
                acc = np.zeros(m.size, np.float32)
                for t in range(TPP):
                    acc += P[m + t, 2 * t + comp]
                y[comp, c, m0 + m] = acc
    return y


def _reference64(u8I, u8Q, n):
    """The stage-1 output in float64 from the float32 taps."""
    b = np.concatenate([pdec.STAGE1.htop, pdec.STAGE1.hbot]).astype(np.float64)
    return _diag(_rows64(u8I, u8Q, n) @ b, n)


def _rows64(u8I, u8Q, n):
    need = (n + TPP - 1) * R1
    f = [p[:, :need].astype(np.float64).reshape(p.shape[0], -1, R1) - 128.0
         for p in (u8I, u8Q)]
    return np.concatenate(f, axis=2)


def _diag(P, n):
    return np.stack([sum(P[:, t:t + n, 2 * t + comp] for t in range(TPP))
                     for comp in (0, 1)])


@pytest.mark.parametrize("tile_rows", [KERNEL_TILE_ROWS, 128, 64])
@pytest.mark.parametrize("n", [1, 129, 700])
def test_tc_arithmetic_matches_plain_and_xla(n, tile_rows):
    """The kernel's split-TF32 arithmetic and tile walk on uint8 C=3
    (at n = 700 the kernel's own 256-row tiles cross two block edges and
    end in a ragged tile): within 1e-4 of the plain version (float32 sums in another order)
    and 1e-3 of the JAX package's XLA path (its tolerance for uint8
    input); its error against a float64 reference is at least 100x
    smaller than that of one product with TF32-rounded taps."""
    rng = np.random.default_rng(100 + n)
    L = n * R1 + STAGE1_TAPS - R1
    u8I = rng.integers(0, 256, (3, L), dtype=np.uint8)
    u8Q = rng.integers(0, 256, (3, L), dtype=np.uint8)
    frag = pdec.STAGE1.tensors(CPU).b_frag.numpy()
    y = _tc_emulate(u8I, u8Q, frag, n, tile_rows)

    pI, pQ = polyphase_plain(torch.from_numpy(u8I), torch.from_numpy(u8Q),
                             pdec.STAGE1, n)
    np.testing.assert_allclose(y[0], pI.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(y[1], pQ.numpy(), rtol=0, atol=1e-4)
    xI, xQ = jdec.decimate_stage1_xla(jnp.asarray(u8I), jnp.asarray(u8Q), n)
    np.testing.assert_allclose(y[0], np.asarray(xI), rtol=0, atol=1e-3)
    np.testing.assert_allclose(y[1], np.asarray(xQ), rtol=0, atol=1e-3)

    ref = _reference64(u8I, u8Q, n)
    b1 = tf32_round(np.concatenate([pdec.STAGE1.htop, pdec.STAGE1.hbot]))
    single = _diag(_rows64(u8I, u8Q, n) @ b1.astype(np.float64), n)
    assert np.abs(y - ref).max() * 100 <= np.abs(single - ref).max()


@pytest.mark.parametrize("dtype, stage, route", [
    (torch.uint8, "STAGE1", "tc"),
    (torch.float32, "STAGE1", "direct"),
    (torch.float32, "STAGE2", "direct"),
])
def test_route_picks_the_kernel(dtype, stage, route):
    """uint8 stage-1 calls on CUDA go to the tensor-core kernel, float32
    calls to polyphase.cu; no card or launch needed."""
    assert _route("cuda", dtype, getattr(pdec, stage)) == route


# a 640/80 filter with real taps: the stage-1 shape, not its taps
_REAL_640 = PolyphaseFilter(np.hanning(STAGE1_TAPS).astype(np.complex64), R1)
# filters neither instantiation of polyphase.cu takes: stage 2's shape with
# complex taps, 9 taps per phase, and a decimation other than 80
_COMPLEX_2400 = PolyphaseFilter(
    pdec.STAGE2.gr + 1j * np.hanning(pdec.STAGE2.T), 80)
_TPP9 = PolyphaseFilter(np.hanning(720).astype(np.complex64), 80)
_R64 = PolyphaseFilter(np.hanning(640) * (1 + 1j), 64)


@pytest.mark.parametrize("device_type, filt", [
    ("cuda", pdec.STAGE2),
    ("cuda", _REAL_640),
    ("cpu", pdec.STAGE1),
], ids=["stage2", "real-taps-640", "cpu"])
def test_route_refuses_what_no_kernel_takes(device_type, filt):
    """uint8 planes through a filter other than stage 1 have no kernel
    (polyphase.cu takes float32 only), and no kernel runs off CUDA:
    _route raises rather than pick one."""
    with pytest.raises(ValueError):
        _route(device_type, torch.uint8, filt)


@pytest.mark.parametrize("filt", [_COMPLEX_2400, _TPP9, _R64],
                         ids=["complex-2400", "tpp9-720", "r64-640"])
def test_route_refuses_float32_no_instantiation_takes(filt):
    """float32 planes go to polyphase.cu, which is built for two filters
    only (640/80 with complex taps, 2400/80 with real taps): any other
    filter raises rather than launch."""
    with pytest.raises(ValueError):
        _route("cuda", torch.float32, filt)


def _direct_blocks() -> dict[str, tuple[int, int]]:
    """polyphase.cu's (frames per block, frames per thread) of each
    instantiation, read from its source."""
    src = _KERNELS["direct"][1].read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    return {f"STAGE{k}": (const(f"kStage{k}Frames"), const(f"kStage{k}Group"))
            for k in (1, 2)}


def _direct_emulate(xI, xQ, filt, n, frames, group):
    """polyphase.cu's walk in numpy float32. Per (row, block of `frames`
    output frames): the slab of frames + tpp - 1 rows of R samples, rows
    past the input's needed end 0. Thread (r, grp) walks slab rows
    grp*group + j, j < group + tpp - 1, of its phase r, and row j feeds
    frame i = j - t of its group through tap block t, so each of its
    `group` partials per plane adds t rising (complex taps: the gr
    product, then the gi one). Then each frame adds the R phases'
    partials, r rising."""
    R, tpp = filt.R, filt.tpp
    gr = filt.gr.reshape(tpp, R)                      # [t, r]
    gi = filt.gi.reshape(tpp, R)
    cplx = bool(np.any(gi))
    C = xI.shape[0]
    nb = -(-n // frames)
    rows = frames + tpp - 1
    slab = np.zeros((2, C, nb, rows, R), np.float32)  # plane, c, block, s, r
    for b in range(nb):
        rv = min(rows, n + tpp - 1 - b * frames)
        for p, x in enumerate((xI, xQ)):
            seg = x[:, b * frames * R:(b * frames + rv) * R]
            slab[p, :, b, :rv] = seg.reshape(C, rv, R)
    ng = frames // group
    aI = np.zeros((C, nb, ng, group, R), np.float32)  # c, block, grp, i, r
    aQ = np.zeros_like(aI)
    for j in range(group + tpp - 1):
        xi = slab[0][:, :, j + group * np.arange(ng)]  # [c, block, grp, r]
        xq = slab[1][:, :, j + group * np.arange(ng)]
        for t in range(max(0, j - group + 1), min(tpp, j + 1)):
            i = j - t
            aI[..., i, :] += gr[t] * xi
            aQ[..., i, :] += gr[t] * xq
            if cplx:
                aI[..., i, :] += -gi[t] * xq
                aQ[..., i, :] += gi[t] * xi
    y = np.zeros((2, C, nb * frames), np.float32)
    for p, a in enumerate((aI, aQ)):
        a = a.reshape(C, nb * frames, R)
        for r in range(R):
            y[p] += a[..., r]
    return y[:, :, :n]


@pytest.mark.parametrize("stage", ["STAGE1", "STAGE2"])
def test_direct_walk_matches_plain_and_jax(stage):
    """polyphase.cu's block walk at its own block shape, float32 C=2, n
    crossing two block edges and ending in a ragged block: within 1e-4 of
    the output scale of the plain version and of the JAX package's XLA
    path (stage 2 on N(0,30) rows, its tolerance in
    test_stage2_matches_xla); for stage 1 on N(0,1) rows also within 1e-4
    of the XLA path and the Pallas kernel in interpret mode, as
    test_stage1_float_matches_xla_and_pallas holds them."""
    frames, group = _direct_blocks()[stage]
    filt = getattr(pdec, stage)
    n = 2 * frames + frames // 2 + 3
    L = n * filt.R + filt.T - filt.R
    rng = np.random.default_rng(40 + filt.tpp)
    sd = 1.0 if stage == "STAGE1" else 30.0
    xI, xQ = (rng.normal(0, sd, (2, L)).astype(np.float32) for _ in range(2))
    y = _direct_emulate(xI, xQ, filt, n, frames, group)

    pI, pQ = polyphase_plain(torch.from_numpy(xI), torch.from_numpy(xQ),
                             filt, n)
    scale = float(np.abs(pI.numpy()).max())
    np.testing.assert_allclose(y[0], pI.numpy(), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(y[1], pQ.numpy(), rtol=0, atol=1e-4 * scale)
    if stage == "STAGE2":
        refs = [jdec.decimate_stage2_xla(jnp.asarray(xI), jnp.asarray(xQ), n)]
        atol = 1e-4 * scale
    else:
        refs = [jdec.decimate_stage1_xla(jnp.asarray(xI), jnp.asarray(xQ), n)]
        refs.append([np.stack(z) for z in zip(*(
            decimate_stage1_pallas(jnp.asarray(xI[c]), jnp.asarray(xQ[c]), n,
                                   interpret=True) for c in range(2)))])
        atol = 1e-4
    for rI, rQ in refs:
        np.testing.assert_allclose(y[0], np.asarray(rI), rtol=0, atol=atol)
        np.testing.assert_allclose(y[1], np.asarray(rQ), rtol=0, atol=atol)


def test_split_tables_follow_load_state_dict():
    """A bumped stage-1 Htop loaded through convert changes the
    fragment table STAGE1.tensors() returns to the split of the new taps
    (read back by the kernel's index); restoring it restores the table."""
    f0 = pdec.STAGE1.tensors(CPU).b_frag.clone()
    saved = convert.state_dict()
    try:
        bumped = dict(saved)
        bumped["frontend.stage1.htop"] = saved["frontend.stage1.htop"] * 3
        convert.load_state_dict(bumped)
        f1 = pdec.STAGE1.tensors(CPU).b_frag
        assert not torch.equal(f1, f0)
        hi1, lo1 = _b_from_fragments(f1.numpy())
        want_hi, want_lo = tf32_split(saved["frontend.stage1.htop"] * 3,
                                      saved["frontend.stage1.hbot"])
        np.testing.assert_array_equal(hi1, want_hi)
        np.testing.assert_array_equal(lo1, want_lo)
    finally:
        convert.load_state_dict(saved)
    assert torch.equal(pdec.STAGE1.tensors(CPU).b_frag, f0)
