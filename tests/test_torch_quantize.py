"""The port's link quantize (csrc/quantize.cpp through
``native.quantize_into``) bit for bit against the scalar loop of
native/hostdsp.cpp (the JAX package's ``native.quantize_into``) and
numpy's ``clip(nan_to_num(rint(x * scale)))``, over both link formats,
lengths that put every element count in the vector body's tail, and
unaligned starts."""

import platform

import numpy as np
import pytest

from rtlsdr_wsprd_tpu import native as jnative
from rtlsdr_wsprd_tpu_torch import native as pnative

FORMATS = {"int8": (np.int8, 254.0, 127), "int16": (np.int16, 65534.0, 32767)}
LENGTHS = [0, 1, 7, 15, 16, 17, 31, 45000, 3 * 45000 + 5]
STEP = 16  # elements a step of the vector body


def _f32(bits: int) -> np.float32:
    return np.array([bits], np.uint32).view(np.float32)[0]


def _scaled_to(target: float, scale: np.float32) -> np.float32:
    """An x whose float32 product with ``scale`` is exactly ``target``:
    the nearest float32 to target / scale, or one a few ulps off it."""
    t = np.float32(target)
    x0 = np.float32(t / scale)
    for toward in (np.float32(-np.inf), np.float32(np.inf)):
        x = x0
        for _ in range(8):
            if np.float32(x * scale) == t:
                return x
            x = np.nextafter(x, toward)
    raise AssertionError(f"no float32 x gives {target} at scale {scale}")


def _specials(scale: float, lim: int) -> np.ndarray:
    """NaNs of both signs (and a signalling one), +-inf, +-0, every tie
    k + 0.5 for k in -130..130, the clamp's edge +-(lim + 0.5) with its
    neighbours inside and outside, subnormals and +-FLT_MAX."""
    s = np.float32(scale)
    big = np.finfo(np.float32).max
    vals = [np.float32(np.nan), _f32(0xFFC00000), _f32(0x7FA00000),
            np.float32(np.inf), np.float32(-np.inf), np.float32(0.0),
            np.float32(-0.0), big, -big, _f32(1), _f32(0x80000001),
            np.float32(1e-40), np.float32(-1e-40),
            np.finfo(np.float32).tiny]
    vals += [_scaled_to(k + 0.5, s) for k in range(-130, 131)]
    for sign in (1, -1):
        edge = _scaled_to(sign * (lim + 0.5), s)
        vals += [edge, np.nextafter(edge, np.float32(0)),
                 np.nextafter(edge, np.float32(sign * np.inf)),
                 _scaled_to(sign * (lim + 0.25), s),
                 _scaled_to(sign * (lim + 0.75), s),
                 _scaled_to(sign * (lim - 0.5), s)]
    out = np.array(vals, np.float32)
    with np.errstate(all="ignore"):
        v = out * s
        ties = np.count_nonzero(v - np.floor(v) == 0.5)
    assert ties == 261 + 4
    return out


def _input(n: int, scale: float, lim: int, seed: int) -> np.ndarray:
    """N(0, 0.2) samples (the -3 dB-normalized range) with the specials
    at random places and, where there is room, a run of them at the end
    (the vector body's tail)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.2, n).astype(np.float32)
    spec = np.roll(_specials(scale, lim), -seed)
    m = min(n, spec.size)
    x[rng.choice(n, m, replace=False)] = spec[:m]
    if n >= spec.size + STEP:
        x[n - STEP:] = spec[-STEP:]
    return x


def _numpy_ref(x: np.ndarray, dt, scale: float, lim: int) -> np.ndarray:
    with np.errstate(all="ignore"):
        v = np.rint(x * np.float32(scale))
    return np.clip(np.nan_to_num(v), -lim, lim).astype(dt)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_quantize_matches_hostdsp_and_numpy(fmt, n, offset):
    """Every element equal to the scalar reference and to numpy, the
    input and the output starting ``offset`` elements into larger
    buffers (unaligned loads and stores), and nothing written past
    ``out``'s end."""
    dt, scale, lim = FORMATS[fmt]
    x_buf = np.zeros(n + 4, np.float32)
    x = x_buf[offset:offset + n]
    x[:] = _input(n, scale, lim, seed=n * 4 + offset)
    out_buf = np.full(n + 4, 99, dt)
    got = out_buf[offset:offset + n]
    pnative.quantize_into(x, got, scale)
    ref = np.zeros(n, dt)
    jnative.quantize_into(x, ref, scale)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _numpy_ref(x, dt, scale, lim))
    assert (out_buf[:offset] == 99).all()
    assert (out_buf[offset + n:] == 99).all()


def test_quantize_returns_the_vector_count():
    """The count returned is the elements that went through the vector
    body: the length less its tail of length mod 16 on x86-64 (SSE2 is
    its baseline), for both formats."""
    sse2 = platform.machine().lower() in ("x86_64", "amd64")
    for fmt, (dt, scale, lim) in sorted(FORMATS.items()):
        for n in LENGTHS:
            x = _input(n, scale, lim, seed=n)
            got = pnative.quantize_into(x, np.zeros(n, dt), scale)
            assert got == (n - n % STEP if sse2 else 0), (fmt, n)
