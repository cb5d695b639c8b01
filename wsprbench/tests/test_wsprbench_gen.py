"""The traffic generator: the pool's content fixed by the mix, its order
by the run seed, the same work for every seed."""

from pathlib import Path

import numpy as np
import torch

from wsprbench import gen
from wsprbench.run import load_cell


def small(name, **kw):
    mix = load_cell(name).mix
    return dict(mix, **kw)


def rows(a):
    return sorted(r.tobytes() for r in a)


def test_baseband_content_fixed_order_by_seed():
    mix = small("farm.mixed", windows=4)
    a = gen.baseband(mix, 2**31 + 5)
    b = gen.baseband(mix, 2**31 + 5)
    c = gen.baseband(mix, 2**31 + 7)
    assert np.array_equal(a.wi, b.wi) and np.array_equal(a.wq, b.wq)
    assert rows(a.wi) == rows(c.wi) and rows(a.wq) == rows(c.wq)
    assert not np.array_equal(a.content_at, c.content_at)
    for pool in (a, c):
        for k, w in enumerate(pool.content_at):
            assert pool.truth[k] == a.truth[list(a.content_at).index(w)]
    assert a.wi.shape == (4, 45000) and a.wi.dtype == np.float32
    peak = np.maximum(np.abs(a.wi).max(axis=1), np.abs(a.wq).max(axis=1))
    assert np.allclose(peak, 0.5)
    other = gen.baseband(dict(mix, content_seed=12), 2**31 + 5)
    assert rows(other.wi) != rows(a.wi)


def test_pattern_is_the_bench_batch():
    """mixed: make_batch's signals (tools/torch_measure.py), 1 in 4
    windows noise only."""
    mix = small("farm.mixed", windows=12)
    calls = mix["signals"]["messages"]
    want = []
    for b in range(12):
        if b % 4 == 3:
            continue
        want += [(b, calls[b % 4], 3.0 - (b % 3) * 4.0,
                  -60.0 + 13.0 * (b % 9), 2.0),
                 (b, calls[(b + 1) % 4], -8.0, 45.0 - 11.0 * (b % 7), 1.0)]
    sig, P = gen.plan(mix)
    assert [(s.window, s.message, s.snr_db, s.f0_hz, s.t0_s)
            for s in sig] == want and P == 12
    assert sorted(gen.slots(12, 1)) == list(range(12))
    assert list(gen.slots(12, 1)) != list(gen.slots(12, 2))


def test_random_mix_spreads_its_counts_and_levels():
    mix = dict(gen.load_mix(Path(gen.__file__).parent / "traffic/crowded.json"),
               windows=18)
    sig, P = gen.plan(mix)
    counts = sorted(np.bincount([s.window for s in sig], minlength=18))
    assert counts == sorted(list(range(4, 13)) * 2)
    v = np.sort([s.snr_db for s in sig])
    n = len(v)
    # stratified: one level in each of n slices of [-25, -3]
    assert np.all(np.floor((v + 25.0) / 22.0 * n) == np.arange(n))
    for w in range(18):
        f = sorted(s.f0_hz for s in sig if s.window == w)
        assert all(b - a > 4.0 for a, b in zip(f, f[1:]))
    assert [s.message for s in gen.plan(mix)[0]] == [s.message for s in sig]


def test_raw_capture_deterministic_and_window_alone():
    mix = small("chain.raw", windows=3)
    a = gen.raw_capture(mix, 9, "cpu", seconds=0.01, lead=4)
    b = gen.raw_capture(mix, 9, "cpu", seconds=0.01, lead=4, only=[2])
    c = gen.raw_capture(mix, 10, "cpu", seconds=0.01, lead=4)
    assert a.raw_i.dtype == torch.uint8 and a.raw_i.shape == (3, 24004)
    assert torch.equal(a.raw_i[2], b.raw_i[0])
    assert torch.equal(a.raw_q[2], b.raw_q[0])
    assert rows(a.raw_i.numpy()) == rows(c.raw_i.numpy())
    assert torch.all(a.raw_i[:, :4] == 128)
    noise = a.raw_i[:, 4:].to(torch.float32) - 128.0
    assert abs(float(noise.std()) - 8.0) < 0.3
