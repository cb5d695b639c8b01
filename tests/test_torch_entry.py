"""The port's entry points (rtlsdr_wsprd_tpu_torch/entry.py) against the
JAX repo's __graft_entry__.py on the CPU: the example batch bit for bit,
entry()'s contract (tests/test_multichannel.py's), its forward step
against the JAX forward step, and the card as its default."""

import importlib.util

import numpy as np
import pytest
import torch

from rtlsdr_wsprd_tpu_torch import entry as pentry
from rtlsdr_wsprd_tpu_torch.parallel import dryrun
from rtlsdr_wsprd_tpu_torch.parallel.multichannel import ChannelDecode

from torch_parity import CPU, REPO


@pytest.fixture(scope="module")
def graft():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B", [2, 3])
def test_example_batch_equals_jax(graft, B):
    """_example_batch gives __graft_entry__._example_batch's windows bit
    for bit."""
    for got, ref in zip(pentry._example_batch(B), graft._example_batch(B)):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_entry_contract(graft):
    """entry(device="cpu") returns a callable and the JAX entry()'s
    arguments as tensors on the CPU: (2, 45000) float32 planes and an
    int32 maxdrift of 4. The file's second function is re-exported."""
    fn, args = pentry.entry(device=CPU)
    assert callable(fn)
    assert args[0].shape == (2, 45000) and args[0].dtype == torch.float32
    _jfn, jargs = graft.entry()
    assert len(args) == len(jargs) == 3
    for a, j in zip(args, jargs):
        assert a.device == torch.device(CPU)
        assert str(a.dtype).removeprefix("torch.") == j.dtype.name
        np.testing.assert_array_equal(a.numpy(), j)
    assert pentry.dryrun_multichip is dryrun.dryrun_multichip


def test_entry_forward_matches_jax(graft):
    """The forward step on its arguments against the JAX forward step on
    the CPU: every integer and bool field equal in every slot, floats
    within 1e-5 (tests/test_torch_dense.py), ``data`` where ``success``
    is set; both windows decode."""
    fn, args = pentry.entry(device=CPU)
    got = fn(*args)
    jfn, jargs = graft.entry()
    ref = jfn(*jargs)
    for name, g, r in zip(ChannelDecode._fields, got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape, name
        if name == "data":
            ok = np.asarray(ref.success)
            np.testing.assert_array_equal(g[ok], r[ok])
        elif g.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          r.astype(np.int64), err_msg=name)
    assert got.success.any(dim=1).all()


def test_entry_needs_a_card_unless_asked(monkeypatch):
    """entry() names the CUDA card: on a host without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pentry.entry()
