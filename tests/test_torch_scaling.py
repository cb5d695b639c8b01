"""The port's scaling tool (tools/torch_scaling.py) against
tools/scaling.py on the CPU: its constants and windows bit for bit, its
JSON keys in every mode, the mesh mode over two CPU shards, the 2-rank
dist and daemon modes (slow), and the card as its default."""

import ast

import numpy as np
import pytest
import torch

from torch_parity import CPU, REPO, import_tools

(pscaling,) = import_tools("torch_scaling")
(jscaling,) = import_tools("scaling")


def _json_shapes(name: str) -> dict:
    """Every dict literal of a tool keyed by what it reports: a mode's
    line by its "mode" value, a rank's row by ("rank", its unit)."""
    out = {}
    for node in ast.walk(ast.parse((REPO / "tools" / name).read_text())):
        if not isinstance(node, ast.Dict) or not node.keys:
            continue
        keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
        if keys[:1] == ["mode"]:
            out[node.values[0].value] = set(keys)
        elif keys[:1] == ["rank"]:
            out["rank", keys[2]] = set(keys)
    return out


def test_constants_and_windows_equal_jax():
    """The JAX tool's constants, and its windows bit for bit."""
    assert (pscaling.B_GLOBAL, pscaling.DEVICE_BATCH, pscaling.C_GLOBAL) == \
        (jscaling.B_GLOBAL, jscaling.DEVICE_BATCH, jscaling.C_GLOBAL)
    assert pscaling.DECODE_KW == jscaling.DECODE_KW
    for got, ref in zip(pscaling._windows(8), jscaling._windows(8)):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_json_keys_equal_jax():
    """The mesh, dist and daemon lines and both kinds of rank row have
    the JAX tool's keys."""
    got, want = _json_shapes("torch_scaling.py"), _json_shapes("scaling.py")
    assert set(want) == {"mesh", "dist", "daemon", ("rank", "windows"),
                         ("rank", "channels")}
    assert got == want


def test_mesh_mode_two_cpu_shards():
    """The mesh mode at B=2 over make_mesh(["cpu", "cpu"]): the sharded
    dense step equals the unsharded one in every ChannelDecode field
    (mesh_mode raises otherwise) and every window decodes."""
    out = pscaling.mesh_mode(CPU, B=2, devices=[CPU, CPU], reps=1)
    assert set(out) == _json_shapes("scaling.py")["mesh"]
    assert (out["mode"], out["B"], out["devices"]) == ("mesh", 2, 2)
    assert out["t_unsharded_s"] > 0 and out["t_sharded_8dev_s"] > 0


@pytest.mark.slow
def test_dist_mode_two_ranks():
    """The dist mode on the CPU: a solo process on 8 windows, one on 4,
    two gloo ranks on 4 each (every window spotted in each process), the
    JAX tool's keys, and each process's kernel launches and runs a timed
    sample."""
    out, procs = pscaling.dist_mode(CPU, timeout_s=900)
    assert set(out) == _json_shapes("scaling.py")["dist"]
    assert [r["windows"] for r in out["ranks"]] == [4, 4]
    assert len(procs) == 4
    assert all("fano" in x["launches"] and x["runs_a_sample"] >= 1
               for x in procs)


@pytest.mark.slow
def test_daemon_mode_two_ranks():
    """The daemon mode on the CPU: solo on 4 channels, on 2, and two
    ranks on 2 each, one spot a channel in every process."""
    out, procs = pscaling.daemon_mode(CPU, timeout_s=3600)
    assert set(out) == _json_shapes("scaling.py")["daemon"]
    assert [r["channels"] for r in out["ranks"]] == [2, 2]
    assert len(procs) == 4
    assert all("fano" in x["launches"] and x["runs_a_sample"] >= 1
               for x in procs)


def test_scaling_needs_a_card_unless_asked(monkeypatch):
    """Without --device each mode names the CUDA card: on a host without
    one it raises before it starts a process or measures anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("mesh", "dist", "daemon"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pscaling.main([mode])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pscaling.mesh_mode()
