"""The port's headline bench (tools/torch_bench.py) against bench.py on
the CPU: its JSON keys and environment overrides, the headline's spot
count against the JAX package's decode of the same batch, the stage-A
sync count, the front-end and host-side sections, and the card as its
default."""

import ast
import sys

import numpy as np
import pytest
import torch

from rtlsdr_wsprd_tpu.config import DecoderOptions as JOptions
from rtlsdr_wsprd_tpu.parallel import multichannel as jmc

from torch_parity import CPU, REPO, import_tools
from torch_parity import jax_host_fec  # noqa: F401  (fixture)

(pbench, pmeasure) = import_tools("torch_bench", "torch_measure")
(jbench,) = import_tools("bench")


def _tree(name: str):
    return ast.parse((REPO / name).read_text())


def _metric_keys(tree) -> set[str]:
    """The keys of the dict literal that holds the "metric" key."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant)}
            if "metric" in keys:
                return keys
    raise AssertionError("no dict with a 'metric' key")


def _strings(tree, prefix: str) -> set[str]:
    return {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and n.value.startswith(prefix)}


def test_json_keys_and_overrides_equal_bench_py():
    """bench()'s dict has bench.py's JSON keys (:441-474) plus ``card``,
    and the tool reads bench.py's environment overrides by their names,
    no other."""
    jtree, ptree = _tree("bench.py"), _tree("tools/torch_bench.py")
    assert _metric_keys(ptree) == _metric_keys(jtree) | {"card"}
    env = "RTLSDR_WSPRD_TPU_BENCH_"
    assert _strings(ptree, env) == _strings(jtree, env)
    assert len(_strings(jtree, env)) == 7


@pytest.fixture(scope="module")
def batch8():
    wi, wq, _calls = pmeasure.make_batch(8)
    jwi, jwq = jbench.make_batch(8)
    np.testing.assert_array_equal(wi, jwi)
    np.testing.assert_array_equal(wq, jwq)
    return wi, wq


def test_headline_spots_match_jax(batch8, jax_host_fec):
    """headline(device="cpu", B=8, DB=4, runs=1): one run of ITERS
    batches, and ``spots_per_batch`` equal to the JAX package's
    decode_channels spot count on the same make_batch(8)."""
    got = pbench.headline(device=CPU, B=8, DB=4, runs=1)
    wi, wq = batch8
    ref = jmc.decode_channels(wi, wq, JOptions(), device_batch=4)
    assert got["spots_per_batch"] == sum(len(ch) for ch in ref) > 0
    assert len(got["runs_windows_per_s"]) == 1
    assert got["windows_per_s"] == got["runs_windows_per_s"][0] > 0


def test_stage_a_syncs_counts_the_coarse_grid(batch8):
    """stage_a_syncs counts DB x 512 rows x 32 lags x 9 drifts a call
    (bench.py:429)."""
    wi, wq = batch8
    got = pbench.stage_a_syncs(CPU, wi, wq, DB=2, iters=1)
    assert got["syncs_per_call"] == 2 * 512 * 32 * 9
    assert got["syncs_per_s"] == pytest.approx(
        got["syncs_per_call"] / got["seconds_per_call"])


def test_frontend_and_host_sections():
    """The front-end section at a small shape on the CPU, the host front
    end, and the link section (no pinned rate off the card)."""
    assert pbench.frontend(CPU, C=2, n_frames=16, iters=2) > 0
    assert pbench.host_frontend() > 0
    pageable, pinned = pbench.link(CPU)
    assert pageable > 0 and pinned is None


def test_bench_needs_a_card_unless_asked(monkeypatch):
    """Without --device the bench names the CUDA card: on a host without
    one, main() and each section raise before measuring anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["torch_bench.py"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pbench.main()
    z = np.zeros((1, 45000), np.float32)
    for call in (lambda: pbench.headline(batch=(z, z)),
                 lambda: pbench.frontend(C=1, n_frames=1),
                 lambda: pbench.stage_a_syncs(None, z, z),
                 pbench.e2e_daemon, pbench.link):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
