"""rtlsdr_wsprd_tpu_torch — the WSPR decode framework in PyTorch and CUDA.

The port of ``rtlsdr_wsprd_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. The JAX package stays beside it as the reference; this package
imports neither JAX nor anything of it and keeps its own copies of the
framework-free modules (constants, codecs, filter design, synthesis).

* ``frontend`` — the 2.4 Msps -> 375 sps two-stage polyphase decimator;
                 both stages run through one hand-written CUDA kernel
                 (``frontend/csrc/polyphase.cu``).
* ``ops``      — STFT, candidate search, coarse grid, lane correlators
                 and coherent subtraction, as PyTorch tensor code.
* ``parallel`` — the staged single-device multi-channel decode.
* ``models``   — ``Spot`` and the ``WsprDecoder`` facade.
* ``native``   — ctypes binding to the host Fano decoder.
* ``convert``  — the JAX package's constant tables as the port's.

Every entry point takes ``device=None``, meaning the CUDA card, and
raises without one unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import DecoderOptions  # noqa: F401
