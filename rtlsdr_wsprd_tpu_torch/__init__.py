"""rtlsdr_wsprd_tpu_torch — the WSPR decode framework in PyTorch and CUDA.

The port of ``rtlsdr_wsprd_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100. The JAX package stays beside it as the reference; this package
imports neither JAX nor anything of it and keeps its own copies of the
framework-free modules (constants, codecs, filter design, synthesis).

* ``frontend`` — the 2.4 Msps -> 375 sps two-stage polyphase decimator
                 and the wideband channelizer
                 on two hand-written CUDA kernels: uint8 stage 1 on the
                 tensor cores (``frontend/csrc/polyphase_tc.cu``), float32
                 stage 1 and stage 2 on the FP32 cores
                 (``frontend/csrc/polyphase.cu``).
* ``ops``      — STFT, candidate search, coarse grid, lane correlators
                 and coherent subtraction, as PyTorch tensor code; the
                 batched Fano decoder on a hand-written CUDA kernel
                 (``ops/csrc/fano.cu``), the hybrid device/host FEC
                 split and its calibration.
* ``parallel`` — the multi-channel decode: the staged path, its
                 pipelined stream decode and their multi-device forms;
                 the dense device step (``multichannel_decode_device``)
                 and its mesh path (``mesh.py``,
                 ``decode_channels(sharding=...)``); the multi-host
                 runtime on ``torch.distributed`` (``distributed``, the
                 time-sharded front end ``streaming``, ``dryrun``).
* ``models``   — ``Spot``, the dense per-window ``decode_window`` and the
                 ``WsprDecoder`` facade.
* ``runtime``  — IQ file IO, synthesis, sample sources (rtl_tcp, file,
                 synthetic), raw banks, wsprnet reporting, and the two
                 daemons: ``scheduler.WsprDaemon`` (one dongle) and
                 ``multidaemon.MultiChannelDaemon`` (many).
* ``cli``, ``multicli`` — the two command lines
                 (``python -m rtlsdr_wsprd_tpu_torch.cli`` /
                 ``.multicli``), flag-compatible with the JAX package's.
* ``native``   — ctypes binding to the host Fano decoder and encoder,
                 the uint8 IQ ingest and the host polyphase front end.
* ``convert``  — the JAX package's constant tables as the port's.

Every entry point takes ``device=None``, meaning the CUDA card (the
calling thread's current one, named by its index: ``cuda:k``), and
raises without one unless the caller passes ``device="cpu"`` (the CLIs:
``--compute-device cpu``).
"""

__version__ = "0.1.0"

from .config import DecoderOptions, ReceiverOptions  # noqa: F401
