"""The pipelined driver (parallel/multichannel.py
``decode_channels_pipelined``) seen from its caller: the 95th
percentile, over the batches completed in the traced window, of the
time from the driver pulling a batch to its spots being yielded, in ms
on the host clock."""

import numpy as np


def read(trace):
    if not trace.batch_ms:
        return None
    return float(np.percentile(trace.batch_ms, 95))
