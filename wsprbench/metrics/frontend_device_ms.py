"""The front end (frontend/decimate.py, frontend/polyphase.py): device
time of its two polyphase kernels, by name, in ms a channel-window."""


def read(trace):
    s = trace.kernel_s("polyphase_tc") + trace.kernel_s("polyphase")
    if trace.windows == 0 or s <= 0.0:
        return None
    return 1e3 * s / trace.windows
