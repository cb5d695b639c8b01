"""The FEC calibration's measurement (ops/calibrate.py, each process
measures once a card): self wall seconds of the program's
``fec_calibrate`` spans over the whole process, set-up included (a
kernel load nested in it counts under ``kernel_load_s``)."""

from ._record import process_self_s


def read(trace):
    return process_self_s("fec_calibrate")
