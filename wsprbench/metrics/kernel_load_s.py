"""Loading (and, where ``_build/`` lacks them, building) the program's
kernel and host libraries (buildlib.py ``load_library``): wall seconds
of the program's ``kernel_load`` spans over the whole process, set-up
included; one inside the traced window is a load set-up missed."""

from ._record import process_self_s


def read(trace):
    return process_self_s("kernel_load")
