"""The benchmark's plain reference: the WSPR decode and the RTL front end
in plain PyTorch and NumPy, frozen here. It imports nothing of the
program it judges."""
