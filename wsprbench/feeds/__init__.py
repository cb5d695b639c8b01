"""How a deployment feeds the decode: one module a feed, named by the
configuration's ``feed`` key (``feeds/<feed>.py``), each defining a
class ``Feed`` that subclasses the base below. ``run.py`` finds the
module by that name under the cell's own root and knows no feed
otherwise, so a new deployment's feed is a new file here."""

from __future__ import annotations


class Feed:
    """What ``run.run`` relies on; a feed holds its inputs and its share
    of the program's state from construction to ``release``.

    * ``__init__(cell, seed, devices)``: make the inputs from the seed;
      ``devices`` is the cell's list of cards (``chips`` of them), the
      same device named ``chips`` times where a test names one. Runs on
      the set-up clock.
    * ``batch``: the most windows one pull holds.
    * ``items(win, order)``: the stream handed to ``decode``. With a
      window (``run.Window``), pull while ``win.pulled(key)`` says it is
      open, ``key`` saying what the pull holds; ``order(n)`` yields the
      seed's order over ``n`` keys. Without one (``None``, ``range`` as
      the order), the warm-up's pulls.
    * ``windows_of(key)``: the sampled windows' indices (pool slots) a
      pull holds, in the order ``decode`` yields their spot lists; the
      run counts a pull's windows as their number.
    * ``decode(items, options, on_error)``: the program's timed path,
      yielding each pull's per-window spot lists in order.
    * ``warm(options)``: every shape the window meets, once.
    * ``keep_for_check(rows)``: told the sampled windows before the
      warm-up; keeps what ``check_inputs`` needs of them.
    * ``check_inputs(checked, n_done)``: after the window, with
      ``n_done`` pulls yielded inside it: the reference's ``(i, q)``
      inputs of each judged window, from the seed's inputs and never
      from what the program made of them, and a dict of further numbers
      compared (``compare.judge``), empty by default.
    * ``release()``: free the feed's device state before the reference
      runs.
    """

    batch: int

    def __init__(self, cell, seed: int, devices: list):
        self.cell, self.devices = cell, devices

    def items(self, win, order):
        raise NotImplementedError

    def windows_of(self, key) -> list[int]:
        raise NotImplementedError

    def decode(self, items, options, on_error):
        raise NotImplementedError

    def warm(self, options):
        for _ in self.decode(self.items(None, range), options, None):
            pass

    def keep_for_check(self, rows: list[int]):
        pass

    def check_inputs(self, checked: list[int], n_done: int):
        raise NotImplementedError

    def release(self):
        pass
