"""``feed: host``: host float32 windows, quantized and uploaded by the
pipelined decode (``transfer_dtype``), batches of the mix's size cycled
over the pool; the warm-up decodes every batch of the pool once, every
lane bucket and budget the window meets."""

from __future__ import annotations

from wsprbench import feeds, gen


class Feed(feeds.Feed):
    def __init__(self, cell, seed: int, devices: list):
        super().__init__(cell, seed, devices)
        self.device = devices[0]
        self.batch = int(cell.mix["batch"])
        self.pool = gen.baseband(cell.mix, seed, device=self.device)
        self.n_batches = self.pool.wi.shape[0] // self.batch

    def items(self, win, order):
        for b in order(self.n_batches):
            if win is not None and not win.pulled(b):
                return
            s = slice(b * self.batch, (b + 1) * self.batch)
            yield self.pool.wi[s], self.pool.wq[s]

    def windows_of(self, key) -> list[int]:
        return list(range(key * self.batch, (key + 1) * self.batch))

    def decode(self, items, options, on_error):
        from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc
        cfg = self.cell.config
        return mc.decode_channels_pipelined(
            items, options, depth=int(cfg["depth"]), device_batch=self.batch,
            transfer_dtype=cfg["transfer_dtype"], fec=cfg["fec"],
            device=self.device, on_error=on_error)

    def check_inputs(self, checked: list[int], n_done: int):
        """The pool's windows as the link carries them."""
        from wsprbench.reference.decode import quantize
        if self.cell.config["transfer_dtype"] == "int8":
            return {w: (quantize(self.pool.wi[w]), quantize(self.pool.wq[w]))
                    for w in checked}, {}
        return {w: (self.pool.wi[w], self.pool.wq[w]) for w in checked}, {}
