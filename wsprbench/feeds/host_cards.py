"""``feed: host_cards``: the host farm (``host``) on every card of the
cell from one calling thread. Each pull of the mix's ``batch`` host
float32 windows goes whole to ``decode_channels_pipelined_multidevice``
over the cell's cards, which splits it into one contiguous shard a card
(``batch / cards`` windows, its ``device_batch``), quantizes and uploads
each shard on the calling thread and decodes it on its card. The pool
is made on the first card and copied to the host once; every card is
calibrated, and its FEC logged, before the warm-up decodes every pull
of the pool once."""

from __future__ import annotations

import sys

from wsprbench.feeds import host


class Feed(host.Feed):
    def decode(self, items, options, on_error):
        from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc
        cfg = self.cell.config
        return mc.decode_channels_pipelined_multidevice(
            items, options, depth=int(cfg["depth"]),
            device_batch=self.batch // len(self.devices),
            transfer_dtype=cfg["transfer_dtype"], fec=cfg["fec"],
            on_error=on_error, devices=self.devices)

    def warm(self, options):
        from rtlsdr_wsprd_tpu_torch.ops.calibrate import describe
        for k, d in enumerate(self.devices):
            print(f"fec card {k} ({d}): {describe(self.cell.config['fec'], d)}",
                  file=sys.stderr, flush=True)
        super().warm(options)
