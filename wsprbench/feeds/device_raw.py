"""``feed: device_raw``: each channel a raw 2.4 Msps uint8 capture on
the card, replayed every round with the front end's carries going on:
``steps`` fused stage-1 + stage-2 steps of ``n_mid`` stage-1 frames a
round, each window normalized to a 0.5 peak on the card and handed over
as a ``prepare_windows_device`` handle. The warm-up is round 0, which
primes the carries. The check compares the kept channels' windows of
every round after the first with the reference front end's
(``baseband_err``) and decodes the reference's."""

from __future__ import annotations

import torch

from wsprbench import feeds, gen


class Feed(feeds.Feed):
    def __init__(self, cell, seed: int, devices: list):
        from rtlsdr_wsprd_tpu_torch.frontend.filters import (
            R1, R2, STAGE1_TAPS, STAGE2_TAPS)
        super().__init__(cell, seed, devices)
        self.device = dev = devices[0]
        cfg = cell.config["frontend"]
        self.n_mid = int(cfg["n_mid"])
        self.steps = int(cfg["steps"])
        self.R1 = R1
        self.lead = STAGE1_TAPS - R1
        self.batch = int(cell.mix["batch"])
        self.pool = gen.raw_capture(cell.mix, seed, dev, lead=self.lead)
        C = self.pool.raw_i.shape[0]
        self.m2 = [torch.zeros((C, STAGE2_TAPS - R2), dtype=torch.float32,
                               device=dev) for _ in range(2)]
        self.check_rows: list[int] = []
        self.kept: list = []          # (rows I, rows Q) a round, on the card
        self.rounds = 0

    def _round(self):
        from rtlsdr_wsprd_tpu_torch.frontend.decimate import (
            _fused_frontend_step)
        from rtlsdr_wsprd_tpu_torch.parallel.multichannel import (
            prepare_windows_device)
        ri, rq = self.pool.raw_i, self.pool.raw_q
        span = self.n_mid * self.R1
        ois, oqs = [], []
        for s in range(self.steps):
            a = s * span
            oi, oq, self.m2[0], self.m2[1] = _fused_frontend_step(
                ri[:, a:a + span + self.lead], rq[:, a:a + span + self.lead],
                self.m2[0], self.m2[1], self.n_mid)
            ois.append(oi)
            oqs.append(oq)
        if self.rounds == 0:  # from now on the stream runs on in a loop
            ri[:, :self.lead] = ri[:, -self.lead:]
            rq[:, :self.lead] = rq[:, -self.lead:]
        self.rounds += 1
        wi, wq = torch.cat(ois, dim=1), torch.cat(oqs, dim=1)
        peak = torch.maximum(wi.abs().amax(dim=1), wq.abs().amax(dim=1))
        scale = (0.5 / torch.clamp(peak, min=1e-24))[:, None]
        wi, wq = wi * scale, wq * scale
        if self.check_rows and self.rounds > 1:  # rounds after the first
            rows = torch.as_tensor(self.check_rows, device=wi.device)
            self.kept.append((wi[rows], wq[rows]))
        return prepare_windows_device(wi, wq, device_batch=self.batch)

    def items(self, win, order=None):
        """Rounds while the window is open; without one, one round."""
        while win is None or win.pulled(0):
            yield self._round()
            if win is None:
                return

    def windows_of(self, key) -> list[int]:
        return list(range(self.batch))

    def decode(self, items, options, on_error):
        from rtlsdr_wsprd_tpu_torch.parallel import multichannel as mc
        cfg = self.cell.config
        return mc.decode_channels_pipelined(
            items, options, depth=int(cfg["depth"]), device_batch=self.batch,
            fec=cfg["fec"], device=self.device, on_error=on_error)

    def keep_for_check(self, rows: list[int]):
        """Keep these channels' windows of every round after the first."""
        self.check_rows = rows

    def check_inputs(self, checked: list[int], n_done: int):
        """The reference front end's steady windows of the kept channels,
        from their captures (the bytes after the stream's lead), in
        float64: ``baseband_err`` holds the kept windows of the rounds
        yielded inside the window to them, over the 0.5 peak, and they
        are what the reference decodes."""
        from wsprbench.reference.frontend import steady_window
        ref_bb = [steady_window(self.pool.raw_i[r, self.lead:],
                                self.pool.raw_q[r, self.lead:],
                                dtype=torch.float64)
                  for r in self.check_rows]
        err = 0.0
        for ki, kq in self.kept[:n_done]:
            for k in range(len(checked)):
                ri, rq = ref_bb[k]
                err = max(err, float((ki[k] - ri).abs().max()),
                          float((kq[k] - rq).abs().max()))
        inputs = {w: (ref_bb[k][0].cpu().numpy(), ref_bb[k][1].cpu().numpy())
                  for k, w in enumerate(checked)}
        return inputs, {"baseband_err": err / 0.5}

    def release(self):
        self.pool.raw_i = self.pool.raw_q = None
        self.m2 = None
