"""``batched_stein_os_peak(needles, captures, freqs, fs,
num_lags=lags)``: each needle against its long capture, over the lags
where the needle lies wholly inside it; already on the card."""

from __future__ import annotations

import torch

from caf_cookoff_tpu_torch import batched_stein_os_peak


def prepare(cell, item):
    return tuple(torch.from_numpy(item[k]).to(cell.device)
                 for k in ("needles", "hays"))


def search(cell, prepared, clock):
    needles, hays = prepared
    return batched_stein_os_peak(needles, hays, cell.freqs, cell.fs,
                                 num_lags=int(cell.config["lags"]),
                                 device=cell.device)


def pairs(answer):
    fr, lg, vv = answer
    return [(float(f), int(x), float(v)) for f, x, v in zip(fr, lg, vv)]
