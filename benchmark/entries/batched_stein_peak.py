"""``batched_stein_peak(needles, haystacks, freqs, fs)``: a batch of
equal-length pairs a call, already on the card."""

from __future__ import annotations

import torch

from caf_cookoff_tpu_torch import batched_stein_peak


def prepare(cell, item):
    return tuple(torch.from_numpy(item[k]).to(cell.device)
                 for k in ("needles", "hays"))


def search(cell, prepared, clock):
    needles, hays = prepared
    return batched_stein_peak(needles, hays, cell.freqs, cell.fs,
                              device=cell.device)


def pairs(answer):
    fr, lg, vv = answer
    return [(float(f), int(x), float(v)) for f, x, v in zip(fr, lg, vv)]
