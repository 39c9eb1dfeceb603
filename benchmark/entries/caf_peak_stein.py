"""``caf_peak(needle, haystack, freqs, fs, backend="stein")``: one pair a
call, both signals already on the card."""

from __future__ import annotations

import torch

from caf_cookoff_tpu_torch import caf_peak


def prepare(cell, item):
    return tuple(torch.from_numpy(item[k][0]).to(cell.device)
                 for k in ("needles", "hays"))


def search(cell, prepared, clock):
    needle, hay = prepared
    return caf_peak(needle, hay, cell.freqs, cell.fs, backend="stein",
                    device=cell.device)


def pairs(answer):
    return [answer]
