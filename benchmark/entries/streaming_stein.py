"""A live capture through ``StreamingCAF(backend="stein")``: a search
builds the stream on the needle (on the card), feeds the capture from
the host in chunks of ``chunk_len`` samples (the last one shorter), as
a receiver delivers them, and asks for ``best()``.  The clock marks the
build, each ``process()`` and ``best()``.  The answer is ``best()``
and every chunk's own peak as ``process()`` returned it."""

from __future__ import annotations

import torch

from caf_cookoff_tpu_torch import StreamingCAF


def prepare(cell, item):
    chunk = int(cell.workload["chunk_len"])
    capture = item["hays"][0]
    return (torch.from_numpy(item["needles"][0]).to(cell.device),
            [capture[i:i + chunk] for i in range(0, len(capture), chunk)])


def search(cell, prepared, clock):
    needle, chunks = prepared
    with clock.step("build"):
        stream = StreamingCAF(needle, cell.freqs, cell.fs,
                              chunk_len=len(chunks[0]), backend="stein",
                              device=cell.device)
    local = []
    for chunk in chunks:
        with clock.step("chunk"):
            local.append(stream.process(chunk))
    with clock.step("best"):
        return stream.best(), local


def pairs(answer):
    return [answer[0]]


def chunks(answer):
    """Each pair's chunk peaks, in the order fed."""
    return [answer[1]]
