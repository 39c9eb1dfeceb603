"""The |R|^2/max epilogue's ceiling on the card (kernel K4).

Port of ``docs/roofline_vpu.py``: K1's epilogue op mix (|R|^2 by
``mag2_rn``, a running max, one row reduce) on a (416, 8192) f32 pair
held on chip, swept 64 times, with no tensor-core work and no
device-memory traffic per sweep (``csrc/roofline_epilogue.cu``).  It
gives the rate a redesigned K1 epilogue can reach on this card.

    python -m caf_cookoff_tpu_torch.utils.roofline

prints one JSON line (operations/s, the epilogue floor in us, the card's
name and power limit).  :func:`epilogue` launches the kernel for a CUDA
device and runs :func:`epilogue_plain` for the CPU; the two compute the
same (rows,) maxima bit for bit.
"""

from __future__ import annotations

import ctypes
import json
from typing import Dict

import torch

from caf_cookoff_tpu_torch.config import default_device

KP = 416        # the headline kernel's padded bin count (400 -> 416)
M = 8192        # the headline lag count
REPEAT = 64     # sweeps per launch (amortizes the fill)
STEP = 2.0 ** -20   # sweep s works on (x + (s+1)*STEP, y + (s+1)*STEP)
# f32 operations executed per element and sweep: the 2 offset adds that
# keep the sweeps distinct, then the epilogue proper: 2 mul and 1 add
# (|R|^2, no fma) and 1 max.
OPS_PER_ELEM = 6
EPILOGUE_OPS = 4

LAUNCHES = 0


def _fill(rows: int, cols: int, seed: float, device):
    r = torch.arange(rows, dtype=torch.float32, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.float32, device=device)[None, :]
    return (r * 1e-3 + c * 1e-6) + seed, (c * 1e-3 - r * 1e-6) + seed


def epilogue_plain(rows: int = KP, cols: int = M, sweeps: int = REPEAT,
                   seed: float = 0.0, device="cpu") -> torch.Tensor:
    """The kernel's (rows,) row maxima in plain PyTorch, with its
    roundings (every operation a separate f32 op, so none contracts)."""
    x, y = _fill(rows, cols, seed, device)
    best = torch.zeros_like(x)
    for s in range(sweeps):
        d = (s + 1) * STEP
        xd, yd = x + d, y + d
        best = torch.maximum(best, xd * xd + yd * yd)
    return torch.amax(best, dim=1)


def _launch(lib, out: torch.Tensor, rows: int, cols: int, sweeps: int,
            seed: float, stream: int) -> None:
    global LAUNCHES
    rc = lib.caf_epilogue_roofline(out.data_ptr(), rows, cols, sweeps,
                                   ctypes.c_float(seed), stream)
    if rc != 0:
        raise RuntimeError(f"epilogue kernel launch failed: "
                           f"{lib.caf_cuda_error_string(rc).decode()}")
    # A launch into a CUDA graph being captured only records it: each
    # replay counts its launches (:func:`_launch_ms`).
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES += 1


def epilogue(rows: int = KP, cols: int = M, sweeps: int = REPEAT,
             seed: float = 0.0, device=None) -> torch.Tensor:
    """The epilogue microbenchmark: (rows,) f32 row maxima.  A CUDA
    device launches the kernel (``sweeps`` 1 or 64; a failed build or
    launch raises), the CPU runs :func:`epilogue_plain`."""
    dev = torch.device(device) if device is not None else default_device()
    if dev.type == "cpu":
        return epilogue_plain(rows, cols, sweeps, seed, dev)
    if dev.type != "cuda":
        raise ValueError(f"epilogue: unsupported device {dev}")
    if sweeps not in (1, REPEAT):
        raise ValueError(f"the kernel is compiled for 1 or {REPEAT} sweeps, "
                         f"got {sweeps}")
    if not 0 < rows <= 65535 or cols <= 0:
        raise ValueError(f"rows must be in [1, 65535] and cols positive, "
                         f"got ({rows}, {cols})")
    from caf_cookoff_tpu_torch.ops import _build

    lib = _build.load_library()
    out = torch.zeros(rows, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(lib, out, rows, cols, sweeps, seed,
                torch.cuda.current_stream(dev).cuda_stream)
    return out


def _launch_ms(sweeps: int, dev, burst: int = 20, rounds: int = 20) -> float:
    """Device ms of one (416, 8192) launch, the best of ``rounds``
    replays of a CUDA graph of ``burst`` launches: no host time sits
    between them (the wrapper's own host work takes about as long as the
    kernel)."""
    from caf_cookoff_tpu_torch.ops import _build
    from caf_cookoff_tpu_torch.utils.bench import _events_ms

    lib = _build.load_library()
    out = torch.zeros(KP, dtype=torch.float32, device=dev)

    def launches():
        stream = torch.cuda.current_stream(dev).cuda_stream
        for _ in range(burst):
            _launch(lib, out, KP, M, sweeps, 0.0, stream)

    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            launches()                       # warm-up, outside the graph
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            launches()

        def replay():
            global LAUNCHES
            graph.replay()
            LAUNCHES += burst

        return _events_ms(replay, 1, rounds, warmup=3) / burst


def measure(device="cuda") -> Dict:
    """Device times of the 64-sweep and the 1-sweep launch at (416,
    8192) (:func:`_launch_ms`); their difference is 63 sweeps without the
    fill, the row reduce or the launch.  Returns the times, the f32
    operation rate from that difference (and over the whole 64-sweep
    launch, a lower bound) and the epilogue floor: one sweep's 4
    epilogue operations an element over the pair at that rate."""
    from caf_cookoff_tpu_torch.utils.bench import _require_card

    dev = _require_card(device)
    ms = _launch_ms(REPEAT, dev)
    ms_one = _launch_ms(1, dev)
    elems = KP * M
    ops_per_s = (elems * OPS_PER_ELEM * (REPEAT - 1)
                 / max(ms - ms_one, 1e-9) * 1e3)
    return {"ms": ms, "ms_one_sweep": ms_one, "ops_per_s": ops_per_s,
            "ops_per_s_whole_launch": elems * OPS_PER_ELEM * REPEAT / ms * 1e3,
            "epilogue_floor_us": elems * EPILOGUE_OPS / ops_per_s * 1e6,
            "shape": f"{KP}x{M} f32, {REPEAT} sweeps, {OPS_PER_ELEM} ops an "
                     f"element and sweep ({EPILOGUE_OPS} of the epilogue)",
            "device": torch.cuda.get_device_name(dev)}


def main() -> None:
    from caf_cookoff_tpu_torch.utils.bench import nvidia_smi_card

    got = epilogue()
    want = epilogue_plain(device=got.device)
    if not torch.equal(got, want):
        raise SystemExit("epilogue kernel disagrees with its plain version")
    out = measure()
    out["card"] = nvidia_smi_card()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
