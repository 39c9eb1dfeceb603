"""A cell as its pieces see it: its configuration and workload files,
the grid, and the device it runs on."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from benchmark import spec


@dataclass
class Cell:
    name: str
    config: Dict
    workload: Dict
    device: str = "cuda"
    freqs: np.ndarray = field(init=False)
    # The doppler-rate grid (Hz/s) of a configuration that names one
    # (``rate_start_hz_per_s``, ``rate_step_hz_per_s``, ``rates``), or
    # None: its answers are then (rate, freq, lag, value), keyed (rate
    # index, bin, lag).
    rates: Optional[np.ndarray] = field(init=False)

    def __post_init__(self):
        c = self.config
        self.freqs = (c["freq_start_hz"] + c["freq_step_hz"]
                      * np.arange(c["bins"])).astype(np.float32)
        self.rates = None if "rates" not in c else (
            c["rate_start_hz_per_s"] + c["rate_step_hz_per_s"]
            * np.arange(c["rates"])).astype(np.float32)

    @property
    def fs(self) -> float:
        return float(self.config["sample_rate_hz"])

    @property
    def pairs(self) -> int:
        """Pairs a search answers."""
        return int(self.workload["pairs_per_call"])

    @property
    def grids(self) -> List[np.ndarray]:
        """The grids an answer's leading numbers lie on, in its order:
        the rates (where the cell has them), then the frequencies."""
        return [self.freqs] if self.rates is None else [self.rates,
                                                        self.freqs]


def load(name: str, device: str = "cuda", config: Dict = None,
         workload: Dict = None) -> Cell:
    """The cell ``name`` from its files; ``config`` / ``workload`` update
    their files' keys (the CPU tests run cells at small sizes so)."""
    w = {**spec.load_json("workloads", name), **(workload or {})}
    c = {**spec.load_json("configs", w["config"]), **(config or {})}
    return Cell(name, c, w, device)


def make_pool(cell: Cell, seed: int) -> List[Dict]:
    """The cell's pool of distinct inputs, drawn from ``seed`` by its
    configuration's recipe: numpy arrays on the host."""
    recipe = spec.load_module("recipes", cell.config["recipe"])
    return [recipe.make(cell.config, seed, i, cell.pairs)
            for i in range(int(cell.workload["pool"]))]
