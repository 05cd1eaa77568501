"""What a kind's ``Run`` reads of its cell and run."""

from __future__ import annotations


class Context:
    def __init__(self, cell, seed: int, device, fault: str = None):
        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.reference, self.model_flops = cell.reference, cell.model_flops
        self.seed, self.device = seed, device
        self.fault = fault

    def plant(self, run) -> None:
        """Break the program under ``run`` as the fault named says (the
        control runs and the tests of the check; never in a benchmark run)."""
        if self.fault is not None:
            from perfbench.lib import faults
            faults.plant(self.fault, run)
