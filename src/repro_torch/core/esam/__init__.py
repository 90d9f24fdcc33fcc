"""The ESAM core of the port: tiles, plans, learning, faults, cost model."""

from repro_torch.core.esam.faults import FaultModel

__all__ = ["FaultModel"]
