"""Scale-out (port of linrad_tpu/parallel/): :class:`FleetRunner`, many
independent receivers as one batched step on one card."""

from .fleet import FleetRunner

__all__ = ["FleetRunner"]
