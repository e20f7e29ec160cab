"""Many robot streams on one card: FleetVio."""

from kimera_vio_tpu_torch.parallel.fleet import FleetState, FleetVio  # noqa: F401
