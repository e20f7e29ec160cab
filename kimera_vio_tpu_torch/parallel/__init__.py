"""Many robot streams over a (data, model) mesh of devices: FleetVio."""

from kimera_vio_tpu_torch.parallel.fleet import (  # noqa: F401
    FleetState,
    FleetVio,
    RowState,
    fleet_mesh,
)
