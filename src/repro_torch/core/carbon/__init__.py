"""Carbon measurement: traces, paths, energy models, the carbon field."""
from repro_torch.core.carbon.intensity import (CITrace, GridRegion, REGIONS,
                                               STATE_CARBON_INDEX, get_region,
                                               region_ci)
from repro_torch.core.carbon.geo import geolocate, haversine_km, IPInfo
from repro_torch.core.carbon.path import (Hop, NetworkPath, discover_path,
                                          path_ci)
from repro_torch.core.carbon.energy import (HostPowerModel, HOST_PROFILES,
                                            host_profile_for_endpoint,
                                            hop_power_w)
from repro_torch.core.carbon.field import (CarbonField, FrozenField,
                                           default_field,
                                           install_frozen_default,
                                           register_field_setup)
from repro_torch.core.carbon.score import (carbonscore, transfer_emissions_g,
                                           transfer_emissions_g_batch,
                                           transfer_emissions_g_reference,
                                           TransferLedger)
from repro_torch.core.carbon.telemetry import (HostMetrics, NetworkMetrics,
                                               TransferMetrics, Pmeter)

__all__ = [
    "CITrace", "GridRegion", "REGIONS", "STATE_CARBON_INDEX", "get_region",
    "region_ci", "geolocate", "haversine_km", "IPInfo", "Hop", "NetworkPath",
    "discover_path", "path_ci", "HostPowerModel", "HOST_PROFILES",
    "host_profile_for_endpoint", "hop_power_w", "CarbonField", "FrozenField",
    "default_field", "install_frozen_default", "register_field_setup",
    "carbonscore", "transfer_emissions_g", "transfer_emissions_g_batch",
    "transfer_emissions_g_reference", "TransferLedger",
    "HostMetrics", "NetworkMetrics", "TransferMetrics", "Pmeter",
]
