"""Host-side data access: CDF I/O, orbit discovery, cusp CSV, synthetic archives."""

from configurable_spectrograms_torch.data.cdf_utils import (
    get_cdf_file_type,
    get_cdf_var_shapes,
    get_timestamps_for_orbit,
    get_variable_shape,
    load_fast_cdf_dataset,
    load_filtered_orbits,
)
from configurable_spectrograms_torch.data.orbit_discovery import (
    discover_orbit_files,
    extract_orbit_and_instrument,
    resolve_orbit_from_files,
    resolve_shared_orbit,
)

__all__ = [
    "get_cdf_file_type",
    "get_cdf_var_shapes",
    "get_timestamps_for_orbit",
    "get_variable_shape",
    "load_fast_cdf_dataset",
    "load_filtered_orbits",
    "discover_orbit_files",
    "extract_orbit_and_instrument",
    "resolve_orbit_from_files",
    "resolve_shared_orbit",
]
