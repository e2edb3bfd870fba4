"""Host-side data access: CDF I/O, orbit discovery, cusp CSV, synthetic archives."""
