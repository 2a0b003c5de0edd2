"""Carbon measurement: traces, paths, energy models, the carbon field."""
