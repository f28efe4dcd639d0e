"""Host-side utilities of the port: logging, plots, YAML configs and profiling."""
