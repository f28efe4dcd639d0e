"""Host-side utilities of the port: logging and plots."""
