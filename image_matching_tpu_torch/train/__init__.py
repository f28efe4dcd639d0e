"""Training of the port: SuperGlue on pairs generated on the device."""
