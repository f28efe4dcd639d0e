"""Data of the port: host-side datasets and the photometric augmentation."""
