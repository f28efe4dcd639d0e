"""Heatmap and label geometry."""
