"""Assembled models: BraggNN."""
