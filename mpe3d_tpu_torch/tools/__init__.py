"""Measurement tools that run on the card (not imported by the port)."""
