"""Measurement tools for the port on the card."""
