"""Measurement tools of the port that run on a card."""
