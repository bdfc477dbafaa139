"""Measurement scripts for the card (each run as ``python -m``)."""
