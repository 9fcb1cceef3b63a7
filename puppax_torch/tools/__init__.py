"""Measurement tools for the port, run on an NVIDIA GPU."""
