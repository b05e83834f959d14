"""Measurement tools of the port, for runs on the card (timing of kernels)."""
