"""Continual learners of the port (ER so far)."""
