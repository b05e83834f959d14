"""Continual learners of the port."""
