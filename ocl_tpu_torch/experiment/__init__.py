"""Experiment runners and metrics of the port."""
