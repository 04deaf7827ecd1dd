"""Evaluation over the port's serving path."""
