"""Checkpoint / resume."""
