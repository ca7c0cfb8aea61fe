"""Measurement scripts of the port that no entry point runs."""
