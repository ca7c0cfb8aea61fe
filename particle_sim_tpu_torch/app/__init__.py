"""Application entry points: the headless CLI."""
