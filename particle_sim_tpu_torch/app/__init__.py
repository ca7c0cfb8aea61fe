"""Application entry points: the headless CLI and the stream server."""
