"""Checkpoint / resume and the stream frame packer."""
