"""Configurations of the port (the embedder's precision table)."""
