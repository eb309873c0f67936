"""Checkpoint utilities."""
