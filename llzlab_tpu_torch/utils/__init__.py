"""Checkpoint, config and metrics utilities."""
