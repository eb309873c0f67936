"""Device and precision policy."""
