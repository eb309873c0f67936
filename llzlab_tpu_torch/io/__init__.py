"""Host-side I/O: WAV files."""
