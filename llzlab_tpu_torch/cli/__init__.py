"""Command-line tools: WAV in, a streamed chain on the card, WAV out."""
