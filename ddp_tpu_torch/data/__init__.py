"""Training data: synthetic token streams and byte-level text."""
