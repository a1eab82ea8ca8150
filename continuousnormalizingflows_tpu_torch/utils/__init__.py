"""Parameter conversion and toy data."""
