"""Image preprocessing and dataset constants."""
