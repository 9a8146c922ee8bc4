"""Training command lines."""
