"""Engine utilities: logging and metrics."""
