"""Weight carrying and other helpers."""
