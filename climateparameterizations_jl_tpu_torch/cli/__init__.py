"""Command-line helpers (partial: the suite loader and the wind-mixing model factory)."""
