"""Data: deterministic token sources and the prefetching loader."""
