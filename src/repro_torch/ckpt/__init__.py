"""Checkpoints: atomic save, garbage collection and restore of a train state."""
