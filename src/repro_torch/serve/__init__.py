"""Serving: the batched greedy decode engine."""
