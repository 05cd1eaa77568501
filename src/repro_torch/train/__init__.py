"""Training: AdamW with mixed-precision state, and the functional train step."""
