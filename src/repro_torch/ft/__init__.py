"""Fault tolerance: the retrying, straggler-flagging step runner."""
