"""Profiling and featurisation: records, the NSM, and the profiled train step."""
