"""Analysis helpers of the port: the zero-trace roofline floor."""
