"""The frozen arithmetic of the metrics: percentiles, the roofline count, the trace reduction."""
