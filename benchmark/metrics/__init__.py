"""Readers of the per-layer metrics, one file a metric, named as the metric."""
