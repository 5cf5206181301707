"""Learned shape models (the IGR shape-space decoder)."""
