"""Experiments: the paper's optimization scripts on the port."""
