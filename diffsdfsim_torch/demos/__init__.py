"""Demos: the reference's demo scripts on the port."""
