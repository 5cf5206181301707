"""simbench: the benchmark of diffsdfsim_torch (see ``run.py``)."""
