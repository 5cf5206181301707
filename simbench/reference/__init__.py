"""The plain reference the benchmark judges the port by.

``sim/`` is a frozen copy of the port's plain PyTorch path, cut to what
the configurations under ``simbench/configs`` build: box, sphere and
latent shapes, a body fixed in place, gravity, the 3D contact search, the
PDIPM solver with its KKT backward and the time of contact, stepped on a
lane axis. The CUDA kernel dispatch is taken out: every operation here is
a plain tensor operation, on the CPU or on the card. It imports nothing of
the port, of the JAX package or of JAX (``simbench/tests`` checks that).
``optim_sphere.py`` and ``optim_shapespace.py`` build each configuration's
worlds from its file under ``simbench/configs`` alone.
"""
