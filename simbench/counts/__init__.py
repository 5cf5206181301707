"""Operation and byte counts of the port's kernels, one file per kernel.

Each module names the kernel as the device trace shows it (``KERNEL``, a
substring of the kernel's symbol), the peak it is held to (``PEAK``, a key
of ``peaks.json``), where the traced run records each launch's problem sizes
(``HOOK``: module, object and method of the port's wrapper, called once per
launch), how a call of that method gives the sizes (``sizes``), and the
least work those sizes need (``count(sizes) -> (operations, bytes)``).

The counts are of what the inputs need, not of what one implementation
does: every input byte read once and every output byte written once, and
operations that do not depend on how many iterations a kernel chose to
run, so that any implementation of the same problems is held to the same
work.
"""


def element_size(is_float64: int) -> int:
    return 8 if is_float64 else 4
