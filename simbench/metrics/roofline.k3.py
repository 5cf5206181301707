"""Share of its roofline that K3 (the Frank-Wolfe contact search, ``ops/csrc/fw_search.cu``) reached
in the profiled unit: the least time its launches' problems need
(``counts/k3.py``) over its device time in the trace, in per cent."""

KERNEL_COUNT = "k3"


def read(rec):
    return rec.roofline(KERNEL_COUNT)
