"""Share of its roofline that K2 (the KKT backward, ``ops/csrc/kkt_bwd.cu``) reached
in the profiled unit: the least time its launches' problems need
(``counts/k2.py``) over its device time in the trace, in per cent."""

KERNEL_COUNT = "k2"


def read(rec):
    return rec.roofline(KERNEL_COUNT)
