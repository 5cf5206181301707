"""Share of its roofline that K4 (the fused IGR decoder, ``ops/csrc/igr_mlp.cu``) reached
in the profiled unit: the least time its launches' problems need
(``counts/k4.py``) over its device time in the trace, in per cent."""

KERNEL_COUNT = "k4"


def read(rec):
    return rec.roofline(KERNEL_COUNT)
