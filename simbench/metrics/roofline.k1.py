"""Share of its roofline that K1 (the PDIPM forward, ``ops/csrc/pdipm_fwd.cu``) reached
in the profiled unit: the least time its launches' problems need
(``counts/k1.py``) over its device time in the trace, in per cent."""

KERNEL_COUNT = "k1"


def read(rec):
    return rec.roofline(KERNEL_COUNT)
