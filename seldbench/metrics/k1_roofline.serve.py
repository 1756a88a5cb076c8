"""K1's share of its roofline, %: the least time of the traced requests' K1 work
(2,112 fp32 operations a (clip, bin, frame) cell of the DOA band at the fp32
peak, or its bytes at the memory rate, the larger) over the profiler's time of
the `salsa_spatial_kernel` rows."""

from seldbench import work
from seldbench.reference.features import params_of

NOTE = "bound: operations (2,112 fp32 a cell, 67e12 FLOP/s), H100 SXM peaks at 700 W"


def read(run):
    ms, n = run.reading.device_ms("salsa_spatial_kernel")
    units = run.traced_units
    if not n or ms <= 0 or not units:
        return None
    p = params_of(run.cfg)
    least = sum(work.k1_least_ms(u["clips"], p.upper_bin - p.lower_bin, u["frames"],
                                 p.audio_format)[0] for u in units)
    return 100.0 * least / ms
