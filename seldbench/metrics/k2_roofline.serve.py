"""K2's share of its roofline, %: the least time of the traced requests' tracker
work (channel 0's DOA-band planes read once, a byte mask and the final state
written, at the memory rate; 12 fp32 operations a cell at the fp32 peak, the
larger) over the profiler's time of the `noise_floor_kernel` rows."""

from seldbench import work
from seldbench.reference.features import params_of

NOTE = "bound: bytes (read once, written once, 3.35e12 B/s), H100 SXM peaks at 700 W"


def read(run):
    ms, n = run.reading.device_ms("noise_floor_kernel")
    units = run.traced_units
    if not n or ms <= 0 or not units:
        return None
    p = params_of(run.cfg)
    least = sum(work.k2_least_ms(u["clips"], p.upper_bin - p.lower_bin, u["frames"])[0]
                for u in units)
    return 100.0 * least / ms
