"""Host-to-device copy a request, ms: the pipeline's pageable upload of the
request's waves, the profiler's `Memcpy HtoD` rows over the traced window's
requests. Not measured where the rows add up to less than PCIe's least time for
the bytes those requests copied: the profiler dropped a row."""


def read(run):
    units = run.traced_units
    if not units:
        return None
    ms = run.reading.copy_ms(sum(u["h2d_bytes"] for u in units), run.peaks["pcie_bytes"])
    return None if ms is None else ms / len(units)
