"""The card's idle time inside the program's `train.step` ranges, ms a step: the
idle stretches of the traced window (outside the union of kernel and copy
intervals, `reading.intervals`) that the profiler's `train.step` rows cover,
over the number of those rows. Nothing where the profile holds no such row."""

ROOT = "train.step"


def read(run):
    r = run.reading
    lo, hi = r.window
    ranges = sorted((max(a, lo), min(b, hi)) for name, a, b in r.host_ops
                    if name == ROOT and b > lo and a < hi)
    if not ranges or not r.measured:
        return None
    covered: list[list[int]] = []  # the ranges' union
    for a, b in ranges:
        if covered and a <= covered[-1][1]:
            covered[-1][1] = max(covered[-1][1], b)
        else:
            covered.append([a, b])
    edges = [lo] + [x for ab in r.intervals for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    ns = i = j = 0
    while i < len(gaps) and j < len(covered):  # both sorted and disjoint
        (a, b), (c, d) = gaps[i], covered[j]
        ns += max(0, min(b, d) - max(a, c))
        if b < d:
            i += 1
        else:
            j += 1
    return ns / 1e6 / len(ranges)
