"""kernels.wrapper_host_us (us): host time a call spends in the port's
kernel wrappers (the ``tsd.kernels.*`` spans: checks, casts, output
allocation, the launch), less the port spans nested in them (the row
barrier ``tsd.parallel.order``), over the wrapper calls of the traced
window.  None on a port without these spans."""


def read(tr):
    spans = sorted(tr.spans, key=lambda s: s[1])
    total, count = 0.0, 0
    for i, (name, s, d) in enumerate(spans):
        if not name.startswith("tsd.kernels."):
            continue
        count += 1
        total += d
        inner_end, j = s, i + 1
        while j < len(spans) and spans[j][1] <= s + d:
            n, cs, cd = spans[j]
            # a direct child: a port span inside this one that starts
            # after the last child taken ended (so not a grandchild)
            if n.startswith("tsd.") and cs >= inner_end \
                    and cs + cd <= s + d:
                total -= cd
                inner_end = cs + cd
            j += 1
    if count == 0:
        return None
    return total / count
