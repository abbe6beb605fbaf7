"""Device time of the hash grids' backward (the program's
``gf::grid_backward`` span: the table gradients' products and K1's fills and
scatters) per step.

The profiler gives each kernel to the innermost user span alone, so in a
traced run the benchmark's ``pb::k1`` span around each K1 call holds that
call's kernels, and the grid backward's own device range ends with its last
own kernel, before its last scatter. The device ranges of the K1 calls made
inside the span are counted with it: the n-th ``pb::k1`` host range launched
the n-th device range (one stream, calls in turn). Where the two counts
differ, the span's own range alone is read."""

from pbcore import trace as tr
from pbcore.readers import per_unit_ms


def device_s(t):
    own = t.dev_spans.get("gf::grid_backward")
    if not own:
        return None
    ranges = list(own)
    inside = [(a, b) for a, b, n in t.host_spans if n == "gf::grid_backward"]
    calls = [(a, b) for a, b, n in t.host_spans if n == "pb::k1"]
    dev_calls = sorted(t.dev_spans.get("pb::k1", []))
    if len(calls) == len(dev_calls):
        ranges += [d for (a, b), d in zip(calls, dev_calls)
                   if any(s <= a and b <= e for s, e in inside)]
    return sum(t.busy_between(a, b) for a, b in tr.merge(ranges, t.t0, t.t1)) / 1e9


def read(ctx):
    return per_unit_ms(device_s(ctx["trace"]), ctx, "steps")
