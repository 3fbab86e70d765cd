"""``flash_decode_paged``'s share of its roofline in the traced slice: the
least time of the calls' work (``bench.counts``: the live K and V read
once, q read and the output written, against the operations on the CUDA
cores; the larger) over the kernel time they took.  Nothing where the
slice holds none of the kernel's launches, or not one for each call the
slice's steps make."""
import sys

from bench import counts

#: the kernel's two routes, as the device trace names them
KERNELS = ("decode_kernel", "decode_grouped")


def read(run):
    t = run.trace
    if t is None:
        return None
    spans = [s for s in t.device if any(k in s[0] for k in KERNELS)]
    calls = [c for req, i in run.tracer.steps
             for c in run.driver.decode_calls(req, i)]
    if not spans or len(spans) != len(calls):
        print(f"bench: {__name__}: {len(spans)} kernel launches traced for "
              f"{len(calls)} calls; not read", file=sys.stderr)
        return None
    least = sum(counts.least_seconds(*counts.decode_call_work(*c))
                for c in calls)
    return 100.0 * least / sum(b - a for _, a, b, _ in spans)
