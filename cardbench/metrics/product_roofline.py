"""product_roofline: the least time the card needs for the products
of the requests inside the profiled stretch (``cardbench.roofline``:
A's CSR, B and C each moved once, 2·nnz(A)·k operations, at the H100 SXM
data sheet's 3.35 TB/s and 67 TFLOP/s), as a share of the device time of
the compute kernels in that stretch (copies and sets left out)."""

from cardbench import profiling


def read(obs):
    if obs.profile is None or obs.least_s <= 0:
        return None
    busy = profiling.kernel_s(obs.profile)
    if busy <= 0:
        return None
    return 100.0 * obs.least_s / busy
