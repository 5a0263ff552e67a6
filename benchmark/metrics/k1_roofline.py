"""k1_roofline (%, device trace): the least time of the last profiled
tick's lattice DP kernel launches (ops/st_kernel.py, csrc/st_wavefront.cu)
over their device time in the profiler trace.  The least time of a launch
is the larger of its bytes over the HBM bandwidth and its float operations
over the f32 peak, both counted on that launch's own inputs
(harness/roofline.py)."""


def read(run):
    if not run.k1:
        return None
    least = sum(a for a, _ in run.k1)
    kernel = sum(b for _, b in run.k1)
    return 100.0 * least / kernel if kernel > 0 else None
