"""Device milliseconds of the walk kernels in the profiled job: the
unitig walks and their look-aheads (csrc/walk.cu's walk_kernel and
branch_kernel, every variant), from the profiler."""

UNIT = "ms"
LAYER = "ops.kernels"
MOVES = "read_mbp_per_s"


def read(run):
    if run.profile is None:
        return None
    secs = run.profile.kernel_seconds(
        lambda n: "walk_kernel" in n or "branch_kernel" in n)
    return secs * 1e3 if secs > 0 else None
