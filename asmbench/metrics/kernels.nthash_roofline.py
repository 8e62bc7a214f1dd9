"""The ntHash kernel's share of its roofline over the profiled job: the
least time the bytes of its launches need at the card's memory
bandwidth (roofline.py; each launch's shape recorded at
ops.kernels.nthash_launch) over the profiler's device time of
nthash_kernel.  The bound is the published H100 SXM bandwidth, so a
card held below its 700 W limit reads lower."""

from asmbench.roofline import bound_seconds, nthash_bytes

UNIT = "%"
LAYER = "ops.kernels"
MOVES = "read_mbp_per_s"
CALLS = {"kernels.nthash_launch": ("abyss_tpu_torch.ops.kernels",
                                   "nthash_launch")}


def read(run):
    if run.profile is None:
        return None
    nbytes = 0
    for (shape, k, strands, *_rest) in run.profile_calls.get(
            "kernels.nthash_launch", []):
        B, L = shape
        nbytes += nthash_bytes(B, L, k, bool(strands))
    secs = run.profile.kernel_seconds(lambda n: "nthash_kernel" in n)
    if nbytes == 0 or secs <= 0:
        return None
    return 100.0 * bound_seconds(nbytes) / secs
