"""`halo_ms` and its variants (ms, trace): device time per call of kernel
E's kernels (kernels/csrc/halo.cu), the largest of the ranks. Its waits
are stream waits, not kernels, and are not in it."""

REDUCE = "max"
E_KERNELS = ("halo_put_kernel", "halo_interior_kernel", "halo_edges_kernel")


def read(ctx):
    return None if ctx.timeline is None else ctx.timeline.device_ms("call", names=E_KERNELS)
