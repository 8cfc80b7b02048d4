"""`host_syncs_per_call` and its variants (count, trace): separate blocking
syncs of the host inside a call's span (aten::_local_scalar_dense,
cudaStreamSynchronize, cudaDeviceSynchronize, cudaMemcpy; one nested in
another counts once); on several cards the largest of the ranks."""

REDUCE = "max"


def read(ctx):
    return None if ctx.timeline is None else ctx.timeline.syncs_per_call()
