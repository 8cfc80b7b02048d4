"""`throughput` and its variants (Msamples/s, host clock): the input
samples of every call of the window over the whole window, first issue to
last completion (on several cards the global samples over the slowest
rank's window). `throughput.roundtrip` and `throughput.sharded` are kept
apart from the card-paced cells' `throughput` because the host sets their
pace, so that their spread does not set its bound."""

from portbench.core.readers import throughput


def read(ctx):
    return throughput(ctx)
