"""`stft_roofline` (%, trace): stage `stft`'s least time on this card
(portbench/stages/stft.py) over the device time of the operations its
'stft' spans launched."""

from portbench.core.readers import roofline


def read(ctx):
    return roofline(ctx, "stft", "stft")
