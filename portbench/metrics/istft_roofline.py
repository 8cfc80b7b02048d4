"""`istft_roofline` (%, trace): stage `istft`'s least time on this card
(portbench/stages/istft.py) over the device time of the operations its
'istft' spans launched."""

from portbench.core.readers import roofline


def read(ctx):
    return roofline(ctx, "istft", "istft")
