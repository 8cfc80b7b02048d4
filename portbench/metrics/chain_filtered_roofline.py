"""`chain_filtered_roofline` (%, trace): stage `chain_filtered`'s least time on this card
(portbench/stages/chain_filtered.py) over the device time of the operations its
'call' spans launched."""

from portbench.core.readers import roofline


def read(ctx):
    return roofline(ctx, "chain_filtered", "call")
