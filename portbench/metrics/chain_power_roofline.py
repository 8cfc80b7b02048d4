"""`chain_power_roofline` (%, trace): stage `chain_power`'s least time on this card
(portbench/stages/chain_power.py) over the device time of the operations its
'call' spans launched."""

from portbench.core.readers import roofline


def read(ctx):
    return roofline(ctx, "chain_power", "call")
