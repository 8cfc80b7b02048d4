"""`chain_power_sharded_roofline` (%, trace): stage `chain_power_sharded`'s least time on this card
(portbench/stages/chain_power_sharded.py) over the device time of the operations its
'call' spans launched. The lowest of the ranks."""

from portbench.core.readers import roofline

REDUCE = "min"


def read(ctx):
    return roofline(ctx, "chain_power_sharded", "call")
