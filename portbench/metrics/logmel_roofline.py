"""`logmel_roofline` (%, trace): stage `logmel`'s least time on this card
(portbench/stages/logmel.py) over the device time of the operations each
call launched."""

from portbench.core.readers import roofline


def read(ctx):
    return roofline(ctx, "logmel")
