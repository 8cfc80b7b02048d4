"""Published peaks of the cards the benchmark knows, and a stage's least
time from its work.

NVIDIA's data sheet for the H100 SXM (80 GB HBM3), dense rates at the full
700 W: 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of device
memory. A card missing from the table has no peaks, and every roofline
reader then reports nothing rather than a number against the wrong card."""

PEAKS = {
    "H100 80GB HBM3": {"f32_flops": 67e12, "bytes": 3.35e12},
}


def peaks(device_name: str):
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None


def least_seconds(flops: float, nbytes: float, device_name: str):
    """(least seconds, 'operations' or 'bytes'), the larger of the work's
    operations at the float32 peak and its bytes at the memory peak; None
    for a card with no peaks."""
    card = peaks(device_name)
    if card is None:
        return None
    ops_s, bytes_s = flops / card["f32_flops"], nbytes / card["bytes"]
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
