"""Static shape math helpers."""


def next_power_of_two(n: int) -> int:
    """Smallest power of two >= n.

    Examples:

    >>> from nx_signal_tpu_torch.utils.shapes import next_power_of_two
    >>> next_power_of_two(400), next_power_of_two(512), next_power_of_two(1)
    (512, 512, 1)
    """
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()
