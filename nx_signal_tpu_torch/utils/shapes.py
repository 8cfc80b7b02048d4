"""Static shape math helpers (counterpart of nx_signal_tpu/utils/shapes.py)."""


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


def fft_fast_length(n: int) -> int:
    """FFT length of the convolution paths: the next power of two, as in the
    JAX package (where the TPU's FFT needs it); the results are sliced back
    to the exact N + K - 1, so the rule changes no value, only the speed.

    Examples:

    >>> from nx_signal_tpu_torch.utils.shapes import fft_fast_length
    >>> fft_fast_length(1000)
    1024
    """
    return next_power_of_two(n)


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth (2^a * 3^b * 5^c) integer >= n, the CPU-FFT notion
    of a fast size (scipy.fft.next_fast_len's analog).

    Examples:

    >>> from nx_signal_tpu_torch.utils.shapes import next_fast_len
    >>> next_fast_len(1001), next_fast_len(7)
    (1024, 8)
    """
    if n <= 6:
        return max(n, 1)
    best = next_power_of_two(n)
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            need = -(-n // p35)  # ceil(n / p35), then a power-of-two factor on top
            pow2 = 1 << max(0, (need - 1).bit_length())
            best = min(best, p35 * pow2)
            p35 *= 3
        p5 *= 5
    return best


def conv_output_length(n: int, k: int, mode: str) -> int:
    """Length of a 1-D convolution of n and k samples in `mode`.

    Examples:

    >>> from nx_signal_tpu_torch.utils.shapes import conv_output_length
    >>> [conv_output_length(10, 3, m) for m in ("full", "same", "valid")]
    [12, 10, 8]
    """
    if mode == "full":
        return n + k - 1
    if mode == "same":
        return n
    if mode == "valid":
        return n - k + 1
    raise ValueError(f"expected mode to be one of ['full', 'same', 'valid'], got: {mode}")


def _frame_block_widths(window_length: int, stride: int):
    """Column widths of the C = ceil(window_length / stride) hop blocks a
    frame splits into: `stride` each, the last one the remainder."""
    num_blocks = -(-window_length // stride)  # ceil
    return [min(stride, window_length - r * stride) for r in range(num_blocks)]
