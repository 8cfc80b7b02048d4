"""Host IO of the port (counterpart of nx_signal_tpu/io): WAV and raw
capture readers and writers on its own native library, and checkpoints of
streaming state."""

from nx_signal_tpu_torch.io.checkpoint import load_state, save_state
from nx_signal_tpu_torch.io.wav import (PrefetchingWavReader, RingBuffer, WavReader,
                                        read_wav, stream_wav, write_wav)

__all__ = ["PrefetchingWavReader", "RingBuffer", "WavReader", "load_state",
           "read_wav", "save_state", "stream_wav", "write_wav"]
