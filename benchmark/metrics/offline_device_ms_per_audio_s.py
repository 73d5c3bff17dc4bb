"""End to end: the device time of the traced batch (a full batch of the
commonest bucket, clips of the same lengths for every seed, encoded and
greedily decoded as the window's batches are) per second of its audio:
what a second of batch transcription costs the card."""

from portbench.readers import device_ms_per_audio_s


def read(record):
    return device_ms_per_audio_s(record)
