"""End to end: the device time of the traced service updates (the first
decoding update of each cohort after the stagger, every stream decoding
its open segment to its budget) per second of the audio they ingested:
what a second of live captioning costs the card."""

from portbench.readers import device_ms_per_audio_s


def read(record):
    return device_ms_per_audio_s(record)
