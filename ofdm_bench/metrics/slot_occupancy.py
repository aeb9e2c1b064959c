"""slot_occupancy.live: percent of the chunk steps' detection slots
(streams x det_max) that held a detection in the traced steps: 100 x the
program's counter ``ofdm.detections`` over its ``ofdm.slots``, which the
program keeps only while the profiler records.  A ratio, so a retaken
trace leaves it as it is."""

from ofdm_bench.stages import occupancy, program_counters


def read(ctx: dict):
    return occupancy(program_counters())
