"""graph_share.live: percent of the traced chunk steps that ran as one
replay of the receiver's CUDA graph: 100 x the total over the values kept
of the program's counter ``ofdm.graph_steps`` (1 a replayed step, 0 an
eager one), which the program keeps only while the profiler records.  A
program without the counter reads None."""

from ofdm_bench.stages import program_counters


def read(ctx: dict):
    total, records = (program_counters() or {}).get("ofdm.graph_steps",
                                                    (0, 0))
    return 100.0 * total / records if records else None
