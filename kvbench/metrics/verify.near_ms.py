"""verify.near_ms (ms/query, layer verify): phase 2's device elapsed time
(the FFT near-sets or K2), between the two CUDA events of each device leg
of the program's ``kv.verify.near`` spans, summed over their chunks, per
query.  It counts the card's idle between a leg's launches too (each
near-set chunk waits on its ``nonzero`` count): on an H100 in the cnsm_ed
cells, 8-15% above the busy time of the kernels the spans launch."""

from kvbench import spans


def read(run):
    return spans.per_query(run, lambda rec: spans.device_ms(rec,
                                                            "kv.verify.near"))
