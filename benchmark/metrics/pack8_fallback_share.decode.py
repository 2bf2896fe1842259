"""% of the decode passes (count ``decode.passes``) whose pixels did not
fit a byte, so that the collector copied the wide pixels back instead
(count ``decode.pack8_fallbacks``)."""

from benchmark import program_trace


def read(run):
    return program_trace.count_share(run, "decode.pack8_fallbacks",
                                     "decode.passes")
