"""api_own_pct.<part>: share (%) of the window in the own time of the api's
public calls (the program's root spans ``api.decompress``,
``api.compress``, ``api.decompress_batch``, ``api.compress_batch``): their
intervals less their child spans, the zstd stage's and the backend's. That
is the framing, the sized header, the frames' copies into bytes and the
results' ``tobytes``. One reader for every part."""

from benchmark.harness import program

ROOTS = ("api.decompress", "api.compress", "api.decompress_batch",
         "api.compress_batch")


def read(run):
    return program.share_pct(run, ROOTS)
