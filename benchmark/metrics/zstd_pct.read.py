"""zstd_pct.read: share (%) of the window in which the api's zstd stage
(decode) ran on the host: the union of the spans around
``vbz_compression_tpu_torch.api:zstd_decompress`` (every thread), over the
window."""

SPANS = {
    "api.zstd_decompress":
        "vbz_compression_tpu_torch.api:zstd_decompress",
}


def read(run):
    return run.span_pct("api.zstd_decompress")
