"""zstd_pct.write: share (%) of the window in which the api's zstd stage
(encode) ran on the host: the union of the spans around
``vbz_compression_tpu_torch.api:zstd_compress`` (every thread), over the
window."""

SPANS = {
    "api.zstd_compress":
        "vbz_compression_tpu_torch.api:zstd_compress",
}


def read(run):
    return run.span_pct("api.zstd_compress")
