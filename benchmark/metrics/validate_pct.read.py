"""validate_pct.read: share (%) of the window in which the backend's stream
validation ran on the host: the union of the spans around
``vbz_compression_tpu_torch.models.codec:_check_stream`` (every thread),
over the window."""

SPANS = {
    "codec._check_stream":
        "vbz_compression_tpu_torch.models.codec:_check_stream",
}


def read(run):
    return run.span_pct("codec._check_stream")
