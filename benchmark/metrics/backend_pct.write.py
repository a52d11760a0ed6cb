"""backend_pct.write: share (%) of the window in which the backend's
StreamVByte encode (typing, padding, H2D, kernel E, the gather, D2H) ran on
the host: the union of the spans around
``vbz_compression_tpu_torch.models.codec:TorchSvbBackend.svb_compress_batch``
(every thread), over the window."""

SPANS = {
    "backend.svb_compress_batch":
        "vbz_compression_tpu_torch.models.codec:"
        "TorchSvbBackend.svb_compress_batch",
}


def read(run):
    return run.span_pct("backend.svb_compress_batch")
