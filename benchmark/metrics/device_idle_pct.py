"""device_idle_pct.<part>: share (%) of the traced window in which no
kernel, copy or fill ran on the card. One reader for every part; the parts
differ only in the end-to-end metric they move."""


def read(run):
    return run.idle_pct()
