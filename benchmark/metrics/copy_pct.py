"""copy_pct.<part>: share (%) of the window in which the host was in one of
the backend's copies to or from the card (the program's spans
``backend.h2d`` and ``backend.d2h``: pageable ``.to(device)``,
``torch.tensor(..., device=)``, ``.cpu()`` and ``.tolist()``), their union
over the window. One reader for every part."""

from benchmark.harness import program

COPIES = ("backend.h2d", "backend.d2h")


def read(run):
    return program.share_pct(run, COPIES)
