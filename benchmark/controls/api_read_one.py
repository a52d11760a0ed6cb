"""Control of ``api_read_one``: the reference decoder without the stream
validation that takes most of the backend's decode."""

from __future__ import annotations

from benchmark.harness import reference


def control(cell):
    level = cell.config["options"][3]

    def decode(frame, dtype):
        return reference.decode_frame(frame, level, cell.device,
                                      validating=False).view(dtype)
    return decode
