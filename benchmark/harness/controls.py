"""The controls: the reference put in the program's place with one of the
configuration's guarantees broken, the step a later change might be
tempted to take. Each check must read the control as not correct.

An entry's control is its own file, ``controls/<entry>.py``, whose
``control(cell)`` returns the stand-in for the entry's program call; the
file's docstring says which guarantee it breaks. A new entry brings its
control as a new file.
"""

from __future__ import annotations

from . import cell as cell_mod


def for_entry(entry: str, cell):
    """The control of ``entry`` for ``cell``."""
    own = cell_mod.BENCH / "controls" / f"{entry}.py"
    if not own.is_file():
        raise FileNotFoundError(f"entry {entry!r} has no control: {own}")
    return cell_mod.load_module(own).control(cell)
