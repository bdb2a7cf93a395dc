"""Errors shared by every layer of the port."""


def unported(what: str, item: int | str) -> NotImplementedError:
    """The error for a knob of the JAX package that the port lacks yet,
    naming the ``ROADMAP.md`` queue-1 item that ports it."""
    return NotImplementedError(
        f"{what} is not ported yet: it comes with item {item} of queue 1 in "
        f"ROADMAP.md ('Modules still to port')")
